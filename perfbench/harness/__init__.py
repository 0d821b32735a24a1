"""The yardstick: data, reference, counts, trace reduction, the windows."""
