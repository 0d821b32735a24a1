"""The eight example scripts of the JAX package, as modules of the port.

Each runs as ``python -m repro_torch.examples.<name>`` on the card (the
default ``--device cuda``; without a card it raises) or on the CPU with
``--device cpu``: quickstart, serve_gnn, train_ibmb_full, dynamic_graph,
ooc_serve, serve_async, inference_comparison and serve_lm. Each has a
``main(argv=None)`` that prints the reference script's lines and returns
their figures as a dict. Nothing is imported here.
"""
