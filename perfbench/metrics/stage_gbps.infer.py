"""stage_gbps.infer: bytes the engine staged over the inference passes
over the seconds of its staging spans (``engine.stage``); moves
infer_nodes_per_s.
"""
from perfbench.harness import spans


def read(ctx):
    return spans.stage_gbps(spans.snapshot(), "engine.stage")
