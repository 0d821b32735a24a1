"""plan_cache_s: seconds the program's plan build spent stacking its batch
cache (``plan.cache``); moves setup_s.
"""
from perfbench.harness import spans


def read(ctx):
    return spans.plan_cache_s(spans.snapshot())
