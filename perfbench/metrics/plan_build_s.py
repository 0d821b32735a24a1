"""plan_build_s: the program's plan build (PPR, preprocessing, the plan's
cache, schedule and routing), from Plan.timings; moves setup_s.
"""
from perfbench.harness.readers import plan_build_s as read  # noqa: F401
