"""page_lock_s: seconds the program spent page-locking its plan's batch
cache for staging (the always-on total of ``stage.page_lock``); moves
setup_s. None for a program that does not page-lock.
"""
from perfbench.harness import spans


def read(ctx):
    tot = ((spans.snapshot() or {}).get("totals") or {}).get(
        "stage.page_lock")
    return float(tot["seconds"]) if tot else None
