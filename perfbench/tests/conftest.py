"""The benchmark's tests run on the CPU at a tiny size; those that need a
card carry the ``cuda`` marker and skip without one."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
