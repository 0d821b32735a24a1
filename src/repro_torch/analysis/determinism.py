"""Determinism checker (DESIGN.md §8/§14/§15).

Plan builds must be bitwise-reproducible: the plan fingerprint chains
config + payload, streamed builds must equal resident builds, and shard
manifests chain per-shard fingerprints. That dies silently the moment a
build path reads the wall clock into an artifact, draws from an
unseeded/global RNG, iterates a ``set`` into an array, or keys anything
on ``id()``/``hash()`` (both salted per process).

Scope: ``src/repro_torch/core/`` plus the streaming build paths
``src/repro_torch/ooc/stream.py`` and ``src/repro_torch/ooc/shard.py``
(the port's copies of the reference's scope). Timing-only
wall-clock reads (bench counters that never feed an artifact) are
annotated ``# lint: allow(determinism)`` with a justification.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.model import (Checker, Finding, Module, Project,
                                  call_name)

RULE = "determinism"

SCOPE_PREFIXES = ("src/repro_torch/core/",)
SCOPE_FILES = ("src/repro_torch/ooc/stream.py",
               "src/repro_torch/ooc/shard.py")

WALL_CLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}

#: legacy numpy global-state RNG entry points (process-wide, unseeded by
#: default, order-dependent across call sites)
NP_GLOBAL_RNG = {
    "np.random." + fn for fn in (
        "seed", "rand", "randn", "randint", "random", "random_sample",
        "permutation", "shuffle", "choice", "normal", "uniform")
} | {
    "numpy.random." + fn for fn in (
        "seed", "rand", "randn", "randint", "random", "random_sample",
        "permutation", "shuffle", "choice", "normal", "uniform")
}

DEFAULT_RNG = {"np.random.default_rng", "numpy.random.default_rng"}


def in_scope(relpath: str) -> bool:
    return (relpath.startswith(SCOPE_PREFIXES) or relpath in SCOPE_FILES)


def _is_set_like(node: ast.AST) -> bool:
    """Direct set-valued expressions whose iteration order is salted."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return call_name(node) in ("set", "frozenset")
    return False


class DeterminismChecker(Checker):
    name = "determinism"
    rules = (RULE,)

    def run(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.iter_modules(in_scope):
            out.extend(self._check_module(mod))
        return out

    def _check_module(self, mod: Module) -> List[Finding]:
        out: List[Finding] = []

        def finding(node: ast.AST, msg: str) -> None:
            out.append(Finding(RULE, mod.relpath, node.lineno, msg))

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name in WALL_CLOCK:
                    finding(node,
                            f"wall-clock read `{name}()` in a fingerprinted "
                            "build path; if this is timing-only telemetry "
                            "that never feeds an artifact, annotate it "
                            "`# lint: allow(determinism)` with a "
                            "justification")
                elif name in DEFAULT_RNG and not node.args \
                        and not node.keywords:
                    finding(node,
                            "unseeded `np.random.default_rng()` — thread "
                            "the config seed through (the "
                            "`seed=cfg.seed` idiom in core/update.py)")
                elif name in NP_GLOBAL_RNG:
                    finding(node,
                            f"global-state RNG `{name}` — use a seeded "
                            "`np.random.default_rng(seed)` Generator "
                            "instead")
                elif name in ("id", "hash"):
                    finding(node,
                            f"`{name}()` is salted per process — never "
                            "stable across runs; key on content "
                            "(fingerprints, crc32) instead")
            elif isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                if _is_set_like(it):
                    finding(it if hasattr(it, "lineno") else node,
                            "iterating a set: order is hash-salted per "
                            "process, so anything built from it is "
                            "non-reproducible — wrap in `sorted(...)`")
        return out
