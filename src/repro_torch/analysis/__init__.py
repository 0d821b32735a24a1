"""AST-based invariant analyzer for the PyTorch port (DESIGN.md §15); the
port of ``repro.analysis``, scoped to ``src/repro_torch/``.

``repro_torch.analysis`` mechanically enforces the contracts the rest of
the port states in prose: deterministic plan builds (§8/§14), lock
discipline in the threaded serving tier, the loader, the elastic
coordinator and the kernel build cache (§11–§12), atomic artifact writes
(§12–§13; also the kernel libraries and the dataset cache), a single
canonical fault-point registry (§12), compiled-executable cache hygiene
(the counterpart of jit caching: kernel builds, ``torch.compile`` and
CUDA graphs) and bench-gate/emitter agreement. Rule names, the
``# lint: allow(<rule>)`` syntax, the finding format and the exit codes
are the reference's.

Run it with ``python -m repro_torch.analysis [--format json] [paths]``;
see ``repro_torch.analysis.cli``. The package is stdlib-only (``ast`` +
``re`` + ``json``): it imports neither ``torch`` nor ``repro``.
"""
from repro_torch.analysis.model import (Checker, Finding, Module, Project,
                                  load_baseline)
from repro_torch.analysis.determinism import DeterminismChecker
from repro_torch.analysis.locks import LockDisciplineChecker
from repro_torch.analysis.atomic_write import AtomicWriteChecker
from repro_torch.analysis.fault_points import FaultPointChecker
from repro_torch.analysis.jit_cache import JitCacheChecker
from repro_torch.analysis.bench_gate import BenchGateChecker

ALL_CHECKERS = (
    DeterminismChecker,
    LockDisciplineChecker,
    AtomicWriteChecker,
    FaultPointChecker,
    JitCacheChecker,
    BenchGateChecker,
)

__all__ = [
    "ALL_CHECKERS",
    "AtomicWriteChecker",
    "BenchGateChecker",
    "Checker",
    "DeterminismChecker",
    "FaultPointChecker",
    "Finding",
    "JitCacheChecker",
    "LockDisciplineChecker",
    "Module",
    "Project",
    "load_baseline",
]
