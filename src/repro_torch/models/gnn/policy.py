"""BackendPolicy: the one aggregation-backend resolution entry point
(DESIGN.md §14).

Before this module, three call sites (``GNNTrainer``, ``GNNInferenceEngine``,
``ShardedPlanExecutor``) each re-implemented the same override dance —
``backend=str`` → ``dataclasses.replace(model_cfg, backend=...)`` — and the
only decision surface was a single global string. A per-batch *auto* mode
cannot live in a global string, so the override arg now accepts a policy:

* ``BackendPolicy.fixed("segment" | "bcsr" | "dense")`` — every batch runs
  the named backend; exactly the old ``backend="..."`` behaviour.
* ``BackendPolicy.auto()`` — per-batch dispatch: batches execute on the
  backend the plan-build autotuner decided for them (``Plan.batch_backends``,
  driven by the tile-fill/degree stats recorded during preprocessing —
  ``repro_torch.core.autotune``), falling back to tile presence for raw batch
  containers that carry no decision.

``resolve(model_cfg, backend)`` is the ONE shared helper: it normalizes a
``None | str | BackendPolicy`` override (plain strings keep working;
``"auto"`` means the auto policy), applies the deprecated
``REPRO_GNN_BACKEND`` env alias (warns once, maps onto a fixed policy), and
returns the adjusted model config plus the policy. Consumers then key their
forwards by ``(backend, block_f)`` per batch.

The port's copy of ``repro.models.gnn.policy`` (pure Python).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.models.gnn import ops as gnn_ops


@dataclasses.dataclass(frozen=True)
class BackendPolicy:
    """How batches map to aggregation backends: ``fixed(name)`` or ``auto``."""
    mode: str                               # "fixed" | "auto"
    backend: Optional[str] = None           # fixed mode only

    @classmethod
    def fixed(cls, name: str) -> "BackendPolicy":
        if name not in gnn_ops.BACKENDS:
            raise ValueError(
                f"unknown aggregation backend {name!r}; want one of "
                f"{gnn_ops.BACKENDS}")
        return cls("fixed", name)

    @classmethod
    def auto(cls) -> "BackendPolicy":
        return cls("auto")

    @property
    def is_auto(self) -> bool:
        return self.mode == "auto"


BackendSpec = Union[None, str, BackendPolicy]


def as_policy(spec: BackendSpec) -> Optional[BackendPolicy]:
    """Normalize a ``None | str | BackendPolicy`` override. ``"auto"``
    (string) means the auto policy; other strings are fixed backends."""
    if spec is None or isinstance(spec, BackendPolicy):
        return spec
    if isinstance(spec, str):
        return BackendPolicy.auto() if spec == "auto" \
            else BackendPolicy.fixed(spec)
    raise TypeError(
        f"backend must be None, a backend name, 'auto', or a BackendPolicy "
        f"— got {type(spec).__name__}")


def resolve(model_cfg, backend: BackendSpec = None):
    """THE shared resolution helper (replaces the triplicated
    ``dataclasses.replace(model_cfg, backend=...)`` pattern).

    Precedence: deprecated ``REPRO_GNN_BACKEND`` env alias (warns once,
    forces a fixed policy — it predates per-batch dispatch) > explicit
    ``backend`` arg > ``model_cfg.backend`` (which may itself be ``"auto"``).

    Returns ``(model_cfg, policy)``: for a fixed policy the config's
    ``backend`` field is the fixed name; for auto it is the ``"segment"``
    base (always executable — every batch carries COO edges), and consumers
    derive per-batch configs via :func:`batch_config`.
    """
    env = gnn_ops._env_backend()
    pol = BackendPolicy.fixed(env) if env else as_policy(backend)
    if pol is None:
        pol = as_policy(getattr(model_cfg, "backend", "segment") or "segment")
    base = "segment" if pol.is_auto else pol.backend
    if getattr(model_cfg, "backend", None) != base:
        model_cfg = dataclasses.replace(model_cfg, backend=base)
    return model_cfg, pol


def batch_config(model_cfg, backend: str, block_f: int = 0):
    """The per-executable config for one (backend, tuned block_f) decision —
    consumers jit one forward per distinct config, picked host-side."""
    if getattr(model_cfg, "backend", None) == backend \
            and int(getattr(model_cfg, "bcsr_block_f", 0)) == int(block_f):
        return model_cfg
    return dataclasses.replace(model_cfg, backend=backend,
                               bcsr_block_f=int(block_f))


def _has_tiles(batch) -> bool:
    if hasattr(batch, "has_bcsr"):
        return bool(batch.has_bcsr)
    return "tile_cols" in batch and "tile_vals" in batch


def batch_decisions(host, policy: BackendPolicy, model_cfg
                    ) -> List[Tuple[str, int]]:
    """Per-batch ``(backend, block_f)`` execution decisions for `host`.

    `host` is anything the trainer/engine serve from: a ``Plan`` (carries
    the autotuner's v3 decisions), a ``BatchCache``/``LazyBatchCache``, or a
    plain sequence of batch dicts / ``PaddedBatch``. Fixed policies return a
    uniform list; the auto policy reads the plan's stored decisions and
    degrades to tile-presence dispatch for containers without them.
    GAT has no precomputable tiles, so auto always resolves it to segment.
    """
    n = len(host)
    bf = int(getattr(model_cfg, "bcsr_block_f", 0))
    if not policy.is_auto:
        be = policy.backend or getattr(model_cfg, "backend", "segment")
        return [(be, bf)] * n
    if getattr(model_cfg, "kind", "gcn") == "gat":
        return [("segment", 0)] * n
    names = getattr(host, "batch_backends", None)
    if callable(names):                      # Plan v3 (or v2 fallback)
        tuned = host.batch_block_fs()
        return [(str(b), int(t)) for b, t in zip(names(), tuned)]
    cache = getattr(host, "cache", None)     # Plan-like wrapper
    if cache is not None and host is not cache:
        return batch_decisions(cache, policy, model_cfg)
    return [("bcsr", bf) if _has_tiles(host[i]) else ("segment", 0)
            for i in range(n)]



def superstep_decision(decisions: Sequence[Tuple[str, int]],
                       idx) -> Tuple[str, int]:
    """One decision for a data-parallel super-step (DESIGN.md §9): its
    members run one closure set, so they must share a backend. Uniform
    groups keep their decision; mixed groups fall back to segment (always
    executable — the schedule groups consecutive batches, and the
    autotuner's decisions are strongly run-length-uniform in practice, so
    this is the rare tail).
    """
    got = {decisions[int(i)] for i in idx}
    if len(got) == 1:
        return next(iter(got))
    backends = {b for b, _ in got}
    if len(backends) == 1:                   # same backend, mixed block_f
        return (next(iter(backends)), 0)
    return ("segment", 0)
