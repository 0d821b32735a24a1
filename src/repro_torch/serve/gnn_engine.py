"""Request-level GNN inference over a frozen Plan (DESIGN.md §8), in PyTorch.

The port of ``repro.serve.gnn_engine``. Queries are sets of output-node
ids, answered from a ``Plan`` with no preprocessing on the request path:

1. **Route** — the plan's routing index maps every queried node id to its
   precomputed ``(batch, row)``.
2. **Coalesce** — requests in one ``run`` that hit the same batch share
   ONE forward pass.
3. **Execute** — one forward per (backend, block_f) decision: fixed
   policies run every batch on one backend; ``BackendPolicy.auto()``
   follows the plan's stored autotuner decisions (DESIGN.md §14). Each
   missing batch's host arrays are staged to the device once per forward
   (from the plan's cache, page-locked in place on a CUDA device:
   ``device.page_lock``, at construction and on every ``swap``; a batch
   whose tiles it checked has them built on the card from its edges);
   with the bcsr backend on a CUDA device the GCN's and SAGE's aggregation
   is the hand-written block-CSR SpMM kernel (GAT runs the segment path).
4. **Gather** — per-node logit rows are sliced out of the batch output,
   on the host, and scattered back into each request.

Repeat traffic is served from an LRU of recent batch outputs.

Dynamic graphs (DESIGN.md §10): ``swap(plan, delta)`` hot-swaps the engine
onto a refreshed plan atomically between requests. Only the LRU entries of
batches the refresh rebuilt or patched are invalidated; untouched batches
keep serving from cache, and the per-``versions`` stats table (requests /
lru_hits / batch_runs / hit_rate per plan version) shows traffic flowing
across the swap. A refused swap rolls back and is recorded in
``swap_audit``.

Out-of-core plans (DESIGN.md §13): a plan from ``PlanStore.as_plan`` or
``IBMBPipeline.plan(out_of_core=True)`` serves unchanged — each batch is
read through its ``LazyBatchCache`` and staged like a resident one — and
``ooc_stats`` reports the lazy cache's counters.

Mesh serving (DESIGN.md §9): with ``mesh=`` (a ``DataMesh``) concurrent
requests coalesce ACROSS the mesh's members — missing batches are grouped
one per member and answered by one forward super-step
(``ShardedPlanExecutor``), each member on its own parameter replica. The
replicas are explicit copies, so assigning ``params`` and every ``swap``
(a rollback included) re-replicate the master parameters.

The engine is single-threaded; ``AsyncGNNEngine`` serializes its calls
per tenant.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan import Plan, check_routing
from repro_torch.device import (DeviceSpec, page_lock, resolve_device,
                                stage)
from repro_torch.models.gnn import ops as gnn_ops
from repro_torch.models.gnn import policy as gnn_policy
from repro_torch.models.gnn.models import GNNConfig, gnn_apply, output_logits
from repro_torch.serve.common import SystemClock

#: the id each ``run`` gives its spans, one process-wide sequence
_RUN_IDS = itertools.count(1)


@dataclasses.dataclass
class GNNRequest:
    """One inference request: logits for an arbitrary set of node ids."""
    node_ids: np.ndarray
    logits: Optional[np.ndarray] = None     # (len(node_ids), C) when done
    latency_s: Optional[float] = None
    done: bool = False
    error: Optional[str] = None             # set instead of done on bad ids


class GNNInferenceEngine:
    """Serve per-node GNN predictions from a frozen ``Plan`` on ``device``
    (``cuda`` unless the caller passes another; no card raises).

    ``query`` answers one request synchronously; ``run`` drains a list of
    requests, coalescing all requests that touch the same precomputed batch
    into one forward pass. Per-batch output logits are LRU-cached
    (``cache_batches`` entries) so repeat traffic skips the forward.
    ``params`` are moved to ``device``; with a ``mesh`` the device is the
    mesh's first member and every member serves from its own replica.
    """

    def __init__(self, plan: Plan, model_cfg: GNNConfig, params,
                 backend=None, cache_batches: int = 8,
                 mesh=None, clock=None, device: DeviceSpec = None):
        # `backend` is a name, "auto", or a BackendPolicy (DESIGN.md §14)
        model_cfg, self.policy = gnn_policy.resolve(model_cfg, backend)
        # mesh serving (DESIGN.md §9): missing batches are grouped one per
        # member and answered by a single forward super-step
        self._ex = None
        if mesh is not None:
            if device is not None:
                raise ValueError("pass mesh= or device=, not both: a mesh "
                                 "engine runs on the mesh's first member")
            from repro_torch.dist.data_parallel import ShardedPlanExecutor
            self._ex = ShardedPlanExecutor(mesh, model_cfg,
                                           backend=self.policy)
            self.device = self._ex.device
        else:
            self.device = resolve_device(device)
        self.plan = plan
        self.cfg = model_cfg
        self.params = params
        # request-latency timing through the injectable clock (DESIGN.md §11)
        self.clock = clock if clock is not None else SystemClock()
        self.cache_batches = max(0, cache_batches)
        # fail fast at construction, not on the first unlucky query; the
        # auto policy validates by tile presence
        self._vb = "auto" if self.policy.is_auto else model_cfg.backend
        gnn_ops.validate_batch_for_backend(plan.cache[0], self._vb,
                                           model_cfg.kind)
        # per-batch (backend, block_f): the plan's stored autotuner
        # decisions under an auto policy, uniform under a fixed one
        self._decisions = gnn_policy.batch_decisions(plan, self.policy,
                                                     model_cfg)
        self._lru: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.stats: Dict = dict(
            requests=0, nodes=0, batch_runs=0, lru_hits=0, supersteps=0,
            evictions=0, swap_count=0, swap_rollbacks=0, versions={})
        # audit trail of swap attempts (DESIGN.md §12): one record per call,
        # including refused swaps that rolled back to the parent version
        self.swap_audit: List[Dict] = []
        self._vstats = self._version_bucket(getattr(plan, "version", 0))
        # one forward per (backend, block_f) decision, built lazily;
        # `_forward` holds the base decision's forward as a plain attribute
        # (the patchable surface tests inject faults through)
        self._fwd: Dict = {}
        self._base_key = (model_cfg.backend,
                          int(getattr(model_cfg, "bcsr_block_f", 0)))
        self._forward = self._build_forward(*self._base_key)
        # the plan's resident cache copies by DMA (device.page_lock)
        page_lock(plan.cache, self.device)

    @property
    def params(self):
        """The master parameters, on ``self.device``."""
        return self._params

    @params.setter
    def params(self, tree) -> None:
        """Place ``tree`` on the device and, on a mesh, re-replicate it."""
        self._params = {"layers": [
            {k: torch.as_tensor(v).to(self.device) for k, v in layer.items()}
            for layer in tree["layers"]]}
        self._replicate()

    def _replicate(self) -> None:
        """Copy the master parameters to every mesh member (a no-op off a
        mesh): the replicas must never serve another version."""
        self._replicas = None if self._ex is None \
            else self._ex.replicate(self._params)

    def _build_forward(self, backend: str, block_f: int):
        cfg = gnn_policy.batch_config(self.cfg, backend, block_f)

        @torch.inference_mode()
        def _forward(params, batch):
            h = gnn_apply(cfg, params, batch)
            return output_logits(h, batch)          # (max_outputs, C)

        return _forward

    def _forward_for(self, backend: str, block_f: int = 0):
        """The forward for one (backend, block_f) decision. The base
        decision answers through the ``_forward`` attribute so a patched
        attribute is honoured."""
        key = (backend, int(block_f))
        if key == self._base_key:
            return self._forward
        if key not in self._fwd:
            self._fwd[key] = self._build_forward(backend, int(block_f))
        return self._fwd[key]

    # ----------------------------------------------------------- hot swap
    def swap(self, plan: Plan, delta=None, validate: bool = True
             ) -> Dict[str, int]:
        """Hot-swap onto a refreshed plan (DESIGN.md §10), atomically
        between requests: everything is computed first, then the plan, LRU
        and per-batch decisions are assigned together.

        ``delta`` is the :class:`~repro_torch.core.update.PlanDelta` from
        ``IBMBPipeline.refresh``: only its rebuilt/patched batches leave
        the LRU, untouched batches keep serving from it. Without a delta
        the whole LRU is cleared. A delta that does not link the serving
        plan to the incoming one (parent/child fingerprints) is refused
        with ValueError, as is (with ``validate``) a plan whose routing
        fails :func:`repro_torch.core.plan.check_routing` or whose batches
        lack what the backend needs. Any failure leaves the engine serving
        the plan it had, appends a rollback record to ``swap_audit`` and
        re-raises. Returns ``{"invalidated": ..., "kept": ...}``. On a
        mesh, a swap and its rollback alike re-replicate ``params``: in JAX
        the mesh forward replicates whatever the engine holds, here the
        replicas are copies.
        """
        prev = (self.plan, self._lru, self._vstats, self._decisions)
        try:
            # fail fast, BEFORE touching any serving state
            gnn_ops.validate_batch_for_backend(
                plan.cache[0], self._vb, self.cfg.kind)
            if delta is not None:
                if delta.parent_fingerprint != self.plan.fingerprint:
                    raise ValueError(
                        f"swap: delta parents {delta.parent_fingerprint!r} "
                        f"but the engine is serving "
                        f"{self.plan.fingerprint!r} — refresh the serving "
                        f"plan, not another chain")
                if delta.child_fingerprint != plan.fingerprint:
                    raise ValueError(
                        f"swap: delta produced {delta.child_fingerprint!r} "
                        f"but the incoming plan is {plan.fingerprint!r} — "
                        f"this audit record does not describe that plan, "
                        f"and trusting it would keep stale LRU entries "
                        f"serving")
            if validate:
                check_routing(plan)
            if delta is None:
                dirty = set(self._lru)              # conservative: drop all
            else:
                dirty = set(int(i) for i in delta.dirty)
            keep = OrderedDict((bi, out) for bi, out in self._lru.items()
                               if bi not in dirty and bi < len(plan))
            invalidated = len(self._lru) - len(keep)
            # the incoming plan carries its own autotuner decisions (a
            # refresh may re-decide rebuilt batches, DESIGN.md §14)
            decisions = gnn_policy.batch_decisions(plan, self.policy,
                                                   self.cfg)
            self.plan, self._lru, self._decisions = plan, keep, decisions
            self.stats["swap_count"] += 1
            self.stats["evictions"] += invalidated
            self._vstats = self._version_bucket(getattr(plan, "version", 0))
        except Exception as e:
            # roll back and audit: the engine keeps serving the parent
            self.plan, self._lru, self._vstats, self._decisions = prev
            self.stats["swap_rollbacks"] += 1
            self.swap_audit.append(dict(
                ok=False, serving_version=getattr(self.plan, "version", 0),
                refused_version=getattr(plan, "version", None),
                reason=f"{type(e).__name__}: {e}"))
            raise
        finally:
            self._replicate()
        page_lock(plan.cache, self.device)
        self.swap_audit.append(dict(
            ok=True, from_version=getattr(prev[0], "version", 0),
            to_version=getattr(plan, "version", 0),
            invalidated=invalidated, kept=len(keep)))
        return {"invalidated": invalidated, "kept": len(keep)}

    def ooc_stats(self) -> Optional[Dict]:
        """Resident-budget/IO counters of an out-of-core plan's lazy cache
        (DESIGN.md §13), or ``None`` for a resident plan — the engine-level
        hook the serving tier's ``snapshot`` surfaces so operators can see
        batch faulting, eviction pressure, and retried reads per tenant."""
        snap = getattr(self.plan.cache, "snapshot", None)
        return snap() if callable(snap) else None

    # ------------------------------------------------------------ internals
    def _version_bucket(self, version: int) -> Dict[str, float]:
        """Per-plan-version counters inside ``stats['versions']`` (DESIGN.md
        §10)."""
        return self.stats["versions"].setdefault(
            int(version), dict(requests=0, lru_hits=0, batch_runs=0,
                               hit_rate=0.0))

    def _bump(self, **inc) -> None:
        for k, v in inc.items():
            self.stats[k] += v
            if k in self._vstats:
                self._vstats[k] += v
        served = self._vstats["lru_hits"] + self._vstats["batch_runs"]
        if served:
            self._vstats["hit_rate"] = self._vstats["lru_hits"] / served

    def _lru_put(self, bi: int, out: np.ndarray) -> np.ndarray:
        self._bump(batch_runs=1)
        if self.cache_batches:
            self._lru[bi] = out
            while len(self._lru) > self.cache_batches:
                self._lru.popitem(last=False)
                self.stats["evictions"] += 1
        return out

    def _flush_misses(self, missing):
        """Compute the logits of `missing` (≤ world batches), yielding
        (bi, host logits of its output rows). A lone miss skips the
        super-step machinery — padding it to `world` identical copies would
        waste world−1 members' staging and compute — and runs the plain
        per-batch forward on the mesh's first device instead."""
        if len(missing) == 1 or self._ex is None:
            for bi in missing:
                fwd = self._forward_for(*self._decisions[bi])
                host = self.plan.cache[bi]
                with obs.span("engine.stage", batch=bi) as s:
                    batch = stage(host, self.device, s)
                with obs.span("engine.forward", batch=bi):
                    out = fwd(self.params, batch)
                with obs.span("engine.fetch", batch=bi):
                    out = out.cpu().numpy()
                yield bi, self._lru_put(bi, out)
            return
        from repro_torch.dist.data_parallel import superstep_indices
        (idx, w), = superstep_indices(np.asarray(missing), self._ex.world)
        fns = self._ex.steps_for(
            *gnn_policy.superstep_decision(self._decisions, idx))
        batch, _w = self._ex.stage(self.plan.cache, idx, w)
        lg = [out.cpu().numpy()
              for out in fns.forward(self._replicas, batch)]
        self.stats["supersteps"] += 1
        for j in range(len(idx)):
            if w[j] > 0:
                yield int(idx[j]), self._lru_put(int(idx[j]), lg[j])

    def _iter_logits(self, need):
        """Yield (bi, output-row logits) for every batch index in `need`,
        through the LRU. Misses run coalesced — one batch per member per
        super-step when a mesh is configured — but are flushed chunk by
        chunk, so peak host memory beyond the LRU stays at O(world) batch
        outputs however many batches a request set touches (the caller
        scatters each batch's rows and drops the reference)."""
        world = self._ex.world if self._ex is not None else 1
        missing: List[int] = []
        for bi in need:
            bi = int(bi)
            if bi in self._lru:
                self._lru.move_to_end(bi)
                self._bump(lru_hits=1)
                yield bi, self._lru[bi]
                continue
            missing.append(bi)
            if len(missing) == world:
                yield from self._flush_misses(missing)
                missing = []
        if missing:
            yield from self._flush_misses(missing)

    # -------------------------------------------------------------- queries
    def query(self, node_ids: Sequence[int]) -> np.ndarray:
        """Logits for `node_ids` (any output nodes covered by the plan),
        in query order. Raises KeyError for ids the plan does not cover."""
        q = np.asarray(node_ids, dtype=np.int64).ravel()
        bidx, rows = self.plan.routing.lookup(q)
        self._bump(requests=1, nodes=len(q))
        out = None
        for bi, lg in self._iter_logits(np.unique(bidx)):
            if out is None:
                out = np.empty((len(q), lg.shape[1]), lg.dtype)
            sel = bidx == bi
            out[sel] = lg[rows[sel]]
        if out is None:                              # empty query
            out = np.zeros((0, self.cfg.out_dim), np.float32)
        return out

    def run(self, requests: List[GNNRequest]) -> Dict[str, float]:
        """Drain `requests`, coalescing across them: every precomputed batch
        needed by ANY request runs at most once (then serves them all).
        Records per-request latency (admission → completion). A request with
        ids the plan does not cover gets its `error` set and is skipped."""
        with obs.span("engine.run", run=next(_RUN_IDS),
                      requests=len(requests)) as run_span:
            t0 = self.clock.now()
            routed = []
            for req in requests:
                q = np.asarray(req.node_ids, dtype=np.int64).ravel()
                try:
                    bidx, rows = self.plan.routing.lookup(q)
                except KeyError as e:
                    req.error = str(e)
                    req.done, req.logits = False, None
                    continue
                req.logits = None
                routed.append((req, q, bidx, rows))
                self._bump(requests=1, nodes=len(q))
                run_span.add(nodes=len(q))
            # batch → request indices, so completion is tracked per request
            # as its last batch lands
            needed: "OrderedDict[int, List[int]]" = OrderedDict()
            remaining = []
            for ri, (_req, _q, bidx, _rows) in enumerate(routed):
                uniq = np.unique(bidx)
                remaining.append(len(uniq))
                for bi in uniq:
                    needed.setdefault(int(bi), []).append(ri)
            for bi, lg in self._iter_logits(list(needed)):
                for ri in needed[bi]:
                    req, q, bidx, rows = routed[ri]
                    if req.logits is None:
                        req.logits = np.empty((len(q), lg.shape[1]), lg.dtype)
                    sel = bidx == bi
                    req.logits[sel] = lg[rows[sel]]
                    remaining[ri] -= 1
                    if remaining[ri] == 0:
                        req.done = True
                        req.latency_s = self.clock.now() - t0
            for req, q, _bidx, _rows in routed:          # empty requests
                if len(q) == 0:
                    req.logits = np.zeros((0, self.cfg.out_dim), np.float32)
                    req.done, req.latency_s = True, self.clock.now() - t0
        return {"requests": len(requests), "batch_runs_total":
                self.stats["batch_runs"], "time_s": self.clock.now() - t0}
