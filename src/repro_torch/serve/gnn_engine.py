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
   missing batch's host arrays are staged to the device once per forward;
   with the bcsr backend on a CUDA device the aggregation is the
   hand-written block-CSR SpMM kernel.
4. **Gather** — per-node logit rows are sliced out of the batch output,
   on the host, and scattered back into each request.

Repeat traffic is served from an LRU of recent batch outputs. The engine is
single-threaded. Not ported yet (ROADMAP.md): ``mesh=`` serving,
``swap`` onto a refreshed plan and ``ooc_stats``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.plan import Plan
from repro_torch.device import DeviceSpec, resolve_device, stage
from repro_torch.models.gnn import ops as gnn_ops
from repro_torch.models.gnn import policy as gnn_policy
from repro_torch.models.gnn.models import GNNConfig, gnn_apply, output_logits
from repro_torch.serve.common import SystemClock


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
    ``params`` are moved to ``device``.
    """

    def __init__(self, plan: Plan, model_cfg: GNNConfig, params,
                 backend=None, cache_batches: int = 8,
                 mesh=None, clock=None, device: DeviceSpec = None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported yet (ROADMAP.md, multi-GPU "
                "super-steps)")
        self.device = resolve_device(device)
        # `backend` is a name, "auto", or a BackendPolicy (DESIGN.md §14)
        model_cfg, self.policy = gnn_policy.resolve(model_cfg, backend)
        self.plan = plan
        self.cfg = model_cfg
        self.params = {"layers": [
            {k: torch.as_tensor(v).to(self.device) for k, v in layer.items()}
            for layer in params["layers"]]}
        # request-latency timing through the injectable clock (DESIGN.md §11)
        self.clock = clock if clock is not None else SystemClock()
        self.cache_batches = max(0, cache_batches)
        # fail fast at construction, not on the first unlucky query
        gnn_ops.validate_batch_for_backend(
            plan.cache[0], "auto" if self.policy.is_auto else model_cfg.backend,
            model_cfg.kind)
        # per-batch (backend, block_f): the plan's stored autotuner
        # decisions under an auto policy, uniform under a fixed one
        self._decisions = gnn_policy.batch_decisions(plan, self.policy,
                                                     model_cfg)
        self._lru: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.stats: Dict = dict(requests=0, nodes=0, batch_runs=0,
                                lru_hits=0, evictions=0, versions={})
        self._vstats = self.stats["versions"].setdefault(
            int(getattr(plan, "version", 0)),
            dict(requests=0, lru_hits=0, batch_runs=0, hit_rate=0.0))
        # one forward per (backend, block_f) decision, built lazily;
        # `_forward` holds the base decision's forward as a plain attribute
        # (the patchable surface tests inject faults through)
        self._fwd: Dict = {}
        self._base_key = (model_cfg.backend,
                          int(getattr(model_cfg, "bcsr_block_f", 0)))
        self._forward = self._build_forward(*self._base_key)

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

    # ------------------------------------------------------------ internals
    def _bump(self, **inc) -> None:
        for k, v in inc.items():
            self.stats[k] += v
            if k in self._vstats:
                self._vstats[k] += v
        served = self._vstats["lru_hits"] + self._vstats["batch_runs"]
        if served:
            self._vstats["hit_rate"] = self._vstats["lru_hits"] / served

    def _run_batch(self, bi: int) -> np.ndarray:
        """Forward one precomputed batch on the device; host logits of its
        output rows, entered into the LRU."""
        fwd = self._forward_for(*self._decisions[bi])
        out = fwd(self.params, stage(self.plan.cache[bi], self.device))
        out = out.cpu().numpy()
        self._bump(batch_runs=1)
        if self.cache_batches:
            self._lru[bi] = out
            while len(self._lru) > self.cache_batches:
                self._lru.popitem(last=False)
                self.stats["evictions"] += 1
        return out

    def _iter_logits(self, need):
        """Yield (bi, output-row logits) for every batch index in `need`,
        through the LRU; misses run one forward each."""
        for bi in need:
            bi = int(bi)
            if bi in self._lru:
                self._lru.move_to_end(bi)
                self._bump(lru_hits=1)
                yield bi, self._lru[bi]
            else:
                yield bi, self._run_batch(bi)

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
        # batch → request indices, so completion is tracked per request as
        # its last batch lands
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
