"""Versioned plan updates for dynamic graphs (DESIGN.md §10).

The port's copy of ``repro.core.update`` (host numpy), with only its
imports changed, so a refresh yields plans bitwise equal to the
reference's.

IBMB's whole advantage is that batches are precomputed once and reused; a
frozen ``Plan`` must therefore survive a *living* graph without rebuild-the-
world re-preprocessing. This module makes updates first-class:

* :class:`GraphDelta` — a declarative record of change: feature row updates,
  undirected edge inserts/deletes, label updates, per-split output-set
  adds/removes. ``delta.apply(ds)`` produces the post-delta dataset
  (copy-on-write; GCN renormalization recomputed only for structural
  deltas).
* :class:`PlanUpdater` — maps a delta to the minimal dirty-batch set using
  the incremental PPR push (``core.ppr.push_appr_incremental``: re-push
  only roots within ``push_iters`` hops of an edited endpoint, splice every
  other stored top-k row through bit-identically), rebuilds exactly those
  batches inside the parent plan's padded caps, patches payload arrays
  (features/labels) in place for batches whose influence-selected aux set
  did not change, and emits a new :class:`~repro_torch.core.plan.Plan` with a
  bumped ``version`` and parent fingerprint.
* :class:`PlanDelta` — the audit record of one refresh: which batches were
  rebuilt / patched / untouched, how many roots were re-pushed, per-stage
  timings, and the fallback reason when the fast path could not apply.

``IBMBPipeline.refresh(plan, delta)`` is the user-facing wrapper and
``GNNInferenceEngine.swap(plan, delta)`` consumes the audit record to
invalidate only the dirty LRU entries (zero-downtime hot swap).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import autotune
from repro_torch.core.aux_selection import batch_wise_aux, node_wise_aux
from repro_torch.core.batches import BatchCache, PaddedBatch, build_batches
from repro_torch.core.partition import (
    graph_partition, ppr_distance_partition, random_partition)
from repro_torch.core.plan import Plan, RoutingIndex, _frozen, encode_backends
from repro_torch.core.ppr import TopKPPR, ppr_dirty_roots, push_appr, \
    push_appr_incremental
from repro_torch.core.scheduling import make_schedule
from repro_torch.graph.csr import CSRGraph, gcn_preprocess, sorted_lookup


def _ids(a, dtype=np.int64) -> np.ndarray:
    return np.asarray(a, dtype=dtype).ravel()


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One batch of changes to a :class:`~repro_torch.graph.datasets.GraphDataset`.

    feat_nodes/feat_values:   (U,) node ids / (U, F) replacement feature rows
    edge_inserts/edge_deletes:(E, 2) undirected pairs (both directions applied)
    label_nodes/label_values: (L,) node ids / (L,) replacement labels
    output_adds/output_removes: per-split node-id arrays (output-set changes)
    """

    feat_nodes: Optional[np.ndarray] = None
    feat_values: Optional[np.ndarray] = None
    edge_inserts: Optional[np.ndarray] = None
    edge_deletes: Optional[np.ndarray] = None
    label_nodes: Optional[np.ndarray] = None
    label_values: Optional[np.ndarray] = None
    output_adds: Mapping[str, np.ndarray] = \
        dataclasses.field(default_factory=dict)
    output_removes: Mapping[str, np.ndarray] = \
        dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if (self.feat_nodes is None) != (self.feat_values is None):
            raise ValueError("feat_nodes and feat_values must come together")
        if (self.label_nodes is None) != (self.label_values is None):
            raise ValueError("label_nodes and label_values must come together")
        for name in ("feat_nodes", "label_nodes"):
            ids = getattr(self, name)
            if ids is not None and len(np.unique(ids)) != len(_ids(ids)):
                # duplicates are ambiguous: apply()'s fancy assignment keeps
                # the LAST occurrence while a membership patch would take
                # the first — refuse rather than silently diverge
                raise ValueError(f"{name} contains duplicate node ids")
        for name in ("edge_inserts", "edge_deletes"):
            e = getattr(self, name)
            if e is not None and (np.asarray(e).ndim != 2
                                  or np.asarray(e).shape[1] != 2):
                raise ValueError(f"{name} must be an (E, 2) array of pairs")

    # ------------------------------------------------------------- queries
    @property
    def is_structural(self) -> bool:
        """True iff the delta edits edges (degrees / GCN weights move)."""
        return bool(
            (self.edge_inserts is not None and len(self.edge_inserts)) or
            (self.edge_deletes is not None and len(self.edge_deletes)))

    def touched_nodes(self) -> np.ndarray:
        """Endpoints of every edited edge — the seed of all structural
        dirtiness (an edge edit moves the degrees, hence the GCN weights,
        of exactly its endpoints)."""
        parts = [np.asarray(e, dtype=np.int64).ravel()
                 for e in (self.edge_inserts, self.edge_deletes)
                 if e is not None and len(e)]
        return np.unique(np.concatenate(parts)) if parts \
            else np.zeros(0, np.int64)

    def summary(self) -> Dict[str, int]:
        def n(a):
            return 0 if a is None else len(a)
        return {
            "feat_updates": n(self.feat_nodes),
            "edge_inserts": n(self.edge_inserts),
            "edge_deletes": n(self.edge_deletes),
            "label_updates": n(self.label_nodes),
            "output_adds": sum(len(v) for v in self.output_adds.values()),
            "output_removes":
                sum(len(v) for v in self.output_removes.values()),
        }

    # -------------------------------------------------------------- apply
    def _check_range(self, name: str, ids: np.ndarray, n: int) -> np.ndarray:
        ids = _ids(ids)
        if len(ids) and (ids.min() < 0 or ids.max() >= n):
            # a negative id would silently wrap in fancy indexing while the
            # membership patch skips it — an undetectable refresh divergence
            raise ValueError(f"{name} node ids out of range [0, {n})")
        return ids

    def apply(self, ds):
        """Post-delta dataset (copy-on-write — `ds` is never mutated)."""
        n = ds.num_nodes
        features, labels = ds.features, ds.labels
        if self.feat_nodes is not None and len(self.feat_nodes):
            nodes = self._check_range("feat_nodes", self.feat_nodes, n)
            vals = np.asarray(self.feat_values, dtype=features.dtype)
            if vals.shape != (len(nodes), features.shape[1]):
                raise ValueError(
                    f"feat_values shape {vals.shape} != "
                    f"({len(nodes)}, {features.shape[1]})")
            features = features.copy()
            features[nodes] = vals
        if self.label_nodes is not None and len(self.label_nodes):
            labels = labels.copy()
            labels[self._check_range("label_nodes", self.label_nodes, n)] = \
                np.asarray(self.label_values, dtype=labels.dtype)

        graph, norm_graph = ds.graph, ds.norm_graph
        if self.is_structural:
            m = ds.graph.to_scipy().tolil()
            for pairs, val in ((self.edge_deletes, 0.0),
                               (self.edge_inserts, 1.0)):
                if pairs is None or not len(pairs):
                    continue
                e = np.asarray(pairs, dtype=np.int64)
                if e.min() < 0 or e.max() >= n:
                    raise ValueError(f"edge endpoint out of range [0, {n})")
                if np.any(e[:, 0] == e[:, 1]):
                    raise ValueError("self-loop edits are not supported — "
                                     "GCN self-loops are added by "
                                     "gcn_preprocess, not stored")
                m[e[:, 0], e[:, 1]] = val       # undirected: both directions
                m[e[:, 1], e[:, 0]] = val
            csr = m.tocsr()
            csr.eliminate_zeros()
            graph = CSRGraph.from_scipy(csr)
            norm_graph = gcn_preprocess(graph)

        splits = dict(ds.splits)
        for split, adds in self.output_adds.items():
            adds = self._check_range(f"output_adds[{split!r}]", adds, n)
            if np.isin(adds, splits[split]).any():
                raise ValueError(f"output_adds[{split!r}] contains nodes "
                                 f"already in the split")
            splits[split] = np.concatenate([splits[split],
                                            np.sort(adds)]).astype(
                                                splits[split].dtype)
        for split, rm in self.output_removes.items():
            rm = _ids(rm)
            missing = rm[~np.isin(rm, splits[split])]
            if len(missing):
                raise ValueError(f"output_removes[{split!r}] names nodes not "
                                 f"in the split: {missing[:8].tolist()}")
            splits[split] = splits[split][~np.isin(splits[split], rm)]
        return dataclasses.replace(ds, graph=graph, norm_graph=norm_graph,
                                   features=features, labels=labels,
                                   splits=splits)


@dataclasses.dataclass(frozen=True)
class PlanDelta:
    """Audit record of one plan refresh (DESIGN.md §10)."""

    parent_fingerprint: str
    child_fingerprint: str
    version: int                     # the CHILD plan's version
    rebuilt: np.ndarray              # batch indices fully rebuilt
    patched: np.ndarray              # batch indices payload-patched in place
    untouched: np.ndarray            # batch indices carried over verbatim
    dirty_roots: int                 # roots re-pushed by incremental PPR
    timings: Dict[str, float]
    fallback: Optional[str] = None   # why the minimal path did not apply

    @property
    def dirty(self) -> np.ndarray:
        """Batches whose OUTPUT logits may have changed — what an engine
        must drop from its LRU on swap."""
        return np.union1d(self.rebuilt, self.patched)

    def summary(self) -> str:
        fb = f", fallback={self.fallback}" if self.fallback else ""
        return (f"v{self.version}: {len(self.rebuilt)} rebuilt, "
                f"{len(self.patched)} patched, "
                f"{len(self.untouched)} untouched, "
                f"{self.dirty_roots} roots re-pushed{fb}")


class PlanUpdater:
    """Map a :class:`GraphDelta` to the minimal dirty-batch set and emit the
    refreshed plan. Stateless apart from the inputs; one instance per
    refresh. Prefer :meth:`repro_torch.core.pipeline.IBMBPipeline.refresh`, which
    wires the datasets, fingerprints and PPR caches for you.
    """

    def __init__(self, cfg, old_ds, new_ds, delta: GraphDelta):
        self.cfg = cfg
        self.old_ds = old_ds
        self.new_ds = new_ds
        self.delta = delta
        self.new_ppr: Optional[TopKPPR] = None   # exposed for pipeline cache

    # ----------------------------------------------------------- internals
    def _caps(self, plan: Plan) -> Tuple[int, int, int]:
        f = plan.cache.fields
        return (f["node_mask"].shape[1], f["edge_src"].shape[1],
                f["output_idx"].shape[1])

    def _partition(self, ppr: Optional[TopKPPR],
                   outputs: np.ndarray, mode: str) -> List[np.ndarray]:
        cfg = self.cfg
        cap = cfg.max_outputs_per_batch * (2 if mode == "inference" else 1)
        nb = cfg.num_batches or max(1, int(np.ceil(len(outputs) / cap)))
        if cfg.variant == "node":
            return ppr_distance_partition(ppr, outputs, cap, seed=cfg.seed)
        if cfg.variant == "random":
            return random_partition(outputs, nb, seed=cfg.seed)
        if cfg.variant == "batch":
            return graph_partition(self.new_ds.graph, outputs, nb,
                                   method=cfg.partition_method, seed=cfg.seed)
        raise ValueError(f"unknown IBMB variant: {cfg.variant}")

    def _aux_for(self, parts: Sequence[np.ndarray],
                 ppr: Optional[TopKPPR]) -> List[np.ndarray]:
        cfg = self.cfg
        if cfg.variant in ("node", "random"):
            return node_wise_aux(ppr, parts, cfg.k_per_output)
        return batch_wise_aux(self.new_ds.graph, parts,
                              budget=cfg.aux_budget, alpha=cfg.alpha,
                              num_iters=cfg.power_iters,
                              method=cfg.diffusion, heat_t=cfg.heat_t)

    def _parts_from_plan(self, plan: Plan) -> List[np.ndarray]:
        """Recover the parent's output partition (batch order = row order)
        from the routing index."""
        ro = plan.routing
        parts = []
        for i in range(len(plan)):
            m = ro.batch == i
            ids, rows = ro.node_ids[m], ro.row[m]
            parts.append(ids[np.argsort(rows)].astype(np.int64))
        return parts

    def _build(self, parts, aux, caps=None,
               block: Optional[int] = None) -> List[PaddedBatch]:
        cfg = self.cfg
        mn, me, mo = caps if caps is not None else (None, None, None)
        return build_batches(
            self.new_ds.norm_graph, self.new_ds.features, self.new_ds.labels,
            parts, aux, cache_features=cfg.cache_features,
            pad_multiple=cfg.pad_multiple,
            max_nodes=mn, max_edges=me, max_outputs=mo,
            bcsr_block=(block or cfg.bcsr_block)
            if cfg.backend == "bcsr" else None,
            reorder=cfg.reorder)

    # -------------------------------------------------------------- refresh
    def refresh(self, plan: Plan, fingerprint: str,
                old_ppr: Optional[TopKPPR] = None
                ) -> Tuple[Plan, PlanDelta]:
        """The delta-PPR refresh (DESIGN.md §10). Returns the child plan
        plus the audit record; `fingerprint` is the POST-delta pipeline's
        fingerprint for the plan's (split, mode)."""
        cfg, delta = self.cfg, self.delta
        split = plan.meta.get("split")
        mode = plan.meta.get("mode", "train")
        outputs = self.new_ds.splits[split]
        timings: Dict[str, float] = {}
        fallback = None

        # ---- stage 1: incremental PPR -----------------------------------
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        t0 = time.time()
        ppr_new, dirty_mask = None, np.zeros(len(outputs), bool)
        if cfg.variant in ("node", "random"):
            prev = old_ppr if old_ppr is not None else plan.ppr
            topk = cfg.ppr_topk()
            if prev is None:
                fallback = "no stored PPR (plan predates v2 or was wrapped "\
                           "from raw batches) — full re-push"
                dirty_mask[:] = True
                ppr_new = push_appr(
                    self.new_ds.graph, outputs, alpha=cfg.alpha, eps=cfg.eps,
                    max_iters=cfg.push_iters, topk=topk)
            else:
                dirty_mask = ppr_dirty_roots(
                    outputs, delta.touched_nodes(),
                    [self.old_ds.graph, self.new_ds.graph],
                    max(cfg.push_iters - 1, 0))
                dirty_mask |= ~np.isin(outputs, prev.roots)
                ppr_new = push_appr_incremental(
                    self.new_ds.graph, outputs, prev, dirty_mask,
                    alpha=cfg.alpha, eps=cfg.eps, max_iters=cfg.push_iters,
                    topk=topk)
            self.new_ppr = ppr_new
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        timings["refresh/ppr"] = time.time() - t0

        # ---- stage 2: partition + positional diff -----------------------
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        t0 = time.time()
        parts_old = self._parts_from_plan(plan)
        # Reuse the parent partition outright when its INPUTS are provably
        # unchanged — determinism then guarantees a from-scratch run would
        # recompute the identical partition, so skipping is exact:
        # node:   f(stored top-k rows, outputs, cap, seed) — rows unchanged
        #         iff the incremental push spliced every row through;
        # random: f(outputs, seed);
        # batch:  f(graph, outputs, seed) — graph unchanged iff the delta
        #         is not structural.
        outputs_same = np.array_equal(outputs, self.old_ds.splits[split])
        prev = old_ppr if old_ppr is not None else plan.ppr
        if cfg.variant == "node":
            reuse = outputs_same and prev is not None \
                and np.array_equal(ppr_new.indices, prev.indices) \
                and np.array_equal(ppr_new.values, prev.values)
        elif cfg.variant == "random":
            reuse = outputs_same
        else:
            reuse = outputs_same and not delta.is_structural
        parts_new = parts_old if reuse \
            else self._partition(ppr_new, outputs, mode)
        b_old, b_new = len(parts_old), len(parts_new)
        same_membership = np.zeros(b_new, bool)
        if reuse:
            same_membership[:] = True
        else:
            for i in range(min(b_old, b_new)):
                same_membership[i] = np.array_equal(
                    parts_new[i].astype(np.int64), parts_old[i])
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        timings["refresh/partition"] = time.time() - t0

        # ---- stage 3: classify batches ----------------------------------
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        t0 = time.time()
        n = self.new_ds.num_nodes
        dirty_out = np.zeros(max(n, 1), bool)
        if dirty_mask.any():
            dirty_out[outputs[dirty_mask]] = True
        touched = np.zeros(max(n, 1), bool)
        tn = delta.touched_nodes()
        touched[tn[tn < n]] = True

        rebuild = set(range(b_new)) - set(np.nonzero(same_membership)[0])
        if plan.node_ids is None:
            fallback = fallback or "plan has no membership table — " \
                                   "full rebuild"
            rebuild = set(range(b_new))
        elif cfg.variant == "batch" and delta.is_structural:
            # topic-sensitive PPR is a global diffusion: any edge edit
            # moves every batch's aux scores — no locality to exploit.
            fallback = "batch-wise aux is a global diffusion — structural " \
                       "delta dirties every batch"
            rebuild = set(range(b_new))
        else:
            aux_candidates = []
            for i in range(b_new):
                if i in rebuild:
                    continue
                members = plan.node_ids[i]
                members = members[members >= 0].astype(np.int64)
                if touched[members].any():
                    rebuild.add(i)        # induced edges / GCN weights moved
                elif dirty_out[parts_new[i]].any():
                    aux_candidates.append(i)
            if aux_candidates and cfg.variant in ("node", "random"):
                aux_cand = self._aux_for([parts_new[i]
                                          for i in aux_candidates], ppr_new)
                for i, aux in zip(aux_candidates, aux_cand):
                    members = plan.node_ids[i]
                    stored = np.sort(
                        members[members >= 0]).astype(np.int64)
                    if not np.array_equal(stored, aux.astype(np.int64)):
                        rebuild.add(i)    # influence-selected aux set moved
        rebuild_idx = np.array(sorted(rebuild), dtype=np.int64)
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        timings["refresh/classify"] = time.time() - t0

        # ---- stage 4: rebuild dirty batches inside the parent's caps ----
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        t0 = time.time()
        caps = self._caps(plan)
        rebuilt_batches: List[PaddedBatch] = []
        if len(rebuild_idx):
            parts_r = [parts_new[i] for i in rebuild_idx]
            aux_r = self._aux_for(parts_r, ppr_new)
            # rebuilt batches must tile at the PARENT's (possibly autotuned)
            # block so they splice into its (R, K, B, B) cache shape
            tv = plan.cache.fields.get("tile_vals")
            parent_block = int(tv.shape[-1]) if tv is not None else None
            try:
                rebuilt_batches = self._build(parts_r, aux_r, caps=caps,
                                              block=parent_block)
            except ValueError as e:
                # a rebuilt batch outgrew the frozen shape bucket: rebuild
                # the world with fresh caps (serving executables recompile,
                # which is exactly what growing shapes costs anywhere)
                return self._full_rebuild(
                    plan, fingerprint, parts_new, ppr_new, dirty_mask,
                    timings, f"caps exceeded ({e}) — full rebuild", t0)
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        timings["refresh/build"] = time.time() - t0

        # ---- stage 5: assemble the child cache --------------------------
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        t0 = time.time()
        parent_fields = plan.cache.fields
        mn = caps[0]
        if b_new == b_old:
            fields = {k: v.copy() for k, v in parent_fields.items()}
            node_ids = np.asarray(plan.node_ids).copy()
            meta = [dict(m) for m in plan.cache.meta]
        else:
            fields = {k: np.zeros((b_new,) + v.shape[1:], v.dtype)
                      for k, v in parent_fields.items()}
            node_ids = np.full((b_new, mn), -1, np.int32)
            meta = [dict() for _ in range(b_new)]
            for i in range(min(b_old, b_new)):
                if i not in rebuild:
                    for k in fields:
                        fields[k][i] = parent_fields[k][i]
                    node_ids[i] = plan.node_ids[i]
                    meta[i] = dict(plan.cache.meta[i])

        # BCSR K reconciliation: zero tiles only, no math effect
        if rebuilt_batches and rebuilt_batches[0].has_bcsr:
            k_old = fields["tile_cols"].shape[2]
            k_new = rebuilt_batches[0].tile_cols.shape[1]
            if k_new > k_old:
                pad = k_new - k_old
                fields["tile_cols"] = np.pad(
                    fields["tile_cols"], ((0, 0), (0, 0), (0, pad)))
                fields["tile_vals"] = np.pad(
                    fields["tile_vals"],
                    ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
        for i, pb in zip(rebuild_idx, rebuilt_batches):
            da = pb.device_arrays()
            for k, v in da.items():
                if v.shape != fields[k].shape[1:]:     # K smaller than cache
                    pad = [(0, a - b) for a, b in
                           zip(fields[k].shape[1:], v.shape)]
                    v = np.pad(v, pad)
                fields[k][i] = v
            node_ids[i] = pb.node_ids
            meta[i] = dict(nodes=pb.num_real_nodes, edges=pb.num_real_edges,
                           outputs=pb.num_real_outputs)

        # ---- stage 6: payload patches on clean batches ------------------
        patched = set()
        clean = np.array([i for i in range(b_new) if i not in rebuild],
                         dtype=np.int64)
        if len(clean) and delta.feat_nodes is not None \
                and len(delta.feat_nodes):
            upd = _ids(delta.feat_nodes)
            order = np.argsort(upd, kind="stable")
            upd_s = upd[order]
            vals_s = np.asarray(delta.feat_values,
                                dtype=fields["features"].dtype)[order]
            sub = node_ids[clean].astype(np.int64)          # (C, mn)
            safe, hit = sorted_lookup(upd_s, sub)
            hit &= sub >= 0                                 # -1 pads
            rows_c, cols = np.nonzero(hit)
            if len(rows_c):
                fields["features"][clean[rows_c], cols] = \
                    vals_s[safe[rows_c, cols]]
                patched.update(int(i) for i in np.unique(clean[rows_c]))
        if len(clean) and delta.label_nodes is not None \
                and len(delta.label_nodes):
            lab_ids = _ids(delta.label_nodes)
            lab_vals = np.asarray(delta.label_values,
                                  dtype=fields["labels"].dtype)
            ro = plan.routing
            safe, known = sorted_lookup(ro.node_ids, lab_ids)
            clean_set = set(clean.tolist())
            for j in np.nonzero(known)[0]:
                bi, row = int(ro.batch[safe[j]]), int(ro.row[safe[j]])
                if bi in clean_set:
                    fields["labels"][bi, row] = lab_vals[j]
                    patched.add(bi)

        # ---- stage 7: schedule (reuse when label multisets unchanged) ---
        if b_new == b_old \
                and np.array_equal(fields["labels"], parent_fields["labels"]) \
                and np.array_equal(fields["output_mask"],
                                   parent_fields["output_mask"]):
            schedule = np.asarray(plan.schedule, np.int64)
        else:
            labels = [fields["labels"][i][fields["output_mask"][i] > 0]
                      for i in range(b_new)]
            schedule = make_schedule(labels, self.new_ds.num_classes,
                                     mode=cfg.schedule, seed=cfg.seed)
        routing = RoutingIndex.from_cache(node_ids, fields["output_idx"],
                                          fields["output_mask"])
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        timings["refresh/assemble"] = time.time() - t0

        meta_counts = np.array(
            [[m.get("nodes", 0), m.get("edges", 0), m.get("outputs", 0)]
             for m in meta], np.int64)
        cache = BatchCache.from_fields(fields, meta_counts)
        # re-run the autotuner's per-batch half over the spliced cache:
        # rebuilt batches get fresh decisions, untouched ones re-derive the
        # same answer (pure function of unchanged structure, DESIGN.md §14)
        backs, bfs, bstats = autotune.decide_cache(cache, self.cfg)
        new_meta = dict(plan.meta, num_batches=b_new,
                        num_classes=int(self.new_ds.num_classes),
                        batch_stats=bstats)
        child = Plan(cache=cache, schedule=_frozen(schedule),
                     routing=routing, fingerprint=fingerprint,
                     meta=new_meta, timings=timings,
                     version=plan.version + 1, parent=plan.fingerprint,
                     node_ids=_frozen(node_ids), ppr=ppr_new,
                     batch_backend=_frozen(encode_backends(backs)),
                     batch_block_f=_frozen(np.asarray(bfs, np.int32)))
        untouched = np.array(
            [i for i in range(b_new)
             if i not in rebuild and i not in patched], np.int64)
        audit = PlanDelta(
            parent_fingerprint=plan.fingerprint,
            child_fingerprint=fingerprint, version=child.version,
            rebuilt=rebuild_idx,
            patched=np.array(sorted(patched), np.int64),
            untouched=untouched, dirty_roots=int(dirty_mask.sum()),
            timings=timings, fallback=fallback)
        return child, audit

    def _full_rebuild(self, plan, fingerprint, parts_new, ppr_new,
                      dirty_mask, timings, reason, t0):
        """Rebuild-the-world fallback, still versioned along the chain."""
        aux = self._aux_for(parts_new, ppr_new)
        batches = self._build(parts_new, aux, caps=None)
        cfg = self.cfg
        if cfg.backend == "bcsr" and cfg.autotune and \
                getattr(cfg, "tune_blocks", ()):
            # same per-plan tile sweep a from-scratch plan() runs
            batches, _block = autotune.retune_tile_block(batches, cfg)
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        timings["refresh/build"] = time.time() - t0
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        t1 = time.time()
        labels = [b.labels[b.output_mask] for b in batches]
        schedule = make_schedule(labels, self.new_ds.num_classes,
                                 mode=self.cfg.schedule, seed=self.cfg.seed)
        backs, bfs, bstats = autotune.decide_batches(batches, cfg)
        child = Plan.from_batches(
            batches, schedule=schedule, fingerprint=fingerprint,
            meta=dict(plan.meta, num_batches=len(batches),
                      num_classes=int(self.new_ds.num_classes),
                      batch_stats=bstats),
            timings=timings, version=plan.version + 1,
            parent=plan.fingerprint, ppr=ppr_new,
            batch_backend=encode_backends(backs),
            batch_block_f=np.asarray(bfs, np.int32))
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        timings["refresh/assemble"] = time.time() - t1
        audit = PlanDelta(
            parent_fingerprint=plan.fingerprint,
            child_fingerprint=fingerprint, version=child.version,
            rebuilt=np.arange(len(batches), dtype=np.int64),
            patched=np.zeros(0, np.int64), untouched=np.zeros(0, np.int64),
            dirty_roots=int(dirty_mask.sum()), timings=timings,
            fallback=reason)
        return child, audit
