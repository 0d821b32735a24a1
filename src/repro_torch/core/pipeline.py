"""End-to-end IBMB preprocessing pipeline — the public API.

    cfg  = IBMBConfig(variant="node", k_per_output=16, max_outputs_per_batch=1024)
    pipe = IBMBPipeline(dataset, cfg)
    plan = pipe.plan("train")                      # frozen Plan artifact (§8)
    plan.save("train_plan.npz")                    # preprocess once, reuse
    plan = pipe.load_plan("train_plan.npz", "train")   # fingerprint-checked

``plan()`` is the primary entry point (DESIGN.md §8): it returns a frozen,
serializable :class:`~repro_torch.core.plan.Plan` bundling the contiguous batch
cache (+ BCSR tiles), the batch schedule, preprocessing timings, the config
fingerprint, and the routing index that request-level serving
(``repro_torch.serve.gnn_engine``) uses. ``preprocess()`` remains the lower-level
stage returning the raw ``List[PaddedBatch]``.

``refresh(plan, delta)`` is the dynamic-graph entry point (DESIGN.md §10):
it advances the pipeline to the post-delta dataset and emits the next plan
in the version chain, rebuilding only the batches the delta actually
dirtied (incremental PPR push decides) plus a ``PlanDelta`` audit record.

``plan(split, out_of_core=True, store_dir=...)`` streams the build into a
``repro_torch.ooc`` PlanStore instead (DESIGN.md §13). Everything matches
``repro.core.pipeline`` line for line, so the two packages build, stream
and refresh bitwise-identical plans.

Variants (paper Sec. 5 setup):
* "node"  — node-wise IBMB: PPR-distance partitioning + node-wise top-k aux.
* "batch" — batch-wise IBMB: graph partitioning + batch-wise (topic) PPR aux.
* "random" — fixed-random partition + node-wise aux (the paper's ablation).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.graph.datasets import GraphDataset
from repro_torch.core.ppr import push_appr, TopKPPR
from repro_torch.core.partition import ppr_distance_partition, graph_partition, random_partition
from repro_torch.core.aux_selection import node_wise_aux, batch_wise_aux
from repro_torch.core import autotune
from repro_torch.core.batches import PaddedBatch, build_batches, BatchCache
from repro_torch.core.plan import Plan, encode_backends, plan_fingerprint
from repro_torch.core.scheduling import make_schedule
from repro_torch.core.update import GraphDelta, PlanDelta, PlanUpdater


@dataclasses.dataclass
class IBMBConfig:
    variant: str = "node"            # node | batch | random
    alpha: float = 0.25              # PPR teleport (paper default 0.25)
    eps: float = 2e-4                # push threshold
    push_iters: int = 3              # paper: 3 push sweeps
    power_iters: int = 50            # paper: 50 power iterations
    k_per_output: int = 16           # aux nodes per output (main free knob)
    max_outputs_per_batch: int = 1024
    num_batches: Optional[int] = None   # for batch/random variants
    aux_budget: Optional[int] = None    # batch-wise: None → |partition|
    partition_method: str = "fennel"    # fennel | louvain | random
    diffusion: str = "ppr"              # ppr | heat  (Table 5)
    heat_t: float = 3.0
    schedule: str = "tsp"               # tsp | weighted | none  (Fig. 7)
    pad_multiple: int = 128
    cache_features: bool = True
    seed: int = 0
    # aggregation backend the batches are built for (DESIGN.md §7):
    # "segment"/"dense" need only the COO edge list; "bcsr" additionally
    # emits the per-batch block-CSR tiles after batch-local node reordering.
    backend: str = "segment"
    bcsr_block: int = 128               # tile size (gcd'd with max_nodes)
    reorder: str = "bfs"                # bfs | degree | none (tile locality)
    # plan-build autotuner (DESIGN.md §14): per-batch backend decision +
    # tuned feature-tile width stored in the Plan (format v3); all knobs
    # are fingerprinted (the whole config is), so a tuned plan is pinned.
    autotune: bool = True
    tune_blocks: tuple = ()             # extra tile-size B candidates to sweep
    tune_block_fs: tuple = (128, 256, 512)   # feature-tile width candidates
    auto_kappa: float = 16.0            # bcsr wins iff tile flops <= kappa·|E|
    tune_vmem_kb: int = 8192            # fused-kernel working-set budget

    def ppr_topk(self) -> int:
        """Stored top-k width of the node-wise APPR. ONE home for the
        formula: ``node_ppr`` computes with it and the refresh path
        (``core.update``) aligns stored rows against it — if they ever
        disagreed, ``push_appr_incremental`` would silently mark every
        root dirty on every refresh."""
        return max(self.k_per_output * 2, 32)


class IBMBPipeline:
    def __init__(self, dataset: GraphDataset, cfg: IBMBConfig):
        if cfg.backend not in ("segment", "bcsr", "dense"):
            raise ValueError(f"unknown IBMBConfig.backend {cfg.backend!r}; "
                             "want segment | bcsr | dense (DESIGN.md §7)")
        self.ds = dataset
        self.cfg = cfg
        self._ppr_cache: Dict[str, TopKPPR] = {}
        self._content_sha_cache: Optional[str] = None
        self.timings: Dict[str, float] = {}

    # -- influence scores ---------------------------------------------------
    def node_ppr(self, split: str) -> TopKPPR:
        """Node-wise APPR for the split's output nodes (cached — the paper
        re-uses preprocessing across models/seeds)."""
        if split not in self._ppr_cache:
            with obs.span("plan.ppr") as s:
                self._ppr_cache[split] = push_appr(
                    self.ds.graph, self.ds.splits[split],
                    alpha=self.cfg.alpha, eps=self.cfg.eps,
                    max_iters=self.cfg.push_iters, topk=self.cfg.ppr_topk())
            self.timings[f"ppr/{split}"] = s.seconds
        return self._ppr_cache[split]

    # -- fingerprint --------------------------------------------------------
    def _content_sha(self) -> str:
        """Digest of the actual graph/feature/label CONTENT (not just
        shapes), so a regenerated dataset with identical dimensions still
        invalidates old plans. Computed once per pipeline — preprocessing-
        time cost, amortized like everything else."""
        if self._content_sha_cache is None:
            h = hashlib.sha256()
            g = self.ds.norm_graph
            for a in (g.indptr, g.indices, g.weights,
                      self.ds.features, self.ds.labels):
                h.update(np.ascontiguousarray(a).tobytes())
            self._content_sha_cache = h.hexdigest()[:16]
        return self._content_sha_cache

    def fingerprint(self, split: str, for_inference: bool = False) -> str:
        """Fingerprint of (config, dataset, split, mode) — what a saved Plan
        is checked against on load (DESIGN.md §8)."""
        sig = {
            "name": self.ds.name,
            "num_nodes": int(self.ds.num_nodes),
            "num_edges": int(self.ds.graph.num_edges),
            "feat_dim": int(self.ds.feat_dim),
            "num_classes": int(self.ds.num_classes),
            "content_sha": self._content_sha(),
            "split_sha": hashlib.sha256(
                np.ascontiguousarray(
                    self.ds.splits[split], dtype=np.int64).tobytes()
            ).hexdigest()[:16],
        }
        mode = "inference" if for_inference else "train"
        return plan_fingerprint(dataclasses.asdict(self.cfg), sig, split, mode)

    # -- the primary entry point: frozen Plan artifact ----------------------
    def plan(self, split: str, for_inference: bool = False,
             out_of_core: bool = False, store_dir: Optional[str] = None,
             ooc=None) -> Plan:
        """Run preprocessing end to end and freeze the result (DESIGN.md §8):
        batches + cache + schedule + routing index + fingerprint + timings.
        The returned Plan is what ``GNNTrainer.fit/evaluate``,
        ``GNNInferenceEngine`` and ``Plan.save`` consume.

        ``out_of_core=True`` (DESIGN.md §13) streams the build instead:
        batches are constructed chunk by chunk and appended to a
        :class:`~repro_torch.ooc.store.PlanStore` at ``store_dir`` as they
        finish — the full padded batch payload is NEVER resident at once —
        and the returned Plan is backed by a lazy, mmap-backed cache with a
        bounded resident-batch budget (``ooc`` is an optional
        :class:`~repro_torch.ooc.stream.OOCConfig`). Per-batch contents,
        schedule, routing index and fingerprint are bit-identical to the
        resident build."""
        if out_of_core:
            from repro_torch.ooc.stream import stream_plan
            if store_dir is None:
                raise ValueError("out_of_core=True needs store_dir (the "
                                 "PlanStore directory to stream batches to)")
            return stream_plan(self, split, for_inference, store_dir, ooc)
        mode = "inference" if for_inference else "train"
        batches = self.preprocess(split, for_inference=for_inference)
        with obs.span("plan.cache") as s_cache:
            cache = BatchCache(batches)
            s_cache.add(bytes=cache.nbytes())
        with obs.span("plan.schedule") as s_sched:
            sched = self.schedule(batches)
        # the autotuner's per-batch half (DESIGN.md §14): backend decision
        # + tuned feature-tile width, stored in the plan (format v3) so
        # serving dispatches without re-measuring anything
        with obs.span("plan.autotune") as s_tune:
            backs, bfs, bstats = autotune.decide_batches(batches, self.cfg)
        self.timings[f"plan/{split}/{mode}"] = \
            s_cache.seconds + s_sched.seconds + s_tune.seconds
        meta = dict(split=split, mode=mode, variant=self.cfg.variant,
                    backend=self.cfg.backend,
                    num_classes=int(self.ds.num_classes),
                    num_batches=len(batches), dataset=self.ds.name,
                    batch_stats=bstats)
        # only THIS split/mode's timings: the artifact stays self-describing
        # even when one pipeline planned several splits
        own = (f"ppr/{split}", f"preprocess/{split}/{mode}",
               f"plan/{split}/{mode}")
        return Plan.from_batches(
            batches, schedule=sched, cache=cache,
            fingerprint=self.fingerprint(split, for_inference),
            meta=meta,
            batch_backend=encode_backends(backs),
            batch_block_f=np.asarray(bfs, np.int32),
            timings={k: v for k, v in self.timings.items() if k in own},
            # the stored warm state future refreshes splice from (§10);
            # batch-wise plans carry none (their aux diffusion is global)
            ppr=self._ppr_cache.get(split))

    def load_plan(self, path: str, split: str,
                  for_inference: bool = False) -> Plan:
        """Load a saved Plan, refusing artifacts whose fingerprint does not
        match THIS pipeline's (config, dataset, split, mode)."""
        return Plan.load(
            path, expect_fingerprint=self.fingerprint(split, for_inference))

    # -- dynamic graphs: versioned plan refresh (DESIGN.md §10) -------------
    def refresh(self, plan: Plan, delta: GraphDelta):
        """Apply ``delta`` to this pipeline's dataset and emit the next plan
        in the version chain: ``(child_plan, plan_delta)``.

        The pipeline ADVANCES to the post-delta graph (subsequent ``plan``/
        ``fingerprint`` calls see it; the plan's split keeps a warm PPR
        cache spliced by the incremental push, other splits' caches are
        dropped as stale). ``plan`` must belong to this pipeline's
        pre-delta state — a foreign or stale artifact is refused exactly
        like ``load_plan`` would refuse it. The child plan's logits are
        numerically identical to a from-scratch ``plan()`` on the
        post-delta graph; only the dirty subset of batches is rebuilt
        (``plan_delta`` records which, for ``GNNInferenceEngine.swap``).
        """
        split, mode = plan.meta.get("split"), plan.meta.get("mode", "train")
        if split not in self.ds.splits:
            raise ValueError(f"plan names unknown split {split!r}")
        for_inference = mode == "inference"
        expect = self.fingerprint(split, for_inference)
        if plan.fingerprint != expect:
            raise ValueError(
                f"refresh: plan fingerprint {plan.fingerprint!r} does not "
                f"match this pipeline's pre-delta state ({expect!r}) — "
                f"refresh continues a chain, it cannot adopt a foreign plan")
        with obs.span("plan.refresh") as s:
            old_ds = self.ds
            new_ds = delta.apply(old_ds)
            updater = PlanUpdater(self.cfg, old_ds, new_ds, delta)
            old_ppr = self._ppr_cache.get(split)
            # advance the pipeline to the post-delta graph
            self.ds = new_ds
            self._content_sha_cache = None
            self._ppr_cache.clear()
            child, audit = updater.refresh(
                plan, fingerprint=self.fingerprint(split, for_inference),
                old_ppr=old_ppr)
            if updater.new_ppr is not None:
                self._ppr_cache[split] = updater.new_ppr
        self.timings[f"refresh/{split}/{mode}"] = s.seconds
        return child, audit

    # -- full preprocessing -------------------------------------------------
    def partition(self, split: str, for_inference: bool = False
                  ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """The id-only half of preprocessing: influence scores → output
        partition → auxiliary selection. Returns ``(parts, aux)``, two
        aligned lists of global node-id arrays (one pair per batch) and NO
        payload. ``preprocess`` is exactly ``partition`` + ``build_batches``."""
        cfg = self.cfg
        outputs = self.ds.splits[split]
        # inference batches can be ~2x larger (no gradient storage, App. B)
        cap = cfg.max_outputs_per_batch * (2 if for_inference else 1)
        nb = cfg.num_batches or max(1, int(np.ceil(len(outputs) / cap)))

        if cfg.variant == "node":
            ppr = self.node_ppr(split)
            parts = ppr_distance_partition(ppr, outputs, cap, seed=cfg.seed)
            aux = node_wise_aux(ppr, parts, cfg.k_per_output)
        elif cfg.variant == "batch":
            parts = graph_partition(self.ds.graph, outputs, nb,
                                    method=cfg.partition_method, seed=cfg.seed)
            aux = batch_wise_aux(self.ds.graph, parts, budget=cfg.aux_budget,
                                 alpha=cfg.alpha, num_iters=cfg.power_iters,
                                 method=cfg.diffusion, heat_t=cfg.heat_t)
        elif cfg.variant == "random":
            ppr = self.node_ppr(split)
            parts = random_partition(outputs, nb, seed=cfg.seed)
            aux = node_wise_aux(ppr, parts, cfg.k_per_output)
        else:
            raise ValueError(f"unknown IBMB variant: {cfg.variant}")
        return parts, aux

    def preprocess(self, split: str, for_inference: bool = False) -> List[PaddedBatch]:
        cfg = self.cfg
        # the partition span holds the split's PPR when it is not cached,
        # so preprocessing's timing holds it too, as it always has
        with obs.span("plan.partition") as s_part:
            parts, aux = self.partition(split, for_inference)
        with obs.span("plan.batches") as s_batch:
            batches = build_batches(
                self.ds.norm_graph, self.ds.features, self.ds.labels,
                parts, aux, cache_features=cfg.cache_features,
                pad_multiple=cfg.pad_multiple,
                bcsr_block=cfg.bcsr_block if cfg.backend == "bcsr" else None,
                reorder=cfg.reorder)
            if cfg.backend == "bcsr" and cfg.autotune and cfg.tune_blocks:
                # the autotuner's per-plan half: sweep tile-size candidates
                # by padded MXU work and retile to the winner (DESIGN.md §14)
                batches, _block = autotune.retune_tile_block(batches, cfg)
        # keyed by mode as well as split: preprocessing the same split for
        # training AND inference must not silently overwrite one timing.
        mode = "inference" if for_inference else "train"
        self.timings[f"preprocess/{split}/{mode}"] = \
            s_part.seconds + s_batch.seconds
        return batches

    def build_cache(self, batches: List[PaddedBatch]) -> BatchCache:
        return BatchCache(batches)

    def schedule(self, batches: List[PaddedBatch], num_epochs: int = 1) -> np.ndarray:
        labels = [b.labels[b.output_mask] for b in batches]
        return make_schedule(labels, self.ds.num_classes,
                             mode=self.cfg.schedule, num_epochs=num_epochs,
                             seed=self.cfg.seed)
