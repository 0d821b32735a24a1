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

The port leaves out ``refresh`` (the dynamic-graph entry point, which
needs ``core/update.py``) and the out-of-core build (``ooc``); both are
queued in ROADMAP.md. Everything else matches ``repro.core.pipeline``
line for line, so the two packages build bitwise-identical plans.

Variants (paper Sec. 5 setup):
* "node"  — node-wise IBMB: PPR-distance partitioning + node-wise top-k aux.
* "batch" — batch-wise IBMB: graph partitioning + batch-wise (topic) PPR aux.
* "random" — fixed-random partition + node-wise aux (the paper's ablation).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.graph.datasets import GraphDataset
from repro_torch.core.ppr import push_appr, TopKPPR
from repro_torch.core.partition import ppr_distance_partition, graph_partition, random_partition
from repro_torch.core.aux_selection import node_wise_aux, batch_wise_aux
from repro_torch.core import autotune
from repro_torch.core.batches import PaddedBatch, build_batches, BatchCache
from repro_torch.core.plan import Plan, encode_backends, plan_fingerprint
from repro_torch.core.scheduling import make_schedule


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
            # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
            t0 = time.time()
            roots = self.ds.splits[split]
            self._ppr_cache[split] = push_appr(
                self.ds.graph, roots, alpha=self.cfg.alpha, eps=self.cfg.eps,
                max_iters=self.cfg.push_iters, topk=self.cfg.ppr_topk())
            # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
            self.timings[f"ppr/{split}"] = time.time() - t0
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
    def plan(self, split: str, for_inference: bool = False) -> Plan:
        """Run preprocessing end to end and freeze the result (DESIGN.md §8):
        batches + cache + schedule + routing index + fingerprint + timings.
        The returned Plan is what ``GNNInferenceEngine`` and ``Plan.save``
        consume."""
        mode = "inference" if for_inference else "train"
        batches = self.preprocess(split, for_inference=for_inference)
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        t0 = time.time()
        cache = BatchCache(batches)
        sched = self.schedule(batches)
        # the autotuner's per-batch half (DESIGN.md §14): backend decision
        # + tuned feature-tile width, stored in the plan (format v3) so
        # serving dispatches without re-measuring anything
        backs, bfs, bstats = autotune.decide_batches(batches, self.cfg)
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        self.timings[f"plan/{split}/{mode}"] = time.time() - t0
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
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        t0 = time.time()
        parts, aux = self.partition(split, for_inference)

        batches = build_batches(
            self.ds.norm_graph, self.ds.features, self.ds.labels,
            parts, aux, cache_features=cfg.cache_features,
            pad_multiple=cfg.pad_multiple,
            bcsr_block=cfg.bcsr_block if cfg.backend == "bcsr" else None,
            reorder=cfg.reorder)
        if cfg.backend == "bcsr" and cfg.autotune and cfg.tune_blocks:
            # the autotuner's per-plan half: sweep tile-size candidates by
            # padded MXU work and retile to the winner (DESIGN.md §14)
            batches, _block = autotune.retune_tile_block(batches, cfg)
        # keyed by mode as well as split: preprocessing the same split for
        # training AND inference must not silently overwrite one timing.
        mode = "inference" if for_inference else "train"
        # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
        self.timings[f"preprocess/{split}/{mode}"] = time.time() - t0
        return batches

    def build_cache(self, batches: List[PaddedBatch]) -> BatchCache:
        return BatchCache(batches)

    def schedule(self, batches: List[PaddedBatch], num_epochs: int = 1) -> np.ndarray:
        labels = [b.labels[b.output_mask] for b in batches]
        return make_schedule(labels, self.ds.num_classes,
                             mode=self.cfg.schedule, num_epochs=num_epochs,
                             seed=self.cfg.seed)
