"""Baseline mini-batching methods the paper compares against (Sec. 5).

All produce the same PaddedBatch format as IBMB so that model/trainer code is
shared and the comparison is fair (paper: "the same training pipeline for all
methods"). Methods that resample per epoch are flagged `fixed = False` — their
per-epoch resampling cost is exactly the overhead the paper attributes to
them; we measure it in the benchmarks.

* NeighborSampling  — GraphSAGE [21]: per-layer fanout sampling per output.
* LADIES            — [42]: layer-dependent importance sampling (per-batch
                      node budget per layer; we take the union of layer
                      samples and run on the induced subgraph — faithful to
                      the shared-activation structure at subgraph level).
* GraphSAINT-RW     — [40]: random-walk sampled subgraphs; outputs = training
                      nodes inside the sample.
* ClusterGCN        — [7]: fixed graph partitions; aux = partition itself
                      (no influence-based aux selection — the ablation IBMB
                      beats).
* ShadowPPR         — [41]: per-output top-k PPR subgraphs, batched randomly
                      WITHOUT output partitioning; per-node subgraphs are
                      disjoint copies (duplicated computation — its known
                      cost).
* FullBatch         — chunked full-graph inference baseline.

The port's copy of ``repro.graph.sampling`` (numpy), with its imports
renamed, so the trainer takes a resampling batcher as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.graph.csr import CSRGraph, induced_subgraph
from repro_torch.graph.datasets import GraphDataset
from repro_torch.core.batches import PaddedBatch, build_batches
from repro_torch.core.ppr import push_appr, TopKPPR
from repro_torch.core.partition import graph_partition, random_partition


class Batcher:
    """Interface: `epoch_batches(rng_epoch)` returns the batch list; `fixed`
    tells the trainer whether re-generation per epoch is required."""

    fixed: bool = True
    name: str = "batcher"

    def __init__(self, ds: GraphDataset, split: str = "train"):
        self.ds = ds
        self.split = split
        self.outputs = ds.splits[split]

    def epoch_batches(self, epoch: int = 0) -> List[PaddedBatch]:
        raise NotImplementedError

    # shape caps shared across epochs so one executable serves all epochs
    _caps = None

    def _build(self, parts, aux) -> List[PaddedBatch]:
        pad = 128
        if self._caps is None:
            batches = build_batches(self.ds.norm_graph, self.ds.features,
                                    self.ds.labels, parts, aux, pad_multiple=pad)
            b0 = batches[0]
            # leave headroom for resampling variance
            self._caps = (int(b0.node_ids.shape[0] * 1.5) // pad * pad + pad,
                          int(b0.edge_src.shape[0] * 1.5) // pad * pad + pad,
                          b0.output_idx.shape[0])
            return batches
        mn, me, mo = self._caps
        return build_batches(self.ds.norm_graph, self.ds.features,
                             self.ds.labels, parts, aux, pad_multiple=pad,
                             max_nodes=mn, max_edges=me, max_outputs=mo)


class NeighborSampling(Batcher):
    fixed = False
    name = "neighbor_sampling"

    def __init__(self, ds: GraphDataset, split: str = "train",
                 num_batches: int = 12, fanouts: Sequence[int] = (6, 5, 5),
                 seed: int = 0):
        super().__init__(ds, split)
        self.num_batches = num_batches
        self.fanouts = list(fanouts)
        self.seed = seed

    def epoch_batches(self, epoch: int = 0) -> List[PaddedBatch]:
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(self.outputs)
        parts = [np.sort(c).astype(np.int32)
                 for c in np.array_split(perm, self.num_batches) if len(c)]
        aux = []
        g = self.ds.graph
        for batch in parts:
            frontier = batch
            nodes = [batch.astype(np.int64)]
            for fanout in self.fanouts:
                nxt = []
                for u in frontier:
                    nb = g.neighbors(int(u))
                    if len(nb) > fanout:
                        nb = rng.choice(nb, size=fanout, replace=False)
                    nxt.append(nb.astype(np.int64))
                frontier = np.unique(np.concatenate(nxt)) if nxt else np.zeros(0, np.int64)
                nodes.append(frontier)
            aux.append(np.unique(np.concatenate(nodes)).astype(np.int32))
        return self._build(parts, aux)


class Ladies(Batcher):
    fixed = False
    name = "ladies"

    def __init__(self, ds: GraphDataset, split: str = "train",
                 num_batches: int = 12, nodes_per_layer: int = 2048,
                 num_layers: int = 3, seed: int = 0):
        super().__init__(ds, split)
        self.num_batches = num_batches
        self.npl = nodes_per_layer
        self.num_layers = num_layers
        self.seed = seed
        # column-squared-norm importance ∝ Σ_u A_uv² (precomputed once)
        m = ds.norm_graph.to_scipy()
        self.col_imp = np.asarray(m.multiply(m).sum(axis=0)).ravel() + 1e-12
        self.csc = m.tocsc()

    def epoch_batches(self, epoch: int = 0) -> List[PaddedBatch]:
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(self.outputs)
        parts = [np.sort(c).astype(np.int32)
                 for c in np.array_split(perm, self.num_batches) if len(c)]
        aux = []
        m = self.ds.norm_graph.to_scipy()
        for batch in parts:
            layers = [batch.astype(np.int64)]
            rows = batch
            for _ in range(self.num_layers):
                # candidate columns restricted to rows' neighborhoods
                sub = m[rows]
                cand = np.unique(sub.indices)
                if len(cand) == 0:
                    break
                p = self.col_imp[cand]
                p = p / p.sum()
                k = min(self.npl, len(cand))
                sel = rng.choice(cand, size=k, replace=False, p=p)
                layers.append(sel.astype(np.int64))
                rows = sel
            aux.append(np.unique(np.concatenate(layers)).astype(np.int32))
        return self._build(parts, aux)


class GraphSaintRW(Batcher):
    fixed = False
    name = "graphsaint_rw"

    def __init__(self, ds: GraphDataset, split: str = "train",
                 num_steps: int = 8, batch_roots: int = 2000,
                 walk_length: int = 2, seed: int = 0):
        super().__init__(ds, split)
        self.num_steps = num_steps
        self.batch_roots = batch_roots
        self.walk_length = walk_length
        self.seed = seed
        self._train_mask = np.zeros(ds.num_nodes, bool)
        self._train_mask[self.outputs] = True

    def _walk(self, rng, roots: np.ndarray) -> np.ndarray:
        g = self.ds.graph
        nodes = [roots.astype(np.int64)]
        cur = roots
        for _ in range(self.walk_length):
            nxt = np.empty_like(cur)
            for i, u in enumerate(cur):
                nb = g.neighbors(int(u))
                nxt[i] = nb[rng.integers(len(nb))] if len(nb) else u
            nodes.append(nxt.astype(np.int64))
            cur = nxt
        return np.unique(np.concatenate(nodes))

    def epoch_batches(self, epoch: int = 0) -> List[PaddedBatch]:
        rng = np.random.default_rng(self.seed + epoch)
        parts, aux = [], []
        for _ in range(self.num_steps):
            roots = rng.choice(self.outputs, size=min(self.batch_roots, len(self.outputs)),
                               replace=False)
            sample = self._walk(rng, roots)
            outs = sample[self._train_mask[sample]]
            if len(outs) == 0:
                outs = roots[:1].astype(np.int64)
            parts.append(np.sort(outs).astype(np.int32))
            aux.append(sample.astype(np.int32))
        return self._build(parts, aux)


class ClusterGCN(Batcher):
    fixed = True
    name = "cluster_gcn"

    def __init__(self, ds: GraphDataset, split: str = "train",
                 num_batches: int = 8, method: str = "fennel", seed: int = 0):
        super().__init__(ds, split)
        from repro_torch.core.partition import _fennel, _louvain  # reuse partitioners
        if method == "fennel":
            assign = _fennel(ds.graph, num_batches, seed=seed)
        else:
            assign = _louvain(ds.graph, seed=seed)
        parts, aux = [], []
        for p in np.unique(assign):
            members = np.where(assign == p)[0].astype(np.int32)
            outs = members[np.isin(members, self.outputs)]
            if len(outs) == 0:
                continue
            parts.append(np.sort(outs))
            aux.append(members)     # aux = whole partition (no influence sel.)
        self._batches = self._build(parts, aux)

    def epoch_batches(self, epoch: int = 0) -> List[PaddedBatch]:
        return self._batches


class ShadowPPR(Batcher):
    fixed = True
    name = "shadow_ppr"

    def __init__(self, ds: GraphDataset, split: str = "train",
                 k: int = 16, outputs_per_batch: int = 256,
                 alpha: float = 0.25, eps: float = 2e-4, seed: int = 0):
        super().__init__(ds, split)
        ppr = push_appr(ds.graph, self.outputs, alpha=alpha, eps=eps,
                        max_iters=3, topk=k)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self.outputs))
        nb = max(1, len(self.outputs) // outputs_per_batch)
        groups = np.array_split(perm, nb)
        # Disjoint-union batches: each output node's subgraph is its own copy.
        self._batches = []
        raw = []
        for grp in groups:
            # build one disjoint union graph per group
            all_nodes, all_src, all_dst, all_w, out_local, out_ids = [], [], [], [], [], []
            offset = 0
            for gi in grp:
                nodes, _ = ppr.row(gi)
                nodes = np.unique(np.concatenate([nodes, [ppr.roots[gi]]])).astype(np.int64)
                src, dst, w = induced_subgraph(ds.norm_graph, nodes)
                all_nodes.append(nodes)
                all_src.append(src + offset)
                all_dst.append(dst + offset)
                all_w.append(w)
                out_local.append(offset + int(np.searchsorted(nodes, ppr.roots[gi])))
                out_ids.append(int(ppr.roots[gi]))
                offset += len(nodes)
            raw.append((np.concatenate(all_nodes), np.concatenate(all_src),
                        np.concatenate(all_dst), np.concatenate(all_w),
                        np.array(out_local, np.int32), np.array(out_ids, np.int64)))
        pad = 128
        mn = max(len(r[0]) for r in raw); mn = (mn + pad - 1) // pad * pad
        me = max(len(r[1]) for r in raw); me = (me + pad - 1) // pad * pad
        mo = max(len(r[4]) for r in raw); mo = (mo + pad - 1) // pad * pad
        for nodes, src, dst, w, out_local, out_ids in raw:
            nn, ne, no = len(nodes), len(src), len(out_local)
            node_ids = np.full(mn, -1, np.int32); node_ids[:nn] = nodes
            node_mask = np.zeros(mn, bool); node_mask[:nn] = True
            es = np.zeros(me, np.int32); ed = np.zeros(me, np.int32)
            ew = np.zeros(me, np.float32); em = np.zeros(me, bool)
            es[:ne] = src; ed[:ne] = dst; ew[:ne] = w; em[:ne] = True
            oi = np.full(mo, -1, np.int32); oi[:no] = out_local
            om = np.zeros(mo, bool); om[:no] = True
            lab = np.zeros(mo, np.int32); lab[:no] = ds.labels[out_ids]
            feats = np.zeros((mn, ds.features.shape[1]), np.float32)
            feats[:nn] = ds.features[nodes]
            self._batches.append(PaddedBatch(node_ids, node_mask, es, ed, ew, em,
                                             oi, om, feats, lab))

    def epoch_batches(self, epoch: int = 0) -> List[PaddedBatch]:
        return self._batches


class FullBatch(Batcher):
    """Whole graph as one batch (chunked on GPU in the paper; one padded batch
    here). Used for 'full-batch inference' comparisons."""
    fixed = True
    name = "full_batch"

    def __init__(self, ds: GraphDataset, split: str = "train"):
        super().__init__(ds, split)
        all_nodes = np.arange(ds.num_nodes, dtype=np.int32)
        self._batches = build_batches(
            ds.norm_graph, ds.features, ds.labels,
            [self.outputs], [all_nodes], pad_multiple=128)

    def epoch_batches(self, epoch: int = 0) -> List[PaddedBatch]:
        return self._batches


def make_batcher(name: str, ds: GraphDataset, split: str = "train", **kw) -> Batcher:
    cls = {
        "neighbor_sampling": NeighborSampling,
        "ladies": Ladies,
        "graphsaint_rw": GraphSaintRW,
        "cluster_gcn": ClusterGCN,
        "shadow_ppr": ShadowPPR,
        "full_batch": FullBatch,
    }[name]
    return cls(ds, split, **kw)
