"""Streaming (out-of-core) plan construction (DESIGN.md §13).

The port's copy of ``repro.ooc.stream``, unchanged but for its imports:
a streamed plan equals the port's resident plan and the reference's
streamed plan bit for bit (``tests/test_torch_ooc.py``).

``IBMBPipeline.plan(split, out_of_core=True, store_dir=...)`` lands here.
The resident build holds every padded batch in memory at once
(``preprocess`` → ``BatchCache``); this builder produces a BIT-IDENTICAL
plan while never materializing more than one chunk of batches:

1. **Id-only partition** — ``pipe.partition(split)`` runs influence scores
   → output partition → auxiliary selection exactly as the resident path
   does (it IS the resident path: ``preprocess = partition +
   build_batches``), returning per-batch global-id lists. O(outputs · k)
   memory, no payload.
2. **Sizing sweep** — one structure-only pass over the batches measures the
   exact node/edge/output maxima the resident ``build_batches`` would have
   padded to (and, for the bcsr backend, the global column-tile count K
   after batch-local reordering). Chunked builds pass these as explicit
   caps, so every chunk pads to the SAME bucket the resident build picks —
   the precondition for bitwise-equal payload. One batch's induced
   subgraph is alive at a time.
3. **Chunked materialize + append** — ``build_batches`` runs over
   ``chunk_batches`` batches at a time (explicit caps + ``bcsr_pad_k``);
   each chunk's stacked fields are appended to the
   :class:`~repro_torch.ooc.store.PlanStore` and dropped. Per-chunk we keep only
   the small per-batch side products the plan header needs: real labels
   (schedule input), routing triplets, and the membership rows.
4. **Index + commit** — schedule via the same ``make_schedule`` call the
   resident path makes, routing via ``RoutingIndex.from_triplets`` over the
   concatenated chunk triplets (one stable sort ⇒ identical to a resident
   ``from_cache``), then ``finalize`` writes index + header (the header is
   the commit point — a crash mid-stream leaves nothing openable).

The returned :class:`~repro_torch.core.plan.Plan` is backed by a
:class:`~repro_torch.ooc.store.LazyBatchCache` with a bounded resident-batch
budget; its fingerprint, schedule, routing, membership, and per-batch
payload are bitwise equal to ``pipe.plan(split)``'s — the §13 acceptance
bar the equality tests pin.

The trade is deliberate: the sizing sweep re-derives each batch's induced
subgraph (and the bcsr pass re-tiles it), so streaming costs roughly one
extra structure pass of preprocessing time in exchange for O(chunk) peak
payload memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core import autotune
from repro_torch.core.batches import BatchCache, _round_up, build_batches
from repro_torch.core.plan import Plan, RoutingIndex, encode_backends
from repro_torch.core.scheduling import make_schedule
from repro_torch.faults import NO_FAULTS
from repro_torch.graph.csr import induced_subgraph
from repro_torch.ooc.store import PlanStore, PlanStoreWriter


@dataclasses.dataclass(frozen=True)
class OOCConfig:
    """Knobs of the out-of-core build/serve path (DESIGN.md §13).

    chunk_batches:    batches materialized per streaming append — peak
                      builder payload is ~chunk_batches padded batches.
    resident_batches: LazyBatchCache LRU budget of the returned plan —
                      peak serving payload is ~resident_batches batches.
    io_retries:       bounded retries of a transient per-batch read fault
                      (the ``batch_io`` point; checksum mismatches are
                      never retried).
    """
    chunk_batches: int = 8
    resident_batches: int = 8
    io_retries: int = 2


def _measure_caps(pipe, parts: List[np.ndarray], aux: List[np.ndarray]):
    """The sizing sweep: per-batch real (nodes, edges, outputs) counts plus
    the padded caps the resident ``build_batches`` would derive. Only one
    batch's induced subgraph exists at a time."""
    g = pipe.ds.norm_graph
    pad = pipe.cfg.pad_multiple
    nn_max = ne_max = no_max = 0
    for outs, a in zip(parts, aux):
        nodes = np.unique(np.concatenate([outs, a]))
        src, _dst, _w = induced_subgraph(g, nodes)
        nn_max = max(nn_max, len(nodes))
        ne_max = max(ne_max, len(src))
        no_max = max(no_max, len(outs))
    mn = _round_up(nn_max, pad)
    me = _round_up(max(ne_max, 1), pad)
    mo = _round_up(no_max, pad)
    return mn, me, mo


def _measure_bcsr(pipe, parts, aux, mn: int):
    """Tile-shape half of the sizing sweep: analytically derive, per
    candidate tile size, the padded-flops cost and the global column-tile
    count K over each batch's (reordered) adjacency —
    ``autotune.tile_shape_stats`` computes exactly what ``csr_to_bcsr``
    would emit, without materializing tiles. Returns ``(block, pad_k)``:
    the winning tile size (the SAME argmin the resident
    ``autotune.retune_tile_block`` takes, over the same edge sets) and the
    K chunks must pad to so batches built in different chunks share one
    tile-table shape."""
    from repro_torch.core.batches import batch_node_order
    g = pipe.ds.norm_graph
    cfg = pipe.cfg
    if cfg.autotune and cfg.tune_blocks:
        cand = autotune.tile_block_candidates(cfg, mn)
    else:
        cand = [math.gcd(cfg.bcsr_block, mn)]
    costs = {b: 0 for b in cand}
    kmax = {b: 1 for b in cand}
    for outs, a in zip(parts, aux):
        nodes = np.unique(np.concatenate([outs, a]))
        src, dst, w = induced_subgraph(g, nodes)
        if cfg.reorder != "none":
            perm = batch_node_order(len(nodes), src, dst,
                                    mode=cfg.reorder)
            inv = np.empty(len(nodes), np.int64)
            inv[perm] = np.arange(len(nodes))
            src = inv[src].astype(np.int32)
            dst = inv[dst].astype(np.int32)
        for b in cand:
            t, k = autotune.tile_shape_stats(src, dst, w, mn, b)
            costs[b] += t * b * b
            kmax[b] = max(kmax[b], k)
    win = autotune.pick_tile_block(costs)
    return win, kmax[win]


def stream_chunks(pipe, parts, aux, caps, pad_k: Optional[int],
                  writer: PlanStoreWriter, chunk: int,
                  bcsr_block: Optional[int] = None):
    """Stage 3 of the streaming build: materialize ``chunk`` batches at a
    time with the GLOBAL caps, append each chunk's stacked fields to
    ``writer``, and keep only the index-scale side products. Returns
    ``(labels, (trip_ids, trip_b, trip_r), members, decisions)`` —
    schedule input, routing triplets in batch-major order (batch indices
    local to this writer), the (B, max_nodes) membership rows, and the
    autotuner's per-batch ``(backends, block_fs, stats)`` lists
    (DESIGN.md §14; computed chunk by chunk through the same
    ``autotune.decide_batches`` the resident build runs). ``bcsr_block``
    overrides the configured tile size with the sweep winner. Shared by
    :func:`stream_plan` (one store) and ``repro_torch.ooc.shard.build_shards``
    (one store per contiguous batch range)."""
    cfg = pipe.cfg
    mn, me, mo = caps
    labels: List[np.ndarray] = []
    trip_ids, trip_b, trip_r = [], [], []
    members: List[np.ndarray] = []
    backs: List[str] = []
    bfs: List[int] = []
    bstats: List[dict] = []
    for s in range(0, len(parts), chunk):
        e = min(s + chunk, len(parts))
        batches = build_batches(
            pipe.ds.norm_graph, pipe.ds.features, pipe.ds.labels,
            parts[s:e], aux[s:e], cache_features=cfg.cache_features,
            pad_multiple=cfg.pad_multiple,
            max_nodes=mn, max_edges=me, max_outputs=mo,
            bcsr_block=(bcsr_block or cfg.bcsr_block)
            if cfg.backend == "bcsr" else None,
            reorder=cfg.reorder, bcsr_pad_k=pad_k)
        cb, cf, cs = autotune.decide_batches(batches, cfg)
        backs.extend(cb); bfs.extend(cf); bstats.extend(cs)
        cache = BatchCache(batches)        # one chunk resident, then dropped
        meta_counts = np.array(
            [[m["nodes"], m["edges"], m["outputs"]] for m in cache.meta],
            np.int64)
        writer.append(cache.fields, meta_counts)
        labels.extend(b.labels[b.output_mask] for b in batches)
        node_ids = np.stack([b.node_ids for b in batches])
        members.append(node_ids)
        # same row-major walk as RoutingIndex.from_cache, chunk offset
        # shifts batch indices into writer-local coordinates
        omask = np.stack([b.output_mask for b in batches])
        oidx = np.stack([np.maximum(b.output_idx, 0) for b in batches])
        b_loc, r = np.nonzero(omask)
        trip_ids.append(node_ids[b_loc, oidx[b_loc, r]].astype(np.int64))
        trip_b.append(b_loc.astype(np.int64) + s)
        trip_r.append(r)
    return labels, (trip_ids, trip_b, trip_r), members, (backs, bfs, bstats)


def stream_plan(pipe, split: str, for_inference: bool, store_dir: str,
                ooc: Optional[OOCConfig] = None, faults=NO_FAULTS) -> Plan:
    """Build ``pipe.plan(split, for_inference)`` out of core: stream chunks
    of batches into a :class:`PlanStore` at ``store_dir`` and return the
    lazily-backed plan. See the module docstring for the four stages."""
    ooc = ooc or OOCConfig()
    cfg = pipe.cfg
    mode = "inference" if for_inference else "train"
    with obs.span("plan.partition") as s_part:
        parts, aux = pipe.partition(split, for_inference)
    # the batches' span is opened twice: the caps' pass, then the stream
    with obs.span("plan.batches") as s_batch:
        caps = _measure_caps(pipe, parts, aux)
        pad_k = block = None
        if cfg.backend == "bcsr":
            block, pad_k = _measure_bcsr(pipe, parts, aux, caps[0])

    writer = PlanStoreWriter(store_dir)
    chunk = max(1, int(ooc.chunk_batches))
    try:
        with obs.span("plan.batches") as s_stream:
            labels, (trip_ids, trip_b, trip_r), members, decisions = \
                stream_chunks(pipe, parts, aux, caps, pad_k, writer, chunk,
                              bcsr_block=block)
        backs, bfs, bstats = decisions
        pipe.timings[f"preprocess/{split}/{mode}"] = \
            s_part.seconds + s_batch.seconds + s_stream.seconds
        with obs.span("plan.schedule") as s_sched:
            sched = make_schedule(labels, pipe.ds.num_classes,
                                  mode=cfg.schedule, num_epochs=1,
                                  seed=cfg.seed)
        with obs.span("plan.routing") as s_route:
            routing = RoutingIndex.from_triplets(np.concatenate(trip_ids),
                                                 np.concatenate(trip_b),
                                                 np.concatenate(trip_r))
        pipe.timings[f"plan/{split}/{mode}"] = \
            s_sched.seconds + s_route.seconds
        meta = dict(split=split, mode=mode, variant=cfg.variant,
                    backend=cfg.backend,
                    num_classes=int(pipe.ds.num_classes),
                    num_batches=len(parts), dataset=pipe.ds.name,
                    batch_stats=bstats,
                    out_of_core=True, chunk_batches=chunk)
        own = (f"ppr/{split}", f"preprocess/{split}/{mode}",
               f"plan/{split}/{mode}")
        writer.finalize(
            sched, routing, pipe.fingerprint(split, for_inference), meta,
            {k: v for k, v in pipe.timings.items() if k in own},
            node_ids=np.concatenate(members),
            ppr=pipe._ppr_cache.get(split),
            batch_backend=encode_backends(backs),
            batch_block_f=np.asarray(bfs, np.int32))
    except BaseException:
        writer.abort()
        raise
    store = PlanStore.open(store_dir, faults=faults,
                           io_retries=ooc.io_retries)
    return store.as_plan(resident_batches=ooc.resident_batches)
