"""Sharded plans: partition the output set along batch boundaries, serve
one shard per host (DESIGN.md §13).

The port's copy of ``repro.ooc.shard``. One repair: the owner table is
published through ``atomic_savez`` (the reference writes it with a plain
``np.savez`` though it documents both files as atomic); its bytes are the
same. ``ShardRouter.load`` builds the port's engines on ``device`` (``cuda``
unless the caller names another).

Out-of-core storage removes the RAM ceiling on ONE host; sharding removes
the single-host ceiling. A shard build runs the FULL split's partition +
sizing sweep exactly once (so every shard pads to the same global shape
bucket the resident plan would), then cuts the batch list into
``num_shards`` contiguous ranges and streams each range into its own
:class:`~repro_torch.ooc.store.PlanStore` at ``root/shard_NNNNN/``. Because
IBMB assigns each output node to exactly one batch, a batch-aligned cut IS
a partition of the output set — and because every shard's batches are the
GLOBAL plan's batches (same parts/aux, same caps, same bcsr K), a
shard-routed query returns logits bitwise identical to the resident
single-host engine. Re-planning each shard's outputs from scratch would
lose both properties: different partitions, different padding, different
floats.

``manifest.json`` at the root records, per shard, its batch range, the
shard plan's fingerprint, and a FINGERPRINT CHAIN

    chain_i = sha256(chain_{i-1} || fingerprint_i)[:16]

so the manifest's final ``chain`` commits to every shard plan in order: a
swapped, stale, or re-built shard breaks the chain even when its own store
is internally consistent (the §10 parent-chain idea applied across space
instead of time). ``owners.npz`` alongside maps every output node id to
its owner shard (first-batch-wins on duplicates, matching the resident
routing index), so a router can say "shard 3 owns this id" without
loading shard 3. Both are written atomically, manifest LAST — it is the
commit point of the build.

Serving: :class:`ShardRouter` loads any subset of shards (a multi-host
deployment loads one per host; ``shards=None`` loads all — the
single-host and test path), verifies the chain, and fans each query out
to owner-shard engines, merging logits back in query order. An id owned
by a shard this router did NOT load raises a clear error naming the shard
to load; an id no shard owns raises the plan-level KeyError — never a
silent wrong answer.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.plan import PlanFormatError, RoutingIndex, encode_backends
from repro_torch.core.scheduling import make_schedule
from repro_torch.faults import NO_FAULTS
from repro_torch.ioutil import atomic_savez as _atomic_savez
from repro_torch.ioutil import atomic_write_text as _atomic_write_text
from repro_torch.ooc.store import PlanStore, PlanStoreWriter
from repro_torch.ooc.stream import (OOCConfig, _measure_bcsr, _measure_caps,
                              stream_chunks)

_MANIFEST = "manifest.json"
_OWNERS = "owners.npz"
SHARD_FORMAT = "ibmb-plan-shards"


def _chain(prev: str, fingerprint: str) -> str:
    return hashlib.sha256((prev + fingerprint).encode()).hexdigest()[:16]


def shard_name(i: int) -> str:
    return f"shard_{i:05d}"


def _shard_split(split: str, i: int, num_shards: int) -> str:
    return f"{split}@shard{i}/{num_shards}"


def build_shards(pipe, split: str, num_shards: int, root: str,
                 for_inference: bool = False,
                 ooc: Optional[OOCConfig] = None) -> Dict:
    """Cut ``split``'s batch list into ``num_shards`` contiguous ranges and
    stream each into its own out-of-core store under ``root``; commit the
    chained manifest + owner table. Returns the manifest dict.

    Partition, sizing, and (for bcsr) the global tile count run ONCE over
    the full split, so shard batches are bit-identical to the resident
    plan's — the bitwise-equality bar shard-routed serving is held to."""
    import dataclasses as _dc
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    os.makedirs(root, exist_ok=True)
    if os.path.exists(os.path.join(root, _MANIFEST)):
        raise ValueError(f"{root}: already holds a committed shard build "
                         f"— refusing to overwrite")
    ooc = ooc or OOCConfig()
    cfg = pipe.cfg
    mode = "inference" if for_inference else "train"

    # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
    t0 = time.time()
    parts, aux = pipe.partition(split, for_inference)
    if num_shards > len(parts):
        raise ValueError(f"cannot cut {len(parts)} batches into "
                         f"{num_shards} shards — lower num_shards or "
                         f"max_outputs_per_batch")
    caps = _measure_caps(pipe, parts, aux)
    pad_k = block = None
    if cfg.backend == "bcsr":
        block, pad_k = _measure_bcsr(pipe, parts, aux, caps[0])
    ranges = np.array_split(np.arange(len(parts)), num_shards)

    # one pipeline over a dataset carrying the shard output-splits: each
    # shard fingerprint is the ordinary (config, dataset, shard-split, mode)
    # fingerprint, so per-shard load-time checking needs no new scheme. The
    # content sha is reused, not recomputed.
    splits = dict(pipe.ds.splits)
    shard_outputs = [np.sort(np.concatenate([parts[b] for b in r]))
                     for r in ranges]
    for i, ids in enumerate(shard_outputs):
        splits[_shard_split(split, i, num_shards)] = ids.astype(np.int64)
    spipe = type(pipe)(_dc.replace(pipe.ds, splits=splits), cfg)
    spipe._content_sha_cache = pipe._content_sha_cache or pipe._content_sha()

    chain = ""
    shards: List[Dict] = []
    own_ids, own_shard = [], []
    chunk = max(1, int(ooc.chunk_batches))
    for i, brange in enumerate(ranges):
        sdir = os.path.join(root, shard_name(i))
        writer = PlanStoreWriter(sdir)
        try:
            sparts = [parts[b] for b in brange]
            saux = [aux[b] for b in brange]
            labels, (tids, tb, tr), members, (backs, bfs, bstats) = \
                stream_chunks(pipe, sparts, saux, caps, pad_k, writer,
                              chunk, bcsr_block=block)
            sched = make_schedule(labels, pipe.ds.num_classes,
                                  mode=cfg.schedule, num_epochs=1,
                                  seed=cfg.seed)
            routing = RoutingIndex.from_triplets(np.concatenate(tids),
                                                 np.concatenate(tb),
                                                 np.concatenate(tr))
            fp = spipe.fingerprint(_shard_split(split, i, num_shards),
                                   for_inference)
            meta = dict(split=split, mode=mode, variant=cfg.variant,
                        backend=cfg.backend,
                        num_classes=int(pipe.ds.num_classes),
                        num_batches=len(brange), dataset=pipe.ds.name,
                        shard=i, num_shards=num_shards,
                        batch_start=int(brange[0]), batch_stats=bstats)
            writer.finalize(sched, routing, fp, meta, {},
                            node_ids=np.concatenate(members),
                            batch_backend=encode_backends(backs),
                            batch_block_f=np.asarray(bfs, np.int32))
        except BaseException:
            writer.abort()
            raise
        chain = _chain(chain, fp)
        shards.append(dict(dir=shard_name(i), fingerprint=fp, chain=chain,
                           num_outputs=int(len(shard_outputs[i])),
                           num_batches=int(len(brange)),
                           batch_start=int(brange[0])))
        # owner table triplets: routing already dedupes within a shard
        # (first batch wins); cross-shard duplicates are resolved below by
        # the same rule via a stable sort on (id, shard order).
        own_ids.append(routing.node_ids)
        own_shard.append(np.full(len(routing.node_ids), i, np.int32))

    ids = np.concatenate(own_ids)
    owner = np.concatenate(own_shard)
    order = np.argsort(ids, kind="stable")   # ties keep lower shard = the
    ids, owner = ids[order], owner[order]    # earlier batch, as resident
    keep = np.ones(len(ids), bool)           # routing would pick
    if len(ids) > 1:
        keep[1:] = ids[1:] != ids[:-1]
    _atomic_savez(os.path.join(root, _OWNERS), node_ids=ids[keep],
                  shard=owner[keep])
    manifest = dict(format=SHARD_FORMAT, version=1, split=split, mode=mode,
                    num_shards=num_shards, dataset=pipe.ds.name,
                    num_batches=len(parts), chain=chain, shards=shards,
                    # lint: allow(determinism) — timing telemetry only, never fed into the plan payload or fingerprint
                    build_seconds=time.time() - t0)
    _atomic_write_text(os.path.join(root, _MANIFEST),
                       json.dumps(manifest, indent=1))
    return manifest


def load_manifest(root: str) -> Dict:
    """Read + verify a shard manifest: format and the fingerprint chain
    recomputed from the per-shard fingerprints must hold before anything
    is served."""
    mpath = os.path.join(root, _MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(
            f"{root}: no committed shard build here (missing {_MANIFEST})")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except ValueError as e:
        raise PlanFormatError(f"{mpath}: corrupt manifest ({e})") from e
    if manifest.get("format") != SHARD_FORMAT:
        raise PlanFormatError(f"{mpath}: not a shard manifest "
                              f"(format={manifest.get('format')!r})")
    if len(manifest["shards"]) != int(manifest["num_shards"]):
        raise PlanFormatError(f"{mpath}: {len(manifest['shards'])} shard "
                              f"entries, header says "
                              f"{manifest['num_shards']}")
    chain = ""
    for i, s in enumerate(manifest["shards"]):
        chain = _chain(chain, s["fingerprint"])
        if chain != s["chain"]:
            raise PlanFormatError(
                f"{mpath}: fingerprint chain breaks at shard {i} "
                f"(expected {chain!r}, manifest says {s['chain']!r}) — a "
                f"shard plan was swapped or re-built out of order")
    if chain != manifest.get("chain", ""):
        raise PlanFormatError(f"{mpath}: final chain mismatch")
    return manifest


class PlanShard:
    """One loaded shard: its store, lazy plan, and engine."""

    def __init__(self, index: int, store: PlanStore, plan, engine):
        self.index = index
        self.store = store
        self.plan = plan
        self.engine = engine


class ShardRouter:
    """Route per-node queries across shard engines (DESIGN.md §13).

    The owner table gives O(log |outputs|) owner lookup without loading
    every shard; loaded shards answer through their own
    :class:`~repro_torch.serve.gnn_engine.GNNInferenceEngine` (lazy batch
    faulting under the shard's resident budget, per-shard output LRU).
    Logits are bitwise identical to the resident single-host engine —
    shard batches ARE the global plan's batches."""

    def __init__(self, manifest: Dict, owners: Dict[str, np.ndarray],
                 shards: Dict[int, PlanShard]):
        self.manifest = manifest
        self.owner_ids = np.asarray(owners["node_ids"], np.int64)
        self.owner_shard = np.asarray(owners["shard"], np.int32)
        self.shards = shards
        self.stats = dict(requests=0, nodes=0, shard_misses=0)

    @staticmethod
    def load(root: str, model_cfg, params,
             shards: Optional[Sequence[int]] = None,
             resident_batches: int = 8, cache_batches: int = 8,
             faults=NO_FAULTS, io_retries: int = 2,
             device=None) -> "ShardRouter":
        """Open ``root`` and serve the given shard indices (``None`` = all;
        a multi-host deployment passes its own shard). Chain-verified
        manifest first; each shard store opens O(metadata) and faults
        batches in lazily, so loading one shard of a huge build is cheap.
        Each shard's engine runs on ``device`` (``cuda`` unless named)."""
        from repro_torch.serve.gnn_engine import GNNInferenceEngine
        manifest = load_manifest(root)
        opath = os.path.join(root, _OWNERS)
        try:
            with np.load(opath, allow_pickle=False) as z:
                owners = {k: z[k] for k in ("node_ids", "shard")}
        except FileNotFoundError:
            raise PlanFormatError(f"{root}: owner table missing ({_OWNERS})")
        except Exception as e:
            raise PlanFormatError(f"{opath}: corrupt owner table "
                                  f"({type(e).__name__}: {e})") from e
        want = range(manifest["num_shards"]) if shards is None else shards
        loaded: Dict[int, PlanShard] = {}
        for i in want:
            i = int(i)
            if not 0 <= i < manifest["num_shards"]:
                raise ValueError(f"shard {i} out of range "
                                 f"[0, {manifest['num_shards']})")
            entry = manifest["shards"][i]
            store = PlanStore.open(os.path.join(root, entry["dir"]),
                                   faults=faults, io_retries=io_retries)
            if store.fingerprint != entry["fingerprint"]:
                raise PlanFormatError(
                    f"shard {i}: store fingerprint {store.fingerprint!r} "
                    f"does not match the manifest "
                    f"({entry['fingerprint']!r}) — chain broken on disk")
            plan = store.as_plan(resident_batches=resident_batches)
            engine = GNNInferenceEngine(plan, model_cfg, params,
                                        cache_batches=cache_batches,
                                        device=device)
            loaded[i] = PlanShard(i, store, plan, engine)
        return ShardRouter(manifest, owners, loaded)

    def owner(self, node_ids: Sequence[int]) -> np.ndarray:
        """Owner shard per query id; KeyError for ids no shard owns."""
        q = np.asarray(node_ids, dtype=np.int64).ravel()
        pos = np.searchsorted(self.owner_ids, q)
        safe = np.minimum(pos, max(len(self.owner_ids) - 1, 0))
        bad = (len(self.owner_ids) == 0) | (pos >= len(self.owner_ids)) | \
            (self.owner_ids[safe] != q)
        if np.any(bad):
            missing = q[bad] if len(q) else q
            raise KeyError(f"node ids not covered by any shard: "
                           f"{missing[:8].tolist()}"
                           f"{'...' if len(missing) > 8 else ''}")
        return self.owner_shard[safe]

    def query(self, node_ids: Sequence[int]) -> np.ndarray:
        """Logits in query order, fanned out across owner shards. KeyError
        when an owner shard is not loaded (says which one to route to)."""
        q = np.asarray(node_ids, dtype=np.int64).ravel()
        own = self.owner(q)
        self.stats["requests"] += 1
        self.stats["nodes"] += len(q)
        out = None
        for si in np.unique(own):
            shard = self.shards.get(int(si))
            if shard is None:
                self.stats["shard_misses"] += 1
                raise KeyError(
                    f"node ids {q[own == si][:8].tolist()} are owned by "
                    f"shard {int(si)}, which this router did not load "
                    f"(loaded: {sorted(self.shards)}) — route the request "
                    f"to the host serving that shard")
            sel = own == si
            lg = shard.engine.query(q[sel])
            if out is None:
                out = np.empty((len(q), lg.shape[1]), lg.dtype)
            out[sel] = lg
        if out is None:
            first = next(iter(self.shards.values()), None)
            width = (first.plan.meta.get("num_classes", 0) if first else 0)
            return np.zeros((0, width), np.float32)
        return out

    def shards_hit(self, node_ids: Sequence[int]) -> int:
        """How many distinct shards a query touches (bench evidence that
        routed traffic really spans shards)."""
        return len(np.unique(self.owner(node_ids)))

    def snapshot(self) -> Dict:
        """Router + per-shard engine/cache observability (§11 idiom)."""
        return dict(self.stats,
                    loaded=sorted(self.shards),
                    num_shards=int(self.manifest["num_shards"]),
                    per_shard={i: dict(engine=s.engine.stats,
                                       cache=s.plan.cache.snapshot())
                               for i, s in self.shards.items()})
