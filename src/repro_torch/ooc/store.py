"""Mmap-backed, per-batch-addressable Plan storage (DESIGN.md §13).

The port's copy of ``repro.ooc.store``. The directory format is the
reference's, so each package opens the other's stores. One repair: the
crc32 of a batch is taken over the array's buffer, not over a ``tobytes``
copy of it (the same checksum, one pass less over each batch read).
Batches come back as host numpy arrays; the engines stage them to the
device (``repro_torch.device.stage``) as they stage resident batches.

The paper's systems insight — precomputed batches laid out consecutively —
is exactly what makes disk-backed plans practical: reading batch ``i`` of
field ``f`` is ONE contiguous slice of one flat file, never a random
neighbor gather. ``PlanStore`` turns that into a storage format:

    store_dir/
      header.json        # metadata, field dtypes/shapes, chunk table —
                         # written LAST (tmp + os.replace): its presence is
                         # the commit point of a build. A crash mid-stream
                         # leaves no header ⇒ open() refuses the directory.
      index.npz          # schedule, routing index, per-batch meta counts,
                         # membership (node_ids), warm PPR state, and the
                         # (B, num_fields) per-batch crc32 table
      fields/<name>.bin  # raw C-order little-endian bytes, shape
                         # (num_batches, *field_shape): batch i IS the
                         # byte range [i*rowbytes, (i+1)*rowbytes)

Batches are appended in CHUNKS (a few batches at a time) by the streaming
builder (``repro_torch.ooc.stream``): each append is a sequential write to every
field file, so building never holds more than one chunk of padded payload.

Reading is the mirror image. ``PlanStore.open`` reads header + index only
(O(metadata)); field payload is exposed two ways:

* ``mmap_fields()`` — a dict of read-only ``np.memmap`` views shaped like a
  resident ``BatchCache.fields``, for whole-plan consumers (``check_routing``,
  schedule re-derivation) that touch a few small fields: the OS pages in
  only what is read.
* ``read_batch(i)`` — the serving path: copy batch i's slice of every field
  out of the maps (a contiguous read), verify its crc32 against the index
  table, and hand back an ordinary dict. Transient ``OSError`` retries up
  to ``io_retries`` times (the ``batch_io`` fault point fires per attempt,
  DESIGN.md §12); a checksum mismatch raises ``PlanFormatError`` — corrupt
  bytes are never retried and never served.

``LazyBatchCache`` wraps a store in the ``BatchCache`` interface with a
bounded RESIDENT-BATCH BUDGET: at most ``resident_batches`` verified batch
dicts are held (LRU eviction of cold batches), so ``GNNInferenceEngine`` /
``AsyncGNNEngine`` fault in only the batches requests route to and
``PrefetchLoader`` streams training super-steps from disk at O(budget)
host memory however large the plan is.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.batches import BatchCache
from repro_torch.core.plan import Plan, PlanFormatError, RoutingIndex, _frozen
from repro_torch.core.ppr import TopKPPR
from repro_torch.faults import NO_FAULTS, FaultStats
from repro_torch.ioutil import atomic_savez as _atomic_savez
from repro_torch.ioutil import atomic_write_text as _atomic_write_text

STORE_VERSION = 1
_HEADER = "header.json"
_INDEX = "index.npz"
_FIELD_DIR = "fields"


def _row_crc32(stacked: np.ndarray) -> np.ndarray:
    """crc32 of each leading-axis slice of a stacked field array."""
    a = np.ascontiguousarray(stacked)
    flat = a.reshape(len(a), -1)
    return np.array([zlib.crc32(flat[i]) for i in range(len(a))],
                    dtype=np.uint32)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Per-batch dtype/shape of one stored field."""
    name: str
    dtype: str                    # numpy dtype string, e.g. "float32"
    shape: tuple                  # per-batch shape (without the batch axis)

    @property
    def rowbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * int(np.prod(self.shape,
                                                               dtype=np.int64)))


class PlanStoreWriter:
    """Append-only builder of a ``PlanStore`` directory.

    ``append(stacked_fields, meta_counts)`` writes one chunk of batches
    sequentially to every field file; ``finalize(...)`` writes the index
    and then the header — the header is the COMMIT: until it exists,
    ``PlanStore.open`` refuses the directory, so a crash mid-build can
    never be served (§12's atomic-artifact rule applied to a directory)."""

    def __init__(self, path: str):
        self.path = path
        if os.path.exists(os.path.join(path, _HEADER)):
            raise ValueError(f"{path}: already holds a finalized PlanStore "
                             f"— refusing to overwrite")
        os.makedirs(os.path.join(path, _FIELD_DIR), exist_ok=True)
        self.specs: List[FieldSpec] = []
        self._files: Dict[str, "object"] = {}
        self._crcs: Dict[str, List[np.ndarray]] = {}
        self._meta: List[np.ndarray] = []
        self._chunks: List[Dict[str, int]] = []
        self.num_batches = 0
        self._finalized = False

    def append(self, stacked: Dict[str, np.ndarray],
               meta_counts: np.ndarray) -> None:
        """Write one chunk: ``stacked[f]`` is (C, *field_shape) for every
        field, ``meta_counts`` is (C, 3) real (nodes, edges, outputs)."""
        count = len(next(iter(stacked.values())))
        if not self.specs:                      # first chunk fixes the schema
            self.specs = [FieldSpec(k, str(v.dtype), tuple(v.shape[1:]))
                          for k, v in sorted(stacked.items())]
            for s in self.specs:
                self._files[s.name] = open(
                    os.path.join(self.path, _FIELD_DIR, s.name + ".bin"),
                    "wb")
                self._crcs[s.name] = []
        if set(stacked) != {s.name for s in self.specs}:
            raise ValueError(f"chunk fields {sorted(stacked)} != store "
                             f"schema {[s.name for s in self.specs]}")
        for s in self.specs:
            v = np.ascontiguousarray(stacked[s.name])
            if v.shape[1:] != s.shape or str(v.dtype) != s.dtype:
                raise ValueError(
                    f"field {s.name!r}: chunk is {v.dtype}{v.shape[1:]} but "
                    f"the store schema says {s.dtype}{s.shape} — chunked "
                    f"builds must share one padded shape bucket")
            self._files[s.name].write(v.tobytes())
            self._crcs[s.name].append(_row_crc32(v))
        self._meta.append(np.asarray(meta_counts, np.int64).reshape(count, 3))
        self._chunks.append({"start": self.num_batches, "count": count})
        self.num_batches += count

    def finalize(self, schedule: np.ndarray, routing: RoutingIndex,
                 fingerprint: str, meta: Dict, timings: Dict[str, float],
                 version: int = 0, parent: str = "",
                 node_ids: Optional[np.ndarray] = None,
                 ppr: Optional[TopKPPR] = None,
                 batch_backend: Optional[np.ndarray] = None,
                 batch_block_f: Optional[np.ndarray] = None) -> None:
        assert self.num_batches > 0, "finalize() before any append()"
        for f in self._files.values():
            f.flush()
            os.fsync(f.fileno())
            f.close()
        crc_table = np.stack(
            [np.concatenate(self._crcs[s.name]) for s in self.specs], axis=1)
        index = {
            "schedule": np.asarray(schedule, np.int64),
            "route/node_ids": np.asarray(routing.node_ids, np.int64),
            "route/batch": np.asarray(routing.batch, np.int32),
            "route/row": np.asarray(routing.row, np.int32),
            "meta_counts": np.concatenate(self._meta),
            "batch_crc32": crc_table,
        }
        if node_ids is not None:
            index["batch_node_ids"] = np.asarray(node_ids, np.int32)
        # autotuner decisions (plan format v3, DESIGN.md §14) ride in the
        # index next to the other per-batch metadata
        if batch_backend is not None:
            index["batch_backend"] = np.asarray(batch_backend, np.int8)
        if batch_block_f is not None:
            index["batch_block_f"] = np.asarray(batch_block_f, np.int32)
        if ppr is not None:
            index["ppr/roots"] = ppr.roots
            index["ppr/indices"] = ppr.indices
            index["ppr/values"] = ppr.values
        _atomic_savez(os.path.join(self.path, _INDEX), **index)
        header = {
            "format": "ibmb-plan-store",
            "store_version": STORE_VERSION,
            "fingerprint": fingerprint,
            "plan_version": int(version),
            "parent": parent,
            "meta": dict(meta),
            "timings": {k: float(v) for k, v in timings.items()},
            "num_batches": int(self.num_batches),
            "fields": [dataclasses.asdict(s) for s in self.specs],
            "chunks": self._chunks,
        }
        _atomic_write_text(os.path.join(self.path, _HEADER),
                           json.dumps(header, indent=1))
        self._finalized = True

    def abort(self) -> None:
        """Drop a half-written build (nothing was ever visible to open)."""
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass


class PlanStore:
    """Read side of the store: header + index resident, payload mmap'd."""

    def __init__(self, path: str, header: Dict, index: Dict[str, np.ndarray],
                 faults=NO_FAULTS, io_retries: int = 2):
        self.path = path
        self.header = header
        self.fingerprint = header.get("fingerprint", "")
        self.meta = header.get("meta", {})
        self.timings = header.get("timings", {})
        self.num_batches = int(header["num_batches"])
        self.specs = [FieldSpec(f["name"], f["dtype"], tuple(f["shape"]))
                      for f in header["fields"]]
        self.schedule = index["schedule"]
        self.routing = RoutingIndex(_frozen(index["route/node_ids"]),
                                    _frozen(index["route/batch"]),
                                    _frozen(index["route/row"]))
        self.meta_counts = index["meta_counts"]
        self.batch_crc32 = index["batch_crc32"]
        self.node_ids = index.get("batch_node_ids")
        self.batch_backend = index.get("batch_backend")
        self.batch_block_f = index.get("batch_block_f")
        self.ppr = None
        if "ppr/roots" in index:
            self.ppr = TopKPPR(roots=index["ppr/roots"],
                               indices=index["ppr/indices"],
                               values=index["ppr/values"])
        self.faults = faults
        self.io_retries = max(0, int(io_retries))
        self.stats = FaultStats("reads", "io_retries", "crc_failures")
        self._mmaps: Dict[str, np.memmap] = {}
        self._validate_payload_sizes()

    # ------------------------------------------------------------- opening
    @staticmethod
    def open(path: str, faults=NO_FAULTS, io_retries: int = 2) -> "PlanStore":
        """Open a finalized store. O(metadata): header + index only — no
        field payload is read (that is ``read_batch``'s job). A directory
        without a committed header, a truncated field file, or an index the
        zip layer cannot verify all raise :class:`PlanFormatError`."""
        hpath = os.path.join(path, _HEADER)
        if not os.path.isdir(path) or not os.path.exists(hpath):
            raise FileNotFoundError(
                f"{path}: no finalized PlanStore here (missing {_HEADER} — "
                f"a crash mid-build leaves no header on purpose)")
        try:
            with open(hpath) as f:
                header = json.load(f)
        except ValueError as e:
            raise PlanFormatError(f"{hpath}: corrupt store header "
                                  f"({e})") from e
        if header.get("format") != "ibmb-plan-store" or \
                header.get("store_version") != STORE_VERSION:
            raise PlanFormatError(
                f"{path}: not a PlanStore this build reads "
                f"(format={header.get('format')!r}, "
                f"store_version={header.get('store_version')!r}, "
                f"want {STORE_VERSION})")
        ipath = os.path.join(path, _INDEX)
        try:
            with np.load(ipath, allow_pickle=False) as z:
                index = {k: z[k] for k in z.files}   # zip CRC verified here
        except FileNotFoundError:
            raise PlanFormatError(f"{path}: store index missing ({_INDEX})")
        except Exception as e:
            raise PlanFormatError(f"{ipath}: corrupt or truncated store "
                                  f"index ({type(e).__name__}: {e})") from e
        return PlanStore(path, header, index, faults=faults,
                         io_retries=io_retries)

    def _field_path(self, name: str) -> str:
        return os.path.join(self.path, _FIELD_DIR, name + ".bin")

    def _validate_payload_sizes(self) -> None:
        """A truncated chunk (crash/partial copy) is caught at open time by
        SIZE, before any mmap slice could read past EOF."""
        if self.batch_crc32.shape != (self.num_batches, len(self.specs)):
            raise PlanFormatError(
                f"{self.path}: crc table shape {self.batch_crc32.shape} "
                f"does not match {self.num_batches} batches x "
                f"{len(self.specs)} fields")
        for s in self.specs:
            p = self._field_path(s.name)
            want = s.rowbytes * self.num_batches
            got = os.path.getsize(p) if os.path.exists(p) else -1
            if got != want:
                raise PlanFormatError(
                    f"{p}: field payload is {got} bytes, header says "
                    f"{want} ({self.num_batches} batches x {s.rowbytes} "
                    f"B/batch) — truncated or foreign chunk data")

    # ------------------------------------------------------------- payload
    def mmap_fields(self) -> Dict[str, np.memmap]:
        """Read-only ``np.memmap`` per field, shaped (B, *field_shape) like
        a resident ``BatchCache.fields`` — whole-plan consumers read through
        OS paging, resident set stays at what they actually touch."""
        for s in self.specs:
            if s.name not in self._mmaps:
                self._mmaps[s.name] = np.memmap(
                    self._field_path(s.name), dtype=np.dtype(s.dtype),
                    mode="r", shape=(self.num_batches,) + s.shape)
        return dict(self._mmaps)

    def read_batch(self, i: int) -> Dict[str, np.ndarray]:
        """Materialize + verify batch ``i``: one contiguous copy per field,
        crc32-checked against the index table. The ``batch_io`` fault point
        fires per attempt; transient ``OSError`` retries up to
        ``io_retries`` times, checksum mismatch raises
        :class:`PlanFormatError` immediately (corrupt data is a recovery
        decision, not a retry, DESIGN.md §12)."""
        if not 0 <= i < self.num_batches:
            raise IndexError(f"batch {i} out of range [0, {self.num_batches})")
        self.stats.bump("reads")
        last: Optional[BaseException] = None
        for attempt in range(self.io_retries + 1):
            try:
                self.faults.fire("batch_io", OSError)
                maps = self.mmap_fields()
                out = {s.name: np.array(maps[s.name][i]) for s in self.specs}
                break
            except OSError as e:
                last = e
                self._mmaps.clear()       # a stale map is part of the fault
                if attempt < self.io_retries:
                    self.stats.bump("io_retries")
                    continue
                raise
        for fi, s in enumerate(self.specs):
            got = zlib.crc32(np.ascontiguousarray(out[s.name]))
            want = int(self.batch_crc32[i, fi])
            if got != want:
                self.stats.bump("crc_failures")
                raise PlanFormatError(
                    f"{self._field_path(s.name)}: checksum mismatch for "
                    f"batch {i} (stored {want:#010x}, computed {got:#010x}) "
                    f"— artifact corrupt")
        return out

    def __len__(self) -> int:
        return self.num_batches

    def payload_nbytes(self) -> int:
        """Logical size of the full batch payload (what a resident
        ``BatchCache`` would hold) — the number the RSS budget is up
        against."""
        return sum(s.rowbytes for s in self.specs) * self.num_batches

    # ---------------------------------------------------------------- plan
    def as_plan(self, resident_batches: int = 8) -> Plan:
        """A servable :class:`Plan` whose cache is a
        :class:`LazyBatchCache` over this store — drop-in for
        ``GNNInferenceEngine`` / ``GNNTrainer`` / ``PrefetchLoader``, with
        at most ``resident_batches`` batches materialized at once."""
        cache = LazyBatchCache(self, resident_batches=resident_batches)
        return Plan(cache=cache, schedule=_frozen(np.asarray(self.schedule)),
                    routing=self.routing, fingerprint=self.fingerprint,
                    meta=dict(self.meta), timings=dict(self.timings),
                    version=int(self.header.get("plan_version", 0)),
                    parent=self.header.get("parent", ""),
                    node_ids=None if self.node_ids is None
                    else _frozen(self.node_ids),
                    ppr=self.ppr,
                    batch_backend=None if self.batch_backend is None
                    else _frozen(self.batch_backend),
                    batch_block_f=None if self.batch_block_f is None
                    else _frozen(self.batch_block_f))


def write_store(path: str, plan: Plan, chunk_batches: int = 8) -> PlanStore:
    """Write an in-memory (resident) plan as a ``PlanStore`` directory —
    the bulk-export path (sharding uses it for resident shard builds; the
    streaming builder in ``repro_torch.ooc.stream`` appends chunks as they are
    born instead). Chunked so the writer never buffers more than
    ``chunk_batches`` batches of payload beyond the source plan."""
    w = PlanStoreWriter(path)
    try:
        fields = plan.cache.fields
        meta = np.array([[m.get("nodes", 0), m.get("edges", 0),
                          m.get("outputs", 0)] for m in plan.cache.meta],
                        np.int64)
        for s in range(0, len(plan.cache), chunk_batches):
            e = min(s + chunk_batches, len(plan.cache))
            w.append({k: v[s:e] for k, v in fields.items()}, meta[s:e])
        w.finalize(plan.schedule, plan.routing, plan.fingerprint, plan.meta,
                   plan.timings, version=plan.version, parent=plan.parent,
                   node_ids=plan.node_ids, ppr=plan.ppr,
                   batch_backend=plan.batch_backend,
                   batch_block_f=plan.batch_block_f)
    except BaseException:
        w.abort()
        raise
    return PlanStore.open(path)


class LazyBatchCache:
    """``BatchCache``-shaped view over a :class:`PlanStore` with a bounded
    resident-batch budget (DESIGN.md §13).

    * ``cache[i]`` — verified batch dict through an LRU of at most
      ``resident_batches`` entries (cold batches evict; hot batches are
      free repeats). This is the path the engines and ``PrefetchLoader``
      take, so serving a plan 100x bigger than RAM holds O(budget) batch
      payload plus whatever the engine's own output LRU keeps.
    * ``cache.fields`` — the store's read-only memmaps, shaped exactly like
      resident ``BatchCache.fields`` (``check_routing``, ``batch_labels``
      and other metadata readers work unchanged; the OS pages in only the
      small fields they touch).
    * ``cache.stack(idx)`` — super-step staging through the LRU/verify
      path (the reference's ``stack_batches`` dispatches to it; the
      port's multi-GPU super-steps are still to come).
    """

    def __init__(self, store: PlanStore, resident_batches: int = 8):
        self.store = store
        self.resident_batches = max(1, int(resident_batches))
        self.num_batches = len(store)
        self.meta = [dict(nodes=int(n), edges=int(e), outputs=int(o))
                     for n, e, o in np.asarray(store.meta_counts)]
        self._lru: "OrderedDict[int, Dict[str, np.ndarray]]" = OrderedDict()
        self.stats = dict(loads=0, hits=0, evictions=0)

    def __len__(self) -> int:
        return self.num_batches

    @property
    def fields(self) -> Dict[str, np.memmap]:
        return self.store.mmap_fields()

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        i = int(i)
        hit = self._lru.get(i)
        if hit is not None:
            self._lru.move_to_end(i)
            self.stats["hits"] += 1
            return hit
        batch = self.store.read_batch(i)
        self.stats["loads"] += 1
        self._lru[i] = batch
        while len(self._lru) > self.resident_batches:
            self._lru.popitem(last=False)
            self.stats["evictions"] += 1
        return batch

    def stack(self, idx: Sequence[int]) -> Dict[str, np.ndarray]:
        """One super-step's stacked fields, each member verified through
        the LRU path (eviction keeps the worker at O(budget + group))."""
        dicts = [self[int(i)] for i in idx]
        return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}

    def nbytes(self) -> int:
        """Logical (fully-materialized) payload size — kept comparable with
        ``BatchCache.nbytes`` so memory accounting reports what the lazy
        cache AVOIDS holding; see ``resident_nbytes`` for what it does."""
        return self.store.payload_nbytes()

    def resident_nbytes(self) -> int:
        return sum(sum(v.nbytes for v in d.values())
                   for d in self._lru.values())

    def snapshot(self) -> Dict[str, int]:
        """Observability surface (§11 idiom): LRU traffic + store I/O."""
        return dict(self.stats, resident=len(self._lru),
                    resident_bytes=self.resident_nbytes(),
                    budget=self.resident_batches,
                    **{f"io_{k}": v for k, v in
                       self.store.stats.snapshot().items()})
