"""The frozen, serializable preprocessing artifact — ``Plan`` (DESIGN.md §8).

The port's copy of ``repro.core.plan``, with the ``plan_io`` fault hooks of
``save``/``open``/``load``; the npz format is unchanged, so either package
loads the other's artifacts.

The paper's headline amortization is that preprocessing is computed ONCE and
reused across models, seeds and runs. A ``Plan`` makes that reuse a
first-class artifact instead of a transient ``List[PaddedBatch]``: it bundles

* the contiguous :class:`~repro_torch.core.batches.BatchCache` (padded batches,
  including BCSR tiles when built for the bcsr backend),
* the batch **schedule** (epoch-0 order from ``core.scheduling``),
* a **routing index** — the inverse map ``output node id → (batch, row)``
  that request-level serving (``repro_torch.serve.gnn_engine``) needs to answer
  per-node queries without scanning batches,
* a config **fingerprint** (IBMB config + dataset signature + split + mode)
  so a loaded plan can never silently be served against the wrong
  config/graph, and
* the preprocessing **timings**, preserved for amortization accounting.

``Plan.save``/``Plan.load`` give a versioned on-disk format: one ``.npz``
(uncompressed by default — the dominant payload, the stacked batch cache, is
stored exactly as the in-memory contiguous blocks, so loading is one
sequential read per field; ``compress=True`` trades that for a zipped
archive, auto-detected on load) and the result is fully materialized (the
file handle is closed before ``load`` returns).

Plans are additionally **versioned along a refresh chain** (DESIGN.md §10):
``version`` counts refreshes since the original build and ``parent`` names
the fingerprint this plan was refreshed from (empty for a fresh build).
The JAX package's ``core.update.PlanUpdater`` consumes a plan's ``node_ids`` (per-batch global
node membership) and ``ppr`` (the stored top-k influence scores) to map a
``GraphDelta`` to the minimal dirty-batch set instead of rebuilding the
world.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.batches import BatchCache, PaddedBatch
from repro_torch.core.ppr import TopKPPR
from repro_torch.faults import NO_FAULTS

PLAN_VERSION = 3
# still-loadable on-disk versions: v2 artifacts predate per-batch backend
# decisions (DESIGN.md §14) — they load with decision = the config backend.
COMPAT_PLAN_VERSIONS = (2, PLAN_VERSION)

# the on-disk per-batch backend-decision encoding (plan format v3). A fixed
# serialization table, deliberately independent of the runtime BACKENDS
# tuple's order — appending a backend must not re-number saved artifacts.
BACKEND_CODES = {"segment": 0, "bcsr": 1, "dense": 2}
BACKEND_NAMES = {v: k for k, v in BACKEND_CODES.items()}

_JSON_KEY = "__plan_json__"
_SCHEDULE_KEY = "schedule"
_ROUTE_NODES_KEY = "route/node_ids"
_ROUTE_BATCH_KEY = "route/batch"
_ROUTE_ROW_KEY = "route/row"
_NODE_IDS_KEY = "batch_node_ids"
_BATCH_BACKEND_KEY = "batch_backend"
_BATCH_BLOCK_F_KEY = "batch_block_f"
_PPR_ROOTS_KEY = "ppr/roots"
_PPR_INDICES_KEY = "ppr/indices"
_PPR_VALUES_KEY = "ppr/values"
_CACHE_PREFIX = "cache/"


class PlanFormatError(ValueError):
    """The on-disk artifact is not a plan this code can load (bad version,
    missing fields) or fails the fingerprint check."""


@dataclasses.dataclass(frozen=True)
class PlanHeader:
    """The metadata half of a saved plan — everything ``Plan.save`` put in
    the JSON header, WITHOUT the array payload. ``Plan.open`` returns one in
    O(metadata): routing decisions (does the fingerprint match? which split/
    mode/version is this? how many batches?) never need the stacked batch
    cache materialized."""

    path: str
    fingerprint: str
    version: int                 # refresh-chain version (Plan.version)
    parent: str
    meta: Dict
    timings: Dict[str, float]
    checksums: Dict[str, int]    # per-array crc32, payload integrity table

    @property
    def num_batches(self) -> int:
        return int(self.meta.get("num_batches", 0))


def _parse_header(raw: str, path: str) -> PlanHeader:
    """Validate + decode the JSON header string shared by ``Plan.open``
    (header-only) and ``Plan.load`` (full payload)."""
    header = json.loads(raw)
    version = header.get("version")
    if version not in COMPAT_PLAN_VERSIONS:
        raise PlanFormatError(
            f"{path}: plan version {version!r} unsupported "
            f"(this build reads versions {COMPAT_PLAN_VERSIONS})")
    return PlanHeader(
        path=path,
        fingerprint=header.get("fingerprint", ""),
        version=int(header.get("plan_version", 0)),
        parent=header.get("parent", ""),
        meta=header.get("meta", {}),
        timings=header.get("timings", {}),
        checksums={k: int(v) for k, v in header.get("checksums", {}).items()})


def plan_fingerprint(cfg_fields: Dict, dataset_sig: Dict, split: str,
                     mode: str) -> str:
    """Deterministic fingerprint of (IBMB config, dataset, split, mode).

    Two pipelines produce the same fingerprint iff a plan computed by one is
    byte-for-byte what the other would compute — so ``Plan.load`` can refuse
    artifacts from a different config/graph (DESIGN.md §8).
    """
    blob = json.dumps({"cfg": cfg_fields, "dataset": dataset_sig,
                       "split": split, "mode": mode},
                      sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _frozen(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    a.setflags(write=False)
    return a


def _crc32(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def encode_backends(names: Sequence[str]) -> np.ndarray:
    """Backend names → the (B,) int8 code array stored in a v3 plan."""
    return _frozen(np.array([BACKEND_CODES[str(n)] for n in names], np.int8))


def decode_backends(codes: np.ndarray) -> List[str]:
    return [BACKEND_NAMES[int(c)] for c in np.asarray(codes)]


@dataclasses.dataclass(frozen=True)
class RoutingIndex:
    """Inverse map ``global output node id → (batch index, output row)``.

    ``node_ids`` is sorted so lookup is a binary search; ``batch`` / ``row``
    are aligned with it. When an output node appears in several batches
    (resampling baselines), the first occurrence wins — any batch containing
    the node yields its logits.
    """

    node_ids: np.ndarray    # (M,) int64, sorted
    batch: np.ndarray       # (M,) int32
    row: np.ndarray         # (M,) int32 — row into the batch's output axis

    def __len__(self) -> int:
        return len(self.node_ids)

    def lookup(self, query: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(batch, row) for every queried node id; KeyError on unknown ids."""
        q = np.asarray(query, dtype=np.int64).ravel()
        if len(self.node_ids) == 0:
            if len(q):
                raise KeyError(f"node ids not covered by this plan: "
                               f"{q[:8].tolist()}")
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        pos = np.searchsorted(self.node_ids, q)
        safe = np.minimum(pos, len(self.node_ids) - 1)
        bad = (pos >= len(self.node_ids)) | (self.node_ids[safe] != q)
        if bad.any():
            missing = q[bad]
            raise KeyError(f"node ids not covered by this plan: "
                           f"{missing[:8].tolist()}"
                           f"{'...' if len(missing) > 8 else ''}")
        return self.batch[safe], self.row[safe]

    def batch_occupancy(self, num_batches: int) -> np.ndarray:
        """``counts[b]`` = number of output nodes routed to batch ``b`` —
        the capacity hint the micro-batching window policy needs
        (DESIGN.md §11): once a window holds a full batch's worth of
        distinct routed rows for some batch, waiting longer cannot coalesce
        any more work into that batch's forward."""
        return _frozen(np.bincount(self.batch, minlength=num_batches)
                       .astype(np.int64))

    @staticmethod
    def from_batches(batches: Sequence[PaddedBatch]) -> "RoutingIndex":
        if not len(batches):
            return RoutingIndex(_frozen(np.zeros(0, np.int64)),
                                _frozen(np.zeros(0, np.int32)),
                                _frozen(np.zeros(0, np.int32)))
        return RoutingIndex.from_cache(
            np.stack([b.node_ids for b in batches]),
            np.stack([np.maximum(b.output_idx, 0) for b in batches]),
            np.stack([b.output_mask for b in batches]))

    @staticmethod
    def from_cache(node_ids: np.ndarray, output_idx: np.ndarray,
                   output_mask: np.ndarray) -> "RoutingIndex":
        """Build the routing index from stacked per-batch arrays — the one
        constructor behind ``from_batches`` (fresh builds) and the refresh
        path (``PlanUpdater``, where only some batches exist as
        ``PaddedBatch`` objects, DESIGN.md §10).

        node_ids:    (B, max_nodes) global ids, -1 pad
        output_idx:  (B, max_outputs) local indices (cache field, 0-clamped)
        output_mask: (B, max_outputs) nonzero for real output rows

        ``np.nonzero`` walks row-major, so entries come batch-major exactly
        like the old per-batch concatenation — the stable sort then makes
        the FIRST batch win for duplicated output nodes (resampling
        baselines).
        """
        b_all, r_all = np.nonzero(output_mask > 0)
        ids = node_ids[b_all, output_idx[b_all, r_all]].astype(np.int64)
        return RoutingIndex.from_triplets(ids, b_all, r_all)

    @staticmethod
    def from_triplets(ids: np.ndarray, batch: np.ndarray,
                      row: np.ndarray) -> "RoutingIndex":
        """Build the index from unsorted ``(id, batch, row)`` triplets in
        batch-major order — the tail of ``from_cache``, split out so the
        streaming builder (``repro.ooc.stream``, DESIGN.md §13) can emit
        triplets chunk by chunk and sort ONCE over the concatenation,
        guaranteed to produce the same index as a resident ``from_cache``
        over the full stacked arrays."""
        ids = np.asarray(ids, dtype=np.int64)
        b_all = np.asarray(batch)
        r_all = np.asarray(row)
        order = np.argsort(ids, kind="stable")
        ids = ids[order]
        bidx = b_all[order].astype(np.int32)
        rows = r_all[order].astype(np.int32)
        keep = np.ones(len(ids), bool)
        if len(ids) > 1:                          # drop duplicate node ids
            keep[1:] = ids[1:] != ids[:-1]
        return RoutingIndex(_frozen(ids[keep]), _frozen(bidx[keep]),
                            _frozen(rows[keep]))


@dataclasses.dataclass(frozen=True)
class Plan:
    """Frozen result of one preprocessing run (DESIGN.md §8).

    Built by :meth:`repro_torch.core.pipeline.IBMBPipeline.plan`; consumed by
    ``repro_torch.serve.gnn_engine``. Treat it as
    immutable — the schedule/routing arrays are write-protected, and the
    fingerprint binds the artifact to the config+graph that produced it.
    """

    cache: BatchCache
    schedule: np.ndarray
    routing: RoutingIndex
    fingerprint: str
    meta: Dict                      # split, mode, variant, num_classes, ...
    timings: Dict[str, float]
    # refresh-chain versioning (DESIGN.md §10): version counts refreshes
    # since the original build; parent is the fingerprint this plan was
    # refreshed from ("" for a fresh build).
    version: int = 0
    parent: str = ""
    # (B, max_nodes) global node id per batch row, -1 pad — the membership
    # table PlanUpdater needs to localize feature patches and structural
    # dirtiness. None only for hand-constructed plans.
    node_ids: Optional[np.ndarray] = None
    # stored top-k influence scores (node/random variants) — the warm state
    # push_appr_incremental refreshes instead of recomputing from scratch.
    ppr: Optional[TopKPPR] = None
    # plan format v3 (DESIGN.md §14): the plan-build autotuner's per-batch
    # execution decisions — backend code per batch (see BACKEND_CODES) and
    # the tuned bcsr feature-tile width (0 = untuned default). None on v2
    # artifacts and hand-built plans: decisions fall back to meta["backend"].
    batch_backend: Optional[np.ndarray] = None    # (B,) int8
    batch_block_f: Optional[np.ndarray] = None    # (B,) int32

    # ------------------------------------------------------------- views
    @property
    def num_batches(self) -> int:
        return len(self.cache)

    def __len__(self) -> int:
        return len(self.cache)

    def batch_occupancy(self) -> np.ndarray:
        """Per-batch count of routed output rows (DESIGN.md §11) — how many
        distinct rows of precomputed batch ``b`` request traffic can ever
        address. The async serving tier dispatches a micro-batching window
        early when pending requests cover a full batch's worth of rows."""
        return self.routing.batch_occupancy(len(self.cache))

    def batch_labels(self) -> List[np.ndarray]:
        """Per-batch real (unpadded) output labels — what the scheduler
        consumes to re-derive per-epoch orders."""
        lab = self.cache.fields["labels"]
        msk = self.cache.fields["output_mask"]
        return [lab[i][msk[i] > 0] for i in range(len(self.cache))]

    def batch_backends(self) -> List[str]:
        """Per-batch backend decision (DESIGN.md §14). v2 plans and
        hand-built plans carry no decisions — every batch falls back to the
        backend the plan was configured with (``meta["backend"]``), which is
        exactly what those plans executed before auto dispatch existed."""
        if self.batch_backend is not None:
            return decode_backends(self.batch_backend)
        fallback = str(self.meta.get("backend", "segment") or "segment")
        if fallback not in BACKEND_CODES:
            fallback = "segment"
        return [fallback] * len(self.cache)

    def batch_block_fs(self) -> np.ndarray:
        """Per-batch tuned bcsr feature-tile width; 0 = untuned default."""
        if self.batch_block_f is not None:
            return np.asarray(self.batch_block_f, np.int32)
        return np.zeros(len(self.cache), np.int32)

    def nbytes(self) -> int:
        extra = 0 if self.node_ids is None else self.node_ids.nbytes
        if self.ppr is not None:
            extra += (self.ppr.roots.nbytes + self.ppr.indices.nbytes +
                      self.ppr.values.nbytes)
        return (self.cache.nbytes() + self.schedule.nbytes +
                self.routing.node_ids.nbytes + self.routing.batch.nbytes +
                self.routing.row.nbytes + extra)

    def supersteps(self, world: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Group this plan's precomputed schedule into `world`-sized
        super-steps for data-parallel execution (DESIGN.md §9): a list of
        ``(batch indices, weights)`` pairs where the ragged tail repeats
        the last real batch with weight 0. All batches of a plan share one
        padded shape bucket (the BatchCache invariant), which is what lets
        a super-step's members stack into one array per field."""
        from repro_torch.dist.data_parallel import superstep_indices
        return superstep_indices(self.schedule, world)

    # ------------------------------------------------------ construction
    @staticmethod
    def from_batches(batches: Sequence[PaddedBatch],
                     schedule: Optional[np.ndarray] = None,
                     fingerprint: str = "",
                     meta: Optional[Dict] = None,
                     timings: Optional[Dict[str, float]] = None,
                     cache: Optional[BatchCache] = None,
                     version: int = 0,
                     parent: str = "",
                     ppr: Optional[TopKPPR] = None,
                     batch_backend: Optional[np.ndarray] = None,
                     batch_block_f: Optional[np.ndarray] = None) -> "Plan":
        """Wrap a raw batch list (from IBMB or any baseline batcher) into a
        plan — the back-compat bridge from the list-based API."""
        cache = cache or BatchCache(batches)
        sched = np.arange(len(cache), dtype=np.int64) if schedule is None \
            else np.asarray(schedule, dtype=np.int64)
        node_ids = _frozen(np.stack([b.node_ids for b in batches]))
        return Plan(cache=cache, schedule=_frozen(sched),
                    routing=RoutingIndex.from_batches(batches),
                    fingerprint=fingerprint, meta=dict(meta or {}),
                    timings=dict(timings or {}),
                    version=version, parent=parent,
                    node_ids=node_ids, ppr=ppr,
                    batch_backend=None if batch_backend is None
                    else _frozen(np.asarray(batch_backend, np.int8)),
                    batch_block_f=None if batch_block_f is None
                    else _frozen(np.asarray(batch_block_f, np.int32)))

    # ------------------------------------------------------- persistence
    def save(self, path: str, compress: bool = False,
             faults=NO_FAULTS) -> None:
        """Versioned on-disk format: one npz. Cache fields are stored under
        ``cache/``; schedule/routing/membership/ppr/meta alongside.
        ``compress=True`` writes a zipped npz (smaller artifact, slower
        sequential load); ``load`` auto-detects either.

        The write is ATOMIC (DESIGN.md §12): bytes go to ``path + ".tmp"``
        and are published with ``os.replace``, so a crash mid-save can never
        leave a truncated artifact at ``path`` — readers see the old plan or
        the new one, nothing in between. The header additionally records a
        crc32 per array so ``load`` detects payload corruption that slips
        past the zip layer. ``faults`` is the injection hook for the
        ``plan_io`` point."""
        meta_counts = np.array(
            [[m.get("nodes", 0), m.get("edges", 0), m.get("outputs", 0)]
             for m in self.cache.meta], np.int64)
        arrays = {
            _SCHEDULE_KEY: np.asarray(self.schedule, np.int64),
            _ROUTE_NODES_KEY: self.routing.node_ids,
            _ROUTE_BATCH_KEY: self.routing.batch,
            _ROUTE_ROW_KEY: self.routing.row,
            _CACHE_PREFIX + BatchCache._META_KEY: meta_counts,
        }
        if self.node_ids is not None:
            arrays[_NODE_IDS_KEY] = np.asarray(self.node_ids, np.int32)
        if self.batch_backend is not None:
            arrays[_BATCH_BACKEND_KEY] = np.asarray(self.batch_backend,
                                                    np.int8)
        if self.batch_block_f is not None:
            arrays[_BATCH_BLOCK_F_KEY] = np.asarray(self.batch_block_f,
                                                    np.int32)
        if self.ppr is not None:
            arrays[_PPR_ROOTS_KEY] = self.ppr.roots
            arrays[_PPR_INDICES_KEY] = self.ppr.indices
            arrays[_PPR_VALUES_KEY] = self.ppr.values
        for k, v in self.cache.fields.items():
            arrays[_CACHE_PREFIX + k] = v
        header = json.dumps({
            "version": PLAN_VERSION,
            "fingerprint": self.fingerprint,
            "plan_version": int(self.version),
            "parent": self.parent,
            "meta": self.meta,
            "timings": {k: float(v) for k, v in self.timings.items()},
            "checksums": {k: _crc32(v) for k, v in arrays.items()},
        })
        arrays[_JSON_KEY] = np.array(header)
        faults.fire("plan_io", OSError)
        # savez through an open file object: numpy appends ".npz" to bare
        # PATHS but leaves file objects alone, which keeps the tmp name
        # exact for the os.replace publish.
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                (np.savez_compressed if compress else np.savez)(f, **arrays)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    @staticmethod
    def open(path: str, expect_fingerprint: Optional[str] = None,
             faults=NO_FAULTS) -> PlanHeader:
        """Read ONLY the metadata header of a saved plan — O(metadata), not
        O(payload). ``np.load`` on an npz is lazy (it reads the zip
        directory; members decompress on access), so pulling just the JSON
        header never touches the stacked batch cache. This is what shard
        manifests, routing tiers and ``auto_resume``-style pickers should
        use to DECIDE about an artifact before paying to materialize it
        (``Plan.load`` used to be the only option and eagerly read every
        array). The payload checksums are returned, not verified — only
        ``load`` reads the arrays they describe."""
        faults.fire("plan_io", OSError)
        try:
            with np.load(path, allow_pickle=False) as z:
                if _JSON_KEY not in z.files:
                    raise PlanFormatError(f"{path}: not a Plan artifact "
                                          f"(missing {_JSON_KEY})")
                raw = str(z[_JSON_KEY])
        except (FileNotFoundError, PlanFormatError):
            raise
        except Exception as e:
            raise PlanFormatError(
                f"{path}: corrupt or truncated plan artifact "
                f"({type(e).__name__}: {e})") from e
        header = _parse_header(raw, path)
        if expect_fingerprint is not None and \
                header.fingerprint != expect_fingerprint:
            raise PlanFormatError(
                f"{path}: fingerprint mismatch — artifact was built from a "
                f"different config/dataset/split/mode (got "
                f"{header.fingerprint!r}, expected {expect_fingerprint!r})")
        return header

    @staticmethod
    def load(path: str, expect_fingerprint: Optional[str] = None,
             faults=NO_FAULTS) -> "Plan":
        """Load a saved plan. ``expect_fingerprint`` (or
        ``IBMBPipeline.load_plan``) rejects artifacts produced by a
        different config/dataset/split/mode. A truncated or byte-flipped
        artifact raises :class:`PlanFormatError` (DESIGN.md §12) — caught by
        the zip member CRC on read or by the header's per-array checksums —
        never a half-loaded plan. ``FileNotFoundError`` still propagates
        as-is (absent and corrupt are different recovery decisions)."""
        faults.fire("plan_io", OSError)
        try:
            with np.load(path, allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}   # materialize: zip CRC
        except FileNotFoundError:
            raise
        except PlanFormatError:
            raise
        except Exception as e:
            # zipfile.BadZipFile / zlib.error / ValueError / EOFError / ...
            # — all mean the same thing to a caller: the artifact is not
            # loadable. Normalize so recovery code has ONE type to catch.
            raise PlanFormatError(
                f"{path}: corrupt or truncated plan artifact "
                f"({type(e).__name__}: {e})") from e
        return Plan._load_from(arrays, path, expect_fingerprint)

    @staticmethod
    def _load_from(z: Dict[str, np.ndarray], path: str,
                   expect_fingerprint: Optional[str]) -> "Plan":
        if _JSON_KEY not in z:
            raise PlanFormatError(f"{path}: not a Plan artifact "
                                  f"(missing {_JSON_KEY})")
        header = _parse_header(str(z[_JSON_KEY]), path)
        for k, want in header.checksums.items():
            if k not in z:
                raise PlanFormatError(
                    f"{path}: plan artifact is missing checksummed "
                    f"field {k!r}")
            got = _crc32(z[k])
            if got != int(want):
                raise PlanFormatError(
                    f"{path}: checksum mismatch for {k!r} (stored "
                    f"{int(want):#010x}, computed {got:#010x}) — "
                    f"artifact corrupt")
        fingerprint = header.fingerprint
        if expect_fingerprint is not None and fingerprint != expect_fingerprint:
            raise PlanFormatError(
                f"{path}: fingerprint mismatch — artifact was built from a "
                f"different config/dataset/split/mode (got {fingerprint!r}, "
                f"expected {expect_fingerprint!r}); re-run "
                f"IBMBPipeline.plan() or load with the matching pipeline")
        required = (_SCHEDULE_KEY, _ROUTE_NODES_KEY, _ROUTE_BATCH_KEY,
                    _ROUTE_ROW_KEY, _CACHE_PREFIX + BatchCache._META_KEY)
        missing = [k for k in required if k not in z]
        if missing:
            raise PlanFormatError(
                f"{path}: plan artifact is missing fields {missing}")
        fields = {k[len(_CACHE_PREFIX):]: z[k] for k in z
                  if k.startswith(_CACHE_PREFIX)
                  and k != _CACHE_PREFIX + BatchCache._META_KEY}
        if not fields:
            raise PlanFormatError(f"{path}: plan has no cache fields")
        cache = BatchCache.from_fields(
            fields, z[_CACHE_PREFIX + BatchCache._META_KEY])
        routing = RoutingIndex(_frozen(z[_ROUTE_NODES_KEY]),
                               _frozen(z[_ROUTE_BATCH_KEY]),
                               _frozen(z[_ROUTE_ROW_KEY]))
        node_ids = _frozen(z[_NODE_IDS_KEY]) if _NODE_IDS_KEY in z \
            else None
        ppr = None
        if _PPR_ROOTS_KEY in z:
            ppr = TopKPPR(roots=z[_PPR_ROOTS_KEY],
                          indices=z[_PPR_INDICES_KEY],
                          values=z[_PPR_VALUES_KEY])
        # v3 decision arrays; absent on v2 artifacts (batch_backends() then
        # falls back to the config backend in meta)
        batch_backend = _frozen(z[_BATCH_BACKEND_KEY]) \
            if _BATCH_BACKEND_KEY in z else None
        batch_block_f = _frozen(z[_BATCH_BLOCK_F_KEY]) \
            if _BATCH_BLOCK_F_KEY in z else None
        return Plan(cache=cache, schedule=_frozen(z[_SCHEDULE_KEY]),
                    routing=routing, fingerprint=fingerprint,
                    meta=header.meta, timings=header.timings,
                    version=header.version, parent=header.parent,
                    node_ids=node_ids, ppr=ppr,
                    batch_backend=batch_backend,
                    batch_block_f=batch_block_f)


def check_routing(plan: Plan) -> Dict[str, int]:
    """Validate the routing-index invariants of a plan; raise ValueError on
    the first violation, return summary counts otherwise.

    Invariants (DESIGN.md §8/§10) — checked after build, load and refresh:

    * ``node_ids`` strictly increasing (sorted AND duplicate-free, so binary
      search is well-defined and the map is injective);
    * every entry addresses a real slot: batch in range, row in range, the
      row's ``output_mask`` set;
    * the map is bijective onto the plan's output nodes: the sorted routing
      ids equal the sorted distinct global ids over all real output rows
      (requires ``plan.node_ids``; membership-less plans check coverage
      count only);
    * when membership is available, the addressed slot actually holds the
      node: ``node_ids[b][output_idx[b, r]] == id``.
    """
    r = plan.routing
    ids = np.asarray(r.node_ids)
    if len(ids) and not np.all(ids[1:] > ids[:-1]):
        raise ValueError("routing node_ids not strictly increasing")
    if len(r.batch) != len(ids) or len(r.row) != len(ids):
        raise ValueError("routing arrays are not aligned")
    out_mask = plan.cache.fields["output_mask"]
    out_idx = plan.cache.fields["output_idx"]
    nb, mo = out_mask.shape
    if len(ids) and (r.batch.min() < 0 or r.batch.max() >= nb):
        raise ValueError(f"routing batch index out of range [0, {nb})")
    if len(ids) and (r.row.min() < 0 or r.row.max() >= mo):
        raise ValueError(f"routing row index out of range [0, {mo})")
    if len(ids) and not np.all(out_mask[r.batch, r.row] > 0):
        raise ValueError("routing entry addresses a padded output row")
    if plan.node_ids is not None:
        got = plan.node_ids[r.batch, out_idx[r.batch, r.row]]
        if not np.array_equal(got.astype(np.int64), ids):
            raise ValueError("routing entry does not address its node: "
                             "node_ids[batch][output_idx[batch, row]] != id")
        b_all, r_all = np.nonzero(out_mask > 0)
        covered = np.unique(
            plan.node_ids[b_all, out_idx[b_all, r_all]].astype(np.int64))
        if not np.array_equal(covered, ids):
            raise ValueError(
                f"routing is not bijective over output nodes: plan holds "
                f"{len(covered)} distinct output ids, routing maps {len(ids)}")
    else:
        if len(ids) > int((out_mask > 0).sum()):
            raise ValueError("routing maps more ids than real output rows")
    return {"entries": int(len(ids)), "batches": int(nb)}
