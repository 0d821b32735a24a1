"""Device selection and host→device staging shared by the entry points.

A resident ``BatchCache`` staged to a CUDA card is page-locked in place
(``page_lock``): each stacked field is registered with the driver once, so
every batch's slice of it copies by DMA, ``non_blocking``, without a
second, pinned copy of the plan on the host. Everything else (a memmap,
the out-of-core ``LazyBatchCache``, a stacked super-step, the CPU, a
registration the driver refuses) copies from pageable memory as before.

Once its fields are locked, each batch's dense ``tile_vals`` are checked
against the tiles ``build_tiles`` makes from the batch's edges
(``stage.tile_check``); a batch that matches bit for bit has its tiles made
on the card when it is staged, from the few MB of edges it copies anyway,
instead of copying the (R, K, B, B) tiles, which are nearly all zeros.
"""
from __future__ import annotations

import ctypes
import mmap
import threading
import warnings
import weakref
from typing import Dict, FrozenSet, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs

DeviceSpec = Union[None, str, torch.device]

#: ``cudaHostRegisterPortable``: pinned for every CUDA context of the
#: process, so a cache serves engines on several cards
_REGISTER_PORTABLE = 1

# Registered host ranges, process-wide as the driver's registrations are:
# start address -> [nbytes, number of caches holding it]. ``_spans`` is the
# same ranges as an immutable tuple of (start, end), replaced under the
# lock and read without it on the staging path. The lock is reentrant: a
# collection inside ``page_lock`` may run another cache's ``_release``.
_lock = threading.RLock()
_ranges: Dict[int, List[int]] = {}
_spans: Tuple[Tuple[int, int], ...] = ()
_locked: "weakref.WeakSet" = weakref.WeakSet()      # caches seen

# Batches whose tiles ``page_lock`` found equal, bit for bit, to the ones
# built from their edges: per batch the identity (address, shape, strides,
# type) of each of its ``TILE_SOURCES`` views -> the number of caches
# holding it. ``_checked`` is the same keys as an immutable set, replaced
# under the lock and read without it on the staging path, as ``_spans``.
_check_counts: Dict[tuple, int] = {}
_checked: FrozenSet[tuple] = frozenset()


def resolve_device(device: DeviceSpec = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Never falls back to the CPU: asking for CUDA on a machine
    without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    return dev


def page_locked(a) -> bool:
    """Whether host array ``a``'s bytes lie inside a range ``page_lock``
    registered (a batch's slice of a registered field does)."""
    spans = _spans
    if not spans or not isinstance(a, np.ndarray) or a.nbytes == 0:
        return False
    lo = a.__array_interface__["data"][0]
    hi = lo + a.nbytes
    return any(s <= lo and hi <= e for s, e in spans)


def _dma(a: np.ndarray, dev: torch.device) -> bool:
    return dev.type == "cuda" and page_locked(a)


def to_tensor(a, device: DeviceSpec = None) -> torch.Tensor:
    """A copy of host array ``a`` on ``device``. Plan arrays are
    write-protected; they are only read here, once, by the copy. From
    page-locked memory the copy is ``non_blocking`` on the current stream:
    a caller that hands the tensor to another stream, or the host, waits
    for that stream first."""
    dev = resolve_device(device)
    a = np.ascontiguousarray(a)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        t = torch.from_numpy(a)
    if dev.type == "cpu":
        return t.clone()
    return t.to(dev, non_blocking=_dma(a, dev))


def _tiles():
    """``kernels.spmm.ops``, which owns the tiles' layout (``TILE_SOURCES``)
    and their builder (``batch_tiles``); imported on use, as it imports
    this module."""
    from repro_torch.kernels.spmm import ops
    return ops


def _view_key(a: np.ndarray) -> tuple:
    ai = a.__array_interface__
    return ai["data"][0], ai["shape"], ai["strides"], ai["typestr"]


def _tile_key(batch: Mapping[str, np.ndarray]) -> Optional[tuple]:
    """The identity of ``batch``'s ``TILE_SOURCES`` views, or None where it
    lacks one or one is not a host array."""
    views = [batch.get(k) for k in _tiles().TILE_SOURCES]
    if not all(isinstance(v, np.ndarray) for v in views):
        return None
    return tuple(_view_key(v) for v in views)


def _staging(batch: Mapping[str, np.ndarray], dev: torch.device
             ) -> Tuple[List[str], bool]:
    """How ``batch`` stages to ``dev``: the fields it copies, largest first,
    and whether it builds ``tile_vals`` on the card instead of copying
    them, as it does only for the checked views of a page-locked cache
    staged to a CUDA device."""
    checked = _checked
    build = bool(checked) and dev.type == "cuda" and \
        _tile_key(batch) in checked
    copied = sorted((k for k in batch if not (build and k == "tile_vals")),
                    key=lambda k: -np.asarray(batch[k]).nbytes)
    return copied, build


def _counts(batch: Mapping[str, np.ndarray], dev: torch.device,
            copied: List[str], build: bool) -> Dict[str, int]:
    return {"bytes": sum(np.asarray(batch[k]).nbytes for k in copied),
            "pinned_bytes": sum(batch[k].nbytes for k in copied
                                if _dma(batch[k], dev)),
            "built_bytes": batch["tile_vals"].nbytes if build else 0}


def stage_nbytes(batch: Mapping[str, np.ndarray],
                 device: torch.device) -> Dict[str, int]:
    """The counts ``copy_batch`` puts on its span for staging ``batch`` to
    ``device``: ``bytes`` copied, ``pinned_bytes`` of them copied from
    page-locked memory (0 off a CUDA device), and ``built_bytes``, the
    ``tile_vals`` made on the card instead of copied (0 where they are
    copied). A batch's host arrays are ``bytes`` + ``built_bytes``."""
    return _counts(batch, device, *_staging(batch, device))


def copy_batch(batch: Mapping[str, np.ndarray], device: DeviceSpec = None,
               span: Optional[obs.Span] = None) -> Dict[str, torch.Tensor]:
    """One copy per field of ``batch`` to ``device``, keyed in ``batch``'s
    order. The largest copy is issued first: from page-locked memory it
    runs while the host issues the rest, which queue behind it on the
    stream, so the copy engine is not left idle between small fields.
    Checked tiles (``page_lock``) are not copied but built on the card
    from the staged edges after the copies, on the current stream. Adds
    ``stage_nbytes``' counts to ``span`` where one is given."""
    dev = resolve_device(device)
    copied, build = _staging(batch, dev)
    out = {k: to_tensor(batch[k], dev) for k in copied}
    if build:
        out["tile_vals"] = _tiles().batch_tiles(out, batch)
    if span is not None:
        span.add(**_counts(batch, dev, copied, build))
    return {k: out[k] for k in batch}


def stage(batch: Mapping[str, np.ndarray], device: DeviceSpec = None,
          span: Optional[obs.Span] = None) -> Dict[str, torch.Tensor]:
    """Copy one batch's host arrays to ``device`` (``copy_batch``, which
    counts them on ``span``). Returns once the copies are done,
    page-locked ones included."""
    dev = resolve_device(device)
    out = copy_batch(batch, dev, span)
    if any(_dma(np.asarray(v), dev) for v in batch.values()):
        torch.cuda.current_stream(dev).synchronize()
    return out


# ------------------------------------------------------------- page lock
def _mapped(a: np.ndarray) -> bool:
    """Whether ``a``'s memory belongs to a file mapping."""
    while a is not None:
        if isinstance(a, (np.memmap, mmap.mmap)):
            return True
        a = a.obj if isinstance(a, memoryview) else getattr(a, "base", None)
    return False


def _lockable(a) -> bool:
    return (isinstance(a, np.ndarray) and a.nbytes > 0
            and a.flags.c_contiguous and not _mapped(a))


def _publish() -> None:
    global _spans
    _spans = tuple((p, p + n) for p, (n, _c) in _ranges.items())


def _clear_error(cudart) -> None:
    """Reset the runtime's last error after a refused registration; left
    set, the next kernel launch's check would raise it."""
    get = getattr(cudart, "cudaGetLastError", None)
    if get is None:
        get = getattr(ctypes.CDLL(None), "cudaGetLastError", None)
    if get is not None:
        get()


def _publish_checked() -> None:
    global _checked
    _checked = frozenset(_check_counts)


def _release(held: List[Tuple[int, int]], arrays, keys: List[tuple]
             ) -> None:
    """Drop a released cache's hold on its ranges and checked batches;
    unregister a range no cache holds. ``arrays``, held by the finalizer
    until this returns, keeps the memory alive until then."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()     # no copy may read a range it unpins
    with _lock:
        for key in keys:
            _check_counts[key] -= 1
            if _check_counts[key] == 0:
                del _check_counts[key]
        _publish_checked()
        free = []
        for p, n in held:
            entry = _ranges.get(p)
            if entry is None or entry[0] != n:
                continue
            entry[1] -= 1
            if entry[1] == 0:
                del _ranges[p]
                free.append(p)
        _publish()
        if free:
            cudart = torch.cuda.cudart()
            for p in free:
                cudart.cudaHostUnregister(p)


def page_lock(cache, device) -> int:
    """Page-lock a resident ``BatchCache``'s stacked fields in place for
    staging to a CUDA ``device``: one ``cudaHostRegister`` per field, under
    the span ``stage.page_lock`` (``bytes``: the bytes registered). Runs
    once per cache; later calls return 0. The fields stay registered until
    the cache is released. Anything else (another container, a CPU
    device, a memmap or non-contiguous field, a range already registered
    in part, a field whose registration is refused) is left pageable.
    Then checks the cache's tiles (``_check_tiles``). Returns the bytes
    registered by this call."""
    from repro_torch.core.batches import BatchCache
    if not isinstance(cache, BatchCache) or \
            not isinstance(device, torch.device) or device.type != "cuda":
        return 0
    with _lock:
        if cache in _locked:
            return 0
        cudart = torch.cuda.cudart()
        held: List[Tuple[int, int]] = []
        arrays = []
        with obs.span("stage.page_lock") as s:
            for a in cache.fields.values():
                if not _lockable(a):
                    continue
                p = a.__array_interface__["data"][0]
                n = a.nbytes
                entry = _ranges.get(p)
                if entry is not None and entry[0] == n:
                    entry[1] += 1                # shared with another cache
                elif any(s0 < p + n and p < e0 for s0, e0 in _spans):
                    continue                     # overlaps another range
                elif int(cudart.cudaHostRegister(p, n, _REGISTER_PORTABLE)):
                    _clear_error(cudart)
                    continue
                else:
                    _ranges[p] = [n, 1]
                    s.add(bytes=n)
                held.append((p, n))
                arrays.append(a)
                _publish()
        keys: List[tuple] = []
        fin = weakref.finalize(cache, _release, held, arrays, keys)
        fin.atexit = False           # the process's exit unpins it anyway
        _locked.add(cache)
        _check_tiles(cache, device, keys)
        return (s.counts or {}).get("bytes", 0)


def _check_tiles(cache, device: torch.device, keys: List[tuple]) -> None:
    """Find the batches of a page-locked ``cache`` whose tiles staging may
    build on ``device`` instead of copying, under the span
    ``stage.tile_check`` (counts ``checked``, ``mismatched`` and
    ``skipped`` batches, ``bytes`` of tiles copied to compare). Each
    batch's ``tile_vals`` are copied by DMA and compared, as int32 so NaN
    and ``-0.0`` count, with the tiles built from its edges; the keys of
    those that match go to ``keys`` and the checked set, and the rest keep
    the copy. Once the card has no room to compare, the batches not yet
    checked are skipped, with a warning, and keep the copy too. The
    ``TILE_SOURCES`` fields are made read-only first, so a check holds
    for the cache's life. Holds ``_lock``."""
    sources = _tiles().TILE_SOURCES
    f = cache.fields
    if not all(k in f for k in sources) or \
            f["tile_vals"].dtype != np.float32 or \
            not page_locked(f["tile_vals"]):
        return
    for k in sources:
        f[k].setflags(write=False)
    with obs.span("stage.tile_check") as s:
        skipped = 0
        for i in range(len(cache)):
            batch = {k: f[k][i] for k in sources}
            key = _tile_key(batch)
            if key not in _check_counts:
                if skipped:
                    skipped += 1
                    continue
                try:
                    same = _tiles_match(batch, device)
                except torch.cuda.OutOfMemoryError:
                    skipped = 1
                    continue
                s.add(checked=1, mismatched=int(not same),
                      bytes=batch["tile_vals"].nbytes)
                if not same:
                    continue
            _check_counts[key] = _check_counts.get(key, 0) + 1
            keys.append(key)
        s.add(skipped=skipped)
        _publish_checked()
    if skipped:
        warnings.warn(
            f"stage.tile_check: out of card memory, {skipped} of "
            f"{len(cache)} batches were not checked and copy their tiles",
            RuntimeWarning)


def _tiles_match(batch: Mapping[str, np.ndarray],
                 device: torch.device) -> bool:
    """Whether the tiles built on ``device`` from ``batch``'s edges are its
    ``tile_vals``, bit for bit."""
    staged = {k: to_tensor(v, device) for k, v in batch.items()}
    built = _tiles().batch_tiles(staged, batch)
    return torch.equal(built.view(torch.int32),
                       staged["tile_vals"].view(torch.int32))
