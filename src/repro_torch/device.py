"""Device selection and host→device staging shared by the entry points.

A resident ``BatchCache`` staged to a CUDA card is page-locked in place
(``page_lock``): each stacked field is registered with the driver once, so
every batch's slice of it copies by DMA, ``non_blocking``, without a
second, pinned copy of the plan on the host. Everything else (a memmap,
the out-of-core ``LazyBatchCache``, a stacked super-step, the CPU, a
registration the driver refuses) copies from pageable memory as before.
"""
from __future__ import annotations

import ctypes
import mmap
import threading
import warnings
import weakref
from typing import Dict, List, Mapping, Tuple, Union

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


def host_nbytes(batch: Mapping[str, np.ndarray]) -> int:
    """The bytes ``stage`` copies for ``batch``: its host arrays' sizes."""
    return sum(np.asarray(v).nbytes for v in batch.values())


def pinned_nbytes(batch: Mapping[str, np.ndarray],
                  device: torch.device) -> int:
    """The bytes of ``batch`` that staging to ``device`` copies from
    page-locked memory: 0 off a CUDA device."""
    return sum(v.nbytes for v in batch.values() if _dma(v, device))


def copy_batch(batch: Mapping[str, np.ndarray],
               device: DeviceSpec = None) -> Dict[str, torch.Tensor]:
    """One copy per field of ``batch`` to ``device``, keyed in ``batch``'s
    order. The largest copy is issued first: from page-locked memory it
    runs while the host issues the rest, which queue behind it on the
    stream, so the copy engine is not left idle between small fields."""
    dev = resolve_device(device)
    first = sorted(batch, key=lambda k: -np.asarray(batch[k]).nbytes)
    out = {k: to_tensor(batch[k], dev) for k in first}
    return {k: out[k] for k in batch}


def stage(batch: Mapping[str, np.ndarray],
          device: DeviceSpec = None) -> Dict[str, torch.Tensor]:
    """Copy one batch's host arrays to ``device`` (``copy_batch``).
    Returns once the copies are done, page-locked ones included."""
    dev = resolve_device(device)
    out = copy_batch(batch, dev)
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


def _release(held: List[Tuple[int, int]], arrays) -> None:
    """Drop a released cache's hold on its ranges; unregister a range no
    cache holds. ``arrays``, held by the finalizer until this returns,
    keeps the memory alive until then."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()     # no copy may read a range it unpins
    with _lock:
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
    in part, a field the driver refuses) is left pageable. Returns the
    bytes registered by this call."""
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
        fin = weakref.finalize(cache, _release, held, arrays)
        fin.atexit = False           # the process's exit unpins it anyway
        _locked.add(cache)
        return (s.counts or {}).get("bytes", 0)
