"""Fault-tolerant checkpointing of trees of tensors (DESIGN.md §6, §12).

The port of ``repro.checkpoint.checkpointer``, in the reference's on-disk
format, so each package restores the other's checkpoints:

* a tree (nested dicts, lists and tuples of tensors, numpy arrays or
  scalars) flattens to ``{path: array}`` under the reference's keys: dict
  keys as they are (sorted, as JAX flattens them), list and tuple items by
  index, joined by ``/`` — a GCN's ``{"layers": [...]}`` and an Adam state
  ``{"step", "m", "v"}`` map to the npz members JAX writes for the same
  trees;
* each process writes its own shard file (``shard-<rank>.npz``) and a JSON
  manifest (step, keys, shapes, dtypes, crc32 per array, hosts, extra);
* writes are ATOMIC (a ``.tmp`` directory renamed into place, the manifest
  written last inside it) and ASYNC (a background thread), so the step
  loop never blocks on disk;
* ``latest_step`` + ``auto_resume`` scan the run dir; a half-written
  checkpoint (no manifest) is ignored, and a corrupt one (checksum, zip
  CRC, unreadable manifest) raises :class:`CheckpointCorruptError` on
  restore while ``auto_resume`` falls back to the newest intact step.

bf16 leaves are stored as the reference stores them: their bits as a
``V2`` npz member, manifest dtype ``"bfloat16"``. On restore such a member
is read back as ``torch.bfloat16`` from its bits (the reference's own
``load_pytree`` cannot cast ``V2`` back: ROADMAP.md, Queue 3).

Restore places each leaf on the template leaf's device with its dtype; a
template leaf that is not a tensor (a numpy array or scalar) lands on
``device`` (``cuda`` unless the caller names another).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.faults import NO_FAULTS

_BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """A checkpoint operation failed (including an ASYNC save whose error
    is re-raised on the next ``save()``/``wait()`` — DESIGN.md §12)."""


class CheckpointCorruptError(CheckpointError):
    """The on-disk checkpoint exists but fails integrity checks (truncated
    shard, checksum mismatch, unreadable manifest)."""


def _crc32(a: np.ndarray) -> int:
    """crc32 of an array's bytes, read from its buffer (no copy)."""
    return zlib.crc32(np.ascontiguousarray(a))


def _leaves_with_paths(tree: Any, prefix: Tuple = ()):
    """``(path, leaf)`` pairs in JAX's flattening order: dict keys sorted,
    sequences by index; ``None`` is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves_with_paths(t, prefix + (i,))
    else:
        yield prefix, tree


def _key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf and its manifest dtype. The copy is taken
    now, so a later in-place update of the leaf (an optimizer step on a
    CPU tensor) cannot reach the saved bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).numpy()
            return bits.view(np.dtype("V2")), _BF16
        a = t.numpy()
    else:
        a = np.array(leaf)                   # a copy
    if a.dtype.name == _BF16:                # ml_dtypes' bfloat16
        return a.view(np.dtype("V2")), _BF16
    return a, str(a.dtype)


def _flatten(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for path, leaf in _leaves_with_paths(tree):
        k = _key(path)
        flat[k], dtypes[k] = _host_array(leaf)
    return flat, dtypes


def _world() -> Tuple[int, int]:
    """(rank, world size) of this process: ``torch.distributed``'s when a
    process group is up, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _save_flat(flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
               directory: str, step: int, extra: Optional[Dict],
               faults) -> str:
    ckpt = os.path.join(directory, f"step-{step:08d}")
    tmp = ckpt + ".tmp"
    try:
        faults.fire("ckpt_io", OSError)
        os.makedirs(tmp, exist_ok=True)
        rank, world = _world()
        np.savez(os.path.join(tmp, f"shard-{rank if world > 1 else 0}.npz"),
                 **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes,
            "checksums": {k: _crc32(v) for k, v in flat.items()},
            "hosts": world,
            "time": time.time(),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(ckpt):
            shutil.rmtree(ckpt)
        os.rename(tmp, ckpt)                  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return ckpt


def save_pytree(tree: Any, directory: str, step: int,
                extra: Optional[Dict] = None, faults=NO_FAULTS) -> str:
    """Synchronous atomic save. Returns the checkpoint dir.

    The manifest is written LAST inside the tmp dir and the dir rename is
    the publish point, so a crash anywhere before the rename leaves only an
    ignorable ``.tmp``; the manifest records a crc32 per array so restore
    can prove shard integrity (DESIGN.md §12)."""
    flat, dtypes = _flatten(tree)
    return _save_flat(flat, dtypes, directory, step, extra, faults)


def _read_checkpoint(ckpt: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    try:
        with open(os.path.join(ckpt, "manifest.json")) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"{ckpt}: unreadable manifest ({type(e).__name__}: {e})") from e
    flat: Dict[str, np.ndarray] = {}
    try:
        for fn in sorted(os.listdir(ckpt)):
            if fn.startswith("shard-") and fn.endswith(".npz"):
                with np.load(os.path.join(ckpt, fn),
                             allow_pickle=False) as z:
                    for k in z.files:
                        flat[k] = z[k]       # materialize: zip member CRC
    except Exception as e:
        # BadZipFile / zlib.error / ValueError / EOFError — the shard is
        # truncated or mangled; one catchable type for recovery code.
        raise CheckpointCorruptError(
            f"{ckpt}: corrupt or truncated shard "
            f"({type(e).__name__}: {e})") from e
    for k, want in manifest.get("checksums", {}).items():
        if k not in flat:
            raise CheckpointCorruptError(
                f"{ckpt}: shard files are missing checksummed leaf {k!r}")
        got = _crc32(flat[k])
        if got != int(want):
            raise CheckpointCorruptError(
                f"{ckpt}: checksum mismatch for leaf {k!r} (stored "
                f"{int(want):#010x}, computed {got:#010x})")
    return flat, manifest


def _as_tensor(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    """A CPU tensor of a stored member: a ``V2`` member whose manifest
    dtype is bfloat16 is reinterpreted from its bits."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or dtype_name != _BF16:
            raise CheckpointCorruptError(
                f"stored member of dtype {arr.dtype} with manifest dtype "
                f"{dtype_name!r}: only bfloat16 is stored as raw bits")
        bits = np.require(arr, requirements="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements="C"))


def load_pytree(template: Any, directory: str, step: Optional[int] = None,
                device: DeviceSpec = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``template``: each leaf on the
    template leaf's device with its dtype (a non-tensor template leaf on
    ``device``, ``cuda`` unless named)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    ckpt = os.path.join(directory, f"step-{step:08d}")
    flat, manifest = _read_checkpoint(ckpt)
    dtypes = manifest.get("dtypes", {})
    host_dev: Optional[torch.device] = None

    def restore(path: Tuple, leaf):
        nonlocal host_dev
        key = _key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = _as_tensor(flat[key], dtypes.get(key))
        if isinstance(leaf, torch.Tensor):
            return t.to(device=leaf.device, dtype=leaf.dtype, copy=True)
        if host_dev is None:
            host_dev = resolve_device(device)
        dtype = getattr(leaf, "dtype", None)
        want = t.dtype if dtype is None else _torch_dtype(dtype)
        return t.to(device=host_dev, dtype=want, copy=True)

    return _rebuild(template, (), restore), manifest


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name == _BF16:
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _rebuild(tree: Any, path: Tuple, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], path + (k,), fn) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, path + (i,), fn)
                          for i, t in enumerate(tree))
    return fn(path, tree)


def all_steps(directory: str) -> List[int]:
    """Published checkpoint steps (manifest present), newest first."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for fn in os.listdir(directory):
        m = re.match(r"step-(\d+)$", fn)
        if m and os.path.exists(os.path.join(directory, fn, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps, reverse=True)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[0] if steps else None


class Checkpointer:
    """Async checkpointer with bounded retention.

    Failure contract (DESIGN.md §12): an error in the BACKGROUND save
    thread is captured, not swallowed — the next ``save()`` or ``wait()``
    re-raises it as :class:`CheckpointError` (chained to the original), so
    a training loop that keeps checkpointing cannot silently lose every
    checkpoint to a full disk. ``faults`` is the ``ckpt_io`` injection
    hook."""

    def __init__(self, directory: str, keep: int = 3, faults=NO_FAULTS):
        self.directory = directory
        self.keep = keep
        self.faults = faults
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, tree: Any, step: int, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        # snapshot to host memory NOW: the step loop may update the leaves
        # (in place, on the CPU) before the background write reads them
        flat, dtypes = _flatten(tree)
        self.wait()

        def work():
            try:
                _save_flat(flat, dtypes, self.directory, step, extra,
                           self.faults)
                self._gc()
            except BaseException as e:   # captured, re-raised by wait()
                self._error = e

        if blocking:
            work()
            self.wait()                  # surface a blocking-save error too
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join any in-flight save; re-raise its stored error (one-shot)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(
                f"async checkpoint save failed: "
                f"{type(err).__name__}: {err}") from err

    def restore(self, template: Any, step: Optional[int] = None,
                device: DeviceSpec = None):
        return load_pytree(template, self.directory, step, device)

    def auto_resume(self, template: Any, device: DeviceSpec = None):
        """Return (tree, manifest) from the newest INTACT checkpoint, or
        None when the dir holds no published checkpoints at all.

        Corrupt steps (truncated shard, checksum mismatch) are skipped
        newest-to-oldest (DESIGN.md §12) — losing one save interval beats
        resuming from garbage or refusing to start. Raises
        :class:`CheckpointCorruptError` only when checkpoints exist and
        EVERY one of them is corrupt."""
        steps = all_steps(self.directory)
        if not steps:
            return None
        last_err: Optional[CheckpointError] = None
        for step in steps:
            try:
                return self.restore(template, step, device)
            except CheckpointCorruptError as e:
                last_err = e
        raise CheckpointCorruptError(
            f"{self.directory}: all {len(steps)} checkpoints are corrupt "
            f"(newest failure: {last_err})") from last_err

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for fn in os.listdir(self.directory)
            if (m := re.match(r"step-(\d+)$", fn)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:08d}"),
                          ignore_errors=True)
