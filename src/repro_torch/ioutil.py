"""Atomic artifact-write helpers (DESIGN.md §12).

The port's copy of ``repro.ioutil``, unchanged but for its imports.

Every persisted artifact in this repo — plan headers, store indices,
checkpoints, bench-trajectory JSONs — must be published with the
tmp + ``os.replace`` idiom so readers see the old file or the new one,
never a truncated in-between. These helpers are the one sanctioned home
for that idiom; the ``atomic-write`` rule of ``repro_torch.analysis`` flags
plain write-mode ``open()`` calls on artifact paths that do not flow
through here (DESIGN.md §15).
"""
from __future__ import annotations

import json
import os
from typing import Any


def atomic_write_text(path: str, text: str) -> None:
    """tmp + os.replace publish: crash-safe, single-file, same-directory
    (os.replace is only atomic within a filesystem)."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: Any, **dump_kwargs: Any) -> None:
    """Serialize first, publish once — a json.dump that dies mid-stream
    never leaves a half-written artifact behind."""
    atomic_write_text(path, json.dumps(obj, **dump_kwargs))


def atomic_savez(path: str, **arrays: Any) -> None:
    """np.savez with the same tmp + os.replace publish."""
    import numpy as np

    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
