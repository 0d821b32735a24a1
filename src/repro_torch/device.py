"""Device selection and host→device staging shared by the entry points."""
from __future__ import annotations

import warnings
from typing import Dict, Mapping, Union

import numpy as np
import torch

DeviceSpec = Union[None, str, torch.device]


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


def to_tensor(a, device: DeviceSpec = None) -> torch.Tensor:
    """A copy of host array ``a`` on ``device``. Plan arrays are
    write-protected; they are only read here, once, by the copy."""
    dev = resolve_device(device)
    a = np.ascontiguousarray(a)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        t = torch.from_numpy(a)
    return t.clone() if dev.type == "cpu" else t.to(dev)


def stage(batch: Mapping[str, np.ndarray],
          device: DeviceSpec = None) -> Dict[str, torch.Tensor]:
    """Copy one batch's host arrays to ``device`` (one copy per field)."""
    dev = resolve_device(device)
    return {k: to_tensor(v, dev) for k, v in batch.items()}
