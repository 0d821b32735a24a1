"""Production mesh construction; the port of ``repro.launch.mesh``.

Single pod: (data=16, model=16) = 256 chips; multi-pod: (pod=2, data=16,
model=16) = 512 chips. The "model" axis carries TP/EP/SP; "data" (+"pod")
carries DP/FSDP. Inter-pod traffic crosses slower links, so the sharding
policy keeps only data-parallel gradient reduction on the "pod" axis.

Each function builds a torch ``DeviceMesh`` over ranks 0..n-1 of the
process group in force, and raises when its world is too small. A dry run
(``repro_torch.launch.dryrun``) makes that group the ``fake`` backend of
world 512, the counterpart of the reference's
``--xla_force_host_platform_device_count=512``; on one card a ``nccl``
group of world 1 takes ``make_test_mesh((1, 1))``. Functions, not
module-level constants, so importing this module touches no process
group.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# Single source of truth for the DP-axis policy lives in the sharding layer.
from repro_torch.dist.sharding import data_axes  # noqa: F401


def _mesh(shape: Sequence[int], axes: Sequence[str], what: str,
          device_type: Optional[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"{what} {tuple(shape)} needs {need} ranks, found {have} — "
            "launch via launch/dryrun.py, which makes a fake process group "
            "of world 512")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "mesh", device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: Optional[str] = None):
    """Small mesh for tests and for one card (``(1, 1)``)."""
    return _mesh(shape, axes, "test mesh", device_type)
