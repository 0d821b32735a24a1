"""Carry parameters between the JAX package and the port."""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.device import DeviceSpec, resolve_device, to_tensor


def params_from_jax(tree: Dict, device: DeviceSpec = None) -> Dict:
    """The port's GCN parameters from a JAX parameter pytree
    ``{"layers": [{"w", "b", "ln_scale", "ln_bias"}, ...]}`` (any array
    type numpy can read). The layout is kept: ``w`` stays ``(d_in, d_out)``
    and is applied as ``h @ w``, so nothing is transposed."""
    dev = resolve_device(device)
    return {"layers": [
        {k: to_tensor(np.asarray(v), dev) for k, v in layer.items()}
        for layer in tree["layers"]]}
