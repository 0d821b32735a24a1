"""Carry parameters between the JAX package and the port: the GNNs'
(``params_from_jax``) and the LM stack's (``lm_params_from_jax``)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device, to_tensor


def params_from_jax(tree: Dict, device: DeviceSpec = None) -> Dict:
    """The port's GNN parameters from a JAX parameter pytree
    ``{"layers": [{...}, ...]}`` of any of the three kinds (GCN's ``w``,
    ``b``; SAGE's ``w_self``, ``w_nbr``, ``b``; GAT's ``w``, ``a_src``,
    ``a_dst``, ``b``; ``ln_scale``, ``ln_bias`` on hidden layers), any
    array type numpy can read. Every key of a layer dict is carried and
    the layout is kept: weights stay ``(d_in, d_out)`` and are applied as
    ``h @ w``, so nothing is transposed."""
    dev = resolve_device(device)
    return {"layers": [
        {k: to_tensor(np.asarray(v), dev) for k, v in layer.items()}
        for layer in tree["layers"]]}


def _lm_leaf(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry its
        # bits as uint16 and reinterpret them
        return to_tensor(a.view(np.uint16), dev).view(torch.bfloat16)
    return to_tensor(a, dev)


def lm_params_from_jax(tree: Any, device: DeviceSpec = None) -> Any:
    """The port's LM parameters from the reference's LM parameter tree
    (nested dicts and lists of arrays, any type numpy can read). Nesting,
    stacked layouts and dtypes (f32 and bf16) are kept: weights stay
    ``(d_in, d_out)`` and are applied as ``x @ w``, so nothing is
    transposed."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_from_jax(v, dev) for v in tree]
    return _lm_leaf(tree, dev)
