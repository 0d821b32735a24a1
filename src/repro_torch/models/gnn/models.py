"""The paper's GCN (App. B config) in PyTorch: plain functions on tensors.

Parameters keep the JAX package's layout — ``{"layers": [{"w", "b",
"ln_scale", "ln_bias"}, ...]}`` with ``w`` of shape ``(d_in, d_out)``,
applied as ``h @ w`` — so ``repro_torch.convert.params_from_jax`` carries
reference parameters over unchanged. Batches are dicts of tensors
(``repro_torch.device.stage``). The GCN serves and trains (dropout from an
explicit ``torch.Generator``, masked cross-entropy); SAGE and GAT come with
a later slice (ROADMAP.md, Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models.gnn import ops

_LATER = {"sage": "SAGE", "gat": "GAT"}


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    kind: str = "gcn"            # gcn | gat | sage
    in_dim: int = 128
    hidden: int = 256            # paper: 256 (ogbn), 512 (Reddit GCN)
    out_dim: int = 40
    num_layers: int = 3          # paper: 3 (ogbn), 2 (Reddit)
    heads: int = 4               # GAT
    dropout: float = 0.3
    dtype: str = "float32"
    # aggregation backend: segment | bcsr | dense | auto (DESIGN.md §7/§14)
    backend: str = "segment"
    # tuned bcsr feature-tile width (0 = 128-lane default), set per batch
    # from the plan's stored decision via policy.batch_config
    bcsr_block_f: int = 0


def _require_gcn(kind: str) -> None:
    if kind in _LATER:
        raise NotImplementedError(
            f"{_LATER[kind]} is not ported yet (ROADMAP.md, Queue 1 item 6: "
            f"SAGE and GAT); the port runs the GCN")
    if kind != "gcn":
        raise ValueError(kind)


def _glorot(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.empty(shape, dtype=dtype).uniform_(-lim, lim, generator=gen)


def init_gnn(cfg: GNNConfig, generator: torch.Generator,
             device: DeviceSpec = None) -> Dict:
    """GCN parameters with the reference's shapes and Glorot limits, drawn
    from ``generator`` (a CPU generator, so a seed gives the same weights
    on every device) and placed on ``device`` (``cuda`` by default)."""
    _require_gcn(cfg.kind)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    dims = [cfg.in_dim] + [cfg.hidden] * (cfg.num_layers - 1) + [cfg.out_dim]
    params: Dict = {"layers": []}
    for l in range(cfg.num_layers):
        d_in, d_out = dims[l], dims[l + 1]
        layer = {"w": _glorot(generator, (d_in, d_out), dtype),
                 "b": torch.zeros((d_out,), dtype=dtype)}
        if l < cfg.num_layers - 1:
            layer["ln_scale"] = torch.ones((d_out,), dtype=dtype)
            layer["ln_bias"] = torch.zeros((d_out,), dtype=dtype)
        params["layers"].append({k: v.to(dev) for k, v in layer.items()})
    return params


def _gcn_layer(p, h, batch, backend="segment", block_f=0):
    # edge-gather traffic is E×width of whatever flows along edges;
    # aggregating in the NARROWER of (d_in, d_out) minimizes it. Both orders
    # are identical in exact arithmetic because aggregation is linear:
    #   agg(h) @ W  ==  agg(h @ W)
    d_in, d_out = p["w"].shape
    mode = os.environ.get("REPRO_GCN_AGG_ORDER", "transform_first")
    agg_first = (mode == "agg_first"
                 or (mode == "auto" and d_in < d_out))
    if agg_first:
        h = ops.weighted_agg_backend(h, batch, backend, block_f=block_f)
        return h @ p["w"] + p["b"]
    h = h @ p["w"]
    h = ops.weighted_agg_backend(h, batch, backend, block_f=block_f)
    return h + p["b"]


def gnn_apply(cfg: GNNConfig, params: Dict, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              train: bool = False) -> torch.Tensor:
    """Forward pass on one padded batch. Returns logits for ALL nodes
    (N, C); the caller selects output rows via batch['output_idx']. Runs
    where the batch and parameters lie. With ``train`` and a ``generator``
    (on the batch's device), dropout follows the ReLU of every hidden
    layer, each layer drawing its mask from the generator in turn."""
    _require_gcn(cfg.kind)
    h = batch["features"].to(getattr(torch, cfg.dtype))
    backend = ops.validate_batch_for_backend(
        batch, getattr(cfg, "backend", "segment"), cfg.kind)
    block_f = int(getattr(cfg, "bcsr_block_f", 0))
    for l, p in enumerate(params["layers"]):
        h = _gcn_layer(p, h, batch, backend, block_f)
        if l < cfg.num_layers - 1:
            h = ops.layer_norm(h, p["ln_scale"], p["ln_bias"])
            h = torch.relu(h)
            if train and generator is not None:
                h = ops.dropout(h, cfg.dropout, generator,
                                deterministic=False)
    return h


def output_logits(logits_all: torch.Tensor,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Select the batch's output-node rows (paper: only output nodes get
    predictions; auxiliary nodes exist only to feed them)."""
    return logits_all[batch["output_idx"].long()]


def masked_xent(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(torch.float32)
    correct = (logits.argmax(-1) == labels).to(torch.float32) * mask
    return correct.sum() / torch.clamp(mask.sum(), min=1.0)
