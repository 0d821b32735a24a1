"""The paper's three evaluation GNNs, GCN, GraphSAGE and GAT (App. B
configs), in PyTorch: plain functions on tensors.

Parameters keep the JAX package's layout — ``{"layers": [{...}, ...]}``
with GCN's ``w``/``b``, SAGE's ``w_self``/``w_nbr``/``b`` and GAT's
``w``/``a_src``/``a_dst``/``b``, weights of shape ``(d_in, d_out)`` applied
as ``h @ w``, and ``ln_scale``/``ln_bias`` on every hidden layer — so
``repro_torch.convert.params_from_jax`` carries reference parameters over
unchanged. Batches are dicts of tensors (``repro_torch.device.stage``).
All three serve and train (LayerNorm, ReLU, dropout from an explicit
``torch.Generator``, masked cross-entropy).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models.gnn import ops


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


def _glorot(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.empty(shape, dtype=dtype).uniform_(-lim, lim, generator=gen)


def init_gnn(cfg: GNNConfig, generator: torch.Generator,
             device: DeviceSpec = None) -> Dict:
    """Parameters with the reference's shapes and Glorot limits, drawn from
    ``generator`` (a CPU generator, so a seed gives the same weights on
    every device) in the order the layer dict lists them, and placed on
    ``device`` (``cuda`` by default)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    dims = [cfg.in_dim] + [cfg.hidden] * (cfg.num_layers - 1) + [cfg.out_dim]
    params: Dict = {"layers": []}
    for l in range(cfg.num_layers):
        d_in, d_out = dims[l], dims[l + 1]
        if cfg.kind == "gcn":
            layer = {"w": _glorot(generator, (d_in, d_out), dtype),
                     "b": torch.zeros((d_out,), dtype=dtype)}
        elif cfg.kind == "sage":
            layer = {"w_self": _glorot(generator, (d_in, d_out), dtype),
                     "w_nbr": _glorot(generator, (d_in, d_out), dtype),
                     "b": torch.zeros((d_out,), dtype=dtype)}
        elif cfg.kind == "gat":
            h = cfg.heads
            last = l == cfg.num_layers - 1
            dh = d_out if last else d_out // h
            layer = {"w": _glorot(generator, (d_in, h * dh), dtype),
                     "a_src": _glorot(generator, (h, dh), dtype),
                     "a_dst": _glorot(generator, (h, dh), dtype),
                     "b": torch.zeros((d_out if last else h * dh,),
                                      dtype=dtype)}
        else:
            raise ValueError(cfg.kind)
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


def _sage_layer(p, h, batch, backend="segment", block_f=0):
    nbr = ops.mean_agg_backend(h, batch, backend, block_f=block_f)
    return h @ p["w_self"] + nbr @ p["w_nbr"] + p["b"]


def _gat_layer(p, h, batch, backend="segment", block_f=0):
    # GAT recomputes edge weights from attention every step, so there are
    # no precomputable tiles: it always runs the segment path (DESIGN.md
    # §7); `backend` is accepted for a uniform layer signature. Per-edge
    # rows are gathered with index_select (see ops.segment_softmax)
    n = h.shape[0]
    heads, dh = p["a_src"].shape
    z = (h @ p["w"]).reshape(n, heads, dh)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    e_src = (z * p["a_src"][None]).sum(-1)                     # (N, H)
    e_dst = (z * p["a_dst"][None]).sum(-1)
    logits = F.leaky_relu(e_src.index_select(0, src) +
                          e_dst.index_select(0, dst), 0.2)     # (E, H)
    att = ops.segment_softmax(logits, src, n, batch["edge_mask"])
    msgs = z.index_select(0, dst) * att[..., None]             # (E, H, dh)
    out = torch.zeros_like(z).index_add_(0, src, msgs)
    if p["b"].shape[0] == heads * dh:       # hidden layers: concat heads
        return out.reshape(n, heads * dh) + p["b"]
    return out.mean(dim=1) + p["b"]         # output layer: average heads


_LAYERS = {"gcn": _gcn_layer, "sage": _sage_layer, "gat": _gat_layer}


def gnn_apply(cfg: GNNConfig, params: Dict, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              train: bool = False) -> torch.Tensor:
    """Forward pass on one padded batch. Returns logits for ALL nodes
    (N, C); the caller selects output rows via batch['output_idx']. Runs
    where the batch and parameters lie. With ``train`` and a ``generator``
    (on the batch's device), dropout follows the ReLU of every hidden
    layer, each layer drawing its mask from the generator in turn. SAGE
    under bcsr takes the tiles' degree once per forward, not per layer."""
    layer_fn = _LAYERS[cfg.kind]
    h = batch["features"].to(getattr(torch, cfg.dtype))
    if "edge_mask" not in batch:
        batch = dict(batch, edge_mask=(batch["edge_weight"] != 0).to(h.dtype))
    backend = ops.validate_batch_for_backend(
        batch, getattr(cfg, "backend", "segment"), cfg.kind)
    if cfg.kind == "sage" and backend == "bcsr":
        batch = dict(batch, bcsr_degree=ops.bcsr_degree(batch["tile_vals"],
                                                         h.dtype))
    block_f = int(getattr(cfg, "bcsr_block_f", 0))
    for l, p in enumerate(params["layers"]):
        h = layer_fn(p, h, batch, backend, block_f)
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
