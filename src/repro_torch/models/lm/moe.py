"""Mixture-of-Experts FFN (DeepSeek-style: shared + routed, top-k); the port
of ``repro.models.lm.moe``.

``moe_forward`` computes the reference's default dispatch,
``_moe_forward_einsum`` (the Mesh-TF one-hot formulation): top-k routing,
each token's assignment to an expert takes the next free slot of that
expert's capacity C = ``moe_capacity(T)`` in token order, assignments past
C are dropped (the token keeps its residual), and each kept assignment's
expert output is weighted by its renormalised router probability.

The port builds that result by sorting instead of one-hot matmuls: a
stable argsort of the flat token-major expert ids and ``searchsorted``
give each assignment its position within its expert (``route``), kept
assignments are written into an (E, C, D) buffer (``dispatch``), the
expert matmuls run batched in f32 (as in the reference; TF32 stays off,
the PyTorch default), and each kept output, weighted by its gate, goes
back to its (token, rank) row of a (T, k, D) buffer that is summed over k
(``combine``). The einsum form's (T, E, C) dispatch tensors are never
built (at T = 4096 one would be 0.5 GB). The sum over k runs in rank
order, not through atomic adds (``index_add_`` on the card), so a token's
output does not depend on the other tokens of the batch: a request gets
the same tokens served alone or beside others.

Unlike the reference's ``_moe_forward_sort`` (``REPRO_MOE_DISPATCH=sort``),
a dropped assignment writes nothing: the reference sends it to (expert 0,
slot 0) with value 0, which overwrites the first token routed to expert 0
whenever any assignment is dropped (ROADMAP Queue 3). The port reads no
``REPRO_MOE_DISPATCH``; the ``shmap`` (expert-parallel) path waits for the
mesh tooling (ROADMAP Queue 1, item 13).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from repro_torch.models.lm.common import activation


def moe_params_shape(cfg):
    d, e, f = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    shapes = {
        "router": (d, e),
        "we_in": (e, d, f), "we_gate": (e, d, f), "we_out": (e, f, d),
    }
    if cfg.moe_num_shared:
        fs = cfg.moe_d_ff * cfg.moe_num_shared
        shapes.update({"sh_in": (d, fs), "sh_gate": (d, fs),
                       "sh_out": (fs, d)})
    return shapes


def moe_capacity(cfg, tokens: int) -> int:
    c = math.ceil(tokens * cfg.moe_top_k / cfg.moe_num_experts
                  * cfg.moe_capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


class Routing(NamedTuple):
    """The T·k assignments of a (T, D) input, sorted by expert (stably, so
    token order within an expert): ``expert``, ``token``, ``rank`` (which
    of the token's top k) and ``gate`` (the renormalised top-k
    probability) of each, its ``slot`` within its expert, and ``keep``
    (slot < capacity)."""
    expert: torch.Tensor
    token: torch.Tensor
    rank: torch.Tensor
    gate: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(cfg, p: Dict, xt: torch.Tensor) -> Routing:
    """Top-k routing of xt (T, D) and each assignment's capacity slot."""
    t = xt.shape[0]
    k = cfg.moe_top_k
    cap = moe_capacity(cfg, t)
    logits = (xt @ p["router"]).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)           # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(-1)                            # token-major
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, se, side="left")       # expert's 1st rank
    slot = torch.arange(t * k, device=xt.device) - first
    return Routing(expert=se, token=order // k, rank=order % k,
                   gate=top_p.reshape(-1)[order], slot=slot, keep=slot < cap,
                   capacity=cap)


def dispatch(cfg, r: Routing, xt: torch.Tensor) -> torch.Tensor:
    """The (E, C, D) f32 expert inputs: each kept assignment's token in its
    slot, zeros elsewhere; a dropped assignment writes nothing."""
    buf = torch.zeros((cfg.moe_num_experts, r.capacity, xt.shape[1]),
                      dtype=torch.float32, device=xt.device)
    buf[r.expert[r.keep], r.slot[r.keep]] = xt[r.token[r.keep]].float()
    return buf


def combine(cfg, r: Routing, eout: torch.Tensor, t: int) -> torch.Tensor:
    """(T, D) f32: the gate-weighted expert outputs of each token's kept
    assignments, summed over its k ranks in rank order."""
    k = cfg.moe_top_k
    rows = torch.zeros((t * k, eout.shape[-1]), dtype=torch.float32,
                       device=eout.device)
    # the flat token-major index t·k + rank of each sorted assignment
    flat = r.token * k + r.rank
    rows[flat[r.keep]] = eout[r.expert[r.keep], r.slot[r.keep]] * \
        r.gate[r.keep][:, None]
    return rows.reshape(t, k, -1).sum(dim=1)


def _shared_out(cfg, p: Dict, xt: torch.Tensor) -> torch.Tensor:
    sh = activation(cfg, xt @ p["sh_gate"]) * (xt @ p["sh_in"])
    return sh @ p["sh_out"]


def moe_forward(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D): the reference's einsum dispatch."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    r = route(cfg, p, xt)
    buf = dispatch(cfg, r, xt)
    h_gate = torch.bmm(buf, p["we_gate"].float())
    h_in = torch.bmm(buf, p["we_in"].float())
    eout = torch.bmm(activation(cfg, h_gate) * h_in, p["we_out"].float())
    out = combine(cfg, r, eout, t)
    if cfg.moe_num_shared:
        out = out + _shared_out(cfg, p, xt).to(out.dtype)
    return out.reshape(b, s, d).to(x.dtype)


def moe_router_stats(cfg, p: Dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Load-balance diagnostics (aux-loss-style fraction per expert)."""
    d = x.shape[-1]
    logits = (x.reshape(-1, d) @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    _, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1)
    frac = torch.bincount(top_e.reshape(-1), minlength=cfg.moe_num_experts
                          ).float() / top_e.numel()
    return {"expert_fraction": frac, "mean_prob": probs.mean(0)}
