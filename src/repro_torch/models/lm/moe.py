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
the same tokens served alone or beside others. Every assignment is
written, a dropped one to a spare slot past C, so that no shape depends
on the data (a dry run's fake tensors have no values).

On DTensors (a ``DeviceMesh`` under ``logical_rules``) the port builds the
reference's own one-hot formulation instead (``routed_einsum``): DTensor
has no sharding strategy for ``argsort`` or ``searchsorted``, and the
einsums keep the reference's global capacity and token order on any
mesh, at its O(T·E·C·D) dispatch and combine cost.

Unlike the reference's ``_moe_forward_sort`` (``REPRO_MOE_DISPATCH=sort``),
a dropped assignment writes nothing: the reference sends it to (expert 0,
slot 0) with value 0, which overwrites the first token routed to expert 0
whenever any assignment is dropped (ROADMAP Queue 3). The port reads no
``REPRO_MOE_DISPATCH``: ``moe_forward(..., dispatch="shmap")`` selects the
expert-parallel path, the reference's ``_moe_forward_shmap``.

Expert parallelism (``dispatch="shmap"``). The reference runs one
``shard_map`` program over the mesh's "model" (EP) axis: each device routes
its own tokens (batch over the data axes, the sequence over "model" when it
divides), buckets them into an (E, C, D) send buffer in the model dtype
(``_local_dispatch``), exchanges the buckets with a tiled ``all_to_all``
so that each device holds its E/ep experts' (E/ep, ep·C, D) inputs, runs
its experts with f32 accumulation, sends the outputs back by the reverse
``all_to_all`` and combines them locally. The port writes the per-device
program once, as a generator (``_ep_member``) that yields at each
exchange, and runs it single-controller over a ``DataMesh`` (as the
port's data-parallel executor does): member (i, j) of the (data, model)
mesh runs on its mesh entry (entries may repeat one card), and each
exchange is a reshuffle of the members' buffers. On DTensors over a
``DeviceMesh`` the same generator runs on every rank inside ``local_map``,
each exchange a functional all-to-all over the "model" axis's group
(``_moe_forward_funcol``; a (1, 1) mesh included). The send capacity C is
``moe_capacity`` of a member's token count, as in the reference. A
dropped assignment writes nothing here either. Without a mesh, without a
"model" axis or when ep does not divide E, ``dispatch="shmap"`` falls back
to the einsum dispatch (the reference falls back to its sort dispatch).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.dist import annotate, gathered, grad_gathered, is_dtensor, \
    summed
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


def route(cfg, p: Dict, xt: torch.Tensor, cap: Optional[int] = None
          ) -> Routing:
    """Top-k routing of xt (T, D) and each assignment's capacity slot;
    capacity ``moe_capacity(T)`` unless ``cap`` is given."""
    t = xt.shape[0]
    k = cfg.moe_top_k
    if cap is None:
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


def dispatch(cfg, r: Routing, xt: torch.Tensor,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (E, C, D) expert inputs in ``dtype``: each kept assignment's
    token in its slot, zeros elsewhere; a dropped assignment writes
    nothing."""
    # shapes that do not depend on the data (a dry run's fake tensors have
    # no values): every assignment is written, a dropped one to a spare
    # slot C that is cut off
    buf = torch.zeros((cfg.moe_num_experts, r.capacity + 1, xt.shape[1]),
                      dtype=dtype, device=xt.device)
    slot = torch.where(r.keep, r.slot, r.capacity)
    buf[r.expert, slot] = xt[r.token].to(dtype)
    return buf[:, :r.capacity]


def combine(cfg, r: Routing, eout: torch.Tensor, t: int) -> torch.Tensor:
    """(T, D) f32: the gate-weighted expert outputs of each token's kept
    assignments, summed over its k ranks in rank order."""
    k = cfg.moe_top_k
    rows = torch.zeros((t * k, eout.shape[-1]), dtype=torch.float32,
                       device=eout.device)
    # the flat token-major index t·k + rank of each sorted assignment (a
    # permutation); a dropped assignment's row stays 0
    flat = r.token * k + r.rank
    slot = torch.where(r.keep, r.slot, 0)
    rows[flat] = torch.where(r.keep[:, None],
                             eout[r.expert, slot] * r.gate[:, None], 0.0)
    return rows.reshape(t, k, -1).sum(dim=1)


def routed(cfg, p: Dict, xt: torch.Tensor, cap: Optional[int] = None
           ) -> torch.Tensor:
    """(T, D) f32: the routed experts' part of the MoE on xt (T, D), at
    capacity ``moe_capacity(T)`` or ``cap`` (the einsum dispatch's
    function)."""
    r = route(cfg, p, xt, cap)
    buf = annotate(dispatch(cfg, r, xt), "expert", None, None)
    h_gate = torch.bmm(buf, p["we_gate"].float())
    h_in = torch.bmm(buf, p["we_in"].float())
    eout = torch.bmm(activation(cfg, h_gate) * h_in, p["we_out"].float())
    eout = annotate(eout, "expert", None, None)
    return combine(cfg, r, eout, xt.shape[0])


def _replicated_arange(n: int, like: torch.Tensor) -> torch.Tensor:
    """``arange(n)`` as a DTensor replicated on ``like``'s mesh."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(torch.arange(n, device=like.to_local().device),
                              mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def routed_einsum(cfg, p: Dict, xt: torch.Tensor) -> torch.Tensor:
    """(T, D) f32: ``routed`` as the reference's ``_moe_forward_einsum``
    writes it, for DTensors: one-hot masks by comparison with an arange,
    capacity slots by a cumsum over the token-major order, and the (T, E,
    C) dispatch and combine tensors contracted by einsums, each an op
    DTensor has a sharding strategy for (the sort path's ``argsort`` and
    ``searchsorted`` have none). It keeps the global semantics: C =
    ``moe_capacity(T)`` over all T tokens and slots in global token order,
    whatever the mesh. Its dispatch and combine cost O(T·E·C·D) flops, as
    the reference's HLO does."""
    t = xt.shape[0]
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = moe_capacity(cfg, t)
    logits = (xt @ p["router"]).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)           # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    onehot = (top_e[..., None] == _replicated_arange(e, xt)).float()
    per_e = onehot.sum(1)                                 # (T, E)
    pos_in_e = torch.cumsum(per_e, dim=0) - per_e
    pos = torch.einsum("tke,te->tk", onehot, pos_in_e)    # (T, k)
    keep = pos < cap
    gate = top_p * keep
    pos_oh = (pos[..., None] == _replicated_arange(cap, xt)).float()
    # the experts' sharding, which XLA carries back from ``xin``'s
    disp = annotate(torch.einsum("tke,tkc->tec", onehot * keep[..., None],
                                 pos_oh), "batch", "expert", None)
    comb = annotate(torch.einsum("tke,tkc,tk->tec", onehot, pos_oh, gate),
                    "batch", "expert", None)
    xin = annotate(torch.einsum("tec,td->ecd", disp, xt.float()),
                   "expert", None, None)
    h_gate = torch.bmm(xin, p["we_gate"].float())
    h_in = torch.bmm(xin, p["we_in"].float())
    eout = torch.bmm(activation(cfg, h_gate) * h_in, p["we_out"].float())
    eout = annotate(eout, "expert", None, None)
    # as one (T, E·C) @ (E·C, D) product: the experts' shards lead each
    # merged (E, C), which an einsum may order (C, E)
    return comb.reshape(t, e * cap) @ eout.reshape(e * cap, -1)


def _shared_out(cfg, p: Dict, xt: torch.Tensor) -> torch.Tensor:
    sh = activation(cfg, xt @ p["sh_gate"]) * (xt @ p["sh_in"])
    return sh @ p["sh_out"]


def moe_forward(cfg, p: Dict, x: torch.Tensor, dispatch: str = "einsum",
                mesh=None, stats: Optional[Dict] = None) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D): the reference's einsum dispatch, or with
    ``dispatch="shmap"`` its expert-parallel path over ``mesh`` (default:
    the mesh of the active ``logical_rules``). ``stats``, if given, gets the
    shmap path's exchange figures (``_moe_forward_shmap``)."""
    if dispatch == "shmap":
        return _moe_forward_shmap(cfg, p, x, mesh, stats)
    if dispatch != "einsum":
        raise ValueError(f"unknown MoE dispatch {dispatch!r}; want "
                         f"'einsum' or 'shmap'")
    b, s, d = x.shape
    xt = gathered(x, 1).reshape(b * s, d)
    if is_dtensor(xt):
        # the routing's softmax and top-k are not linear in a partial x
        # (the MTP head's residual)
        xt = summed(xt)
        out = routed_einsum(cfg, p, xt)
    else:
        out = routed(cfg, p, xt)
    if cfg.moe_num_shared:
        out = out + _shared_out(cfg, p, xt).to(out.dtype)
    # the output's gradient gathered over the sequence before the reshape
    # flattens (B, S) (a DTensor; XLA reshards by itself)
    return grad_gathered(out.reshape(b, s, d), 1).to(x.dtype)


def _ep_layout(cfg, b: int, s: int, sizes: Dict[str, int]):
    """(ep, the data axes, their member count, each member's sequence
    length, the send capacity) of an expert-parallel MoE over a mesh of
    axis ``sizes``: batch over the data axes, the sequence over "model"
    where it divides, C = ``moe_capacity`` of a member's tokens."""
    ep = sizes["model"]
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    ndp = 1
    for a in dp:
        ndp *= sizes[a]
    if b % ndp != 0:
        raise ValueError(f"batch {b} does not split over the data axes "
                         f"{dp} ({ndp} members)")
    s_loc = s // ep if s % ep == 0 else s
    return ep, dp, ndp, s_loc, moe_capacity(cfg, max(b // ndp, 1) * s_loc)


def _ep_member(cfg, p: Dict, xl: torch.Tensor, cap: int,
               record: Optional[Dict] = None):
    """The per-device program of the expert-parallel MoE (the reference's
    ``local_fn``) of a member of the "model" axis whose experts' weights
    ``p["we_*"]`` (E/ep, ...) holds, beside the whole router, as a
    generator: it yields its (E, C, D) send buffer at the first exchange
    and receives its experts' (E/ep, ep·C, D) inputs; it yields their
    (E/ep, ep·C, D) outputs at the second and receives its tokens' (E, C,
    D) outputs; it returns its (B_l, S_l, D) output in x's dtype. The
    exchange payload is in the model dtype; the expert matmuls take it
    exactly into f32 and accumulate in f32 (the reference's
    ``preferred_element_type``). ``record``, if given, gets the bytes of
    the member's two exchanged buffers and its dropped assignments."""
    bl, sl, d = xl.shape
    xt = xl.reshape(bl * sl, d)
    r = route(cfg, p, xt, cap)
    send = dispatch(cfg, r, xt, xl.dtype)
    recv = yield send
    hg = torch.bmm(recv.float(), p["we_gate"].float())
    hi = torch.bmm(recv.float(), p["we_in"].float())
    eo = torch.bmm((activation(cfg, hg) * hi).to(recv.dtype).float(),
                   p["we_out"].float()).to(recv.dtype)
    back = yield eo
    if record is not None:
        record.update(send_bytes=send.numel() * send.element_size(),
                      back_bytes=back.numel() * back.element_size(),
                      dropped=int((~r.keep).sum()))
    out = combine(cfg, r, back.float(), bl * sl)
    return out.reshape(bl, sl, d).to(xl.dtype)


def _moe_forward_shmap(cfg, p: Dict, x: torch.Tensor, mesh=None,
                       stats: Optional[Dict] = None) -> torch.Tensor:
    """The expert-parallel MoE over a ``DataMesh`` with a "model" axis (see
    the module docstring). ``stats`` gets ``capacity``, ``ep`` and
    ``members``, one record per member in mesh order: the bytes of the
    buffer it sends and of the outputs it gets back (together 2·E·C·D
    values, the reference's collective volume per device and layer) and
    its dropped assignments."""
    if is_dtensor(x):
        return _moe_forward_funcol(cfg, p, x, stats)
    if mesh is None:
        from repro_torch.dist import current_mesh
        mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names \
            or cfg.moe_num_experts % mesh.shape["model"] != 0:
        return moe_forward(cfg, p, x)
    b, s, d = x.shape
    ep, dp, ndp, s_loc, cap = _ep_layout(cfg, b, s, mesh.shape)
    el = cfg.moe_num_experts // ep
    b_loc = b // ndp
    # mesh entries by (data member, model member): the data axes flattened
    # outermost first, any other axis at its first entry
    names = list(mesh.axis_names)
    grid = np.moveaxis(np.asarray(mesh.devices, dtype=object),
                       names.index("model"), -1)
    sel = tuple(slice(None) if a in dp else 0 for a in names
                if a != "model")
    grid = np.asarray(grid[sel]).reshape(ndp, ep)
    gens, records = {}, {}
    for i in range(ndp):
        for j in range(ep):
            dev = grid[i, j]
            rows = slice(i * b_loc, (i + 1) * b_loc)
            cols = slice(j * s_loc, (j + 1) * s_loc) if s_loc != s \
                else slice(None)
            pm = {"router": p["router"].to(dev)}
            pm.update({k: p[k][j * el:(j + 1) * el].to(dev)
                       for k in ("we_in", "we_gate", "we_out")})
            records[i, j] = {} if stats is not None else None
            gens[i, j] = _ep_member(cfg, pm, x[rows, cols].to(dev), cap,
                                    records[i, j])
    # first exchange (tiled all_to_all, split axis 0, concat axis 1):
    # expert block k of member j's buffer goes to member k, concatenated
    # over j along the capacity axis
    sends = {m: next(g) for m, g in gens.items()}
    recv = {(i, k): torch.cat([sends[i, j][k * el:(k + 1) * el].to(
        grid[i, k]) for j in range(ep)], dim=1) for i, k in sends}
    # reverse exchange (split axis 1, concat axis 0): capacity block j of
    # member k's outputs goes back to member j, concatenated over k
    outs = {m: gens[m].send(recv[m]) for m in gens}
    back = {(i, j): torch.cat([outs[i, k][:, j * cap:(j + 1) * cap].to(
        grid[i, j]) for k in range(ep)], dim=0) for i, j in outs}
    res = {}
    for m, g in gens.items():
        try:
            g.send(back[m])
        except StopIteration as stop:
            res[m] = stop.value
    if s_loc != s:
        out = torch.cat([torch.cat([res[i, j].to(x.device)
                                    for j in range(ep)], dim=1)
                         for i in range(ndp)], dim=0)
    else:       # the sequence replicated over "model": member 0's copy
        out = torch.cat([res[i, 0].to(x.device) for i in range(ndp)], dim=0)
    if stats is not None:
        stats.update(capacity=cap, ep=ep,
                     members=[records[m] for m in sorted(records)])
    if cfg.moe_num_shared:
        xt = x.reshape(-1, d)
        out = out + _shared_out(cfg, p, xt).reshape(b, s, d).to(out.dtype)
    return out


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    """A tiled all-to-all over ``group`` that splits ``t``'s axis 0 into
    equal blocks, sends block k to member k and stacks what it gets on
    axis 0 in member order; differentiable (its backward is the reverse
    exchange)."""
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_to_all_single_autograd(
        t.contiguous(), None, None, group))


def _moe_forward_funcol(cfg, p: Dict, x: torch.Tensor,
                        stats: Optional[Dict] = None) -> torch.Tensor:
    """The expert-parallel MoE on a DTensor x over a ``DeviceMesh`` with a
    "model" axis: ``_ep_member`` on every rank inside ``local_map``, the
    reference's ``shard_map`` specs (router whole, experts over "model",
    x's batch over the data axes and its sequence over "model" where it
    divides), each of its two yields resolved by a functional
    ``all_to_all_single`` over the "model" axis's group. Without a
    "model" axis, or where ep does not divide E, the DTensor einsum path.
    A (1, 1) mesh runs this path too, its exchanges one-rank all-to-alls.
    Gradients hold where the sequence splits over "model" (every
    production training shape): a sequence replicated over "model" is
    routed by every member, and each copy's gradient reaches the experts.
    ``stats`` gets ``capacity``, ``ep`` and this rank's record."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    e = cfg.moe_num_experts
    if "model" not in names or e % mesh.size(names.index("model")) != 0:
        return moe_forward(cfg, p, x)
    b, s, d = x.shape
    ep, dp, _, s_loc, cap = _ep_layout(
        cfg, b, s, {n: mesh.size(i) for i, n in enumerate(names)})
    el = e // ep
    x_pl = tuple(Shard(0) if a in dp else
                 Shard(1) if a == "model" and s_loc != s else Replicate()
                 for a in names)
    e_pl = tuple(Shard(0) if a == "model" else Replicate() for a in names)
    whole = (Replicate(),) * mesh.ndim
    # a gradient from this rank's tokens is a partial sum over the axes
    # that split the tokens but not the weight
    router_grad = tuple(Partial() if q.is_shard() else Replicate()
                        for q in x_pl)
    e_grad = tuple(Partial() if q.is_shard() and not w.is_shard() else w
                   for q, w in zip(x_pl, e_pl))
    group = mesh.get_group("model")
    record = {} if stats is not None else None

    def local(router, we_in, we_gate, we_out, xl):
        gen = _ep_member(cfg, {"router": router, "we_in": we_in,
                               "we_gate": we_gate, "we_out": we_out},
                         xl, cap, record)
        send = next(gen)                                  # (E, C, D)
        # split axis 0, concat axis 1: (ep·el, C, D) from the members in
        # order → (el, ep·C, D)
        recv = _exchange(send, group).reshape(ep, el, cap, d) \
            .transpose(0, 1).reshape(el, ep * cap, d)
        eo = gen.send(recv)
        # split axis 1, concat axis 0: capacity block j to member j
        back = _exchange(eo.reshape(el, ep, cap, d).transpose(0, 1)
                         .reshape(e, cap, d), group)
        try:
            gen.send(back)
        except StopIteration as stop:
            return stop.value
        raise RuntimeError("_ep_member did not return after two exchanges")
    out = local_map(
        local, out_placements=list(x_pl),
        in_placements=(whole, e_pl, e_pl, e_pl, x_pl),
        in_grad_placements=(router_grad, e_grad, e_grad, e_grad, x_pl),
        device_mesh=mesh, redistribute_inputs=True)(
            p["router"], p["we_in"], p["we_gate"], p["we_out"], x)
    if stats is not None:
        stats.update(capacity=cap, ep=ep, members=[record])
    if cfg.moe_num_shared:
        xt = summed(gathered(x, 1).reshape(b * s, d))
        sh = grad_gathered(_shared_out(cfg, p, xt).reshape(b, s, d), 1)
        out = out + sh.to(out.dtype)
    return out


def moe_router_stats(cfg, p: Dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Load-balance diagnostics (aux-loss-style fraction per expert)."""
    d = x.shape[-1]
    logits = (x.reshape(-1, d) @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    _, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1)
    frac = torch.bincount(top_e.reshape(-1), minlength=cfg.moe_num_experts
                          ).float() / top_e.numel()
    return {"expert_fraction": frac, "mean_prob": probs.mean(0)}
