"""`repro_torch.dist` — logical-axis sharding and data-parallel Plan
execution (DESIGN.md §5, §9); the port of ``repro.dist``.

Four layers:
* ``annotate(x, *logical_axes)`` — the only distribution primitive model
  code touches: a sharding constraint in logical axis names, the identity
  outside a ``logical_rules`` context, so the same model runs unsharded.
* ``repro_torch.dist.logical`` — name→mesh-axis binding with priority
  arbitration.
* ``repro_torch.dist.sharding`` — path/shape-driven specs for parameter,
  optimizer, cache and batch trees, the divisibility-fallback ``fit_spec``,
  and DTensor placements of a spec (``placements``, ``distribute_tree``).
* ``repro_torch.dist.data_parallel`` — data-parallel Plan execution as
  super-steps over a ``DataMesh`` (one batch per mesh entry, a weighted
  mean of the gradients). Its consumers (the trainer, the engine and the
  loader) import it lazily.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.dist.logical import (
    current_mesh, current_rules, logical_rules, spec_for)
from repro_torch.dist.sharding import (
    batch_spec, cache_spec, data_axes, distribute_tree, fit_spec,
    logical_rules_for, opt_spec, param_spec, placements)

__all__ = [
    "annotate", "logical_rules", "spec_for", "current_mesh", "current_rules",
    "fit_spec", "param_spec", "opt_spec", "cache_spec", "batch_spec",
    "placements", "distribute_tree", "logical_rules_for",
    "data_axes", "is_dtensor", "splittable", "gathered", "on_grad",
    "grad_gathered", "grad_splittable", "per_rank", "summed",
]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; without importing
    ``torch.distributed.tensor`` (no DTensor exists before it is)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def splittable(x, dim: int, n: int):
    """``x`` ready for its dimension ``dim`` to be split into (n, rest):
    a DTensor with ``dim`` sharded over mesh axes whose product does not
    divide n gets those axes replicated (an all-gather), since DTensor
    refuses to split a dimension across shards; anything else as it is.
    XLA reshards such a reshape by itself."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim = dim % x.ndim
    pl = list(x.placements)
    sizes = x.device_mesh.shape
    axes = [i for i, p in enumerate(pl) if p.is_shard(dim)]
    m = 1
    for i in axes:
        m *= sizes[i]
    if n % m == 0:
        return x
    for i in axes:
        pl[i] = Replicate()
    return x.redistribute(x.device_mesh, tuple(pl))


def gathered(x, *dims: int):
    """``x`` with dimensions ``dims`` replicated over every mesh axis that
    shards them (a DTensor; anything else as it is): what a reshape that
    merges those dimensions into the one before them needs, since DTensor
    refuses to merge a sharded dimension that is not the first of the
    merged ones (torch 2.11; later versions track it as a strided
    shard). XLA reshards such a reshape by itself."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = {d % x.ndim for d in dims}
    pl = tuple(Replicate() if p.is_shard() and p.dim in dims else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def summed(x):
    """``x`` with its partial sums reduced: a DTensor replicated over the
    mesh axes where it is ``Partial``; anything else as it is. For an op
    that is not linear in x, or an add whose other operand DTensor would
    otherwise turn partial (which torch 2.11 cannot do from a shard)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if q.is_partial() else q for q in x.placements)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def on_grad(x, fn):
    """``x``, whose gradient goes through ``fn`` before it flows on; the
    forward pass is unchanged. ``x`` itself when it needs no gradient."""
    if not x.requires_grad:
        return x
    return _OnGrad.apply(x, fn)


class _OnGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


def grad_gathered(x, *dims: int):
    """A DTensor ``x`` whose gradient has ``dims`` gathered before it flows
    on: for a row-parallel matmul's output that meets the sequence-sharded
    residual, whose gradient the matmul's backward flattens over (B, S).
    The gather is the backward of the reduce-scatter that brings the
    output to the residual's sharding, as XLA takes it."""
    if not is_dtensor(x):
        return x
    return on_grad(x, lambda g: gathered(g, *dims))


def grad_splittable(x, dim: int, n: int):
    """A DTensor ``x`` whose gradient is made ``splittable(grad, dim, n)``
    before it flows on: for a merge of (heads, head dim) that the backward
    splits again, where the mesh does not divide the heads."""
    if not is_dtensor(x):
        return x
    return on_grad(x, lambda g: splittable(g, dim, n))


def annotate(x, *logical_axes):
    """Constrain ``x``'s sharding by logical axis names; the identity (the
    same object) when no ``logical_rules`` context with a mesh is active.

    Entries may be None (dimension explicitly unconstrained). Axes align to
    the TRAILING dims of ``x`` when ranks differ (stacked prefixes stay
    unconstrained), and any mesh axis that does not divide its dimension is
    dropped. Inside a context a DTensor is redistributed to the fitted spec
    (the mesh axes the spec leaves out replicated); an all-None spec leaves
    it as it is. A plain tensor is returned as it is: the reference's
    constraint only ever acts on traced arrays, whose sharding the compiler
    chooses, and a plain tensor has no sharding to constrain."""
    rules = current_rules()
    if rules is None:
        return x
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(logical_axes) > x.ndim:
        logical_axes = logical_axes[len(logical_axes) - x.ndim:]
    spec = fit_spec(mesh, x.shape, spec_for(logical_axes, rules))
    if all(e is None for e in spec) or not is_dtensor(x):
        return x
    want = placements(mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def per_rank(cfg, fn, args, in_axes, out_axes):
    """``fn(*args)`` of plain tensors, on DTensors ``args``: ``local_map``
    over their mesh, each argument placed by its logical axes ``in_axes``
    and each of ``fn``'s outputs by one entry of ``out_axes`` (each fitted
    to the first argument's shape: an axis the mesh does not divide stays
    whole), so that every rank runs ``fn`` on its own shards. The gradient
    of an argument is a partial sum over the mesh axes that split the
    first argument but not it. The rules are those in force, else
    ``logical_rules_for(cfg, mesh)``."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    rules = current_rules() or logical_rules_for(cfg, mesh)

    def placed(shape, axes):
        return placements(mesh, fit_spec(mesh, shape, spec_for(axes, rules)))
    in_pl = tuple(placed(a.shape, ax) for a, ax in zip(args, in_axes))
    grad_pl = tuple(tuple(Partial() if lead.is_shard() and not q.is_shard()
                          else q for lead, q in zip(in_pl[0], pl))
                    for pl in in_pl)
    out_pl = [placed(args[0].shape, ax) for ax in out_axes]
    return local_map(fn, out_placements=tuple(out_pl) if len(out_pl) > 1
                     else list(out_pl[0]), in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
