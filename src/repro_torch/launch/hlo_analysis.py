"""Per-chip cost of one step, counted op by op; the port's counterpart of
``repro.launch.hlo_analysis``.

The reference compiles each dry-run cell with XLA and parses the
optimized, SPMD-partitioned HLO module, multiplying loop bodies by their
trip counts. The port compiles nothing, so no HLO exists. What takes its
place is the step itself, run eagerly once over DTensors whose local
shards are fake tensors (``FakeTensorMode``: shapes and dtypes, no
memory, no arithmetic), on a fake process group of the mesh's world size.
:class:`StepCounter`, a ``TorchDispatchMode``, sees every aten op the
step runs. It lets an op on DTensors pass (``NotImplemented``), so DTensor
splits it into the op on the local shards plus any redistribution, and
counts those: what rank 0 of the mesh runs. A Python loop runs its body
once per trip, so there are no trip counts to multiply.

Local costs, per chip per step, as the reference takes them:
  * dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``): 2 · prod(output dims) ·
    prod(contracting dims); the addend of ``addmm``/``baddbmm`` one op
    per output element;
  * elementwise (an op tagged ``pointwise``): one op per output element;
  * reductions (tagged ``reduction``, and ``_softmax``/``_log_softmax``):
    one op per input element;
  * bytes: every tensor read plus every tensor written by each op that is
    not a view. An eager step runs unfused, so every aten op is a boundary
    (the reference charges only fusion boundaries: its bytes are lower);
  * collectives: output bytes × ring factor (all-reduce 2x, others 1x), by
    kind. DTensor redistributes through the functional collectives
    (``_c10d_functional.*``). On a CPU mesh DTensor turns an all-to-all
    into an all-gather and a chunk (it logs "CPU process group does not
    support alltoall yet"), so there an all-to-all is counted as an
    all-gather.

Ops on fake tensors of another fake mode are not the step's: DTensor runs
each op once on fake global tensors to learn its output's shape (sharding
propagation), and those are skipped. Over plain tensors (one device) the
counter counts the step itself, and ``dot_flops`` equals
``torch.utils.flop_counter.FlopCounterMode``'s total for the same GEMMs.

Peak memory: the live local bytes, taken op by op. Every storage an op
creates adds its bytes when the first tensor on it appears and gives them
back when the last one is freed (a ``weakref.finalize`` on each tensor);
``peak_bytes`` is the largest sum seen, on top of ``argument_bytes``, the
local bytes of the step's inputs (parameters, optimizer state, cache,
batch), which stay live throughout.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# functional collectives (``torch.distributed._functional_collectives``) by
# the reference's kind
_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_DOTS = {"mm", "bmm", "addmm", "baddbmm"}
_SOFTMAX = {"_softmax", "_log_softmax"}
# ops that move or create no data worth counting
_FREE = {"empty", "empty_strided", "empty_like", "detach", "alias",
         "lift_fresh", "_to_copy_meta", "wait_tensor", "set_"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dot_flops(name: str, args, out) -> float:
    """2 · prod(output dims) · prod(contracting dims) of a dot op."""
    if name in ("mm", "addmm"):
        a = args[1] if name == "addmm" else args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("bmm", "baddbmm"):
        a = args[1] if name == "baddbmm" else args[0]
        return 2.0 * out.numel() * a.shape[-1]
    raise ValueError(name)


@contextlib.contextmanager
def scope(name: str):
    """``StepCounter.scope(name)`` of the counter counting now, if any."""
    counter = StepCounter.active
    if counter is None:
        yield
    else:
        with counter.scope(name):
            yield


class StepCounter(TorchDispatchMode):
    """Counts a step's per-chip cost (see the module docstring).

    ``fake_mode``: the ``FakeTensorMode`` the step's tensors belong to, or
    None when they are real; fake tensors of any other mode are DTensor's
    shape propagation and are not counted."""

    active = None       # the counter inside whose block the step runs

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.dot_flops = 0.0
        self.elementwise = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in _COLLECTIVES}
        self.coll_count = {k: 0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}
        self._in_meta = 0
        self._patched = None
        self._scope = None
        self.scoped_dot_flops: Dict[str, float] = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        """Dot flops counted inside the block are also summed under
        ``scoped_dot_flops[name]`` (e.g. the attention of a step whose
        real run launches a kernel no flop counter sees)."""
        outer, self._scope = self._scope, name
        try:
            yield
        finally:
            self._scope = outer

    def __enter__(self):
        # DTensor's shape propagation runs each new op once on fake global
        # tensors, under the step's own fake mode when there is one: mark
        # those calls so they are not counted
        try:
            from torch.distributed.tensor._sharding_prop import (
                ShardingPropagator)
        except ImportError:
            ShardingPropagator = None
        meta = getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                       None)
        if meta is not None:
            def marked(prop, *a, **kw):
                self._in_meta += 1
                try:
                    return meta(prop, *a, **kw)
                finally:
                    self._in_meta -= 1
            ShardingPropagator._propagate_tensor_meta_non_cached = marked
            self._patched = (ShardingPropagator, meta)
        StepCounter.active = self
        return super().__enter__()

    def __exit__(self, *exc):
        StepCounter.active = None
        if self._patched is not None:
            cls, meta = self._patched
            cls._propagate_tensor_meta_non_cached = meta
            self._patched = None
        return super().__exit__(*exc)

    # ------------------------------------------------------------- memory
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        rec = self._storages.get(key)
        if rec is None:
            rec = self._storages[key] = [0, st.nbytes()]
            self.live += rec[1]
            self.peak = max(self.peak, self.live)
        rec[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[0] -= 1
        if rec[0] == 0:
            self.live -= rec[1]
            del self._storages[key]

    # ------------------------------------------------------------ counting
    def _ours(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        if self._in_meta:
            return False
        for t in tensors:
            if isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode:
                return False
        return True

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        outs = _tensors(out)
        if ns == "_c10d_functional":
            kind = _FUNCOL.get(name)
            if kind is not None:
                nbytes = sum(_nbytes(t) for t in outs) * _COLL_FACTOR[kind]
                self.coll[kind] += nbytes
                self.coll_count[kind] += 1
                self.bytes += sum(_nbytes(t) for t in
                                  _tensors((args, kwargs, out)))
            return
        if func.is_view or name in _FREE:
            return
        if name in _DOTS:
            f = dot_flops(name, args, outs[0])
            self.dot_flops += f
            self.flops += f
            if self._scope is not None:
                self.scoped_dot_flops[self._scope] = \
                    self.scoped_dot_flops.get(self._scope, 0.0) + f
            if name in ("addmm", "baddbmm"):
                self.flops += outs[0].numel()
                self.elementwise += outs[0].numel()
        elif torch.Tag.pointwise in func.tags:
            n = sum(t.numel() for t in outs)
            self.flops += n
            self.elementwise += n
        elif torch.Tag.reduction in func.tags or name in _SOFTMAX:
            ins = _tensors(args[:1])
            self.flops += sum(t.numel() for t in ins)
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor splits it: count that
        out = func(*args, **kwargs)
        if self._ours(_tensors((args, kwargs))):
            self._count(func, args, kwargs, out)
            for t in _tensors(out):
                self._track(t)
        return out

    # -------------------------------------------------------------- results
    def cost(self) -> Dict[str, Any]:
        """The reference's ``analyze_hlo`` fields: per chip per step."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": sum(self.coll.values()),
                "coll": dict(self.coll),
                "dot_flops": self.dot_flops,
                "elementwise_ops": self.elementwise,
                "collective_counts": dict(self.coll_count),
                "scoped_dot_flops": dict(self.scoped_dot_flops)}


def local_bytes(tree) -> int:
    """The local bytes of every tensor in ``tree`` (a DTensor's shard)."""
    from repro_torch.dist import is_dtensor
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if is_dtensor(t) else t)
    return total
