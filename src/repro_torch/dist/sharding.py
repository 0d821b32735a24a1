"""Path- and shape-driven sharding specs for whole trees (DESIGN.md §5); the
port of ``repro.dist.sharding``.

Policy in one line: weights are FSDP-sharded over "data" and tensor-parallel
over "model"; activations/batches are data-parallel over ("pod",) "data" with
the sequence dimension on "model" (sequence parallelism) until a TP-primary
axis claims it; caches shard batch and kv-heads.

Everything funnels through ``fit_spec``, which enforces the two global
invariants:
* LEFT-PADDING — spec entries align to the TRAILING dims, so the same rule
  covers a parameter and its stacked (repeat, ...) variant.
* DIVISIBILITY FALLBACK — a mesh axis whose size does not divide the
  dimension is dropped (replicated) instead of erroring, so one policy
  serves every (arch × shape × mesh) cell of the dry run.

Every spec function takes any mesh with named axes: a torch ``DeviceMesh``
(``mesh_dim_names``), the port's ``DataMesh`` or anything else with
``axis_names`` and a ``shape`` mapping names to sizes. A spec is a tuple
(``repro_torch.dist.logical``). Where the reference builds
``NamedSharding`` trees (``tree_shardings``/``with_shardings``), the port
turns a spec into DTensor placements (``placements``) and places a tree of
tensors by them (``distribute_tree``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

from repro_torch.dist.logical import Spec, _as_tuple


# --------------------------------------------------------------- mesh shape
def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, outermost first."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"{type(mesh).__name__} names no axes: build the "
                        f"DeviceMesh with mesh_dim_names")
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, as a JAX ``Mesh.shape`` gives it."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


# ------------------------------------------------------------------ fit_spec
def _axis_size(sizes: Dict[str, int], entry) -> int:
    """Product of the named axes' sizes; 0 if any axis is not in the mesh
    (the caller then drops the entry — part of the fallback contract)."""
    n = 1
    for a in _as_tuple(entry):
        if a not in sizes:
            return 0
        n *= sizes[a]
    return n


def fit_spec(mesh, shape: Sequence[int], axes: Sequence) -> Spec:
    """Fit mesh-axis names to the trailing dims of ``shape``.

    ``axes`` may be shorter than ``shape`` (stacked/leading dims get None)
    and entries may be a name, a tuple of names, or None. Names that do not
    divide their dimension — or do not exist in this mesh — are dropped
    (replicated)."""
    sizes = axis_sizes(mesh)
    shape = tuple(shape)
    axes = tuple(axes)
    if len(axes) > len(shape):
        axes = axes[len(axes) - len(shape):]
    pad = len(shape) - len(axes)
    entries: List[Any] = [None] * pad
    for dim, entry in zip(shape[pad:], axes):
        n = _axis_size(sizes, entry) if entry is not None else 0
        entries.append(entry if n > 0 and dim % n == 0 else None)
    return tuple(entries)


def data_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel (DP/FSDP) axes of a mesh, outermost first."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def _dp(mesh):
    dp = data_axes(mesh)
    if not dp:
        return None
    return dp[0] if len(dp) == 1 else dp


def _tp(mesh):
    return "model" if "model" in axis_names(mesh) else None


# ---------------------------------------------------------------- param_spec
# Classification by parameter NAME (the last key of its path). Canonical
# specs are for the unstacked rank; fit_spec left-pads the "repeat" axis.
#   column-parallel: contraction dim FSDP-sharded on "data", output on "model"
#   row-parallel:    "model"-contracted input, output gathered onto "data"
_COL = {
    "wq", "wk", "wv", "w_in", "w_gate", "wkv_a", "wq_a", "wq_b", "wk_b",
    "wv_b", "router", "sh_in", "sh_gate", "w_main", "wa", "wi", "lora_a",
    "wr", "wg", "ck", "cr", "w",
}
_ROW = {"wo", "w_out", "sh_out", "cv", "wb_w", "proj"}
# expert-parallel: leading expert dim on "model" (EP), d_model FSDP on "data"
_EXPERT = {"we_in", "we_gate", "we_out"}
# embedding/unembedding tables: (vocab, embed) → vocab TP, embed FSDP
_TABLE = {"table"}


def _key_name(entry) -> str:
    """A path entry's name: a dict key, a list index, or a JAX key object's
    ``key``/``name``/``idx``."""
    return str(getattr(entry, "key", getattr(entry, "name",
               getattr(entry, "idx", entry))))


def _classify(name: str):
    if name in _COL:
        return ("data", "model")
    if name in _ROW:
        return ("model", "data")
    if name in _EXPERT:
        return ("model", "data", None)
    if name in _TABLE:
        return ("model", "data")
    return None


def _ndim(leaf) -> int:
    return len(tuple(leaf.shape))


def param_spec(mesh, path, leaf) -> Spec:
    """Sharding for one parameter leaf, keyed on its path (a sequence of
    dict keys and list indices).

    Unrecognized names (norm scales, biases, gates, decay vectors, ...) are
    replicated — they are small, and replication is always correct."""
    name = _key_name(path[-1]) if path else ""
    axes = _classify(name)
    if axes is None:
        return (None,) * _ndim(leaf)
    return fit_spec(mesh, leaf.shape, axes)


# ------------------------------------------------------------------ opt_spec
_FACTORED_SLOTS = {"vr", "vc"}


def opt_spec(mesh, path, leaf, extra: Dict[str, Any]) -> Spec:
    """Optimizer-state sharding: mirror the owning parameter (DESIGN.md §4).

    Adam-family states nest the param tree under "m"/"v"/"mu"/"acc", so the
    LAST key is still the parameter name and ``param_spec`` applies
    verbatim. Adafactor's factored slots ("vr"/"vc") are rank-reduced
    vectors hanging UNDER the parameter key: replicate them, and shard an
    unfactored "v" slot like its parent."""
    names = [_key_name(k) for k in path]
    if names and names[-1] in _FACTORED_SLOTS:
        return (None,) * _ndim(leaf)
    if len(names) >= 2 and names[-1] == "v" \
            and _classify(names[-2]) is not None:
        return fit_spec(mesh, leaf.shape, _classify(names[-2]))
    return param_spec(mesh, path, leaf)


# ---------------------------------------------------------------- cache_spec
# Canonical (unstacked) trailing specs per cache leaf name. _BATCH stands in
# for the mesh's data axes, resolved at call time.
_BATCH = object()
_CACHE = {
    "k":       (_BATCH, None, "model", None),   # (B, S, KV, hd)
    "v":       (_BATCH, None, "model", None),
    "c_kv":    (_BATCH, None, None),            # MLA compressed (B, S, r)
    "k_rope":  (_BATCH, None, None),
    "wkv":     (_BATCH, "model", None, None),   # RWKV state (B, H, dk, dv)
    "shift_t": (_BATCH, None),
    "shift_c": (_BATCH, None),
    "h":       (_BATCH, None),                  # RG-LRU state (B, W)
    "conv":    (_BATCH, None, None),
}


def cache_spec(mesh, path, leaf) -> Spec:
    """Decode-cache sharding: batch over the data axes, kv-heads / rwkv
    heads over "model"; recurrent per-channel states replicate their
    channel dim."""
    name = _key_name(path[-1]) if path else ""
    axes = _CACHE.get(name)
    if axes is None:
        return (None,) * _ndim(leaf)
    dp = _dp(mesh)
    return fit_spec(mesh, leaf.shape,
                    tuple(dp if a is _BATCH else a for a in axes))


# ---------------------------------------------------------------- batch_spec
def batch_spec(mesh, name: str, shape: Sequence[int]) -> Spec:
    """Model-input sharding: dim 0 (batch) over the data axes, dim 1 (seq)
    over "model" (sequence parallelism). Divisibility fallback makes this
    safe for decode steps (S=1) and ragged prefix lengths."""
    shape = tuple(shape)
    if not shape:
        return ()
    axes: list = [_dp(mesh)]
    if len(shape) > 1:
        axes.append(_tp(mesh))
    axes += [None] * (len(shape) - len(axes))
    return fit_spec(mesh, shape, axes)


# ------------------------------------------------------------- placements
def placements(mesh, spec: Spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh axis,
    ``Shard(d)`` for the axis that shards dimension d, else
    ``Replicate()``. An axis of size 1 shards nothing: it gets
    ``Replicate()``, the same data, which spares DTensor from refusing
    views that merge or drop a length-1 dimension "sharded" over it (a
    batch of 1 on a data axis of 1). A dimension over a tuple of axes is split major to
    minor, as JAX splits it; DTensor applies the shards of one dimension in
    mesh-axis order, so the tuple must list its axes in that order (every
    spec of this module does: the data axes come from ``data_axes``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _as_tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dimension {dim} is split over {axes}, not in "
                             f"the mesh's axis order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def _walk(tree: Any, fn: Callable, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def distribute_tree(mesh, tree: Any,
                    spec_fn: Callable[[Any, Any, Any], Spec]) -> Any:
    """Each tensor of ``tree`` as a DTensor on the torch ``DeviceMesh``
    ``mesh``, placed by ``spec_fn(mesh, path, leaf)``: the counterpart of
    the reference's ``with_shardings(tree, tree_shardings(...))``. Each
    rank keeps only its own shard (no data moves between ranks); a leaf
    already a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(path, leaf):
        pl = placements(mesh, spec_fn(mesh, path, leaf))
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh, pl)
        return distribute_tensor(leaf, mesh, pl, src_data_rank=None)
    return _walk(tree, place)


# ------------------------------------------------------------- logical rules
def logical_rules_for(cfg, mesh) -> Dict[str, Any]:
    """The logical→mesh binding for the LM stack on this mesh (DESIGN.md
    §5).

    "batch" spans every data axis; all TP-primary names plus the yielding
    "seq"/"cache_seq" share "model" — ``spec_for`` arbitration decides, per
    tensor, which one actually holds it. "embed" is deliberately unmapped:
    the residual stream keeps its channel dim gathered, and TP happens
    through the weight shardings (``param_spec``), not activation
    constraints."""
    rules: Dict[str, Any] = {"batch": _dp(mesh)}
    tp = _tp(mesh)
    if tp is not None:
        for name in ("seq", "cache_seq", "heads", "kv_heads", "mlp",
                     "vocab", "expert"):
            rules[name] = tp
    return rules
