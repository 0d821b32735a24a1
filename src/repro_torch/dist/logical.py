"""Logical-axis sharding rules (DESIGN.md §5); the port of
``repro.dist.logical``.

Model code names tensor dimensions with LOGICAL axes ("batch", "seq",
"heads", ...) via ``repro_torch.dist.annotate``; a ``logical_rules``
context binds those names to PHYSICAL mesh axes ("data", "model", "pod").
Two properties make this usable inside one shared model implementation:

* PRIORITY ARBITRATION — several logical axes of one tensor may map to the
  same mesh axis (e.g. sequence parallelism maps "seq"→"model" while tensor
  parallelism maps "heads"→"model"). A mesh axis can shard only one
  dimension, so ``spec_for`` awards it to the highest-priority claimant:
  TP-primary contraction axes (heads/mlp/vocab/expert/...) beat "batch",
  which beats the yielding axes "seq"/"cache_seq" (ties: the leftmost
  dimension).
* NO-OP OUTSIDE A CONTEXT — without active rules, ``annotate`` returns its
  input unchanged, so single-device runs never pay for (or depend on) a
  mesh.

A spec is a plain tuple with one entry per dimension: a mesh-axis name, a
tuple of names (the dimension sharded over their product, major to minor)
or None. It compares entry by entry with a JAX ``PartitionSpec``.

The context is a plain module-global stack, as in the reference. The port
has no ambient mesh: ``current_mesh()`` is the mesh given to
``logical_rules``, or None.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]

# Lower value = stronger claim on a contested mesh axis (DESIGN.md §5).
# TP-primary axes are the ones a tensor-parallel matmul contracts or tiles
# over — losing one would silently turn TP off, while "seq"/"cache_seq"
# merely fall back to a gathered (replicated) sequence dimension.
_PRIORITY: Dict[str, int] = {
    "heads": 0, "kv_heads": 0, "mlp": 0, "vocab": 0, "expert": 0, "embed": 0,
    "batch": 1,
    "seq": 3, "cache_seq": 3,
}
_DEFAULT_PRIORITY = 2

# (mapping, mesh) frames; innermost last.
_STACK: list = []


@contextlib.contextmanager
def logical_rules(mapping: Dict[str, MeshAxes], mesh=None):
    """Bind logical-axis names to mesh axes for the dynamic extent.

    ``mapping`` values are a mesh-axis name, a tuple of names (the dimension
    is sharded over their product, e.g. batch over ("pod", "data")), or
    None. ``mesh`` is the mesh ``annotate`` fits shapes against (a torch
    ``DeviceMesh`` or anything with ``axis_names`` and ``shape``); without
    one ``annotate`` leaves every tensor as it is."""
    _STACK.append((dict(mapping), mesh))
    try:
        yield
    finally:
        _STACK.pop()


def current_rules() -> Optional[Dict[str, MeshAxes]]:
    """The innermost active mapping, or None outside any context."""
    return _STACK[-1][0] if _STACK else None


def current_mesh():
    """The mesh given to the innermost ``logical_rules``, else None."""
    if _STACK and _STACK[-1][1] is not None:
        return _STACK[-1][1]
    return None


def _as_tuple(v: MeshAxes) -> Tuple[str, ...]:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


def spec_for(axes: Sequence[Optional[str]],
             rules: Optional[Dict[str, MeshAxes]] = None) -> Spec:
    """Resolve logical axis names to a spec under the active rules,
    arbitrating contested mesh axes by priority (ties: leftmost dimension).

    >>> with logical_rules({"seq": "model", "heads": "model", "batch": "data"}):
    ...     spec_for(("batch", "seq", "heads", None))
    ('data', None, 'model', None)
    """
    if rules is None:
        rules = current_rules()
    if rules is None:
        return (None,) * len(axes)
    entries: list = [None] * len(axes)
    order = sorted(
        (i for i, name in enumerate(axes) if name is not None),
        key=lambda i: (_PRIORITY.get(axes[i], _DEFAULT_PRIORITY), i))
    claimed: set = set()
    for i in order:
        want = tuple(a for a in _as_tuple(rules.get(axes[i]))
                     if a not in claimed)
        if not want:
            continue
        claimed.update(want)
        entries[i] = want[0] if len(want) == 1 else want
    return tuple(entries)
