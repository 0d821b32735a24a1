"""Data-parallel Plan execution over a mesh of devices (DESIGN.md §9).

The port of ``repro.dist.data_parallel``. The paper's amortization
precomputes fixed-shape batches; the next scale lever is running those
frozen batches across several devices instead of one at a time. The unit
of multi-device work is the **super-step**: the Plan's schedule is grouped
into consecutive runs of `world` batches (`world` = product of the mesh's
data-axis sizes), every mesh entry takes one batch, and the gradients are
averaged over the super-step — the same update as single-device training
with gradient accumulation over `world` micro-batches.

How the port runs it (the reference's semantics, one process):

* **one controller.** The reference runs a super-step as one ``shard_map``
  program driven by one ``fit`` call; the port drives it from one Python
  process over an explicit :class:`DataMesh` of torch devices. Member j
  runs its forward and backward on mesh entry j, in mesh order (flattened,
  ``"pod"`` before ``"data"``). A mesh may name one device more than once
  — the counterpart of XLA's ``--xla_force_host_platform_device_count``,
  with which the reference's own tests emulate 8 devices on one CPU — so a
  world-4 mesh runs on one card.
* **params replicate.** The master parameters and the optimizer state
  live on the mesh's first device. :func:`replicate` clones every leaf
  once per mesh entry, even when two entries name one device, so the
  refresh of the replicas after each update runs the same way on the CPU,
  on one card and across cards.
* **the weighted mean.** Member gradients go to the first device and are
  summed there in mesh order as Σ_j w_j·g_j, then divided by Σ_j w_j, the
  real count. The ragged tail of an epoch is padded by repeating the last
  real batch with weight 0; a pad still runs, and its gradient times 0
  adds ±0. That is ``GradAccumulator``'s sum and division operation for
  operation, so a mesh fit is bitwise the single-device fit with
  ``grad_accum = world`` on the same device (NaN or Inf times 0 stays
  NaN, as in the reference, which is why the trainer refuses a
  ``nonfinite_policy`` with a mesh).
* **staging.** :func:`stack_batches` stacks the members on the host as the
  reference does. :meth:`ShardedPlanExecutor.stage` then copies each
  stacked field to the device once when every mesh entry names one device
  (the members are views of it), and each member's slice to its own device
  otherwise.
* **backends.** Each member runs the per-batch code of the single-device
  trainer and engine, on its replica's device: under bcsr on a card every
  aggregation is the block-CSR SpMM kernel (``kernels/spmm/ops.py``), its
  launches counted as on the single-device path. Backend selection is a
  ``BackendPolicy``; the executor keeps one closure set per (backend,
  block_f) decision, built lazily.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.loader import consume_superstep, stage_superstep
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import data_axes
from repro_torch.models.gnn import policy as gnn_policy
from repro_torch.models.gnn.models import (
    GNNConfig, gnn_apply, masked_xent, output_logits,
)
from repro_torch.optim.optimizers import apply_updates, tree_leaves, tree_map


# ------------------------------------------------------------------- meshes
def _entry(d) -> torch.device:
    """One mesh entry as a ``torch.device`` with an explicit CUDA index
    (``"cuda"`` alone means the current card), so equal entries compare
    equal. A CUDA entry without a card raises."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DataMesh:
    """An array of torch devices with named axes — the port's counterpart
    of a ``jax.sharding.Mesh`` for data-parallel Plan execution.

    ``DataMesh(["cuda:0", "cuda:1"])`` is a 1-D ``("data",)`` mesh;
    ``DataMesh([[a, b], [c, d]], ("pod", "data"))`` a 2×2 one. An entry may
    repeat a device: ``DataMesh(["cpu"] * 4)`` is the CPU mesh of world 4
    the tests use, ``DataMesh(["cuda:0"] * 4)`` a world-4 mesh on one card.
    ``shape`` maps each axis name to its size, as ``Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data",)):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names) or arr.size == 0:
            raise ValueError(
                f"a mesh of shape {arr.shape} needs {arr.ndim} axis names "
                f"and at least one device, got {self.axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for pos, d in np.ndenumerate(arr):
            self.devices[pos] = _entry(d)
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def members(self) -> List[torch.device]:
        """The device of each super-step member, in mesh order: the data
        axes flattened outermost first, any other axis at its first
        entry."""
        dp = data_axes(self)
        mesh_world(self)                     # raises without a data axis
        sel = tuple(slice(None) if a in dp else 0 for a in self.axis_names)
        return list(np.asarray(self.devices[sel]).ravel())

    def __repr__(self) -> str:
        return (f"DataMesh({[str(d) for d in self.devices.ravel()]}, "
                f"shape={self.shape})")


def data_mesh(num_devices: Optional[int] = None) -> DataMesh:
    """A 1-D pure data-parallel mesh over (the first `num_devices` of) the
    visible CUDA cards — the mesh ``GNNTrainer.fit(mesh=...)`` and
    ``GNNInferenceEngine(mesh=...)`` expect. Raises without a card; build
    a ``DataMesh`` of ``"cpu"`` entries to run on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; build "
                           "DataMesh(['cpu'] * n) to run on the CPU")
    have = torch.cuda.device_count()
    n = have if num_devices is None else num_devices
    if n < 1 or n > have:
        raise ValueError(f"num_devices={num_devices} but {have} present")
    return DataMesh([torch.device("cuda", i) for i in range(n)], ("data",))


def mesh_world(mesh) -> int:
    """Batches per super-step: the product of the mesh's data-axis sizes."""
    dp = data_axes(mesh)
    if not dp:
        raise ValueError(
            f"mesh {mesh.axis_names} has no data axis ('data'/'pod') — "
            "data-parallel Plan execution needs one")
    w = 1
    for a in dp:
        w *= mesh.shape[a]
    return w


# --------------------------------------------------------------- super-steps
def superstep_indices(order: Sequence[int], world: int
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Group a schedule into device-count-sized super-steps.

    Returns a list of ``(idx, weight)`` pairs, each of length `world`:
    `idx` are batch indices into the cache, `weight` is 1.0 for real
    entries and 0.0 for the ragged-tail pads (which repeat the last real
    batch — same shape bucket, zero contribution to the weighted mean)."""
    order = np.asarray(order, dtype=np.int64)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    steps = []
    for s in range(0, len(order), world):
        chunk = order[s:s + world]
        pad = world - len(chunk)
        idx = np.concatenate([chunk, np.full(pad, chunk[-1], np.int64)])
        w = np.concatenate([np.ones(len(chunk), np.float32),
                            np.zeros(pad, np.float32)])
        steps.append((idx, w))
    return steps


def stack_batches(host, idx: np.ndarray) -> Dict[str, np.ndarray]:
    """Stack batches `idx` of an indexable host container into one
    super-step: every field gains a leading axis of length len(idx).

    Fast path: a ``BatchCache`` (or a ``Plan``'s cache) answers with one
    fancy-index per contiguous field block. All selected batches must share
    one shape bucket — guaranteed within a Plan, asserted otherwise.

    A host exposing ``stack(idx)`` (the out-of-core ``LazyBatchCache``,
    DESIGN.md §13) wins over the fields fast path: its members must come
    through the checksum-verified, LRU-budgeted per-batch read — fancy-
    indexing its memmaps would silently skip both."""
    stack = getattr(host, "stack", None)
    if stack is not None:                        # verified lazy path (§13)
        return stack(np.asarray(idx))
    fields = getattr(host, "fields", None)
    if fields is not None:                       # BatchCache fast path
        return {k: v[idx] for k, v in fields.items()}
    dicts = [host[int(i)] for i in idx]
    for d in dicts[1:]:
        assert all(np.shape(d[k]) == np.shape(dicts[0][k]) for k in d), \
            "super-step members must share one padded shape bucket"
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


# -------------------------------------------------------------- replication
def replicate(tree, mesh: DataMesh) -> List:
    """One clone of every leaf of `tree` per super-step member, on that
    member's device — a copy even where two members share a device."""
    return [tree_map(lambda t: torch.as_tensor(t).detach().to(
        device=d, copy=True), tree) for d in mesh.members]


@torch.no_grad()
def refresh_replicas(replicas: List, tree) -> None:
    """Copy `tree` into every replica, leaf by leaf, in place."""
    src = tree_leaves(tree)
    for rep in replicas:
        for r, s in zip(tree_leaves(rep), src):
            r.copy_(s)


def member(batch: Dict, j: int) -> Dict:
    """Member j of a staged super-step (a view or a tensor of its own)."""
    return {k: v[j] for k, v in batch.items()}


# --------------------------------------------------------------- the executor
@dataclasses.dataclass(frozen=True)
class SuperstepFns:
    """One decision's super-step closures (DESIGN.md §9/§14)."""
    train: Callable
    eval: Callable
    forward: Callable


class ShardedPlanExecutor:
    """Execute a Plan's schedule data-parallel over `mesh` (DESIGN.md §9).

    Owns the super-step closures — train (every member's forward and
    backward on its replica, the weighted gradient mean on the first
    device, one optimizer update of the master parameters, the replicas
    refreshed), eval (per-member weighted loss/accuracy sums) and forward
    (per-member output logits, consumed by ``GNNInferenceEngine``) — one
    set per (backend, block_f) decision, built lazily.

    `opt` (a ``repro_torch.optim`` Optimizer) is only needed for training.
    `backend` accepts a name, ``"auto"`` or a
    :class:`~repro_torch.models.gnn.policy.BackendPolicy`; with an auto
    policy, callers pick the per-super-step closures via :meth:`steps_for`
    + ``policy.superstep_decision`` (``evaluate`` does this itself).
    """

    def __init__(self, mesh: DataMesh, model_cfg: GNNConfig, opt=None,
                 backend=None):
        model_cfg, self.policy = gnn_policy.resolve(model_cfg, backend)
        self.mesh = mesh
        self.cfg = model_cfg
        self.opt = opt
        self.world = mesh_world(mesh)
        self.devices = mesh.members
        self.device = self.devices[0]        # master params, summed grads
        self.backend = model_cfg.backend
        self._steps: Dict[Tuple[str, int], SuperstepFns] = {}
        base = self.steps_for(self.backend,
                              int(getattr(model_cfg, "bcsr_block_f", 0)))
        # the fixed-decision closures, kept as plain attributes for the
        # single-decision callers
        self.train_superstep = base.train
        self.eval_superstep = base.eval
        self.forward_superstep = base.forward

    # ------------------------------------------------------------ staging
    def place(self, tree):
        """`tree` on the mesh's first device (the master copy)."""
        return tree_map(lambda t: torch.as_tensor(t).to(self.device), tree)

    def replicate(self, tree) -> List:
        return replicate(tree, self.mesh)

    def supersteps(self, order) -> List[Tuple[np.ndarray, np.ndarray]]:
        return superstep_indices(order, self.world)

    def stage(self, host, idx: np.ndarray, weights: np.ndarray):
        """Stack one super-step on the host and place member j on device
        j, on the current stream; returns ``(batch, weights)``, each field
        of ``batch`` indexable by member."""
        stacked = stack_batches(host, idx)
        batch = consume_superstep(stage_superstep(stacked, self.devices))
        return batch, np.asarray(weights, np.float32)

    def decisions(self, host) -> List[Tuple[str, int]]:
        """Per-batch (backend, block_f) under this executor's policy —
        the plan's stored autotuner decisions when ``host`` carries them
        (DESIGN.md §14)."""
        return gnn_policy.batch_decisions(host, self.policy, self.cfg)

    # ------------------------------------------------------------- builds
    def steps_for(self, backend: str, block_f: int = 0) -> SuperstepFns:
        """The (train, eval, forward) super-step closures for one
        (backend, block_f) decision — built lazily, cached for the
        executor's lifetime."""
        key = (backend, int(block_f))
        if key not in self._steps:
            self._steps[key] = self._build(backend, int(block_f))
        return self._steps[key]

    def _build(self, backend: str, block_f: int) -> SuperstepFns:
        cfg = gnn_policy.batch_config(self.cfg, backend, block_f)
        opt, dev0 = self.opt, self.device

        # the single-device trainer's loss and gradient, verbatim: the
        # bitwise parity with grad_accum rests on running the same ops
        def loss_fn(params, batch, gen):
            h = gnn_apply(cfg, params, batch, generator=gen, train=True)
            logits = output_logits(h, batch)
            return masked_xent(logits, batch["labels"], batch["output_mask"])

        def grad_step(params, batch, gen):
            with torch.enable_grad():
                p = tree_map(lambda t: t.detach().requires_grad_(True),
                             params)
                loss = loss_fn(p, batch, gen)
                flat = iter(torch.autograd.grad(loss, tree_leaves(p)))
            return loss.detach(), tree_map(lambda _: next(flat), params)

        def train(params, replicas, opt_state, batch, weights, lr, gens):
            """One super-step from the master ``params`` and their
            ``replicas``; ``gens[j]`` is member j's dropout generator.
            Returns the new master params, optimizer state and the
            per-member losses; the replicas are refreshed in place."""
            total, losses = None, []
            for j, w in enumerate(weights):
                loss, g = grad_step(replicas[j], member(batch, j), gens[j])
                losses.append(loss)
                g = tree_map(lambda t: t.to(dev0) * float(w), g)
                total = g if total is None else tree_map(torch.add, total, g)
            denom = float(np.sum(weights))
            grads = tree_map(lambda t: t / denom, total)
            updates, opt_state = opt.update(grads, opt_state, params, lr)
            params = apply_updates(params, updates)
            refresh_replicas(replicas, params)
            return params, opt_state, losses

        @torch.no_grad()
        def eval_(replicas, batch, weights):
            out = []
            for j, w in enumerate(weights):
                b = member(batch, j)
                logits = output_logits(
                    gnn_apply(cfg, replicas[j], b, train=False), b)
                mask = b["output_mask"].to(torch.float32)
                loss = masked_xent(logits, b["labels"], mask)
                acc = ((logits.argmax(-1) == b["labels"]).to(torch.float32)
                       * mask).sum()
                w = float(w)
                out.append((loss * mask.sum() * w, acc * w, mask.sum() * w))
            return out

        @torch.inference_mode()
        def forward(replicas, batch):
            return [output_logits(gnn_apply(cfg, replicas[j], b), b)
                    for j in range(self.world) for b in [member(batch, j)]]

        return SuperstepFns(train, eval_, forward)

    # ---------------------------------------------------------- evaluation
    def evaluate(self, params, host, decisions=None) -> Dict[str, float]:
        """Mini-batched evaluation over every batch of `host`, mesh-
        parallel; the per-batch sums of the single-device
        ``GNNTrainer.evaluate``, added in the same order. ``params`` is
        the list :meth:`replicate` returns (a bare tree is replicated
        first). Under an auto policy each super-step runs the closures
        its group's stored decision selects (``policy.superstep_
        decision``); pass ``decisions`` when `host` is a bare cache whose
        owning Plan carried the stored decisions."""
        replicas = params if isinstance(params, list) \
            else self.replicate(params)
        if decisions is None:
            decisions = self.decisions(host)
        tot_l = tot_a = tot_n = 0.0
        for idx, w in self.supersteps(np.arange(len(host))):
            fns = self.steps_for(
                *gnn_policy.superstep_decision(decisions, idx))
            batch, wd = self.stage(host, idx, w)
            for l, a, n in fns.eval(replicas, batch, wd):
                tot_l += float(l); tot_a += float(a); tot_n += float(n)
        n = max(tot_n, 1.0)
        return {"loss": tot_l / n, "acc": tot_a / n}
