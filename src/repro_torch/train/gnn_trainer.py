"""GNN training loop reproducing the paper's recipe (Sec. 4 / App. B), in
PyTorch.

The port of ``repro.train.gnn_trainer``: Adam + ReduceLROnPlateau(0.33,
patience, cooldown) on val loss, early stop on val loss, batch scheduling
(TSP / weighted / none), optional gradient accumulation, mini-batched
evaluation with the SAME method used for training ("since full inference
is too slow to execute every epoch"), and the non-finite gradient guard
(DESIGN.md §12). ``fit(mesh=...)`` runs the Plan data-parallel over a
``repro_torch.dist.data_parallel.DataMesh`` (DESIGN.md §9).

Each step runs eagerly on the trainer's device (``cuda`` unless the caller
passes another). Batches are staged by ``PrefetchLoader`` on a side stream
while the previous step computes; with the bcsr backend on a CUDA device
every aggregation of the GCN and SAGE, forward and backward, is the
hand-written block-CSR SpMM kernel (SAGE's in its pattern mode); GAT
aggregates on the segment path whatever the backend. Parameters and optimizer state are trees of tensors with the
reference's layout, so either package's state carries into the other.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.batches import BatchCache, PaddedBatch
from repro_torch.core.plan import Plan
from repro_torch.core.scheduling import make_schedule
from repro_torch.data.loader import PrefetchLoader
from repro_torch.device import DeviceSpec, resolve_device, stage
from repro_torch.faults import FaultStats
from repro_torch.models.gnn import ops as gnn_ops
from repro_torch.models.gnn import policy as gnn_policy
from repro_torch.models.gnn.models import (
    GNNConfig, init_gnn, gnn_apply, output_logits, masked_xent,
)
from repro_torch.optim.accumulate import GradAccumulator
from repro_torch.optim.optimizers import (
    apply_updates, get_optimizer, tree_leaves, tree_map,
)
from repro_torch.optim.schedules import ReduceLROnPlateau


class NonFiniteGradError(RuntimeError):
    """Raised by ``nonfinite_policy="halt"`` when a step produces NaN/Inf
    loss or gradients (DESIGN.md §12) — training stops at the first
    poisoned step instead of silently corrupting the parameters."""


@dataclasses.dataclass
class TrainResult:
    params: Dict
    history: List[Dict]          # per-epoch metrics
    best_val_acc: float
    best_epoch: int
    time_per_epoch: float
    preprocess_time: float
    total_time: float


def _derive_seed(*words: int) -> int:
    """A 64-bit seed that is a pure function of ``words``."""
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0])


def step_rng(seed: int, epoch: int, step: int) -> int:
    """Dropout seed for (epoch, step), derived statelessly from the base
    seed — the counterpart of the reference's ``step_rng``.

    Seeds MUST differ across epochs for the same step: a generator merely
    re-seeded from the top every epoch would replay identical dropout masks
    epoch after epoch. Domain word 1 keeps the (epoch, step) grid disjoint
    from the initialisation seed (domain 0, see ``fit``)."""
    return _derive_seed(seed, 1, epoch, step)


def step_generator(seed: int, epoch: int, step: int,
                   device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``step_rng(seed, epoch,
    step)``."""
    return torch.Generator(device=device).manual_seed(
        step_rng(seed, epoch, step))


def as_host_batches(batches):
    """Normalize any batch container to an indexable sequence of host-array
    dicts. ``Plan`` is the primary input (DESIGN.md §8); raw ``PaddedBatch``
    lists and ``BatchCache`` keep working. A ``Plan``/``BatchCache`` is
    consumed in place — reading batch i slices the contiguous cache."""
    if isinstance(batches, Plan):
        return batches.cache
    if isinstance(batches, BatchCache):
        return batches
    return [b.device_arrays() if isinstance(b, PaddedBatch) else b
            for b in batches]


def _batch_labels(batches) -> List[np.ndarray]:
    """Per-batch real output labels, for the scheduler."""
    if isinstance(batches, Plan):
        return batches.batch_labels()
    if isinstance(batches, BatchCache):
        lab, msk = batches.fields["labels"], batches.fields["output_mask"]
        return [lab[i][msk[i] > 0] for i in range(len(batches))]
    return [b.labels[b.output_mask] for b in batches]


def _tree_finite(loss: torch.Tensor, grads) -> bool:
    flags = [torch.isfinite(loss).all()] + \
        [torch.isfinite(g).all() for g in tree_leaves(grads)]
    return bool(torch.stack(flags).all())


class GNNTrainer:
    def __init__(self, model_cfg: GNNConfig, optimizer: str = "adam",
                 lr: float = 1e-3, weight_decay: float = 0.0,
                 plateau_patience: int = 30, early_stop_patience: int = 100,
                 grad_accum: int = 1, seed: int = 0,
                 backend=None,
                 nonfinite_policy: str = "off",
                 device: DeviceSpec = None):
        # `backend` overrides model_cfg.backend (DESIGN.md §7/§14): a name,
        # "auto", or a BackendPolicy; the auto policy dispatches per batch
        # on the plan's stored autotuner decisions.
        self.device = resolve_device(device)
        model_cfg, self.policy = gnn_policy.resolve(model_cfg, backend)
        # NaN/Inf grad guard (DESIGN.md §12): "skip" drops the poisoned
        # update and keeps going; "halt" raises NonFiniteGradError.
        if nonfinite_policy not in ("off", "skip", "halt"):
            raise ValueError(
                f"nonfinite_policy must be 'off', 'skip' or 'halt': "
                f"{nonfinite_policy!r}")
        self.cfg = model_cfg
        self.opt = get_optimizer(optimizer, weight_decay=weight_decay)
        self.sched = ReduceLROnPlateau(lr=lr, patience=plateau_patience)
        self.early_stop_patience = early_stop_patience
        self.grad_accum = grad_accum
        self.seed = seed
        self.nonfinite_policy = nonfinite_policy
        self.fault_stats = FaultStats("nonfinite_steps", "skipped_steps",
                                      "halts")
        self._step_cache: Dict = {}

    def _steps_for(self, backend: str, block_f: int = 0) -> Dict:
        """The step set for one (backend, block_f) decision (DESIGN.md
        §14), built once per distinct decision in play."""
        key = (backend, int(block_f))
        if key not in self._step_cache:
            self._step_cache[key] = self._build_steps(
                gnn_policy.batch_config(self.cfg, backend, int(block_f)))
        return self._step_cache[key]

    def _build_steps(self, cfg) -> Dict:
        opt = self.opt

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

        def apply_step(params, opt_state, grads, lr):
            updates, opt_state = opt.update(grads, opt_state, params, lr)
            return apply_updates(params, updates), opt_state

        def train_step(params, opt_state, batch, lr, gen):
            loss, grads = grad_step(params, batch, gen)
            params, opt_state = apply_step(params, opt_state, grads, lr)
            return params, opt_state, loss

        # Guarded variant (DESIGN.md §12): when the step is non-finite the
        # OLD params/opt_state are returned untouched.
        def guarded_train_step(params, opt_state, batch, lr, gen):
            loss, grads = grad_step(params, batch, gen)
            ok = _tree_finite(loss, grads)
            if ok:
                params, opt_state = apply_step(params, opt_state, grads, lr)
            return params, opt_state, loss, ok

        @torch.no_grad()
        def eval_step(params, batch):
            h = gnn_apply(cfg, params, batch, train=False)
            logits = output_logits(h, batch)
            mask = batch["output_mask"].to(torch.float32)
            loss = masked_xent(logits, batch["labels"], mask)
            acc_num = (logits.argmax(-1) == batch["labels"]).to(
                torch.float32) * mask
            return loss * mask.sum(), acc_num.sum(), mask.sum()

        return {"train": train_step, "grad": grad_step, "apply": apply_step,
                "eval": eval_step, "guarded": guarded_train_step}

    def init_params(self, rng: Optional[int] = None) -> Dict:
        """The parameters ``fit`` starts from: ``init_gnn`` with a CPU
        generator seeded from domain 0 of the base seed (``self.seed`` when
        ``rng`` is None), on the trainer's device."""
        base = self.seed if rng is None else int(rng)
        return init_gnn(self.cfg,
                        torch.Generator().manual_seed(_derive_seed(base, 0)),
                        device=self.device)

    # ------------------------------------------------------------------
    def _on_nonfinite(self, ep: int, step: int) -> None:
        """Apply the nonfinite policy to one poisoned step (DESIGN.md §12)."""
        self.fault_stats.bump("nonfinite_steps")
        if self.nonfinite_policy == "halt":
            self.fault_stats.bump("halts")
            raise NonFiniteGradError(
                f"non-finite loss/gradients at epoch {ep} step {step} "
                f"(nonfinite_policy='halt')")
        self.fault_stats.bump("skipped_steps")

    def snapshot(self) -> Dict:
        """Degradation observability (DESIGN.md §12), the ServeStats idiom."""
        return {"nonfinite_policy": self.nonfinite_policy,
                "faults": self.fault_stats.snapshot()}

    # ------------------------------------------------------------------
    def evaluate(self, params, batches) -> Dict[str, float]:
        """Mini-batched evaluation. Accepts a Plan (primary), a BatchCache,
        a list of PaddedBatch, or a list of host-array dicts. Under an auto
        policy each batch runs the backend the plan's stored autotuner
        decision selects (DESIGN.md §14); decisions are read from the
        ORIGINAL container before cache normalization."""
        decisions = gnn_policy.batch_decisions(batches, self.policy, self.cfg)
        batches = as_host_batches(batches)
        tot_l = tot_a = tot_n = 0.0
        for i in range(len(batches)):
            l, a, n = self._steps_for(*decisions[i])["eval"](
                params, stage(batches[i], self.device))
            tot_l += float(l); tot_a += float(a); tot_n += float(n)
        n = max(tot_n, 1.0)
        return {"loss": tot_l / n, "acc": tot_a / n}

    def _mesh_epoch(self, executor, host, order, decisions, params, replicas,
                    opt_state, base: int, ep: int):
        """One epoch of super-steps (DESIGN.md §9). Member j of super-step
        si is global step si*world+j, so its dropout generator matches the
        single-device loop's step counter exactly. The loader groups with
        the SAME ``superstep_indices`` the executor uses, so ``groups[si]``
        names super-step si's batches and its (backend, block_f) closures
        (§14). Returns params, optimizer state, and the loss sum and count
        over the real members."""
        groups = executor.supersteps(order)
        loader = PrefetchLoader(host, order, group=executor.world,
                                device=executor.mesh)
        ep_loss, nsteps = 0.0, 0
        for si, (batch, w) in enumerate(loader):
            fns = executor.steps_for(*gnn_policy.superstep_decision(
                decisions, groups[si][0]))
            gens = [step_generator(base, ep, si * executor.world + j, d)
                    for j, d in enumerate(executor.devices)]
            params, opt_state, losses = fns.train(
                params, replicas, opt_state, batch, w, self.sched.lr, gens)
            for loss, wj in zip(losses, w):
                if wj > 0:                      # real members only
                    ep_loss += float(loss)
                    nsteps += 1
        return params, opt_state, ep_loss, nsteps

    def fit(self,
            train_batches,                    # Plan | List[PaddedBatch] | Batcher
            val_batches,                      # Plan | List[PaddedBatch]
            num_classes: int,
            epochs: int = 100,
            schedule_mode: str = "tsp",
            eval_every: int = 1,
            verbose: bool = False,
            preprocess_time: float = 0.0,
            rng: Optional[int] = None,
            mesh=None) -> TrainResult:
        """Train on precomputed batches (or a resampling batcher from
        ``repro_torch.graph.sampling``). ``rng`` is the integer base seed of
        initialisation and dropout (``self.seed`` when None). With a
        ``mesh`` (a ``repro_torch.dist.data_parallel.DataMesh``) the Plan
        runs data-parallel through ``ShardedPlanExecutor`` (DESIGN.md §9):
        params replicate, each mesh entry takes one batch per super-step,
        and the gradients are averaged — bitwise the single-device fit with
        ``grad_accum = mesh_world(mesh)`` on the same device."""
        base = self.seed if rng is None else int(rng)
        # init from domain 0; dropout seeds live in domain 1 keyed by
        # (epoch, step) — see `step_rng` for why the split is stateless.
        params = self.init_params(base)
        opt_state = self.opt.init(params)
        accum = GradAccumulator(self.grad_accum)

        if isinstance(train_batches, Plan) and not preprocess_time:
            # amortization accounting rides along in the artifact
            m = train_batches.meta
            preprocess_time = train_batches.timings.get(
                f"preprocess/{m.get('split')}/{m.get('mode')}", 0.0)
        fixed = isinstance(train_batches, (Plan, BatchCache, list, tuple))
        if not fixed and self.cfg.kind != "gat" \
                and gnn_ops.resolve_backend(self.cfg.backend) == "bcsr":
            # fail with the batcher's name up front, not with a generic
            # missing-tiles error from deep inside the first epoch
            name = getattr(train_batches, "name",
                           type(train_batches).__name__)
            raise ValueError(
                f"backend='bcsr' needs batches with precomputed BCSR tiles, "
                f"but batcher {name!r} (graph/sampling.py) regenerates "
                f"batches per epoch without tiles. Train from an "
                f"IBMBPipeline plan built with IBMBConfig(backend='bcsr'), "
                f"or use backend='segment' for this batcher (DESIGN.md §7).")
        if fixed:
            host = as_host_batches(train_batches)
            labels = _batch_labels(train_batches)
            order_fn = lambda ep: make_schedule(
                labels, num_classes, mode=schedule_mode, seed=self.seed + ep)
            # (backend, block_f) per batch — the plan's stored autotuner
            # decisions under an auto policy, uniform otherwise (§14)
            decisions = gnn_policy.batch_decisions(
                train_batches, self.policy, self.cfg)
        val_host = as_host_batches(val_batches)
        # fail fast if the batches lack the tiles the configured backend
        # needs (DESIGN.md §7); an auto policy validates by tile presence
        vb = "auto" if self.policy.is_auto else self.cfg.backend
        for sample in ([host[0]] if fixed else []) + [val_host[0]]:
            gnn_ops.validate_batch_for_backend(sample, vb, self.cfg.kind)

        executor = replicas = val_decisions = None
        if mesh is not None:
            if not fixed:
                raise ValueError(
                    "mesh execution needs precomputed fixed batches (a "
                    "Plan/BatchCache/list) — resampling batchers regenerate "
                    "per epoch and cannot be staged as super-steps")
            if self.grad_accum != 1:
                raise ValueError(
                    "mesh=... already averages gradients over each "
                    "super-step (DESIGN.md §9); combining it with "
                    "grad_accum is not supported")
            if self.nonfinite_policy != "off":
                raise ValueError(
                    "nonfinite_policy guards the single-device loop only; "
                    "the mesh super-step path is unguarded (DESIGN.md §12) "
                    "— use nonfinite_policy='off' with mesh=...")
            from repro_torch.dist.data_parallel import ShardedPlanExecutor
            executor = ShardedPlanExecutor(mesh, self.cfg, self.opt,
                                           backend=self.policy)
            # the master copy and its optimizer state on the mesh's first
            # device; one replica per member
            params = executor.place(params)
            opt_state = executor.place(opt_state)
            replicas = executor.replicate(params)
            # the val plan's stored decisions, read before the cache
            # normalization drops them (§14)
            val_decisions = executor.decisions(val_batches)

        history: List[Dict] = []
        best_val_loss, best_val_acc, best_epoch = float("inf"), 0.0, -1
        best_params = params
        bad = 0
        epoch_times = []
        t_total0 = time.time()
        apply_step = self._steps_for(self.cfg.backend, int(getattr(
            self.cfg, "bcsr_block_f", 0)))["apply"]

        for ep in range(epochs):
            t0 = time.time()
            if not fixed:  # resampling baselines pay regeneration every epoch
                epoch_pb = train_batches.epoch_batches(ep)
                host = as_host_batches(epoch_pb)
                order = np.random.default_rng(self.seed + ep).permutation(
                    len(host))
                decisions = gnn_policy.batch_decisions(
                    epoch_pb, self.policy, self.cfg)
            else:
                order = order_fn(ep)
            if executor is not None:
                params, opt_state, ep_loss, nsteps = self._mesh_epoch(
                    executor, host, order, decisions, params, replicas,
                    opt_state, base, ep)
            else:
                ep_loss = 0.0
                nsteps = 0
                loader = PrefetchLoader(host, order, device=self.device)
                for bi, batch in enumerate(loader):
                    # loader position bi holds batch order[bi]; its stored
                    # decision picks the step set (uniform when fixed)
                    steps = self._steps_for(*decisions[int(order[bi])])
                    gen = step_generator(base, ep, bi, self.device)
                    lr = self.sched.lr
                    if self.grad_accum == 1:
                        if self.nonfinite_policy == "off":
                            params, opt_state, loss = steps["train"](
                                params, opt_state, batch, lr, gen)
                        else:
                            params, opt_state, loss, ok = steps["guarded"](
                                params, opt_state, batch, lr, gen)
                            if not ok:
                                self._on_nonfinite(ep, bi)
                                continue   # loss is poisoned; update held
                    else:
                        loss, grads = steps["grad"](params, batch, gen)
                        if self.nonfinite_policy != "off" and \
                                not _tree_finite(loss, grads):
                            # never let a NaN enter the accumulator: one bad
                            # micro-batch would poison the whole macro-step
                            self._on_nonfinite(ep, bi)
                            continue
                        g = accum.add(grads)
                        if g is not None:
                            params, opt_state = apply_step(
                                params, opt_state, g, lr)
                    ep_loss += float(loss)
                    nsteps += 1
                if self.grad_accum > 1:
                    g = accum.flush()
                    if g is not None:
                        params, opt_state = apply_step(params, opt_state, g,
                                                       self.sched.lr)
            epoch_times.append(time.time() - t0)

            if (ep + 1) % eval_every == 0:
                val = executor.evaluate(replicas, val_host,
                                        decisions=val_decisions) \
                    if executor is not None \
                    else self.evaluate(params, val_batches)
                self.sched.step(val["loss"])
                history.append({"epoch": ep,
                                "train_loss": ep_loss / max(nsteps, 1),
                                "val_loss": val["loss"], "val_acc": val["acc"],
                                "lr": self.sched.lr,
                                "time": time.time() - t_total0})
                if verbose:
                    print(f"  ep {ep:4d} loss {ep_loss/max(nsteps,1):.4f} "
                          f"val_loss {val['loss']:.4f} val_acc "
                          f"{val['acc']:.4f} lr {self.sched.lr:.2e}")
                if val["loss"] < best_val_loss - 1e-6:
                    best_val_loss, best_val_acc, best_epoch = \
                        val["loss"], val["acc"], ep
                    best_params = tree_map(lambda x: x.clone(), params)
                    bad = 0
                else:
                    bad += 1
                    if bad >= self.early_stop_patience:
                        break
        return TrainResult(
            params=best_params, history=history, best_val_acc=best_val_acc,
            best_epoch=best_epoch,
            time_per_epoch=float(np.mean(epoch_times)) if epoch_times else 0.0,
            preprocess_time=preprocess_time, total_time=time.time() - t_total0)
