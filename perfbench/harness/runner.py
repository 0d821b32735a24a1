"""Run one cell once: set up, measure the window, check what the window
produced against the reference, and build the result line.

Two kinds of traffic, named by a mix's ``kind``:

* ``train`` — ``GNNTrainer.fit`` on the training Plan for whole epochs
  (TSP order, staging, the SpMM kernel forward and backward, Adam).
  Set-up runs one warm epoch; the window runs as many epochs as fill the
  run's seconds, at least one. ``fit`` is handed the training Plan as its
  validation Plan with ``eval_every`` past the last epoch, so no
  validation runs.
* ``infer`` — passes over every test output through
  ``GNNInferenceEngine.run``, each pass requests of ``request_size`` ids
  in a seeded order, so every pass runs every batch.

``--seed`` draws the weights (the trainer's seed for ``train``), the
dropout masks and epoch orders (through the trainer's seed) and the
requests. The graph and the Plan are the configuration's.

Beside the result, ``host`` records per run what explains its spread:
the bytes the window staged and their rate, a fixed host-to-device copy
timed from pageable and from pinned memory, and the host's least
available memory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import resource
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.harness import check, data, plan_ref, reference, roofline
from perfbench.harness import trace as tracemod
from perfbench.harness.cell import Cell, kind_of, load_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared by whole names (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error, with seconds since import."""
    print(f"perfbench +{time.perf_counter() - _T0:.1f}s {msg}",
          file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The measured window: host seconds, and with ``traced`` a profile of
    it under the span ``trace.WINDOW``."""

    def __init__(self, device: torch.device, traced: bool):
        self.device, self.traced = device, traced
        self.prof = None
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> "Window":
        _sync(self.device)
        if self.traced:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = self._stack.enter_context(profile(activities=acts))
            self._stack.enter_context(record_function(tracemod.WINDOW))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _sync(self.device)
        self.t1 = time.perf_counter()
        self._stack.close()

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def summary(self) -> Optional[Dict]:
        if self.prof is None:
            return None
        return tracemod.summarize(*tracemod.from_profile(self.prof))


# ----------------------------------------------------------------- the port
def gnn_config(model: dict):
    """The program's ``GNNConfig``: the widths, depth, dropout, dtype and
    backend every kind shares, and the kind's own keywords."""
    from repro_torch.models.gnn.models import GNNConfig
    return GNNConfig(in_dim=model["in_dim"], hidden=model["hidden"],
                     out_dim=model["out_dim"], num_layers=model["num_layers"],
                     dropout=model["dropout"], dtype=model["dtype"],
                     backend=model["backend"],
                     **kind_of(model).program_kwargs(model))


def as_dataset(name: str, g: data.Graph):
    """The benchmark's graph as the program's ``GraphDataset``."""
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.datasets import GraphDataset
    raw = CSRGraph(g.indptr, g.indices, np.ones(len(g.indices), np.float32))
    norm = CSRGraph(g.n_indptr, g.n_indices, g.n_weights)
    return GraphDataset(name, raw, norm, g.features, g.labels,
                        dict(g.splits))


def build_plan(ds, ibmb: dict, split: str, for_inference: bool):
    from repro_torch.core.pipeline import IBMBConfig, IBMBPipeline
    return IBMBPipeline(ds, IBMBConfig(**ibmb)).plan(
        split, for_inference=for_inference)


@dataclasses.dataclass
class PlanInfo:
    """What the checks and the host record need of a Plan, kept after the
    Plan itself is freed."""
    nodes: np.ndarray                 # (B, max_nodes) global ids, -1 pad
    outputs: List[np.ndarray]         # each batch's output ids
    batch_bytes: int                  # the host arrays staged per pass
    timings: Dict[str, float]


def plan_info(plan) -> PlanInfo:
    f = plan.cache.fields
    nodes = np.asarray(plan.node_ids)
    om = f["output_mask"] > 0
    outputs = [nodes[b][f["output_idx"][b][om[b]]] for b in range(len(nodes))]
    return PlanInfo(nodes, outputs, int(plan.cache.nbytes()),
                    dict(plan.timings))


def window_costs(graph: data.Graph, batches, model: dict, train: bool,
                 units: int) -> Dict:
    """The SpMM calls, their least time and the model operations of
    ``units`` runs over every batch, counted from the reference's batches
    and the normalised graph's edges among their nodes."""
    per = roofline.spmm_calls(model, train)
    bound = flops = 0.0
    for b in batches:
        src, dst, _ = plan_ref.induced_edges(graph.n_indptr, graph.n_indices,
                                             graph.n_weights, b.nodes)
        t = roofline.spmm_needs(src, dst)
        bound += roofline.batch_bound_s(t, model, train)
        flops += roofline.model_flops(model, len(b.nodes), t.nnz, train)
    return {"spmm_calls": units * len(per) * len(batches),
            "spmm_bound_s": units * bound, "model_flops": units * flops}


def make_params(model: dict, seed: int, device: torch.device) -> Dict:
    """Serving weights from the seed, in the program's layout, drawn on
    the device: each layer's as its kind draws them (``serve_layer``), and
    small random LayerNorm affines on the hidden layers."""
    gen = torch.Generator(device=device).manual_seed(
        reference.derive_seed(seed, 7))
    kind, dims = kind_of(model), reference.layer_dims(model)
    L = model["num_layers"]

    def uni(shape, lim):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * lim

    def nrm(n, mean, std):
        return mean + std * torch.randn((n,), generator=gen, device=device)

    layers = []
    for l in range(L):
        layer = kind.serve_layer(model, dims[l], dims[l + 1], l == L - 1,
                                 uni, nrm)
        if l < L - 1:
            layer["ln_scale"] = nrm(dims[l + 1], 1.0, 0.1)
            layer["ln_bias"] = nrm(dims[l + 1], 0.0, 0.1)
        layers.append(layer)
    return {"layers": layers}


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------------- train
class _Recorder:
    """Wraps the trainer's optimizer and its loss: once armed, keeps the
    first ``n`` steps' losses, the first step's gradient as the optimizer
    gets it, and the parameters before the first step and after the
    ``n``-th (as step ``n + 1`` receives them); counts every update."""

    def __init__(self, opt, loss_fn, n: int):
        self.n, self.armed, self.count = n, False, 0
        self.losses: List[torch.Tensor] = []
        self.p0 = self.grad1 = self.p_after = None
        self._update, self._loss = opt.update, loss_fn
        self.opt = dataclasses.replace(opt, update=self.update)

    @staticmethod
    def _copy(tree) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone()
                for k, v in reference.flatten(tree).items()}

    def update(self, grads, state, params, lr):
        if self.armed:
            if self.count == 0:
                self.p0, self.grad1 = self._copy(params), self._copy(grads)
            if self.count == self.n:
                self.p_after = self._copy(params)
            self.count += 1
        return self._update(grads, state, params, lr)

    def loss(self, logits, labels, mask):
        out = self._loss(logits, labels, mask)
        if self.armed and len(self.losses) < self.n:
            self.losses.append(out.detach())
        return out


def run_train(cell: Cell, graph: data.Graph, seed: int, seconds: float,
              traced: bool, device: torch.device) -> Dict:
    import repro_torch.train.gnn_trainer as gt
    model, mix, conf = cell.config["model"], cell.mix, cell.config
    ds = as_dataset(cell.config_name, graph)
    log("plan build")
    plan = build_plan(ds, conf["ibmb"], "train", False)
    log(f"plan built: {plan.timings}")
    num_classes = graph.num_classes
    trainer = gt.GNNTrainer(gnn_config(model), optimizer=conf["train"][
        "optimizer"], lr=conf["train"]["lr"], seed=seed,
        backend=model["backend"], device=device)
    rec = _Recorder(trainer.opt, gt.masked_xent, mix["check_steps"])
    trainer.opt = rec.opt

    def fit(epochs: int):
        return trainer.fit(plan, plan, num_classes, epochs=epochs,
                           eval_every=epochs + 1,
                           schedule_mode=mix["schedule"])

    with _patched(gt, "masked_xent", rec.loss):
        t = time.perf_counter()
        fit(1)
        _sync(device)
        warm = time.perf_counter() - t
        epochs = max(1, int(round(seconds / warm)))
        log(f"warm epoch {warm:.3f}s; window of {epochs} epoch(s)")
        rec.armed = True
        with Window(device, traced) as win:
            fit(epochs)
    info = plan_info(plan)
    mem = _peak(device)
    steps = epochs * len(info.outputs)
    out = dict(attempted=steps, failed=steps - rec.count,
               window_s=win.seconds, window_t0=win.t0, memory_peak_bytes=mem,
               staged_bytes=epochs * info.batch_bytes,
               e2e={"train_nodes_per_s":
                    epochs * sum(len(o) for o in info.outputs) / win.seconds},
               ctx=dict(trace=win.summary(), plan_timings=info.timings))
    prog = dict(losses=[float(x) for x in rec.losses], p0=rec.p0,
                grad1=rec.grad1, p_after=rec.p_after)
    del plan, trainer, rec
    _free(device)
    log(f"window {win.seconds:.3f}s; reference")
    batches = plan_ref.reference_batches(graph, conf["ibmb"], "train", False)
    if traced:
        out["ctx"].update(window_costs(graph, batches, model, True, epochs))
    out["numbers"] = train_check(cell, graph, seed, info, prog, device,
                                 batches)
    log("reference done")
    return out


def train_reference(cell: Cell, graph: data.Graph, seed: int, device,
                    tf32: bool = False, batches=None,
                    dtype=torch.float32) -> Dict:
    """The reference's own batches and first training steps of a trainer
    seeded with ``seed``: its batches, the checked steps' batches and
    their local orders, its initial parameters, losses, first gradient and
    parameters after the checked steps."""
    model, conf, n = cell.config["model"], cell.config, cell.mix["check_steps"]
    ibmb = conf["ibmb"]
    if batches is None:
        batches = plan_ref.reference_batches(graph, ibmb, "train", False)
    order = plan_ref.tsp_order([graph.labels[b.outputs] for b in batches],
                               graph.num_classes, seed)
    steps = [int(b) for b in order[:n]]
    ordered = {b: plan_ref.local_order(graph, batches[b]) for b in steps}
    pad = ibmb["pad_multiple"]
    mn = pad * math.ceil(max(len(b.nodes) for b in batches) / pad)
    masks = []
    for i, b in enumerate(steps):
        gen = torch.Generator(device=device).manual_seed(
            reference.derive_seed(seed, 1, 0, i))
        masks.append([(torch.rand((mn, model["hidden"]), generator=gen,
                                  device=device) < 1.0 - model["dropout"])
                      [:len(ordered[b])]
                      for _ in range(model["num_layers"] - 1)])
    init = reference.trainer_init(model, seed, device)
    losses, grad1, p_after = reference.train_steps(
        model, graph, [(batches[b].outputs, ordered[b]) for b in steps],
        init, masks, conf["train"]["lr"], device, tf32=tf32, dtype=dtype)
    return dict(batches=batches, ordered=ordered, init=init, losses=losses,
                grad1=grad1, p_after=p_after)


def train_check(cell, graph, seed, info: PlanInfo, prog: Dict, device,
                batches) -> Dict[str, float]:
    ref = train_reference(cell, graph, seed, device, batches=batches)
    if prog["p0"] is None or prog["p_after"] is None:
        nums = {k: float("inf") for k in (
            "loss1_gap", "init_gap", "grad_gap_last", "step_gap_median")}
    else:
        nums = check.train_numbers(prog, ref, ref["init"])
        log(f"leaves moved: {len(check.moved_leaves(ref['grad1']))} of "
            f"{len(ref['grad1'])}; not compared: "
            + ", ".join(f"{k} {nums[k]!r}" for k in (
                "loss_gap", "grad_gap", "step_gap")))
    nums["plan_wrong"] = float(check.plan_wrong(
        info.nodes, info.outputs, ref["batches"], ref["ordered"]))
    return nums


# ------------------------------------------------------------------- infer
def _engine(plan, model: dict, params, cache_batches: int, device):
    from repro_torch.serve.gnn_engine import GNNInferenceEngine
    return GNNInferenceEngine(plan, gnn_config(model), params,
                              backend=model["backend"],
                              cache_batches=cache_batches, device=device)


def run_infer(cell: Cell, graph: data.Graph, seed: int, seconds: float,
              traced: bool, device: torch.device) -> Dict:
    from repro_torch.serve.gnn_engine import GNNRequest
    model, mix = cell.config["model"], cell.mix
    ds = as_dataset(cell.config_name, graph)
    log("plan build")
    plan = build_plan(ds, cell.config["ibmb"], "test", True)
    log(f"plan built: {plan.timings}")
    params = make_params(model, seed, device)
    eng = _engine(plan, model, params, mix["cache_batches"], device)
    test = graph.splits["test"]
    rng = np.random.default_rng([seed, 1])
    size = mix["request_size"]

    def one_pass(order):
        reqs = [GNNRequest(order[i:i + size])
                for i in range(0, len(order), size)]
        eng.run(reqs)
        return reqs

    t = time.perf_counter()
    one_pass(rng.permutation(test))
    _sync(device)
    warm = time.perf_counter() - t
    passes = max(1, int(round(seconds / warm)))
    log(f"warm pass {warm:.3f}s; window of {passes} pass(es)")
    orders = [rng.permutation(test) for _ in range(passes)]
    answered = []
    with Window(device, traced) as win:
        for order in orders:
            answered.append(one_pass(order))
    info = plan_info(plan)
    mem = _peak(device)
    reqs = [r for a in answered for r in a]
    failed = sum(1 for r in reqs if not r.done or r.error
                 or r.logits is None or len(r.logits) != len(r.node_ids))
    out = dict(attempted=len(reqs), failed=failed, window_s=win.seconds,
               window_t0=win.t0, memory_peak_bytes=mem,
               staged_bytes=passes * info.batch_bytes,
               e2e={"infer_nodes_per_s": passes * len(test) / win.seconds},
               ctx=dict(trace=win.summary(), plan_timings=info.timings))
    ok = [r for r in reqs if r.done and r.logits is not None
          and len(r.logits) == len(r.node_ids)]
    answers = (np.concatenate([np.asarray(r.node_ids) for r in ok]),
               np.concatenate([r.logits for r in ok])) if ok else None
    del plan, eng, answered, reqs
    _free(device)
    log(f"window {win.seconds:.3f}s; reference")
    batches = plan_ref.reference_batches(graph, cell.config["ibmb"], "test",
                                         True)
    if traced:
        out["ctx"].update(window_costs(graph, batches, model, False, passes))
    nums = answers_check(cell, graph, info, params, answers, device, batches)
    log("reference done")
    nums["unanswered"] = float(failed)
    out["numbers"] = nums
    return out


def answers_check(cell, graph, info: PlanInfo, params, answers, device,
                  batches=None) -> Dict[str, float]:
    """Every answer the program gave against the reference's logits of its
    node. ``answers`` is (node ids, logit rows), a node as often as it was
    answered; the reference runs each batch of its own partition that
    holds an answered node once."""
    model = cell.config["model"]
    if batches is None:
        batches = plan_ref.reference_batches(graph, cell.config["ibmb"],
                                             "test", True)
    plan = float(check.plan_wrong(info.nodes, info.outputs, batches, {}))
    if answers is None:
        return {"logit_gap": float("inf"), "plan_wrong": plan}
    ids, rows = answers
    owner = np.full(graph.num_nodes, -1, np.int64)
    for i, b in enumerate(batches):
        owner[b.outputs] = i
    uniq = np.unique(ids)
    if (owner[uniq] < 0).any():
        return {"logit_gap": float("inf"), "plan_wrong": plan}
    want = np.zeros((graph.num_nodes, rows.shape[1]), np.float32)
    ref_params = reference.flatten(params)
    for b in np.unique(owner[uniq]):
        us = uniq[owner[uniq] == b]
        want[us] = reference.batch_logits(model, graph, ref_params,
                                          batches[b].nodes, us, device)
    return {"logit_gap": check.logit_gap(rows, want[ids]), "plan_wrong": plan}


RUNS = {"train": run_train, "infer": run_infer}


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


class MemWatch:
    """The host's least available memory (``MemAvailable`` of
    ``/proc/meminfo``) while it runs, sampled from a thread."""

    def __init__(self, every_s: float = 0.25):
        self.least: Optional[int] = None
        self._every = every_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    @staticmethod
    def available() -> Optional[int]:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        return int(line.split()[1]) * 1024
        except OSError:
            pass
        return None

    def _watch(self) -> None:
        while True:
            a = self.available()
            if a is not None and (self.least is None or a < self.least):
                self.least = a
            if self._stop.wait(self._every):
                return

    def __enter__(self) -> "MemWatch":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()


def _copy_gbps(src: torch.Tensor, device: torch.device, reps: int = 3
               ) -> float:
    """GB/s of copying ``src`` to the device, the median of ``reps``."""
    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize(device)
        ts.append(time.perf_counter() - t)
    return src.numel() * src.element_size() / sorted(ts)[reps // 2] / 1e9


def copy_probe(device: torch.device, nbytes: int = 1 << 30
               ) -> Dict[str, float]:
    """GB/s of one fixed host-to-device copy of ``nbytes`` from a fresh
    pageable and a fresh pinned buffer: a witness of this process's copy
    speed beside the program's own staging."""
    if device.type != "cuda":
        return {}
    src = torch.ones(nbytes // 4, dtype=torch.float32)
    out = {"probe_pageable_gbps": _copy_gbps(src, device),
           "probe_pinned_gbps": _copy_gbps(src.pin_memory(), device)}
    del src
    _free(device)
    return out


# ------------------------------------------------------------------ a run
def mark_complete(ctx: Dict) -> bool:
    """In a traced run's context, set ``trace_complete``: whether the
    trace holds exactly as many SpMM kernels as the window made calls (0
    for a kind that makes none). Returns whether it was set."""
    tr = ctx.get("trace")
    if tr is None or "spmm_calls" not in ctx:
        return False
    ctx["trace_complete"] = tr["spmm_calls"] == ctx["spmm_calls"]
    return True


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float) -> Dict:
    """One run of ``cell``: the result line's object, ``checks`` last.
    ``t_start`` (``time.perf_counter``) is when the process began; set-up
    is everything from then until the window opens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(seed) & (2 ** 63 - 1)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros((), device=device)
        torch.cuda.reset_peak_memory_stats(device)
    with MemWatch() as mem:
        graph = data.load_graph(cell.config["dataset"])
        log(f"graph: {graph.num_nodes} nodes")
        res = RUNS[cell.mix["kind"]](cell, graph, seed, seconds, traced,
                                     device)
    probe = copy_probe(device)
    ctx = res["ctx"]
    tr = ctx.get("trace")
    if mark_complete(ctx):
        log(f"spmm calls: {tr['spmm_calls']} in the trace, "
            f"{ctx['spmm_calls']} made"
            + ("" if ctx["trace_complete"] else
               "; the trace is incomplete, its device metrics withheld"))
    numbers = res["numbers"]
    correct = check.verdict(numbers, cell.limits)
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(res["e2e"], setup_s=res["window_t0"] - t_start)
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else device.type,
           "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    log("result")
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    staged = res["staged_bytes"]
    out["host"] = {
        "window_s": res["window_s"],
        "setup_s": res["window_t0"] - t_start,
        "plan_build_s": sum(ctx["plan_timings"].values()),
        "plan_timings": ctx["plan_timings"],
        "rss_peak_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
        "mem_available_least_bytes": mem.least,
        "staged_bytes": staged,
        "staged_gbps": staged / res["window_s"] / 1e9,
        **probe}
    if ctx.get("trace_complete") and tr["htod_s"] > 0:
        out["host"]["htod_gbps"] = staged / tr["htod_s"] / 1e9
    out["checks"] = {k: {"value": numbers.get(k, float("inf")),
                         "limit": v} for k, v in cell.limits.items()}
    return out
