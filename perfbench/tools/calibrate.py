"""Readings for the limits of ``correct``, at a cell's own size, with one
set-up for many seeds.

    python3 perfbench/tools/calibrate.py --workload <cell> \
        --seeds 12 --controls 3 [--faults 3] [--first-seed N] [--witness]

For each seed, the program's timed path is compared with the reference
exactly as a run compares it (a training cell's first steps through
``GNNTrainer.fit``, stopped after the checked steps; an inference cell's
sampled batches through the engine's ``run``). The control is the
reference computed in TF32 put in the program's place; for a training
cell, ``--faults`` seeds also read the program with half of each batch
left out of the loss. One JSON line per reading on standard output.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.harness import (  # noqa: E402
    check, data, plan_ref, reference, runner)
from perfbench.harness.cell import load_cell  # noqa: E402


class _Stop(Exception):
    pass


def train_readings(cell, graph, seeds, controls, faults, device, emit,
                   witness=False):
    import repro_torch.train.gnn_trainer as gt
    conf, model, n = cell.config, cell.config["model"], cell.mix["check_steps"]
    plan = runner.build_plan(runner.as_dataset(cell.config_name, graph),
                             conf["ibmb"], "train", False)
    info = runner.plan_info(plan)

    def program(seed, loss_fn):
        trainer = gt.GNNTrainer(
            runner.gnn_config(model), optimizer=conf["train"]["optimizer"],
            lr=conf["train"]["lr"], seed=seed, backend=model["backend"],
            device=device)
        rec = runner._Recorder(trainer.opt, loss_fn, n)
        inner = rec.update

        def update(grads, state, params, lr):
            out = inner(grads, state, params, lr)
            if rec.count > n:
                raise _Stop
            return out

        trainer.opt = rec.opt = dataclasses.replace(rec.opt, update=update)
        rec.armed = True
        with runner._patched(gt, "masked_xent", rec.loss):
            try:
                trainer.fit(plan, plan, graph.num_classes, epochs=1,
                            eval_every=2, schedule_mode=cell.mix["schedule"])
            except _Stop:
                pass
        return dict(losses=[float(x) for x in rec.losses], p0=rec.p0,
                    grad1=rec.grad1, p_after=rec.p_after)

    _orig_xent = gt.masked_xent

    def half_batch(logits, labels, mask):
        """The fault: every other output row left out of the loss."""
        keep = torch.arange(mask.shape[0], device=mask.device) % 2 == 0
        return _orig_xent(logits, labels, mask * keep.to(mask.dtype))

    def as_prog(r):
        return dict(losses=r["losses"], p0=r["init"], grad1=r["grad1"],
                    p_after=r["p_after"])

    def numbers(prog, ref):
        nums = check.train_numbers(prog, ref, ref["init"])
        if witness:
            keep = check.moved_leaves(ref["grad1"])
            nums["grad_leaves"] = check.leaf_gaps(prog["grad1"], ref["grad1"])
            nums["step_leaves"] = check.leaf_gaps(
                {k: prog["p_after"][k] - prog["p0"][k] for k in keep},
                {k: ref["p_after"][k] - ref["init"][k] for k in keep}, keep)
        return nums

    def perturbed(draw):
        """The trainer's initial weights, each times 1 + 2**-23 N(0, 1)."""
        def init(model, seed, device):
            p = _init(model, seed, device)
            g = torch.Generator().manual_seed(draw)
            return {k: v * (1 + 2.0 ** -23 * torch.randn(
                v.shape, generator=g).to(device)) for k, v in p.items()}
        return init

    _init = reference.trainer_init
    batches = plan_ref.reference_batches(graph, conf["ibmb"], "train", False)
    for i, seed in enumerate(seeds):
        ref = runner.train_reference(cell, graph, seed, device,
                                     batches=batches)
        prog = program(seed, _orig_xent)
        nums = numbers(prog, ref)
        nums["plan_wrong"] = float(check.plan_wrong(
            info.nodes, info.outputs, ref["batches"], ref["ordered"]))
        emit("program", seed, nums)
        if witness:
            ref64 = runner.train_reference(cell, graph, seed, device,
                                           batches=batches,
                                           dtype=torch.float64)
            emit("float64_vs_ref", seed, numbers(as_prog(ref64), ref))
            emit("program_vs_float64", seed, numbers(prog, ref64))
            for d in range(2):
                with runner._patched(reference, "trainer_init",
                                     perturbed(d)):
                    ptb = runner.train_reference(cell, graph, seed, device,
                                                 batches=batches)
                emit(f"init_ulp_{d}_vs_ref", seed, numbers(as_prog(ptb), ref))
            if i == 0:
                again = program(seed, _orig_xent)
                emit("program_again", seed, {
                    k: max(float((again[k][n] - prog[k][n]).abs().max())
                           for n in prog[k]) for k in ("grad1", "p_after")})
        if i < controls:
            ctl = runner.train_reference(cell, graph, seed, device,
                                         tf32=True, batches=batches)
            emit("control_tf32", seed, numbers(as_prog(ctl), ref))
        if i < faults:
            emit("fault_half_batch", seed, numbers(
                program(seed, half_batch), ref))


def answer_readings(cell, graph, seeds, controls, device, emit, plan):
    from repro_torch.serve.gnn_engine import GNNRequest
    model = cell.config["model"]
    info = runner.plan_info(plan)
    test = graph.splits["test"]
    size = max(cell.mix["request_size"], 1024)
    batches = plan_ref.reference_batches(graph, cell.config["ibmb"], "test",
                                         True)
    for i, seed in enumerate(seeds):
        params = runner.make_params(model, seed, device)
        eng = runner._engine(plan, model, params, 0, device)
        order = np.random.default_rng([seed, 1]).permutation(test)
        reqs = [GNNRequest(order[j:j + size])
                for j in range(0, len(order), size)]
        eng.run(reqs)
        answers = (np.concatenate([r.node_ids for r in reqs]),
                   np.concatenate([r.logits for r in reqs]))
        nums = runner.answers_check(cell, graph, info, params, answers,
                                    device, batches=batches)
        emit("program", seed, nums)
        if i < controls:
            ctl = control_answers(cell, graph, params, device, batches)
            emit("control_tf32", seed, runner.answers_check(
                cell, graph, info, params, ctl, device, batches=batches))
        del eng


def control_answers(cell, graph, params, device, batches):
    """The TF32 reference's answers for every test node."""
    ids, rows = [], []
    for rb in batches:
        ids.append(rb.outputs)
        rows.append(reference.batch_logits(
            cell.config["model"], graph, reference.flatten(params), rb.nodes,
            rb.outputs, device, tf32=True))
    return np.concatenate(ids), np.concatenate(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, nargs="+",
                    help="cells; inference cells on one graph share a Plan")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_007)
    ap.add_argument("--witness", action="store_true",
                    help="training: also each leaf's gaps, the float64 "
                    "reference and the reference from initial weights "
                    "moved by an ulp, each against the float32 reference")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    t0 = time.perf_counter()
    plans = {}
    for name in args.workload:
        cell = load_cell(name, ROOT)
        graph = data.load_graph(cell.config["dataset"])

        def emit(what, seed, nums, cell=cell):
            print(json.dumps({"cell": cell.name, "reading": what,
                              "seed": seed,
                              "t": round(time.perf_counter() - t0, 1),
                              **nums}), flush=True)

        if cell.mix["kind"] == "train":
            train_readings(cell, graph, seeds, args.controls, args.faults,
                           device, emit, witness=args.witness)
            continue
        key = json.dumps([cell.config["dataset"], cell.config["ibmb"]],
                         sort_keys=True)
        if key not in plans:
            plans.clear()
            plans[key] = runner.build_plan(
                runner.as_dataset(cell.config_name, graph),
                cell.config["ibmb"], "test", True)
        answer_readings(cell, graph, seeds, args.controls, device, emit,
                        plans[key])
    return 0


if __name__ == "__main__":
    sys.exit(main())
