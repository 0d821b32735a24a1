"""Trace the GAT train step's card-vs-CPU differences to the kinks of its
activations, on a CUDA card.

    PYTHONPATH=src python3 tests/gat_kinks.py [--fits 4] [--batches 4]
        [--out chiprun_out/gat_kinks]

Builds chip_smoke's arxiv-like train and val Plans (bcsr), then for each of
``--fits`` 2-epoch fits of the paper's GAT (``configs/gnn_gat``, seeds 0,
1, ...) takes one train step at dropout 0 from the fit's parameters on
each of the first ``--batches`` train batches, on the card and on the CPU,
with every ``torch.relu`` and ``F.leaky_relu`` input recorded
(``tests/_kinks.py``). For each step it writes one JSON line to
``--out``/steps.jsonl, and prints those with a flip or an element outside
the tolerance: the elements of each gradient leaf outside ATOL = RTOL =
1e-4, the flipped pre-activations (which call, both values, how many ulps
from 0), the elements still outside after the CPU's step is recomputed
with the card's side of every flip, and, for a step with a flip or such
an element, the largest card-vs-CPU difference of the same step in
float64 (``tests/_f64.py``'s ``port_f64``). A step with elements outside
the tolerance is dumped to ``--out`` as an npz (the leaves on both
devices and forced, the failing indices, the flips) beside the parameters
it started from (``.params.pt``).
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

import _f64  # noqa: E402
import _kinks  # noqa: E402

ATOL = RTOL = 1e-4


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fits", type=int, default=4)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out/gat_kinks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gat_kinks: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)

    from repro_torch.configs import gnn_gat
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.device import stage
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.train import GNNTrainer

    ds = get_dataset("arxiv-like")
    pipe = IBMBPipeline(ds, IBMBConfig(variant="node", backend="bcsr"))
    train_plan = pipe.plan("train")
    val_plan = pipe.plan("val", for_inference=True)
    cfg = dataclasses.replace(gnn_gat.CONFIG, in_dim=ds.feat_dim,
                              out_dim=ds.num_classes)
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    names = None

    def grad(params, host, device, sides=None, f64=False):
        t = GNNTrainer(cfg0, backend="segment", device=device)
        p = tree_map(lambda x: x.to(device), params)
        with _kinks.kink_trace(sides) as tr:
            if f64:
                with _f64.port_f64():
                    loss, g = t._steps_for("segment", 0)["grad"](
                        p, stage(host, device), None)
            else:
                loss, g = t._steps_for("segment", 0)["grad"](
                    p, stage(host, device), None)
        return loss, [x.detach().cpu() for x in tree_leaves(g)], tr.inputs

    totals = dict(steps=0, failing_steps=0, flips=0, unexplained=0)
    log = open(os.path.join(args.out, "steps.jsonl"), "w")
    for seed in range(args.fits):
        t0 = time.perf_counter()
        res = GNNTrainer(cfg, optimizer="adam", lr=1e-3,
                         backend="segment").fit(
            train_plan, val_plan, ds.num_classes, epochs=2, rng=seed)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        if names is None:
            names = [f"layers.{i}.{k}" for i, layer in
                     enumerate(res.params["layers"]) for k in layer]
        for bi in range(min(args.batches, len(train_plan))):
            host = train_plan.cache[bi]
            lc, gc, xc = grad(res.params, host, "cuda")
            lp, gp, xp = grad(res.params, host, "cpu")
            fl = _kinks.flips(xc, xp)
            bad = {n: int((~torch.isclose(a, b, atol=ATOL, rtol=RTOL)).sum())
                   for n, a, b in zip(names, gc, gp)}
            bad = {n: v for n, v in bad.items() if v}
            rec = dict(seed=seed, batch=bi, fit_s=round(fit_s, 3),
                       loss_card=lc.item(), loss_cpu=lp.item(),
                       max_abs_err=max(float((a - b).abs().max())
                                       for a, b in zip(gc, gp)),
                       bad=bad, flips=[dict(call=c, idx=i, x_card=a, x_cpu=b,
                                            ulps=round(u, 2))
                                       for c, i, a, b, u in fl[:50]],
                       n_flips=len(fl))
            forced = None
            if fl:
                _, forced, _ = grad(res.params, host, "cpu",
                                    sides=_kinks.sides_of(xc))
                rec["forced_max_abs_err"] = max(
                    float((a - f).abs().max()) for a, f in zip(gc, forced))
                rec["flip_effect"] = max(
                    float((f - b).abs().max()) for f, b in zip(forced, gp))
                rec["forced_bad"] = {
                    n: int((~torch.isclose(a, f, atol=ATOL, rtol=RTOL)).sum())
                    for n, a, f in zip(names, gc, forced)}
            excused, worst, problems = _kinks.kink_witness(
                gc, gp, forced, ATOL, RTOL, names, len(fl))
            problems += _kinks.flip_problems(fl)
            rec.update(excused=excused, excused_worst=worst,
                       problems=problems)
            if bad or fl or (seed == 0 and bi == 0):
                _, g64c, x64c = grad(res.params, host, "cuda", f64=True)
                _, g64p, x64p = grad(res.params, host, "cpu", f64=True)
                rec["f64_card_vs_cpu"] = max(float((a - b).abs().max())
                                             for a, b in zip(g64c, g64p))
                rec["f32_card_vs_f64"] = max(float((a - b).abs().max())
                                             for a, b in zip(gc, g64p))
                rec["f32_cpu_vs_f64"] = max(float((a - b).abs().max())
                                            for a, b in zip(gp, g64p))
                rec["f64_flips"] = len(_kinks.flips(x64c, x64p))
            if bad:
                dump = {f"card/{n}": a.numpy() for n, a in zip(names, gc)}
                dump.update({f"cpu/{n}": b.numpy() for n, b in zip(names, gp)})
                if forced is not None:
                    dump.update({f"forced/{n}": f.numpy()
                                 for n, f in zip(names, forced)})
                for n, a, b in zip(names, gc, gp):
                    if n in bad:
                        dump[f"bad/{n}"] = torch.nonzero(~torch.isclose(
                            a, b, atol=ATOL, rtol=RTOL)).numpy()
                dump["flips"] = np.array([(c, *i, a, b, u) for
                                          c, i, a, b, u in fl], np.float64)
                np.savez(os.path.join(args.out, f"seed{seed}_batch{bi}.npz"),
                         **dump)
                torch.save(tree_map(lambda t: t.cpu(), res.params),
                           os.path.join(args.out,
                                        f"seed{seed}_batch{bi}.params.pt"))
            totals["steps"] += 1
            totals["failing_steps"] += bool(bad)
            totals["flips"] += len(fl)
            totals["unexplained"] += len(problems)
            log.write(json.dumps(rec) + "\n")
            log.flush()
            if bad or fl:
                print(json.dumps(rec), flush=True)
    log.close()
    print(json.dumps(dict(totals=totals)), flush=True)


if __name__ == "__main__":
    main()
