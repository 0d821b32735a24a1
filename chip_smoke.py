#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(the kernels target ``sm_90a``, i.e. Hopper). Phases, each fatal:

1. device   — require CUDA, print the card's name and power limit, TF32 off.
2. build    — compile every kernel source of the port from the checkout,
              one ``nvcc`` per source, all started together.
3. kernels-random — both block-CSR SpMM kernels, forward and backward
              (through ``spmm_bcsr_sym``), and the row gather (f32 and bf16,
              rows that do and do not take 16-byte vectors, ids outside the
              table) against their plain PyTorch versions on random cases.
4. plan     — the arxiv-like train, val and test Plans for the bcsr backend.
5. kernels-real — each kernel on the main path's real inputs, with its
              time beside the bound, the plain version and a library call.
6. train    — the main path: ``GNNTrainer.fit`` of the paper's ogbn GCN
              (hidden 256, 3 layers, dropout 0.3, Adam) for 2 epochs on the
              train Plan under ``backend="bcsr"``; exact SpMM launch count,
              finite losses, parameters moved, one train step on the card
              against the same step on the CPU, and one step's device time
              split by ``torch.profiler``.
7. entry-points — the unfused SpMM (forward and backward over every train
              batch) and the row gather (every train batch's features from
              the feature table) through their own entry points.
8. serve    — ``GNNInferenceEngine`` on the test Plan under
              ``backend="bcsr"``, then ``backend="auto"``.
9. attention-yardstick — ``scaled_dot_product_attention`` at the
              llama3.2-1b prefill shape and its bound: the TPU flash
              attention kernel is not ported yet; this is its yardstick.

The second-to-last line is a JSON ``kernels`` record and the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# f32 throughout with TF32 off: the kernels and the plain versions differ
# only in summation order, a few ulps per output over at most B·K terms;
# the same slack holds for the serving logits and for one train step's loss
# and gradients (CUDA against the CPU) through three layers and two
# LayerNorms. The row gather is a copy: it must match bit for bit, in f32
# and in bf16 alike (tolerance 0).
ATOL = RTOL = 1e-4

# published peaks (NVIDIA data sheets, dense, at the full power limit):
# f32 CUDA-core FLOP/s, bf16 tensor-core FLOP/s and device-memory bytes/s,
# by the name nvidia-smi gives
PEAKS = (("H100 PCIe", 51e12, 756e12, 2.0e12),
         ("H100 NVL", 60e12, 835e12, 3.9e12),
         ("H200", 67e12, 989e12, 4.8e12), ("H100", 67e12, 989e12, 3.35e12))

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "spmm_bcsr": ("src/repro_torch/kernels/csrc/spmm_bcsr.cu",
                  "src/repro/kernels/spmm/fused.py:96"),
    "spmm_bcsr_unfused": ("src/repro_torch/kernels/csrc/spmm_bcsr_unfused.cu",
                          "src/repro/kernels/spmm/spmm.py:37"),
    "gather_rows": ("src/repro_torch/kernels/csrc/gather_rows.cu",
                    "src/repro/kernels/gather_rows/gather_rows.py:29"),
}
SPMM_IMPLS = {"spmm_bcsr": "cuda", "spmm_bcsr_unfused": "cuda_unfused"}

# ogbn-products' node features: 2,449,029 nodes × 100 f32
PRODUCTS_NODES, PRODUCTS_FEATURES, GATHER_IDS = 2_449_029, 100, 1 << 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    try:
        yield
    except BaseException:
        traceback.print_exc()
        fail(f"phase {name} failed")
    print(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def peaks_for(name: str):
    for key, f32, bf16, bw in PEAKS:
        if key in name:
            return f32, bf16, bw
    fail(f"no published peaks for card {name!r}")


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    one warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def spmm_bound_ms(cols, vals, x, peak_flops, peak_bw):
    """Least time for one call on these inputs: every input read once and
    the output written once, against the f32 operations the data needs —
    one B×B by B×F product per tile that holds a nonzero."""
    r, k, b, _ = vals.shape
    f = x.shape[1]
    nz_tiles = int((vals != 0).any(dim=3).any(dim=2).sum())
    nbytes = (cols.numel() * 4 + vals.numel() * 4 + x.numel() * 4
              + r * b * f * 4)
    flops = 2.0 * nz_tiles * b * b * f
    t_bytes, t_ops = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nz_tiles, flops, nbytes)


def gather_bound_ms(torch, table, idx, peak_bw):
    """Least time for one gather: every distinct row the ids name read
    once, the ids read once, the output written once (no arithmetic)."""
    row = table.shape[1] * table.element_size()
    distinct = int(torch.unique(idx).numel())
    nbytes = distinct * row + idx.numel() * 4 + idx.numel() * row
    return nbytes / peak_bw * 1e3, distinct, nbytes


def bsr_of(torch, cols, vals, n_cols):
    """The nonzero tiles as one ``torch.sparse_bsr_tensor`` (the library
    yardstick; the port never calls it)."""
    r, _, b, _ = vals.shape
    nz = (vals != 0).any(dim=3).any(dim=2)
    crow = torch.zeros(r + 1, dtype=torch.int32, device=vals.device)
    crow[1:] = nz.sum(dim=1).cumsum(0)
    with torch.sparse.check_sparse_tensor_invariants(False):
        return torch.sparse_bsr_tensor(
            crow, cols[nz].to(torch.int32), vals[nz].contiguous(),
            size=(r * b, n_cols))


def device_time_split(prof, torch):
    """A profile's device time (µs) by kind: host→device copies (staging),
    the SpMM kernel, and everything else."""
    from torch.autograd import DeviceType
    split = {"staging": 0.0, "spmm_kernel": 0.0, "rest": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if "Memcpy HtoD" in e.key:
            split["staging"] += us
        elif "spmm_bcsr" in e.key:
            split["spmm_kernel"] += us
        else:
            split["rest"] += us
    return split


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from the root of a checkout")
    sys.path.insert(0, SRC)
    import numpy as np
    import scipy.sparse as sp
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout
        card = smi.strip().splitlines()[0]
        print(card, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
        peak_flops, peak_bf16, peak_bw = peaks_for(kind)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"card {kind!r} peaks f32 {peak_flops / 1e12:g} TFLOP/s, bf16 "
              f"{peak_bf16 / 1e12:g} TFLOP/s, {peak_bw / 1e12:g} TB/s",
              flush=True)

    from repro_torch.kernels import build
    from repro_torch.kernels.gather_rows import gather_rows, gather_rows_ref
    from repro_torch.kernels.spmm import (
        csr_to_bcsr, spmm_bcsr, spmm_bcsr_ref, spmm_bcsr_stream,
        spmm_bcsr_sym)

    with phase("build"):
        t0 = time.perf_counter()
        paths = build.build_all()
        for src, path in paths.items():
            build.load_library(src)
            print(f"{src} -> {path}", flush=True)
        print(f"built {len(paths)} sources in parallel in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    max_err = {name: 0.0 for name in KERNELS}
    record = {}

    def note(name, err, label, ok):
        max_err[name] = max(max_err[name], err)
        print(f"{name} {label}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({label})")

    def check_spmm(cols, vals, x, label, backward=True):
        for name, impl in SPMM_IMPLS.items():
            got = spmm_bcsr(cols, vals, x, impl=impl)
            want = spmm_bcsr_ref(cols, vals, x)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item() if got.numel() else 0.0
            note(name, err, label, bool(torch.allclose(
                got, want, atol=ATOL, rtol=RTOL) and torch.isfinite(
                    got).all()))
            if not backward:
                continue
            xg = x.clone().requires_grad_(True)
            g = torch.randn(got.shape, device=dev,
                            generator=torch.Generator(dev).manual_seed(7))
            spmm_bcsr_sym(cols, vals, xg, impl=impl).backward(g)
            want = spmm_bcsr_ref(cols, vals, g)
            torch.cuda.synchronize()
            err = (xg.grad - want).abs().max().item()
            note(name, err, label + " backward", bool(torch.allclose(
                xg.grad, want, atol=ATOL, rtol=RTOL)))

    def check_gather(table, idx, label):
        got = gather_rows(table, idx)
        ok = (idx >= 0) & (idx < table.shape[0])
        want = gather_rows_ref(table, idx[ok])
        torch.cuda.synchronize()
        exact = bool(torch.equal(got[ok], want)) and \
            not bool((got[~ok] != 0).any())
        err = (got[ok].float() - want.float()).abs().max().item() \
            if want.numel() else 0.0
        note("gather_rows", err, f"{label} ({int((~ok).sum())} ids outside "
             f"the table, zero rows)", exact)

    with phase("kernels-random"):
        rng = np.random.default_rng(0)
        for b in (1, 7, 16, 32, 64, 128):
            n = 512 if b >= 16 else 40 * b
            a = sp.random(n, n, density=0.02, random_state=b, format="csr",
                          dtype=np.float32)
            a = (a + a.T).tocsr()
            bc = csr_to_bcsr(a.indptr, a.indices, a.data, n, n, block=b)
            cols = torch.as_tensor(bc.tile_cols, device=dev)
            vals = torch.as_tensor(bc.tile_vals, device=dev)
            for f in (40, 128, 256):
                x = torch.as_tensor(rng.normal(size=(bc.num_cols, f))
                                    .astype(np.float32), device=dev)
                check_spmm(cols, vals, x, f"random B={b} K={cols.shape[1]} "
                                          f"F={f}")
        for dtype in (torch.float32, torch.bfloat16):
            for f in (100, 128, 256, 37):       # F=37: no 16-byte vectors
                table = torch.as_tensor(rng.normal(size=(5000, f)),
                                        dtype=torch.float32,
                                        device=dev).to(dtype)
                idx = torch.as_tensor(rng.integers(0, 5000, size=20000),
                                      dtype=torch.int32, device=dev)
                check_gather(table, idx, f"random {dtype} F={f}")
                idx[::97] = -3
                idx[5::97] = 5000
                check_gather(table, idx, f"random {dtype} F={f}")

    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.graph.datasets import get_dataset

    with phase("plan"):
        ds = get_dataset("arxiv-like")
        pipe = IBMBPipeline(ds, IBMBConfig(variant="node", backend="bcsr"))
        plans = {}
        for split in ("train", "val", "test"):
            t0 = time.perf_counter()
            plan = pipe.plan(split, for_inference=split != "train")
            plans[split] = plan
            tv = plan.cache.fields["tile_vals"]
            print(f"arxiv-like {split} plan: {len(plan)} batches, max_nodes "
                  f"{plan.cache.fields['features'].shape[1]}, tiles R,K,B = "
                  f"{tv.shape[1]},{tv.shape[2]},{tv.shape[3]}, tile_vals "
                  f"{tv.nbytes / 1e9:.3f} GB, autotuner decisions "
                  f"{sorted(set(plan.batch_backends()))}, built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)

    with phase("kernels-real"):
        for split in ("train", "test"):
            fields = plans[split].cache.fields
            cols = torch.as_tensor(fields["tile_cols"][0], device=dev)
            vals = torch.as_tensor(fields["tile_vals"][0], device=dev)
            n_cols = vals.shape[0] * vals.shape[3]     # A is square
            bsr = bsr_of(torch, cols, vals, n_cols)
            for f in (256, 40):
                x = torch.as_tensor(rng.normal(size=(n_cols, f))
                                    .astype(np.float32), device=dev)
                label = f"arxiv-like {split} batch 0 F={f}"
                check_spmm(cols, vals, x, label, backward=split == "train")
                bound, by, nz_tiles, flops, nbytes = spmm_bound_ms(
                    cols, vals, x, peak_flops, peak_bw)
                plain = cuda_ms(torch, lambda: spmm_bcsr_ref(cols, vals, x),
                                5)
                stream = cuda_ms(torch, lambda: spmm_bcsr_stream(
                    cols, vals, x), 5)
                lib_out = bsr @ x
                torch.cuda.synchronize()
                lib_err = (lib_out - spmm_bcsr_ref(cols, vals, x)).abs().max()
                lib = cuda_ms(torch, lambda: bsr @ x, 10)
                padded = 2.0 * vals.shape[0] * vals.shape[1] * \
                    vals.shape[2] ** 2 * f
                for name, impl in SPMM_IMPLS.items():
                    ms = cuda_ms(torch, lambda: spmm_bcsr(
                        cols, vals, x, impl=impl), 10)
                    print(f"{name} {label} (R={vals.shape[0]} "
                          f"K={vals.shape[1]}): kernel {ms:.4f} ms, plain "
                          f"(reference) {plain:.4f} ms, plain (stream) "
                          f"{stream:.4f} ms, library (sparse_bsr_tensor @ x, "
                          f"err {lib_err.item():.2e}) {lib:.4f} ms; bound "
                          f"{bound:.4f} ms by {by} ({nz_tiles} nonzero tiles "
                          f"of {vals.shape[0] * vals.shape[1]} slots, "
                          f"{flops / 1e9:.2f} GFLOP needed, "
                          f"{padded / 1e9:.2f} GFLOP padded, "
                          f"{nbytes / 1e6:.1f} MB moved); kernel at "
                          f"{padded / ms / 1e9:.2f} TFLOP/s padded, "
                          f"{bound / ms * 100:.1f}% of bound", flush=True)
                    if split == "train" and f == 256:
                        record[name] = dict(ms=ms, plain_ms=plain,
                                            bound_ms=bound, bound_by=by,
                                            library_ms=lib)
            del x, bsr, lib_out, cols, vals

        # the gather: the feature table with train batch 0's node ids (pads
        # are -1: zero rows, as the batch's padded feature rows are), then a
        # table the size of ogbn-products' features for timing
        feats = torch.as_tensor(ds.features, dtype=torch.float32, device=dev)
        ids = torch.as_tensor(plans["train"].node_ids[0],
                              dtype=torch.int32, device=dev)
        check_gather(feats, ids, f"arxiv-like features {tuple(feats.shape)}"
                                 f" train batch 0 ids")
        gen = torch.Generator(dev).manual_seed(3)
        table = torch.randn((PRODUCTS_NODES, PRODUCTS_FEATURES), device=dev,
                            generator=gen)
        idx = torch.randint(0, PRODUCTS_NODES, (GATHER_IDS,), device=dev,
                            generator=gen, dtype=torch.int32)
        check_gather(table, idx, f"products-size table "
                                 f"{tuple(table.shape)} f32")
        ms = cuda_ms(torch, lambda: gather_rows(table, idx), 20)
        plain = cuda_ms(torch, lambda: gather_rows_ref(table, idx), 20)
        lib = cuda_ms(torch, lambda: torch.index_select(table, 0, idx), 20)
        bound, distinct, nbytes = gather_bound_ms(torch, table, idx, peak_bw)
        print(f"gather_rows products-size table {tuple(table.shape)} f32 "
              f"({table.numel() * 4 / 1e9:.3f} GB), {GATHER_IDS} ids "
              f"({distinct} distinct): kernel {ms:.4f} ms, plain "
              f"(table[idx]) {plain:.4f} ms, library (index_select) "
              f"{lib:.4f} ms; bound {bound:.4f} ms by bytes "
              f"({nbytes / 1e6:.1f} MB moved); kernel at "
              f"{nbytes / ms / 1e6:.1f} GB/s, {bound / ms * 100:.1f}% of "
              f"bound", flush=True)
        record["gather_rows"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                     bound_by="bytes", library_ms=lib)
        del table, idx

    from repro_torch.data.loader import PrefetchLoader, consume, stage_batch
    from repro_torch.device import stage
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.optim import tree_leaves
    from repro_torch.train import GNNTrainer

    cfg = GNNConfig(kind="gcn", hidden=256, num_layers=3, dropout=0.3,
                    in_dim=ds.feat_dim, out_dim=ds.num_classes)
    launches = {}
    with phase("train"):
        train_plan, val_plan = plans["train"], plans["val"]
        trainer = GNNTrainer(cfg, optimizer="adam", lr=1e-3, backend="bcsr")
        init = [t.clone() for t in tree_leaves(trainer.init_params())]
        build.reset_launches()
        t0 = time.perf_counter()
        result = trainer.fit(train_plan, val_plan, ds.num_classes, epochs=2)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches["spmm_bcsr"] = build.launches.get("spmm_bcsr", 0)
        steps = len(train_plan) * len(result.history)
        want = 2 * cfg.num_layers * steps + \
            cfg.num_layers * len(val_plan) * len(result.history)
        prev = 0.0
        for h in result.history:
            print(f"epoch {h['epoch']}: train_loss {h['train_loss']:.6f} "
                  f"val_loss {h['val_loss']:.6f} val_acc {h['val_acc']:.4f} "
                  f"lr {h['lr']:.2e}, {h['time'] - prev:.3f} s with "
                  f"evaluation", flush=True)
            prev = h["time"]
        print(f"fit: {steps} train steps, {len(val_plan)} val batches x "
              f"{len(result.history)} evaluations in {fit_s:.3f} s; train "
              f"time per epoch {result.time_per_epoch:.3f} s; spmm_bcsr "
              f"launches {launches['spmm_bcsr']} (want {want} = 6 x {steps} "
              f"+ 3 x {len(val_plan)} x {len(result.history)})", flush=True)
        if launches["spmm_bcsr"] != want:
            raise AssertionError(f"spmm_bcsr launched "
                                 f"{launches['spmm_bcsr']} times, want {want}")
        for h in result.history:
            if not all(np.isfinite(h[k]) for k in ("train_loss", "val_loss",
                                                    "val_acc")):
                raise AssertionError(f"non-finite history {h}")
        moved = max((a - b).abs().max().item() for a, b in zip(
            tree_leaves(result.params), init))
        if not moved > 0 or not all(torch.isfinite(t).all() for t in
                                    tree_leaves(result.params)):
            raise AssertionError(f"parameters did not move finitely "
                                 f"(max change {moved})")
        print(f"parameters moved by up to {moved:.3e}", flush=True)

        # one train step on the card against the same step on the CPU, at
        # dropout 0, from the same parameters and batch
        cfg0 = dataclasses.replace(cfg, dropout=0.0)
        host = train_plan.cache[0]
        got_l, got_g = GNNTrainer(cfg0, backend="bcsr")._steps_for(
            "bcsr", 0)["grad"](result.params, stage(host, dev), None)
        cpu_params = {"layers": [{k: v.cpu() for k, v in layer.items()}
                                 for layer in result.params["layers"]]}
        want_l, want_g = GNNTrainer(cfg0, backend="bcsr", device="cpu") \
            ._steps_for("bcsr", 0)["grad"](cpu_params, stage(host, "cpu"),
                                           None)
        worst = abs(got_l.item() - want_l.item())
        for a, b in zip(tree_leaves(got_g), tree_leaves(want_g)):
            worst = max(worst, (a.cpu() - b).abs().max().item())
            torch.testing.assert_close(a.cpu(), b, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(got_l.cpu(), want_l, atol=ATOL, rtol=RTOL)
        print(f"train step, card vs CPU (dropout 0): loss {got_l.item():.6f}"
              f" vs {want_l.item():.6f}, loss and gradients max_abs_err "
              f"{worst:.3e}", flush=True)

        # one train step's device time: staging on the side stream, then
        # the step on the current stream, under the profiler
        from torch.profiler import ProfilerActivity, profile
        steps_fn = trainer._steps_for("bcsr", 0)["train"]
        opt_state = trainer.opt.init(result.params)
        side = torch.cuda.Stream(dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            batch = consume(stage_batch(host, dev, side), dev)
            steps_fn(result.params, opt_state, batch, 1e-3,
                     torch.Generator(dev).manual_seed(0))
            torch.cuda.synchronize()
        split = device_time_split(prof, torch)
        total = sum(split.values())
        if total <= 0:
            raise AssertionError("the profiler recorded no device time")
        print("one train step's device time (torch.profiler): " + ", ".join(
            f"{k} {v / 1e3:.3f} ms ({v / total * 100:.1f}%)"
            for k, v in split.items()) + f"; total {total / 1e3:.3f} ms",
            flush=True)
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=12), flush=True)
        del batch

        # one epoch of train steps through the prefetch loader (no
        # evaluation): wall time per step, then the device's activity in
        # the same loop under the profiler; what the wall time leaves over
        # is the device's idle share
        def epoch_of_steps():
            params, state = result.params, opt_state
            for i, b in enumerate(PrefetchLoader(train_plan, device=dev)):
                params, state, loss = steps_fn(
                    params, state, b, 1e-3,
                    torch.Generator(dev).manual_seed(i))
                float(loss)
            torch.cuda.synchronize()

        epoch_of_steps()                                  # warm
        t0 = time.perf_counter()
        epoch_of_steps()
        wall = (time.perf_counter() - t0) * 1e3 / len(train_plan)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            epoch_of_steps()
        split = {k: v / 1e3 / len(train_plan) for k, v in
                 device_time_split(prof, torch).items()}
        busy = sum(split.values())
        print(f"steady train steps through the loader: {wall:.3f} ms wall "
              f"per step (host clock, {len(train_plan)} steps); device "
              f"activity per step (torch.profiler): " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in split.items()) +
              f"; device idle share {max(0.0, 1 - busy / wall) * 100:.1f}%"
              f" (activity summed over streams)", flush=True)
        del opt_state

    with phase("entry-points"):
        # the unfused SpMM through spmm_bcsr_sym, forward and backward, on
        # every train batch at the hidden width, against the plain version
        fields = train_plan.cache.fields
        w = torch.randn((ds.feat_dim, cfg.hidden), device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
        build.reset_launches()
        for bi in range(len(train_plan)):
            cols = torch.as_tensor(fields["tile_cols"][bi], device=dev)
            vals = torch.as_tensor(fields["tile_vals"][bi], device=dev)
            x = (torch.as_tensor(fields["features"][bi], device=dev) @ w) \
                .requires_grad_(True)
            out = spmm_bcsr_sym(cols, vals, x, impl="cuda_unfused")
            g = torch.ones_like(out)
            out.backward(g)
            with torch.no_grad():
                for got, want, what in (
                        (out, spmm_bcsr_ref(cols, vals, x), "forward"),
                        (x.grad, spmm_bcsr_ref(cols, vals, g), "backward")):
                    torch.cuda.synchronize()
                    note("spmm_bcsr_unfused", (got - want).abs().max().item(),
                         f"train batch {bi} {what}", bool(torch.allclose(
                             got, want, atol=ATOL, rtol=RTOL)))
        launches["spmm_bcsr_unfused"] = build.launches.get(
            "spmm_bcsr_unfused", 0)
        # the gather: every train batch's features from the feature table
        # (pad ids -1 give the zero rows the batch pads with)
        build.reset_launches()
        for bi in range(len(train_plan)):
            ids = torch.as_tensor(train_plan.node_ids[bi], dtype=torch.int32,
                                  device=dev)
            got = gather_rows(feats, ids)
            want = torch.as_tensor(fields["features"][bi], device=dev)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"gather_rows of train batch {bi}'s "
                                     f"ids differs from its features")
        launches["gather_rows"] = build.launches.get("gather_rows", 0)
        print(f"entry points over {len(train_plan)} train batches: "
              f"spmm_bcsr_unfused launches "
              f"{launches['spmm_bcsr_unfused']} (forward and backward), "
              f"gather_rows launches {launches['gather_rows']} (features "
              f"bit-identical to the plan's)", flush=True)
        for name in ("spmm_bcsr_unfused", "gather_rows"):
            if launches[name] == 0:
                raise AssertionError(f"{name} was never launched")
        del feats

    from repro_torch.models.gnn import init_gnn
    from repro_torch.serve import GNNInferenceEngine, GNNRequest

    with phase("serve"):
        plan = plans["test"]
        params = init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
        ids = plan.routing.node_ids
        qrng = np.random.default_rng(1)
        queries = [qrng.choice(ids, 16, replace=False) for _ in range(64)]
        burst = [qrng.choice(ids, 16, replace=False) for _ in range(32)]

        build.reset_launches()
        eng = GNNInferenceEngine(plan, cfg, params, backend="bcsr",
                                 cache_batches=0)
        lat, answers = [], []
        for q in queries:
            t0 = time.perf_counter()
            answers.append(eng.query(q))
            lat.append(time.perf_counter() - t0)
        reqs = [GNNRequest(node_ids=q) for q in burst]
        t0 = time.perf_counter()
        eng.run(reqs)
        burst_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        served = build.launches.get("spmm_bcsr", 0)

        runs = eng.stats["batch_runs"]
        p50, p95 = np.percentile(np.array(lat) * 1e3, [50, 95])
        print(f"bcsr serving: {len(queries)} queries of 16 ids, latency "
              f"p50 {p50:.2f} ms p95 {p95:.2f} ms (host clock, n="
              f"{len(lat)}); burst of {len(reqs)} requests in "
              f"{burst_s * 1e3:.2f} ms; stats "
              f"{json.dumps({k: v for k, v in eng.stats.items() if k != 'versions'})}; "
              f"spmm_bcsr launches {served}", flush=True)
        if runs == 0 or served != cfg.num_layers * runs:
            raise AssertionError(f"spmm_bcsr launched {served} times for "
                                 f"{runs} batch forwards of a "
                                 f"{cfg.num_layers}-layer GCN")
        if not all(r.done for r in reqs):
            raise AssertionError("burst left requests unanswered")
        for a in answers + [r.logits for r in reqs]:
            if a.shape != (16, cfg.out_dim) or not np.isfinite(a).all():
                raise AssertionError(f"bad logits: shape {a.shape}")

        # one whole batch against the plain path on the CPU
        b0 = plan.routing.node_ids[plan.routing.batch == 0]
        got = eng.query(b0)
        cpu = GNNInferenceEngine(plan, cfg, params, backend="bcsr",
                                 cache_batches=0, device="cpu")
        want = cpu.query(b0)
        err = float(np.abs(got - want).max())
        print(f"batch 0 ({len(b0)} outputs): cuda vs cpu engine max_abs_err "
              f"{err:.3e}", flush=True)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.query(b0)
            torch.cuda.synchronize()
        split = device_time_split(prof, torch)
        total = sum(split.values())
        print("one serving forward's device time (torch.profiler): " +
              ", ".join(f"{k} {v / 1e3:.3f} ms ({v / total * 100:.1f}%)"
                        for k, v in split.items()), flush=True)

        # auto: the plan's stored autotuner decisions (segment here)
        auto = GNNInferenceEngine(plan, cfg, params, backend="auto",
                                  cache_batches=0)
        before = build.launches.get("spmm_bcsr", 0)
        worst = 0.0
        for q, a in zip(queries[:8], answers[:8]):
            got = auto.query(q)
            worst = max(worst, float(np.abs(got - a).max()))
            np.testing.assert_allclose(got, a, atol=ATOL, rtol=RTOL)
        print(f"auto serving: decisions {sorted(set(auto._decisions))}, "
              f"8 queries vs bcsr max_abs_err {worst:.3e}, spmm_bcsr "
              f"launches {build.launches.get('spmm_bcsr', 0) - before}",
              flush=True)

    with phase("attention-yardstick"):
        # llama3.2-1b prefill (src/repro/configs/llama3_2_1b.py): B=1, 32
        # heads, S=4096, head dim 64, causal, bf16
        b, h, s, d = 1, 32, 4096, 64
        gen = torch.Generator(dev).manual_seed(11)
        q, k, v = (torch.randn((b, h, s, d), device=dev, generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out = sdpa(q, k, v, is_causal=True)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError("non-finite attention output")
        ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True), 20)
        flops = 4.0 * b * h * s * s * d / 2          # causal half
        nbytes = 4 * b * h * s * d * 2               # q, k, v read, o written
        t_ops, t_bytes = flops / peak_bf16 * 1e3, nbytes / peak_bw * 1e3
        print(f"flash_attention yardstick (not ported): "
              f"scaled_dot_product_attention B={b} H={h} S={s} D={d} causal "
              f"bf16 {ms:.4f} ms; bound {max(t_ops, t_bytes):.4f} ms by "
              f"{'operations' if t_ops >= t_bytes else 'bytes'} "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)",
              flush=True)

    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=replaces,
        launches=launches[name], max_abs_err=max_err[name],
        **record[name]) for name, (src, replaces) in KERNELS.items()]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
