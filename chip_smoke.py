#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(the kernels target ``sm_90a``, i.e. Hopper). Phases, each fatal:

1. device   — require CUDA, print the card's name and power limit, TF32 off.
2. build    — compile every kernel of the serving path from the checkout.
3. kernels  — each kernel against its plain PyTorch version on the card, on
              random symmetric cases and on the real tiles of one batch of
              the main path; timings beside the bound and a library call.
4. serve    — the main path: an arxiv-like test Plan built for the bcsr
              backend, the paper's ogbn GCN (hidden 256, 3 layers, seeded
              random weights) served by ``GNNInferenceEngine`` under
              ``backend="bcsr"``; launch counts, finiteness, agreement with
              the same engine on the CPU; then ``backend="auto"``.

The second-to-last line is a JSON ``kernels`` record and the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# f32 throughout with TF32 off: the kernel and the plain versions differ
# only in summation order, a few ulps per output over at most B·K terms;
# the same slack holds for the serving logits (CUDA engine against the CPU
# engine, bcsr against segment) through three layers and two LayerNorms
ATOL = RTOL = 1e-4

# published peaks (NVIDIA data sheets, dense, at the full power limit):
# f32 CUDA-core FLOP/s and device-memory bytes/s, by the name nvidia-smi gives
PEAKS = (("H100 PCIe", 51e12, 2.0e12), ("H100 NVL", 60e12, 3.9e12),
         ("H200", 67e12, 4.8e12), ("H100", 67e12, 3.35e12))

SPMM_SOURCE = "src/repro_torch/kernels/csrc/spmm_bcsr.cu"
SPMM_REPLACES = "src/repro/kernels/spmm/fused.py:96"


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
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
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
        peak_flops, peak_bw = peaks_for(kind)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"card {kind!r} peaks f32 {peak_flops / 1e12:g} TFLOP/s, "
              f"{peak_bw / 1e12:g} TB/s", flush=True)

    from repro_torch.kernels import build
    from repro_torch.kernels.spmm import (
        csr_to_bcsr, spmm_bcsr, spmm_bcsr_ref, spmm_bcsr_stream)
    from repro_torch.kernels.spmm.ops import KERNEL, SOURCE

    with phase("build"):
        t0 = time.perf_counter()
        print(f"{SOURCE} -> {build.build(SOURCE)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        build.load_library(SOURCE)

    max_err = 0.0

    def check(cols, vals, x, label):
        nonlocal max_err
        got = spmm_bcsr(cols, vals, x, impl="cuda")
        want = spmm_bcsr_ref(cols, vals, x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        ok = bool(torch.allclose(got, want, atol=ATOL, rtol=RTOL))
        max_err = max(max_err, err)
        print(f"spmm_bcsr {label}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"kernel disagrees with spmm_bcsr_ref "
                                 f"({label})")

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
                check(cols, vals, x, f"random B={b} K={cols.shape[1]} "
                                     f"F={f}")

    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.graph.datasets import get_dataset

    with phase("plan"):
        ds = get_dataset("arxiv-like")
        pipe = IBMBPipeline(ds, IBMBConfig(variant="node", backend="bcsr"))
        t0 = time.perf_counter()
        plan = pipe.plan("test", for_inference=True)
        tc, tv = plan.cache.fields["tile_cols"], plan.cache.fields["tile_vals"]
        print(f"arxiv-like test plan: {len(plan)} batches, max_nodes "
              f"{plan.cache.fields['features'].shape[1]}, tiles R,K,B = "
              f"{tv.shape[1]},{tv.shape[2]},{tv.shape[3]}, tile_vals "
              f"{tv.nbytes / 1e9:.3f} GB, decisions "
              f"{plan.batch_backends()} block_f "
              f"{plan.batch_block_fs().tolist()}, built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for i, s in enumerate(plan.meta["batch_stats"]):
            print(f"  batch {i}: {json.dumps(s, sort_keys=True)}")

    record = {}
    with phase("kernels-real"):
        cols = torch.as_tensor(tc[0], device=dev)
        vals = torch.as_tensor(tv[0], device=dev)
        n_cols = tv.shape[1] * tv.shape[3]
        for f in (256, 40):
            x = torch.as_tensor(rng.normal(size=(n_cols, f))
                                .astype(np.float32), device=dev)
            check(cols, vals, x, f"arxiv-like batch 0 F={f}")
            bound, by, nz_tiles, flops, nbytes = spmm_bound_ms(
                cols, vals, x, peak_flops, peak_bw)
            ms = cuda_ms(torch, lambda: spmm_bcsr(cols, vals, x,
                                                  impl="cuda"), 10)
            plain = cuda_ms(torch, lambda: spmm_bcsr_ref(cols, vals, x), 5)
            stream = cuda_ms(torch, lambda: spmm_bcsr_stream(cols, vals, x),
                             5)
            bsr = bsr_of(torch, cols, vals, n_cols)
            lib_out = bsr @ x
            torch.cuda.synchronize()
            lib_err = (lib_out - spmm_bcsr_ref(cols, vals, x)).abs().max()
            lib = cuda_ms(torch, lambda: bsr @ x, 10)
            padded = 2.0 * vals.shape[0] * vals.shape[1] * \
                vals.shape[2] ** 2 * f
            print(f"spmm_bcsr F={f}: kernel {ms:.4f} ms, plain (reference) "
                  f"{plain:.4f} ms, plain (stream) {stream:.4f} ms, "
                  f"library (sparse_bsr_tensor @ x, err "
                  f"{lib_err.item():.2e}) {lib:.4f} ms; bound {bound:.4f} ms "
                  f"by {by} ({nz_tiles} nonzero tiles of "
                  f"{vals.shape[0] * vals.shape[1]} slots, {flops / 1e9:.2f} "
                  f"GFLOP needed, {padded / 1e9:.2f} GFLOP padded, "
                  f"{nbytes / 1e6:.1f} MB moved); kernel at "
                  f"{padded / ms / 1e9:.2f} TFLOP/s padded, "
                  f"{bound / ms * 100:.1f}% of bound", flush=True)
            if f == 256:
                record = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                              bound_by=by, library_ms=lib)
        del x, bsr, lib_out

    from repro_torch.models.gnn import GNNConfig, init_gnn
    from repro_torch.serve import GNNInferenceEngine, GNNRequest

    launches = 0
    with phase("serve"):
        cfg = GNNConfig(kind="gcn", hidden=256, num_layers=3, dropout=0.3,
                        in_dim=ds.feat_dim, out_dim=ds.num_classes)
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
        launches = build.launches.get(KERNEL, 0)

        runs = eng.stats["batch_runs"]
        p50, p95 = np.percentile(np.array(lat) * 1e3, [50, 95])
        print(f"bcsr serving: {len(queries)} queries of 16 ids, latency "
              f"p50 {p50:.2f} ms p95 {p95:.2f} ms (host clock, n="
              f"{len(lat)}); burst of {len(reqs)} requests in "
              f"{burst_s * 1e3:.2f} ms; stats "
              f"{json.dumps({k: v for k, v in eng.stats.items() if k != 'versions'})}; "
              f"{KERNEL} launches {launches}", flush=True)
        if runs == 0 or launches != cfg.num_layers * runs:
            raise AssertionError(f"{KERNEL} launched {launches} times for "
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
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=10), flush=True)

        # auto: the plan's stored autotuner decisions (segment here)
        auto = GNNInferenceEngine(plan, cfg, params, backend="auto",
                                  cache_batches=0)
        before = build.launches.get(KERNEL, 0)
        worst = 0.0
        for q, a in zip(queries[:8], answers[:8]):
            got = auto.query(q)
            worst = max(worst, float(np.abs(got - a).max()))
            np.testing.assert_allclose(got, a, atol=ATOL, rtol=RTOL)
        print(f"auto serving: decisions {sorted(set(auto._decisions))}, "
              f"8 queries vs bcsr max_abs_err {worst:.3e}, {KERNEL} "
              f"launches {build.launches.get(KERNEL, 0) - before}",
              flush=True)

    print(json.dumps({"kernels": [dict(
        name=KERNEL, route="cuda", source=SPMM_SOURCE,
        replaces=SPMM_REPLACES, launches=launches, max_abs_err=max_err,
        ms=record["ms"], plain_ms=record["plain_ms"],
        bound_ms=record["bound_ms"], bound_by=record["bound_by"],
        library_ms=record["library_ms"])]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
