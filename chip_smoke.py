#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``
(the kernels target ``sm_90a``, i.e. Hopper). Phases, each fatal:

1. device   — require CUDA, print the card's name and power limit, TF32 off.
2. build    — compile every kernel source of the port from the checkout,
              one ``nvcc`` per source, all started together; each SpMM
              kernel's registers and spills (``ptxas -v``, fatal if it
              spills) and the bulk copies (UBLKCP) in the SASS of every
              instantiation that streams by them (fatal if absent).
3. kernels-random — both block-CSR SpMM kernels, forward and backward
              (through ``spmm_bcsr_sym``; B 1-128, F 40/128/256/300, an
              all-zero slot, column tiles outside x, a NaN x row that
              reaches only its readers, two calls bitwise equal), and the
              row gather (f32 and bf16,
              rows that do and do not take 16-byte vectors, ids outside the
              table) and flash attention (f32 and bf16, causal or not,
              window 0 or 64, S 128/200/4095, D 64/128, GQA 1 or 4) against
              their plain PyTorch versions on random cases; bf16 attention
              (the tensor-core kernel) is held elementwise to one bf16
              rounding of the f32 result, f32 attention (the CUDA-core
              kernel) to 1e-4.
4. plan     — the arxiv-like train, val and test Plans for the bcsr backend,
              and what batches 0 and 1 of train and test hold (nonzero
              tiles, entries, chunks and columns).
5. kernels-real — each kernel on the main path's real inputs, with its
              time beside the bound, the plain version and a library call
              (for the SpMM, timed with the calls queued behind a held
              card: one call's kernels are shorter than the host's
              dispatch of it, which is printed beside them); for the SpMM
              also the unfused kernel with S = 2 forced, the bytes moved,
              the GB/s and share of the per-entry bound, beside the
              per-tile count of the first kernels' bound.
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
9. flash-real — the flash-attention kernel at the llama3.2-1b prefill
              shape (B=1, 32 heads over 8 kv heads, S=4096, head dim 64,
              causal) in bf16 and in f32 against the plain version, then
              its bf16 time beside the bound, the plain version and
              ``scaled_dot_product_attention`` (the yardstick only); the
              bf16 kernel's SASS must hold tensor-core (HGMMA) and TMA
              (UTMALDG) instructions; its registers, spills and shared
              memory per block from the build.
10. lm-prefill — the LM main path: ``init_params`` of the full llama3.2-1b
              (16 layers, bf16) on the card, then ``lm_forward`` and
              ``head_logits`` on the last position at B=1, S=4096: exactly
              one flash launch per layer, finite logits, and one forward's
              device time split by ``torch.profiler``.
11. lm-card-vs-cpu — the same widths cut to 2 layers, f32, S=256: the
              card's logits against the CPU path's.
12. lm-decode — full width and depth in f32, B=2: 256 teacher-forced
              ``decode_step``s against the prefill's last logits (and the
              same figure in bf16, printed for the record), each also
              against a prefill whose attention runs the plain version;
              then one decode step's kernels and device-busy share under
              ``torch.profiler``.
13. lm-serve — ``ServeEngine`` (4 slots, max_len 512) serves 8 seeded
              requests at full width in bf16; all complete, none evicted,
              and the first request's tokens equal those it gets alone.

The second-to-last line is a JSON ``kernels`` record and the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
import contextlib
import ctypes
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time
import traceback
import unittest.mock

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# f32 throughout with TF32 off: the kernels and the plain versions differ
# only in summation order, a few ulps per output over at most B·K terms;
# the same slack holds for the serving logits and for one train step's loss
# and gradients (CUDA against the CPU) through three layers and two
# LayerNorms, and for the LM's logits through two layers. The row gather is
# a copy: it must match bit for bit, in f32 and in bf16 alike (tolerance 0).
ATOL = RTOL = 1e-4
# flash attention in bf16: the kernel takes the bf16 inputs exactly into
# f32, accumulates in f32 and rounds each output once to bf16, so it is held
# elementwise to the plain version on f32 copies of the same inputs within
# one bf16 rounding (at most 2^-8 of the value) on top of ATOL
BF16_REL = 2 ** -8
# decode against prefill over 16 layers: the reference's criterion,
# max error over max |logit| (tests/test_lm_archs.py)
DECODE_REL = 2e-2

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
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:81"),
}
SPMM_IMPLS = {"spmm_bcsr": "cuda", "spmm_bcsr_unfused": "cuda_unfused"}

# ogbn-products' node features: 2,449,029 nodes × 100 f32
PRODUCTS_NODES, PRODUCTS_FEATURES, GATHER_IDS = 2_449_029, 100, 1 << 20

# clock cycles ``queued_ms`` holds the card for (about 50 ms on an H100)
HOLD_CYCLES = 100_000_000

# the llama3.2-1b prefill: one sequence of 4096 tokens
LM_ARCH, PREFILL_S = "llama3.2-1b", 4096


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


def queued_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    one warm-up call, by CUDA events, with every call enqueued while the
    card is held busy (``torch.cuda._sleep``): for calls whose kernels are
    shorter than the host's dispatch of a call, where plain back-to-back
    timing would time the host. Raises if the host took longer to enqueue
    the calls than the card slept."""
    fn()
    torch.cuda.synchronize()
    hold, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    hold.record()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if not hold.elapsed_time(start) > enqueue_ms:
        raise AssertionError(f"the host took {enqueue_ms:.3f} ms to enqueue "
                             f"{iters} calls, longer than the card was held")
    return start.elapsed_time(end) / iters


def spmm_bound_ms(cols, vals, x, peak_flops, peak_bw):
    """Least time for one call on these inputs: tile_cols, tile_vals and x
    read once and the output written once, against the f32 operations the
    data needs, two per nonzero entry and feature (2·nnz·F). Also returns
    the per-tile count that bounded the first, dense kernels (one B×B by
    B×F product per tile that holds a nonzero) for comparison."""
    r, k, b, _ = vals.shape
    f = x.shape[1]
    nnz = int((vals != 0).sum())
    nz_tiles = int((vals != 0).any(dim=3).any(dim=2).sum())
    nbytes = (cols.numel() * 4 + vals.numel() * 4 + x.numel() * 4
              + r * b * f * 4)
    flops = 2.0 * nnz * f
    t_bytes, t_ops = nbytes / peak_bw * 1e3, flops / peak_flops * 1e3
    tile_flops = 2.0 * nz_tiles * b * b * f
    return dict(ms=max(t_bytes, t_ops), by="bytes" if t_bytes >= t_ops
                else "operations", bytes_ms=t_bytes, nbytes=nbytes,
                nnz=nnz, flops=flops, nz_tiles=nz_tiles,
                tile_ms=max(t_bytes, tile_flops / peak_flops * 1e3),
                tile_flops=tile_flops)


def tile_survey(torch, vals):
    """What one batch's padded tiles (B a multiple of 32) hold: slots,
    nonzero tiles, nonzero entries, entries per nonzero tile, the nonzero
    tiles' share of the bytes, the share of their 32-wide column chunks
    that hold a nonzero, and the share of their columns that do."""
    r, k, b, _ = vals.shape
    nz = vals != 0
    tiles = nz.any(dim=3).any(dim=2)
    n_tiles, nnz = int(tiles.sum()), int(nz.sum())
    cols_used = nz.any(dim=2)                              # (R, K, B)
    chunks = cols_used.reshape(r, k, b // 32, 32).any(dim=3)[tiles]
    return (f"{r}x{k} = {r * k} slots, {n_tiles} nonzero tiles "
            f"({n_tiles / (r * k) * 100:.1f}%), {nnz} nonzero entries, "
            f"{nnz / max(n_tiles, 1):.1f} per nonzero tile, nonzero tiles' "
            f"bytes {n_tiles * b * b * 4 / 1e6:.1f} of "
            f"{vals.numel() * 4 / 1e6:.1f} MB, 32-wide chunks of nonzero "
            f"tiles holding a nonzero "
            f"{chunks.float().mean().item() * 100:.0f}%, columns of a "
            f"nonzero tile used "
            f"{cols_used[tiles].float().mean().item() * 100:.0f}%")


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


GNN_KINDS = (("staging", lambda k: "Memcpy HtoD" in k),
             ("spmm_kernel", lambda k: "spmm_bcsr" in k))
LM_KINDS = (("flash_kernel", lambda k: "flash_fwd" in k),
            ("gemm", lambda k: any(w in k.lower() for w in (
                "gemm", "nvjet", "xmma", "cutlass", "matmul"))))


def device_events(prof):
    """(name, count, µs) of each kind of device activity in a profile:
    kernels, copies and fills, not user annotations."""
    from torch.autograd import DeviceType
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        yield e.key, e.count, us


def device_time_split(prof, torch, kinds=GNN_KINDS):
    """A profile's device time (µs) by kind: the first of ``kinds`` (name,
    predicate on the kernel's name) that matches, else "rest"."""
    split = {name: 0.0 for name, _ in kinds}
    split["rest"] = 0.0
    for key, _, us in device_events(prof):
        name = next((n for n, match in kinds if match(key)), "rest")
        split[name] += us
    return split


def attention_bound_ms(b, h, kv, s, d, causal, elem, peak_flops, peak_bw):
    """Least time for one attention call: q, k and v read once and the
    output written once, against the operations the mask leaves (two
    products of 2·D flops per visible (query, key) pair)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4.0 * b * h * pairs * d
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * elem
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def sass_counts(sass: str, words=("HGMMA", "UTMALDG")):
    """{kernel: {word: count}} over the functions of a ``cuobjdump -sass``
    listing."""
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        counts[name.strip()] = {w: body.count(w) for w in words}
    return counts


def ptxas_report(log: str):
    """(kernel, registers, stack bytes, spill store and load bytes) of each
    entry function in a ``ptxas -v`` report."""
    return [(m[1], int(m[5]), int(m[2]), int(m[3]), int(m[4]))
            for m in re.finditer(
                r"Compiling entry function '(\w+)'.*?(\d+) bytes stack "
                r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                r"loads.*?Used (\d+) registers", log, re.S)]


def spmm_build_report(build, source):
    """Print each SpMM kernel's registers and spills from its ``ptxas -v``
    report and its bulk copies (UBLKCP) from its SASS; raise if a kernel
    spills or an instantiation that streams by bulk copies (template
    argument ``kBulk = true``, ``Lb1E`` in the mangled name) has none."""
    for name, regs, stack, spill_st, spill_ld in ptxas_report(
            build.build_log(source)):
        print(f"ptxas {name}: {regs} registers, {stack} bytes stack, "
              f"{spill_st}/{spill_ld} bytes spill stores/loads", flush=True)
        if spill_st or spill_ld:
            raise AssertionError(f"{name} spills registers")
    sass = subprocess.run(
        [build.cuda_tool("cuobjdump"), "-sass", build.library_path(source)],
        capture_output=True, text=True, check=True).stdout
    bulk = {name: c for name, c in sass_counts(sass, ("UBLKCP",)).items()
            if "Lb1E" in name}
    for name, c in bulk.items():
        print(f"SASS of {name}: {c['UBLKCP']} UBLKCP", flush=True)
    if not bulk or any(c["UBLKCP"] == 0 for c in bulk.values()):
        raise AssertionError(f"{source}: a bulk-copy kernel's SASS lacks "
                             f"UBLKCP: {bulk}")


def bshd(torch, gen, shape, dtype, dev):
    """A (B, S, heads, D) normal tensor viewed as (B, heads, S, D), the
    layout the LM's projections hand the kernel."""
    return torch.randn(shape, device=dev, generator=gen).to(dtype) \
        .transpose(1, 2)


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
    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention)
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
        for src, _ in KERNELS.values():
            if "spmm" in src:
                spmm_build_report(build, os.path.basename(src))

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

    def check_spmm_edges(bc, f, label):
        """Both SpMM kernels with two more slots per row tile: an all-zero
        tile at a live column tile, and nonzero tiles at column tiles C
        and -1, outside x, which the kernels skip (the plain version sees
        them zeroed); two calls must give the same bits. Then a NaN x row
        that a nonzero entry reads: exactly its readers' outputs are NaN,
        and every other output matches the plain version on x with the row
        zeroed."""
        b, k = bc.block, bc.tile_cols.shape[1]
        padded = bc.with_pad_k(k + 2)
        cols, vals = padded.tile_cols.copy(), padded.tile_vals.copy()
        c = padded.num_cols // b
        cols[:, k] = 1 % c
        cols[0, k + 1], cols[-1, k + 1] = c, -1
        vals[0, k + 1] = vals[-1, k + 1] = 1.0
        seen_c, seen_v = cols.copy(), vals.copy()
        seen_c[[0, -1], k + 1], seen_v[[0, -1], k + 1] = 0, 0.0
        cols, vals, seen_c, seen_v = (torch.as_tensor(t, device=dev) for t in
                                      (cols, vals, seen_c, seen_v))
        x = torch.as_tensor(rng.normal(size=(padded.num_cols, f))
                            .astype(np.float32), device=dev)
        r0, k0, _i, j0 = (int(v) for v in (seen_v != 0).nonzero()[0])
        p = int(seen_c[r0, k0]) * b + j0
        readers = ((seen_v[..., p % b] != 0) &
                   (seen_c == p // b)[..., None]).any(dim=1).reshape(-1)
        xn, xz = x.clone(), x.clone()
        xn[p], xz[p] = float("nan"), 0.0
        want, want_z = (spmm_bcsr_ref(seen_c, seen_v, t) for t in (x, xz))
        for name, impl in SPMM_IMPLS.items():
            got, again = (spmm_bcsr(cols, vals, x, impl=impl)
                          for _ in range(2))
            torch.cuda.synchronize()
            note(name, (got - want).abs().max().item(), f"{label} all-zero "
                 f"slot, column tiles outside x, two calls bitwise equal",
                 bool(torch.allclose(got, want, atol=ATOL, rtol=RTOL)) and
                 torch.equal(got.view(torch.int32), again.view(torch.int32)))
            got = spmm_bcsr(cols, vals, xn, impl=impl)
            torch.cuda.synchronize()
            rest = ~readers
            note(name, (got[rest] - want_z[rest]).abs().max().item(),
                 f"{label} NaN x row {p} ({int(readers.sum())} readers)",
                 torch.equal(torch.isnan(got).all(dim=1), readers) and
                 not bool(torch.isnan(got[rest]).any()) and
                 bool(torch.allclose(got[rest], want_z[rest], atol=ATOL,
                                     rtol=RTOL)))

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

    def check_flash(q, k, v, causal, window, label):
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             window=window)
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        limit = ATOL + (BF16_REL * want.abs() if q.dtype == torch.bfloat16
                        else 0.0)
        err = diff.max().item()
        note("flash_attention", err, f"{label} (worst error / limit "
             f"{(diff / limit).max().item():.3f})", bool(
                 (diff <= limit).all() and torch.isfinite(got).all())
             and got.stride() == q.stride())

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
            for f in (40, 128, 256, 300):
                x = torch.as_tensor(rng.normal(size=(bc.num_cols, f))
                                    .astype(np.float32), device=dev)
                check_spmm(cols, vals, x, f"random B={b} K={cols.shape[1]} "
                                          f"F={f}")
            for f in (40, 300):
                check_spmm_edges(bc, f, f"random B={b} F={f}")
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
        # flash attention: q (B, S, H, D) and k, v (B, S, KV, D) buffers
        # passed as (B, heads, S, D) views, as the LM passes them
        gen = torch.Generator(dev).manual_seed(13)
        for dtype, causal, window, s, d, g in itertools.product(
                (torch.float32, torch.bfloat16), (True, False), (0, 64),
                (128, 200, 4095), (64, 128), (1, 4)):
            kv = 2
            q = bshd(torch, gen, (1, s, kv * g, d), dtype, dev)
            k, v = (bshd(torch, gen, (1, s, kv, d), dtype, dev)
                    for _ in range(2))
            check_flash(q, k, v, causal, window, f"random {dtype} causal="
                        f"{causal} window={window} S={s} D={d} G={g}")

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
        # what the SpMM kernels are given: the tiles of batches 0 and 1
        for split in ("train", "test"):
            for bi in (0, 1):
                vals = torch.as_tensor(
                    plans[split].cache.fields["tile_vals"][bi], device=dev)
                print(f"arxiv-like {split} batch {bi} tiles: "
                      f"{tile_survey(torch, vals)}", flush=True)
                del vals

    from repro_torch.kernels.spmm import ops as spmm_ops

    with phase("kernels-real"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
                bd = spmm_bound_ms(cols, vals, x, peak_flops, peak_bw)
                # a call's kernels are shorter than the host's dispatch of
                # it: every time here is taken with the calls queued
                plain = queued_ms(torch, lambda: spmm_bcsr_ref(
                    cols, vals, x), 5)
                stream = queued_ms(torch, lambda: spmm_bcsr_stream(
                    cols, vals, x), 5)
                want = spmm_bcsr_ref(cols, vals, x)
                lib_err = (bsr @ x - want).abs().max()
                lib = queued_ms(torch, lambda: bsr @ x, 10)
                lib_call = cuda_ms(torch, lambda: bsr @ x, 10)
                r, k, b, _ = vals.shape
                splits, _per = spmm_ops.k_splits(r, k, b, f, sms)
                for name, impl in SPMM_IMPLS.items():
                    ms = queued_ms(torch, lambda: spmm_bcsr(
                        cols, vals, x, impl=impl), 10)
                    call = cuda_ms(torch, lambda: spmm_bcsr(
                        cols, vals, x, impl=impl), 10)
                    print(f"{name} {label} (R={r} K={k}): kernel {ms:.4f} "
                          f"ms (queued; {call:.4f} ms a call through "
                          f"spmm_bcsr by CUDA events over back-to-back "
                          f"calls, the host's dispatch included), plain "
                          f"(reference) {plain:.4f} ms, plain "
                          f"(stream) {stream:.4f} ms, library "
                          f"(sparse_bsr_tensor @ x, err {lib_err.item():.2e}) "
                          f"{lib:.4f} ms queued, {lib_call:.4f} ms a call; "
                          f"bound {bd['ms']:.4f} ms by "
                          f"{bd['by']} ({bd['nnz']} nonzero entries, "
                          f"{bd['flops'] / 1e6:.2f} MFLOP needed, "
                          f"{bd['nbytes'] / 1e6:.1f} MB moved); per-tile "
                          f"bound {bd['tile_ms']:.4f} ms "
                          f"({bd['nz_tiles']} nonzero tiles of {r * k} "
                          f"slots, {bd['tile_flops'] / 1e9:.2f} GFLOP); "
                          f"kernel at {bd['nbytes'] / ms / 1e6:.1f} GB/s, "
                          f"{bd['bytes_ms'] / ms * 100:.1f}% of the bytes "
                          f"bound" + (f"; K split S={splits}"
                                      if impl == "cuda_unfused" else ""),
                          flush=True)
                    if split == "train" and f == 256:
                        record[name] = dict(ms=ms, plain_ms=plain,
                                            bound_ms=bd["ms"],
                                            bound_by=bd["by"], library_ms=lib)
                # the unfused kernel's split model against a measurement:
                # the same call with S = 2 forced
                with unittest.mock.patch.object(
                        spmm_ops, "k_splits",
                        lambda r, k, b, f, sms: (2, -(-k // 2))):
                    forced = spmm_bcsr(cols, vals, x, impl="cuda_unfused")
                    torch.cuda.synchronize()
                    ms2 = queued_ms(torch, lambda: spmm_bcsr(
                        cols, vals, x, impl="cuda_unfused"), 10)
                note("spmm_bcsr_unfused", (forced - want).abs().max()
                     .item(), f"{label} S=2 forced", bool(torch.allclose(
                         forced, want, atol=ATOL, rtol=RTOL)))
                print(f"spmm_bcsr_unfused {label}: S=2 forced {ms2:.4f} ms "
                      f"queued (k_splits chose S={splits})",
                      flush=True)
            del x, bsr, want, forced, cols, vals

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
    from repro_torch.optim import tree_leaves, tree_map
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

    with phase("flash-real"):
        # the llama3.2-1b prefill (src/repro/configs/llama3_2_1b.py): B=1,
        # 32 heads over 8 kv heads, S=4096, head dim 64, causal, bf16
        b, h, kv, s, d = 1, 32, 8, PREFILL_S, 64
        gen = torch.Generator(dev).manual_seed(11)
        q = bshd(torch, gen, (b, s, h, d), torch.bfloat16, dev)
        k, v = (bshd(torch, gen, (b, s, kv, d), torch.bfloat16, dev)
                for _ in range(2))
        check_flash(q, k, v, True, 0, f"llama3.2-1b prefill B={b} H={h} "
                                      f"KV={kv} S={s} D={d} causal bf16")
        check_flash(q.float(), k.float(), v.float(), True, 0,
                    f"llama3.2-1b prefill B={b} H={h} KV={kv} S={s} D={d} "
                    f"causal f32")
        ms = cuda_ms(torch, lambda: flash_attention(q, k, v), 20)
        plain = cuda_ms(torch, lambda: attention_ref(q, k, v), 5)
        # the yardstick wants K and V expanded to H heads, (B, H, S, D)
        qe, ke, ve = (t.repeat_interleave(h // t.shape[1], dim=1)
                      .contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_err = (sdpa(qe, ke, ve, is_causal=True).float() -
                   attention_ref(q, k, v).float()).abs().max().item()
        lib = cuda_ms(torch, lambda: sdpa(qe, ke, ve, is_causal=True), 20)
        bound, by, flops, nbytes = attention_bound_ms(
            b, h, kv, s, d, True, 2, peak_bf16, peak_bw)
        floor_f32 = flops / peak_flops * 1e3
        print(f"flash_attention llama3.2-1b prefill B={b} H={h} KV={kv} "
              f"S={s} D={d} causal bf16: kernel {ms:.4f} ms, plain "
              f"(attention_ref) {plain:.4f} ms, library "
              f"(scaled_dot_product_attention on expanded K/V, err "
              f"{lib_err:.2e}) {lib:.4f} ms; bound {bound:.4f} ms by {by} "
              f"({flops / 1e9:.2f} GFLOP at the bf16 tensor peak, "
              f"{nbytes / 1e6:.1f} MB moved); the f32 CUDA-core floor "
              f"{floor_f32:.4f} ms; kernel at {flops / ms / 1e9:.2f} "
              f"TFLOP/s, {bound / ms * 100:.1f}% of bound", flush=True)
        record["flash_attention"] = dict(ms=ms, plain_ms=plain,
                                         bound_ms=bound, bound_by=by,
                                         library_ms=lib)
        del q, k, v, qe, ke, ve

        # bf16 runs on the tensor cores: the kernel's SASS must hold wgmma
        # (HGMMA) and TMA loads (UTMALDG)
        source = os.path.basename(KERNELS["flash_attention"][0])
        sass = subprocess.run(
            [build.cuda_tool("cuobjdump"), "-sass",
             build.library_path(source)],
            capture_output=True, text=True, check=True).stdout
        tc = {name: c for name, c in sass_counts(sass).items()
              if "flash_fwd_wgmma" in name}
        for name, c in tc.items():
            print(f"SASS of {name}: {c['HGMMA']} HGMMA, {c['UTMALDG']} "
                  f"UTMALDG", flush=True)
        if not tc or any(min(c.values()) == 0 for c in tc.values()):
            raise AssertionError(f"the bf16 flash kernel's SASS lacks "
                                 f"tensor-core or TMA instructions: {tc}")
        smem = build.load_library(source).flash_attention_bf16_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        for name, regs, stack, spill_st, spill_ld in ptxas_report(
                build.build_log(source)):
            dim = re.search(r"Li(\d+)E", name)
            extra = (f", {smem(int(dim[1]))} bytes of dynamic shared "
                     f"memory per block" if "wgmma" in name and dim else "")
            print(f"ptxas {name}: {regs} registers, {stack} bytes stack, "
                  f"{spill_st}/{spill_ld} bytes spill stores/loads{extra}",
                  flush=True)

    from repro_torch.configs import get_config
    from repro_torch.models.lm import (
        decode_step, head_logits, init_cache, init_params, lm_forward)
    from repro_torch.models.lm.config import dense_stages
    from repro_torch.serve import Request, ServeEngine

    lm_cfg = get_config(LM_ARCH)
    n_layers = lm_cfg.num_layers
    trng = np.random.default_rng(17)

    def tokens_of(shape):
        return torch.as_tensor(trng.integers(0, lm_cfg.vocab_size, shape),
                               device=dev)

    def last_logits(cfg, params, toks):
        return head_logits(cfg, params, lm_forward(cfg, params, toks)[:, -1])

    with phase("lm-prefill"), torch.no_grad():
        t0 = time.perf_counter()
        params = init_params(lm_cfg, torch.Generator(dev).manual_seed(0),
                             dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"{LM_ARCH}: {n_layers} layers, d_model {lm_cfg.d_model}, "
              f"{lm_cfg.num_heads} heads over {lm_cfg.num_kv_heads} kv "
              f"heads, head dim {lm_cfg.resolved_head_dim}, d_ff "
              f"{lm_cfg.d_ff}, vocab {lm_cfg.vocab_size}, {lm_cfg.dtype}: "
              f"{n_params} parameters initialised on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        toks = tokens_of((1, PREFILL_S))
        build.reset_launches()
        logits = last_logits(lm_cfg, params, toks)
        torch.cuda.synchronize()
        launches["flash_attention"] = build.launches.get("flash_attention",
                                                         0)
        print(f"prefill B=1 S={PREFILL_S}: logits {tuple(logits.shape)} "
              f"{logits.dtype}, max |logit| "
              f"{logits.float().abs().max().item():.4f}; flash_attention "
              f"launches {launches['flash_attention']} (want {n_layers}, "
              f"one per layer)", flush=True)
        if launches["flash_attention"] != n_layers:
            raise AssertionError(f"flash_attention launched "
                                 f"{launches['flash_attention']} times in "
                                 f"a {n_layers}-layer prefill")
        if logits.shape != (1, lm_cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise AssertionError("non-finite or misshapen prefill logits")
        ms = cuda_ms(torch, lambda: last_logits(lm_cfg, params, toks), 3)
        print(f"one prefill (lm_forward + head_logits, CUDA events, mean "
              f"of 3): {ms:.3f} ms, {PREFILL_S / ms * 1e3:.0f} tokens/s",
              flush=True)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            last_logits(lm_cfg, params, toks)
            torch.cuda.synchronize()
        split = device_time_split(prof, torch, LM_KINDS)
        total = sum(split.values())
        if total <= 0:
            raise AssertionError("the profiler recorded no device time")
        print("one prefill's device time (torch.profiler): " + ", ".join(
            f"{k} {v / 1e3:.3f} ms ({v / total * 100:.1f}%)"
            for k, v in split.items()) + f"; total {total / 1e3:.3f} ms",
            flush=True)
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=12), flush=True)
        # which side bounds a prefill: the host's time to enqueue one (no
        # synchronisation) against the device's busy share of it
        t0 = time.perf_counter()
        last_logits(lm_cfg, params, toks)
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        print(f"host enqueue of one prefill {enqueue:.3f} ms (host clock, "
              f"no synchronisation); the device busy "
              f"{total / 1e3 / ms * 100:.1f}% of the {ms:.3f} ms prefill",
              flush=True)
        serve_params = params
        del logits

    with phase("lm-card-vs-cpu"), torch.no_grad():
        # the same widths cut to 2 layers, f32 (TF32 is off)
        cfg2 = dataclasses.replace(lm_cfg, stages=dense_stages(2),
                                   dtype="float32")
        p2 = init_params(cfg2, torch.Generator(dev).manual_seed(1), dev)
        toks = tokens_of((1, 256))
        build.reset_launches()
        got = last_logits(cfg2, p2, toks)
        torch.cuda.synchronize()
        if build.launches.get("flash_attention", 0) != 2:
            raise AssertionError("the 2-layer card forward did not launch "
                                 "the flash kernel once per layer")
        cpu_p = tree_map(lambda t: t.cpu(), p2)
        want = last_logits(cfg2, cpu_p, toks.cpu())
        err = (got.cpu() - want).abs().max().item()
        print(f"2-layer f32 prefill S=256, card (flash kernel) vs CPU "
              f"(chunked_attention): logits max_abs_err {err:.3e}, max "
              f"|logit| {want.abs().max().item():.4f}", flush=True)
        torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=RTOL)
        del p2, cpu_p

    from repro_torch.models.lm import attention as lm_attention

    def plain_attention(q, k, v, causal=True, window=0, impl=None):
        return attention_ref(q, k, v, causal=causal, window=window)

    with phase("lm-decode"), torch.no_grad():
        cfg32 = dataclasses.replace(lm_cfg, dtype="float32")
        p32 = init_params(cfg32, torch.Generator(dev).manual_seed(0), dev)
        toks = tokens_of((2, 256))
        figures = {}
        for cfg, p in ((cfg32, p32), (lm_cfg, serve_params)):
            full = last_logits(cfg, p, toks).float()
            # the same prefill with its attention through the plain
            # attention_ref on the card: tells the kernel's share of the
            # decode-vs-prefill figure from the model's own
            with unittest.mock.patch.object(lm_attention, "flash_attention",
                                            plain_attention):
                plain = last_logits(cfg, p, toks).float()
            cache = init_cache(cfg, 2, 512, dev)
            t0 = time.perf_counter()
            for t in range(toks.shape[1]):
                logits, cache = decode_step(cfg, p, cache,
                                            toks[:, t:t + 1], t)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / toks.shape[1]
            scale = full.abs().max().item() + 1e-9
            err, err_plain, kernel_gap = (
                (a - b).abs().max().item() for a, b in (
                    (logits[:, 0].float(), full),
                    (logits[:, 0].float(), plain), (full, plain)))
            figures[cfg.dtype] = err / scale
            print(f"{cfg.dtype}: 256 teacher-forced decode steps (B=2, "
                  f"cache 512) vs prefill, last logits max_abs_err "
                  f"{err:.3e} / max |logit| {scale:.4f} = "
                  f"{err / scale:.3e}; against the prefill through "
                  f"attention_ref {err_plain / scale:.3e}; flash vs plain "
                  f"prefill logits {kernel_gap / scale:.3e}; "
                  f"{step_ms:.2f} ms per step (host clock)", flush=True)
            # what the card does in a decode step: kernels launched and
            # device time per step under the profiler, against the step's
            # wall time above (taken without the profiler)
            n_prof = 8
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for t in range(256, 256 + n_prof):
                    decode_step(cfg, p, cache, toks[:, :1], t)
                torch.cuda.synchronize()
            acts = list(device_events(prof))
            kernels = sum(n for _, n, _ in acts) / n_prof
            busy = sum(us for _, _, us in acts) / 1e3 / n_prof
            print(f"{cfg.dtype} decode step (torch.profiler, {n_prof} "
                  f"steps): {kernels:.0f} device kernels and copies, "
                  f"{busy:.3f} ms of device time per step; device busy "
                  f"{busy / step_ms * 100:.1f}% of the {step_ms:.2f} ms "
                  f"step", flush=True)
            del cache
        if not figures["float32"] < DECODE_REL:
            raise AssertionError(f"f32 decode diverges from prefill: "
                                 f"{figures['float32']:.3e}")
        del p32

    with phase("lm-serve"), torch.no_grad():
        srng = np.random.default_rng(23)
        prompts = [srng.integers(0, lm_cfg.vocab_size,
                                 int(srng.integers(32, 65))).astype(np.int32)
                   for _ in range(8)]
        reqs = [Request(prompt=pr, max_new_tokens=16) for pr in prompts]
        eng = ServeEngine(lm_cfg, serve_params, num_slots=4, max_len=512,
                          device=dev)
        build.reset_launches()
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        new = sum(len(r.out_tokens) for r in reqs)
        print(f"ServeEngine {LM_ARCH} bf16, 4 slots, max_len 512: "
              f"{stats['completed']}/8 requests, {stats['evicted']} "
              f"evicted, {stats['steps']} steps in {stats['time_s']:.3f} s "
              f"(host clock), {stats['time_s'] * 1e3 / stats['steps']:.2f} "
              f"ms per step, {new / stats['time_s']:.1f} generated "
              f"tokens/s; flash_attention launches "
              f"{build.launches.get('flash_attention', 0)} (decode runs "
              f"none)", flush=True)
        if stats["completed"] != 8 or stats["evicted"] != 0:
            raise AssertionError(f"serving left requests unfinished: "
                                 f"{stats}")
        if not all(len(r.out_tokens) == 16 and all(
                0 <= t < lm_cfg.vocab_size for t in r.out_tokens)
                for r in reqs):
            raise AssertionError("bad generated tokens")
        # slots are independent: the first request alone in a fresh
        # engine gets the same tokens
        alone = Request(prompt=prompts[0], max_new_tokens=16)
        ServeEngine(lm_cfg, serve_params, num_slots=4, max_len=512,
                    device=dev).run([alone])
        print(f"request 0: {reqs[0].out_tokens}; alone: "
              f"{alone.out_tokens}", flush=True)
        if alone.out_tokens != reqs[0].out_tokens:
            raise AssertionError("request 0's tokens depend on its "
                                 "neighbours in the batch")
        del serve_params, params, eng

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
