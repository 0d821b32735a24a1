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
              instantiation that streams by them (fatal if absent); the
              registers and spills of the flash kernels' head-dim-256
              instantiations (fatal if one spills).
3. kernels-random — both block-CSR SpMM kernels and the fused kernel's
              pattern mode (``(A != 0) @ x``, GraphSAGE's neighbour sum),
              forward and backward (through ``spmm_bcsr_sym``; B 1-128, F
              40/128/256/300, an all-zero slot, column tiles outside x, a
              NaN x row that reaches only its readers, two calls bitwise
              equal; in pattern mode a NaN value counted as 1), and the
              row gather (f32 and bf16,
              rows that do and do not take 16-byte vectors, ids outside the
              table) and flash attention (f32 and bf16, causal or not,
              window 0 or 64, S 128/200/4095, D 64/128, GQA 1 or 4; and
              at D 256 window 0/64/2048, GQA 1/4/10 over one kv head) against
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
              (``configs/gnn_gcn.CONFIG``: hidden 256, 3 layers, dropout
              0.3, Adam) for 2 epochs on the
              train Plan under ``backend="bcsr"``; exact SpMM launch count,
              finite losses, parameters moved, one train step on the card
              against the same step on the CPU, and one step's device time
              split by ``torch.profiler``.
7. entry-points — the unfused SpMM (forward and backward over every train
              batch) and the row gather (every train batch's features from
              the feature table) through their own entry points.
8. serve    — ``GNNInferenceEngine`` on the test Plan under
              ``backend="bcsr"``, then ``backend="auto"``.
8a. sage    — the paper's GraphSAGE (``configs/gnn_sage.CONFIG``: hidden
              256, 3 layers, dropout 0.3) under a fixed bcsr policy: ``fit``
              2 epochs with the exact count of pattern-kernel launches (and
              none of the weighted kernel), one step card against CPU, one
              step's device time split, the test Plan served (card logits
              against CPU logits, query p50/p95), and the pattern kernel
              on train and test batch 0 at F = 128 and 256 against its
              plain version, timed beside its bound, the weighted kernel
              and ``sparse_bsr_tensor`` of the binary nonzero tiles @ x.
8b. gat     — the paper's GAT (``configs/gnn_gat.CONFIG``: hidden 128, 4
              heads, 3 layers, dropout 0.3) on the segment path: ``fit`` 2
              epochs with no SpMM launch, one step card against CPU, the
              test Plan served against the CPU, one step's device time.
8c. refresh-swap — the GCN serves every test batch under bcsr (filling
              the LRU), a seeded ``GraphDelta`` (64 feature rows, 32 edge
              inserts among test nodes) goes through ``pipe.refresh``
              (timed beside a from-scratch ``plan()``) and
              ``GNNInferenceEngine.swap``: untouched batches answer
              bit-identically from the LRU, dirty ones run on the card and
              match a fresh engine on a from-scratch plan; a second,
              feature-only refresh confined to one batch's own outputs
              keeps the other batches in the LRU; a plan with damaged
              routing is refused and rolled back, and the engine answers
              bit-identically to before.
8d. data-parallel — the GCN of phase train over a ``DataMesh`` of world
              4 (4 cards when the machine has them, else the card four
              times) under a fixed bcsr policy: ``fit(mesh=...)`` 2 epochs
              (3 super-steps per epoch, one pad) bitwise the single-device
              ``grad_accum=4`` fit and within 1e-4 of the same mesh fit on
              the CPU, the exact SpMM launch count (pads included), the
              seconds per epoch of both fits and the host seconds in
              ``stack_batches``; ``executor.evaluate`` bitwise the single-
              device evaluation; ``GNNInferenceEngine(mesh=...)`` on the
              test Plan: 64 cold queries of 16 ids bitwise the single-
              device engine with the exact super-step and launch counts,
              then a swap to a second parameter set bitwise a fresh
              engine on it.
8e. influence — ``exact_influence`` (``torch.func.jacrev``) of a random
              full-width GCN over the whole arxiv-like graph (segment
              aggregation) for 4 seeded PPR roots of the test Plan: the
              card's within 1e-4 of the largest influence of the CPU's
              (computed over each root's 3-hop ball, where all of its
              influence lies; the card's must be 0 outside it), and PPR's
              stored top-k ranking those nodes like the influence (mean
              Spearman above 0.5); seconds and peak card memory.
8f. ooc     — the serving tiers, the GCN under a fixed bcsr policy on the
              test Plan: ``pipe.plan(out_of_core=True)`` streams it into a
              ``PlanStore`` (chunks of 1 batch), held to the resident Plan
              bit for bit; 32 cold queries from ``as_plan(resident_batches=
              1)`` on the card bit-identical to the resident engine
              (latency, ``ooc_stats``); a 2-shard build behind a
              ``ShardRouter`` answers them bit-identically too.
8g. async   — ``AsyncGNNEngine`` (worker thread, ``SystemClock``) with a
              resident tenant (v1 of refresh-swap's chain) and an
              out-of-core one (the store): 256 seeded requests, 32 with a
              deadline, the resident tenant swapped to v2 mid-stream; every
              answer bit-identical to the synchronous engine on its plan
              version, rows of untouched batches unchanged by the swap, and
              no reject, expiry, failure, retry, breaker open or restart.
8h. async-faults — the same tier under a scripted ``FaultInjector``, one
              request at a time: retried and failing forwards, a breaker
              that opens on one tenant while the other serves and closes on
              the half-open probe, a worker death the watchdog restarts, a
              50 ms dispatch stall, a ``batch_io`` read retry; counters
              exact, answers bit-identical to the healthy path; then
              ``plan_io`` on ``Plan.save`` and ``Plan.load`` (the old file
              intact). From 8f to here the SpMM launches equal 3 x the
              batch forwards of every engine these phases ran.
9. flash-real — the flash-attention kernel at the llama3.2-1b prefill
              shape (B=1, 32 heads over 8 kv heads, S=4096, head dim 64,
              causal) in bf16 and in f32 against the plain version, then
              its bf16 time beside the bound, the plain version and
              ``scaled_dot_product_attention`` (the yardstick only); the
              bf16 kernel's SASS must hold tensor-core (HGMMA) and TMA
              (UTMALDG) instructions; its registers, spills and shared
              memory per block from the build.
9a. flash-256 — the kernel at recurrentgemma-2b's local layers (B=1, 10
              heads over 1 kv head, S=4096, head dim 256, causal, window
              2048) in bf16 and f32 against the plain version, then its
              bf16 time beside the bound, the plain version and
              ``scaled_dot_product_attention`` on expanded K/V with the
              window as a mask (the yardstick only).
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
14. checkpoint — ``Checkpointer`` round trips on the card: the GCN's
              trained parameters and Adam state (from phase train), and
              llama3.2-1b's bf16 parameters (from lm-prefill, stored as
              ``V2`` bits), every leaf restored bit for bit (save and
              restore seconds); ``ckpt_io`` on a background save re-raised
              by ``wait``; a corrupt newest step and ``auto_resume`` falls
              back to the older one.
15. lm-archs — deepseek-v2-lite-16b (MLA + MoE), recurrentgemma-2b (RG-LRU
              + local attention at head dim 256) and rwkv6-3b at full
              width and depth in bf16, each in turn and freed before the
              next: ``init_params`` on the card, ``lm_forward`` and
              ``head_logits`` at B=1, S=4096 with finite logits and the
              exact flash launches (8 at head dim 256 for recurrentgemma,
              none for the others), the forward's time and device time
              split (flash, the MoE's routing/dispatch/combine, the
              recurrences' scans, GEMMs, rest) and the peak memory.
16. lm-archs-card-vs-cpu — each at full width, cut in depth, in f32: the
              card's logits against the CPU path's (deepseek 1 dense + 1
              MoE layer at S=256 with assignments dropped; recurrentgemma
              one (R, R, A) superblock at S=4096, so that the window
              binds; rwkv6 2 layers at S=256).
17. lm-archs-decode — 64 teacher-forced ``decode_step``s (B=2, f32)
              against the prefill's last logits at the reference's 2e-2:
              deepseek cut to 4 layers at a capacity factor (11) under
              which the prefill drops nothing, recurrentgemma at full
              depth with its softcap at 0, rwkv6 at full depth; printed
              beside them, deepseek at its config's 1.25 with the
              prefill's dropped assignments, and recurrentgemma with its
              softcap of 30, which the reference's local prefill leaves
              out.
18. lm-archs-serve — ``ServeEngine`` (4 slots, max_len 512) serves 8
              seeded requests for each of the three at full width in
              bf16; all complete, none evicted, request 0's tokens equal
              those it gets alone.
19. lm-frontends — musicgen-large (4-codebook tokens, exactly 48 flash
              launches, 4 decode steps of (2, 1, 4) tokens) and
              internvl2-1b (a 256-row ``prefix_embeds`` before 4096 text
              tokens, 24 flash launches) at full width in bf16, then each
              cut to 2 layers in f32 with the card's logits against the
              CPU's.
20. lm-train — the LM main path in training: the full llama3.2-1b (bf16)
              through ``repro_torch.launch.train.train_loop`` with the
              reference launcher's defaults (B=8, S=256, AdamW at lr 3e-4,
              remat): 6 steps with a checkpoint after step 3 and exactly 32
              flash launches a step (each layer's forward, and again in
              remat's recompute; the backward differentiates the plain
              attention), a run resumed from the checkpoint against the
              uninterrupted one, before them 5 steps with no checkpoint
              (the step time and tokens/s), 2 steps on one repeated batch
              (the loss falls; the flash kernel's inputs from these steps,
              B=8 S=256 H=32 KV=8 D=64 bf16, through the kernel against
              ``plain_attention`` in f32), one step's device time split
              (flash forward, attention backward recompute, GEMMs, xent,
              optimizer, rest), 2 steps with ``--compress``; peak memory.
21. lm-train-card-vs-cpu — its first 2 layers at full width in f32, B=1,
              S=256: the loss and every gradient leaf, card against CPU,
              with the CPU's float64 witness (tests/_lm_grad.py's rule).
22. lm-archs-train — one train step (forward, backward, AdamW) per family,
              each freed before the next: recurrentgemma-2b (B=1, S=4096:
              the window binds, the head-dim-256 kernel runs), rwkv6-3b
              (S=512), musicgen-large, internvl2-1b (256-row prefix), the
              first two layers of deepseek-v2-lite-16b and deepseek-v3's
              SMOKE config (MTP): finite loss and gradients, exact flash
              launches, the flash kernel on each model's own inputs
              against ``plain_attention`` in f32, step time, peak memory
              beside the bytes reckoned.
              Phases 15–22 are module functions (``lm_archs_phase`` and
              its siblings) that rehearse on the CPU with the SMOKE
              configs.
23. mesh-card — llama3.2-1b on a world-1 (1, 1) ``DeviceMesh``: prefill,
              decode steps and a train step bitwise the unsharded runs,
              the flash kernel under ``local_map`` (``mesh_card_phase``).
24. moe-mesh — deepseek-v2-lite-16b's MoE layer at full width on a (1, 1)
              ``DeviceMesh`` through the DTensor einsum dispatch and the
              expert-parallel path on DTensors (funcol all-to-alls inside
              ``local_map``), each against the unsharded layer
              (``moe_mesh_phase``).
25. moe-ep — the same layer through ``dispatch="shmap"`` over a world-4
              ``DataMesh`` on the card, with and without drops
              (``moe_ep_phase``).
26. dryrun — the CPU dry run started beside the card phases
              (``start_dryrun``): llama3.2-1b at every shape, the GCN,
              deepseek-v2-lite-16b's and rwkv6-3b's prefill_32k (mesh
              single), each command's wall clock, and the SMOKE sweep of
              the ten LM archs on a fake (4, 4) group under this
              machine's torch (``smoke_sweep``), fatal on any cell's
              error; then the one-card anchor (``dryrun_phase``).
27. examples — the port's eight examples (``repro_torch.examples``), each
              ``main`` in-process on the card (``EXAMPLES``; the GNN ones
              under ``--backend bcsr``, serve_lm at llama3.2-1b's full
              config in bf16): seconds and launches, each fit's exact
              ``spmm_bcsr`` count and above 0 on every bcsr example; the
              weight-independent figures (fingerprints, batch counts and
              bytes, engine and LRU counters, the refresh audit and swap,
              out-of-core loads and shards) equal to the same examples run
              on the CPU in a subprocess beside the LM phases
              (``start_examples_cpu``); the card's trained weights served
              and evaluated on the CPU within ATOL; serve_lm's tokens
              equal in a second run, and one prefill of what it served
              (16 flash launches, the kernel held on its own inputs)
              (``examples_phase``).

Every card-vs-CPU train step (phases train, sage, gat) holds each gradient
element within ATOL and RTOL but one that a ReLU or LeakyReLU kink explains
(``tests/_kinks.py``; ``step_vs_cpu``).

The second-to-last line is a JSON ``kernels`` record and the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""
import atexit
import contextlib
import ctypes
import dataclasses
import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
import types
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
    # the same kernel's pattern mode: the reference runs the fused kernel
    # on materialised binary tiles (src/repro/models/gnn/ops.py:177-182)
    "spmm_bcsr_pattern": ("src/repro_torch/kernels/csrc/spmm_bcsr.cu",
                          "src/repro/kernels/spmm/fused.py:96"),
    "spmm_bcsr_unfused": ("src/repro_torch/kernels/csrc/spmm_bcsr_unfused.cu",
                          "src/repro/kernels/spmm/spmm.py:37"),
    "gather_rows": ("src/repro_torch/kernels/csrc/gather_rows.cu",
                    "src/repro/kernels/gather_rows/gather_rows.py:29"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:81"),
    # the same kernels' head-dim-256 instantiations (the bf16 one a block
    # of one consumer warpgroup), counted apart: recurrentgemma's local
    # layers
    "flash_attention_d256": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:81"),
}
SPMM_IMPLS = {"spmm_bcsr": "cuda", "spmm_bcsr_unfused": "cuda_unfused"}

# ogbn-products' node features: 2,449,029 nodes × 100 f32
PRODUCTS_NODES, PRODUCTS_FEATURES, GATHER_IDS = 2_449_029, 100, 1 << 20

# clock cycles ``queued_ms`` holds the card for (about 50 ms on an H100)
HOLD_CYCLES = 100_000_000

# queries the mesh engine answers after its swap, against a fresh engine
SWAP_QUERIES = 8
# the learning rate of the mesh fit held card against CPU: large enough
# that the 6 updates move the parameters by about 1e-2, far above ATOL
CPU_FIT_SGD_LR = 0.1

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


def is_pattern_kernel(key: str) -> bool:
    """Whether a profiler key names a pattern-mode instantiation of the
    fused SpMM kernel (``spmm_bcsr_kernel<T, kBulk, true>``)."""
    return re.search(r"spmm_bcsr_kernel<\d+, \w+, true>", key) is not None


SAGE_KINDS = (("staging", lambda k: "Memcpy HtoD" in k),
              ("spmm_bcsr_pattern", is_pattern_kernel))
GAT_KINDS = (("staging", lambda k: "Memcpy HtoD" in k),
             ("index_add/scatter", lambda k: any(
                 w in k.lower() for w in ("index", "scatter"))),
             ("gemm", lambda k: any(w in k.lower() for w in (
                 "gemm", "nvjet", "xmma", "cutlass", "matmul"))))
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


def attention_bound_ms(b, h, kv, s, d, causal, elem, peak_flops, peak_bw,
                       window=0):
    """Least time for one attention call: q, k and v read once and the
    output written once, against the operations the mask leaves (two
    products of 2·D flops per visible (query, key) pair; with a window W,
    a causal query i sees min(i + 1, W) keys)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    if causal and 0 < window < s:
        pairs = window * (window + 1) // 2 + (s - window) * window
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
    spills or an instantiation that streams by bulk copies has none (its
    template arguments open ``<T, kBulk = true``: ``ILi<T>ELb1E`` in the
    mangled name, whatever follows, as the pattern flag does in
    ``spmm_bcsr.cu``)."""
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
            if re.search(r"ILi\d+ELb1E", name)}
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


def same_bytes(np, a, b) -> bool:
    """Two arrays of the same dtype and shape, bit for bit."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def same_tensor_bits(torch, a, b) -> bool:
    """Two tensors of the same dtype, shape and device type, bit for bit."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.device.type == b.device.type and torch.equal(
                a.detach().reshape(-1).view(torch.uint8),
                b.detach().reshape(-1).view(torch.uint8)))


def du_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(path) for f in files)


def check_same_plan(np, got, want, what: str) -> None:
    """Fingerprint, schedule, routing, membership, decisions and every
    batch field (through the verified per-batch read) bit for bit."""
    if got.fingerprint != want.fingerprint:
        raise AssertionError(f"{what}: fingerprint {got.fingerprint} != "
                             f"{want.fingerprint}")
    for name, a, b in (
            ("schedule", got.schedule, want.schedule),
            ("node_ids", got.node_ids, want.node_ids),
            ("batch_backend", got.batch_backend, want.batch_backend),
            ("batch_block_f", got.batch_block_f, want.batch_block_f),
            *((f"routing.{f}", getattr(got.routing, f),
               getattr(want.routing, f)) for f in ("node_ids", "batch",
                                                   "row"))):
        if not same_bytes(np, a, b):
            raise AssertionError(f"{what}: {name} differs")
    if len(got) != len(want) or got.cache.meta != want.cache.meta:
        raise AssertionError(f"{what}: batch counts differ")
    for i in range(len(want)):
        a, b = got.cache[i], want.cache[i]
        if sorted(a) != sorted(b) or not all(same_bytes(np, a[k], b[k])
                                             for k in b):
            raise AssertionError(f"{what}: batch {i} differs")


def ooc_phase(ctx) -> None:
    """Stream the test plan into a PlanStore, hold it to the resident plan
    bit for bit, serve cold queries from it with a one-batch budget and
    through a 2-shard router on the card, against the resident engine."""
    import numpy as np
    from repro_torch.core import IBMBPipeline
    from repro_torch.ooc import OOCConfig, PlanStore, ShardRouter, build_shards
    from repro_torch.serve import GNNInferenceEngine

    opipe = IBMBPipeline(ctx.ds, ctx.pipe_cfg)   # the graph before refresh
    ctx.store_dir = os.path.join(ctx.work, "store")
    t0 = time.perf_counter()
    lazy = opipe.plan("test", for_inference=True, out_of_core=True,
                      store_dir=ctx.store_dir,
                      ooc=OOCConfig(chunk_batches=1, resident_batches=1))
    stream_s = time.perf_counter() - t0
    check_same_plan(np, lazy, ctx.plan, "streamed test plan")
    print(f"streamed test plan: {len(lazy)} batches, bit-identical to the "
          f"resident plan (fingerprint {lazy.fingerprint}, every batch "
          f"field); store {du_bytes(ctx.store_dir)} bytes on disk "
          f"(payload {lazy.cache.nbytes()}); built in {stream_s:.3f} s "
          f"against {ctx.plan_s:.3f} s for the resident plan() (host "
          f"clock, both with their PPR)", flush=True)

    sync = GNNInferenceEngine(ctx.plan, ctx.cfg, ctx.params,
                              cache_batches=len(ctx.plan), device=ctx.dev)
    cold = GNNInferenceEngine(
        PlanStore.open(ctx.store_dir).as_plan(resident_batches=1), ctx.cfg,
        ctx.params, cache_batches=0, device=ctx.dev)
    ctx.engines += [sync, cold]
    lat = []
    for q in ctx.queries:
        t0 = time.perf_counter()
        got = cold.query(q)
        lat.append(time.perf_counter() - t0)
        if got.tobytes() != sync.query(q).tobytes():
            raise AssertionError("a lazy answer differs from the resident "
                                 "engine's")
    p50, p95 = np.percentile(np.array(lat) * 1e3, [50, 95])
    print(f"lazy engine (resident_batches=1, no output LRU): "
          f"{len(ctx.queries)} cold queries of 16 ids bit-identical to the "
          f"resident engine on the card; latency p50 {p50:.2f} ms p95 "
          f"{p95:.2f} ms (host clock); {cold.stats['batch_runs']} batch "
          f"runs; ooc_stats {json.dumps(cold.ooc_stats())}", flush=True)
    if cold.ooc_stats()["resident"] > 1 or cold.stats["lru_hits"]:
        raise AssertionError(f"budget broken: {cold.ooc_stats()}")

    root = os.path.join(ctx.work, "shards")
    t0 = time.perf_counter()
    man = build_shards(opipe, "test", 2, root, for_inference=True,
                       ooc=OOCConfig(chunk_batches=1))
    shard_s = time.perf_counter() - t0
    router = ShardRouter.load(root, ctx.cfg, ctx.params, device=ctx.dev)
    ctx.engines += [sh.engine for sh in router.shards.values()]
    hits = []
    for q in ctx.queries:
        if router.query(q).tobytes() != sync.query(q).tobytes():
            raise AssertionError("a shard-routed answer differs from the "
                                 "resident engine's")
        hits.append(router.shards_hit(q))
    snap = router.snapshot()
    spans = dict(zip(*(v.tolist() for v in np.unique(hits,
                                                     return_counts=True))))
    print(f"2 shards ({[sh['num_batches'] for sh in man['shards']]} "
          f"batches, chain {man['chain']}) built in {shard_s:.3f} s, "
          f"{du_bytes(root)} bytes; {len(ctx.queries)} routed queries "
          f"bit-identical to the resident engine; shards_hit per query "
          f"{spans}; router "
          f"{ {k: snap[k] for k in ('requests', 'nodes', 'shard_misses')} }",
          flush=True)
    if max(hits) < 2:
        raise AssertionError("no query spanned both shards")
    shutil.rmtree(root)


def serve_config(AsyncServeConfig):
    """The tier's policy in both async phases: one retry, a breaker after
    two failed windows, 300 ms of cooldown."""
    return AsyncServeConfig(max_retries=1, breaker_threshold=2,
                            breaker_cooldown_us=300_000.0)


def async_phase(ctx) -> None:
    """256 requests through the threaded async tier (SystemClock), half to
    a resident tenant and half to an out-of-core one, with a swap of the
    resident tenant mid-stream; every answer bit-identical to the
    synchronous engine on the same plan version, and no degradation
    machinery touched."""
    import numpy as np
    from repro_torch.ooc import PlanStore
    from repro_torch.serve import (AsyncGNNEngine, AsyncServeConfig,
                                   GNNInferenceEngine, SystemClock)

    def engine(plan, lru):
        e = GNNInferenceEngine(plan, ctx.cfg, ctx.params, cache_batches=lru,
                               device=ctx.dev)
        ctx.engines.append(e)
        return e

    ctx.sync = {v: engine(p, len(p)) for v, p in (
        (0, ctx.plan), (1, ctx.child), (2, ctx.grand))}
    lazy = PlanStore.open(ctx.store_dir).as_plan(resident_batches=1)
    tier = AsyncGNNEngine({"resident": engine(ctx.child, 0),
                           "ooc": engine(lazy, 0)},
                          serve_config(AsyncServeConfig),
                          clock=SystemClock(), start=True)
    rng = np.random.default_rng(37)
    deadline = set(rng.choice(256, 32, replace=False).tolist())
    sent = []

    def submit(i):
        tenant = ("resident", "ooc")[i % 2]
        ids = rng.choice(ctx.plan.routing.node_ids, 16, replace=False)
        sent.append((i, tenant, ids, tier.submit(
            tenant, ids, deadline_ms=60_000.0 if i in deadline else None)))

    try:
        t0 = time.perf_counter()
        for i in range(128):
            submit(i)
        for i, tenant, ids, fut in sent:     # the resident half drains; the
            if tenant == "resident":         # out-of-core tenant may still
                fut.result(timeout=300.0)    # be in flight across the swap
        swap = tier.swap("resident", ctx.grand, ctx.audit2)
        for i in range(128, 256):
            submit(i)
        answers = [fut.result(timeout=300.0) for *_rest, fut in sent]
        wall = time.perf_counter() - t0
    finally:
        tier.close()
    dirty = np.asarray(ctx.audit2.dirty)
    untouched_rows = 0
    for (i, tenant, ids, fut), got in zip(sent, answers):
        version = 0 if tenant == "ooc" else (1 if i < 128 else 2)
        if got.tobytes() != ctx.sync[version].query(ids).tobytes():
            raise AssertionError(f"request {i} ({tenant}) differs from the "
                                 f"synchronous engine on plan v{version}")
        if version == 2:                     # rows of untouched batches:
            keep = ~np.isin(ctx.grand.routing.lookup(ids)[0], dirty)
            if got[keep].tobytes() != \
                    ctx.sync[1].query(ids)[keep].tobytes():
                raise AssertionError(f"request {i}: an untouched batch's "
                                     f"rows changed across the swap")
            untouched_rows += int(keep.sum())
    snap = tier.snapshot()
    bad = {k: snap[k] for k in ("rejected", "expired", "failed",
                                "window_errors") if snap[k]}
    bad.update({k: v for k, v in snap["faults"].items() if v})
    if bad or snap["completed"] != 256:
        raise AssertionError(f"the healthy path degraded: {bad}, "
                             f"completed {snap['completed']}")
    print(f"async tier: 256 requests (128 per tenant, 32 with a 60 s "
          f"deadline) bit-identical to the synchronous engine on each "
          f"plan version; swap of 'resident' v1 -> v2 mid-stream {swap}, "
          f"{untouched_rows} rows of untouched batches bit-identical across "
          f"it; windows {snap['windows']}, mean requests per window "
          f"{snap['mean_window_requests']:.2f}, last window's occupancy "
          f"{snap['window_occupancy']:.3f}, latency p50 "
          f"{snap['p50_us'] / 1e3:.2f} ms p95 {snap['p95_us'] / 1e3:.2f} ms "
          f"(SystemClock), {256 / wall:.1f} requests/s over {wall:.3f} s; "
          f"rejects, expirations, failures, retries, breaker opens and "
          f"worker restarts all 0; ooc tenant "
          f"{json.dumps(snap['tenants']['ooc']['ooc'])}", flush=True)


def async_faults_phase(ctx) -> None:
    """The same tier under a scripted FaultInjector, one request at a
    time: forward faults a retry absorbs, two failed windows that open the
    out-of-core tenant's breaker while the resident tenant serves, a
    worker death the watchdog restarts, a dispatch stall, a batch_io fault
    a read retry absorbs, and the half-open probe that closes the breaker;
    then plan_io on a Plan.save."""
    import numpy as np
    from repro_torch.core import IBMBConfig, IBMBPipeline, Plan
    from repro_torch.faults import FaultInjector, InjectedFault, WorkerDeath
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.ooc import PlanStore
    from repro_torch.serve import (AsyncGNNEngine, AsyncServeConfig,
                                   GNNInferenceEngine, ServeUnavailable,
                                   SystemClock)

    # call indices per point, one request at a time (the reference's
    # FakeClock tests of tests/test_faults.py read the same way): forward
    # 0 (A, retried), 2-3 (B), 4-5 (C); step 4 (F) dies; dispatch 4 (G)
    # stalls; read 1 (the probe H's first miss; read 0 is the engine's
    # check of batch 0)
    inj = FaultInjector(seed=41, script={
        "forward": [0, 2, 3, 4, 5], "worker_death": [4],
        "dispatch_delay": [4], "batch_io": [1]},
        delays={"dispatch_delay": 0.05})
    store = PlanStore.open(ctx.store_dir, faults=inj, io_retries=2)
    tenants = {
        "resident": GNNInferenceEngine(ctx.grand, ctx.cfg, ctx.params,
                                       cache_batches=0, device=ctx.dev),
        "ooc": GNNInferenceEngine(store.as_plan(resident_batches=1), ctx.cfg,
                                  ctx.params, cache_batches=0,
                                  device=ctx.dev)}
    ctx.engines += list(tenants.values())
    tier = AsyncGNNEngine(tenants, serve_config(AsyncServeConfig),
                          clock=SystemClock(), faults=inj, start=True)
    rng = np.random.default_rng(43)
    healthy = {"resident": ctx.sync[2], "ooc": ctx.sync[0]}
    log = []

    def one(name, tenant, want):
        ids = rng.choice(ctx.plan.routing.node_ids, 16, replace=False)
        fut = tier.submit(tenant, ids)
        if not fut.wait(300.0):
            raise AssertionError(f"{name}: the future did not terminate")
        exc = fut.exception(0)
        if want is None:
            if exc is not None:
                raise AssertionError(f"{name}: {exc!r}")
            if fut.result(0).tobytes() != healthy[tenant].query(ids) \
                    .tobytes():
                raise AssertionError(f"{name}: differs from the healthy "
                                     f"path")
        elif not isinstance(exc, want):
            raise AssertionError(f"{name}: want {want.__name__}, got "
                                 f"{exc!r}")
        log.append(f"{name} {tenant} "
                   f"{'ok' if exc is None else type(exc).__name__} "
                   f"{fut.latency_s * 1e3:.1f} ms")
        return fut

    try:
        one("A", "resident", None)               # absorbed by a retry
        one("B", "ooc", InjectedFault)           # retries exhausted
        one("C", "ooc", InjectedFault)           # ... again: breaker opens
        one("D", "ooc", ServeUnavailable)        # fast reject while open
        one("E", "resident", None)               # the other tenant serves
        one("F", "resident", WorkerDeath)        # the watchdog restarts
        g = one("G", "resident", None)           # a 50 ms stall
        time.sleep(0.35)                         # past the cooldown
        one("H", "ooc", None)                    # half-open probe closes it
    finally:
        tier.close()
    snap = tier.snapshot()
    want_faults = dict(retries=3, fast_rejects=1, worker_restarts=1,
                       breaker_opens=1, breaker_closes=1, swap_rollbacks=0)
    want_stats = dict(submitted=8, accepted=7, rejected_unavailable=1,
                      completed=4, failed=3, window_errors=2, windows=6,
                      expired=0)
    got_faults = {k: snap["faults"][k] for k in want_faults}
    got_stats = {k: snap[k] for k in want_stats}
    fired = {k: v["fired"] for k, v in snap["faults"]["injected"].items()}
    io = snap["tenants"]["ooc"]["ooc"]
    print(f"async under faults: {'; '.join(log)}; fault_stats {got_faults}; "
          f"stats {got_stats}; injected {fired}; ooc tenant io_retries "
          f"{io['io_io_retries']}; breakers "
          f"{ {n: t['breaker']['state'] for n, t in snap['tenants'].items()} }",
          flush=True)
    if got_faults != want_faults or got_stats != want_stats or fired != \
            {"forward": 5, "worker_death": 1, "dispatch_delay": 1,
             "batch_io": 1} or io["io_io_retries"] != 1 or \
            g.latency_s < 0.05:
        raise AssertionError("the fault script did not play out as the "
                             "reference's semantics say")

    # plan_io: a failed save leaves the old artifact as it was
    tiny = IBMBPipeline(get_dataset("tiny"), IBMBConfig(
        variant="node", backend="bcsr", k_per_output=8,
        max_outputs_per_batch=16, pad_multiple=32)).plan(
        "test", for_inference=True)
    path = os.path.join(ctx.work, "plan.npz")
    pio = FaultInjector(script={"plan_io": [1, 2]})
    tiny.save(path, faults=pio)
    with open(path, "rb") as f:
        before = f.read()
    for what, call in (("save", lambda: tiny.save(path, faults=pio)),
                       ("load", lambda: Plan.load(path, faults=pio))):
        try:
            call()
        except OSError as e:
            print(f"plan_io on Plan.{what}: {e}", flush=True)
        else:
            raise AssertionError(f"plan_io did not fire in Plan.{what}")
    with open(path, "rb") as f:
        if f.read() != before or os.path.exists(path + ".tmp"):
            raise AssertionError("a failed Plan.save touched the old file")
    check_same_plan(np, Plan.load(path, faults=pio), tiny, "reloaded plan")
    print("the old plan file intact and loadable after the failed save",
          flush=True)


def checkpoint_phase(ctx) -> None:
    """Round-trip the GCN's trained parameters and Adam state, and
    llama3.2-1b's bf16 parameters, through the checkpointer on the card;
    a ckpt_io fault on a background save, and a corrupt newest step."""
    import torch
    from repro_torch.checkpoint import (Checkpointer, CheckpointError,
                                        all_steps)
    from repro_torch.faults import FaultInjector, corrupt_file
    from repro_torch.optim import tree_leaves, tree_map

    def round_trip(name, tree, directory, keep):
        ck = Checkpointer(directory, keep=keep)
        t0 = time.perf_counter()
        ck.save(tree, 1, extra={"what": name})        # in the background
        snap_s = time.perf_counter() - t0
        ck.wait()
        write_s = time.perf_counter() - t0 - snap_s
        template = tree_map(torch.zeros_like, tree)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, manifest = ck.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        leaves, got = tree_leaves(tree), tree_leaves(out)
        if len(got) != len(leaves) or not all(
                same_tensor_bits(torch, a, b) for a, b in zip(got, leaves)):
            raise AssertionError(f"{name}: a restored leaf differs")
        n = sum(t.numel() for t in leaves)
        print(f"checkpoint {name}: {len(leaves)} leaves, {n} values "
              f"({sorted({str(t.dtype) for t in leaves})}), "
              f"{du_bytes(directory)} bytes on disk; save: snapshot to the "
              f"host {snap_s:.3f} s, background write {write_s:.3f} s; "
              f"restore onto the card {restore_s:.3f} s; every leaf "
              f"bit-identical (manifest dtypes "
              f"{sorted(set(manifest['dtypes'].values()))})", flush=True)
        return ck

    gcn = {"params": ctx.gcn_params, "opt": ctx.gcn_opt}
    ck = round_trip("GCN params + Adam state", gcn,
                    os.path.join(ctx.work, "ckpt_gcn"), keep=2)
    round_trip(f"{ctx.lm_name} bf16 params", ctx.lm_params,
               os.path.join(ctx.work, "ckpt_lm"), keep=1)
    shutil.rmtree(os.path.join(ctx.work, "ckpt_lm"))

    bad = Checkpointer(os.path.join(ctx.work, "ckpt_fault"),
                       faults=FaultInjector(script={"ckpt_io": [0]}))
    bad.save(gcn, 1)                                  # in the background
    try:
        bad.wait()
    except CheckpointError as e:
        print(f"ckpt_io on a background save, re-raised by wait(): {e}",
              flush=True)
    else:
        raise AssertionError("a failed background save went unreported")
    if all_steps(bad.directory):
        raise AssertionError("a failed save left a checkpoint behind")

    later = tree_map(lambda t: t + 1 if t.is_floating_point() else t, gcn)
    ck.save(later, 2, blocking=True)
    corrupt_file(os.path.join(ck.directory, "step-00000002", "shard-0.npz"),
                 seed=2, nbytes=8)
    out, manifest = ck.auto_resume(tree_map(torch.zeros_like, gcn))
    if manifest["step"] != 1 or not all(
            same_tensor_bits(torch, a, b) for a, b in
            zip(tree_leaves(out), tree_leaves(gcn))):
        raise AssertionError(f"auto_resume did not fall back to step 1: "
                             f"step {manifest['step']}")
    print(f"corrupt newest step 2: auto_resume fell back to step "
          f"{manifest['step']}, bit-identical", flush=True)


def same_history(a, b) -> bool:
    """Two ``fit`` histories equal in every number but the wall clock."""
    keys = ("epoch", "train_loss", "val_loss", "val_acc", "lr")
    return len(a) == len(b) and all(
        [x[k] for k in keys] == [y[k] for k in keys] for x, y in zip(a, b))


def data_parallel_phase(ctx) -> None:
    """The GCN at full width trained data-parallel over a world-4
    ``DataMesh`` (4 cards when there are, else the card four times) under
    a fixed bcsr policy: bitwise the single-device ``grad_accum=4`` fit,
    the exact SpMM launch count; at dropout 0 with plain SGD within ATOL
    of the same mesh fit on the CPU; mesh
    evaluation bitwise the single-device one; the test Plan served through
    the mesh engine bitwise the single-device engine (``ctx.
    single_answers``: phase serve's answers to ``ctx.queries`` on the
    same parameters), then after a swap to a second parameter set bitwise
    a fresh single-device engine.

    Each cold super-step of the engine stacks and stages 4 test batches
    (1.4 GB) on one card, so the 64 cold queries go through one
    coalesced ``run`` (one super-step) and ``query`` is held to the
    single-device engine on four of them: two that span the test batches
    (a super-step each) and two inside one batch (a lone miss each)."""
    import numpy as np
    import torch
    from repro_torch.dist import data_parallel
    from repro_torch.dist.data_parallel import DataMesh, ShardedPlanExecutor
    from repro_torch.kernels import build
    from repro_torch.models.gnn import BackendPolicy, init_gnn
    from repro_torch.optim import tree_leaves
    from repro_torch.serve import GNNInferenceEngine, GNNRequest
    from repro_torch.train import GNNTrainer

    dev, cfg, world = ctx.dev, ctx.cfg, 4
    train, val, test = ctx.train_plan, ctx.val_plan, ctx.test_plan
    policy = BackendPolicy.fixed("bcsr")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= world:
        mesh, what = DataMesh([torch.device("cuda", i)
                               for i in range(world)]), "4 distinct cards"
    else:
        mesh, what = DataMesh([dev] * world), f"{dev} four times"
    print(f"mesh {mesh}: {what}", flush=True)

    # host seconds in stack_batches, in the loader's worker and in stage
    stack_s = []
    real_stack = data_parallel.stack_batches

    def timed_stack(host, idx):
        t0 = time.perf_counter()
        out = real_stack(host, idx)
        stack_s.append(time.perf_counter() - t0)
        return out

    def fit(device, cfg_k=cfg, **kw):
        trainer = GNNTrainer(cfg_k, backend=policy, device=device,
                             **dict(dict(optimizer="adam", lr=1e-3),
                                    **kw.pop("trainer", {})))
        t0 = time.perf_counter()
        res = trainer.fit(train, val, ctx.num_classes, epochs=2, **kw)
        ctx.sync()
        return res, time.perf_counter() - t0

    def same_params(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))

    build.reset_launches()
    with unittest.mock.patch.object(data_parallel, "stack_batches",
                                    timed_stack):
        mesh_res, mesh_s = fit(dev, mesh=mesh)
    counts = {k: v for k, v in build.launches.items() if v}
    supersteps = -(-len(train) // world)
    val_steps = -(-len(val) // world)
    want = 2 * (2 * cfg.num_layers * world * supersteps
                + cfg.num_layers * world * val_steps)
    print(f"mesh fit: {len(train)} train batches in {supersteps} "
          f"super-steps per epoch ({supersteps * world - len(train)} pad), "
          f"{len(val)} val batches in {val_steps}; {mesh_s:.3f} s, "
          f"{mesh_res.time_per_epoch:.3f} s per epoch without evaluation; "
          f"stack_batches {sum(stack_s):.3f} s on the host over "
          f"{len(stack_s)} calls; launches {counts} (want spmm_bcsr "
          f"{want} = 2 epochs x (2 x {cfg.num_layers} layers x {world} "
          f"members x {supersteps} super-steps + {cfg.num_layers} x "
          f"{world} x {val_steps}), pads included)", flush=True)
    # (a CPU rehearsal of this phase runs the plain path: no launches)
    if dev.type == "cuda" and counts != {"spmm_bcsr": want}:
        raise AssertionError(f"launches {counts}, want spmm_bcsr {want}")
    for h in mesh_res.history:
        print(f"mesh epoch {h['epoch']}: train_loss {h['train_loss']:.6f} "
              f"val_loss {h['val_loss']:.6f} val_acc {h['val_acc']:.4f}",
              flush=True)

    acc_res, acc_s = fit(dev, trainer={"grad_accum": world})
    bitwise = same_history(mesh_res.history, acc_res.history) and \
        same_params(mesh_res.params, acc_res.params)
    print(f"grad_accum={world} fit on {dev}: {acc_s:.3f} s, "
          f"{acc_res.time_per_epoch:.3f} s per epoch without evaluation; "
          f"mesh fit bitwise equal: {bitwise}", flush=True)
    if not bitwise:
        worst = max((a - b).abs().max().item() for a, b in zip(
            tree_leaves(mesh_res.params), tree_leaves(acc_res.params)))
        raise AssertionError(f"the mesh fit differs from grad_accum="
                             f"{world}: params by up to {worst:.3e}, "
                             f"histories {mesh_res.history} vs "
                             f"{acc_res.history}")

    # the card against the CPU: dropout 0, since each device's generator
    # draws its own masks, and plain SGD, since Adam's first steps divide
    # each gradient by its own magnitude and so turn an f32 summation-
    # order difference in a near-zero gradient into a difference of up to
    # lr in the parameter (tools/fit_card_vs_cpu.py)
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    sgd = {"optimizer": "sgd", "lr": CPU_FIT_SGD_LR}
    card0, card0_s = fit(dev, cfg0, mesh=mesh, trainer=sgd)
    cpu0, cpu0_s = fit(torch.device("cpu"), cfg0, trainer=sgd,
                       mesh=DataMesh(["cpu"] * world))
    worst = max(abs(a[k] - b[k]) for a, b in zip(card0.history,
                                                   cpu0.history)
                for k in ("train_loss", "val_loss", "val_acc"))
    for a, b in zip(tree_leaves(card0.params), tree_leaves(cpu0.params)):
        worst = max(worst, (a.cpu() - b).abs().max().item())
        torch.testing.assert_close(a.cpu(), b, atol=ATOL, rtol=RTOL)
    for a, b in zip(card0.history, cpu0.history):
        for k in ("train_loss", "val_loss", "val_acc"):
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=RTOL)
    moved = max((a.cpu() - b).abs().max().item() for a, b in zip(
        tree_leaves(card0.params), tree_leaves(
            GNNTrainer(cfg0, device="cpu").init_params())))
    print(f"dropout 0, SGD at lr {CPU_FIT_SGD_LR}: the mesh fit on {dev} "
          f"({card0_s:.3f} s) against the same mesh fit on the CPU "
          f"({cpu0_s:.3f} s): params and history max_abs_err {worst:.3e}; "
          f"the parameters moved by up to {moved:.3e}", flush=True)

    ex = ShardedPlanExecutor(mesh, cfg, backend=policy)
    got = ex.evaluate(ex.replicate(mesh_res.params), val.cache,
                      decisions=ex.decisions(val))
    single = GNNTrainer(cfg, backend=policy, device=dev).evaluate(
        mesh_res.params, val)
    print(f"executor.evaluate on the val plan: {got}; single device "
          f"{single}", flush=True)
    if got != single:
        raise AssertionError("mesh evaluation differs from the single-"
                             "device evaluation")

    p1 = init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    p2 = init_gnn(cfg, torch.Generator().manual_seed(1), device=dev)
    em = GNNInferenceEngine(test, cfg, p1, backend=policy, cache_batches=0,
                            mesh=mesh)
    e1 = GNNInferenceEngine(test, cfg, p1, backend=policy, cache_batches=0,
                            device=dev)
    rb = np.asarray(test.routing.batch)
    inside = [test.routing.node_ids[rb == bi][:16] for bi in (0, len(test)
                                                              - 1)]
    singles = list(ctx.queries[:2]) + inside

    def misses(q):
        """(super-steps, lone forwards) of a cold miss set: full groups
        of `world`, a rest of 2 or more padded, a rest of 1 alone."""
        full, rest = divmod(len(np.unique(test.routing.lookup(
            np.asarray(q))[0])), world)
        return full + (rest >= 2), int(rest == 1)

    plan_steps = [misses(np.concatenate(ctx.queries))] + \
        [misses(q) for q in singles]
    want_steps = sum(s for s, _ in plan_steps)
    want = cfg.num_layers * sum(world * s + lone for s, lone in plan_steps)
    build.reset_launches()
    t0 = time.perf_counter()
    reqs = [GNNRequest(node_ids=q) for q in ctx.queries]
    em.run(reqs)
    ctx.sync()
    run_s = time.perf_counter() - t0
    got = [em.query(q) for q in singles]
    ctx.sync()
    counts = {k: v for k, v in build.launches.items() if v}
    if any(r.logits.tobytes() != a.tobytes()
           for r, a in zip(reqs, ctx.single_answers)) or any(
            g.tobytes() != a.tobytes() for g, a in zip(
                got, list(ctx.single_answers[:2]) +
                [e1.query(q) for q in inside])):
        raise AssertionError("a mesh answer differs from the single-device "
                             "engine's")
    print(f"mesh engine: {len(reqs)} cold requests of 16 ids in one run() "
          f"({run_s:.3f} s), then 4 query() calls (2 spanning batches, 2 "
          f"inside one), bit-identical to the single-device engine; "
          f"(super-steps, lone misses) {plan_steps}; supersteps "
          f"{em.stats['supersteps']} (want {want_steps}), batch_runs "
          f"{em.stats['batch_runs']}; launches {counts} (want spmm_bcsr "
          f"{want} = {cfg.num_layers} layers x ({world} members a "
          f"super-step + 1 a lone miss))", flush=True)
    if em.stats["supersteps"] != want_steps or (
            dev.type == "cuda" and counts != {"spmm_bcsr": want}):
        raise AssertionError(f"supersteps {em.stats['supersteps']}, "
                             f"launches {counts}")
    em.params = p2
    em.swap(test)
    reqs = [GNNRequest(node_ids=q) for q in ctx.queries[:SWAP_QUERIES]]
    em.run(reqs)
    fresh = GNNInferenceEngine(test, cfg, p2, backend=policy,
                               cache_batches=0, device=dev)
    if any(r.logits.tobytes() != fresh.query(r.node_ids).tobytes()
           for r in reqs):
        raise AssertionError("after the swap the mesh engine differs from "
                             "a fresh engine on the new parameters")
    if not all(same_params(rep, em.params) for rep in em._replicas):
        raise AssertionError("a replica kept the old parameters")
    print(f"swap to a second parameter set: {SWAP_QUERIES} requests "
          f"bit-identical to a fresh single-device engine, every replica "
          f"holds the new parameters; stats "
          f"{ {k: em.stats[k] for k in ('supersteps', 'swap_count')} }",
          flush=True)


def influence_phase(ctx) -> None:
    """``exact_influence`` of a randomly initialized full-width GCN over the
    whole graph (segment aggregation, no LayerNorm, as
    ``tests/test_influence.py``) for 4 seeded output nodes among the test
    Plan's PPR roots: the card's against the CPU's within ATOL relative to
    the largest influence, and PPR ranking the top-k nodes it stored like
    the influence does (mean Spearman correlation above 0.5).

    The CPU computes each node's influence over the subgraph induced by
    the nodes within ``num_layers`` hops of it: a node farther away has no
    path of ``num_layers`` edges to it, and every node that reaches it
    within ``num_layers - 1`` hops has all its neighbours inside, so the
    subgraph gives the same influence for a few thousand nodes where the
    whole graph has 20,000. The card's influence outside must be 0."""
    import numpy as np
    import torch
    from repro_torch.core.influence import exact_influence
    from repro_torch.models.gnn import init_gnn, ops

    ds, cfg, dev = ctx.ds, ctx.cfg, ctx.dev
    adj = ds.norm_graph.to_scipy().tocsr()
    params = init_gnn(cfg, torch.Generator().manual_seed(3), device="cpu")

    def apply_on(sub, device):
        """The full-graph forward over the edges of ``sub``."""
        m = sub.tocoo()
        src, dst, w = (torch.as_tensor(a, device=device) for a in (
            m.row.astype(np.int32), m.col.astype(np.int32),
            m.data.astype(np.float32)))
        layers = [{k: v.to(device) for k, v in p.items()}
                  for p in params["layers"]]

        def apply_fn(feats):
            h = feats
            for l, p in enumerate(layers):
                h = ops.weighted_agg(h @ p["w"], src, dst, w) + p["b"]
                if l < len(layers) - 1:
                    h = torch.relu(h)
            return h

        return apply_fn

    def ball(u):
        """The nodes within ``num_layers`` hops of u, u first."""
        seen, frontier = {u}, [u]
        for _ in range(cfg.num_layers):
            nxt = set(adj[frontier].indices.tolist()) - seen
            seen |= nxt
            frontier = sorted(nxt)
        return np.array([u] + sorted(seen - {u}), np.int64)

    ppr = ctx.test_plan.ppr
    rows = np.random.default_rng(5).choice(len(ppr.roots), 4, replace=False)
    card_fn = apply_on(adj, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cors, card_s, cpu_s, worst = [], [], 0.0, 0.0
    for r in rows:
        u = int(ppr.roots[r])
        t0 = time.perf_counter()
        got = exact_influence(card_fn, ds.features, u, device=dev)
        card_s.append(time.perf_counter() - t0)
        near = ball(u)
        t0 = time.perf_counter()
        want = np.zeros_like(got)
        want[near] = exact_influence(
            apply_on(adj[near][:, near], torch.device("cpu")),
            ds.features[near], 0, device="cpu")
        cpu_s += time.perf_counter() - t0
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / scale
        worst = max(worst, err)
        outside = np.ones(len(got), bool)
        outside[near] = False
        if not err <= ATOL or got[outside].any():
            raise AssertionError(f"node {u}: card vs CPU influence differs "
                                 f"by {err:.3e} of the largest, "
                                 f"{int((got[outside] != 0).sum())} "
                                 f"nonzero outside its ball")
        idx, val = ppr.row(r)
        keep = got[idx] > 0
        cor = spearman(np, got[idx][keep], val[keep])
        cors.append(cor)
        print(f"output node {u}: {int((got > 0).sum())} nodes of "
              f"{ds.num_nodes} with nonzero influence, {len(near)} within "
              f"{cfg.num_layers} hops; top-{len(idx)} PPR nodes, "
              f"{int(keep.sum())} with nonzero influence, Spearman "
              f"{cor:.3f}; {card_s[-1]:.3f} s on the card", flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    print(f"exact_influence of a {cfg.num_layers}-layer width-{cfg.hidden} "
          f"GCN over {ds.num_nodes} nodes x {ds.feat_dim} features, "
          f"{adj.nnz} edges: {np.mean(card_s):.3f} s per output node on "
          f"the card, {cpu_s / len(rows):.3f} s on the CPU over its "
          f"ball; peak card memory {peak / 2**30:.2f} GiB; card vs CPU "
          f"max err {worst:.3e} of the largest influence; mean Spearman "
          f"{np.mean(cors):.3f}", flush=True)
    if not np.mean(cors) > 0.5:
        raise AssertionError(f"PPR should rank like influence, got {cors}")


# ------------------------------------------------------------ LM archs
# the architectures served at full width (phases lm-archs to lm-archs-serve)
# and the frontends (phase lm-frontends)
LM_ARCHS = ("deepseek-v2-lite-16b", "recurrentgemma-2b", "rwkv6-3b")
FRONTEND_ARCHS = ("musicgen-large", "internvl2-1b")
# teacher-forced decode steps held against the prefill, per family
ARCH_DECODE_STEPS = 64
# a capacity factor at which deepseek-v2-lite's prefill drops nothing:
# above E/k = 64/6, so one expert can take every token
NO_DROP_CF = 11.0
# device time inside these functions is read as one kind in a forward's
# split (label, module[:class] under repro_torch, functions): the MoE's
# routing, dispatch and combine, and the recurrences' scans
ARCH_RANGES = (("moe_dispatch", "models.lm.moe",
                ("route", "dispatch", "combine")),
               ("scan", "models.lm.rglru", ("linear_scan",)),
               ("scan", "models.lm.rwkv", ("_wkv_chunk",)))


def flash_launches_of(cfg):
    """The flash launches of one prefill of ``cfg`` on the card: one per
    GQA or local layer, counted under ``flash_attention_d256`` at head dim
    256."""
    n = sum(len([s for s in st.layers if s.mixer in ("gqa", "local")]) *
            st.repeat for st in cfg.stages)
    if not n:
        return {}
    return {"flash_attention_d256" if cfg.resolved_head_dim == 256
            else "flash_attention": n}


def arch_cut(ctx, arch, purpose):
    """The config ``arch`` at full width, cut in depth for ``purpose``:
    "card-vs-cpu" (f32; deepseek 1 dense + 1 MoE layer, recurrentgemma one
    (R, R, A) superblock, rwkv6 and the frontends 2 layers) or "decode"
    (f32; deepseek 1 dense + 3 MoE layers with NO_DROP_CF, recurrentgemma
    one superblock with its softcap at 0, the others at full depth)."""
    from repro_torch.models.lm.config import Stage
    cfg = dataclasses.replace(ctx.config(arch), dtype="float32")
    first, last = cfg.stages[0], cfg.stages[-1]
    if purpose == "card-vs-cpu":
        if arch == "deepseek-v2-lite-16b":
            return dataclasses.replace(cfg, stages=(
                Stage(first.layers, 1), Stage(last.layers, 1)))
        if arch == "recurrentgemma-2b":
            return dataclasses.replace(cfg, stages=(Stage(first.layers, 1),))
        return dataclasses.replace(cfg, stages=(Stage(first.layers, 2),))
    if arch == "deepseek-v2-lite-16b":
        return dataclasses.replace(cfg, stages=(
            Stage(first.layers, 1), Stage(last.layers, 3)),
            moe_capacity_factor=NO_DROP_CF)
    if arch == "recurrentgemma-2b":
        return dataclasses.replace(cfg, stages=(Stage(first.layers, 1),),
                                   logit_softcap=0.0)
    return cfg


def arch_params(ctx, arch, cut, seed):
    """The first layers of the full model: ``init_params`` of ``arch`` at
    full depth in its dtype on the card, each stage's stacked leaves cut
    to the repeats of ``cut`` and cast to ``cut``'s dtype. The reference's
    init draws a stacked weight with std repeat ** -0.5, so a model
    initialised at the cut depth would have weights up to 4x as large,
    whose outputs f32 resolves no better than about 1e-3 (rwkv6 at 2
    layers)."""
    from repro_torch.models.lm import init_params
    torch = ctx.torch
    full = init_params(ctx.config(arch), torch.Generator(ctx.dev).manual_seed(
        seed), ctx.dev)
    dt = getattr(torch, cut.dtype)

    def cast(tree, n=None):
        if isinstance(tree, dict):
            return {k: cast(v, n) for k, v in tree.items()}
        # a copy even in the model's own dtype: a view would keep the
        # whole stack alive
        return (tree if n is None else tree[:n]).to(dt, copy=True)
    out = {k: cast(v) for k, v in full.items() if k != "stages"}
    out["stages"] = [cast(st, c.repeat) for st, c in zip(full["stages"],
                                                          cut.stages)]
    del full
    if ctx.on_card:
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def record_ranges(torch, table):
    """Wrap the functions of ``table`` (ARCH_RANGES, TRAIN_RANGES) in
    ``record_function`` ranges; a class's functions are static methods."""
    import importlib
    with contextlib.ExitStack() as stack:
        for label, target, names in table:
            mod_name, _, cls = target.partition(":")
            owner = importlib.import_module(f"repro_torch.{mod_name}")
            owner = getattr(owner, cls) if cls else owner
            for name in names:
                def wrapped(*a, _fn=getattr(owner, name), _label=label,
                            **kw):
                    with torch.profiler.record_function(_label):
                        return _fn(*a, **kw)
                stack.enter_context(unittest.mock.patch.object(
                    owner, name, staticmethod(wrapped) if cls else wrapped))
        yield


def is_gemm(name: str) -> bool:
    return any(w in name.lower() for w in ("gemm", "nvjet", "xmma",
                                           "cutlass", "matmul"))


def arch_time_split(prof):
    """A profiled forward's device time (µs): flash kernels, then the
    kernels under the ``moe_dispatch`` and ``scan`` ranges, then GEMMs,
    then the rest."""
    def under(ev):
        for k in ev.kernels:
            yield k.name, k.duration
        for ch in ev.cpu_children:
            yield from under(ch)
    split = dict(flash_kernel=0.0, moe_dispatch=0.0, scan=0.0, gemm=0.0,
                 rest=0.0)
    ranged_gemm = 0.0
    for ev in prof.events():
        if ev.name in ("moe_dispatch", "scan"):
            for name, us in under(ev):
                split[ev.name] += us
                ranged_gemm += us if is_gemm(name) else 0.0
    total = 0.0
    for key, _, us in device_events(prof):
        total += us
        if "flash_fwd" in key:
            split["flash_kernel"] += us
        elif is_gemm(key):
            split["gemm"] += us
    split["gemm"] -= ranged_gemm
    split["rest"] = total - sum(split.values())
    return split, total


def arch_tokens(ctx, cfg, shape, seed):
    shape = tuple(shape) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1
                            else ())
    return ctx.torch.as_tensor(ctx.np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape), device=ctx.dev)


def arch_last_logits(cfg, params, toks, prefix=None):
    from repro_torch.models.lm import head_logits, lm_forward
    return head_logits(cfg, params, lm_forward(cfg, params, toks,
                                               prefix)[:, -1])


def arch_prefill_phase(ctx, arch, prefix_rows=0):
    """``init_params`` of ``arch`` at full width and depth on the card, one
    prefill's logits at B=1 (with ``prefix_rows`` of patch embeddings
    before the text), the exact flash launches, the forward's time and
    device time split, and the peak memory."""
    torch, build, dev = ctx.torch, ctx.build, ctx.dev
    from repro_torch.models.lm import init_params
    from repro_torch.optim import tree_leaves
    from torch.profiler import ProfilerActivity, profile
    cfg = ctx.config(arch)
    if ctx.on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    ctx.sync()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() if ctx.on_card else 0
    if ctx.on_card:
        torch.cuda.reset_peak_memory_stats()
    n = sum(t.numel() for t in tree_leaves(params))
    toks = arch_tokens(ctx, cfg, (1, ctx.prefill_s), 1)
    prefix = None
    if prefix_rows:
        prefix = (torch.randn((1, prefix_rows, cfg.d_model), device=dev,
                              generator=torch.Generator(dev).manual_seed(2))
                  * 0.02).to(getattr(torch, cfg.dtype))
    build.reset_launches()
    logits = arch_last_logits(cfg, params, toks, prefix)
    ctx.sync()
    got = {k: v for k, v in build.launches.items() if v}
    want = flash_launches_of(cfg) if ctx.on_card else {}
    width = cfg.num_codebooks * cfg.vocab_size
    print(f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}: {n} parameters initialised on the card in "
          f"{init_s:.1f} s; prefill B=1 S={ctx.prefill_s}"
          f"{f' after a {prefix_rows}-row prefix' if prefix_rows else ''}: "
          f"logits {tuple(logits.shape)}, max |logit| "
          f"{logits.float().abs().max().item():.4f}; launches {got} (want "
          f"{want})", flush=True)
    if got != want:
        raise AssertionError(f"{arch}: kernel launches {got}, want {want}")
    if logits.shape != (1, width) or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: non-finite or misshapen logits")
    ms = ctx.cuda_ms(lambda: arch_last_logits(cfg, params, toks, prefix))
    with record_ranges(torch, ARCH_RANGES), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        arch_last_logits(cfg, params, toks, prefix)
        ctx.sync()
    split, total = arch_time_split(prof)
    if ctx.on_card and total <= 0:
        raise AssertionError("the profiler recorded no device time")
    peak = torch.cuda.max_memory_allocated() if ctx.on_card else 0
    s_all = ctx.prefill_s + prefix_rows
    print(f"{arch} one prefill (CUDA events): {ms:.3f} ms, "
          f"{s_all / ms * 1e3:.0f} tokens/s; device time (torch.profiler) "
          + ", ".join(f"{k} {v / 1e3:.3f} ms "
                      f"({v / max(total, 1e-9) * 100:.1f}%)"
                      for k, v in split.items())
          + f"; total {total / 1e3:.3f} ms, device busy "
          f"{total / 1e3 / ms * 100:.1f}%; peak memory allocated "
          f"{init_peak / 1e9:.2f} GB in init_params, {peak / 1e9:.2f} GB in "
          f"the forwards", flush=True)
    ctx.arch_records[arch] = dict(params=n, ms=ms, split=split,
                                  peak_gb=peak / 1e9, launches=got)
    del params, logits
    if ctx.on_card:
        torch.cuda.empty_cache()


def lm_archs_phase(ctx):
    for arch in LM_ARCHS:
        arch_prefill_phase(ctx, arch)


@contextlib.contextmanager
def counting_drops(torch, drops):
    """Append each MoE call's count of dropped assignments to ``drops``."""
    from repro_torch.models.lm import moe
    route = moe.route

    def counted(*a, **kw):
        r = route(*a, **kw)
        drops.append(int((~r.keep).sum()))
        return r
    with unittest.mock.patch.object(moe, "route", counted):
        yield


def lm_archs_card_vs_cpu_phase(ctx):
    """Each family at full width, cut in depth (the full model's first
    layers), in f32: the card's logits against the CPU path's."""
    torch, build = ctx.torch, ctx.build
    from repro_torch.optim import tree_map
    for arch in LM_ARCHS:
        cfg = arch_cut(ctx, arch, "card-vs-cpu")
        s = ctx.rg_cvc_s if arch == "recurrentgemma-2b" else ctx.cvc_s
        p = arch_params(ctx, arch, cfg, 1)
        toks = arch_tokens(ctx, cfg, (1, s), 3)
        drops = []
        build.reset_launches()
        with counting_drops(torch, drops):
            got = arch_last_logits(cfg, p, toks)
            ctx.sync()
        launches = {k: v for k, v in build.launches.items() if v}
        want_l = flash_launches_of(cfg) if ctx.on_card else {}
        t0 = time.perf_counter()
        cpu_p = tree_map(lambda t: t.cpu(), p)
        want = arch_last_logits(cfg, cpu_p, toks.cpu())
        err = (got.cpu() - want).abs().max().item()
        print(f"{arch} cut to {cfg.num_layers} layers, f32, S={s}: card vs "
              f"CPU logits max_abs_err {err:.3e}, max |logit| "
              f"{want.abs().max().item():.4f}; launches {launches}; MoE "
              f"assignments dropped per layer on the card {drops}; CPU "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if launches != want_l:
            raise AssertionError(f"launches {launches}, want {want_l}")
        if arch == "deepseek-v2-lite-16b" and not sum(drops):
            raise AssertionError("no MoE assignment was dropped: the "
                                 "capacity never bound")
        torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=RTOL)
        del p, cpu_p


def decode_figure(ctx, cfg, params, toks, drops=None):
    """err / max |logit| of the last of len(toks) teacher-forced decode
    steps against the prefill's last logits, and ms per step (host
    clock)."""
    from repro_torch.models.lm import decode_step, init_cache
    with counting_drops(ctx.torch, drops if drops is not None else []):
        full = arch_last_logits(cfg, params, toks).float()
    cache = init_cache(cfg, toks.shape[0], 2 * toks.shape[1], ctx.dev)
    t0 = time.perf_counter()
    for t in range(toks.shape[1]):
        logits, cache = decode_step(cfg, params, cache, toks[:, t:t + 1], t)
    ctx.sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / toks.shape[1]
    scale = full.abs().max().item() + 1e-9
    err = (logits[:, 0].float() - full).abs().max().item()
    return err / scale, scale, step_ms


def sequential_scan(a, b):
    """``rglru.linear_scan`` one step at a time, in decode's order of
    operations."""
    import torch
    h, out = torch.zeros_like(b[:, 0]), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def lm_archs_decode_phase(ctx):
    """ARCH_DECODE_STEPS teacher-forced decode steps per family in f32
    against the prefill, at the reference's limit; and, printed for the
    record, deepseek at its config's capacity factor (the prefill drops
    assignments that decode does not) and recurrentgemma at full depth:
    with its softcap at 0, with the config's (which the reference's local
    prefill leaves out), and its prefill against the same prefill with the
    scan run step by step (two f32 orders of the same sums)."""
    from repro_torch.models.lm import rglru
    for arch in LM_ARCHS:
        cfg = arch_cut(ctx, arch, "decode")
        p = arch_params(ctx, arch, cfg, 4)
        toks = arch_tokens(ctx, cfg, (2, ctx.decode_steps), 5)
        fig, scale, step_ms = decode_figure(ctx, cfg, p, toks)
        print(f"{arch} ({cfg.num_layers} layers, f32, cf "
              f"{cfg.moe_capacity_factor}, softcap {cfg.logit_softcap}): "
              f"{ctx.decode_steps} teacher-forced decode steps (B=2) vs "
              f"prefill, last logits err / max |logit| ({scale:.4f}) = "
              f"{fig:.3e} (limit {DECODE_REL}); {step_ms:.2f} ms per step "
              f"(host clock)", flush=True)
        if not fig < DECODE_REL:
            raise AssertionError(f"{arch}: f32 decode diverges from "
                                 f"prefill: {fig:.3e}")
        base = ctx.config(arch)
        if arch == "deepseek-v2-lite-16b":
            drops = []
            alt = dataclasses.replace(
                cfg, moe_capacity_factor=base.moe_capacity_factor)
            fig2, _, _ = decode_figure(ctx, alt, p, toks, drops)
            print(f"  at the config's capacity factor "
                  f"{base.moe_capacity_factor}: {fig2:.3e}; the prefill "
                  f"(T = {toks.numel()}) dropped {drops} assignments per "
                  f"MoE layer, decode (T = 2 a step) drops none",
                  flush=True)
        if arch == "recurrentgemma-2b":
            del p
            full = dataclasses.replace(base, dtype="float32",
                                       logit_softcap=0.0)
            p = arch_params(ctx, arch, full, 4)
            fig0, _, _ = decode_figure(ctx, full, p, toks)
            want = arch_last_logits(full, p, toks).float()
            with unittest.mock.patch.object(rglru, "linear_scan",
                                            sequential_scan):
                seq = arch_last_logits(full, p, toks).float()
            gap = (seq - want).abs().max().item() / want.abs().max().item()
            capped = dataclasses.replace(full,
                                         logit_softcap=base.logit_softcap)
            fig30, _, _ = decode_figure(ctx, capped, p, toks)
            print(f"  at full depth ({full.num_layers} layers): softcap 0 "
                  f"{fig0:.3e}; the prefill against the same prefill with "
                  f"the RG-LRU scan run step by step {gap:.3e} (two f32 "
                  f"orders of the same sums); with "
                  f"the config's softcap {base.logit_softcap}: {fig30:.3e}: "
                  f"the reference's local prefill applies no softcap and "
                  f"its decode does (ROADMAP Queue 3)", flush=True)
        del p
        if ctx.on_card:
            ctx.torch.cuda.empty_cache()


def decode_step_profile(ctx, cfg, params, eng, n=4):
    """What the card does in a serving decode step of ``eng``'s slots:
    kernels and device time per step under ``torch.profiler``, against
    the step's host time."""
    torch = ctx.torch
    from repro_torch.models.lm import decode_step
    from torch.profiler import ProfilerActivity, profile
    cache, pos = eng.cache, eng.pos
    toks = torch.zeros((eng.num_slots, 1) + (
        (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()),
        dtype=torch.long, device=ctx.dev)
    ctx.sync()
    t0 = time.perf_counter()
    for t in range(n):
        decode_step(cfg, params, cache, toks, pos + t)
    ctx.sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(n):
            decode_step(cfg, params, cache, toks, pos + n + t)
        ctx.sync()
    acts = list(device_events(prof))
    kernels = sum(c for _, c, _ in acts) / n
    busy = sum(us for _, _, us in acts) / 1e3 / n
    top = sorted(acts, key=lambda a: -a[2])[:3]
    print(f"  decode step (B={eng.num_slots}, torch.profiler, {n} "
          f"steps): {kernels:.0f} device kernels and copies, {busy:.3f} ms "
          f"of device time per step against {step_ms:.2f} ms on the host "
          f"clock (device busy {busy / step_ms * 100:.1f}%); largest: "
          + ", ".join(f"{k[:60]} {us / 1e3 / n:.3f} ms" for k, _, us in top),
          flush=True)


def lm_archs_serve_phase(ctx):
    """``ServeEngine`` (4 slots, max_len 512) serves 8 seeded requests at
    full width in bf16; all complete, none is evicted, and the first
    request's tokens equal those it gets alone."""
    torch, dev, np = ctx.torch, ctx.dev, ctx.np
    from repro_torch.models.lm import init_params
    from repro_torch.serve import Request, ServeEngine
    for arch in LM_ARCHS:
        cfg = ctx.config(arch)
        params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        srng = np.random.default_rng(23)
        prompts = [srng.integers(0, cfg.vocab_size, int(srng.integers(
            32, 65))).astype(np.int32) for _ in range(8)]
        reqs = [Request(prompt=pr, max_new_tokens=16) for pr in prompts]
        eng = ServeEngine(cfg, params, num_slots=4, max_len=512, device=dev)
        stats = eng.run(reqs)
        ctx.sync()
        new = sum(len(r.out_tokens) for r in reqs)
        print(f"ServeEngine {arch} {cfg.dtype}, 4 slots, max_len 512: "
              f"{stats['completed']}/8 requests, {stats['evicted']} "
              f"evicted, {stats['steps']} steps in {stats['time_s']:.3f} s "
              f"(host clock), {stats['time_s'] * 1e3 / stats['steps']:.2f} "
              f"ms per step, {new / stats['time_s']:.1f} generated "
              f"tokens/s", flush=True)
        if stats["completed"] != 8 or stats["evicted"] != 0:
            raise AssertionError(f"serving left requests unfinished: "
                                 f"{stats}")
        if not all(len(r.out_tokens) == 16 and all(
                0 <= t < cfg.vocab_size for t in r.out_tokens)
                for r in reqs):
            raise AssertionError("bad generated tokens")
        alone = Request(prompt=prompts[0], max_new_tokens=16)
        ServeEngine(cfg, params, num_slots=4, max_len=512,
                    device=dev).run([alone])
        print(f"  request 0: {reqs[0].out_tokens}; alone: "
              f"{alone.out_tokens}", flush=True)
        if alone.out_tokens != reqs[0].out_tokens:
            raise AssertionError("request 0's tokens depend on its "
                                 "neighbours in the batch")
        decode_step_profile(ctx, cfg, params, eng)
        del eng, params
        if ctx.on_card:
            torch.cuda.empty_cache()


def lm_frontends_phase(ctx):
    """musicgen-large ((B, S, 4) codebook tokens; a few (B, 1, 4) decode
    steps) and internvl2-1b (a 256-row ``prefix_embeds``) at full width,
    then each at a cut depth in f32 with the card's logits against the
    CPU's."""
    torch, dev = ctx.torch, ctx.dev
    from repro_torch.models.lm import decode_step, init_cache, init_params
    from repro_torch.optim import tree_map
    for arch in FRONTEND_ARCHS:
        cfg = ctx.config(arch)
        rows = cfg.vision_prefix_len
        arch_prefill_phase(ctx, arch, prefix_rows=rows)
        if cfg.num_codebooks > 1:
            params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)
            toks = arch_tokens(ctx, cfg, (2, 4), 6)
            cache = init_cache(cfg, 2, 8, dev)
            for t in range(4):
                logits, cache = decode_step(cfg, params, cache,
                                            toks[:, t:t + 1], t)
            ctx.sync()
            print(f"{arch}: 4 decode steps of (2, 1, {cfg.num_codebooks}) "
                  f"tokens: logits {tuple(logits.shape)}", flush=True)
            if logits.shape != (2, 1, cfg.num_codebooks * cfg.vocab_size) \
                    or not torch.isfinite(logits).all():
                raise AssertionError("bad multi-codebook decode logits")
            del params, cache
        cut = arch_cut(ctx, arch, "card-vs-cpu")
        p = arch_params(ctx, arch, cut, 1)
        toks = arch_tokens(ctx, cut, (1, ctx.cvc_s), 7)
        prefix = None
        if rows:
            prefix = torch.randn((1, rows, cut.d_model), device=dev,
                                 generator=torch.Generator(dev).manual_seed(
                                     8)) * 0.02
        got = arch_last_logits(cut, p, toks, prefix)
        cpu_p = tree_map(lambda t: t.cpu(), p)
        want = arch_last_logits(cut, cpu_p, toks.cpu(),
                                None if prefix is None else prefix.cpu())
        err = (got.cpu() - want).abs().max().item()
        print(f"{arch} cut to {cut.num_layers} layers, f32, S={ctx.cvc_s}"
              f"{f' + {rows} prefix rows' if rows else ''}: card vs CPU "
              f"logits max_abs_err {err:.3e}, max |logit| "
              f"{want.abs().max().item():.4f}", flush=True)
        torch.testing.assert_close(got.cpu(), want, atol=ATOL, rtol=RTOL)
        del p, cpu_p


# ------------------------------------------------------------ LM training
# the reference launcher's defaults (python -m repro.launch.train): B=8,
# S=256, AdamW at lr 3e-4, remat on
TRAIN_B, TRAIN_S, TRAIN_LR = 8, 256, 3e-4
# lm-train: 6 steps, a checkpoint after step 3 (--ckpt-every 4), then a run
# resumed from it
TRAIN_STEPS, TRAIN_CKPT_EVERY = 6, 4
# resumed steps that are not bitwise the uninterrupted run's: the losses
# within this (absolute, on losses near 12), with the nondeterministic op
# named
RESUME_ATOL = 1e-3
# one train step per family (phase lm-archs-train): arch, depth cut, B, S
ARCH_TRAIN = (("recurrentgemma-2b", None, 1, 4096),
              ("rwkv6-3b", None, 1, 512),
              ("musicgen-large", None, TRAIN_B, TRAIN_S),
              ("internvl2-1b", None, TRAIN_B, TRAIN_S),
              ("deepseek-v2-lite-16b", "first-two", TRAIN_B, TRAIN_S),
              ("deepseek-v3-671b", "smoke", TRAIN_B, TRAIN_S))
# a train step's device time is split by these ranges (as ARCH_RANGES):
# the backward of a flash layer (the plain attention recomputed and
# differentiated), the chunked cross entropy's forward and the optimizer;
# the log-softmax backward's kernels count as xent too
TRAIN_RANGES = (("attn_bwd_recompute", "models.lm.attention:"
                 "FlashAttentionTrain", ("backward",)),
                ("xent", "models.lm.model", ("_xent_chunk",)),
                ("optimizer", "launch.train", ("apply_grads",)))


def train_time_split(prof):
    """A profiled train step's device time (µs): each kernel under a range
    of TRAIN_RANGES counts to it; the others are the flash kernel (the
    forward's launches and remat's recompute), GEMMs, the log-softmax
    backward (xent) or the rest."""
    labels = {label for label, *_ in TRAIN_RANGES}
    split = dict(flash_fwd=0.0, attn_bwd_recompute=0.0, gemm=0.0,
                 xent=0.0, optimizer=0.0, rest=0.0)
    for ev in prof.events():
        if not ev.kernels:
            continue
        label, up = None, ev
        while up is not None and label is None:
            label = up.name if up.name in labels else None
            up = up.cpu_parent
        for k in ev.kernels:
            kind = label or ("flash_fwd" if "flash_fwd" in k.name else
                             "gemm" if is_gemm(k.name) else
                             "xent" if "softmax" in k.name.lower() else
                             "rest")
            split[kind] += k.duration
    return split, sum(split.values())


def train_args(**kw):
    """The reference launcher's flags as ``train_loop`` takes them."""
    base = dict(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S, lr=TRAIN_LR,
                optimizer="adamw", ckpt_dir=None, ckpt_every=10,
                compress=False, device=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def train_launches_of(cfg, steps=1):
    """Flash launches of ``steps`` train steps with remat: each GQA or
    local layer launches the kernel in the forward and again when the
    backward recomputes its repeat."""
    return {k: 2 * v * steps for k, v in flash_launches_of(cfg).items()}


def kink_rule():
    """``tests/_kinks.py``, shared with the tests: ``kink_trace``, which
    records (or forces the side of) every ReLU and LeakyReLU input, and
    ``kink_witness``, the rule that excuses a gradient element of a
    card-vs-CPU step only where a flipped kink explains it."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _kinks
    return _kinks


def f64_witness():
    """``tests/_f64.py``, shared with the tests: ``port_f64``, a dispatch
    mode that runs every op in f64 (so the port's own f32 casts do not
    round), and ``witness_misses``, the rule that holds an f32 gradient
    leaf by leaf with that float64 witness."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _f64
    return _f64


@contextlib.contextmanager
def flash_inputs(captured):
    """While the block runs, keep a copy of the first inputs the flash
    kernel's wrapper is given at each (shapes, dtype, window), in the
    layout the LM passes them: ``hold_flash`` holds the kernel against its
    plain version at exactly the path's shapes afterwards."""
    from repro_torch.models.lm import attention
    orig = attention.flash_attention

    def spy(q, k, v, causal=True, window=0, impl=None):
        key = (tuple(q.shape), tuple(k.shape), q.dtype, causal, window)
        if key not in captured:
            captured[key] = [t.detach().clone() for t in (q, k, v)]
        return orig(q, k, v, causal=causal, window=window, impl=impl)
    with unittest.mock.patch.object(attention, "flash_attention", spy):
        yield


def hold_flash(ctx, captured, label):
    """Each input ``flash_inputs`` kept, through the kernel's wrapper,
    against ``plain_attention`` (the function the backward differentiates)
    in f32 on the same values: f32 within ATOL, bf16 within one bf16
    rounding on top (BF16_REL), as kernels-random holds it — with ATOL in
    units of the largest |v|. An output row is a weighted mean of v's
    rows, so the kernel's absolute error scales with them: ATOL is set
    for kernels-random's N(0, 1) values, and a model's v reaches |v|
    near 40 at its init (printed here). There the tensor cores' f32 sums
    leave more than the unscaled limit on outputs that cancel to near 0,
    while P rounded once to bf16 (2^-8 of each weight) or a fault of the
    batch or head strides or the mask puts errors of order 2^-9 |v|, or
    |v| itself, far outside the scaled one."""
    torch = ctx.torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.lm.attention import plain_attention
    for (qs, ks, dtype, causal, window), (q, k, v) in captured.items():
        assert causal, "the LM's attention is causal"
        with torch.no_grad():
            got = flash_attention(q, k, v, causal=True, window=window,
                                  impl="cuda")
            want = plain_attention(*(t.transpose(1, 2).float()
                                     for t in (q, k, v)),
                                   window).transpose(1, 2)
        ctx.sync()
        diff = (got.float() - want).abs()
        scale = max(1.0, v.float().abs().max().item())
        limit = ATOL * scale + (BF16_REL * want.abs()
                                if dtype == torch.bfloat16 else 0.0)
        b, h, s, d = qs
        if dtype == torch.bfloat16:
            # the library's bf16 attention on the same inputs, against the
            # same f32 result, under kernels-random's limit (unscaled) and
            # this one (ROADMAP Queue 3)
            from torch.nn.functional import scaled_dot_product_attention
            mask = None
            if window:
                pos = torch.arange(s, device=q.device)
                mask = (pos[None, :] <= pos[:, None]) & \
                    (pos[None, :] > pos[:, None] - window)
            with torch.no_grad():
                lib = scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=True)
            ctx.sync()
            unscaled = ATOL + BF16_REL * want.abs()
            for who, out in (("kernel", got), ("sdpa", lib)):
                e = (out.float() - want).abs()
                print(f"  bf16 {who} B={b} H={h} KV={ks[1]} S={s} D={d} "
                      f"window {window}: max err {e.max().item():.4g}; "
                      f"worst error / limit {(e / unscaled).max().item():.3f}"
                      f" unscaled (ATOL + 2^-8|want|), "
                      f"{(e / limit).max().item():.3f} scaled (ATOL x max "
                      f"|v| + 2^-8|want|)", flush=True)
        ctx.note("flash_attention_d256" if d == 256 else "flash_attention",
                 diff.max().item(),
                 f"{label}'s own inputs B={b} H={h} KV={ks[1]} S={s} D={d} "
                 f"{str(dtype).split('.')[-1]} window {window} against "
                 f"plain_attention in f32 (max |v| {scale:.4g}, worst error "
                 f"/ limit {(diff / limit).max().item():.3f})",
                 bool((diff <= limit).all() and torch.isfinite(got).all()))


def timed_steps(ctx, train, times):
    """Patch ``train.train_step`` so each call appends its time (ms; CUDA
    events on the card, the host clock on the CPU) to ``times``."""
    torch, orig = ctx.torch, train.train_step

    def timed(*a, **kw):
        if ctx.on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = orig(*a, **kw)
            ev[1].record()
            times.append(ev)
        else:
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            times.append((time.perf_counter() - t0) * 1e3)
        return out
    return unittest.mock.patch.object(train, "train_step", timed)


def step_clock(ctx):
    """Start a clock (CUDA events on the card, the host clock on the CPU);
    the returned function synchronises and gives the ms since."""
    torch = ctx.torch
    if ctx.on_card:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()

        def stop():
            ev[1].record()
            ctx.sync()
            return ev[0].elapsed_time(ev[1])
        return stop
    t0 = time.perf_counter()
    return lambda: (time.perf_counter() - t0) * 1e3


def step_ms(ctx, times):
    ctx.sync()
    return [ev[0].elapsed_time(ev[1]) if ctx.on_card else ev for ev in times]


def lm_train_phase(ctx):
    """The LM main path: llama3.2-1b at its full config through the
    launcher's ``train_loop``, with its defaults. 6 steps with a
    checkpoint after step 3 (exact flash launches) after 5 steps with no
    checkpoint (the step time), a run resumed from the checkpoint against
    the uninterrupted one, 2 steps on one repeated batch (the loss falls;
    the flash kernel held against its plain version on their inputs), 2
    steps with ``--compress``; tokens/s, peak memory and one step's
    device time split."""
    torch, dev, build = ctx.torch, ctx.dev, ctx.build
    from repro_torch.launch import train
    from repro_torch.models.lm import init_params
    from repro_torch.optim import get_optimizer, tree_leaves
    from torch.profiler import ProfilerActivity, profile
    cfg = ctx.config(LM_ARCH)
    if ctx.on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = get_optimizer("adamw")
    state = opt.init(params)
    n = sum(t.numel() for t in tree_leaves(params))
    b, s = ctx.train_b, ctx.train_s
    # the step time, before any checkpoint of this phase is written: 5
    # steps with no checkpoint directory, the median of the last 4 (the
    # first pays each shape's first use)
    clean = []
    with timed_steps(ctx, train, clean):
        params, state, _ = train.train_loop(
            cfg, params, state, train_args(batch=b, seq=s, steps=5,
                                           device=dev), opt,
            log=lambda _: None)
    clean = step_ms(ctx, clean)
    med = float(ctx.np.median(clean[1:]))
    print(f"step time with no checkpoint written "
          f"({'CUDA events' if ctx.on_card else 'host clock'}): "
          + " ".join(f"{x:.1f}" for x in clean)
          + f" ms, median of the last 4 {med:.2f} ms, "
          f"{b * s / med * 1e3:.0f} tokens/s", flush=True)

    ck = os.path.join(ctx.work, "lm-train")
    args = train_args(batch=b, seq=s, ckpt_dir=ck,
                      ckpt_every=TRAIN_CKPT_EVERY, device=dev)
    logs, times = [], []
    build.reset_launches()
    t0 = time.perf_counter()
    with timed_steps(ctx, train, times):
        params, state, losses = train.train_loop(cfg, params, state, args,
                                                 opt, log=logs.append)
    ctx.sync()
    run_s = time.perf_counter() - t0
    got = {k: v for k, v in build.launches.items() if v}
    want = train_launches_of(cfg, TRAIN_STEPS) if ctx.on_card else {}
    ms = step_ms(ctx, times)
    peak = torch.cuda.max_memory_allocated() if ctx.on_card else 0
    print(f"{cfg.name}: {cfg.num_layers} layers, {cfg.dtype}, {n} "
          f"parameters; train_loop B={b} S={s} AdamW lr {TRAIN_LR}, remat, "
          f"a checkpoint after step {TRAIN_CKPT_EVERY - 1}: losses "
          + " ".join(f"{losses[k]:.6f}" for k in sorted(losses))
          + f"; step times ({'CUDA events' if ctx.on_card else 'host clock'}) "
          + " ".join(f"{x:.1f}" for x in ms)
          + f" ms: steps 2-3 {float(ctx.np.median(ms[2:4])):.2f} ms and "
          f"steps 4-5 {float(ctx.np.median(ms[4:6])):.2f} ms (the median "
          f"of each pair; steps 4-5 run while the checkpoint's writer "
          f"thread writes step 3's); {run_s:.1f} s for the run (host "
          f"clock, the checkpoint's host copy included); peak memory "
          f"allocated "
          f"{peak / 1e9:.2f} GB; flash launches {got} (want {want}, "
          f"{sum(train_launches_of(cfg).values())} a step)", flush=True)
    for line in logs:
        print(f"  {line}", flush=True)
    if got != want:
        raise AssertionError(f"flash launches {got}, want {want}")
    if not all(ctx.np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    ctx.train_launches = got

    # resumed from the checkpoint after step 3: steps 4 and 5 again
    t0 = time.perf_counter()
    _, state2, resumed = train.train_loop(cfg, params, state, args, opt,
                                          log=logs.append)
    ctx.sync()
    print(f"resumed run: '{[ln for ln in logs if ln.startswith('resumed')]}"
          f"', losses {resumed} in "
          f"{time.perf_counter() - t0:.1f} s (the restore included); "
          f"uninterrupted {[losses[4], losses[5]]}", flush=True)
    if sorted(resumed) != [4, 5]:
        raise AssertionError(f"the resumed run ran steps {sorted(resumed)}")
    del state2
    if [resumed[4], resumed[5]] == [losses[4], losses[5]]:
        print("resumed steps 4-5 bitwise the uninterrupted run's",
              flush=True)
    else:
        batch = train.synthetic_batch(cfg, b, s, 0, dev)
        g1, _ = train.grads_only(cfg, params, batch)
        g2, _ = train.grads_only(cfg, params, batch)
        names = ["/".join(map(str, path)) for path, x, y in zip(
            train.leaf_paths(params), tree_leaves(g1), tree_leaves(g2))
            if not torch.equal(x, y)]
        del g1, g2
        print(f"resumed steps 4-5 differ from the uninterrupted run's by "
              f"{abs(resumed[4] - losses[4]):.3e}, "
              f"{abs(resumed[5] - losses[5]):.3e} (limit {RESUME_ATOL}); "
              f"two gradients of one batch at the same parameters differ "
              f"bitwise in {names}: the embedding's index backward "
              f"(index_put_ with accumulate) sums a token's rows in no "
              f"fixed order", flush=True)
        if max(abs(resumed[k] - losses[k]) for k in (4, 5)) > RESUME_ATOL:
            raise AssertionError("the resumed run parts from the "
                                 "uninterrupted one")

    # 2 steps on one repeated batch: the loss falls; the flash kernel held
    # against its plain version on the inputs these steps gave it
    batch = train.synthetic_batch(cfg, b, s, 0, dev)
    captured = {}
    with flash_inputs(captured):
        params, state, l1 = train.train_step(cfg, opt, params, state, batch,
                                             TRAIN_LR)
        params, state, l2 = train.train_step(cfg, opt, params, state, batch,
                                             TRAIN_LR)
    print(f"one batch twice: loss {l1.item():.6f} -> {l2.item():.6f}",
          flush=True)
    if not l2.item() < l1.item():
        raise AssertionError("the loss did not fall on a repeated batch")
    if ctx.on_card and not captured:
        raise AssertionError("the train steps gave the flash kernel nothing")
    hold_flash(ctx, captured, cfg.name)
    del captured

    # one step's device time split
    with record_ranges(torch, TRAIN_RANGES), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, state, _ = train.train_step(cfg, opt, params, state, batch,
                                            TRAIN_LR)
        ctx.sync()
    split, total = train_time_split(prof)
    if ctx.on_card and (total <= 0 or split["attn_bwd_recompute"] <= 0
                        or split["optimizer"] <= 0):
        raise AssertionError(f"the profiler split is missing a part: "
                             f"{split}")
    share = {k: v / max(total, 1e-9) * 100 for k, v in split.items()}
    print(f"one train step's device time (torch.profiler): "
          + ", ".join(f"{k} {v / 1e3:.3f} ms ({share[k]:.1f}%)"
                      for k, v in split.items())
          + f"; total {total / 1e3:.3f} ms, device busy "
          f"{total / 1e3 / med * 100:.1f}% of the {med:.2f} ms step",
          flush=True)
    ctx.train_record = dict(step_ms=med, tokens_s=b * s / med * 1e3,
                            peak_gb=peak / 1e9, split=split)

    # 2 steps with --compress
    t0 = time.perf_counter()
    params, state, closs = train.train_loop(
        cfg, params, state, train_args(batch=b, seq=s, steps=2,
                                       compress=True, device=dev), opt,
        log=lambda _: None)
    ctx.sync()
    peak = torch.cuda.max_memory_allocated() if ctx.on_card else 0
    print(f"--compress (1% top-k with error feedback), 2 steps: losses "
          f"{closs} in {time.perf_counter() - t0:.1f} s (host clock); "
          f"peak memory allocated {peak / 1e9:.2f} GB", flush=True)
    if not all(ctx.np.isfinite(v) for v in closs.values()):
        raise AssertionError(f"non-finite losses under --compress {closs}")
    del params, state
    if ctx.on_card:
        torch.cuda.empty_cache()


def lm_train_card_vs_cpu_phase(ctx):
    """llama3.2-1b's first 2 layers at full width in f32, B=1, S=256: the
    loss and every gradient leaf (flash kernel forward, plain backward on
    the card) against the CPU's plain path, with the CPU's float64
    witness, leaf by leaf (``tests/_f64.py``; the CPU's runs at nudged
    parameters only where a leaf is refused)."""
    torch = ctx.torch
    from repro_torch.launch import train
    from repro_torch.models.lm.config import Stage
    from repro_torch.optim import tree_leaves, tree_map
    full = ctx.config(LM_ARCH)
    cfg = dataclasses.replace(full, dtype="float32", stages=(
        Stage(full.stages[0].layers, 2),))
    p = arch_params(ctx, LM_ARCH, cfg, 1)
    ctx.build.reset_launches()
    g, loss = train.grads_only(cfg, p, train.synthetic_batch(
        cfg, 1, ctx.cvc_s, 0, ctx.dev))
    ctx.sync()
    launches = {k: v for k, v in ctx.build.launches.items() if v}
    want_l = train_launches_of(cfg) if ctx.on_card else {}
    g = [t.cpu() for t in tree_leaves(g)]
    cpu_p = tree_map(lambda t: t.cpu(), p)
    del p
    t0 = time.perf_counter()
    cbatch = train.synthetic_batch(cfg, 1, ctx.cvc_s, 0, "cpu")
    g32, loss32 = train.grads_only(cfg, cpu_p, cbatch)
    f64 = f64_witness()
    with f64.port_f64():
        g64, loss64 = train.grads_only(
            cfg, tree_map(lambda t: t.double(), cpu_p), cbatch)

    def more():
        for i in range(f64.N_NUDGED):
            rng = ctx.np.random.default_rng(100 + i)
            nudged = tree_map(lambda t: f64.nudged(t, rng), cpu_p)
            r32, _ = train.grads_only(cfg, nudged, cbatch)
            with f64.port_f64():
                r64, _ = train.grads_only(
                    cfg, tree_map(lambda t: t.double(), nudged), cbatch)
            yield tree_leaves(r32), tree_leaves(r64)
    misses, fig = f64.witness_misses(
        g, tree_leaves(g32), tree_leaves(g64),
        ["/".join(map(str, path)) for path in train.leaf_paths(cpu_p)],
        ATOL, more)
    print(f"{LM_ARCH} cut to 2 layers, f32, B=1 S={ctx.cvc_s}: loss card "
          f"{loss.item():.7f} CPU {loss32.item():.7f} (f64 "
          f"{loss64.item():.10f}); gradients, max over {len(g)} leaves of "
          f"max err / the leaf's largest entry (card = port, CPU = ref): "
          + ", ".join(f"{k} {v:.3e}" if isinstance(v, float)
                      else f"{k} {v}" for k, v in fig.items())
          + f"; launches {launches} (want {want_l}); the CPU's runs "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if launches != want_l:
        raise AssertionError(f"launches {launches}, want {want_l}")
    torch.testing.assert_close(loss.cpu(), loss32, atol=ATOL, rtol=RTOL)
    if misses:
        raise AssertionError(f"gradient leaves where the card parts from "
                             f"the CPU beyond the f64 witness (card vs "
                             f"CPU, CPU f32 vs f64, card vs f64): {misses}")


def lm_archs_train_phase(ctx):
    """Train steps (forward, backward with remat, AdamW) per family at
    full width, each model freed before the next: finite loss and
    gradients, the exact flash launches, the flash kernel held against its
    plain version on the inputs the steps gave it, the step time (the
    second of two) and the peak memory beside the bytes reckoned for
    it."""
    torch, dev, build = ctx.torch, ctx.dev, ctx.build
    from repro_torch.launch import train
    from repro_torch.models.lm import init_params
    from repro_torch.models.lm.config import Stage
    from repro_torch.optim import get_optimizer, tree_leaves
    opt = get_optimizer("adamw")
    ctx.arch_train = {}
    for arch, cut, b, s in ctx.arch_train_cases:
        if ctx.on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        if cut == "smoke":
            cfg = ctx.smoke_config(arch)
            params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)
        elif cut == "first-two":
            full = ctx.config(arch)
            cfg = dataclasses.replace(full, stages=(
                Stage(full.stages[0].layers, 1),
                Stage(full.stages[-1].layers, 1)))
            params = arch_params(ctx, arch, cfg, 0)
        else:
            cfg = ctx.config(arch)
            params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                                 dev)
        state = opt.init(params)
        n = sum(t.numel() for t in tree_leaves(params))
        elem = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
        reckoned = n * (2 * elem + 8)
        batch = train.synthetic_batch(cfg, b, s, 0, dev)
        if ctx.on_card:
            torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        captured = {}
        # two steps, the second timed: the first pays each new shape's
        # first use (and the copy of the flash kernel's inputs)
        with flash_inputs(captured):
            for _ in range(2):
                clock = step_clock(ctx)
                grads, loss = train.grads_only(cfg, params, batch)
                finite = torch.stack([torch.isfinite(t).all()
                                      for t in tree_leaves(grads)]).all()
                params, state = train.apply_grads(opt, params, state, grads,
                                                  TRAIN_LR)
                ms = clock()
                finite = bool(finite) and bool(torch.isfinite(loss))
                if not finite:
                    break
        launches = {k: v for k, v in build.launches.items() if v}
        want = train_launches_of(cfg, 2) if ctx.on_card else {}
        peak = torch.cuda.max_memory_allocated() if ctx.on_card else 0
        rows = cfg.vision_prefix_len
        print(f"{arch}{f' ({cut})' if cut else ''}: {cfg.num_layers} "
              f"layers, {cfg.dtype}, {n} parameters, B={b} S={s}"
              f"{f' + {rows} prefix rows' if rows else ''}: "
              f"loss {loss.item():.6f}, every gradient finite {finite}; "
              f"the second step (grads_only + apply_grads) {ms:.1f} ms "
              f"({'CUDA events' if ctx.on_card else 'host clock'}); peak "
              f"memory allocated {peak / 1e9:.2f} GB against "
              f"{reckoned / 1e9:.2f} GB reckoned for params, gradients and "
              f"f32 moments; flash launches {launches} (want {want})",
              flush=True)
        if not finite:
            raise AssertionError(f"{arch}: non-finite loss or gradient")
        if launches != want:
            raise AssertionError(f"{arch}: launches {launches}, want {want}")
        if bool(captured) != bool(want):
            raise AssertionError(f"{arch}: the flash kernel was given "
                                 f"{len(captured)} shapes of input, with "
                                 f"launches {want} wanted")
        hold_flash(ctx, captured, arch)
        del captured
        ctx.arch_train[arch] = dict(launches=launches, peak_gb=peak / 1e9,
                                    step_ms=ms)
        del loss
        del params, state, grads, batch
        if ctx.on_card:
            torch.cuda.empty_cache()


# the mesh phases (ROADMAP Queue 1, item 13)
MESH_DECODE_STEPS = 16
# the sharded model against the same run unsharded on a world-1 mesh: the
# same arithmetic, except where DTensor hands an op a differently laid-out
# operand (a GEMM's kernel may then sum in another order); held within one
# bf16 rounding of the largest value (2^-8 of it), the bitwise
# equality printed beside it
MESH_REL = 2 ** -8
# the expert-parallel MoE: deepseek-v2-lite-16b's layer at full width
MOE_EP_ARCH, MOE_EP_B, MOE_EP_S, MOE_EP_MEMBERS = \
    "deepseek-v2-lite-16b", 4, 1024, 4
# capacity factors: MOE_DROP_CF, at which assignments drop, and NO_DROP_CF,
# at which an expert's bucket holds every token of a member
MOE_DROP_CF = 0.5
# in bf16 the shmap path rounds to bf16 where the plain path stays f32, as
# the reference's does: the expert hidden state, the exchanged outputs and
# a member's output before the shared experts are added; with the final
# sum's own rounding, held within four bf16 roundings of the largest |out|
MOE_BF16_ROUNDINGS = 4
# the dry run's SMOKE sweep: every (arch, kind) cell of the ten LM archs
# on a fake (4, 4) ("data", "model") group at B=8, S=64
SWEEP_MESH, SWEEP_B, SWEEP_S = (4, 4), 8, 64
SWEEP_KINDS = ("prefill", "train", "decode")
# the production cells the background dry run adds to llama3.2-1b's and
# the GCN's: the MoE's and RWKV6's prefill on the (16, 16) mesh
DRYRUN_PREFILL_ARCHS = ("deepseek-v2-lite-16b", "rwkv6-3b")


def mesh_card_phase(ctx):
    """llama3.2-1b under a real device mesh: a world-1 process group
    (``nccl`` on the card, ``gloo`` on the CPU) and a (1, 1) ("data",
    "model") ``DeviceMesh``; parameters placed by ``param_spec``, the cache
    by ``cache_spec``, the batch by ``batch_spec``. Under
    ``logical_rules(logical_rules_for(cfg, mesh), mesh)`` a prefill of
    ``ctx.prefill_s`` tokens (the flash kernel under ``local_map``, one
    launch per layer), MESH_DECODE_STEPS ``decode_step``s and one
    ``launch.train`` step (``grads_only`` + ``apply_grads``; two flash
    launches per layer with remat), each held against the same run
    unsharded. The group is destroyed at the end."""
    torch, np, dev, build = ctx.torch, ctx.np, ctx.dev, ctx.build
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import (
        batch_spec, cache_spec, distribute_tree, logical_rules,
        logical_rules_for, opt_spec, param_spec, placements)
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import (
        decode_step, head_logits, init_cache, init_params, lm_forward)
    from repro_torch.optim.optimizers import (
        get_optimizer, tree_leaves, tree_map)

    dist.init_process_group("nccl" if ctx.on_card else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1))
        cfg = ctx.mesh_cfg
        rules = logical_rules_for(cfg, mesh)
        print(f"{mesh}; rules {rules}", flush=True)

        @contextlib.contextmanager
        def sharded():
            with logical_rules(rules, mesh), implicit_replication():
                yield

        def place(t, name):
            return distribute_tensor(t, mesh, placements(
                mesh, batch_spec(mesh, name, t.shape)), src_data_rank=None)

        def held(what, got, want):
            got = got.full_tensor() if hasattr(got, "full_tensor") else got
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            same = bool(torch.equal(got, want))
            ok = err <= MESH_REL * scale and bool(torch.isfinite(got).all())
            print(f"mesh-card {what}: max err {err:.4g} (max |want| "
                  f"{scale:.4g}, limit {MESH_REL * scale:.4g}), bitwise "
                  f"{same}", flush=True)
            if not ok:
                raise AssertionError(f"the sharded {what} is off the "
                                     f"unsharded one by {err:.4g}")
            return same

        params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        n_layers = cfg.num_layers
        rng = np.random.default_rng(23)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (1, ctx.prefill_s)), device=dev)
        pd = distribute_tree(mesh, params, param_spec)
        specs = {}
        for path, leaf in (((("stages", 0, "layer0", "mixer", "wq")),
                            pd["stages"][0]["layer0"]["mixer"]["wq"]),
                           (("embed", "table"), pd["embed"]["table"])):
            specs[path[-1]] = (param_spec(mesh, path, leaf),
                               tuple(leaf.placements))
        print(f"param placements: {specs}", flush=True)
        bitwise = {}
        with torch.no_grad():
            want = head_logits(cfg, params, lm_forward(cfg, params,
                                                       toks)[:, -1])
            ctx.sync()
            build.reset_launches()
            with sharded():
                got = head_logits(cfg, pd, lm_forward(
                    cfg, pd, place(toks, "tokens"))[:, -1])
            ctx.sync()
            n = build.launches.get("flash_attention", 0)
            print(f"sharded prefill S={ctx.prefill_s}: logits "
                  f"{type(got).__name__} {tuple(got.shape)} placements "
                  f"{tuple(got.placements)}; flash_attention launches {n} "
                  f"(want {n_layers if ctx.on_card else 0})", flush=True)
            if ctx.on_card and n != n_layers:
                raise AssertionError(f"flash_attention launched {n} times "
                                     f"in the sharded prefill")
            ctx.mesh_launches = {"flash_attention": n}
            bitwise["prefill"] = held("prefill logits", got, want)
            del got, want
            cache = init_cache(cfg, 1, MESH_DECODE_STEPS, dev)
            cache_d = distribute_tree(mesh, init_cache(
                cfg, 1, MESH_DECODE_STEPS, dev), cache_spec)
            errs = []
            for i in range(MESH_DECODE_STEPS):
                t = toks[:, i:i + 1]
                lw, _ = decode_step(cfg, params, cache, t, i)
                with sharded():
                    lg, _ = decode_step(cfg, pd, cache_d,
                                        place(t, "tokens"), i)
                errs.append(held(f"decode step {i}", lg, lw))
            bitwise["decode"] = all(errs)
            del cache, cache_d, pd

        # one train step, unsharded and sharded from the same weights
        opt = get_optimizer("adamw")
        batch = train.synthetic_batch(cfg, ctx.train_b, ctx.train_s, 0, dev)
        p1 = tree_map(lambda t: t.clone(), params)
        g1, l1 = train.grads_only(cfg, p1, batch)
        ctx.sync()
        build.reset_launches()
        p2 = distribute_tree(mesh, params, param_spec)
        with sharded():
            g2, l2 = train.grads_only(cfg, p2, {k: place(v, k)
                                                for k, v in batch.items()})
        ctx.sync()
        n = build.launches.get("flash_attention", 0)
        want_n = 2 * n_layers if ctx.on_card else 0
        print(f"sharded train step B={ctx.train_b} S={ctx.train_s}: "
              f"flash_attention launches {n} (want {want_n}); loss "
              f"{float(l1):.6f} unsharded, {float(l2.full_tensor()):.6f} "
              f"sharded", flush=True)
        if n != want_n:
            raise AssertionError(f"flash_attention launched {n} times in "
                                 f"the sharded train step")
        ctx.mesh_launches["flash_attention"] += n
        bitwise["loss"] = held("loss", l2, l1)
        same = [held(f"gradient {'/'.join(map(str, path))}", b, a)
                for path, a, b in zip(train.leaf_paths(g1), tree_leaves(g1),
                                      tree_leaves(g2))]
        bitwise["gradients"] = all(same)
        s1 = opt.init(p1)
        with sharded():
            s2 = distribute_tree(mesh, opt.init(params),
                                 lambda m, p, l: opt_spec(m, p, l, {}))
            p2, s2 = train.apply_grads(opt, p2, s2, g2, TRAIN_LR)
        p1, s1 = train.apply_grads(opt, p1, s1, g1, TRAIN_LR)
        same = [held(f"updated {'/'.join(map(str, path))}", b, a)
                for path, a, b in zip(train.leaf_paths(p1), tree_leaves(p1),
                                      tree_leaves(p2))]
        bitwise["update"] = all(same)
        print(f"mesh-card bitwise against unsharded: {bitwise}", flush=True)
        ctx.mesh_bitwise = bitwise
        del p1, p2, s1, s2, g1, g2, params
    finally:
        dist.destroy_process_group()


def moe_ep_phase(ctx):
    """One deepseek-v2-lite-16b MoE layer at full width (E=64, top-6,
    d_model 2048, expert width 1408, 2 shared experts) through
    ``moe_forward(..., dispatch="shmap")`` over a ``DataMesh`` of
    MOE_EP_MEMBERS entries on ``ctx.dev`` along "model", at B=MOE_EP_B,
    S=MOE_EP_S: with no drops held against the plain ``moe_forward`` (f32
    within ATOL of the largest |out|, bf16 within one bf16 rounding of
    it), each member's exchange bytes beside the reference's 2·E·C·D; at
    MOE_DROP_CF, with drops, each member's tokens held against the plain
    routed experts at the member's capacity, where a dropped assignment
    writes nothing."""
    torch = ctx.torch
    from repro_torch.dist.data_parallel import DataMesh
    from repro_torch.models.lm import moe
    from repro_torch.models.lm.common import dense_init

    base = ctx.config(MOE_EP_ARCH)
    mesh = DataMesh([[ctx.dev] * ctx.moe_members], ("data", "model"))
    gen = torch.Generator(ctx.dev).manual_seed(5)
    p32 = {k: dense_init(gen, s, torch.float32)
           for k, s in sorted(moe.moe_params_shape(base).items())}
    b, s, d = ctx.moe_b, ctx.moe_s, base.d_model
    x32 = torch.randn((b, s, d), generator=gen, device=ctx.dev)
    e = base.moe_num_experts
    print(f"{MOE_EP_ARCH} MoE layer: E={e} top-{base.moe_top_k} d_model "
          f"{d} expert width {base.moe_d_ff} shared {base.moe_num_shared}; "
          f"B={b} S={s} over {mesh}", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        cfg = dataclasses.replace(base, moe_capacity_factor=NO_DROP_CF,
                                  dtype=name)
        p = {k: v.to(dtype) for k, v in p32.items()}
        x = x32.to(dtype)
        whole = moe.moe_forward(cfg, p, x)
        stats = {}
        ctx.sync()
        t0 = time.perf_counter()
        got = moe.moe_forward(cfg, p, x, dispatch="shmap", mesh=mesh,
                              stats=stats)
        ctx.sync()
        sec = time.perf_counter() - t0
        # the plain path on each member's tokens: routing then multiplies
        # the same rows (in bf16 a router logit one rounding off can swap
        # an expert at a tie, whatever the dispatch)
        s_loc = s // stats["ep"]
        want = torch.cat([moe.moe_forward(cfg, p, x[:, j * s_loc:(j + 1) *
                                                    s_loc])
                          for j in range(stats["ep"])], dim=1)
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        err_whole = (got.float() - whole.float()).abs().max().item()
        limit = ATOL * scale if dtype == torch.float32 else \
            MOE_BF16_ROUNDINGS * BF16_REL * scale
        ok = err <= limit
        cap = stats["capacity"]
        formula = 2 * e * cap * d * x.element_size()
        dropped = sum(m["dropped"] for m in stats["members"])
        print(f"moe-ep {name} no drops (capacity factor {NO_DROP_CF}, "
              f"member capacity C={cap}): max err {err:.4g} against "
              f"moe_forward on each member's tokens (max |out| {scale:.4g},"
              f" limit {limit:.4g}), {err_whole:.4g} against moe_forward on "
              f"all of x at once; dropped {dropped}; {sec:.3f} s (host "
              f"clock)", flush=True)
        for j, m in enumerate(stats["members"]):
            both = m["send_bytes"] + m["back_bytes"]
            print(f"  member {j}: sends {m['send_bytes']} B, gets back "
                  f"{m['back_bytes']} B, together {both} B against 2·E·C·D"
                  f" = {formula} B; of it {both * (stats['ep'] - 1) // stats['ep']}"
                  f" B leave the member", flush=True)
            if both != formula:
                raise AssertionError("exchange bytes off 2·E·C·D")
        if dropped or not ok or not torch.isfinite(got).all():
            raise AssertionError(f"the shmap MoE ({name}) is off by "
                                 f"{err:.4g} with {dropped} drops")
        del whole, want, got, p, x
    # drops: each member's tokens against the plain routed experts at the
    # member's capacity (the plain path writes nothing for a drop)
    cfg = dataclasses.replace(base, moe_capacity_factor=MOE_DROP_CF,
                              dtype="float32")
    stats = {}
    got = moe.moe_forward(cfg, p32, x32, dispatch="shmap", mesh=mesh,
                          stats=stats)
    cap, ep = stats["capacity"], stats["ep"]
    s_loc = s // ep
    xt = x32.reshape(-1, d)
    want = torch.cat([moe.routed(cfg, p32, x32[:, j * s_loc:(j + 1) * s_loc]
                                 .reshape(-1, d), cap).reshape(b, s_loc, d)
                      for j in range(ep)], dim=1)
    want = want + moe._shared_out(cfg, p32, xt).reshape(b, s, d)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    dropped = [m["dropped"] for m in stats["members"]]
    print(f"moe-ep f32 with drops (capacity factor {MOE_DROP_CF}, member "
          f"capacity C={cap}): dropped per member {dropped}; max err "
          f"{err:.4g} against each member's plain routed experts at C "
          f"(max |out| {scale:.4g}, limit {ATOL * scale:.4g})", flush=True)
    if not sum(dropped) or not err <= ATOL * scale:
        raise AssertionError("the drop case does not hold")


def moe_mesh_phase(ctx):
    """deepseek-v2-lite-16b's MoE layer at full width (E=64, top-6, d_model
    2048, expert width 1408, 2 shared experts, its capacity factor 1.25)
    on a world-1 (1, 1) ``DeviceMesh`` (``nccl`` on the card, ``gloo`` on
    the CPU), B=``ctx.moe_b``, S=``ctx.moe_s``, f32: the parameters placed
    by ``param_spec`` under ``logical_rules``, through the DTensor einsum
    dispatch (``moe.routed_einsum``: the (T, E, C) one-hot formulation)
    and the expert-parallel path on DTensors (``dispatch="shmap"``:
    ``_ep_member`` inside ``local_map``, its exchanges one-rank functional
    all-to-alls), each held within ATOL of the largest |out| against the
    unsharded layer (the sort path) on the same inputs; the bitwise
    equality and the host-clock seconds printed beside. Two ranks on one
    card cannot be checked: NCCL refuses them. The group is destroyed at
    the end."""
    torch = ctx.torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import (
        distribute_tree, logical_rules, logical_rules_for, param_spec)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import moe
    from repro_torch.models.lm.common import dense_init

    dist.init_process_group("nccl" if ctx.on_card else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1))
        cfg = dataclasses.replace(ctx.config(MOE_EP_ARCH), dtype="float32")
        gen = torch.Generator(ctx.dev).manual_seed(7)
        p = {k: dense_init(gen, s, torch.float32)
             for k, s in sorted(moe.moe_params_shape(cfg).items())}
        b, s, d = ctx.moe_b, ctx.moe_s, cfg.d_model
        x = torch.randn((b, s, d), generator=gen, device=ctx.dev)
        want = moe.moe_forward(cfg, p, x)
        r = moe.route(cfg, p, x.reshape(-1, d))
        scale = want.abs().max().item()
        print(f"{MOE_EP_ARCH} MoE layer on {mesh}: E={cfg.moe_num_experts} "
              f"top-{cfg.moe_top_k} d_model {d} expert width "
              f"{cfg.moe_d_ff}, B={b} S={s}, capacity C={r.capacity} "
              f"(factor {cfg.moe_capacity_factor}), dropped "
              f"{int((~r.keep).sum())} of {r.keep.numel()} assignments; "
              f"unsharded max |out| {scale:.4g}", flush=True)
        pd = distribute_tree(mesh, p, param_spec)
        xd = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        for dispatch in ("einsum", "shmap"):
            stats = {}
            ctx.sync()
            t0 = time.perf_counter()
            with logical_rules(logical_rules_for(cfg, mesh), mesh), \
                    implicit_replication():
                got = moe.moe_forward(cfg, pd, xd, dispatch=dispatch,
                                      stats=stats)
            ctx.sync()
            sec = time.perf_counter() - t0
            got = got.full_tensor()
            err = (got - want).abs().max().item()
            ok = err <= ATOL * scale and bool(torch.isfinite(got).all())
            extra = ""
            if stats:
                m = stats["members"][0]
                extra = (f"; member capacity {stats['capacity']}, sends "
                         f"{m['send_bytes']} B, gets back {m['back_bytes']} "
                         f"B, dropped {m['dropped']}")
            print(f"moe-mesh {dispatch} on DTensors: max err {err:.4g} "
                  f"against the unsharded layer (limit {ATOL * scale:.4g}),"
                  f" bitwise {bool(torch.equal(got, want))}; {sec:.3f} s "
                  f"(host clock){extra}", flush=True)
            if not ok:
                raise AssertionError(f"the {dispatch} MoE on a (1, 1) mesh "
                                     f"is off the unsharded layer by "
                                     f"{err:.4g}")
            del got
    finally:
        dist.destroy_process_group()


def smoke_sweep(out_dir):
    """Every SMOKE cell of the ten LM archs (``SWEEP_KINDS``) through
    ``dryrun.run_cell`` on a fake ``SWEEP_MESH`` group at B=SWEEP_B,
    S=SWEEP_S, in this process (its own fake group): one JSON a cell in
    ``out_dir``, its per-chip counts and seconds or its error. Run as a
    process of its own (``start_dryrun``)."""
    import torch.distributed as dist

    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    os.makedirs(out_dir, exist_ok=True)
    dryrun.fake_group(SWEEP_MESH[0] * SWEEP_MESH[1])
    try:
        mesh = make_test_mesh(SWEEP_MESH)
        for arch in (a for a in ARCH_IDS if not a.startswith("gnn-")):
            for kind in SWEEP_KINDS:
                t0 = time.perf_counter()
                res = {"arch": arch, "kind": kind}
                try:
                    cell = dryrun.run_cell(
                        arch, kind, "smoke", verbose=False, mesh=mesh,
                        cfg=get_smoke_config(arch),
                        shape=ShapeSpec(kind, SWEEP_S, SWEEP_B, kind))
                    res.update(flops=cell["hlo"]["flops"],
                               dot_flops=cell["hlo"]["dot_flops"],
                               collectives=cell["hlo"]["collectives"])
                except Exception as e:  # every cell is tried; phase
                    # dryrun fails the run on any error
                    res.update(error=f"{type(e).__name__}: {e}",
                               traceback=traceback.format_exc()[-3000:])
                res["seconds"] = time.perf_counter() - t0
                with open(os.path.join(out_dir, f"{arch}__{kind}.json"),
                          "w") as f:
                    json.dump(res, f)
    finally:
        dist.destroy_process_group()


def start_dryrun(out_dir, log_path, sweep_dir):
    """Start the dry run's subprocesses (CPU only, at low priority and one
    thread each) while the card phases run, in two chains that run side
    by side, each one command after another: llama3.2-1b at every shape,
    the GCN and deepseek-v2-lite-16b's prefill_32k; rwkv6-3b's
    prefill_32k and the SMOKE sweep (``smoke_sweep`` into ``sweep_dir``).
    Mesh "single". Returns the runner's ``Popen``; its log holds each
    command's wall clock."""
    dry = ["-m", "repro_torch.launch.dryrun"]
    prefill = [(dry + ["--arch", arch, "--shape", "prefill_32k", "--mesh",
                       "single", "--out", out_dir],
                f"{arch} --shape prefill_32k")
               for arch in DRYRUN_PREFILL_ARCHS]
    chains = (
        [(dry + ["--arch", "llama3.2-1b", "--shape", "all", "--mesh",
                 "single", "--out", out_dir], "llama3.2-1b --shape all"),
         (dry + ["--arch", "gnn-gcn", "--mesh", "single", "--out", out_dir],
          "gnn-gcn"), prefill[0]],
        [prefill[1],
         (["-c", f"import sys; sys.path.insert(0, {ROOT!r}); import "
                 f"chip_smoke; chip_smoke.smoke_sweep({sweep_dir!r})"],
          "SMOKE sweep of the ten LM archs on a fake "
          f"{SWEEP_MESH} group")])
    runner = (
        "import subprocess, sys, threading, time\n"
        "failed = []\n"
        "def chain(cmds):\n"
        "    for argv, name in cmds:\n"
        "        t0 = time.perf_counter()\n"
        "        rc = subprocess.call([sys.executable, *argv])\n"
        "        print(f'dryrun {name}: {time.perf_counter() - t0:.1f} s '\n"
        "              f'wall clock, exit {rc}', flush=True)\n"
        "        if rc:\n"
        "            failed.append(name)\n"
        "            return\n"
        f"threads = [threading.Thread(target=chain, args=(c,)) for c in "
        f"{chains!r}]\n"
        "for t in threads:\n"
        "    t.start()\n"
        "for t in threads:\n"
        "    t.join()\n"
        "sys.exit(1 if failed else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    log = open(log_path, "w")
    proc = subprocess.Popen(["nice", "-n", "19", sys.executable, "-c",
                             runner], stdout=log, stderr=subprocess.STDOUT,
                            env=env, cwd=ROOT, start_new_session=True)

    def stop():
        if proc.poll() is None:         # the runner and its dry run
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    atexit.register(stop)
    return proc


def dryrun_phase(ctx):
    """The port's dry run: wait for the subprocesses ``start_dryrun``
    started, print their log, summarize their JSON, fail on a cell with an
    error. Then the one-card anchor: the llama3.2-1b prefill at B=1,
    S=``ctx.prefill_s`` counted as a (1, 1) cell on a fake world-1 group
    (``make_test_mesh((1, 1))``), its GEMM flops outside attention held
    equal to ``FlopCounterMode`` over the same prefill run for real on
    ``ctx.dev`` (the flash kernel is no aten op: attention is added by
    formula), and its roofline beside ``ctx.prefill_ms``, the card's
    measured time for that prefill."""
    torch = ctx.torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import attention, head_logits, init_params
    from repro_torch.models.lm import lm_forward

    rc = ctx.dryrun_proc.wait(timeout=ctx.dryrun_timeout)
    with open(ctx.dryrun_log) as f:
        print("".join(line for line in f if "alltoall" not in line
                      and "redistributing" not in line), flush=True)
    if rc != 0:
        raise AssertionError(f"the dry run exited {rc}")
    cells = []
    for name in sorted(os.listdir(ctx.dryrun_dir)):
        with open(os.path.join(ctx.dryrun_dir, name)) as f:
            cells.append(json.load(f))
    for c in cells:
        if "error" in c:
            print(c.get("traceback", ""), flush=True)
            raise AssertionError(f"dry-run cell {c['arch']} {c['shape']}: "
                                 f"{c['error']}")
        if "roofline" not in c:
            print(f"{c['arch']} {c['shape']}: {c.get('skipped')}")
            continue
        h, r, m = c["hlo"], c["roofline"], c["memory"]
        print(f"dry-run cell {c['arch']} {c['shape']} ({c['chips']} chips): "
              f"per chip {h['flops']:.6g} flops ({h['dot_flops']:.6g} in "
              f"dots), {h['bytes']:.6g} bytes, collectives "
              f"{h['collectives']} ({h['collective_counts']}); roofline at "
              f"H100 constants: compute {r['compute_s']:.6g} s, memory "
              f"{r['memory_s']:.6g} s, collective {r['collective_s']:.6g} s "
              f"-> {r['dominant']}; peak {m['peak_bytes'] / 1e9:.4g} GB "
              f"per chip ({m['hbm_fraction'] * 100:.1f}% of 80 GB); step "
              f"{c['compile_s']} s", flush=True)
    print(subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.summarize", "--dir",
         ctx.dryrun_dir], capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=SRC)).stdout, flush=True)
    missing = {a for a in DRYRUN_PREFILL_ARCHS} - {
        c["arch"] for c in cells if c["shape"] == "prefill_32k"}
    if missing:
        raise AssertionError(f"no prefill_32k cell of {sorted(missing)}")

    # the SMOKE sweep under this machine's torch
    sweep = []
    for name in sorted(os.listdir(ctx.sweep_dir)):
        with open(os.path.join(ctx.sweep_dir, name)) as f:
            sweep.append(json.load(f))
    print(f"SMOKE sweep on a fake {SWEEP_MESH} group, B={SWEEP_B} "
          f"S={SWEEP_S}, torch {torch.__version__}:", flush=True)
    for c in sweep:
        what = c.get("error") or (
            f"per chip {c['flops']:.6g} flops ({c['dot_flops']:.6g} in "
            f"dots), collectives {c['collectives']}")
        print(f"  {c['arch']} {c['kind']} ({c['seconds']:.1f} s): {what}",
              flush=True)
    failed = [c for c in sweep if "error" in c]
    for c in failed:
        print(c["traceback"], flush=True)
    want = 10 * len(SWEEP_KINDS)
    if failed or len(sweep) != want:
        raise AssertionError(f"SMOKE sweep: {len(failed)} of {len(sweep)} "
                             f"cells failed ({want} expected)")

    # the one-card anchor
    cfg = ctx.mesh_cfg
    s = ctx.prefill_s
    dryrun.fake_group(1)
    try:
        mesh = make_test_mesh((1, 1))
        orig = attention.plain_attention

        def scoped(*a, **kw):
            with hlo_analysis.scope("attention"):
                return orig(*a, **kw)
        with unittest.mock.patch.object(attention, "plain_attention",
                                        scoped):
            cell = dryrun.run_cell(
                LM_ARCH, f"prefill_b1_s{s}", "one-card", verbose=False,
                mesh=mesh, cfg=cfg, shape=ShapeSpec(
                    f"prefill_b1_s{s}", s, 1, "prefill"))
    finally:
        dist.destroy_process_group()
    h, r = cell["hlo"], cell["roofline"]
    attn_dots = h["scoped_dot_flops"].get("attention", 0.0)
    gemm = h["dot_flops"] - attn_dots
    params = init_params(cfg, torch.Generator(ctx.dev).manual_seed(0),
                         ctx.dev)
    toks = torch.zeros((1, s), dtype=torch.long, device=ctx.dev)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        head_logits(cfg, params, lm_forward(cfg, params, toks)[:, -1])
    ctx.sync()
    # on the CPU (a rehearsal) the real prefill's attention is the plain
    # version, which the flop counter sees
    real = float(fc.get_total_flops()) - (0.0 if ctx.on_card else attn_dots)
    _, _, attn_flops, _ = attention_bound_ms(
        1, cfg.num_heads, cfg.num_kv_heads, s, cfg.resolved_head_dim, True,
        2, ctx.peak_bf16, ctx.peak_bw)
    attn_flops *= cfg.num_layers
    total = real + attn_flops
    print(f"one-card anchor {LM_ARCH} prefill B=1 S={s} as a (1, 1) cell: "
          f"per chip {h['flops']:.6g} flops ({h['dot_flops']:.6g} in dots, "
          f"of which {attn_dots:.6g} the plain attention's), {h['bytes']:.6g}"
          f" bytes (eager, unfused), collectives {h['collective_bytes']:.6g} "
          f"B; roofline at H100 constants compute {r['compute_s'] * 1e3:.4f}"
          f" ms, memory {r['memory_s'] * 1e3:.4f} ms", flush=True)
    print(f"GEMM flops outside attention: counted {gemm:.0f}, "
          f"FlopCounterMode over the card's prefill {real:.0f} "
          f"({'equal' if gemm == real else 'DIFFERENT'}); with the flash "
          f"kernel's causal attention by formula ({attn_flops:.6g}) the "
          f"card's prefill does {total:.6g} flops: "
          f"{total / ctx.peak_bf16 * 1e3:.4f} ms at the bf16 peak, against "
          f"{ctx.prefill_ms:.3f} ms measured (CUDA events, lm-prefill) = "
          f"{total / ctx.prefill_ms / 1e9:.2f} TFLOP/s", flush=True)
    if gemm != real:
        raise AssertionError(f"the anchor's GEMM flops {gemm} differ from "
                             f"FlopCounterMode's {real}")
    del params


# the examples phase: each port example (``repro_torch.examples``) in the
# order README presents them, with its arguments on the card
EXAMPLES = (
    ("quickstart", ["--backend", "bcsr"]),
    ("serve_gnn", ["--dataset", "arxiv-like", "--backend", "bcsr",
                   "--epochs", "2"]),
    ("train_ibmb_full", ["--dataset", "arxiv-like", "--model", "gcn",
                         "--backend", "bcsr", "--epochs", "3"]),
    ("dynamic_graph", ["--dataset", "small", "--backend", "bcsr",
                       "--epochs", "2"]),
    ("ooc_serve", ["--dataset", "small", "--backend", "bcsr"]),
    ("serve_async", ["--dataset", "small", "--backend", "bcsr",
                     "--epochs", "2"]),
    ("inference_comparison", ["--epochs", "3"]),
    ("serve_lm", ["--arch", LM_ARCH, "--requests", "6", "--slots", "2",
                  "--new-tokens", "8"]),
)
# the CPU's run of the same GNN examples (in a subprocess beside the card
# phases) takes fewer epochs: the figures it is held to do not depend on
# the weights
EXAMPLE_CPU_EPOCHS = {"quickstart": 2, "serve_gnn": 1, "train_ibmb_full": 1,
                      "dynamic_graph": 1, "serve_async": 1,
                      "inference_comparison": 1}
# the weight-independent figures each GNN example's card run shares with
# the CPU's
EXAMPLE_FIGURES = {
    "quickstart": ("num_nodes", "num_edges", "num_classes", "num_train",
                   "train_batches", "val_batches", "train_plan_nbytes",
                   "fingerprint", "test_batches", "batch_runs"),
    "serve_gnn": ("test_batches", "test_plan_nbytes", "fingerprint",
                  "batch_runs", "requests", "lru_hits", "burst_runs",
                  "train_batches", "val_batches"),
    "train_ibmb_full": ("num_nodes", "num_edges", "num_train",
                        "fingerprints", "train_batches", "val_batches",
                        "test_batches", "max_nodes", "max_edges", "hidden"),
    "dynamic_graph": ("batches", "fingerprint", "batch_runs_v0",
                      "lru_hits_v0", "delta", "refresh", "child_version",
                      "child_fingerprint", "invalidated", "kept",
                      "new_runs", "dirty", "versions", "swap_count",
                      "evictions"),
    "ooc_serve": ("batches", "payload_nbytes", "fingerprint", "loads",
                  "hits", "evictions", "resident", "resident_bytes",
                  "num_shards", "shards_hit", "bitwise_equal", "batch_runs"),
    "serve_async": ("batches", "fingerprint", "rejected", "child_version",
                    "swaps", "requests", "train_batches", "val_batches"),
    "inference_comparison": ("train_batches", "val_batches", "batches"),
}


def jsonable(x):
    """``x`` with tuples, numpy scalars and arrays and non-string keys
    made what JSON writes and reads back alike."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if hasattr(x, "tolist"):
        return x.tolist()
    return x


def example_figures(name, fig):
    """The figures of one GNN example's run that ``EXAMPLE_FIGURES`` names
    (for inference_comparison, each method's batch count), and ooc_serve's
    logits (its GCN is untrained: the same weights on both devices)."""
    fig = dict(fig)
    if name == "inference_comparison":
        fig["batches"] = {k: m["batches"] for k, m in fig["methods"].items()}
    out = {k: fig[k] for k in EXAMPLE_FIGURES[name]}
    if name == "ooc_serve":
        out["logits"] = fig["logits"]
    return jsonable(out)


def example_argv(name, argv, tmp, epochs=None):
    """``argv`` with train_ibmb_full's checkpoint and plan directories
    under ``tmp`` and, where given, ``--epochs`` replaced."""
    argv = list(argv)
    if name == "train_ibmb_full":
        argv += ["--ckpt-dir", os.path.join(tmp, "ckpt"),
                 "--plan-dir", os.path.join(tmp, "plans")]
    if epochs is not None:
        argv += ["--epochs", str(epochs)]
    return argv


def examples_on_cpu(examples, tmp, out_path=None):
    """Each GNN example of ``examples`` (name, argv) run on the CPU with
    ``EXAMPLE_CPU_EPOCHS``; returns (and with ``out_path`` writes as JSON)
    each one's ``example_figures`` and seconds."""
    import importlib
    out = {}
    for name, argv in examples:
        if name not in EXAMPLE_FIGURES:
            continue
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        t0 = time.perf_counter()
        fig = mod.main(example_argv(name, argv, os.path.join(tmp, name),
                                    EXAMPLE_CPU_EPOCHS.get(name)) +
                       ["--device", "cpu"])
        out[name] = dict(figures=example_figures(name, fig),
                         seconds=time.perf_counter() - t0)
    if out_path is not None:
        with open(out_path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(out_path + ".tmp", out_path)
    return out


def start_examples_cpu(out_path, log_path, tmp):
    """Start ``examples_on_cpu`` over ``EXAMPLES`` in a subprocess at low
    priority on 3 threads, beside the card phases. Returns its
    ``Popen``."""
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            f"sys.path.insert(0, {SRC!r}); import torch; "
            f"torch.set_num_threads(3); import chip_smoke; "
            f"chip_smoke.examples_on_cpu(chip_smoke.EXAMPLES, {tmp!r}, "
            f"{out_path!r})")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="3")
    log = open(log_path, "w")
    proc = subprocess.Popen(["nice", "-n", "19", sys.executable, "-c", code],
                            stdout=log, stderr=subprocess.STDOUT, env=env,
                            cwd=ROOT, start_new_session=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    atexit.register(stop)
    return proc


def wait_examples_cpu(proc, out_path, log_path, timeout):
    """Wait for ``start_examples_cpu``'s run; fails if it fails. Returns
    its figures."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the CPU's run of the examples took longer "
                             f"than {timeout} s")
    with open(log_path) as f:
        log = f.read()
    if rc:
        raise AssertionError(f"the CPU's run of the examples exited {rc}:\n"
                             f"{log[-4000:]}")
    with open(out_path) as f:
        return json.load(f)


def example_spmm_want(name, fig):
    """The exact number of ``spmm_bcsr`` launches an example's run makes
    under a fixed bcsr backend (0 on segment): each train step aggregates
    once per layer forward and once per layer backward, each evaluated or
    served batch once per layer. None where no count is fixed (ooc_serve:
    its shard engines keep their own counters)."""
    if fig.get("backend", "bcsr") == "segment" or name == "serve_lm":
        return 0
    n_l = fig["num_layers"]

    def fit(ep):
        return 2 * n_l * fig["train_batches"] * ep + \
            n_l * fig["val_batches"] * ep
    if name == "quickstart":
        return fit(fig["epochs_run"]) + n_l * (fig["test_batches"] +
                                               fig["batch_runs"])
    if name in ("serve_gnn", "dynamic_graph"):
        return fit(fig["epochs_run"]) + n_l * fig["total_batch_runs"]
    if name == "train_ibmb_full":
        return fit(fig["epochs_run"]) + n_l * fig["test_batches"]
    if name == "serve_async":
        return sum(fit(ep) for ep in fig["epochs_run"].values()) + n_l * sum(
            e["batch_runs"] for e in fig["engines"].values())
    if name == "inference_comparison":
        return fit(fig["epochs_run"]) + n_l * sum(
            fig["methods"][k]["batches"] for k in ("ibmb_node",
                                                   "ibmb_batch"))
    return None


def served_on_cpu(ctx, served):
    """The CPU engine's answer to a GNN example's query, from the card's
    trained parameters on the same Plan: the card's logits within ATOL."""
    from repro_torch.optim import tree_map
    from repro_torch.serve import GNNInferenceEngine
    params = tree_map(lambda t: t.cpu(), served["params"])
    want = GNNInferenceEngine(served["plan"], served["cfg"], params,
                              backend=served["backend"],
                              device="cpu").query(served["query"])
    got = served["logits"]
    err = float(ctx.np.abs(got - want).max())
    ctx.np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    return err


def examples_phase(ctx):
    """Every port example's ``main`` in-process on ``ctx.dev`` with
    ``ctx.examples`` (name, argv): its seconds and launches; on the card
    the exact ``spmm_bcsr`` count (``example_spmm_want``), above 0 on
    every bcsr example, and no flash launch in serve_lm's decode-only
    engine. Then each GNN example's weight-independent figures equal to
    ``ctx.cpu_examples()`` (the same examples on the CPU), and served
    logits (evaluate losses for train_ibmb_full and the full-batch
    baseline) from the card's trained parameters against the CPU's within
    ATOL. serve_lm runs twice on the same weights: the same greedy tokens;
    then one batched prefill of the served sequences through ``lm_forward``
    (16 flash launches on the card), the kernel held on its own inputs
    (``hold_flash``), its logits beside the plain path's. Sets
    ``ctx.example_launches``."""
    import importlib
    torch, np, build = ctx.torch, ctx.np, ctx.build
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.lm import head_logits, init_params, lm_forward
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models.lm import attention as lm_attention
    runs, totals = {}, {}
    for name, argv in ctx.examples:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        argv = example_argv(name, argv, os.path.join(ctx.work, name)) + [
            "--device", str(ctx.dev)]
        build.reset_launches()
        t0 = time.perf_counter()
        if name == "serve_lm":
            args = mod.parser().parse_args(argv)
            cfg = get_smoke_config(args.arch) if args.smoke else \
                get_config(args.arch)
            lm_params = init_params(cfg, torch.Generator(ctx.dev)
                                    .manual_seed(0), ctx.dev)
            fig = mod.run(args, params=lm_params)
            lm_run = mod, args, cfg, lm_params
        else:
            fig = mod.main(argv)
        ctx.sync()
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in build.launches.items() if v}
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        want = example_spmm_want(name, fig)
        print(f"example {name} {' '.join(argv)}: {secs:.2f} s (host "
              f"clock), launches {counts}, spmm_bcsr wanted "
              f"{'above 0' if want is None else want}", flush=True)
        if ctx.on_card:
            got = counts.get("spmm_bcsr", 0)
            bcsr = "bcsr" in argv
            if (want is not None and got != want) or (bcsr and got == 0):
                raise AssertionError(f"{name}: spmm_bcsr launched {got} "
                                     f"times, want {want}")
            if name == "serve_lm" and counts.get("flash_attention", 0):
                raise AssertionError("serve_lm's engine launched the flash "
                                     "kernel: it runs decode steps only")
        runs[name] = dict(fig=fig, seconds=secs, counts=counts)

    # the same examples on the CPU: weight-independent figures equal
    cpu = ctx.cpu_examples()
    for name, r in cpu.items():
        got = example_figures(name, runs[name]["fig"])
        mine = {k: v for k, v in got.items() if k != "logits"}
        theirs = {k: v for k, v in r["figures"].items() if k != "logits"}
        if mine != theirs:
            raise AssertionError(f"{name}: card figures {mine} != CPU "
                                 f"figures {theirs}")
        line = f"example {name}: {len(mine)} figures equal to the CPU's " \
               f"run ({r['seconds']:.1f} s there)"
        if name == "ooc_serve":
            a, b = np.asarray(got["logits"]), np.asarray(r["figures"][
                "logits"])
            line += f"; logits max_abs_err {float(np.abs(a - b).max()):.3e}"
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
        print(line, flush=True)
    # the card's trained parameters served and evaluated on the CPU
    for name in ("quickstart", "serve_gnn", "dynamic_graph", "serve_async"):
        err = served_on_cpu(ctx, runs[name]["fig"]["served"])
        print(f"example {name}: served logits, card vs CPU from the card's "
              f"trained parameters, max_abs_err {err:.3e}", flush=True)
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.graph.sampling import make_batcher
    from repro_torch.optim import tree_map
    from repro_torch.train import GNNTrainer
    for name, batches, loss in (
            ("train_ibmb_full", runs["train_ibmb_full"]["fig"]["test_plan"],
             runs["train_ibmb_full"]["fig"]["test_loss"]),
            ("inference_comparison", make_batcher(
                "full_batch", get_dataset("small"), split="test")
             .epoch_batches(0),
             runs["inference_comparison"]["fig"]["methods"]["full_batch"][
                 "loss"])):
        fig = runs[name]["fig"]
        backend = fig["backend"] if name == "train_ibmb_full" else "segment"
        want = GNNTrainer(fig["cfg"], backend=backend, device="cpu") \
            .evaluate(tree_map(lambda t: t.cpu(), fig["params"]),
                      batches)["loss"]
        print(f"example {name}: evaluate loss {loss:.6f} on the card, "
              f"{want:.6f} on the CPU from the card's parameters", flush=True)
        if not abs(loss - want) <= ATOL + RTOL * abs(want):
            raise AssertionError(f"{name}: evaluate loss {loss} on the card, "
                                 f"{want} on the CPU")

    # serve_lm: the same tokens again; one prefill of what it served
    lm = runs["serve_lm"]["fig"]
    mod, args, cfg, lm_params = lm_run
    again = mod.run(args, params=lm_params)
    if again["tokens"] != lm["tokens"]:
        raise AssertionError(f"serve_lm's greedy tokens differ between two "
                             f"runs: {lm['tokens']} then {again['tokens']}")
    seqs = torch.as_tensor([p + t[:-1] for p, t in zip(lm["prompts"],
                                                       lm["tokens"])],
                           device=ctx.dev)
    captured = {}
    build.reset_launches()
    with torch.no_grad(), flash_inputs(captured):
        logits = head_logits(cfg, lm_params, lm_forward(cfg, lm_params,
                                                        seqs)).float()
    ctx.sync()
    flash = build.launches.get("flash_attention", 0)
    totals["flash_attention"] = totals.get("flash_attention", 0) + flash
    n_att = cfg.num_layers
    with torch.no_grad(), unittest.mock.patch.object(
            lm_attention, "flash_attention",
            lambda q, k, v, causal=True, window=0, impl=None: attention_ref(
                q, k, v, causal=causal, window=window)):
        plain = head_logits(cfg, lm_params, lm_forward(cfg, lm_params,
                                                       seqs)).float()
    scale = plain.abs().max().item() + 1e-9
    gap = (logits - plain).abs().max().item()
    # the first requests (one per slot) start at position 0, as the
    # prefill does; later ones join the lockstep engine at its position
    n_p, slots = len(lm["prompts"][0]), args.slots
    agree = (logits[:slots, n_p - 1:].argmax(-1).cpu() == torch.as_tensor(
        lm["tokens"][:slots])).float().mean().item()
    print(f"example serve_lm: the same {sum(map(len, lm['tokens']))} greedy "
          f"tokens in a second run; one prefill of the {len(seqs)} served "
          f"sequences (B={seqs.shape[0]}, S={seqs.shape[1]}): "
          f"flash_attention launches {flash} (want {n_att} when the kernel "
          f"runs); logits {tuple(logits.shape)}, flash vs plain prefill "
          f"max_abs_err {gap:.3e} / max |logit| {scale:.4f} = "
          f"{gap / scale:.3e}; the prefill's argmax equal to the engine's "
          f"greedy tokens at {agree * 100:.1f}% of the positions of the "
          f"{slots} requests that started at position 0", flush=True)
    if ctx.on_card and flash != n_att:
        raise AssertionError(f"serve_lm's prefill launched flash_attention "
                             f"{flash} times, want {n_att}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    if ctx.on_card:
        hold_flash(ctx, captured, "serve_lm's prefill")
    print("examples: " + ", ".join(f"{k} {r['seconds']:.2f} s" for k, r in
                                   runs.items()) + f"; launches {totals}",
          flush=True)
    ctx.example_launches = totals


def spearman(np, a, b) -> float:
    """Spearman's rank correlation (tests/test_influence.py)."""
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra ** 2).sum()
                                           * (rb ** 2).sum()))


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
        binary_tiles, csr_to_bcsr, spmm_bcsr, spmm_bcsr_ref,
        spmm_bcsr_stream, spmm_bcsr_sym)

    # the port's dry run (CPU only) runs beside the card phases; phase
    # dryrun reads it
    dry_tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    atexit.register(shutil.rmtree, dry_tmp, ignore_errors=True)
    dry_dir = os.path.join(dry_tmp, "cells")
    dry_log = os.path.join(dry_tmp, "dryrun.log")
    sweep_dir = os.path.join(dry_tmp, "sweep")
    dry_proc = start_dryrun(dry_dir, dry_log, sweep_dir)

    with phase("build"):
        t0 = time.perf_counter()
        paths = build.build_all()
        for src, path in paths.items():
            build.load_library(src)
            print(f"{src} -> {path}", flush=True)
        print(f"built {len(paths)} sources in parallel in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for src in sorted({src for src, _ in KERNELS.values()}):
            if "spmm" in src:
                spmm_build_report(build, os.path.basename(src))
        # the flash kernels' head-dim-256 instantiations: registers and
        # spills (their O accumulator alone is 128 registers a thread)
        d256 = [r for r in ptxas_report(build.build_log(os.path.basename(
            KERNELS["flash_attention"][0]))) if "Li256E" in r[0]]
        for name, regs, stack, spill_st, spill_ld in d256:
            print(f"ptxas {name}: {regs} registers, {stack} bytes stack, "
                  f"{spill_st}/{spill_ld} bytes spill stores/loads",
                  flush=True)
        if len(d256) != 2 or any(r[3] or r[4] for r in d256):
            raise AssertionError(f"want the f32 and bf16 flash kernels at "
                                 f"head dim 256, without spills: {d256}")

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

    def check_pattern(cols, vals, x, label, backward=True):
        """The pattern kernel against the plain version on the binary
        tiles, forward and (through ``spmm_bcsr_sym``) backward."""
        bins = binary_tiles(vals, torch.float32)
        got = spmm_bcsr(cols, vals, x, pattern=True)
        want = spmm_bcsr_ref(cols, bins, x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        note("spmm_bcsr_pattern", err, label, bool(torch.allclose(
            got, want, atol=ATOL, rtol=RTOL) and torch.isfinite(got).all()))
        if not backward:
            return
        xg = x.clone().requires_grad_(True)
        g = torch.randn(got.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(7))
        spmm_bcsr_sym(cols, vals, xg, pattern=True).backward(g)
        want = spmm_bcsr_ref(cols, bins, g)
        torch.cuda.synchronize()
        note("spmm_bcsr_pattern", (xg.grad - want).abs().max().item(),
             label + " backward", bool(torch.allclose(
                 xg.grad, want, atol=ATOL, rtol=RTOL)))

    def check_pattern_edges(bc, f, label):
        """The pattern kernel on the edge cases of ``check_spmm_edges``
        (an all-zero slot, column tiles outside x, two calls bitwise equal,
        a NaN x row reaching only its readers), and a NaN tile value,
        which is not zero and so counts as 1."""
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
        seen_b = binary_tiles(seen_v, torch.float32)
        x = torch.as_tensor(rng.normal(size=(padded.num_cols, f))
                            .astype(np.float32), device=dev)
        got, again = (spmm_bcsr(cols, vals, x, pattern=True)
                      for _ in range(2))
        want = spmm_bcsr_ref(seen_c, seen_b, x)
        torch.cuda.synchronize()
        note("spmm_bcsr_pattern", (got - want).abs().max().item(),
             f"{label} all-zero slot, column tiles outside x, two calls "
             f"bitwise equal", bool(torch.allclose(
                 got, want, atol=ATOL, rtol=RTOL)) and
             torch.equal(got.view(torch.int32), again.view(torch.int32)))
        r0, k0, _i, j0 = (int(v) for v in (seen_v != 0).nonzero()[0])
        p = int(seen_c[r0, k0]) * b + j0
        readers = ((seen_v[..., p % b] != 0) &
                   (seen_c == p // b)[..., None]).any(dim=1).reshape(-1)
        xn, xz = x.clone(), x.clone()
        xn[p], xz[p] = float("nan"), 0.0
        got = spmm_bcsr(cols, vals, xn, pattern=True)
        want_z = spmm_bcsr_ref(seen_c, seen_b, xz)
        torch.cuda.synchronize()
        rest = ~readers
        note("spmm_bcsr_pattern", (got[rest] - want_z[rest]).abs().max()
             .item(), f"{label} NaN x row {p} ({int(readers.sum())} "
                      f"readers)",
             torch.equal(torch.isnan(got).all(dim=1), readers) and
             not bool(torch.isnan(got[rest]).any()) and
             bool(torch.allclose(got[rest], want_z[rest], atol=ATOL,
                                 rtol=RTOL)))
        nan_v = vals.clone()
        nan_v[r0, k0, _i, j0] = float("nan")
        got = spmm_bcsr(cols, nan_v, x, pattern=True)
        torch.cuda.synchronize()
        note("spmm_bcsr_pattern", (got - want).abs().max().item(),
             f"{label} a NaN value counted as 1",
             bool(torch.isfinite(got).all()) and
             torch.equal(got.view(torch.int32), again.view(torch.int32)))

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
        name = "flash_attention_d256" if q.shape[-1] == 256 \
            else "flash_attention"
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             window=window)
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        limit = ATOL + (BF16_REL * want.abs() if q.dtype == torch.bfloat16
                        else 0.0)
        err = diff.max().item()
        note(name, err, f"{label} (worst error / limit "
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
                check_pattern(cols, vals, x, f"random B={b} "
                                             f"K={cols.shape[1]} F={f}")
            for f in (40, 300):
                check_spmm_edges(bc, f, f"random B={b} F={f}")
                check_pattern_edges(bc, f, f"random B={b} F={f}")
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
        # head dim 256, up to recurrentgemma's 10 query heads over 1 kv head
        # and its window of 2048
        for dtype, causal, window, s, g in itertools.product(
                (torch.float32, torch.bfloat16), (True, False),
                (0, 64, 2048), (128, 200, 4095), (1, 4, 10)):
            q = bshd(torch, gen, (1, s, g, 256), dtype, dev)
            k, v = (bshd(torch, gen, (1, s, 1, 256), dtype, dev)
                    for _ in range(2))
            check_flash(q, k, v, causal, window, f"random {dtype} causal="
                        f"{causal} window={window} S={s} D=256 G={g}")

    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.graph.datasets import get_dataset

    with phase("plan"):
        ds = get_dataset("arxiv-like")
        pipe = IBMBPipeline(ds, IBMBConfig(variant="node", backend="bcsr"))
        plans, plan_s = {}, {}
        for split in ("train", "val", "test"):
            t0 = time.perf_counter()
            plan = pipe.plan(split, for_inference=split != "train")
            plan_s[split] = time.perf_counter() - t0
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
    from repro_torch.configs import gnn_gcn
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.train import GNNTrainer

    cfg = dataclasses.replace(gnn_gcn.CONFIG, in_dim=ds.feat_dim,
                              out_dim=ds.num_classes)
    launches = {}
    train_plan, val_plan = plans["train"], plans["val"]
    from torch.profiler import ProfilerActivity, profile

    def fit_two_epochs(cfg_k, backend):
        """``GNNTrainer.fit`` for 2 epochs on the train Plan with the
        launch counts reset first: finite history, parameters moved.
        Returns the trainer, the result and the launch counts."""
        trainer = GNNTrainer(cfg_k, optimizer="adam", lr=1e-3,
                             backend=backend)
        init = [t.clone() for t in tree_leaves(trainer.init_params())]
        build.reset_launches()
        t0 = time.perf_counter()
        result = trainer.fit(train_plan, val_plan, ds.num_classes, epochs=2)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = {k: v for k, v in build.launches.items() if v}
        prev = 0.0
        for h in result.history:
            print(f"epoch {h['epoch']}: train_loss {h['train_loss']:.6f} "
                  f"val_loss {h['val_loss']:.6f} val_acc {h['val_acc']:.4f} "
                  f"lr {h['lr']:.2e}, {h['time'] - prev:.3f} s with "
                  f"evaluation", flush=True)
            prev = h["time"]
        print(f"fit: {len(train_plan) * len(result.history)} train steps, "
              f"{len(val_plan)} val batches x {len(result.history)} "
              f"evaluations in {fit_s:.3f} s; train time per epoch "
              f"{result.time_per_epoch:.3f} s; launches {counts}",
              flush=True)
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
        return trainer, result, counts

    def step_vs_cpu(cfg_k, backend, params, host):
        """One train step on the card against the same step on the CPU, at
        dropout 0, from the same parameters and batch: the loss within ATOL
        and every gradient element within ATOL and RTOL, but for one that
        a kink explains (``tests/_kinks.py``): the ReLU and GAT's LeakyReLU
        inputs are recorded on both devices, and where one lies within
        ``KINK_ULPS`` ulps of 0 on opposite sides, the CPU's step is taken
        again on the card's side of every such flip; an element that this
        recomputation holds within ATOL and RTOL is excused. Prints the
        flips and how many elements they excused, with the largest error;
        fails on a flip farther from 0, an element the recomputation does
        not hold, or more of a leaf excused than ``MAX_SHARE`` of it (at
        least one element) for each flip."""
        kinks = kink_rule()
        cfg0 = dataclasses.replace(cfg_k, dropout=0.0)
        card = GNNTrainer(cfg0, backend=backend)._steps_for(
            backend, 0)["grad"]
        cpu = GNNTrainer(cfg0, backend=backend, device="cpu")._steps_for(
            backend, 0)["grad"]
        cpu_params = tree_map(lambda t: t.cpu(), params)
        with kinks.kink_trace() as on_card:
            got_l, got_g = card(params, stage(host, dev), None)
        with kinks.kink_trace() as on_cpu:
            want_l, want_g = cpu(cpu_params, stage(host, "cpu"), None)
        flips = kinks.flips(on_card.inputs, on_cpu.inputs)
        forced = None
        if flips:
            with kinks.kink_trace(kinks.sides_of(on_card.inputs)):
                forced = tree_leaves(cpu(cpu_params, stage(host, "cpu"),
                                         None)[1])
        got_g, want_g = tree_leaves(got_g), tree_leaves(want_g)
        excused, excused_err, problems = kinks.kink_witness(
            got_g, want_g, forced, ATOL, RTOL, kinks.leaf_names(params),
            len(flips))
        problems += kinks.flip_problems(flips)
        worst = max([abs(got_l.item() - want_l.item())] + [
            (a.cpu() - b).abs().max().item() for a, b in zip(got_g, want_g)])
        torch.testing.assert_close(got_l.cpu(), want_l, atol=ATOL, rtol=RTOL)
        print(f"train step, card vs CPU (dropout 0): loss {got_l.item():.6f}"
              f" vs {want_l.item():.6f}, loss and gradients max_abs_err "
              f"{worst:.3e}; {len(flips)} ReLU/LeakyReLU inputs on opposite "
              f"sides of 0 (at most "
              f"{max([u for *_, u in flips], default=0.0):.2f} ulps from "
              f"it), {excused} gradient elements outside ATOL/RTOL excused "
              f"by them (largest error {excused_err:.3e})", flush=True)
        for c, idx, a, b, u in flips[:8]:
            print(f"  flip: traced call {c} at {idx}: card {a:.3e}, CPU "
                  f"{b:.3e} ({u:.2f} ulps)", flush=True)
        if problems:
            raise AssertionError("card vs CPU step: " + "; ".join(problems))

    def profile_step(trainer, backend, params, host, kinds, rows=12):
        """One train step's device time: staging on the side stream, then
        the step on the current stream, under the profiler, split by
        ``kinds``. Returns the step function and the optimizer state."""
        steps_fn = trainer._steps_for(backend, 0)["train"]
        opt_state = trainer.opt.init(params)
        side = torch.cuda.Stream(dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            batch = consume(stage_batch(host, dev, side), dev)
            steps_fn(params, opt_state, batch, 1e-3,
                     torch.Generator(dev).manual_seed(0))
            torch.cuda.synchronize()
        split = device_time_split(prof, torch, kinds)
        total = sum(split.values())
        if total <= 0:
            raise AssertionError("the profiler recorded no device time")
        print("one train step's device time (torch.profiler): " + ", ".join(
            f"{k} {v / 1e3:.3f} ms ({v / total * 100:.1f}%)"
            for k, v in split.items()) + f"; total {total / 1e3:.3f} ms",
            flush=True)
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=rows), flush=True)
        return steps_fn, opt_state

    with phase("train"):
        trainer, result, counts = fit_two_epochs(cfg, "bcsr")
        launches["spmm_bcsr"] = counts.get("spmm_bcsr", 0)
        steps = len(train_plan) * len(result.history)
        want = 2 * cfg.num_layers * steps + \
            cfg.num_layers * len(val_plan) * len(result.history)
        print(f"spmm_bcsr launches {launches['spmm_bcsr']} (want {want} = "
              f"6 x {steps} + 3 x {len(val_plan)} x "
              f"{len(result.history)})", flush=True)
        if launches["spmm_bcsr"] != want:
            raise AssertionError(f"spmm_bcsr launched "
                                 f"{launches['spmm_bcsr']} times, want {want}")
        host = train_plan.cache[0]
        step_vs_cpu(cfg, "bcsr", result.params, host)
        steps_fn, opt_state = profile_step(trainer, "bcsr", result.params,
                                           host, GNN_KINDS)

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
            return params, state

        epoch_of_steps()                                  # warm
        t0 = time.perf_counter()
        epoch_of_steps()
        wall = (time.perf_counter() - t0) * 1e3 / len(train_plan)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # trained parameters and Adam state, for the checkpoint phase
            gcn_params, gcn_opt = epoch_of_steps()
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
        serve_answers = answers            # the mesh engine's yardstick

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

    from repro_torch.configs import gnn_gat, gnn_sage
    from repro_torch.core import GraphDelta, check_routing
    from repro_torch.models.gnn import BackendPolicy

    def serve_vs_cpu(cfg_k, backend, params, what):
        """Cold queries through ``GNNInferenceEngine`` on the test Plan
        (p50/p95 on the host clock), then every test node on the card
        against the same engine on the CPU."""
        plan = plans["test"]
        eng = GNNInferenceEngine(plan, cfg_k, params, backend=backend,
                                 cache_batches=0)
        lat = []
        for q in queries[:32]:
            t0 = time.perf_counter()
            a = eng.query(q)
            lat.append(time.perf_counter() - t0)
            if a.shape != (16, cfg_k.out_dim) or not np.isfinite(a).all():
                raise AssertionError(f"bad logits: shape {a.shape}")
        p50, p95 = np.percentile(np.array(lat) * 1e3, [50, 95])
        ids = plan.routing.node_ids
        got = eng.query(ids)
        want = GNNInferenceEngine(plan, cfg_k, params, backend=backend,
                                  cache_batches=0, device="cpu").query(ids)
        err = float(np.abs(got - want).max())
        print(f"{what} serving: {len(lat)} queries of 16 ids, latency p50 "
              f"{p50:.2f} ms p95 {p95:.2f} ms (host clock); all "
              f"{len(ids)} test nodes, card vs CPU engine max_abs_err "
              f"{err:.3e}", flush=True)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    with phase("sage"):
        cfg_s = dataclasses.replace(gnn_sage.CONFIG, in_dim=ds.feat_dim,
                                    out_dim=ds.num_classes)
        bcsr = BackendPolicy.fixed("bcsr")
        trainer, result, counts = fit_two_epochs(cfg_s, bcsr)
        launches["spmm_bcsr_pattern"] = counts.get("spmm_bcsr_pattern", 0)
        # a train step aggregates once per layer forward and once per layer
        # backward but the first (its input, the raw features, needs no
        # gradient); an evaluated val batch once per layer
        n_l, evals = cfg_s.num_layers, len(result.history)
        steps = len(train_plan) * evals
        want = (2 * n_l - 1) * steps + n_l * len(val_plan) * evals
        print(f"spmm_bcsr_pattern launches {launches['spmm_bcsr_pattern']} "
              f"(want {want} = {2 * n_l - 1} x {steps} + {n_l} x "
              f"{len(val_plan)} x {evals}); other SpMM launches "
              f"{ {k: v for k, v in counts.items() if k != 'spmm_bcsr_pattern'} }",
              flush=True)
        if launches["spmm_bcsr_pattern"] != want or len(counts) != 1:
            raise AssertionError(f"SAGE fit launched {counts}, want "
                                 f"spmm_bcsr_pattern {want} and nothing "
                                 f"else")
        host = train_plan.cache[0]
        step_vs_cpu(cfg_s, "bcsr", result.params, host)
        profile_step(trainer, "bcsr", result.params, host, SAGE_KINDS, 8)
        serve_vs_cpu(cfg_s, bcsr, result.params, "SAGE bcsr")

        # the pattern kernel at the shapes SAGE gives it: F = 128 (layer 0)
        # and 256 (layers 1-2), against its plain version, timed queued in
        # turns with the weighted kernel on the same tiles and x
        for split in ("train", "test"):
            fields = plans[split].cache.fields
            cols = torch.as_tensor(fields["tile_cols"][0], device=dev)
            vals = torch.as_tensor(fields["tile_vals"][0], device=dev)
            n_cols = vals.shape[0] * vals.shape[3]
            bins = binary_tiles(vals, torch.float32)
            bsr = bsr_of(torch, cols, bins, n_cols)
            for f in (128, 256):
                x = torch.as_tensor(rng.normal(size=(n_cols, f))
                                    .astype(np.float32), device=dev)
                label = f"arxiv-like {split} batch 0 F={f}"
                check_pattern(cols, vals, x, label)
                bd = spmm_bound_ms(cols, vals, x, peak_flops, peak_bw)
                plain = queued_ms(torch, lambda: spmm_bcsr_ref(
                    cols, binary_tiles(vals, torch.float32), x), 5)
                lib_err = (bsr @ x - spmm_bcsr_ref(cols, bins, x)).abs().max()
                lib = queued_ms(torch, lambda: bsr @ x, 10)
                turns = [queued_ms(torch, lambda p=p: spmm_bcsr(
                    cols, vals, x, pattern=p), 10)
                    for p in (True, False, False, True)]
                ms, gcn_ms = (turns[0] + turns[3]) / 2, (turns[1] +
                                                         turns[2]) / 2
                print(f"spmm_bcsr_pattern {label} (R={vals.shape[0]} "
                      f"K={vals.shape[1]}): kernel {ms:.4f} ms (queued; "
                      f"turns {turns[0]:.4f}, {turns[3]:.4f}), the weighted "
                      f"kernel on the same tiles {gcn_ms:.4f} ms (turns "
                      f"{turns[1]:.4f}, {turns[2]:.4f}; pattern/weighted "
                      f"{ms / gcn_ms:.3f}), plain (spmm_bcsr_ref on the "
                      f"binary tiles, their making included) {plain:.4f} "
                      f"ms, library (sparse_bsr_tensor of the binary "
                      f"nonzero tiles @ x, err {lib_err.item():.2e}) "
                      f"{lib:.4f} ms; bound {bd['ms']:.4f} ms by "
                      f"{bd['by']} ({bd['nnz']} nonzero entries, "
                      f"{bd['nbytes'] / 1e6:.1f} MB moved); kernel at "
                      f"{bd['nbytes'] / ms / 1e6:.1f} GB/s, "
                      f"{bd['bytes_ms'] / ms * 100:.1f}% of the bytes bound",
                      flush=True)
                if split == "train" and f == 256:
                    record["spmm_bcsr_pattern"] = dict(
                        ms=ms, plain_ms=plain, bound_ms=bd["ms"],
                        bound_by=bd["by"], library_ms=lib)
            del cols, vals, bins, bsr, x

    with phase("gat"):
        cfg_g = dataclasses.replace(gnn_gat.CONFIG, in_dim=ds.feat_dim,
                                    out_dim=ds.num_classes)
        segment = BackendPolicy.fixed("segment")
        trainer, result, counts = fit_two_epochs(cfg_g, segment)
        if counts:
            raise AssertionError(f"the GAT fit launched kernels {counts}: "
                                 f"GAT aggregates on the segment path")
        print("GAT fit: 0 SpMM launches", flush=True)
        host = train_plan.cache[0]
        step_vs_cpu(cfg_g, "segment", result.params, host)
        profile_step(trainer, "segment", result.params, host, GAT_KINDS, 8)
        serve_vs_cpu(cfg_g, segment, result.params, "GAT segment")

    with phase("refresh-swap"):
        plan = plans["test"]
        params = init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
        eng = GNNInferenceEngine(plan, cfg, params, backend="bcsr",
                                 cache_batches=len(plan))

        def answers(p):
            """Every batch's output ids and logits, through ``eng``."""
            return {bi: (q, eng.query(q)) for bi in range(len(p))
                    for q in [p.routing.node_ids[p.routing.batch == bi]]}

        def same_bits(a, b):
            return a.shape == b.shape and a.tobytes() == b.tobytes()

        served = answers(plan)                 # fills the LRU
        if eng.stats["batch_runs"] != len(plan):
            raise AssertionError(f"{eng.stats['batch_runs']} batch runs "
                                 f"for a {len(plan)}-batch plan")
        # a seeded delta: 64 replacement feature rows and 32 undirected
        # edge inserts among test nodes
        drng = np.random.default_rng(29)
        test_nodes = pipe.ds.splits["test"]
        feat_nodes = np.sort(drng.choice(test_nodes, 64, replace=False))
        pairs = set()
        while len(pairs) < 32:
            u, v = (int(t) for t in drng.choice(test_nodes, 2,
                                                replace=False))
            if not np.isin(v, pipe.ds.graph.neighbors(u)):
                pairs.add((min(u, v), max(u, v)))
        delta = GraphDelta(
            feat_nodes=feat_nodes,
            feat_values=drng.normal(size=(64, ds.feat_dim)).astype(
                np.float32),
            edge_inserts=np.array(sorted(pairs), np.int64))
        t0 = time.perf_counter()
        child, audit = pipe.refresh(plan, delta)
        refresh_s = time.perf_counter() - t0
        check_routing(child)
        t0 = time.perf_counter()
        scratch = IBMBPipeline(pipe.ds, pipe.cfg).plan("test",
                                                       for_inference=True)
        scratch_s = time.perf_counter() - t0
        if scratch.fingerprint != child.fingerprint:
            raise AssertionError("refreshed and from-scratch fingerprints "
                                 "differ")
        print(f"refresh {delta.summary()}: {audit.summary()} (rebuilt "
              f"{audit.rebuilt.tolist()}, patched {audit.patched.tolist()}, "
              f"untouched {audit.untouched.tolist()}); {refresh_s:.3f} s on "
              f"the host against {scratch_s:.3f} s for a from-scratch "
              f"plan() (a fresh pipeline, its PPR included); stages "
              f"{ {k: round(v, 3) for k, v in audit.timings.items()} }",
              flush=True)

        def swap_and_check(new_plan, new_audit, before, fresh_plan):
            """Swap, then: untouched batches answer bit-identically from
            the LRU with no batch run; dirty ones run on the card and match
            a fresh engine on ``fresh_plan`` within ATOL."""
            result = eng.swap(new_plan, new_audit)
            runs = eng.stats["batch_runs"]
            for bi in new_audit.untouched:
                q, want = before[int(bi)]
                if not same_bits(eng.query(q), want):
                    raise AssertionError(f"untouched batch {bi} changed")
            if eng.stats["batch_runs"] != runs:
                raise AssertionError("an untouched batch ran again")
            fresh = GNNInferenceEngine(fresh_plan, cfg, params,
                                       backend="bcsr", cache_batches=0)
            build.reset_launches()
            worst = 0.0
            for bi in new_audit.dirty:
                q = new_plan.routing.node_ids[new_plan.routing.batch == bi]
                got, want = eng.query(q), fresh.query(q)
                worst = max(worst, float(np.abs(got - want).max()))
                np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
            torch.cuda.synchronize()
            ran = eng.stats["batch_runs"] - runs
            if ran != len(new_audit.dirty) or build.launches.get(
                    "spmm_bcsr", 0) != 2 * cfg.num_layers * ran:
                raise AssertionError(f"{ran} batch runs and "
                                     f"{dict(build.launches)} launches for "
                                     f"{len(new_audit.dirty)} dirty batches")
            print(f"swap v{eng.swap_audit[-1]['from_version']} -> "
                  f"v{eng.swap_audit[-1]['to_version']}: {result}; "
                  f"{len(new_audit.untouched)} untouched batches "
                  f"bit-identical from the LRU, {ran} dirty batches run on "
                  f"the card vs a fresh engine on a from-scratch plan "
                  f"max_abs_err {worst:.3e}; spmm_bcsr launches "
                  f"{build.launches.get('spmm_bcsr', 0)}", flush=True)

        swap_and_check(child, audit, served, scratch)
        if eng.stats["swap_count"] != 1 or not {0, 1} <= set(
                eng.stats["versions"]):
            raise AssertionError(f"stats after the swap: {eng.stats}")
        # a feature-only refresh confined to one batch's own outputs (ids no
        # other batch holds): exactly that batch is patched, the others
        # stay in the LRU
        served = answers(child)
        sets = [set(n[n >= 0].tolist()) for n in child.node_ids]
        others = np.fromiter(set().union(*sets[1:]), np.int64)
        own = np.setdiff1d(served[0][0], others)
        nodes = np.sort(drng.choice(own, min(64, len(own)), replace=False))
        delta2 = GraphDelta(feat_nodes=nodes, feat_values=drng.normal(
            size=(len(nodes), ds.feat_dim)).astype(np.float32))
        grand, audit2 = pipe.refresh(child, delta2)
        print(f"refresh {delta2.summary()}: {audit2.summary()}", flush=True)
        if audit2.dirty.tolist() != [0] or len(audit2.untouched) != \
                len(grand) - 1:
            raise AssertionError(f"a delta confined to batch 0 dirtied "
                                 f"{audit2.dirty.tolist()}")
        swap_and_check(grand, audit2, served, IBMBPipeline(
            pipe.ds, pipe.cfg).plan("test", for_inference=True))
        print(f"engine stats: "
              f"{json.dumps({k: v for k, v in eng.stats.items()})}",
              flush=True)

        # a plan whose routing was damaged by hand: refused, rolled back,
        # and the engine answers bit-identically to before
        served = answers(grand)
        row = np.array(grand.routing.row)
        row[0] = (row[0] + 1) % grand.cache.fields["output_idx"].shape[1]
        damaged = dataclasses.replace(grand, routing=dataclasses.replace(
            grand.routing, row=row))
        try:
            eng.swap(damaged)
        except ValueError as e:
            print(f"damaged routing refused: {e}", flush=True)
        else:
            raise AssertionError("a plan with damaged routing was swapped in")
        if eng.stats["swap_rollbacks"] != 1 or eng.swap_audit[-1]["ok"] \
                or eng.plan is not grand:
            raise AssertionError(f"no rollback: {eng.stats}, "
                                 f"{eng.swap_audit[-1]}")
        for bi, (q, want) in served.items():
            if not same_bits(eng.query(q), want):
                raise AssertionError(f"batch {bi} changed after a refused "
                                     f"swap")
        print(f"after the refused swap: {len(served)} batches "
              f"bit-identical, swap_rollbacks "
              f"{eng.stats['swap_rollbacks']}, audit {eng.swap_audit[-1]}",
              flush=True)
        del eng, params

    # the GCN data-parallel over a world-4 mesh, and exact influence
    dp_ctx = types.SimpleNamespace(
        dev=dev, ds=ds, cfg=cfg, train_plan=train_plan, val_plan=val_plan,
        test_plan=plans["test"], num_classes=ds.num_classes,
        queries=queries, single_answers=serve_answers,
        sync=torch.cuda.synchronize)

    with phase("data-parallel"):
        data_parallel_phase(dp_ctx)

    with phase("influence"):
        influence_phase(dp_ctx)

    # the serving tiers: the GCN under a fixed bcsr policy on the test
    # Plan, streamed to disk, sharded and behind the async tier; their
    # SpMM launches are counted from here to the end of async-faults
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    ctx = types.SimpleNamespace(
        dev=dev, ds=ds, pipe_cfg=pipe.cfg,
        cfg=dataclasses.replace(cfg, backend="bcsr"),
        params=init_gnn(cfg, torch.Generator().manual_seed(0), device=dev),
        plan=plans["test"], plan_s=plan_s["test"], queries=queries[:32],
        child=child, grand=grand, audit2=audit2, work=work, engines=[])
    build.reset_launches()

    with phase("ooc"):
        ooc_phase(ctx)

    with phase("async"):
        async_phase(ctx)

    with phase("async-faults"):
        async_faults_phase(ctx)
        torch.cuda.synchronize()
        runs = sum(e.stats["batch_runs"] for e in ctx.engines)
        counts = {k: v for k, v in build.launches.items() if v}
        print(f"ooc, async and async-faults: {len(ctx.engines)} engines ran "
              f"{runs} batch forwards; launches {counts} (want spmm_bcsr "
              f"{cfg.num_layers} x {runs})", flush=True)
        if counts != {"spmm_bcsr": cfg.num_layers * runs}:
            raise AssertionError(f"launches {counts} for {runs} batch "
                                 f"forwards of a {cfg.num_layers}-layer GCN")
        shutil.rmtree(ctx.store_dir)

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

    with phase("flash-256"):
        # recurrentgemma-2b's local layers (src/repro/configs/
        # recurrentgemma_2b.py): B=1, 10 heads over 1 kv head, S=4096,
        # head dim 256, causal, window 2048
        b, h, kv, s, d, w = 1, 10, 1, PREFILL_S, 256, 2048
        gen = torch.Generator(dev).manual_seed(12)
        q = bshd(torch, gen, (b, s, h, d), torch.bfloat16, dev)
        k, v = (bshd(torch, gen, (b, s, kv, d), torch.bfloat16, dev)
                for _ in range(2))
        label = (f"recurrentgemma-2b local layer B={b} H={h} KV={kv} S={s} "
                 f"D={d} causal window={w}")
        check_flash(q, k, v, True, w, f"{label} bf16")
        check_flash(q.float(), k.float(), v.float(), True, w,
                    f"{label} f32")
        ms = cuda_ms(torch, lambda: flash_attention(q, k, v, window=w), 20)
        ms_f32 = cuda_ms(torch, lambda: flash_attention(
            q.float(), k.float(), v.float(), window=w), 3)
        plain = cuda_ms(torch, lambda: attention_ref(q, k, v, window=w), 3)
        # the yardstick: K and V expanded to H heads, the window as a mask
        qe, ke, ve = (t.repeat_interleave(h // t.shape[1], dim=1)
                      .contiguous() for t in (q, k, v))
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - w)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_err = (sdpa(qe, ke, ve, attn_mask=mask).float() -
                   attention_ref(q, k, v, window=w).float()).abs().max() \
            .item()
        lib = cuda_ms(torch, lambda: sdpa(qe, ke, ve, attn_mask=mask), 20)
        bound, by, flops, nbytes = attention_bound_ms(
            b, h, kv, s, d, True, 2, peak_bf16, peak_bw, window=w)
        print(f"flash_attention {label} bf16: kernel {ms:.4f} ms (f32 "
              f"kernel {ms_f32:.4f} ms), plain (attention_ref) "
              f"{plain:.4f} ms, library (scaled_dot_product_attention on "
              f"expanded K/V with the window as a mask, err {lib_err:.2e}) "
              f"{lib:.4f} ms; bound {bound:.4f} ms by {by} "
              f"({flops / 1e9:.2f} GFLOP at the bf16 tensor peak, "
              f"{nbytes / 1e6:.1f} MB moved); kernel at "
              f"{flops / ms / 1e9:.2f} TFLOP/s, {bound / ms * 100:.1f}% of "
              f"bound", flush=True)
        record["flash_attention_d256"] = dict(
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
            library_ms=lib)
        del q, k, v, qe, ke, ve, mask

    from repro_torch.configs import get_config, get_smoke_config
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
        prefill_ms = ms
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
        del eng

    with phase("checkpoint"):
        ctx.gcn_params, ctx.gcn_opt = gcn_params, gcn_opt
        ctx.lm_params, ctx.lm_name = serve_params, LM_ARCH
        checkpoint_phase(ctx)
        del serve_params, params, ctx.lm_params

    # the GNN examples on the CPU, beside the LM phases; phase examples
    # holds the card's runs to them
    ex_out = os.path.join(work, "examples_cpu.json")
    ex_log = os.path.join(work, "examples_cpu.log")
    ex_proc = start_examples_cpu(ex_out, ex_log,
                                 os.path.join(work, "examples_cpu"))

    # the other LM families and the frontends, each model freed before
    # the next is loaded
    torch.cuda.empty_cache()
    arch_ctx = types.SimpleNamespace(
        torch=torch, np=np, dev=dev, build=build, on_card=True,
        config=get_config, sync=torch.cuda.synchronize,
        cuda_ms=lambda fn: cuda_ms(torch, fn, 1), prefill_s=PREFILL_S,
        cvc_s=256, rg_cvc_s=PREFILL_S, decode_steps=ARCH_DECODE_STEPS,
        arch_records={}, note=note)
    with phase("lm-archs"), torch.no_grad():
        lm_archs_phase(arch_ctx)
        launches["flash_attention_d256"] = arch_ctx.arch_records[
            "recurrentgemma-2b"]["launches"]["flash_attention_d256"]

    with phase("lm-archs-card-vs-cpu"), torch.no_grad():
        lm_archs_card_vs_cpu_phase(arch_ctx)

    with phase("lm-archs-decode"), torch.no_grad():
        lm_archs_decode_phase(arch_ctx)

    with phase("lm-archs-serve"), torch.no_grad():
        lm_archs_serve_phase(arch_ctx)

    with phase("lm-frontends"), torch.no_grad():
        lm_frontends_phase(arch_ctx)

    # LM training: the launcher's loop on llama3.2-1b, card against CPU,
    # and one step per family
    arch_ctx.work, arch_ctx.train_b, arch_ctx.train_s = work, TRAIN_B, \
        TRAIN_S
    arch_ctx.smoke_config, arch_ctx.arch_train_cases = get_smoke_config, \
        ARCH_TRAIN
    with phase("lm-train"):
        lm_train_phase(arch_ctx)
        launches["flash_attention"] += arch_ctx.train_launches[
            "flash_attention"]

    with phase("lm-train-card-vs-cpu"):
        lm_train_card_vs_cpu_phase(arch_ctx)

    with phase("lm-archs-train"):
        lm_archs_train_phase(arch_ctx)
        launches["flash_attention_d256"] += arch_ctx.arch_train[
            "recurrentgemma-2b"]["launches"]["flash_attention_d256"]

    # the mesh: the model under a DeviceMesh, the expert-parallel MoE and
    # the dry run
    torch.cuda.empty_cache()
    arch_ctx.mesh_cfg = lm_cfg
    arch_ctx.moe_b, arch_ctx.moe_s, arch_ctx.moe_members = \
        MOE_EP_B, MOE_EP_S, MOE_EP_MEMBERS
    arch_ctx.peak_bf16, arch_ctx.peak_bw = peak_bf16, peak_bw
    arch_ctx.prefill_ms = prefill_ms
    arch_ctx.dryrun_proc, arch_ctx.dryrun_log, arch_ctx.dryrun_dir = \
        dry_proc, dry_log, dry_dir
    arch_ctx.sweep_dir = sweep_dir
    arch_ctx.dryrun_timeout = 300
    with phase("mesh-card"):
        mesh_card_phase(arch_ctx)
        launches["flash_attention"] += arch_ctx.mesh_launches[
            "flash_attention"]

    torch.cuda.empty_cache()
    with phase("moe-mesh"), torch.no_grad():
        moe_mesh_phase(arch_ctx)

    torch.cuda.empty_cache()
    with phase("moe-ep"), torch.no_grad():
        moe_ep_phase(arch_ctx)

    with phase("dryrun"):
        dryrun_phase(arch_ctx)

    torch.cuda.empty_cache()
    arch_ctx.examples = EXAMPLES
    arch_ctx.cpu_examples = lambda: wait_examples_cpu(ex_proc, ex_out,
                                                      ex_log, 600)
    with phase("examples"):
        examples_phase(arch_ctx)
        for name in ("spmm_bcsr", "flash_attention"):
            launches[name] += arch_ctx.example_launches.get(name, 0)

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
