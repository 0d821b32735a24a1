#!/usr/bin/env python3
"""Time design variants of the block-CSR SpMM kernel on one card.

    python3 tools/spmm_variants.py

Run from the root of a checkout on an H100 with ``nvcc``. Each variant is
``src/repro_torch/kernels/csrc/spmm_bcsr.cu`` with one design choice of
its loop (``spmm_tile.cuh``, ``hopper.cuh``) changed by a text
substitution, built with ``ptxas -v`` into ``build/variants/``
(gitignored). Every variant is held against ``spmm_bcsr_ref`` on batch 0
of the arxiv-like train and test plans at F = 40 and 256 (the main path's
inputs) and timed by CUDA events with the calls queued behind a held
card (``chip_smoke.queued_ms``) in three rounds whose order alternates.
What each variant tells:

- ``base``: the kernel as built by the port (a three-stage ring);
- ``stages2``, ``stages4``, ``stages6``: the ring's depth (does three
  keep enough bytes in flight, and does more cost?);
- ``evict_normal``: the value stream under the default L2 policy instead
  of evict-first (does the stream push x out of L2?);
- ``threads128``, ``threads512``: 4 or 16 rows per block, a warp per row
  (how many concurrent slab streams an SM wants);
- ``occupancy5``, ``occupancy6``: shared memory padded so that only 5 or
  6 blocks fit an SM at B = 128, where the registers allow 8.

Beside them, ``vals.sum()`` on the same tiles: the rate at which a
PyTorch reduction reads the same bytes.

Diagnostics only: the port never builds these variants.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "spmm_bcsr.cu"
FILES = (SOURCE, "spmm_tile.cuh", "hopper.cuh")
STAGES = "constexpr int kStages = 3;"
THREADS = "constexpr int kThreads = 256;"
RING = "return kRingOffset + kStages * kRB * B * 4;"
VARIANTS = {  # name -> (file, text in it, its replacement)
    "base": None,
    "stages2": ("spmm_tile.cuh", STAGES, "constexpr int kStages = 2;"),
    "stages4": ("spmm_tile.cuh", STAGES, "constexpr int kStages = 4;"),
    "stages6": ("spmm_tile.cuh", STAGES, "constexpr int kStages = 6;"),
    "evict_normal": ("hopper.cuh", "L2::evict_first.b64",
                     "L2::evict_normal.b64"),
    "threads128": ("spmm_tile.cuh", THREADS, "constexpr int kThreads = 128;"),
    "threads512": ("spmm_tile.cuh", THREADS, "constexpr int kThreads = 512;"),
    "occupancy5": ("spmm_tile.cuh", RING, RING[:-1] + " + 32 * 1024;"),
    "occupancy6": ("spmm_tile.cuh", RING, RING[:-1] + " + 24 * 1024;"),
}


def build_variants(build, ptxas_report):
    """{name: loaded library}, every variant compiled in parallel; prints
    the registers and spills of each bulk-copy kernel from ``ptxas -v``."""
    running = {}
    for name, change in VARIANTS.items():
        out = os.path.join(ROOT, "build", "variants", "spmm_" + name)
        os.makedirs(out, exist_ok=True)
        for file in FILES:
            with open(os.path.join(build.CSRC, file)) as f:
                text = f.read()
            if change is not None and change[0] == file:
                if change[1] not in text:
                    sys.exit(f"spmm_variants: {name}: the text to change "
                             f"is not in {file}")
                text = text.replace(change[1], change[2])
            with open(os.path.join(out, file), "w") as f:
                f.write(text)
        cmd = [build.cuda_tool("nvcc"), *build.NVCC_FLAGS,
               "-o", os.path.join(out, "lib.so"), os.path.join(out, SOURCE)]
        running[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in running.items():
        _stdout, log = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"spmm_variants: {name} does not build:\n{log}")
        for kernel, regs, stack, spill_st, spill_ld in ptxas_report(log):
            if "Lb1E" in kernel:
                print(f"{name} {kernel}: {regs} registers, {stack} bytes "
                      f"stack, {spill_st}/{spill_ld} bytes spilled",
                      flush=True)
        libs[name] = ctypes.CDLL(os.path.join(out, "lib.so"))
    return libs


def main():
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if not torch.cuda.is_available():
        sys.exit("spmm_variants: needs a CUDA card")
    from chip_smoke import ptxas_report, queued_ms
    from repro_torch.core import IBMBConfig, IBMBPipeline
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.spmm import spmm_bcsr, spmm_bcsr_ref
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build_variants(build, ptxas_report)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(3)
    pipe = IBMBPipeline(get_dataset("arxiv-like"),
                        IBMBConfig(variant="node", backend="bcsr"))
    for split in ("train", "test"):
        fields = pipe.plan(split, for_inference=split != "train") \
            .cache.fields
        cols = torch.as_tensor(fields["tile_cols"][0], device=dev)
        vals = torch.as_tensor(fields["tile_vals"][0], device=dev)
        rows = vals.shape[0] * vals.shape[3]
        read = queued_ms(torch, lambda: vals.sum(), 10)
        print(f"{split} batch 0: vals.sum() {read:.4f} ms queued, "
              f"{vals.numel() * 4 / read / 1e6:.0f} GB/s", flush=True)
        for f in (40, 256):
            x = torch.randn((rows, f), device=dev, generator=gen)
            want = spmm_bcsr_ref(cols, vals, x)
            nbytes = (cols.numel() + vals.numel() + 2 * x.numel()) * 4
            times = {name: [] for name in libs}
            order = list(libs)
            for rnd in range(3):
                for name in order if rnd % 2 == 0 else order[::-1]:
                    build._loaded[SOURCE] = libs[name]
                    got = spmm_bcsr(cols, vals, x, impl="cuda")
                    if not torch.allclose(got, want, atol=1e-4, rtol=1e-4):
                        sys.exit(f"spmm_variants: {name} disagrees with "
                                 f"the plain version")
                    times[name].append(queued_ms(
                        torch, lambda: spmm_bcsr(cols, vals, x, impl="cuda"),
                        10))
            build._loaded.pop(SOURCE)
            for name, t in times.items():
                print(f"{split} batch 0 F={f} {name}: " +
                      ", ".join(f"{v:.4f}" for v in t) + " ms queued; "
                      f"{nbytes / min(t) / 1e6:.0f} GB/s at best",
                      flush=True)
            del x, want


if __name__ == "__main__":
    main()
