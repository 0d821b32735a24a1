#!/usr/bin/env python3
"""Time design variants of the bf16 flash-attention kernel on one card.

    python3 tools/flash_variants.py

Run from the root of a checkout on an H100 with ``nvcc``. Each variant is
``src/repro_torch/kernels/csrc/flash_attention.cu`` with one design choice
changed by a text substitution, built with ``ptxas -v`` into
``build/variants/`` (gitignored). Every variant is held against
``attention_ref`` at the llama3.2-1b prefill shape (B=1, 32 heads over 8
kv heads, S=4096, causal) at D=64 and D=128, and timed by CUDA events in
three rounds whose order alternates, beside ``scaled_dot_product_attention``
on K/V expanded to 32 heads. What each variant tells:

- ``base``: the kernel as built by the port;
- ``stages3``: a three-stage K/V ring (does the two-stage ring stall?);
- ``bk64``: 64-key tiles at D=64 too;
- ``bk128``: 128-key tiles at D=128 too (ptxas: does it spill?);
- ``no_split``: P rounded once to bf16, one P·V product (the split's cost;
  its error misses the one-rounding limit and is printed, not checked);
- ``mask_all``: the mask arithmetic on every tile (what the skip saves).

Diagnostics only: the port never builds these variants.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "flash_attention.cu"
MASK = ("    if (k0 + kBK > a.S || (a.causal && k0 + kBK - 1 > r_lo) ||\n"
        "        (a.window > 0 && k0 <= r_lo + 63 - a.window)) {")
VARIANTS = {  # name -> (text in the source, its replacement)
    "base": None,
    "stages3": ("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
    "bk64": ("  return D == 64 ? 128 : 64;", "  return 64;"),
    "bk128": ("  return D == 64 ? 128 : 64;", "  return 128;"),
    "no_split": ("      wgmma_rs_tb<D>(o, p_lo[kk], dv);\n", ""),
    "mask_all": (MASK, "    {"),
}


def build_variants(build, ptxas_report):
    """{name: loaded library}, every variant compiled in parallel; prints
    each kernel's registers and spills from ``ptxas -v``."""
    csrc = build.CSRC
    with open(os.path.join(csrc, SOURCE)) as f:
        src = f.read()
    running = {}
    for name, change in VARIANTS.items():
        text = src
        if change is not None:
            if change[0] not in text:
                sys.exit(f"flash_variants: {name}: the line to change is "
                         f"not in {SOURCE}")
            text = text.replace(change[0], change[1])
        out = os.path.join(ROOT, "build", "variants", name)
        os.makedirs(out, exist_ok=True)
        cu = os.path.join(out, SOURCE)
        with open(cu, "w") as f:
            f.write(text)
        cmd = [build.cuda_tool("nvcc"), *build.NVCC_FLAGS, "-I", csrc,
               "-o", os.path.join(out, "lib.so"), cu]
        running[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in running.items():
        _stdout, log = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"flash_variants: {name} does not build:\n{log}")
        for kernel, regs, stack, spill_st, spill_ld in ptxas_report(log):
            if "wgmma" in kernel:
                print(f"{name} {kernel}: {regs} registers, {stack} bytes "
                      f"stack, {spill_st}/{spill_ld} bytes spilled",
                      flush=True)
        libs[name] = ctypes.CDLL(os.path.join(ROOT, "build", "variants",
                                              name, "lib.so"))
    return libs


def main():
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_variants: needs a CUDA card")
    from chip_smoke import ptxas_report
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build_variants(build, ptxas_report)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(11)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, kv, s = 1, 32, 8, 4096

    def ms_of(fn, iters=50):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for d in (64, 128):
        q, k, v = (torch.randn((b, s, n, d), device=dev, generator=gen)
                   .to(torch.bfloat16).transpose(1, 2) for n in (h, kv, kv))
        want = attention_ref(q.float(), k.float(), v.float())
        limit = 1e-4 + 2 ** -8 * want.abs()
        times = {name: [] for name in libs}
        worst = {}
        order = list(libs)
        for rnd in range(3):
            for name in order if rnd % 2 == 0 else order[::-1]:
                build._loaded[SOURCE] = libs[name]
                got = flash_attention(q, k, v)
                worst[name] = ((got.float() - want).abs() / limit).max() \
                    .item()
                times[name].append(ms_of(lambda: flash_attention(q, k, v)))
        build._loaded.pop(SOURCE)
        qe, ke, ve = (t.repeat_interleave(h // t.shape[1], dim=1)
                      .contiguous() for t in (q, k, v))
        lib = ms_of(lambda: sdpa(qe, ke, ve, is_causal=True))
        for name, t in times.items():
            print(f"D={d} {name}: " + ", ".join(f"{x:.4f}" for x in t) +
                  f" ms; worst error/limit {worst[name]:.3f}", flush=True)
        print(f"D={d} scaled_dot_product_attention: {lib:.4f} ms",
              flush=True)
        if worst["base"] > 1.0:
            sys.exit("flash_variants: the base kernel misses its limit")


if __name__ == "__main__":
    main()
