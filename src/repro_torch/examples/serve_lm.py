"""Batched LM serving: continuous batching over the decode step, any of
the 10 architectures, at its full config on the card.

    python -m repro_torch.examples.serve_lm --arch llama3.2-1b --requests 6
    python -m repro_torch.examples.serve_lm --smoke --device cpu

The weights are random, drawn from a generator on the device seeded 0
(``run(args, params=...)`` serves others). ``--smoke`` takes the reduced
per-arch config, the reference script's, which the CPU runs in seconds.
The engine feeds each prompt token by token through ``decode_step``, as
the reference's does: it runs no prefill.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_device
from repro_torch.models.lm import init_params
from repro_torch.serve import Request, ServeEngine


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-arch config (CPU-runnable)")
    add_device(ap)
    return ap


def run(args: argparse.Namespace, params: Optional[Dict] = None) -> Dict:
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.num_codebooks > 1:
        print(f"{args.arch} is multi-codebook; serving demo uses text-style "
              "archs — pick another --arch")
        return dict(arch=args.arch, skipped=True)
    if params is None:
        params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, num_slots=args.slots, max_len=256,
                      device=dev)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    stats = eng.run(reqs)
    print(f"{args.arch} ({cfg.name}): {stats['completed']}/{len(reqs)} "
          f"requests in {stats['steps']} decode steps, "
          f"{stats['time_s']:.2f}s ({args.slots} slots, continuous batching)")
    for i, r in enumerate(reqs[:3]):
        print(f"  req{i}: prompt {r.prompt.tolist()} → {r.out_tokens}")
    return dict(arch=args.arch, config=cfg.name, skipped=False,
                completed=stats["completed"], requests=len(reqs),
                steps=stats["steps"], time_s=stats["time_s"],
                evicted=stats["evicted"],
                prompts=[r.prompt.tolist() for r in reqs],
                tokens=[r.out_tokens for r in reqs])


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
