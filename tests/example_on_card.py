"""Run one of the port's examples on a CUDA card and print, after its own
lines, its wall seconds, the card's name and power limit and its peak
memory.

    PYTHONPATH=src python3 tests/example_on_card.py train_ibmb_full \\
        --dataset products-like --epochs 1 --backend bcsr

The example's arguments follow its name; ``--device`` is left at its
default, the card. The last line is one JSON object: the example's
numeric figures, ``wall_s`` (host clock, the example's whole ``main``),
``peak_card_bytes`` (``torch.cuda.max_memory_allocated``) and ``card``.
"""
import importlib
import json
import numbers
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main(argv=None):
    import torch
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("example_on_card: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    mod = importlib.import_module(f"repro_torch.examples.{argv[0]}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fig = mod.main(argv[1:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {k: v for k, v in fig.items()
           if isinstance(v, numbers.Number) and not isinstance(v, bool)}
    out.update(wall_s=wall, peak_card_bytes=torch.cuda.max_memory_allocated(),
               card=card)
    print(f"{argv[0]}: {wall:.1f} s of wall clock, peak card memory "
          f"{out['peak_card_bytes'] / 1e9:.3f} GB on {card}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
