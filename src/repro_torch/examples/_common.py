"""What the port's examples share: the ``--device`` and ``--backend``
flags, and the Plan that a backend reads its batches from."""
from __future__ import annotations

import argparse

BACKENDS = ("segment", "bcsr", "dense", "auto")


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or "
                         "cpu, the plain PyTorch path")


def add_backend(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--backend", default="segment", choices=BACKENDS,
                    help="the GNN's aggregation backend (DESIGN.md §7/§14): "
                         "bcsr runs the block-CSR SpMM kernel on the card, "
                         "auto each batch as the plan's autotuner decided")


def plan_backend(backend: str) -> str:
    """The ``IBMBConfig.backend`` a model backend needs: bcsr's tiles for
    ``bcsr`` and ``auto``, the COO edges (the reference's default Plan,
    fingerprint and all) for ``segment`` and ``dense``."""
    return "bcsr" if backend in ("bcsr", "auto") else "segment"
