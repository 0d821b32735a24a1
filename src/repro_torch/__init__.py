"""PyTorch/CUDA port of the IBMB system (``repro``) for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
and names (``repro_torch.core.plan`` ↔ ``repro.core.plan``, ...) and
imports nothing of it, nor JAX. Host-side preprocessing is numpy, copied
from the reference so plans stay bitwise-identical; the device side is
PyTorch plus hand-written CUDA kernels under ``kernels/csrc``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
