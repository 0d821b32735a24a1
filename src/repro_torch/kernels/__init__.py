"""Hand-written Hopper kernels of the port, one per TPU kernel of ``repro``.

Each kernel has a CUDA C++ source under ``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use (``build.load_library``), a wrapper that validates
its inputs and counts its launches (``build.launches``), and a plain
PyTorch version beside it that the CPU path and the tests use.

  spmm        — block-CSR SpMM ``out = A @ x``: ``csrc/spmm_bcsr.cu``
                replaces ``spmm_bcsr_fused_pallas``
                (``repro/kernels/spmm/fused.py``) and
                ``csrc/spmm_bcsr_unfused.cu`` replaces ``spmm_bcsr_pallas``
                (``repro/kernels/spmm/spmm.py``).
  gather_rows — row gather ``out = table[idx]``: ``csrc/gather_rows.cu``
                replaces ``gather_rows_pallas``
                (``repro/kernels/gather_rows/gather_rows.py``).
"""
