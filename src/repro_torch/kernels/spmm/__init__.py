from repro_torch.kernels.spmm.ops import (
    BCSR, csr_to_bcsr, spmm_bcsr, spmm_bcsr_sym)
from repro_torch.kernels.spmm.ref import spmm_bcsr_ref, spmm_bcsr_stream

__all__ = ["spmm_bcsr", "spmm_bcsr_sym", "csr_to_bcsr", "BCSR",
           "spmm_bcsr_ref", "spmm_bcsr_stream"]
