from repro_torch.kernels.gather_rows.ops import gather_rows
from repro_torch.kernels.gather_rows.ref import gather_rows_ref

__all__ = ["gather_rows", "gather_rows_ref"]
