from repro_torch.kernels.bin_overlap.ops import bin_overlap
from repro_torch.kernels.bin_overlap.ref import bin_overlap_ref

__all__ = ["bin_overlap", "bin_overlap_ref"]
