from repro_torch.kernels.topk.ops import topk
from repro_torch.kernels.topk.ref import topk_ref

__all__ = ["topk", "topk_ref"]
