"""ctypes binding of the row-wise top-k CUDA kernel (csrc/topk.cu). The
library is built at first call."""

import ctypes

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = False


def _lib():
    global _bound
    lib = build.library("topk")
    if not _bound:
        lib.topk_launch.argtypes = [_P, ctypes.c_longlong, _I, _I, _I, _P,
                                    _P, _P]
        lib.topk_launch.restype = _I
        lib.topk_max_k.argtypes = []
        lib.topk_max_k.restype = _I
        _bound = True
    return lib


def max_k():
    return int(_lib().topk_max_k())


def topk_cuda(x, k, vals, idx):
    """x (B, D) f32 with unit column stride, any row stride; vals (B, k)
    f32 and idx (B, k) int64, contiguous (checked by ops)."""
    B, D = x.shape
    rc = _lib().topk_launch(x.data_ptr(), x.stride(0), B, D, k,
                            vals.data_ptr(), idx.data_ptr(),
                            build.stream_ptr(x.device))
    build.check_launch("topk", rc)
