"""ctypes binding of the row-wise top-k CUDA kernels (csrc/topk.cu): the
chunk selector (phase A) and the per-row merge (phase B). The library is
built at first call."""

import ctypes

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = False


def _lib():
    global _bound
    lib = build.library("topk")
    if not _bound:
        lib.topk_launch.argtypes = [_P, ctypes.c_longlong, _I, _I, _I, _I,
                                    _I, _I, _P, _P, _P, _P]
        lib.topk_launch.restype = _I
        lib.topk_plan.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
        lib.topk_plan.restype = _I
        lib.topk_max_k.argtypes = []
        lib.topk_max_k.restype = _I
        _bound = True
    return lib


def max_k():
    return int(_lib().topk_max_k())


def plan(B, D, k, sms):
    """(C, L, kstride) for (B, D) rows on a card of `sms` SMs: C chunks of
    L entries per row, and the scratch stride of a chunk's list (0 when
    C == 1)."""
    out = (_I * 3)()
    rc = _lib().topk_plan(B, D, k, sms, out)
    build.check_launch("topk_plan", rc)
    return int(out[0]), int(out[1]), int(out[2])


def topk_cuda(x, k, vals, idx, scratch, chunks):
    """x (B, D) f32 with unit column stride, any row stride; vals (B, k)
    f32 and idx (B, k) int64, contiguous; chunks = plan(...); scratch
    int32 of 2 * B * C * kstride words when C > 1 (checked by ops)."""
    B, D = x.shape
    C, L, kstride = chunks
    rc = _lib().topk_launch(x.data_ptr(), x.stride(0), B, D, k, C, L,
                            kstride, vals.data_ptr(), idx.data_ptr(),
                            scratch.data_ptr() if C > 1 else None,
                            build.stream_ptr(x.device))
    build.check_launch("topk", rc)
