"""ctypes binding of the selected-cluster scoring CUDA kernel
(csrc/cluster_score.cu). The library is built at first call."""

import ctypes

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = False


def _lib():
    global _bound
    lib = build.library("cluster_score")
    if not _bound:
        lib.cluster_score_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                             _I, _P]
        lib.cluster_score_launch.restype = _I
        lib.cluster_score_smem_bytes.argtypes = [_I]
        lib.cluster_score_smem_bytes.restype = ctypes.c_size_t
        _bound = True
    return lib


def smem_bytes(dim):
    return int(_lib().cluster_score_smem_bytes(dim))


def cluster_score_cuda(q, blocks, sel_ids, out):
    """q (B, dim) f32, blocks (U, cap, dim) f32, sel_ids (B, S) i32, out
    (B, S, cap) f32: contiguous, on one CUDA device (checked by ops)."""
    B, dim = q.shape
    U, cap, _ = blocks.shape
    S = sel_ids.shape[1]
    rc = _lib().cluster_score_launch(
        q.data_ptr(), blocks.data_ptr(), sel_ids.data_ptr(), out.data_ptr(),
        B, S, U, cap, dim, build.stream_ptr(out.device))
    build.check_launch("cluster_score", rc)
