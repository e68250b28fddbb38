"""ctypes binding of the overlap-feature CUDA kernel (csrc/bin_overlap.cu).
The library is built at first call."""

import ctypes

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = False


def _lib():
    global _bound
    lib = build.library("bin_overlap")
    if not _bound:
        lib.bin_overlap_launch.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I,
                                           _I, _I, _P]
        lib.bin_overlap_launch.restype = _I
        _bound = True
    return lib


def bin_overlap_cuda(cluster_of, bin_ids, scores, P, Q, n_clusters, v):
    """cluster_of (B, k) i32, bin_ids (k,) or (B, k) i32, scores (B, k)
    f32, P and Q (B, n_clusters, v) f32: contiguous, on one CUDA device
    (checked by ops)."""
    B, k = cluster_of.shape
    rc = _lib().bin_overlap_launch(
        cluster_of.data_ptr(), bin_ids.data_ptr(),
        0 if bin_ids.dim() == 1 else k, scores.data_ptr(), P.data_ptr(),
        Q.data_ptr(), B, k, n_clusters, v, build.stream_ptr(P.device))
    build.check_launch("bin_overlap", rc)
