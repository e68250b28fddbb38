"""ctypes binding of the embedding-bag CUDA kernel
(csrc/embedding_bag.cu). The library is built at first call."""

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_bound = False


def _lib():
    global _bound
    lib = build.library("embedding_bag")
    if not _bound:
        lib.embedding_bag_launch.argtypes = [_P, _P, _P, _L, _I, _I, _I, _P]
        lib.embedding_bag_launch.restype = _I
        _bound = True
    return lib


def embedding_bag_cuda(table, idx, out):
    """table (V, d) float32 or bfloat16, idx (B, hot) int32 in [0, V),
    out (B, d) in the table's dtype: contiguous, on one CUDA device
    (checked by ops)."""
    B, hot = idx.shape
    rc = _lib().embedding_bag_launch(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, hot,
        table.shape[1], _DTYPES[table.dtype], build.stream_ptr(out.device))
    build.check_launch("embedding_bag", rc)
