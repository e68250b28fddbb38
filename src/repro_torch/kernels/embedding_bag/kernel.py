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
        lib.embedding_bag_launch.argtypes = [_P, _P, _P, _L, _I, _I, _L, _I,
                                             _P, _P]
        lib.embedding_bag_launch.restype = _I
        _bound = True
    return lib


def embedding_bag_cuda(table, idx, out, err):
    """table (V, d) float32 or bfloat16, idx (B, hot) int32, out (B, d) in
    the table's dtype, err a zeroed (1,) int64 error word: contiguous, on
    one CUDA device (checked by ops). Launches without waiting; an index
    outside [0, V) is not read but left in `err` (see bad_index)."""
    B, hot = idx.shape
    rc = _lib().embedding_bag_launch(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, hot,
        table.shape[1], table.shape[0], _DTYPES[table.dtype],
        err.data_ptr(), build.stream_ptr(out.device))
    build.check_launch("embedding_bag", rc)


def bad_index(word):
    """The bad index that a finished launch left in its error word (read
    as an int), or None for 0."""
    if not word:
        return None
    return ctypes.c_int32(word & 0xFFFFFFFF).value
