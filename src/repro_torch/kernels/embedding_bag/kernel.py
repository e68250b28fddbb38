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
_err_words = {}     # device index -> the kernel's pointer to its error word


def _lib():
    global _bound
    lib = build.library("embedding_bag")
    if not _bound:
        lib.embedding_bag_launch.argtypes = [_P, _P, _P, _L, _I, _I, _L, _I,
                                             _P, _P]
        lib.embedding_bag_launch.restype = _I
        lib.embedding_bag_error_word.argtypes = [_I, ctypes.POINTER(_P)]
        lib.embedding_bag_error_word.restype = _I
        lib.embedding_bag_take_error.argtypes = [_I]
        lib.embedding_bag_take_error.restype = ctypes.c_ulonglong
        _bound = True
    return lib


def _err_word(device):
    ptr = _err_words.get(device.index)
    if ptr is None:
        out = _P()
        build.check_launch("embedding_bag error word",
                           _lib().embedding_bag_error_word(device.index,
                                                           ctypes.byref(out)))
        ptr = _err_words[device.index] = out.value
    return ptr


def embedding_bag_cuda(table, idx, out):
    """table (V, d) float32 or bfloat16, idx (B, hot) int32, out (B, d) in
    the table's dtype: contiguous, on one CUDA device (checked by ops).
    Launches without waiting; an index outside [0, V) is not read but
    left in the device's error word for take_error."""
    B, hot = idx.shape
    rc = _lib().embedding_bag_launch(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, hot,
        table.shape[1], table.shape[0], _DTYPES[table.dtype],
        _err_word(out.device), build.stream_ptr(out.device))
    build.check_launch("embedding_bag", rc)


def take_error(device):
    """The bad index a finished launch on `device` left in its error word
    (then cleared), or None."""
    word = _lib().embedding_bag_take_error(device.index)
    if not word:
        return None
    return ctypes.c_int32(word & 0xFFFFFFFF).value
