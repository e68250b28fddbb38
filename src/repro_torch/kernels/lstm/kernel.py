"""ctypes binding of the fused LSTM-sequence CUDA kernel (csrc/lstm.cu).
The library is built at first call."""

import ctypes

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = False


def _lib():
    global _bound
    lib = build.library("lstm")
    if not _bound:
        lib.lstm_sequence_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                             _I, _P]
        lib.lstm_sequence_launch.restype = _I
        _bound = True
    return lib


def lstm_sequence_cuda(x, wx, wh, b, out):
    """x (B, n, F), wx (F, 4H), wh (H, 4H), b (4H,), out (B, n, H): float32,
    contiguous, on one CUDA device (checked by ops)."""
    B, n, F = x.shape
    H = wh.shape[0]
    rc = _lib().lstm_sequence_launch(
        x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
        out.data_ptr(), B, n, F, H, build.stream_ptr(out.device))
    build.check_launch("lstm_sequence", rc)
