"""ctypes binding of the ADC CUDA kernels (csrc/adc.cu): the LUT build
and the code-block scorer. The library is built at first call."""

import ctypes

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = False


def _lib():
    global _bound
    lib = build.library("adc")
    if not _bound:
        lib.adc_tables_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
        lib.adc_tables_launch.restype = _I
        lib.adc_score_blocks_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                                _I, _I, _I, _P]
        lib.adc_score_blocks_launch.restype = _I
        lib.adc_score_smem_bytes.argtypes = [_I, _I, _I]
        lib.adc_score_smem_bytes.restype = ctypes.c_size_t
        _bound = True
    return lib


def score_smem_bytes(cap, nsub, K):
    return int(_lib().adc_score_smem_bytes(cap, nsub, K))


def adc_tables_cuda(q_rot, codebooks, out):
    """q_rot (B, dim), codebooks (nsub, K, dsub), out (B, nsub, K): float32,
    contiguous, on one CUDA device (checked by ops)."""
    B = q_rot.shape[0]
    nsub, K, dsub = codebooks.shape
    rc = _lib().adc_tables_launch(
        q_rot.data_ptr(), codebooks.data_ptr(), out.data_ptr(),
        B, nsub, K, dsub, build.stream_ptr(out.device))
    build.check_launch("adc_tables", rc)


def adc_score_blocks_cuda(lut, code_blocks, sel_ids, out):
    """lut (B, nsub, K) f32, code_blocks (U, cap, nsub) u8, sel_ids (B, S)
    i32, out (B, S, cap) f32 (checked by ops)."""
    B, nsub, K = lut.shape
    U, cap, _ = code_blocks.shape
    S = sel_ids.shape[1]
    rc = _lib().adc_score_blocks_launch(
        lut.data_ptr(), code_blocks.data_ptr(), sel_ids.data_ptr(),
        out.data_ptr(), B, S, U, cap, nsub, K, build.stream_ptr(out.device))
    build.check_launch("adc_score_blocks", rc)
