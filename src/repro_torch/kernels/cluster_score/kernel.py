"""ctypes binding of the selected-cluster scoring CUDA kernel
(csrc/cluster_score.cu). The library is built at first call."""

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_bound = False


def _lib():
    global _bound
    lib = build.library("cluster_score")
    if not _bound:
        lib.cluster_score_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                             _I, _P, _P, _P]
        lib.cluster_score_launch.restype = _I
        lib.cluster_score_group.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P,
                                            _P]
        lib.cluster_score_group.restype = _I
        lib.cluster_score_smem_bytes.argtypes = [_I]
        lib.cluster_score_smem_bytes.restype = ctypes.c_size_t
        for fn in (lib.cluster_score_items_bound,
                   lib.cluster_score_scratch_words):
            fn.argtypes = [_I, _I, _I, _I]
            fn.restype = _LL
        _bound = True
    return lib


def smem_bytes(dim):
    return int(_lib().cluster_score_smem_bytes(dim))


def _scratch(B, S, U, cap, device):
    """The pre-pass's scratch: U zeroed counts and the rest (work items,
    bucketed slots, cursors, the item count) as int32 words."""
    words = int(_lib().cluster_score_scratch_words(B, S, U, cap))
    return (torch.zeros(U, dtype=torch.int32, device=device),
            torch.empty(words, dtype=torch.int32, device=device))


def cluster_score_cuda(q, blocks, sel_ids, out):
    """q (B, dim) f32, blocks (U, cap, dim) f32, sel_ids (B, S) i32, out
    (B, S, cap) f32: contiguous, on one CUDA device (checked by ops)."""
    B, dim = q.shape
    U, cap, _ = blocks.shape
    S = sel_ids.shape[1]
    counts, scratch = _scratch(B, S, U, cap, out.device)
    rc = _lib().cluster_score_launch(
        q.data_ptr(), blocks.data_ptr(), sel_ids.data_ptr(), out.data_ptr(),
        B, S, U, cap, dim, counts.data_ptr(), scratch.data_ptr(),
        build.stream_ptr(out.device))
    build.check_launch("cluster_score", rc)


def group_slots_cuda(sel_ids, U, cap):
    """The kernel's grouping pre-pass alone on a (B, S) int32 CUDA tensor
    (a check of the pre-pass; it syncs to read the item count). Returns
    group_slots_ref's (counts, starts, order, items); `order` holds each
    block's slots in whatever order the atomics gave them."""
    B, S = sel_ids.shape
    dev = sel_ids.device
    counts, scratch = _scratch(B, S, U, cap, dev)
    out = torch.empty((B, S, cap), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().cluster_score_group(
            sel_ids.data_ptr(), out.data_ptr(), B, S, U, cap,
            counts.data_ptr(), scratch.data_ptr(), build.stream_ptr(dev))
    build.check_launch("cluster_score", rc)
    nb = int(_lib().cluster_score_items_bound(B, S, U, cap))
    order = scratch[4 * nb:4 * nb + B * S]
    cursor = scratch[4 * nb + B * S:4 * nb + B * S + U]
    n_items = int(scratch[4 * nb + B * S + U].item())
    starts = cursor - counts
    return (counts, starts, order[:int(counts.sum().item())],
            scratch[:4 * nb].view(nb, 4)[:n_items])
