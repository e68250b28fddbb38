"""Plain twin of the grouping pre-pass of csrc/cluster_score.cu: which
slots each block's run holds, and the work items the scoring kernel
takes. The constants are the kernel's."""

import torch

GEMM_MIN_QUERIES = 32   # a run this long takes the GEMM path
GEMM_QUERIES = 128      # queries in a GEMM tile, at most
GEMM_ROWS = 128         # block rows in a GEMM item
BYTES_ROWS = 256        # block rows in a bytes item


def group_slots_ref(sel_ids, U, cap):
    """sel_ids (B, S) positions into U blocks of cap rows -> (counts (U,),
    starts (U,), order (n,), items (n_items, 4)), int32 tensors on the
    CPU: each block's slot count and first position in `order`, the n
    in-range slots (flat b * S + s) bucketed by block, ascending within a
    bucket, and the work items (block, first position, queries, first
    row): the GEMM items of every run of at least GEMM_MIN_QUERIES slots
    (split into the fewest near-equal tiles of at most GEMM_QUERIES, each
    with one item per GEMM_ROWS rows), then one bytes item per BYTES_ROWS
    rows for every shorter nonempty run, each in block order."""
    sel = sel_ids.reshape(-1).long().cpu()
    valid = (sel >= 0) & (sel < U)
    counts = torch.bincount(sel[valid], minlength=U)
    starts = torch.cumsum(counts, 0) - counts
    slots = torch.nonzero(valid).flatten()
    order = slots[torch.argsort(sel[slots], stable=True)]
    rg, rb = -(-cap // GEMM_ROWS), -(-cap // BYTES_ROWS)
    gemm, small = [], []
    for u in torch.nonzero(counts).flatten().tolist():
        n, s0 = int(counts[u]), int(starts[u])
        if n >= GEMM_MIN_QUERIES:
            m = -(-n // GEMM_QUERIES)
            for i in range(m):
                a, b = s0 + i * n // m, s0 + (i + 1) * n // m
                gemm += [(u, a, b - a, r * GEMM_ROWS) for r in range(rg)]
        else:
            small += [(u, s0, n, r * BYTES_ROWS) for r in range(rb)]
    items = torch.tensor(gemm + small, dtype=torch.int32).reshape(-1, 4)
    return counts.int(), starts.int(), order.int(), items
