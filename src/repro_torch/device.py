"""The port's one device policy.

Every entry point (RetrievalEngine, build_index, kmeans, train_pq, ...)
takes `device=None`, and None means the CUDA card. Without a card that
raises: the CPU runs only when the caller asks for it with
`device="cpu"`, as the CPU tests do.
"""

import torch


def resolve_device(device=None):
    """None -> the current CUDA device (RuntimeError without a card); else
    torch.device(device), with a bare "cuda" pinned to its index so that
    it compares equal to a tensor's device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device):
    """Wait for the work queued on `device` (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
