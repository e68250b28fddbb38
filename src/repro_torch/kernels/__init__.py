"""CUDA kernels for sm_90a, one package per Pallas kernel they replace.

Each package keeps the JAX package's three-file layout:

  kernel.py — the ctypes binding of the CUDA kernel in csrc/<name>.cu
  ops.py    — the public wrapper: the plain version (ref.py) for CPU
              tensors; for CUDA tensors it checks device, dtype, shape
              and contiguity, launches the kernel, or raises. There is
              no fallback from a CUDA tensor to ref.
  ref.py    — the plain PyTorch version, for the CPU path and the tests.

`LAUNCHES` counts kernel launches per kernel: a wrapper adds one where
it launches its kernel, and nowhere else.
"""

LAUNCHES = {"adc_tables": 0, "adc_score_blocks": 0, "bin_overlap": 0,
            "cluster_score": 0, "embedding_bag": 0, "lstm_sequence": 0,
            "topk": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def record_launch(name):
    LAUNCHES[name] += 1


def on_cuda(*tensors):
    """True when the tensors lie on one CUDA device, False when all lie on
    the CPU; raises on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def require(t, name, dtype, ndim):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
