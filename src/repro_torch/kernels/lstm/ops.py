"""Public LSTM-sequence op. CPU tensors take the plain version (ref.py),
differentiated by autograd. CUDA tensors launch the kernel of
csrc/lstm.cu after the checks below, or raise; under autograd the launch
is the forward of `_LSTMSequenceFn`, whose backward recomputes the plain
version on the saved inputs and takes its VJP: the same function, so the
kernel's exact gradient, as the JAX package's custom VJP
(`repro.train.trainer._lstm_hseq_bwd`) takes it through the scan. The
JAX package has no backward kernel, and neither has this one."""

import torch

from repro_torch.kernels import on_cuda, record_launch, require
from repro_torch.kernels.lstm import kernel
from repro_torch.kernels.lstm.ref import lstm_sequence_ref


def _launch(x, wx, wh, b):
    for t, name, nd in ((x, "x", 3), (wx, "wx", 2), (wh, "wh", 2), (b, "b", 1)):
        require(t, name, torch.float32, nd)
    B, n, F = x.shape
    H = wh.shape[0]
    if wx.shape != (F, 4 * H) or wh.shape != (H, 4 * H) or b.shape != (4 * H,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, wx "
                         f"{tuple(wx.shape)}, wh {tuple(wh.shape)}, b "
                         f"{tuple(b.shape)}")
    if 4 * H > 1024:
        raise ValueError(f"hidden size {H}: 4H threads exceed a block's 1024")
    out = torch.empty((B, n, H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        kernel.lstm_sequence_cuda(x, wx, wh, b, out)
    record_launch("lstm_sequence")
    return out


class _LSTMSequenceFn(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: the VJP of lstm_sequence_ref
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, x, wx, wh, b):
        ctx.save_for_backward(x, wx, wh, b)
        return _launch(x, wx, wh, b)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            h = lstm_sequence_ref(*inputs)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(h, wanted, g))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def lstm_sequence(x, wx, wh, b):
    """x: (B, n, F); wx: (F, 4H); wh: (H, 4H); b: (4H,) -> (B, n, H)."""
    if not on_cuda(x, wx, wh, b):
        return lstm_sequence_ref(x, wx, wh, b)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, wx, wh, b)):
        return _LSTMSequenceFn.apply(x, wx, wh, b)
    return _launch(x, wx, wh, b)
