"""Learning-rate schedules as step -> lr functions in float32: the JAX
package's `repro.optim.schedules.make_schedule`, operation for operation
(a python float times a float32 tensor is a float32 product in both)."""

import math

import torch


def make_schedule(kind, base_lr, warmup_steps=0, total_steps=1000,
                  min_ratio=0.1):
    """fn(step) -> lr, a float32 tensor of shape () on the step's device
    (the CPU for an int step)."""
    warmup_steps = max(warmup_steps, 1)
    span = max(total_steps - warmup_steps, 1)

    def _step(step):
        return torch.as_tensor(step).to(torch.float32)

    def _t(step):
        return torch.clamp((step - warmup_steps) / span, 0, 1)

    def cosine(step):
        step = _step(step)
        warm = base_lr * step / warmup_steps
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * _t(step))))
        return torch.where(step < warmup_steps, warm, cos)

    def linear(step):
        step = _step(step)
        warm = base_lr * step / warmup_steps
        lin = base_lr * (1 - (1 - min_ratio) * _t(step))
        return torch.where(step < warmup_steps, warm, lin)

    def constant(step):
        step = _step(step)
        warm = base_lr * step / warmup_steps
        return torch.where(step < warmup_steps, warm,
                           torch.full_like(step, base_lr))

    return {"cosine": cosine, "linear": linear, "constant": constant}[kind]
