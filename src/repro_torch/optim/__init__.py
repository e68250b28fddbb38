"""Optimizers over trees of tensors (the JAX package's `repro.optim`
AdamW and SGD, function for function) and the learning-rate schedules."""

from repro_torch.optim.adam import (adamw_init, adamw_update, sgd_init,
                                    sgd_update)
from repro_torch.optim.schedules import make_schedule

__all__ = ["adamw_init", "adamw_update", "make_schedule", "sgd_init",
           "sgd_update"]
