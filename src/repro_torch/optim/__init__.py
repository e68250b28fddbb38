"""Optimizers over trees of tensors (the JAX package's `repro.optim`
AdamW and SGD, function for function)."""

from repro_torch.optim.adam import (adamw_init, adamw_update, sgd_init,
                                    sgd_update)

__all__ = ["adamw_init", "adamw_update", "sgd_init", "sgd_update"]
