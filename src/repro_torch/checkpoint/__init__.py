"""The npz checkpoint layout of the JAX package (`repro.checkpoint`),
read and written with numpy alone."""

from repro_torch.checkpoint.ckpt import (leaf_key, read_checkpoint,
                                         save_checkpoint)

__all__ = ["leaf_key", "read_checkpoint", "save_checkpoint"]
