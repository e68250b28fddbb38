"""The npz checkpoint layout of the JAX package (`repro.checkpoint`),
read and written with numpy over nested dicts of tensors."""

from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         leaf_key, read_checkpoint,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "leaf_key", "read_checkpoint",
           "restore_checkpoint", "save_checkpoint"]
