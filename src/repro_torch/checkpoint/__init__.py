"""Checkpoints of train states (``ckpt``), in the JAX package's layout."""
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree",
           "latest_step"]
