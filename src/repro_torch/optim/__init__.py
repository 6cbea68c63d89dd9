"""Optimizers over the port's parameter trees (``optimizers``)."""
from repro_torch.optim.optimizers import (adam_init, adam_update,
                                          make_optimizer, opt_state_shapes,
                                          sgd_init, sgd_update)

__all__ = ["adam_init", "adam_update", "sgd_init", "sgd_update",
           "make_optimizer", "opt_state_shapes"]
