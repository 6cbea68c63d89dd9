"""Deterministic synthetic data (``synthetic``)."""
from repro_torch.data.synthetic import (input_specs, lm_batch_iterator,
                                        synthetic_batch)

__all__ = ["input_specs", "lm_batch_iterator", "synthetic_batch"]
