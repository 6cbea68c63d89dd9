"""Deterministic synthetic data (``synthetic``)."""
from repro_torch.data.synthetic import lm_batch_iterator

__all__ = ["lm_batch_iterator"]
