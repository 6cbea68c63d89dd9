"""Deterministic synthetic data (``synthetic``)."""
from repro_torch.data.synthetic import (image_dataset, input_specs,
                                        lm_batch_iterator, regression_dataset,
                                        synthetic_batch)

__all__ = ["input_specs", "synthetic_batch", "lm_batch_iterator",
           "regression_dataset", "image_dataset"]
