"""Shared set-up of the PyTorch-port parity tests: the same reduced
starcoder2-3b parameters in both packages, and the tolerances the tests
hold the port to."""
from __future__ import annotations

import jax
import numpy as np

from repro.configs.registry import get_config
from repro.models import lm as jlm
from repro_torch.configs.registry import get_config as torch_get_config
from repro_torch.models.convert import params_from_numpy

# Logits of the reduced model (|logit| < 4, where one bf16 step is 1/64),
# JAX against the port on the CPU.  Both round every activation to bf16,
# but XLA and PyTorch round the bf16 silu/sigmoid differently by one step,
# and the port's prefill attention keeps p in f32 (the flash kernel's
# numerics) where the JAX prefill rounds it to bf16.  Through two layers
# the logits then differ by up to ~2.4 bf16 steps (0.037 measured over
# seeded prompts of 3-64 tokens), so the bound is four steps.
LOGIT_TOL = 4 / 64


def dense_models(seed: int = 0):
    """(jax cfg, port cfg, jax params, port params on the CPU)."""
    cfg = get_config("starcoder2-3b").reduced()
    tcfg = torch_get_config("starcoder2-3b").reduced()
    jp = jlm.init_params(cfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, tcfg, jp, tp


def f32(x) -> np.ndarray:
    """A jax array or a torch tensor as a float32 numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)
