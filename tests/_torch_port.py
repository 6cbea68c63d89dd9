"""Shared set-up of the PyTorch-port parity tests: the same reduced
starcoder2-3b and falcon-mamba-7b parameters in both packages, the
tolerances the tests hold the port to, and the tie-aware token check."""
from __future__ import annotations

import jax
import jax.numpy as jnp
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


def _models(arch: str, seed: int):
    cfg = get_config(arch).reduced()
    tcfg = torch_get_config(arch).reduced()
    jp = jlm.init_params(cfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, tcfg, jp, tp


def dense_models(seed: int = 0):
    """(jax cfg, port cfg, jax params, port params on the CPU)."""
    return _models("starcoder2-3b", seed)


def ssm_models(seed: int = 0):
    """The same for reduced falcon-mamba-7b (2 mamba1 layers, d_model 64,
    d_inner 128, N 16, vocab 256)."""
    return _models("falcon-mamba-7b", seed)


def tie_aware_check(jp, cfg, prompt, ref_tokens, got_tokens):
    """Equal greedy tokens, except at an exact or near tie of the JAX
    model: at the first mismatch, the reference logits (JAX prefill over
    the prompt and the reference tokens so far) must rank the port's token
    within LOGIT_TOL of the reference's own; the continuations then
    legitimately differ and are not compared.  Returns the index of the
    first mismatch, or None."""
    assert len(got_tokens) == len(ref_tokens)
    for t, (a, b) in enumerate(zip(ref_tokens, got_tokens)):
        if a == b:
            continue
        seq = np.concatenate([prompt, np.asarray(ref_tokens[:t], np.int32)])
        lg, _ = jlm.prefill(jp, {"tokens": jnp.asarray(seq[None])}, cfg)
        lg = np.asarray(lg[0, -1], np.float32)
        assert lg[a] - lg[b] <= LOGIT_TOL, (
            f"token {t}: reference {a} ({lg[a]}) vs port {b} ({lg[b]})")
        return t
    return None


def f32(x) -> np.ndarray:
    """A jax array or a torch tensor as a float32 numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)
