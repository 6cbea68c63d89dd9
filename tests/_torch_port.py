"""Shared set-up of the PyTorch-port parity tests: the same reduced
starcoder2-3b, falcon-mamba-7b and zamba2-1.2b parameters in both
packages, the tolerances the tests hold the port to, and the tie-aware
token check."""
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
# and the silu, softplus and attention round op by op as XLA does
# (``common.silu``, ``blocked_attention``), but XLA and PyTorch block some
# bf16 matrix products differently and round them a step apart.  Through
# two layers the logits then differ by up to ~2.4 bf16 steps (0.038
# measured over seeded prompts of 3-64 tokens), so the bound is four
# steps.
LOGIT_TOL = 4 / 64


def _models(arch: str, seed: int, **overrides):
    cfg = get_config(arch).reduced(**overrides)
    tcfg = torch_get_config(arch).reduced(**overrides)
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


def hybrid_models(seed: int = 0, n_layers: int = 3):
    """The same for reduced zamba2-1.2b (mamba2 layers, d_model 64, d_inner
    128 in 8 heads of 16, N 16; the shared block every 2 layers, so 3
    layers apply it twice, after layers 0 and 2)."""
    return _models("zamba2-1.2b", seed, n_layers=n_layers)


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


def assert_decode_batch_matches_jax(arch: str, B: int = 2, S: int = 20,
                                    seed: int = 9):
    """The decode kind of ``input_specs`` / ``synthetic_batch`` against
    the JAX package's, bit for bit: tokens (B, 1) and pos (B,) = S - 1,
    and the cache of ``init_cache_shapes`` all zeros, the JAX draws spent
    in its tree order (cache, pos, tokens) so the tokens agree."""
    import torch

    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.data.synthetic import input_specs as j_input_specs
    from repro.data.synthetic import synthetic_batch as j_synthetic_batch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import input_specs, synthetic_batch
    cfg, tcfg = get_config(arch).reduced(), torch_get_config(arch).reduced()
    jshape, shape = JShapeConfig("d", S, B, "decode"), ShapeConfig(
        "d", S, B, "decode")
    want, jspecs = j_synthetic_batch(cfg, jshape, seed), j_input_specs(
        cfg, jshape)
    got, specs = synthetic_batch(tcfg, shape, seed, device="cpu"), \
        input_specs(tcfg, shape)
    assert sorted(got) == sorted(want) == sorted(specs) == [
        "cache", "pos", "tokens"]
    assert sorted(got["cache"]) == sorted(want["cache"])
    assert specs["tokens"] == ((B, 1), torch.int64)
    assert specs["pos"] == ((B,), torch.int32)
    for k, v in got["cache"].items():
        j = jspecs["cache"][k]
        assert (tuple(v.shape), v.dtype) == specs["cache"][k]
        assert tuple(v.shape) == tuple(j.shape)
        assert str(v.dtype).replace("torch.", "") == str(j.dtype)
        assert not v.any()
    for k in ("tokens", "pos"):
        assert tuple(got[k].shape) == tuple(want[k].shape)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert (got["pos"] == S - 1).all()
