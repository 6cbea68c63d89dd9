"""PyTorch port: the serve steps over the dense per-slot cache held to the
JAX package on the CPU.

(a) ``init_cache_shapes`` and ``init_cache`` give the JAX package's
shapes and dtypes for every family; (b) the decode kind of
``input_specs`` / ``synthetic_batch`` is the JAX package's batch bit for
bit; (c) ``build_prefill_step`` then ``build_decode_step`` over the dense
cache on a 1x1 mesh against the JAX package's, for reduced dense, moe,
vlm, ssm and hybrid models, within the bounds of the port's family tests,
and bit for bit the port's single-device steps; (d) ``jit_serve_step``'s
shapes are the JAX package's.  The 2x2 serve steps (four gloo processes)
are held in ``test_torch_mesh.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.registry import get_config as jget_config
from repro.distributed.sharding import \
    single_device_meshspec as j_single_device_meshspec
from repro.models import lm as jlm
from repro.ps.stepfn import StepKnobs as JStepKnobs
from repro.ps.stepfn import build_decode_step as j_build_decode_step
from repro.ps.stepfn import build_prefill_step as j_build_prefill_step
from repro.ps.stepfn import jit_serve_step as j_jit_serve_step
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.distributed.sharding import single_device_meshspec
from repro_torch.models import lm as tlm
from repro_torch.ps.stepfn import (StepKnobs, build_decode_step,
                                   build_prefill_step, jit_serve_step)

from _torch_port import (LOGIT_TOL, _models, assert_decode_batch_matches_jax,
                         f32)

DECODING = {"dense": "starcoder2-3b", "moe": "llama4-scout-17b-a16e",
            "vlm": "phi-3-vision-4.2b", "ssm": "falcon-mamba-7b",
            "hybrid": "zamba2-1.2b",
            "qkv_bias": "qwen2-72b"}     # the dense family with biases
FAMILIES = dict(DECODING, encoder="hubert-xlarge")
B, P, MAX_SEQ, STEPS = 2, 12, 24, 4
# The bounds of the family tests (test_torch_lm.py, test_torch_moe.py,
# test_torch_vlm.py, test_torch_mamba.py, test_torch_hybrid.py): logits
# within LOGIT_TOL, the hybrid's within 12/64 (its mamba2 state and shared
# block add their rounding); KV rows within LOGIT_TOL (the hybrid's slab
# 1/8), the ssm conv window and state within two bf16 steps at |x| < 2
# (4/128), the hybrid's conv within 1/8 and its state within 1/16.
LOGIT_BOUND = {"hybrid": 12 / 64}
CACHE_BOUND = {"k": LOGIT_TOL, "v": LOGIT_TOL, "conv": 4 / 128,
               "h": 4 / 128}
HYBRID_CACHE_BOUND = {"shared_k": 1 / 8, "shared_v": 1 / 8, "conv": 1 / 8,
                      "h": 1 / 16}


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_cache_matches_jax(family):
    """Shapes (L, B, max_seq, K, hd) for the attention families (the
    encoder too, as the JAX package shapes it), conv and h (and the
    hybrid's slab) for ssm and hybrid; dtypes bf16, h f32; all zeros."""
    arch = FAMILIES[family]
    cfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    want = jlm.init_cache_shapes(cfg, 3, 16)
    got = tlm.init_cache_shapes(tcfg, 3, 16)
    assert sorted(got) == sorted(want)
    cache = tlm.init_cache(tcfg, 3, 16, device="cpu")
    for k, s in want.items():
        assert got[k] == tuple(s.shape), k
        assert tuple(cache[k].shape) == tuple(s.shape)
        assert str(cache[k].dtype).replace("torch.", "") == str(s.dtype), k
        assert not cache[k].any()
    if family in ("dense", "moe", "vlm", "encoder"):
        assert got["k"] == (cfg.n_layers, 3, 16, cfg.n_kv_heads, cfg.hd)
        with pytest.raises(ValueError, match="max_seq"):
            tlm.init_cache_shapes(tcfg, 3)


@pytest.mark.parametrize("family", list(DECODING))
def test_decode_batch_matches_jax(family):
    assert_decode_batch_matches_jax(DECODING[family], B=3, S=17, seed=4)


def _dense_cache(init, prefill_cache, put):
    """The dense decode cache with a prefill's rows in front: attention k
    and v (and the hybrid's slab) at rows [0, P), conv and h whole."""
    for k, v in prefill_cache.items():
        if k in ("k", "v", "shared_k", "shared_v"):
            init = put(init, k, v)
        else:
            init[k] = v
    return init


@pytest.mark.parametrize("family", list(DECODING))
def test_serve_steps_match_jax_on_one_device_mesh(family):
    """A prefill of P tokens, its rows copied into the dense cache of
    MAX_SEQ, then STEPS decode steps of the JAX package's greedy tokens:
    the port's steps on the 1x1 mesh against the JAX steps (logits at
    every step and the final cache within the family bounds), and bit
    for bit against the port's single-device steps (no mesh)."""
    arch = DECODING[family]
    cfg, tcfg, jp, tp = _models(arch, 0)
    tok = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    jpre = j_build_prefill_step(cfg, None, JStepKnobs())
    jdec = j_build_decode_step(cfg, None, JStepKnobs())
    if family != "moe":
        # compiled once; the moe steps run op by op, as test_torch_moe.py
        # runs them (XLA's fusions keep near-tied router scores in f32)
        jpre, jdec = jax.jit(jpre), jax.jit(jdec)
    jl, jc = jpre(jp, {"tokens": jnp.asarray(tok)})

    def jput(c, k, v):
        c[k] = c[k].at[:, :, :P].set(v.astype(c[k].dtype))
        return c
    jcache = _dense_cache(jlm.init_cache(cfg, B, MAX_SEQ),
                          {k: (v.astype(jnp.bfloat16) if k == "conv" else v)
                           for k, v in jc.items()}, jput)

    def tput(c, k, v):
        c[k][:, :, :P] = v
        return c
    runs = {}
    for arm, ms in (("mesh", single_device_meshspec()), ("single", None)):
        tl, tc = build_prefill_step(tcfg, ms)(tp, {"tokens": T(tok).long()})
        cache = _dense_cache(tlm.init_cache(tcfg, B, MAX_SEQ, device="cpu"),
                             {k: v.to(torch.bfloat16) if k == "conv" else v
                              for k, v in tc.items()}, tput)
        runs[arm] = ([tl], cache, build_decode_step(tcfg, ms,
                                                    max_seq=MAX_SEQ))
    bound = LOGIT_BOUND.get(family, LOGIT_TOL)
    np.testing.assert_allclose(f32(runs["mesh"][0][0]), f32(jl), atol=bound,
                               rtol=0)
    pos = np.full((B,), P, np.int32)
    for step in range(STEPS):
        nt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jcache = jdec(jp, jcache, jnp.asarray(nt), jnp.asarray(pos))
        for arm, (logits, cache, dec) in runs.items():
            tl, out = dec(tp, cache, T(nt).long(), T(pos))
            assert out is cache
            logits.append(tl)
        np.testing.assert_allclose(f32(runs["mesh"][0][-1]), f32(jl),
                                   atol=bound, rtol=0,
                                   err_msg=f"step {step}")
        pos = pos + 1
    bounds = HYBRID_CACHE_BOUND if family == "hybrid" else CACHE_BOUND
    mesh_cache, single_cache = runs["mesh"][1], runs["single"][1]
    assert sorted(mesh_cache) == sorted(jcache)
    for k, v in mesh_cache.items():
        np.testing.assert_allclose(f32(v), f32(jcache[k]), atol=bounds[k],
                                   rtol=0, err_msg=k)
        assert torch.equal(v, single_cache[k]), k
    for a, b in zip(*(runs[arm][0] for arm in ("mesh", "single"))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_jit_serve_step_shapes_match_jax(family, kind):
    """``jit_serve_step`` returns the JAX package's parameter (and cache)
    shapes for a cell, and a step that runs on them."""
    arch = DECODING[family]
    cfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    _, jshapes = j_jit_serve_step(cfg, JShapeConfig("c", 16, 2, kind),
                                  j_single_device_meshspec(), JStepKnobs())
    step, shapes = jit_serve_step(tcfg, ShapeConfig("c", 16, 2, kind),
                                  single_device_meshspec(), StepKnobs())
    assert callable(step)
    pj, pt = (jshapes, shapes) if kind == "prefill" else (jshapes[0],
                                                          shapes[0])
    flat = jax.tree_util.tree_leaves_with_path(pj)
    for path, s in flat:
        d = pt
        for key in path:
            d = d[key.key]
        assert d == tuple(s.shape), path
    if kind == "decode":
        assert {k: tuple(v.shape) for k, v in jshapes[1].items()} == shapes[1]
