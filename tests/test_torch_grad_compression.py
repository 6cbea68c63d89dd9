"""PyTorch port: gradient push compression (``ps/compression.py``) held to
the JAX package on the CPU.

int8 quantizes each gradient leaf as one block of the port's int8 kernels.
On the same uniforms as the JAX package's ``_stochastic_round_int8``:
scales within one f32 ulp (C8: XLA may turn the division by 127 into a
multiply), q exactly where the scales agree, and the dequantized leaf
exactly there too.  Then ``compress_grads`` over a whole gradient tree
with JAX's per-leaf draws, bf16 and none; and the kernel file's grid-wide
path for blocks that large (each CTA's partial max over its share, the
block's max folded from the partials, then each value rounded with its own
u) emulated in plain torch, with its constants read from ``quant.cu``,
against the plain version bit for bit.  The CUDA kernels run only on the
card (``test_torch_cuda_train.py``, ``chip_smoke.py``)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ps import compression as jc
from repro_torch.core.tree import flatten
from repro_torch.kernels import _build
from repro_torch.kernels.quant import dequantize_ref, quantize_ref
from repro_torch.kernels.quant import kernel as qkernel
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.ps.compression import (compress_grads,
                                        compressed_bytes_per_push, leaf_seed,
                                        quantize_dequantize_int8)

from _torch_port import f32

CU = (_build.CSRC / "quant.cu").read_text()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


VEC_BYTES, CTA_THREADS = _cu_const("kVecBytes"), _cu_const("kCtaThreads")
CTA_MAX_VPL, GRID_MIN = _cu_const("kCtaMaxVpl"), _cu_const("kGridBlockMin")
H100_SMS = 132


def _ulps(a, b):
    """f32 ulps between two positive f32 arrays."""
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"embed": {"tokens": rng.standard_normal((256, 64))
                      .astype(np.float32) * 0.02},
            "layers": {"mlp": {"wi": rng.standard_normal((2, 64, 128))
                               .astype(np.float32) * 3e-3},
                       "ln1": {"scale": rng.standard_normal((2, 64))
                               .astype(np.float32)}},
            "final_norm": {"scale": np.zeros(64, np.float32)}}


@pytest.mark.parametrize("n,scale,seed", [
    (1000, 1.0, 0), (5000, 1e-3, 1), (33 * 129, 40.0, 2), (70_001, 0.02, 3),
])
def test_per_tensor_int8_matches_jax_on_the_same_uniforms(n, scale, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * scale).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    u = np.array(jax.random.uniform(key, g.shape, jnp.float32))
    jq, js = jc._stochastic_round_int8(jnp.asarray(g), key)
    q, s = quantize_ref(torch.from_numpy(g), torch.from_numpy(u), block=n)
    assert s.shape == (1,)
    assert _ulps(s.numpy(), np.asarray(js)).max() <= 1
    if float(s[0]) == float(js):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        jd = jc.quantize_dequantize_int8(jnp.asarray(g), key)
        td = quantize_dequantize_int8(torch.from_numpy(g),
                                      torch.from_numpy(u))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    else:                               # one q step at most, where it moved
        assert np.abs(q.numpy().astype(int) - np.asarray(jq, int)).max() <= 1


@pytest.mark.parametrize("step", [0, 7])
def test_compress_grads_int8_matches_jax_with_its_draws(step):
    """The JAX package's ``compress_grads`` draws from fold_in(PRNGKey(17),
    step) split per leaf in sorted-key order; the same draws handed to the
    port give its values wherever a leaf's scale agrees (every leaf here),
    in place and in the leaf's dtype (bf16 and f32 leaves)."""
    tree = _grad_tree(step)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jtree["embed"]["tokens"] = jtree["embed"]["tokens"].astype(jnp.bfloat16)
    want = jc.compress_grads(jtree, "int8", step)
    leaves, treedef = jax.tree_util.tree_flatten(jtree)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(17), step),
                            len(leaves))
    us = jax.tree_util.tree_unflatten(treedef, [
        np.asarray(jax.random.uniform(k, x.shape, jnp.float32))
        for x, k in zip(leaves, keys)])
    grads = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                   device="cpu")
    ids = [id(t) for t in flatten(grads)[1]]
    out = compress_grads(grads, "int8", step,
                         uniforms=train_state_from_numpy(us, device="cpu"))
    assert out is grads and [id(t) for t in flatten(out)[1]] == ids
    assert out["embed"]["tokens"].dtype == torch.bfloat16
    got = train_state_to_numpy(out)
    for p, a, b in zip(flatten(got)[0], flatten(got)[1],
                       flatten(jax.tree_util.tree_map(
                           lambda x: np.asarray(x, np.float32), want))[1]):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_compress_grads_bf16_and_none():
    tree = _grad_tree(5)
    want = jc.compress_grads(jax.tree_util.tree_map(jnp.asarray, tree),
                             "bf16", 0)
    grads = train_state_from_numpy(tree, device="cpu")
    assert compress_grads(grads, "none", 0) is grads
    out = compress_grads(grads, "bf16", 0)
    for a, b in zip(flatten(out)[1], flatten(want)[1]):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(f32(a), np.asarray(b))
    with pytest.raises(ValueError, match="compression mode"):
        compress_grads(grads, "fp4", 0)


def test_own_draws_are_seeded_per_step_and_leaf():
    """Without injected uniforms every (step, leaf) has its own stream:
    the same step twice gives the same push, another step another."""
    def push(step):
        return compress_grads(train_state_from_numpy(_grad_tree(1),
                                                     device="cpu"),
                              "int8", step)

    a, b, c = push(3), push(3), push(4)
    for x, y, z in zip(flatten(a)[1], flatten(b)[1], flatten(c)[1]):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, z) for x, z in zip(flatten(a)[1],
                                                     flatten(c)[1]))
    seeds = {leaf_seed(s, i) for s in range(50) for i in range(20)}
    assert len(seeds) == 1000


@pytest.mark.parametrize("n_params", [0, 1, 4_312_980_480])
def test_compressed_bytes_per_push_matches_jax(n_params):
    for mode in ("none", "bf16", "int8"):
        assert compressed_bytes_per_push(n_params, mode) == \
            jc.compressed_bytes_per_push(n_params, mode)


# ----------------------------------------------------- the grid-wide path
def grid_plan(n_blocks, block, itemsize, aligned=True, n_sms=H100_SMS,
              per_sm=8):
    """``launch_quantize``'s choice for a block beyond a CTA team: None
    below kGridBlockMin, else (V, parts): 16-byte vectors or single values,
    and the CTAs a block (the card's resident CTAs over the blocks, at
    most one a 256 values' share, at most what the scratch holds)."""
    V = VEC_BYTES // itemsize
    vec = block % V == 0 and aligned
    vpl = -(-(block // V) // CTA_THREADS)
    if vec and block > 1024 and vpl <= CTA_MAX_VPL:
        return None                                 # the CTA-team kernel
    if block <= GRID_MIN:
        return None
    V = V if vec else 1
    n_partial = max(n_blocks, qkernel.PARTIALS_PER_SM * n_sms)
    n = block // V
    parts = min(n_sms * per_sm // n_blocks, -(-n // CTA_THREADS),
                n_partial // n_blocks)
    return V, max(parts, 1)


def grid_schedule(x, u, block, aligned=True):
    """The two kernels in the order of their partition: CTA c of block
    c // parts takes the vectors (part * 256 + t) + k * parts * 256 of its
    block; its max goes to partial[c]; the rounding kernel's CTAs fold
    their block's partials and round the same shares.  Asserts that every
    value is read by exactly one CTA of each pass and written once."""
    n = x.shape[0]
    nb = n // block
    V, parts = grid_plan(nb, block, x.element_size(), aligned)
    xb = x.float().reshape(nb, block)
    ub = u.float().expand(n).reshape(nb, block)
    nvec = block // V
    partial = torch.zeros(nb * parts)
    seen = torch.zeros(nb, block, dtype=torch.int32)
    shares = {}
    for c in range(nb * parts):
        blk, part = divmod(c, parts)
        i = torch.arange(part * CTA_THREADS, nvec, parts * CTA_THREADS)
        i = (i[:, None] + torch.arange(CTA_THREADS)).reshape(-1)
        i = i[i < nvec]
        vals = (i[:, None] * V + torch.arange(V)).reshape(-1)
        shares[c] = vals
        seen[blk, vals] += 1
        partial[c] = xb[blk, vals].abs().max() if len(vals) else 0.0
    assert bool((seen == 1).all())
    q = torch.zeros(nb, block, dtype=torch.int8)
    scales = torch.zeros(nb)
    for c, vals in shares.items():
        blk, part = divmod(c, parts)
        amax = torch.clamp(partial[blk * parts:(blk + 1) * parts].max(),
                           min=1e-12)
        scale = amax / torch.full_like(amax, 127.0)
        if part == 0:
            scales[blk] = scale
        s = xb[blk, vals] / scale
        lo = torch.floor(s)
        q[blk, vals] = torch.clamp(lo + (ub[blk, vals] < s - lo).float(),
                                   -127, 127).to(torch.int8)
    return q.reshape(n), scales


@pytest.mark.parametrize("n,block,dtype,aligned", [
    (4097 * 3, 4097 * 3, torch.float32, True),     # ragged: single values
    (8200, 8200, torch.float32, True),             # vectors, just above
    (100_000, 100_000, torch.bfloat16, True),      # one block per tensor
    (3 * 40_000, 40_000, torch.float32, True),     # several blocks
    (50_001, 50_001, torch.bfloat16, False),       # misaligned, odd
    (2 * 333_336, 333_336, torch.bfloat16, True),
])
def test_grid_schedule_matches_plain(n, block, dtype, aligned):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                         * 3).to(dtype)
    u = torch.from_numpy(rng.random(n).astype(np.float32))
    assert grid_plan(n // block, block, x.element_size(), aligned) \
        is not None
    q, s = grid_schedule(x, u, block, aligned)
    rq, rs = quantize_ref(x, u, block=block)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    out = dequantize_ref(q, s, block=block, out_dtype=dtype)
    assert torch.equal(out, dequantize_ref(rq, rs, block=block,
                                           out_dtype=dtype))


def test_grid_path_takes_every_leaf_the_team_kernels_cannot():
    """Every gradient leaf of full-width starcoder2-3b quantized as one
    block either fits a CTA team (the final norm's 3,072 values) or takes
    the grid-wide path; the largest is below the C interface's 2**31."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    shapes = flatten(lm.param_shapes(get_config("starcoder2-3b")))[1]
    sizes = [int(np.prod(s)) for s in shapes]
    assert max(sizes) == 30 * 3072 * 12288 < qkernel.N_MAX
    for n in sizes:
        plan = grid_plan(1, n, 2)
        assert (plan is None) == (n <= GRID_MIN), n
