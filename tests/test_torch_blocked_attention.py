"""PyTorch port: ``blocked_attention``, the CPU prefill and training
attention, held to the JAX package's ``chunked_attention`` — forward and
gradients (autograd against XLA's autodiff of the ``jax.checkpoint``-ed kv
blocks) — at group sizes G = 1, 2 and 12, k_chunk below (halved until it
divides Skv), equal to and above Skv, causal and not, and through the
port's ``chunked_attention`` entry point on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as j_chunked_attention
from repro_torch.models.attention import blocked_attention, chunked_attention

from _torch_port import f32

# Forward, port against JAX, relative to the output's largest |value|: the
# same bf16 roundings (q, P before P.V, the output) and f32 sums in another
# order, so a bf16 output may land one step apart.  Measured: 1.1e-3 over
# the 18 cases (16 of them bit for bit).
OUT_RTOL = 4e-3
# Gradients, relative to each gradient's largest |value|: P is rounded to
# bf16 for P.V in both, and so is its cotangent; the rest is f32 summation
# order (over the G heads of a group for dk and dv) and the bf16 result.
# Measured: up to 1.08e-2 (dv at G = 12, not causal).
GRAD_RTOL = 2e-2
B, S, HD = 2, 48, 16


def _inputs(H, K, seed):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return r(B, S, H, HD), r(B, S, K, HD), r(B, S, K, HD), r(B, S, H, HD)


def _rel(got, want):
    got, want = f32(got), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("k_chunk", [32, 48, 100])   # 32 halves to 16
@pytest.mark.parametrize("H,K", [(2, 2), (4, 2), (12, 1)])
def test_blocked_attention_matches_jax(H, K, k_chunk, causal):
    qn, kn, vn, don = _inputs(H, K, seed=H * 100 + k_chunk)
    # the second request's positions start later: per-request masks
    pos = np.stack([np.arange(S), np.arange(S) + 5]).astype(np.int32)
    jpos = jnp.asarray(pos)

    def jloss(q, k, v):
        out = j_chunked_attention(q, k, v, causal=causal, q_positions=jpos,
                                  kv_positions=jpos, k_chunk=k_chunk)
        return (out.astype(jnp.float32) * jnp.asarray(don)).sum(), out

    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (qn, kn, vn))
    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (qn, kn, vn))
    tpos = torch.from_numpy(pos).long()
    out = blocked_attention(tq, tk, tv, causal=causal, q_positions=tpos,
                            kv_positions=tpos, k_chunk=k_chunk)
    tg = torch.autograd.grad((out.float() * torch.from_numpy(don)).sum(),
                             (tq, tk, tv))
    assert out.dtype == torch.bfloat16
    assert _rel(out, jout) <= OUT_RTOL, _rel(out, jout)
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        assert a.dtype == torch.bfloat16
        assert _rel(a, b) <= GRAD_RTOL, (name, _rel(a, b))
    # the model's entry point takes this path for CPU tensors
    via = chunked_attention(tq.detach(), tk.detach(), tv.detach(),
                            causal=causal, q_positions=tpos,
                            kv_positions=tpos, k_chunk=k_chunk)
    assert torch.equal(via, out.detach())
