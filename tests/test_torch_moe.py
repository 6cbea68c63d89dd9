"""PyTorch port: the moe family held to the JAX package on the CPU.

``models/moe.py`` against ``repro.models.moe`` on the same numpy inputs
(top-1 and top-2, dropless and dropping capacity, right-pad rows, router
ties made by hand); the reduced llama4-scout-17b-a16e and
qwen3-moe-235b-a22b LMs (2 layers, d_model 64, 4 experts of d_ff 128,
top-1 and top-2) in prefill and paged decode; the serving engine's tokens
against the JAX engine's, with and without speculation; the loss, its aux
and the gradients against ``jax.value_and_grad``, with and without remat;
one train step with the int8 push against the JAX step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget_config
from repro.data.synthetic import lm_batch_iterator as j_batches
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.lm import ModelKnobs as JKnobs
from repro.optim import make_optimizer as j_make_optimizer
from repro.ps.stepfn import StepKnobs as JStepKnobs
from repro.ps.stepfn import build_train_step as j_build_train_step
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import serve_loop as j_serve_loop
from repro.serving.knobs import DEFAULT_SERVING_SETTING
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import flatten, unflatten
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.models.lm import ModelKnobs
from repro_torch.ps import stepfn
from repro_torch.ps.compression import compress_grads
from repro_torch.ps.stepfn import StepKnobs, build_train_step
from repro_torch.serving import Request, ServingEngine, serve_loop
from repro_torch.serving.knobs import serving_knob_space
from repro_torch.serving.pool import PagedKVPool, make_state_pool

from _torch_port import LOGIT_TOL, _models, f32, tie_aware_check

ARCHS = ("llama4-scout-17b-a16e", "qwen3-moe-235b-a22b")
# the JAX step's bounds (test_torch_train_step.py): the loss and a leaf's
# gradient relative to its largest |value|
LOSS_TOL, GRAD_RTOL = 1e-2, 0.04
AUX_TOL = 1e-6            # the router loss of one block on equal inputs:
                          # f32 means summed in another order
F32_TOL = 2e-5            # the block's output in f32: summation order
MAX_SEQ = 48
_MODELS: dict = {}


def moe_models(arch: str, seed: int = 0, **overrides):
    """(jax cfg, port cfg, jax params, port params) of a reduced moe
    config, cached per (arch, seed, overrides)."""
    key = (arch, seed, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        _MODELS[key] = _models(arch, seed, **overrides)
    return _MODELS[key]


# ---------------------------------------------------------------- the block
def _block_case(arch, topk, cf, dtype, ties, T=64, seed=0):
    """A reduced moe config (4 experts, d_model 64, d_ff 128), router and
    expert weights, and T tokens whose last 20 rows are one pad row (the
    embedding of one token, as a right-padded prefill hands them over).
    ``ties``: experts 1 and 3 get the same router column, so every token
    ties between them.  At cf 1.0 the pad rows, routed alike, overflow
    their expert's capacity: drops are certain."""
    cfg = jget_config(arch).reduced(moe_top_k=topk, capacity_factor=cf)
    tcfg = get_config(arch).reduced(moe_top_k=topk, capacity_factor=cf)
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.standard_normal((D, E)) * 0.3,
         "wi": rng.standard_normal((E, D, F)) * 0.1,
         "wg": rng.standard_normal((E, D, F)) * 0.1,
         "wo": rng.standard_normal((E, F, D)) * 0.1}
    if ties:
        p["router"][:, 3] = p["router"][:, 1]
    x = rng.standard_normal((T, D))
    x[-20:] = x[-21]
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = {k: jnp.asarray(v, jnp.float32).astype(jd) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)).to(td)
          for k, v in p.items()}
    return (cfg, tcfg, jp, tp, jnp.asarray(x, jnp.float32).astype(jd),
            torch.from_numpy(x.astype(np.float32)).to(td))


def _bf16_steps(ref):
    """One bf16 step (2^-7 of the leading power of two) at each value, at
    least that of 2^-8 of the largest |value|: a sum that cancels to near
    zero keeps the rounding of its terms, not of its result."""
    a = np.maximum(np.abs(ref), np.abs(ref).max() * 2.0 ** -8)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


BLOCK_CASES = [(a, k, cf, dt, ties) for a in ARCHS for k in (1, 2)
               for cf in (1.0, 4.0) for dt in ("f32", "bf16")
               for ties in (False, True)
               if not (a == ARCHS[1] and dt == "f32" and ties)]


@pytest.mark.parametrize("arch,topk,cf,dtype,ties", BLOCK_CASES)
def test_moe_block_matches_jax(arch, topk, cf, dtype, ties):
    """Outputs within 2e-5 in f32 and one bf16 step in bf16; the aux within
    1e-6; the same chosen experts, the same kept and dropped pairs."""
    cfg, tcfg, jp, tp, jx, tx = _block_case(arch, topk, cf, dtype, ties)
    jo, ja = jmoe.moe_block(jx, jp, cfg)
    to, ta = tmoe.moe_block(tx, tp, tcfg)
    want, got = f32(jo), f32(to)
    assert got.shape == want.shape and to.dtype == tx.dtype
    tol = F32_TOL if dtype == "f32" else _bf16_steps(want)
    assert np.all(np.abs(got - want) <= tol)
    assert abs(float(ja) - float(ta)) <= AUX_TOL
    _, _, jmeta = jmoe._local_dispatch(jx, jp["router"], cfg)
    _, _, tmeta = tmoe._local_dispatch(tx, tp["router"], tcfg)
    for name, a, b in zip(("se", "pos", "tok", "keep"), jmeta, tmeta):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
    assert jmeta[5] == tmeta[5]
    dropped = int((~np.asarray(jmeta[3])).sum())
    assert (dropped > 0) == (cf == 1.0)
    if ties:                              # the lower expert of a tie first
        assert not (tmeta[0] == 3).any() or topk == 2


@pytest.mark.parametrize("arch,topk,cf", [(a, k, cf) for a in ARCHS
                                          for k in (1, 2) for cf in (1.0,
                                                                     4.0)])
def test_local_dispatch_matches_jax(arch, topk, cf):
    """``_local_dispatch``: xe (E, C, D) bit for bit (zeros where an
    expert's slots are not filled), the aux, and the combine metadata
    (se, pos, tok, keep exactly, the gate weights within f32 rounding, C)."""
    cfg, tcfg, jp, tp, jx, tx = _block_case(arch, topk, cf, "f32", True,
                                            T=37 + 27 * (cf == 1.0))
    jxe, jaux, jmeta = jmoe._local_dispatch(jx, jp["router"], cfg)
    txe, taux, tmeta = tmoe._local_dispatch(tx, tp["router"], tcfg)
    np.testing.assert_array_equal(f32(txe), f32(jxe))
    assert abs(float(jaux) - float(taux)) <= AUX_TOL
    for a, b in zip(jmeta[:4], tmeta[:4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_allclose(f32(tmeta[4]), f32(jmeta[4]), rtol=1e-6)
    assert tmeta[5] == jmeta[5] == tmoe._capacity(tx.shape[0], topk, 4, cf)


@pytest.mark.parametrize("T,k,E,cf", [(1, 1, 16, 1.25), (8, 1, 16, 1.25),
                                      (32, 1, 16, 1.25), (320, 1, 16, 1.25),
                                      (2048, 1, 16, 1.25), (24, 8, 128, 1.25),
                                      (40, 2, 4, 1.0), (13, 2, 4, 4.0),
                                      (100, 1, 16, 1.0), (4096, 8, 128, 1.25)])
def test_capacity_matches_jax(T, k, E, cf):
    """The static capacity, Python's round (half to even) included: 32
    decode-verify tokens over 16 experts at 1.25 give round(2.5) = 2, then
    the small-T floor of 16."""
    assert tmoe._capacity(T, k, E, cf) == jmoe._capacity(T, k, E, cf)


def test_moe_block_over_a_mesh_is_not_ported():
    """Over the one-device mesh moe_block takes the single-device path
    (as the JAX package's does) and moe_block_ep, all experts on the one
    model rank, gives the same bits; a larger mesh needs its ranks
    (tests/test_torch_mesh.py runs them)."""
    from repro_torch.distributed.sharding import single_device_meshspec
    from repro_torch.launch.mesh import make_meshspec
    _, tcfg, _, tp, _, tx = _block_case(ARCHS[0], 1, 4.0, "f32", False)
    want, waux = tmoe.moe_block(tx, tp, tcfg)
    ms = single_device_meshspec()
    for out, aux in (tmoe.moe_block(tx, tp, tcfg, ms=ms),
                     tmoe.moe_block_ep(tx, tp, tcfg, ms)):
        assert torch.equal(out, want) and torch.equal(aux, waux)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_meshspec(2, 2)


def test_serving_skips_the_aux_loss():
    _, tcfg, _, tp, _, tx = _block_case(ARCHS[0], 1, 4.0, "f32", False)
    out, aux = tmoe.moe_block(tx, tp, tcfg, want_aux=False)
    assert aux is None
    assert torch.equal(out, tmoe.moe_block(tx, tp, tcfg)[0])


# ------------------------------------------------------------------- the LM
def test_params_shapes_init_and_conversion():
    """``param_shapes`` has the JAX tree's moe leaves (router (D, E), wi/wg
    (E, D, F), wo (E, F, D), stacked on L); ``init_params`` draws each at
    JAX's fan-in (in_axis = ndim - 2); ``params_from_numpy`` carries the
    JAX parameters and a train state across unchanged."""
    cfg, tcfg, jp, tp = moe_models(ARCHS[0])
    jl = dict(zip(*flatten(jax.tree_util.tree_map(np.asarray, jp))))
    tl = dict(zip(*flatten(tp)))
    assert jl.keys() == tl.keys()
    assert {"layers/moe/router", "layers/moe/wi", "layers/moe/wg",
            "layers/moe/wo"} <= set(tl) and "layers/mlp/wi" not in tl
    L, D, E, F = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff
    assert tl["layers/moe/wi"].shape == (L, E, D, F)
    assert tl["layers/moe/wo"].shape == (L, E, F, D)
    assert tl["layers/moe/router"].shape == (L, D, E)
    for k, a in jl.items():
        assert tl[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(tl[k]), a.astype(np.float32))
    shapes = dict(zip(*flatten(tlm.param_shapes(tcfg))))
    assert {k: tuple(v.shape) for k, v in jl.items()} == {
        k: tuple(v) for k, v in shapes.items()}
    fresh = dict(zip(*flatten(tlm.init_params(tcfg, 3, device="cpu"))))
    for k in ("layers/moe/wi", "layers/moe/wo", "layers/moe/router"):
        t = f32(fresh[k])
        fan_in = t.shape[t.ndim - 2]
        assert np.abs(t).max() <= 2.0 / np.sqrt(fan_in) + 1e-2, k
        assert abs(t.std() * np.sqrt(fan_in) - 0.880) < 0.05, k
    again = tlm.init_params(tcfg, 3, device="cpu")
    assert all(torch.equal(fresh[k], v)
               for k, v in zip(*flatten(again)))
    # a train state: params, Adam moments, step, a staleness queue
    opt_init, _ = j_make_optimizer(JTrainConfig())
    jstate = {"params": jp, "opt": opt_init(jp),
              "step": jnp.asarray(7, jnp.int32),
              "grad_queue": jax.tree_util.tree_map(
                  lambda p: jnp.ones((2,) + p.shape, jnp.bfloat16), jp)}
    jnp_state = jax.tree_util.tree_map(np.asarray, jstate)
    ts = train_state_from_numpy(jnp_state, device="cpu")
    back = train_state_to_numpy(ts)
    for (pa, a), (pb, b) in zip(zip(*flatten(jnp_state)),
                                zip(*flatten(back))):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    assert ts["opt"]["m"]["layers"]["moe"]["wi"].shape == (L, E, D, F)
    assert ts["opt"]["m"]["layers"]["moe"]["wi"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [5, 16, 37])
def test_prefill_logits_match_jax(arch, S):
    cfg, tcfg, jp, tp = moe_models(arch)
    tok = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                            (2, S)).astype(np.int32)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tok)}, cfg)
    tl, tc = tlm.prefill(tp, torch.from_numpy(tok).long(), tcfg)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL, rtol=0)
    assert tuple(tc["k"].shape) == jc["k"].shape


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,dtype", [(1, "float32"), (1, "bfloat16"),
                                     (4, "bfloat16")])
def test_paged_decode_step_matches_jax(arch, S, dtype):
    """One decode step (S = 1) and one 4-token chunked step over the same
    paged pool: logits within LOGIT_TOL, the KV written within it."""
    cfg, tcfg, jp, tp = moe_models(arch)
    rng = np.random.default_rng(11)
    bs, n_slots = 8, 4
    MB = -(-96 // bs)
    nb = n_slots * MB + 1
    shape = tlm.init_paged_cache_shapes(tcfg, nb, bs)["k"]
    kv = {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}
    bt = (np.arange(n_slots * MB).reshape(n_slots, MB) + 1).astype(np.int32)
    jc = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in kv.items()}
    jc["block_tables"] = jnp.asarray(bt)
    tc = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in kv.items()}
    tc["block_tables"] = torch.from_numpy(bt)
    tok = rng.integers(0, cfg.vocab_size, (n_slots, S)).astype(np.int32)
    pos = np.array([3, 17, 30, 9], np.int32)
    jl, jc = jlm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos), cfg,
                             None, JKnobs(attn_impl="paged"))
    tl, tc = tlm.decode_step(tp, tc, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos), tcfg,
                             ModelKnobs(attn_impl="paged"))
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(f32(tc["k"])[:, 1:], f32(jc["k"])[:, 1:],
                               atol=LOGIT_TOL, rtol=0)


def test_vlm_and_encoder_still_raise():
    """Of the two families the moe slice left, both are ported since
    (``test_torch_vlm.py``, ``test_torch_encoder.py``); what still raises
    is the encoder's serving, which has no decode step: the engine
    refuses hubert as the JAX engine does.  hubert builds its frame
    projection, vlm its patch projection."""
    hubert = get_config("hubert-xlarge").reduced()
    params = tlm.init_params(hubert, 0, device="cpu")
    assert params["frontend"]["proj"].shape == (hubert.frontend_dim,
                                                hubert.d_model)
    with pytest.raises(NotImplementedError,
                       match="encoder-only models have no decode step"):
        ServingEngine(params, hubert, max_seq=32, device="cpu")
    vlm = get_config("phi-3-vision-4.2b").reduced()
    assert tlm.init_params(vlm, 0, device="cpu")["frontend"]["proj"].shape \
        == (vlm.frontend_dim, vlm.d_model)
    assert tlm.init_params(get_config(ARCHS[0]).reduced(), 0,
                           device="cpu")["layers"]["moe"]["wi"].ndim == 4


# ------------------------------------------------------------------ serving
def _requests(vocab, cls=Request):
    """Two prompts sharing a 16-token template (two blocks of 8), one that
    is the template whole (copy-on-write), two unrelated."""
    rng = np.random.default_rng(4)
    tpl = rng.integers(1, vocab, (16,)).astype(np.int32)
    prompts = [np.concatenate([tpl, rng.integers(1, vocab, (3,))
                               .astype(np.int32)]), tpl.copy(),
               np.concatenate([tpl, rng.integers(1, vocab, (5,))
                               .astype(np.int32)]),
               rng.integers(1, vocab, (11,)).astype(np.int32),
               rng.integers(1, vocab, (7,)).astype(np.int32)]
    return [cls(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]


ENGINE_CASES = [(a, k, cf) for a in ARCHS for k in (0, 3) for cf in (4.0,)]
ENGINE_CASES += [(ARCHS[1], 3, 1.0)]


@pytest.mark.parametrize("arch,spec_k,cf", ENGINE_CASES)
def test_engine_tokens_match_jax_engine(arch, spec_k, cf):
    """The port's engine and the JAX engine on the same parameters and
    requests (prefix sharing on, 4 slots, blocks of 8): the same greedy
    tokens (tie-aware) with and without speculation (the n-gram drafter,
    the same in both packages), the same prefill and sharing counts, no
    block leaked.  At capacity factor 1.0 (qwen3-moe's top-2 over 4
    experts) the S = 4 verify steps dispatch 32 pairs of 16 tokens against
    a capacity of 16, where idle slots and drafts take capacity alike in
    both engines."""
    cfg, tcfg, jp, tp = moe_models(arch, capacity_factor=cf)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4, block_size=8,
                   prefix_share=True, spec_k=float(spec_k), drafter="ngram")
    je = JEngine(jp, cfg, setting, max_seq=MAX_SEQ)
    je.async_precompile = False
    te = ServingEngine(tp, tcfg, setting, max_seq=MAX_SEQ, device="cpu")
    assert te.pool.kind == je.pool.kind == "paged"
    js = j_serve_loop(je, _requests(cfg.vocab_size, JRequest))
    ts = serve_loop(te, _requests(cfg.vocab_size))
    assert ts["completed"] == js["completed"] == 5
    for k in ("prefill_tokens_computed", "prefill_tokens_total",
              "shared_blocks_hit", "cow_copies"):
        assert ts[k] == js[k], k
    assert ts["shared_blocks_hit"] > 0 and ts["cow_copies"] > 0
    if spec_k:
        assert te.spec_ticks > 0 and te.spec_drafted > 0
    jout = {r.rid: r.tokens_out for r in je.finished}
    tout = {r.rid: r.tokens_out for r in te.finished}
    for r in _requests(cfg.vocab_size):
        assert len(tout[r.rid]) == r.max_new
        tie_aware_check(jp, cfg, r.prompt, jout[r.rid], tout[r.rid])
    te.pool.check_invariants()
    snap = te.pool.snapshot()
    assert te.pool.n_active == 0
    assert snap["blocks_held"] == snap["prefix_cached_blocks"]


def test_moe_serves_through_the_paged_pool_and_knob_space():
    _, tcfg, _, tp = moe_models(ARCHS[0])
    pool = make_state_pool(tcfg, dict(DEFAULT_SERVING_SETTING), 32, "cpu")
    assert isinstance(pool, PagedKVPool) and pool.kind == "paged"
    names = {k.name for k in serving_knob_space(family="moe").knobs}
    assert {"block_size", "prefix_share", "quant", "block_overcommit"} \
        <= names
    eng = ServingEngine(tp, tcfg, dict(DEFAULT_SERVING_SETTING, max_batch=2,
                                       quant="int8"), max_seq=32,
                        device="cpu")
    stats = serve_loop(eng, _requests(tcfg.vocab_size)[:3])
    assert stats["completed"] == 3


# ----------------------------------------------------------------- training
def _batch(seed, B=4, S=16, vocab=256):
    rng = np.random.default_rng(seed)
    toks, labels = rng.integers(0, vocab, (2, B, S))
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _port_grads(tp, tcfg, batch, knobs):
    paths, pl = flatten(tp)
    ls = [p.detach().requires_grad_() for p in pl]
    loss, aux = tlm.loss_fn(unflatten(paths, ls), batch, tcfg, knobs)
    return loss, aux, unflatten(paths, list(torch.autograd.grad(loss, ls)))


def _jax_eager(fn, *args):
    """``fn`` run by the JAX package op by op (no XLA fusion; the layer
    scan as a Python loop through ``scan_unroll=-1`` in the knobs).

    The gradient references run so: compiled, XLA keeps some bf16
    activations in f32 between fused ops, which moves the router's
    near-tied margins across each other.  Measured on the reduced
    qwen3-moe (seed 0, batch 1): the compiled forward's layer-1 input
    differs from the eager one by 0.023, and two tokens whose 2nd and 3rd
    experts were 0.004 apart switch experts there (0.38 in the hidden
    state).  Op by op, the JAX block and the port's give equal layer
    outputs on these inputs, so a leaf compares rounding, not routing."""
    with jax.disable_jit():
        return fn(*args)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_aux_and_grads_match_jax(arch, remat):
    """``loss_fn``'s loss (the router aux weighted in), ce and aux against
    JAX within LOSS_TOL (the compiled loss too), every gradient leaf (the
    routers' and experts' included) within 4% of its largest |value| of
    the JAX package's gradient run op by op (``_jax_eager``)."""
    cfg, tcfg, jp, tp = moe_models(arch)
    jb, tb = _batch(1)
    (jl, jaux), jg = _jax_eager(jax.value_and_grad(jlm.loss_fn,
                                                   has_aux=True),
                                jp, jb, cfg, None,
                                JKnobs(remat=remat, scan_unroll=-1))
    compiled, _ = jlm.loss_fn(jp, jb, cfg, None, JKnobs(remat=remat))
    tl, taux, tg = _port_grads(tp, tcfg, tb, ModelKnobs(remat=remat))
    tl, taux = tl.detach(), {k: v.detach() for k, v in taux.items()}
    assert abs(float(compiled) - float(tl)) <= LOSS_TOL
    assert abs(float(jl) - float(tl)) <= LOSS_TOL
    for k in ("ce", "aux"):
        assert abs(float(jaux[k]) - float(taux[k])) <= LOSS_TOL, k
    assert float(taux["aux"]) > 0
    assert float(tl) == pytest.approx(float(taux["ce"]) + cfg.router_aux_weight
                                      * float(taux["aux"]), rel=1e-6)
    jl_ = dict(zip(*flatten(jax.tree_util.tree_map(np.asarray, jg))))
    for k, g in zip(*flatten(tg)):
        a = np.asarray(jl_[k], np.float32)
        assert np.abs(f32(g) - a).max() <= GRAD_RTOL * np.abs(a).max(), k


def test_remat_gives_the_same_gradients():
    """``remat`` none / dots / full change what is kept for the backward,
    not the arithmetic: the moe model's loss, aux and gradients are equal
    bit for bit."""
    _, tcfg, _, tp = moe_models(ARCHS[1])
    _, tb = _batch(2)
    base_loss, base_aux, base = _port_grads(tp, tcfg, tb, ModelKnobs())
    for remat in ("dots", "full"):
        loss, aux, g = _port_grads(tp, tcfg, tb, ModelKnobs(remat=remat))
        assert torch.equal(loss, base_loss) and torch.equal(
            aux["aux"], base_aux["aux"]), remat
        for a, b in zip(flatten(base)[1], flatten(g)[1]):
            assert torch.equal(a, b), remat


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_train_step_matches_jax(compression, monkeypatch):
    """Two Adam steps of the reduced llama4-scout in both packages from the
    same state on the same batches (the int8 push with the JAX package's
    uniforms injected, one quantize a leaf; the JAX step op by op, as
    ``_jax_eager`` says why): the loss within LOSS_TOL, new parameters
    within one bf16 step plus 2 lr a step, m within the gradient
    bound."""
    cfg, tcfg, jp, _ = moe_models(ARCHS[0])
    jtc, ttc = JTrainConfig(), TrainConfig()
    opt_init, _ = j_make_optimizer(jtc)
    jstate = {"params": jp, "opt": opt_init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = train_state_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jstate),
                                    device="cpu")
    jstep = j_build_train_step(cfg, jtc, None,
                               JStepKnobs(compression=compression,
                                          scan_unroll=-1))
    tstep = build_train_step(tcfg, ttc, StepKnobs(compression=compression))
    calls = []
    if compression == "int8":
        def injected(grads, mode, step, uniforms=None):
            leaves, treedef = jax.tree_util.tree_flatten(
                train_state_to_numpy(grads))
            keys = jax.random.split(jax.random.fold_in(
                jax.random.PRNGKey(17), int(step)), len(leaves))
            us = jax.tree_util.tree_unflatten(treedef, [
                np.asarray(jax.random.uniform(k, g.shape, jnp.float32))
                for g, k in zip(leaves, keys)])
            calls.append(len(leaves))
            return compress_grads(grads, mode, step, uniforms=(
                train_state_from_numpy(us, device="cpu")))

        monkeypatch.setattr(stepfn, "compress_grads", injected)
    jb, tb = j_batches(cfg, 4, 16, seed=5), lm_batch_iterator(
        tcfg, 4, 16, seed=5, device="cpu")
    for _ in range(2):
        jstate, jm = _jax_eager(jstep, jstate, next(jb))
        tstate, tm = tstep(tstate, next(tb))
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= LOSS_TOL
    if compression == "int8":
        assert calls == [len(flatten(tstate["params"])[1])] * 2
    want = dict(zip(*flatten(jax.tree_util.tree_map(np.asarray, jstate))))
    got = dict(zip(*flatten(tstate)))
    lr = ttc.learning_rate
    for k, a in want.items():
        a = np.asarray(a, np.float32)
        if k.startswith("params/"):
            lim = 2 ** -7 * np.abs(a).max() + 2 * lr * 2
        elif k.startswith("opt/m/"):
            lim = GRAD_RTOL * np.abs(a).max()
        else:
            continue
        assert np.abs(f32(got[k]) - a).max() <= lim, k


def test_grads_of_the_stacked_expert_leaves():
    """``stepfn._grads`` gives each layer's expert tensors their own autograd
    leaf and stacks the gradients once: their shapes and dtypes are the
    stacked parameters', the router's gradient is not zero and the router
    aux reaches the returned aux; the model cut to one layer (the card's
    training depth) trains too."""
    _, tcfg, _, tp = moe_models(ARCHS[0])
    _, tb = _batch(3)
    loss, aux, grads = stepfn._grads(tp, tb, tcfg, ModelKnobs())
    for k, g in zip(*flatten(grads)):
        p = dict(zip(*flatten(tp)))[k]
        assert g.shape == p.shape and g.dtype == p.dtype, k
    assert float(aux["aux"]) > 0 and torch.isfinite(loss)
    assert float(grads["layers"]["moe"]["router"].abs().max()) > 0
    # the same model cut to one layer trains too (the card's depth cut)
    one = dataclasses.replace(tcfg, n_layers=1)
    p1 = dict(tp, layers={k: ({kk: vv[:1] for kk, vv in v.items()})
                          for k, v in tp["layers"].items()})
    assert torch.isfinite(stepfn._grads(p1, tb, one, ModelKnobs())[0])
