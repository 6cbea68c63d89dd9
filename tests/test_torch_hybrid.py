"""PyTorch port, hybrid family (zamba2): ``mamba2_block`` in its four modes,
the slab decode of the shared attention block, the hybrid LM (prefill and
decode, parameters carried across by ``convert``) and the serving engine
(fixed, speculative, relayout mid-serve) against the JAX package on the
same parameters and inputs, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import serve_loop as j_serve_loop
from repro_torch.configs.registry import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.serving import (DEFAULT_SERVING_SETTING, Request,
                                 ServingEngine, serve_loop)
from repro_torch.serving.pool import SSMStatePool

from _torch_port import f32, hybrid_models, tie_aware_check

T = torch.from_numpy
# mamba2_block against the JAX block on the same bf16 inputs: every op of
# the block rounds as XLA's does (the silu and softplus included), so the
# outputs are mostly bit for bit; the f32 sums of the recurrence and of
# the gated RMSNorm's mean run in another order, and where that moves an
# f32 value across a bf16 rounding boundary an output is one bf16 step
# off (12 of 3,072 values in one seeded case, nowhere in the others):
# bound one bf16 step, 2^-7 of |out| (atol 2^-10 for values near 0).  The
# f32 state h: <= 9e-8 measured at |h| < 1, bound 1e-6.  The conv window
# is bf16 data moved, not computed: equal.
OUT_RTOL, OUT_ATOL = 2 ** -7, 2 ** -10
H_TOL = 1e-6
# The hybrid LM's logits (|logit| < 4) and caches.  Each layer of the
# model is bit for bit the JAX layer when both run eagerly, but XLA and
# PyTorch block some bf16 matrix products differently, so a product can
# round one bf16 step apart; after the shared block the residual stream
# reaches |x| ~ 12, where a bf16 step is 1/16, and the next layers carry
# it.  Over seeds 0-2, 2 and 3 layers and prompts of 5-40 tokens the
# logits differed by up to 0.074 and the shared KV by up to 0.09 (prefill)
# and 0.086 (decode): bounds 12/64 and 1/8.  The recurrent state h, f32
# fed by those activations: 0.016 measured, bound 1/16.
LM_LOGIT_TOL = 12 / 64
LM_KV_TOL = 1 / 8
LM_H_TOL = 1 / 16
MAX_SEQ = 48


@pytest.fixture(scope="module")
def models():
    return hybrid_models(0)


def _state(rng, B, cfg):
    conv = rng.standard_normal((B, cfg.d_inner, cfg.ssm_conv - 1))
    h = rng.standard_normal((B, cfg.n_ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state)) * 0.3
    return conv.astype(np.float32), h.astype(np.float32)


@pytest.mark.parametrize("S,valid_len,from_state", [
    (24, None, False),         # prefill
    (24, 17, False),           # prefill of a right-padded prompt
    (1, None, True),           # decode
    (3, None, True)])          # speculative verify
def test_mamba2_block_matches_jax(models, S, valid_len, from_state):
    """Outputs within one bf16 step, the new conv window equal and h
    within f32 summation order; from a state, the port writes it in
    place."""
    cfg, tcfg, jp, tp = models
    rng = np.random.default_rng(S + (valid_len or 0))
    lp = jax.tree_util.tree_map(lambda t: t[1], jp["layers"]["ssm"])
    # every per-head parameter away from its init, so each term counts
    lp = dict(lp, **{k: jnp.asarray(rng.standard_normal(lp[k].shape) * 0.5,
                                    jnp.bfloat16)
                     for k in ("A_log2", "dt_bias2", "gnorm", "Dskip2")})
    tlp = {k: T(f32(v)).to(torch.bfloat16) for k, v in lp.items()}
    x = jnp.asarray(rng.standard_normal((2, S, cfg.d_model)), jnp.bfloat16)
    js = ts = None
    if from_state:
        conv, h = _state(rng, 2, cfg)
        js = {"conv": jnp.asarray(conv, jnp.bfloat16), "h": jnp.asarray(h)}
        ts = {"conv": T(f32(js["conv"])).to(torch.bfloat16), "h": T(h)}
    jo, jn = jmamba.mamba2_block(x, lp, cfg, state=js, valid_len=valid_len)
    vl = None if valid_len is None else torch.tensor([valid_len])
    to, tn = tmamba.mamba2_block(T(f32(x)).to(torch.bfloat16), tlp, tcfg,
                                 state=ts, valid_len=vl)
    np.testing.assert_allclose(f32(to), f32(jo), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    np.testing.assert_array_equal(f32(tn["conv"]), f32(jn["conv"]))
    np.testing.assert_allclose(f32(tn["h"]), f32(jn["h"]), atol=H_TOL,
                               rtol=0)
    assert tuple(tn["h"].shape) == (2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state)
    if from_state:
        assert tn is ts                       # written in place


def test_init_mamba_state_mamba2_shapes(models):
    cfg, tcfg, _, _ = models
    st = tmamba.init_mamba_state(tcfg, 3, dtype=torch.bfloat16)
    js = jmamba.init_mamba_state(cfg, 3)
    assert {k: tuple(v.shape) for k, v in st.items()} == {
        k: v.shape for k, v in js.items()}
    assert st["h"].dtype == torch.float32 and not st["h"].any()


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_params_carry_the_hybrid_tree(models):
    """``param_shapes`` is the JAX tree (stacked mamba2 layers, the
    unstacked shared block); ``convert`` carries every leaf exactly; the
    port's own init fixes the same leaves (A_log2, dt_bias2, gnorm zero,
    Dskip2 one)."""
    cfg, tcfg, jp, tp = models
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    assert ("shared", "attn", "wq") in tl and ("layers", "ssm",
                                              "BC_proj") in tl
    for k, a in jl.items():
        np.testing.assert_array_equal(f32(tl[k]), a.astype(np.float32))
    shapes = dict(_leaves(tlm.param_shapes(tcfg)))
    jshapes = {k: v.shape for k, v in _leaves(jlm.param_shapes(cfg))}
    assert {k: tuple(v) for k, v in shapes.items()} == jshapes
    own = dict(_leaves(tlm.init_params(tcfg, 0, device="cpu")))
    for name in ("A_log2", "dt_bias2", "gnorm"):
        assert not own[("layers", "ssm", name)].any(), name
    assert bool((own[("layers", "ssm", "Dskip2")] == 1).all())
    assert tlm.n_shared_apps(tcfg) == 2


def _jax_cache(cfg, jc, B, P):
    """The JAX dense decode cache of a batch-B prefill of P tokens."""
    cache = jlm.init_cache(cfg, B, MAX_SEQ)
    cache["conv"] = jc["conv"].astype(jnp.bfloat16)
    cache["h"] = jc["h"]
    for k in ("shared_k", "shared_v"):
        cache[k] = cache[k].at[:, :, :P].set(jc[k])
    return cache


@pytest.mark.parametrize("n_layers", [2, 3])
def test_hybrid_lm_prefill_and_decode_match_jax(n_layers):
    """Prefill logits and caches, then decode steps of S = 1 and S = 3
    from the JAX cache (the port writing conv, h and the slab in place):
    logits and every cache leaf within the bounds above."""
    cfg, tcfg, jp, tp = hybrid_models(0, n_layers)
    rng = np.random.default_rng(n_layers)
    B, P = 2, 20
    tok = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tok)}, cfg)
    tl, tc = tlm.prefill(tp, T(tok).long(), tcfg)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LM_LOGIT_TOL, rtol=0)
    assert tc.keys() == jc.keys()
    for k in ("shared_k", "shared_v", "conv"):
        assert tuple(tc[k].shape) == jc[k].shape
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), atol=LM_KV_TOL,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(f32(tc["h"]), f32(jc["h"]), atol=LM_H_TOL,
                               rtol=0)
    jcache = _jax_cache(cfg, jc, B, P)
    pos = np.array([P, P - 3], np.int32)
    for S in (1, 3):
        tcache = {k: T(np.array(f32(v))).to(torch.float32 if k == "h"
                                            else torch.bfloat16)
                  for k, v in jcache.items()}
        nt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        jl2, jc2 = jlm.decode_step(jp, jcache, jnp.asarray(nt),
                                   jnp.asarray(pos), cfg)
        tl2, tc2 = tlm.decode_step(tp, tcache, T(nt).long(), T(pos), tcfg)
        assert tc2 is tcache                  # written in place
        np.testing.assert_allclose(f32(tl2), f32(jl2), atol=LM_LOGIT_TOL,
                                   rtol=0)
        for k in ("shared_k", "shared_v", "conv"):
            np.testing.assert_allclose(f32(tc2[k]), f32(jc2[k]),
                                       atol=LM_KV_TOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(f32(tc2["h"]), f32(jc2["h"]),
                                   atol=LM_H_TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_slab_decode_is_dense_decode_attention(dtype):
    """The slab viewed as blocks through the identity tables, on the paged
    path's plain version, is the dense ``decode_attention`` bit for bit,
    and both agree with the JAX ``decode_attention``; the block view is a
    view (no copy) at max_seq 48 (blocks of 16) and 40 (blocks of 8)."""
    rng = np.random.default_rng(5)
    for T_, S in ((48, 1), (48, 3), (40, 2)):
        B, K, hd, H = 3, 2, 16, 4
        q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
        ks, vs = (rng.standard_normal((B, T_, K, hd)).astype(np.float32)
                  for _ in range(2))
        pos = np.array([0, T_ // 2, T_ - S], np.int32)
        tq = T(q).to(torch.bfloat16)
        tk, tv = T(ks).to(dtype), T(vs).to(dtype)
        tables = tattn.identity_tables(B, T_, "cpu")
        assert tables.shape == (B, T_ // tattn.slab_block(T_))
        out = tattn.slab_decode_attention(tq, tk, tv, tables, pos=T(pos))
        ref = tattn.decode_attention(tq, tk, tv, pos=T(pos))
        assert torch.equal(out, ref)
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        jout = jattn.decode_attention(jnp.asarray(q, jnp.bfloat16),
                                      jnp.asarray(ks, jd),
                                      jnp.asarray(vs, jd), pos=pos)
        # one bf16 step of the output (|out| < 2): rounding of p and of
        # the f32 sums in another order
        np.testing.assert_allclose(f32(out), f32(jout), atol=2 ** -6,
                                   rtol=0)
    assert tattn.slab_block(48) == 16 and tattn.slab_block(40) == 8


def test_decode_writes_clamp_at_max_seq(models):
    """A query past the slab (position max_seq) writes its KV row at
    max_seq - 1, as the JAX dense decode clamps it, and attends over the
    whole slab: logits and slabs against JAX."""
    cfg, tcfg, jp, tp = models
    rng = np.random.default_rng(9)
    B = 2
    jcache = jlm.init_cache(cfg, B, MAX_SEQ)
    jcache = {k: jnp.asarray(rng.standard_normal(v.shape) * 0.5, v.dtype)
              for k, v in jcache.items()}
    tcache = {k: T(np.array(f32(v))).to(torch.float32 if k == "h"
                                        else torch.bfloat16)
              for k, v in jcache.items()}
    pos = np.array([MAX_SEQ - 1, MAX_SEQ], np.int32)
    nt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc = jlm.decode_step(jp, jcache, jnp.asarray(nt), jnp.asarray(pos),
                             cfg)
    tl, tc = tlm.decode_step(tp, tcache, T(nt).long(), T(pos), tcfg)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LM_LOGIT_TOL, rtol=0)
    for k in ("shared_k", "shared_v"):
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), atol=LM_KV_TOL,
                                   rtol=0, err_msg=k)
        # only row max_seq - 1 of each slot changed
        changed = (f32(tc[k]) != f32(jcache[k])).any(axis=(0, 3, 4))
        assert not changed[:, :MAX_SEQ - 1].any() and changed[:, -1].all()


def test_pool_writes_prefill_rows_and_snapshots_the_recurrent_state(models):
    """The hybrid pool: a prefill lands its first P slab rows and whole
    conv/h; the speculative snapshot copies conv and h only (the slab and
    its tables are the pool's own); a relayout moves every leaf's slot
    row along axis 1, the slab cast to the new dtype."""
    _, tcfg, _, _ = models
    pool = SSMStatePool(tcfg, dict(DEFAULT_SERVING_SETTING, max_batch=3,
                                   cache_dtype="bf16"), MAX_SEQ, "cpu")
    n_apps, K, hd = tlm.n_shared_apps(tcfg), tcfg.n_kv_heads, tcfg.hd
    assert tuple(pool.state["shared_k"].shape) == (n_apps, 3, MAX_SEQ, K, hd)
    assert pool.state["shared_k"].dtype == torch.bfloat16
    assert pool.state["h"].dtype == torch.float32
    slot, _ = pool.try_admit(np.arange(5), 4)
    slot, _ = pool.try_admit(np.arange(5), 4)
    pc = {k: torch.full((v.shape[0], 1) + tuple(v.shape[2:]), 0.5)
          for k, v in pool.state.items()}
    pc["shared_k"] = torch.full((n_apps, 1, 16, K, hd), 0.75)
    pc["shared_v"] = torch.full((n_apps, 1, 16, K, hd), 0.75)
    pool.write_prefill(slot, pc, 11)
    sk = pool.state["shared_k"]
    assert bool((sk[:, slot, :11] == 0.75).all()) and not sk[:, slot,
                                                             11:].any()
    assert bool((pool.state["h"][:, slot] == 0.5).all())
    saved = pool.save_state()
    assert set(saved) == {"conv", "h", "shared_k", "shared_v", "slab_tables"}
    assert saved["shared_k"] is pool.state["shared_k"]
    assert saved["h"] is not pool.state["h"]
    assert torch.equal(saved["h"], pool.state["h"])
    cache = pool.decode_cache()
    assert torch.equal(cache["slab_tables"],
                       tattn.identity_tables(3, MAX_SEQ, "cpu"))
    before = {k: v.clone() for k, v in pool.state.items()}
    mapping = pool.relayout(dict(pool.setting, cache_dtype="f32",
                                 max_batch=4), {0: 5, slot: 11})
    assert mapping == {0: 0, slot: 1} and pool.n_slots == 4
    for k, v in pool.state.items():
        assert v.shape[1] == 4 and (v.dtype == torch.float32)
        for old, new in mapping.items():
            assert torch.equal(v[:, new], before[k][:, old].float()), k
    assert pool.slab_tables.shape == (4, MAX_SEQ // 16)


def _requests(vocab, cls=Request, seed=3):
    """Prompts of 1-30 tokens (shorter than the conv window, within one
    prefill bucket and across two), more requests than slots."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, vocab, (p,)).astype(np.int32),
                max_new=m, arrival_s=0.0)
            for i, (p, m) in enumerate([(6, 9), (11, 5), (1, 7), (30, 8),
                                        (17, 4)])]


def _drive(eng, reqs, hook=None, max_ticks=500):
    for r in reqs:
        eng.submit(r)
    t = 0
    while eng.has_work() and t < max_ticks:
        eng.step()
        t += 1
        if hook is not None:
            hook(t, eng)
    assert not eng.has_work()
    return {r.rid: list(r.tokens_out) for r in eng.finished}


@pytest.mark.parametrize("cache_dtype", ["bf16", "f32"])
def test_hybrid_engine_tokens_match_jax_engine(models, cache_dtype):
    cfg, tcfg, jp, tp = models
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=3,
                   cache_dtype=cache_dtype)
    je = JEngine(jp, cfg, setting, max_seq=MAX_SEQ)
    te = ServingEngine(tp, tcfg, setting, max_seq=MAX_SEQ, device="cpu")
    assert te.pool.kind == je.pool.kind == "ssm"
    j_stats = j_serve_loop(je, _requests(cfg.vocab_size, JRequest))
    t_stats = serve_loop(te, _requests(cfg.vocab_size))
    assert t_stats["completed"] == j_stats["completed"] == 5
    jout = {r.rid: r.tokens_out for r in je.finished}
    tout = {r.rid: r.tokens_out for r in te.finished}
    for r in _requests(cfg.vocab_size):
        assert len(tout[r.rid]) == r.max_new
        tie_aware_check(jp, cfg, r.prompt, jout[r.rid], tout[r.rid])
    assert te.pool.n_active == 0


def _spec_run(tp, tcfg, switches, cls=ServingEngine, params=None,
              cfg=None):
    """spec_k = 2 with the truncated drafter (2 of 3 layers, one shared
    application), ``switches[tick]`` applied by ``reconfigure`` after that
    tick with live requests."""
    spec = dict(DEFAULT_SERVING_SETTING, max_batch=3, cache_dtype="bf16",
                spec_k=2.0, drafter="truncated")

    def hook(t, eng):
        if t in switches:
            eng.reconfigure(dict(spec, **switches[t]))

    if cls is ServingEngine:
        eng = cls(tp, tcfg, spec, max_seq=MAX_SEQ, device="cpu")
        return _drive(eng, _requests(tcfg.vocab_size), hook), eng
    eng = cls(params, cfg, spec, max_seq=MAX_SEQ)
    eng.async_precompile = False
    return _drive(eng, _requests(cfg.vocab_size, JRequest), hook), eng


def test_hybrid_spec_and_relayout_serve_the_plain_greedy_tokens(models):
    """Speculation (snapshot of conv and h, replay; the slab's rejected
    rows masked and rewritten) and a relayout mid-serve (max_batch 3 -> 2
    with live requests): exactly the port's own plain greedy tokens."""
    _, tcfg, _, tp = models
    plain = _drive(ServingEngine(tp, tcfg, dict(DEFAULT_SERVING_SETTING,
                                                max_batch=3,
                                                cache_dtype="bf16"),
                                 max_seq=MAX_SEQ, device="cpu"),
                   _requests(tcfg.vocab_size))
    tout, te = _spec_run(tp, tcfg, {3: {"max_batch": 2}})
    assert te.spec_ticks > 0 and te.spec_drafted > 0
    assert te.pool.n_slots == 2
    assert tout == plain
    assert not any(te.pool.slot_live)


def test_hybrid_engine_spec_and_relayout_match_jax_engine(models):
    """The same speculative serve with max_batch 3 -> 2 and then
    cache_dtype bf16 -> f32 mid-serve, in both packages: the port's tokens
    are the JAX engine's, tie-aware (an f32 slab keeps P in f32 for P.V,
    where a bf16 one rounds it, so the switch moves logits by rounding)."""
    cfg, tcfg, jp, tp = models
    switches = {3: {"max_batch": 2}, 6: {"max_batch": 2,
                                        "cache_dtype": "f32"}}
    tout, te = _spec_run(tp, tcfg, switches)
    assert te.pool.n_slots == 2 and te.setting["cache_dtype"] == "f32"
    assert te.pool.state["shared_k"].dtype == torch.float32
    jout, _ = _spec_run(None, None, switches, JEngine, jp, cfg)
    for r in _requests(cfg.vocab_size):
        assert len(tout[r.rid]) == r.max_new
        tie_aware_check(jp, cfg, r.prompt, jout[r.rid], tout[r.rid])


def test_hybrid_launcher_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "zamba2-1.2b", "--reduced", "--device",
                       "cpu", "--rate", "40", "--duration", "0.2", "--gen",
                       "4", "--scenario", "mixed_lengths"])
    out = capsys.readouterr().out
    assert "family=hybrid" in out and out.rstrip().endswith("OK")


def test_truncated_drafter_has_the_shared_block():
    """The full model's truncated drafter (19 of 38 layers) applies the
    shared block 4 times (after layers 0, 6, 12, 18)."""
    import dataclasses
    cfg = get_config("zamba2-1.2b")
    assert tlm.n_shared_apps(dataclasses.replace(cfg, n_layers=19)) == 4
    assert tlm.n_shared_apps(cfg) == 7
