"""PyTorch port on the card: online reconfiguration with every step a
captured CUDA graph — a staged commit adopts the steps captured on its
double buffer, a re-block there and back (A -> B -> A) recaptures against
the new tensors, a dtype relayout moves the rows exactly, an ssm shrink
and grow keep the state, a self-tuned serve completes — and after each the
decode step's replay equals its eager step bit for bit and the served
tokens are those of an engine that never reconfigured (tie-aware).  Every
test needs an NVIDIA GPU and skips without one; ``python3 chip_smoke.py``
runs the same checks at full width."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.reconfig import plan
from repro_torch.launch.serve import selftune_manager
from repro_torch.models import lm
from repro_torch.serving import (DEFAULT_SERVING_SETTING,
                                 SERVING_RELAYOUT_KNOBS, Request,
                                 ServingEngine, serve_loop,
                                 serving_knob_space)
from repro_torch.serving.workload import make_trace

pytestmark = pytest.mark.cuda

LOGIT_TOL = 4 / 64        # bf16 rounding of two reduced layers (|x| < 4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(dev, family):
    cfg = (get_config("starcoder2-3b").reduced(head_dim=64)
           if family == "dense" else get_config("falcon-mamba-7b").reduced())
    return cfg, lm.init_params(cfg, 0, device=dev)


def _engine(dev, cfg, params, **setting):
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          **setting), max_seq=64,
                        device=dev)
    eng.warm_start(max_prompt=24)
    return eng


def _requests(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               (int(rng.integers(5, 24)),))
                    .astype(np.int32), max_new=12) for i in range(n)]


def _serve(eng, reqs, hooks=None):
    """Tick until drained; ``hooks[tick](eng)`` runs after that tick."""
    for r in reqs:
        eng.submit(Request(rid=r.rid, prompt=r.prompt.copy(),
                           max_new=r.max_new))
    tick = 0
    while eng.has_work():
        eng.step()
        tick += 1
        if hooks and tick in hooks:
            hooks[tick](eng)
        assert tick < 400
    return {r.rid: r.tokens_out for r in eng.finished}


def _plan(eng, **new):
    return plan(eng.setting, {**eng.setting, **new},
                mesh_knobs=SERVING_RELAYOUT_KNOBS)


def _replay_equals_eager(eng):
    """The decode step of the live slots' context bucket, replayed and run
    eagerly from the same pool state: the live slots' logits and the pool
    bit for bit (all but a paged pool's trash block, where every idle slot
    writes its row at position 0 and the last writer is arbitrary); the
    pool is left as it was."""
    pool = eng.pool
    state = pool.kv if pool.kind == "paged" else pool.state
    live = 1 if pool.kind == "paged" else 0      # first compared block
    active = [i for i, r in enumerate(eng.slot_req) if r is not None]
    assert active
    entry = eng._decode_exec(eng._ctx_cols(int(eng.slot_pos[active].max())))
    assert hasattr(entry, "graph")
    dev = eng.device
    args = (eng.params, pool.decode_cache(),
            torch.as_tensor(eng.slot_tok[:, None], dtype=torch.long,
                            device=dev),
            torch.as_tensor(eng.slot_pos, dtype=torch.int32, device=dev))
    before = {k: v.clone() for k, v in state.items()}
    got = entry(*args)[0][active].clone()
    after = {k: v.clone() for k, v in state.items()}
    for k, v in state.items():
        v.copy_(before[k])
    want = entry.eager(*args)[0][active]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for k, v in state.items():
        assert torch.equal(after[k][:, live:], v[:, live:]), k
        v.copy_(before[k])
    return entry


def _same_tokens(params, cfg, reqs, got, ref):
    """Equal tokens, or at the first difference the served token within
    LOGIT_TOL of the best under one full prefill on the card."""
    for r in reqs:
        a, b = ref[r.rid], got[r.rid]
        assert len(b) == r.max_new
        for t, (x, y) in enumerate(zip(a, b)):
            if x == y:
                continue
            seq = torch.tensor([list(r.prompt) + b[:t]], device="cuda")
            hidden, _ = lm.forward(params, seq, cfg, mode="prefill")
            lg = lm.logits_fn(params, hidden[:, -1:], cfg)[0, 0].float()
            assert float(lg.max() - lg[y]) <= LOGIT_TOL, (r.rid, t)
            break


def test_staged_grow_adopts_the_staged_graphs(dev):
    cfg, params = _model(dev, "dense")
    reqs = _requests(cfg)
    ref = _serve(_engine(dev, cfg, params, max_batch=2, block_size=16,
                         cache_dtype="bf16"), reqs)
    eng = _engine(dev, cfg, params, max_batch=2, block_size=16,
                  cache_dtype="bf16")
    seen = {}

    def stage(e):
        e.begin_reconfig(_plan(e, max_batch=4))
        seen["todo"] = len(e._staged["todo"])
        seen["staged"] = e._staged

    def check(e):
        if e._staged is None and "event" not in seen:
            (ev,) = e.take_reconfig_events()
            seen["event"] = ev
            assert ev["staged"] and ev["bg_capture_failures"] == 0, ev
            assert e.pool.n_slots == 4
            e.pool.check_invariants()
            misses = e._steps.misses
            entry = _replay_equals_eager(e)
            assert e._steps.misses == misses        # no capture: adopted
            assert entry in seen["staged"]["graphs"].values()

    hooks = {3: stage}
    hooks.update({t: check for t in range(4, 60)})
    got = _serve(eng, reqs, hooks)
    assert "event" in seen and seen["todo"] == len(eng._ctx_buckets())
    _same_tokens(params, cfg, reqs, got, ref)


def test_reblock_there_and_back_recaptures(dev):
    """block_size 16 -> 8 -> 16 stop-the-world: the last geometry has the
    first one's step keys, but its tensors are new, so its steps are new
    captures bound to them."""
    cfg, params = _model(dev, "dense")
    reqs = _requests(cfg, seed=1)
    ref = _serve(_engine(dev, cfg, params, max_batch=4, block_size=16,
                         cache_dtype="bf16"), reqs)
    eng = _engine(dev, cfg, params, max_batch=4, block_size=16,
                  cache_dtype="bf16")
    entries = []

    def reblock(bs):
        def hook(e):
            entries.append(_replay_equals_eager(e))
            e.apply_plan(_plan(e, block_size=bs))
            e.pool.check_invariants()
            entries.append(_replay_equals_eager(e))
        return hook

    got = _serve(eng, reqs, {3: reblock(8), 5: reblock(16)})
    a0, b0, b1, a1 = entries
    assert a1 is not a0
    # bound to the live tensors (which may reuse the first pool's
    # addresses: only the drop keeps a stale step from replaying there)
    assert a1._bound[1] == [t.data_ptr()
                            for t in eng.pool.decode_cache().values()]
    _same_tokens(params, cfg, reqs, got, ref)


def test_dtype_relayout_moves_rows_exactly(dev):
    cfg, params = _model(dev, "dense")
    eng = _engine(dev, cfg, params, max_batch=4, block_size=16,
                  cache_dtype="bf16")
    rows = {}

    def logical(e):
        out = {}
        for s, r in enumerate(e.slot_req):
            if r is None:
                continue
            bt = torch.as_tensor(e.pool.tables[s], dtype=torch.long,
                                 device=dev)
            w = int(e.slot_pos[s])
            out[r.rid] = {k: v[:, bt].flatten(1, 2)[:, :w].clone()
                          for k, v in e.pool.kv.items()}
        return out

    def switch(e):
        rows["before"] = logical(e)
        e.apply_plan(_plan(e, cache_dtype="f32"))
        rows["after"] = logical(e)
        _replay_equals_eager(e)

    _serve(eng, _requests(cfg, seed=2), {4: switch})
    assert rows["before"] and eng.pool.kv["k"].dtype == torch.float32
    for rid, kv in rows["before"].items():
        for k, v in kv.items():
            assert torch.equal(rows["after"][rid][k], v.to(torch.float32))


def test_ssm_shrink_after_drain_and_grow(dev):
    cfg, params = _model(dev, "ssm")
    reqs = _requests(cfg, n=8, seed=3)
    ref = _serve(_engine(dev, cfg, params, max_batch=4, cache_dtype="bf16"),
                 reqs)
    eng = _engine(dev, cfg, params, max_batch=4, cache_dtype="bf16")
    slots = []

    def shrink(e):
        e.apply_plan(_plan(e, max_batch=2))
        slots.append(e.n_slots)                  # held while 4 are live
        _replay_equals_eager(e)

    def grow(e):
        slots.append(e.n_slots)                  # shrunk once drained
        e.apply_plan(_plan(e, max_batch=4))
        _replay_equals_eager(e)

    got = _serve(eng, reqs, {2: shrink, 20: grow})
    assert slots == [4, 2] and eng.n_slots == 4
    _same_tokens(params, cfg, reqs, got, ref)


def test_selftuned_serve_completes_on_the_card(dev):
    cfg, params = _model(dev, "dense")
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4)
    eng = ServingEngine(params, cfg, setting, max_seq=64, device=dev)
    space = serving_knob_space(family=cfg.family)
    eng.warm_start(space, max_prompt=24)
    trace = make_trace("poisson", 60.0, 1.5, vocab=cfg.vocab_size, seed=0,
                       prompt_lens=(4, 24), max_news=(4, 16))
    tuner = selftune_manager(eng, space, setting, window=8, init_settings=3)
    stats = serve_loop(eng, trace, tuner)
    assert stats["completed"] == len(trace)
    assert stats["reconfig_count"] >= 1
    assert all(r["bg_capture_failures"] == 0 for r in stats["reconfigs"])
    eng.pool.check_invariants()
