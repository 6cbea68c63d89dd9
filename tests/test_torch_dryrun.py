"""PyTorch port: the dry run (``launch/dryrun.py``) and its counters
(``distributed/trace_analysis.py``) on the CPU.

The counters on known operations: live bytes and their peak, collective
bytes by kind (the JAX package's convention) and each group's link rate.
Then whole cells, traced on meta tensors under a fake process group: a
reduced cell on a fake 2x2 world (prefill, decode and training) whose
collective bytes equal a reckoning from the placement, and one full cell,
starcoder2-3b ``decode_32k`` at the production 16x16 world, whose
collective bytes and FLOPs equal a reckoning from the config.  A trace
launches no kernel, and the entry point writes one JSON a cell."""
import json
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES_BY_NAME, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import flatten
from repro_torch.distributed.trace_analysis import (NET_BW, NVLINK_BW,
                                                    CollectiveCounter,
                                                    LiveBytes, memory_stats)
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_meshspec
from repro_torch.models import lm
from repro_torch.ps.stepfn import StepKnobs, serve_param_specs

SMALL = get_config("starcoder2-3b").reduced(head_dim=64)  # a kernel build's hd


def test_live_bytes_count_each_storage_once_until_freed():
    with LiveBytes() as live:
        a = torch.empty((1024, 256), device="meta")          # 1 MiB
        b = a.view(256, 1024).t()                             # a view
        c = torch.empty((512,), dtype=torch.bfloat16, device="meta")
        assert live.live == (1 << 20) + 1024
        d = a + 1                                             # 1 MiB more
        del d
        assert live.live == (1 << 20) + 1024 and live.peak == (2 << 20) + 1024
        del a, b
        assert live.live == 1024
    stats = memory_stats(live, argument_bytes=1024)
    assert stats["temp_bytes"] == 2 << 20 and stats["fits"]
    del c


def test_collectives_counted_by_kind_and_link():
    """all-gather and all-reduce count result bytes, reduce-scatter result
    bytes x group; a group inside one 8-card node runs at NVLink's rate,
    one that spans nodes at the network port's."""
    with dryrun.fake_world(16):
        near, far = dist.new_group([0, 1]), dist.new_group([0, 8])
        x = torch.empty((1000,), dtype=torch.bfloat16, device="meta")
        with CollectiveCounter() as cc:
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x, group=near)
            dist.all_reduce(x, group=far)
            out = torch.empty((500,), dtype=torch.bfloat16, device="meta")
            dist.reduce_scatter(out, list(x.chunk(2)), group=near)
    got = cc.to_dict()
    assert got["all-gather"] == 4000 and got["all-reduce"] == 2000
    assert got["reduce-scatter"] == 2000 and got["total"] == 8000
    assert got["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "broadcast": 0}
    assert got["seconds"] == pytest.approx(6000 / NVLINK_BW + 2000 / NET_BW)


def _gather_bytes(shape, spec, sizes) -> int:
    """Result bytes of ``sharding.gather`` of a bf16 shard: one all-gather
    per sharded dim in order, each result larger by its shard count."""
    local = [n // sizes[e] if e else n for n, e in zip(shape, spec)]
    total = 0
    for dim, e in enumerate(spec):
        if e and sizes[e] > 1:
            local[dim] *= sizes[e]
            total += 2 * math.prod(local)
    return total


def _param_gathers(cfg, ms, knobs) -> int:
    sizes = dict(ms.shape)
    specs = serve_param_specs(cfg, ms, knobs)
    shapes = lm.param_shapes(cfg)
    return sum(_gather_bytes(s, specs_leaf, sizes) for s, specs_leaf in
               zip(flatten(shapes)[1], flatten(specs)[1]))


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_reduced_cell_on_a_fake_2x2_world(kind):
    """Reduced starcoder2-3b (hd 64), 8 sequences of 32 positions, on a
    fake 2x2 world: the step's collective bytes equal the reckoning —
    the parameters' pull (the default fsdp placement: over data and
    model), decode's per-layer cache gathers over model, and training's
    push (every whole bf16 gradient and the two f32 losses all-reduced
    over data)."""
    B, S = 8, 32
    shape = ShapeConfig("c", S, B, kind)
    before = dict(LAUNCHES)
    r = dryrun.run_cell("starcoder2-3b", shape, mesh=(2, 2), cfg=SMALL,
                        save=False)
    assert LAUNCHES == before                     # a trace launches nothing
    assert r["status"] == "ok" and r["n_devices"] == 4
    knobs = dryrun.default_knobs(SMALL, shape)[0]
    assert knobs.serve_params == "fsdp"
    with dryrun.fake_world(4):
        ms = make_meshspec(2, 2)
        want_gather = _param_gathers(SMALL, ms, knobs)
    want_reduce = 0
    if kind == "decode":     # k and v of each layer: (B/2, S, K, hd) bf16
        want_gather += (2 * SMALL.n_layers * (B // 2) * S * SMALL.n_kv_heads
                        * SMALL.hd * 2)
    if kind == "train":
        want_reduce = 2 * SMALL.n_params() + 2 * 4
    coll = r["collectives"]
    assert coll["all-gather"] == want_gather
    assert coll["all-reduce"] == want_reduce
    assert coll["reduce-scatter"] == coll["all-to-all"] == 0
    assert coll["seconds"] == pytest.approx(coll["total"] / NVLINK_BW)
    assert r["flops_counted_dev"] > 0 and r["memory"]["peak_estimate_bytes"] \
        >= r["memory"]["argument_bytes"] > 0


def test_full_decode_cell_at_the_production_mesh():
    """starcoder2-3b decode_32k at 16x16, the optimized knobs' tp_only
    placement (its 8.6 GB of weights shard to 0.54 GB over model): 128
    sequences over 16 data ranks, the 32,768-row cache over 16 model
    ranks.  Collective bytes: the parameters gathered over model, and
    each layer's k and v gathered whole ((8, 32768, 2, 128) bf16); FLOPs:
    every matrix product of 8 tokens (the parameters but the embedding)
    and the paged attention over 32,768 keys; it fits one card."""
    cfg = get_config("starcoder2-3b")
    r = dryrun.run_cell("starcoder2-3b", "decode_32k", save=False,
                        optimized=True)
    assert r["status"] == "ok" and r["memory"]["fits"]
    assert r["mesh"] == {"data": 16, "model": 16} and r["n_devices"] == 256
    knobs = StepKnobs(remat="none", serve_params="tp_only")
    assert r["knobs"]["serve_params"] == "tp_only"
    with dryrun.fake_world(256):
        from repro_torch.launch.mesh import production_meshspec
        params = _param_gathers(cfg, production_meshspec(live=True), knobs)
    cache = 2 * cfg.n_layers * 8 * 32768 * cfg.n_kv_heads * cfg.hd * 2
    assert r["collectives"]["all-gather"] == params + cache
    assert r["collectives"]["all-reduce"] == 0
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    matmul = cfg.n_params() - V * D - D * (2 * L + 1)     # embed and norms
    attn = 4 * 8 * cfg.n_heads * 32768 * cfg.hd * L
    assert r["flops_counted_dev"] == 2 * 8 * matmul + attn
    assert r["analytic"] == dryrun.cell_costs(
        cfg, SHAPES_BY_NAME["decode_32k"], dryrun.MeshDims(256, 16, 16),
        remat="none", serve_params="tp_only")
    assert set(r["knobs_not_applied"]) == {"scan_unroll", "q_chunk",
                                           "ssm_chunk", "attn_skip_masked",
                                           "seq_shard", "donate"}


def test_entry_point_writes_one_json_a_cell(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch A --shape S --set ...
    --out DIR``: one JSON, the JAX-only knobs listed as not applied."""
    dryrun.main(["--arch", "starcoder2-3b", "--shape", "decode_32k",
                 "--set", "serve_params=fsdp,q_chunk=256",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[ok] starcoder2-3b x decode_32k x 16x16" in out
    assert "0 failed" in out
    (f,) = tmp_path.glob("*.json")
    assert f.name == "starcoder2-3b__decode_32k__pod.json"
    r = json.loads(f.read_text())
    assert r["knobs"]["serve_params"] == "fsdp"
    assert r["knobs_not_applied"]["q_chunk"] == 256
    assert r["model_flops_global"] == 2.0 * r["n_active_params"] * 128
