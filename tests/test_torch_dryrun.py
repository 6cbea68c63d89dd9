"""PyTorch port: the dry run (``launch/dryrun.py``) and its counters
(``distributed/trace_analysis.py``) on the CPU.

The counters on known operations: live bytes and their peak, collective
bytes by kind (the JAX package's convention) and each group's link rate.
Then whole cells, traced on meta tensors under a fake process group: a
reduced cell on a fake 2x2 world (prefill, decode and training) whose
collective bytes equal a reckoning from the placement and the tensor-
parallel plan, and two full cells at the production 16x16 world,
starcoder2-3b and qwen2-72b ``decode_32k``, whose collective bytes (and
FLOPs) equal a reckoning from the config.  A trace
launches no kernel, and the entry point writes one JSON a cell."""
import dataclasses
import json

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES_BY_NAME, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.distributed.trace_analysis import (NET_BW, NVLINK_BW,
                                                    CollectiveCounter,
                                                    LiveBytes, memory_stats)
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import dryrun

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


def _tp_reckoning(cfg, kind: str, B: int, S: int) -> dict:
    """Collective bytes of a rank of the fake 2x2 world (fsdp placement)
    for reduced starcoder2-3b, whose plan on ``model`` 2 splits the query
    and kv heads, the MLP's columns and the vocabulary: every weight
    matrix keeps its model shard and is all-gathered over data at its
    use (the embedding table and lm_head too: the lookup and the logits
    are vocabulary-parallel), a layer's two row-parallel products are
    all-reduced in f32 (``from_model``), and

    - prefill: the lookup's all-reduce, the logits' last row all-gathered
      over the vocabulary, the cache's kv heads all-gathered over model;
    - decode: the same, and a layer's k and v gathered whole over the
      sequence (each rank then keeps its kv head) with the new rows of
      every head all-gathered over model;
    - train (remat full, one microbatch): each layer's pull twice (the
      forward and its recompute) and its from_model three times (the
      recompute stops at the last tensor the backward needs, before the
      MLP's all-reduce: checkpoint's early stop), lm_head's pull
      again in the backward (``keep_shards``), each pulled weight's
      gradient reduce-scattered over data (result bytes x 2), to_model's
      backward all-reduce (f32) of the cotangent after each norm that
      feeds a split block, the loss's three (B, S) f32 all-reduces (the rows'
      max, the sum of exponentials, the target's logit), and the push:
      the norms' scales (spec None: replicated over data) all-reduced
      with the two f32 losses."""
    L, D, V, F = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Bl, bf, f4 = B // 2, 2, 4
    # a layer's weights with the model shard kept, gathered over data
    layer = bf * (D * H * hd + 2 * D * K * hd + H * hd * D + 3 * D * F) // 2
    table = bf * V * D // 2                  # embed and lm_head alike
    out = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}
    act = Bl * S * D
    if kind in ("prefill", "decode"):
        q = S if kind == "prefill" else 1
        out["all-gather"] = (table + L * layer + table
                             + Bl * 1 * V * bf)          # logits' row
        out["all-reduce"] = f4 * Bl * q * D * (1 + 2 * L)
        if kind == "prefill":
            out["all-gather"] += 2 * L * Bl * S * K * hd * bf
        else:
            out["all-gather"] += 2 * L * (Bl * S * K * hd * bf
                                          + Bl * 1 * K * hd * bf)
            out["all-reduce"] = f4 * Bl * D * (1 + 2 * L)
        return out
    out["all-gather"] = table + 2 * L * layer + 2 * table
    out["reduce-scatter"] = table + L * layer + table
    out["all-reduce"] = (f4 * act * (1 + 3 * L) + 3 * f4 * Bl * S
                         + f4 * act * (1 + 2 * L)
                         + bf * D * (2 * L + 1) + 2 * f4)
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_reduced_cell_on_a_fake_2x2_world(kind):
    """Reduced starcoder2-3b (hd 64), 8 sequences of 32 positions, on a
    fake 2x2 world: the step's collective bytes equal the reckoning of
    the tensor-parallel step with the layer-by-layer pull
    (``_tp_reckoning``): no parameter all-gathered over ``model``, the
    push a reduce-scatter of each pulled gradient."""
    B, S = 8, 32
    shape = ShapeConfig("c", S, B, kind)
    before = dict(LAUNCHES)
    r = dryrun.run_cell("starcoder2-3b", shape, mesh=(2, 2), cfg=SMALL,
                        save=False)
    assert LAUNCHES == before                     # a trace launches nothing
    assert r["status"] == "ok" and r["n_devices"] == 4
    knobs = dryrun.default_knobs(SMALL, shape)[0]
    assert knobs.serve_params == "fsdp"
    want = _tp_reckoning(SMALL, kind, B, S)
    coll = r["collectives"]
    for k, v in want.items():
        assert coll[k] == v, (k, coll[k], v)
    assert coll["all-to-all"] == 0
    assert coll["seconds"] == pytest.approx(coll["total"] / NVLINK_BW)
    assert r["flops_counted_dev"] > 0 and r["memory"]["peak_estimate_bytes"] \
        >= r["memory"]["argument_bytes"] > 0


def test_full_decode_cell_at_the_production_mesh():
    """starcoder2-3b decode_32k at 16x16, the optimized knobs' tp_only
    placement (its 8.6 GB of weights shard to 0.54 GB over model): 128
    sequences over 16 data ranks, the 32,768-row cache over 16 model
    ranks.  Its 24 query heads do not divide 16 and a decode step has one
    row, so attention runs whole on every rank: only the attention's
    weights are gathered over model; the MLP and the vocabulary split.
    Collective bytes: those weights, each layer's k and v gathered whole
    ((8, 32768, 2, 128) bf16), the logits' row gathered over the
    vocabulary, the lookup's and each MLP's f32 all-reduce; FLOPs: the
    attention's products whole, the MLP's and the logits' 1/16, and the
    paged attention over 32,768 keys; it fits one card."""
    cfg = get_config("starcoder2-3b")
    r = dryrun.run_cell("starcoder2-3b", "decode_32k", save=False,
                        optimized=True)
    assert r["status"] == "ok" and r["memory"]["fits"]
    assert r["mesh"] == {"data": 16, "model": 16} and r["n_devices"] == 256
    assert r["knobs"]["serve_params"] == "tp_only"
    D, V, L, F = cfg.d_model, cfg.vocab_size, cfg.n_layers, cfg.d_ff
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn_w = 2 * D * H * hd + 2 * D * K * hd
    cache = 2 * L * 8 * 32768 * K * hd * 2
    assert r["collectives"]["all-gather"] == (L * attn_w * 2 + cache
                                              + 8 * V * 2)
    assert r["collectives"]["all-reduce"] == 4 * 8 * D * (1 + L)
    matmul = L * (attn_w + 3 * D * F // 16) + D * V // 16
    attn = 4 * 8 * H * 32768 * hd * L
    assert r["flops_counted_dev"] == 2 * 8 * matmul + attn
    assert r["analytic"] == dryrun.cell_costs(
        cfg, SHAPES_BY_NAME["decode_32k"], dryrun.MeshDims(256, 16, 16),
        remat="none", serve_params="tp_only")
    assert set(r["knobs_not_applied"]) == {"scan_unroll", "q_chunk",
                                           "ssm_chunk", "attn_skip_masked",
                                           "seq_shard", "donate"}


def test_qwen2_decode_fits_and_gathers_only_its_kv_weights():
    """qwen2-72b decode_32k at 16x16 under tp_only: 64 query heads split
    over model (4 a rank), its 8 kv heads do not, so each rank computes
    the one kv head its queries read: the only parameters gathered over
    model are wk, wv, bk and bv (whole, each layer); the MLP (d_ff 29,568
    = 16 x 1,848) and the vocabulary (152,064) split.  It fits a card."""
    cfg = get_config("qwen2-72b")
    knobs = dataclasses.replace(dryrun.default_knobs(
        cfg, SHAPES_BY_NAME["decode_32k"])[0], serve_params="tp_only")
    r = dryrun.run_cell("qwen2-72b", "decode_32k", save=False, knobs=knobs)
    assert r["status"] == "ok" and r["memory"]["fits"]
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    K, hd = cfg.n_kv_heads, cfg.hd
    kv_w = 2 * (D * K * hd + K * hd) * 2                   # wk wv bk bv
    cache = 2 * L * 8 * 32768 * K * hd * 2         # each layer whole
    rows = 2 * L * 8 * K * hd * 2 // 8 * 16        # new rows, 16 ranks
    assert r["collectives"]["all-gather"] == (L * kv_w + cache + rows
                                              + 8 * V * 2)
    assert r["collectives"]["reduce-scatter"] == 0


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
