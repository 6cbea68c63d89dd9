#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device  — the card's name and power limit; TF32 off for matmuls/cuDNN.
2. build   — every CUDA kernel from ``src/repro_torch/kernels/csrc``, one
             nvcc per source, in parallel.
3. kernels — each kernel against its plain PyTorch version at the serving
             path's shapes (H=24, K=2, hd=128): paged attention over bf16
             and f32 pools, bs 8/16, S=1 and S=32/128, tail positions and
             trash-block rows; flash attention at ragged prefill lengths;
             int8 quantize/dequantize bit-exact.  Then each kernel's time
             (CUDA events around device work, L2 flushed) beside its plain
             version's, a library call's where one computes the same
             function, and its bound at this run's shapes.
4. parity  — full-width starcoder2-3b decode step: paged kernel against
             the plain dense gather path on one f32 pool, one layer deep
             and all 30 layers (against a measured rounding-noise floor).
5. serve   — full-width starcoder2-3b (30 layers, random weights from a
             seeded generator) through ``ServingEngine`` and
             ``serve_loop``: a prefix-sharing bf16-pool arm on the
             shared_prefix trace plus one whole-template prompt (prefill,
             suffix prefill, copy-on-write and decode) and a short int8
             arm; every request completes, the pool leaks no
             block, every kernel's launch counter rose during the serve,
             and the served tokens agree with a full-sequence prefill.
6. profile — one decode step of the serve arm under torch.profiler: the
             card's busy share and the kernels that take the time.

Prints one JSON ``kernels`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # dense bf16 tensor cores
F32_FLOPS = 67e12                  # f32 outside the tensor cores
H, K, HD = 24, 2, 128              # starcoder2-3b attention geometry
BF16_TOL = 2e-2                    # one bf16 step at |x| < 4, plus slack
F32_TOL = 2e-5                     # summation order only


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, iters: int = 20) -> float:
    """Median device time of one call, with the 50 MB L2 flushed before
    every launch (the serving path finds its inputs cold).  A sleep kernel
    holds the stream while the host enqueues the flush, the events and the
    call, so the events time the device work and not the wrapper's host
    code."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)           # ~1 ms of GPU clock cycles
        flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def max_err(torch, out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def check_close(torch, what, out, ref, tol):
    err = max_err(torch, out, ref)
    bad = (out.float() - ref.float()).abs() > tol + tol * ref.float().abs()
    if not torch.isfinite(out.float()).all() or bool(bad.any()):
        fail(f"{what}: max abs err {err} beyond atol=rtol={tol}")
    return err


def bound(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ------------------------------------------------------------ phase 3
def check_kernels(torch):
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.kernels.quant import (dequantize, dequantize_ref,
                                           quantize, quantize_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}

    def randn(shape, dtype=f32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # -- paged attention: decode ticks and suffix prefills of the serve
    def paged_case(B, S, bs, q_dt, pool_dt, pos, mb=64, trash_cols=0):
        nb = B * mb + 1
        q = randn((B, S, H, HD), q_dt)
        kp, vp = randn((nb, bs, K, HD), pool_dt), randn((nb, bs, K, HD),
                                                        pool_dt)
        bt = torch.randperm(nb - 1, generator=g, device=dev)[:B * mb]
        bt = (bt.reshape(B, mb) + 1).to(torch.int32)
        if trash_cols:                   # stale entries: the trash block
            bt[:, -trash_cols:] = 0
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        return q, kp, vp, bt, pos

    def ctx_cols(pos, S, bs, mb=64):     # the engine's context bucket
        need = (max(pos) + S - 1) // bs + 1
        gcol = -(-mb // 6)
        return next(c for c in sorted({min(t * gcol, mb)
                                       for t in range(1, 7)}) if c >= need)

    err = 0.0
    for B, S, bs, q_dt, pool_dt, pos, trash in [
            (8, 1, 16, bf16, bf16, [300, 317, 333, 351, 288, 299, 345, 372],
             8),
            (8, 1, 8, bf16, f32, [0, 7, 8, 15, 16, 255, 256, 500], 2),
            (8, 1, 16, f32, f32, [1, 15, 16, 31, 32, 63, 64, 1000], 0),
            (1, 32, 16, bf16, bf16, [256], 16),
            (1, 128, 8, bf16, f32, [256], 0),
            (1, 96, 16, f32, bf16, [240], 4)]:
        q, kp, vp, bt, p = paged_case(B, S, bs, q_dt, pool_dt, pos,
                                      trash_cols=trash)
        for cols in (0, ctx_cols(pos, S, bs)):
            w = cols or bt.shape[1]
            out = paged_attention(q, kp, vp, bt, p, ctx_cols=cols)
            torch.cuda.synchronize()
            ref = paged_attention_ref(q, kp, vp, bt[:, :w], p)
            err = max(err, check_close(
                torch, f"paged_attention B={B} S={S} bs={bs} q={q_dt} "
                f"pool={pool_dt} cols={cols}", out, ref,
                F32_TOL if q_dt == f32 else BF16_TOL))
    # timing at a decode tick of the bf16-pool serve arm: 8 requests with
    # ~300-370 tokens of context, the context bucket of the engine
    pos = [300, 317, 333, 351, 288, 299, 345, 372]
    q, kp, vp, bt, p = paged_case(8, 1, 16, bf16, bf16, pos)
    cols = ctx_cols(pos, 1, 16)
    ms = timed_ms(torch, lambda: paged_attention(q, kp, vp, bt, p,
                                                 ctx_cols=cols))
    plain = timed_ms(torch, lambda: paged_attention_ref(q, kp, vp,
                                                        bt[:, :cols], p))
    ctx = sum(x + 1 for x in pos)                  # keys the queries see
    nbytes = ctx * K * HD * 2 * 2 + 2 * q.numel() * 2 + bt[:, :cols].numel() * 4
    rows["paged_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:90",
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
        shape=f"decode B=8 S=1 H={H} K={K} hd={HD} bs=16 bf16 pool, "
              f"ctx {min(pos) + 1}-{max(pos) + 1}, ctx_cols={cols}",
        bound=bound(nbytes, 4 * ctx * H * HD, BF16_FLOPS))
    # and at a suffix prefill (S = 64 bucket over a 256-token shared prefix)
    q, kp, vp, bt, p = paged_case(1, 64, 16, bf16, bf16, [256])
    cols = ctx_cols([256], 64, 16)
    rows["paged_attention"]["suffix_ms"] = timed_ms(
        torch, lambda: paged_attention(q, kp, vp, bt, p, ctx_cols=cols))

    # -- flash attention: prefill buckets (ragged lengths included)
    err = 0.0
    for S, kc in [(320, 128), (320, 256), (37, 128), (200, 256), (1000, 128)]:
        q = randn((1, S, H, HD), bf16)
        k, v = randn((1, S, K, HD), bf16), randn((1, S, K, HD), bf16)
        out = flash_attention(q, k, v, block_k=kc)
        torch.cuda.synchronize()
        err = max(err, check_close(torch, f"flash_attention S={S} kc={kc}",
                                   out, attention_ref(q, k, v), BF16_TOL))
    S = 320                                        # a ~300-token prompt
    q = randn((1, S, H, HD), bf16)
    k, v = randn((1, S, K, HD), bf16), randn((1, S, K, HD), bf16)
    ms = timed_ms(torch, lambda: flash_attention(q, k, v, block_k=128))
    plain = timed_ms(torch, lambda: attention_ref(q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = timed_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                       enable_gqa=True))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + 2 * S * 4
    rows["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:79",
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
        shape=f"prefill B=1 S={S} H={H} K={K} hd={HD} bf16, k_chunk=128",
        bound=bound(nbytes, 4 * H * HD * S * S / 2, BF16_FLOPS))

    # -- int8 quantize / dequantize: the engine's KV rows, bit-exact
    n = 30 * 320 * K * HD                          # L x bucket x (K*hd)
    x = randn((n,)) * 3
    for u in (torch.full_like(x, 0.5), torch.rand(n, generator=g, device=dev)):
        for scale in (1.0, 1e-4, 1e4):
            qq, ss = quantize(x * scale, u, block=K * HD)
            rq, rs = quantize_ref(x * scale, u, block=K * HD)
            if not (torch.equal(qq, rq) and torch.equal(ss, rs)):
                fail(f"quantize not bit-exact (scale {scale}): "
                     f"{int((qq != rq).sum())} values and "
                     f"{int((ss != rs).sum())} scales differ")
            if not torch.equal(dequantize(qq, ss, block=K * HD),
                               dequantize_ref(rq, rs, block=K * HD)):
                fail(f"dequantize not bit-exact (scale {scale})")
    u = torch.full_like(x, 0.5)
    qq, ss = quantize(x, u, block=K * HD)
    for name, fn, ref, nbytes, ops in [
            ("quantize", lambda: quantize(x, u, block=K * HD),
             lambda: quantize_ref(x, u, block=K * HD),
             n * 4 * 2 + n + ss.numel() * 4, 6 * n),
            ("dequantize", lambda: dequantize(qq, ss, block=K * HD),
             lambda: dequantize_ref(qq, ss, block=K * HD),
             n + ss.numel() * 4 + n * 4, n)]:
        rows[name] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/quant.cu",
            replaces=("src/repro/kernels/quant/kernel.py:34"
                      if name == "quantize"
                      else "src/repro/kernels/quant/kernel.py:52"),
            max_abs_err=0.0, ms=timed_ms(torch, fn),
            plain_ms=timed_ms(torch, ref), library_ms=None,
            shape=f"n={n} (30 layers x 320 rows x 256), block=256, f32",
            bound=bound(nbytes, ops, F32_FLOPS))
    for name, r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = (f" suffix_prefill_ms={r['suffix_ms']:.4f}"
                 if "suffix_ms" in r else "")
        print(f"kernel {name}: max_abs_err={r['max_abs_err']:.3g} "
              f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={lib} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]}){extra} [{r['shape']}]", flush=True)
    return rows


# ------------------------------------------------------------ phase 4
def decode_parity(torch, cfg, params):
    """Paged decode (kernel) against the plain gather path on one f32 pool
    at full width.  One layer deep, the logits agree within 2e-2
    (tests/test_paged_attention.py's bound).  Through 30 random-init
    layers, bf16 rounding noise grows: the run measures that floor
    itself — the gather path against itself with its KV scaled by
    (1 + 2^-22), two f32 ulps — and the kernel may differ from the gather
    path by at most 2e-2 + 1.5 x that floor, with every argmax mismatch a
    near-tie of the gather logits within the same bound."""
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    B, bs, max_seq = 8, 16, 1024
    mb = max_seq // bs
    shape = lm.init_paged_cache_shapes(cfg, B * mb + 1, bs)["k"]
    kv = {k: torch.randn(shape, generator=g, device=dev) for k in "kv"}
    tables = (torch.arange(B * mb, device=dev).reshape(B, mb) + 1
              ).to(torch.int32)
    pos = torch.tensor([3, 17, 300, 511, 64, 129, 900, 40], device=dev,
                       dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=dev)

    def run(depth, impl, cols=0, eps=0.0):
        c = dataclasses.replace(cfg, n_layers=depth)
        p = dict(params, layers=_slice(params["layers"], depth))
        cache = {k: v[:depth] * (1 + eps) for k, v in kv.items()}
        cache["block_tables"] = tables
        logits, _ = lm.decode_step(p, cache, tok, pos, c,
                                   ModelKnobs(attn_impl=impl, attn_ctx=cols))
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all() or logits.shape != (
                B, 1, cfg.vocab_size):
            fail(f"decode logits: shape {tuple(logits.shape)} or not finite")
        return logits.float()

    ref1 = run(1, "gather")
    err1 = check_close(torch, "1-layer decode paged vs gather",
                       run(1, "paged"), ref1, BF16_TOL)
    ref = run(cfg.n_layers, "gather")
    noise = max_err(torch, run(cfg.n_layers, "gather", eps=2.0 ** -22), ref)
    tol = BF16_TOL + 1.5 * noise
    for cols in (0, 58):                      # full table; a context bucket
        out = run(cfg.n_layers, "paged", cols)
        err = max_err(torch, out, ref)
        miss = out.argmax(-1) != ref.argmax(-1)
        gap = (ref.max(-1).values
               - ref.gather(-1, out.argmax(-1, keepdim=True))[..., 0])
        if err > tol or float((gap * miss).max()) > tol:
            fail(f"full-width decode paged(ctx_cols={cols}) vs gather: max "
                 f"abs err {err}, argmax gap {float(gap.max())} beyond {tol}")
        print(f"parity: decode paged(ctx_cols={cols}) vs gather at full "
              f"width: 1 layer max_abs_err={err1:.4g} (bound {BF16_TOL}); "
              f"{cfg.n_layers} layers max_abs_err={err:.4g} against a rounding-noise "
              f"floor of {noise:.4g} (bound {tol:.4g}), argmax agreement "
              f"{1 - float(miss.float().mean()):.3f} (mismatches are "
              f"near-ties), |logit| max {float(ref.abs().max()):.3f}",
              flush=True)
    return tol


def _slice(tree, depth):
    return {k: (_slice(v, depth) if isinstance(v, dict) else v[:depth])
            for k, v in tree.items()}


# ------------------------------------------------------------ phase 5
def serve_arm(torch, cfg, params, setting, trace, label):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import Request, ServingEngine, serve_loop
    dev = torch.device("cuda")
    eng = ServingEngine(params, cfg, setting, max_seq=1024, device=dev)
    eng.warm_start(max_prompt=max(len(r.prompt) for r in trace))
    # one unrelated request first: cuBLAS and allocator warm-up stays out
    # of the measured run (its blocks stay cached and never match)
    warm = Request(rid=-1, prompt=torch.randint(
        0, cfg.vocab_size, (40,), generator=torch.Generator().manual_seed(9)
    ).numpy().astype("int32"), max_new=2)
    serve_loop(eng, [warm])
    reset_launches()
    stats = serve_loop(eng, trace)
    launches = dict(LAUNCHES)
    done = [r for r in eng.finished if r.rid >= 0]
    if stats["completed"] != len(trace) or len(done) != len(trace):
        fail(f"{label}: {stats['completed']}/{len(trace)} requests completed")
    short = [r.rid for r in done if len(r.tokens_out) != r.max_new]
    if short:
        fail(f"{label}: requests {short} stopped before max_new tokens")
    eng.pool.check_invariants()
    snap = eng.pool.snapshot()
    if eng.pool.n_active or snap["blocks_held"] != snap["prefix_cached_blocks"]:
        fail(f"{label}: blocks leaked after the drain: {snap}")
    print(f"serve[{label}]: {stats['completed']}/{len(trace)} requests, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.3f}s = "
          f"{stats['tokens_per_s']:.1f} tok/s, ttft p50 "
          f"{stats['p50_ttft_s']:.4f}s, decode {stats['decode_tok_per_s']:.1f}"
          f" tok/s, prefill {stats['prefill_tokens_computed']}/"
          f"{stats['prefill_tokens_total']} tokens computed, "
          f"{stats['cow_copies']} COW copies, launches {launches}",
          flush=True)
    return eng, done, stats, launches


def check_tokens(torch, cfg, params, reqs, tol):
    """The served tokens against one full-sequence prefill (flash kernel,
    no paged cache) over prompt + generated tokens: at every generated
    position the served token's logit is within ``tol`` (phase 4's bound
    for two paths that differ only in rounding) of the row's maximum — a
    tie-aware greedy check of the paged decode path against an
    independent path."""
    from repro_torch.models import lm
    worst, exact, total = 0.0, 0, 0
    for r in reqs:
        seq = list(r.prompt) + r.tokens_out[:-1]
        toks = torch.tensor([seq], dtype=torch.long, device="cuda")
        hidden, _ = lm.forward(params, toks, cfg, mode="prefill")
        P = len(r.prompt)
        lg = lm.logits_fn(params, hidden[:, P - 1:], cfg)[0].float()
        if not torch.isfinite(lg).all():
            fail("prefill logits not finite")
        got = torch.tensor(r.tokens_out, device="cuda")
        gap = lg.max(-1).values - lg.gather(1, got[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        exact += int((gap == 0).sum())
        total += len(r.tokens_out)
    if worst > tol:
        fail(f"served tokens disagree with the prefill path: logit gap "
             f"{worst} > {tol}")
    print(f"tokens: {exact}/{total} served tokens are the prefill path's "
          f"argmax, worst logit gap {worst:.4g} (tolerance {tol})",
          flush=True)


# ------------------------------------------------------------ phase 6
def profile_decode(torch, cfg, params):
    """Where a decode tick's time goes: the serve arm's decode step (8
    slots, ~290-370 tokens of context, bf16 pool, bs 16, ctx_cols 33)
    timed without the profiler, then under ``torch.profiler``: the card's
    kernel time per step against the wall time, and the kernels that take
    it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    B, bs, mb = 8, 16, 64
    shape = lm.init_paged_cache_shapes(cfg, B * mb + 1, bs)["k"]
    cache = {k: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
             for k in "kv"}
    cache["block_tables"] = (torch.arange(B * mb, device=dev).reshape(B, mb)
                             + 1).to(torch.int32)
    pos = torch.tensor([300, 317, 333, 351, 288, 299, 345, 372], device=dev,
                       dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device=dev)
    knobs = ModelKnobs(attn_impl="paged", attn_ctx=33)

    def step():
        lm.decode_step(params, cache, tok, pos, cfg, knobs)
        torch.cuda.synchronize()

    for _ in range(3):
        step()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
    kernels = [e for e in prof.key_averages()
               if "CUDA" in str(e.device_type)]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in kernels) / n / 1e3
    print(f"profile: decode step (8 slots, 30 layers) {wall:.3f} ms wall, "
          f"{busy:.3f} ms of kernels on the card = busy share "
          f"{busy / wall:.3f}; {sum(e.count for e in kernels) // n} kernel "
          f"launches a step", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"profile:   {dev_us(e) / n / 1e3:8.4f} ms/step "
              f"{e.count // n:5d} x  {e.key[:90]}", flush=True)


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import LAUNCHES, build_all
    from repro_torch.models import lm
    from repro_torch.serving import DEFAULT_SERVING_SETTING, Request
    from repro_torch.serving.workload import make_trace

    t_all = time.perf_counter()
    card = card_line()
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build_all()
    print(f"build: {len(logs)} libraries in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for name, log in logs.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", log))
        print(f"build[{name}]: {len(regs)} kernels for sm_90a, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)} a thread, "
              f"{spill} bytes of spill stores+loads", flush=True)

    rows = check_kernels(torch)

    cfg = get_config("starcoder2-3b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {cfg.name} full width, {n_params / 1e9:.3f} B params "
          f"bf16, init {time.perf_counter() - t0:.1f}s", flush=True)
    tol = decode_parity(torch, cfg, params)

    share = dict(DEFAULT_SERVING_SETTING, max_batch=8, block_size=16,
                 cache_dtype="bf16", prefix_share=True)
    trace = make_trace("shared_prefix", 400.0, 0.04, vocab=cfg.vocab_size,
                       seed=4, prefix_len=256, tail_lens=(16, 96),
                       max_news=(32, 32))
    # one prompt that is a whole template, arriving with the first: its
    # last token re-lands in a shared block, so admission copies it (COW)
    cow = Request(rid=len(trace), prompt=trace[0].prompt[:256].copy(),
                  max_new=32, arrival_s=trace[0].arrival_s)
    trace.append(cow)
    _, done, stats, la = serve_arm(torch, cfg, params, share, trace,
                                   "prefix_share bf16")
    if stats["cow_copies"] == 0:
        fail("the whole-template request made no copy-on-write copy")
    check_tokens(torch, cfg, params,
                 [done[0], done[1]] + [r for r in done if r is cow], tol)
    int8 = dict(share, quant="int8")
    trace8 = make_trace("shared_prefix", 400.0, 0.015, vocab=cfg.vocab_size,
                        seed=100, prefix_len=192, tail_lens=(8, 48),
                        max_news=(8, 8))
    _, done8, _, lb = serve_arm(torch, cfg, params, int8, trace8, "int8")
    profile_decode(torch, cfg, params)
    launches = {k: la[k] + lb[k] for k in LAUNCHES}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"the serve path never launched {missing}: {launches}")
    print(f"serve: {stats['tokens_per_s']:.1f} tok/s, ttft p50 "
          f"{stats['p50_ttft_s']:.4f}s on {card}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)

    line = {"kernels": [
        {"name": name, "route": r["route"], "source": r["source"],
         "replaces": r["replaces"], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
        for name, r in rows.items()]}
    print(json.dumps(line), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f}s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


if __name__ == "__main__":
    main()
