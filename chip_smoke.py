#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device  — the card's name and power limit; TF32 off for matmuls/cuDNN.
2. build   — every CUDA kernel from ``src/repro_torch/kernels/csrc``, one
             nvcc per source, in parallel.
3. kernels — each kernel against its plain PyTorch version at the serving
             paths' shapes: paged attention over bf16 and f32 pools (H=24,
             K=2, hd=128), bs 8/16, S=1 and S=5-128, tail positions,
             trash-block rows, contexts up to 1,000 over many KV splits
             (some wholly in the future), each case twice (the split
             counters return to zero); flash attention at ragged prefill
             lengths x k_chunk 128/256, hd 64, causal=False and two
             requests at different positions;
             int8 quantize/dequantize bit-exact for f32 and bf16 x, random
             and one-value (stride-0) u, f32 and bf16 out, every registry
             block (32-3072) and a ragged one, views at an odd offset (the
             scalar kernels) and n = 0; the selective scan (D=8192,
             N=16, and N=4, 8, 32) at prefill lengths 1-512 with and
             without h0, f32 and bf16 x/dt, Bm/Cm contiguous f32 or bf16
             views of an x_proj output, and at decode (B=8, S=1 and S=5
             from h0, written in place).  Then each kernel's time (CUDA
             events around device work, L2 flushed) beside its plain
             version's, a library call's where one computes the same
             function, and its bound at this run's shapes: paged at a
             decode tick and a suffix prefill, flash at S=320 and S=1024
             beside SDPA, the scan at a decode tick and at the 16, 96, 256
             and 512-token prefill buckets, quantize and dequantize at the
             table's shape (f32) and the engine's (bf16 x, one-value u, bf16
             out), dequantize beside torch.mul.
4. parity  — full-width starcoder2-3b decode step: paged kernel against
             the plain dense gather path on one f32 pool, one layer deep
             and all 30 layers (against a measured rounding-noise floor).
5. serve   — full-width starcoder2-3b (30 layers, random weights from a
             seeded generator) through ``ServingEngine`` and
             ``serve_loop``, every step a captured CUDA graph (warm-start
             prints the captures' time and memory): a prefix-sharing
             bf16-pool arm on the shared_prefix trace plus one
             whole-template prompt (prefill, suffix prefill,
             copy-on-write and decode) and a short int8 arm, whose
             engine's _quant_exec(320) round trip is then held bit for
             bit to the plain path on the CPU and timed; every request
             completes, the pool leaks no block, and the served tokens
             agree with a full-sequence prefill.
6. graphs  — on the bf16 arm's pool, filled with random state: the step
             of every decode context bucket, the 320-token prefill at two
             last_idx, the 96-token suffix prefill and the int8 arm's
             _quant_exec(320), each replayed and then run eagerly on a
             copy of the same pool, bit for bit; then one decode step
             (8 slots, 289-373 tokens of context) eager beside its graph:
             wall time, CUDA-event time, the card's busy share under
             torch.profiler, kernels and host launch calls a step.
   spec    — the bf16 arm again with spec_k=3 and the n-gram drafter: the
             S = 4 verify step launches paged attention, drafts are
             accepted, and the tokens are the spec_k=0 arm's (a request
             that differs is held to the prefill path, tie-aware); every
             dense kernel's launch counter rose during the serves.
7. ssm     — the dense model is freed; full-width falcon-mamba-7b (64
             mamba1 layers, d_inner 8192, N 16): token-by-token decode
             from the stored state against one prefill of the sequence
             (one layer deep, and all 64 against a measured rounding-noise
             floor); a serve of the mixed_lengths trace (8 slots, bf16
             conv state) in which the scan kernel must launch in prefill
             and in decode, every request completes, no slot stays live
             and the served tokens agree with a full-sequence prefill;
             phase 6's graph checks and profile on its pool; a serve with
             spec_k=2 and the truncated drafter, in which the scan runs in
             the drafter, the S = 3 verify and the rollback's replay from
             the snapshot, with the spec_k=0 arm's tokens; the snapshot's
             copy timed.
8. reconfig — online reconfiguration on the card, every step a captured
             graph.  starcoder2-3b (before it is freed): forced switches
             with live requests — a staged grow max_batch 4 -> 8
             (begin_reconfig: the target's decode steps captured against
             the double buffer between ticks, held blocks copied in
             batches, the commit adopting both; a twin engine takes the
             same switch stop-the-world), a re-block block_size 16 -> 8 ->
             16 (apply_plan; the returning geometry's step is a new capture
             bound to the new tensors) and, on a second wave, cache_dtype
             bf16 -> f32 (every relocated row is its old value in f32, bit
             for bit); after each the pool's invariants and the decode
             graph's replay equal to its eager step, and the served tokens
             those of an engine that never reconfigured (tie-aware).  Then
             one self-tuned serve (the --selftune path: warm_start(space),
             TuningManager + ServingObjective, serve_loop over a Poisson
             trace): every request completes, every kind of switch the
             tuner proposed commits, no staged capture fails; its tok/s,
             TTFT, commits, final setting, step cache and graph memory.
             falcon-mamba-7b (after phase 7): max_batch 8 -> 4 with 8 live
             (held, shrunk after the drain) and back, held the same way.

Prints one JSON ``kernels`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
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
DENSE_KERNELS = ("paged_attention", "flash_attention", "quantize",
                 "dequantize")
SFU_PER_SM_CLOCK = 16              # exponentials per SM per clock (MUFU)
N_SMS = 132
H, K, HD = 24, 2, 128              # starcoder2-3b attention geometry
BF16_TOL = 2e-2                    # one bf16 step at |x| < 4, plus slack
F32_TOL = 2e-5                     # summation order only
# K * hd of every registry configuration, the reduced ones' 32 and 64, and
# a ragged block (a multiple of 4 f32 but not of 8 bf16)
QUANT_BLOCKS = (32, 64, 256, 512, 1024, 1280, 2048, 3072, 36)
SCAN_TOL = 1e-4                    # f32 rounding of the exponential (the
                                   # kernel's ex2.approx, the plain version's
                                   # exp), the state update and the <h, C>
                                   # sum over <= 512 steps


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sm_clock_ghz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) / 1e3


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
    def paged_case(B, S, bs, q_dt, pool_dt, pos, trash_cols=0):
        mb = 1024 // bs                  # the serve's max_seq
        nb = B * mb + 1
        q = randn((B, S, H, HD), q_dt)
        kp, vp = randn((nb, bs, K, HD), pool_dt), randn((nb, bs, K, HD),
                                                        pool_dt)
        bt = torch.randperm(nb - 1, generator=g, device=dev)[:B * mb]
        bt = (bt.reshape(B, mb) + 1).to(torch.int32)
        if trash_cols == "extent":       # every column past the request's
            for b, p in enumerate(pos):  # extent is stale: the trash block
                bt[b, (p + S - 1) // bs + 1:] = 0
        elif trash_cols:                 # stale entries: the trash block
            bt[:, -trash_cols:] = 0
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        return q, kp, vp, bt, pos

    def ctx_cols(pos, S, bs):            # the engine's context bucket
        mb = 1024 // bs
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
            (1, 96, 16, f32, bf16, [240], 4),
            # long contexts over many splits, some wholly in the future of
            # a request, every column past a request's extent stale
            (8, 1, 8, bf16, bf16, [999, 0, 5, 130, 257, 511, 640, 1000],
             "extent"),
            (8, 1, 16, bf16, f32, [1000, 3, 500, 77, 998, 16, 15, 700],
             "extent"),
            (4, 1, 8, f32, bf16, [999, 0, 420, 800], "extent"),
            (4, 1, 16, f32, f32, [1000, 31, 32, 640], "extent"),
            (2, 7, 8, f32, f32, [990, 100], "extent"),
            (2, 5, 16, bf16, bf16, [900, 12], "extent")]:
        q, kp, vp, bt, p = paged_case(B, S, bs, q_dt, pool_dt, pos,
                                      trash_cols=trash)
        for cols in (0, ctx_cols(pos, S, bs)):
            w = cols or bt.shape[1]
            for _ in range(2):           # the split counters return to 0
                out = paged_attention(q, kp, vp, bt, p, ctx_cols=cols)
                torch.cuda.synchronize()
                ref = paged_attention_ref(q, kp, vp, bt[:, :w], p)
                err = max(err, check_close(
                    torch, f"paged_attention B={B} S={S} bs={bs} q={q_dt} "
                    f"pool={pool_dt} pos={pos} cols={cols}", out, ref,
                    F32_TOL if q_dt == f32 else BF16_TOL))

    def paged_bound(q, pos, S, cols, bt):
        """Each key a request's last query sees, K and V read once; q read
        and out written once; the visible table read once.  Operations:
        q.k and p.v for every (query row, visible key) pair."""
        seen = sum(p + S for p in pos)               # keys read
        pairs = sum(p + j + 1 for p in pos for j in range(S))
        nbytes = (seen * K * HD * 2 * 2 + 2 * q.numel() * 2
                  + bt[:, :cols].numel() * 4)
        return bound(nbytes, 4 * pairs * H * HD, BF16_FLOPS)

    # timing at a decode tick of the bf16-pool serve arm: 8 requests with
    # ~300-370 tokens of context, the context bucket of the engine
    pos = [300, 317, 333, 351, 288, 299, 345, 372]
    q, kp, vp, bt, p = paged_case(8, 1, 16, bf16, bf16, pos)
    cols = ctx_cols(pos, 1, 16)
    ms = timed_ms(torch, lambda: paged_attention(q, kp, vp, bt, p,
                                                 ctx_cols=cols))
    plain = timed_ms(torch, lambda: paged_attention_ref(q, kp, vp,
                                                        bt[:, :cols], p))
    rows["paged_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:90",
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
        shape=f"decode B=8 S=1 H={H} K={K} hd={HD} bs=16 bf16 pool, "
              f"ctx {min(pos) + 1}-{max(pos) + 1}, ctx_cols={cols}",
        bound=paged_bound(q, pos, 1, cols, bt))
    # and at a suffix prefill (S = 64 bucket over a 256-token shared prefix)
    q, kp, vp, bt, p = paged_case(1, 64, 16, bf16, bf16, [256])
    cols = ctx_cols([256], 64, 16)
    sb = paged_bound(q, [256], 64, cols, bt)
    rows["paged_attention"]["extra"] = (
        f" suffix_prefill(S=64 over 256)_ms="
        f"{timed_ms(torch, lambda: paged_attention(q, kp, vp, bt, p, ctx_cols=cols)):.4f}"
        f" suffix_bound_ms={sb[0]:.4f} ({sb[1]})")

    # -- flash attention: prefill buckets (ragged lengths included), hd 64,
    #    not causal, and two requests at different positions
    err = 0.0
    for S, kc in [(S, kc) for S in (37, 200, 320, 1000) for kc in (128, 256)]:
        q = randn((1, S, H, HD), bf16)
        k, v = randn((1, S, K, HD), bf16), randn((1, S, K, HD), bf16)
        out = flash_attention(q, k, v, block_k=kc)
        torch.cuda.synchronize()
        err = max(err, check_close(torch, f"flash_attention S={S} kc={kc}",
                                   out, attention_ref(q, k, v), BF16_TOL))
    for B, Sq, Skv, h, hd, causal, shift in [
            (1, 200, 200, H, 64, True, 0), (1, 320, 320, H, HD, False, 0),
            (1, 100, 333, 8, 64, False, 0), (2, 300, 300, H, HD, True, 70),
            (2, 64, 1000, H, 64, True, 500)]:
        q = randn((B, Sq, h, hd), bf16)
        k, v = randn((B, Skv, K, hd), bf16), randn((B, Skv, K, hd), bf16)
        qp = torch.arange(Sq, device=dev) + (Skv - Sq)
        qp = torch.stack([qp - shift * b for b in range(B)]).clamp_min(0)
        kp = torch.arange(Skv, device=dev).expand(B, Skv)
        out = flash_attention(q, k, v, qp, kp, causal=causal)
        torch.cuda.synchronize()
        err = max(err, check_close(
            torch, f"flash_attention B={B} Sq={Sq} Skv={Skv} H={h} hd={hd} "
            f"causal={causal} shift={shift}", out,
            attention_ref(q, k, v, qp, kp, causal=causal), BF16_TOL))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_t = {}
    for S in (320, 1024):                # a ~300-token prompt; max_seq
        q = randn((1, S, H, HD), bf16)
        k, v = randn((1, S, K, HD), bf16), randn((1, S, K, HD), bf16)
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        ms = timed_ms(torch, lambda: flash_attention(q, k, v, pos, pos,
                                                     block_k=128))
        plain = timed_ms(torch, lambda: attention_ref(q, k, v, pos, pos))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = timed_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                           enable_gqa=True))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + 2 * S * 4
        flash_t[S] = (ms, plain, lib, bound(
            nbytes, 4 * H * HD * S * (S + 1) / 2, BF16_FLOPS))
    ms, plain, lib, b = flash_t[320]
    ms2, plain2, lib2, b2 = flash_t[1024]
    rows["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:79",
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
        shape=f"prefill B=1 S=320 H={H} K={K} hd={HD} bf16, k_chunk=128",
        bound=b, extra=f" S=1024: kernel_ms={ms2:.4f} plain_ms={plain2:.4f} "
                       f"library_ms={lib2:.4f} bound_ms={b2[0]:.4f} ({b2[1]})")

    # -- int8 quantize / dequantize, bit-exact in every form they take: x
    #    f32 or bf16, u random or one value expanded, out f32 or bf16, every
    #    registry block, a ragged one, views at an odd offset, n = 0
    def at_offset(t, offset):
        v = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)[offset:]
        return v.copy_(t)

    cases = 0
    for block in QUANT_BLOCKS:
        m = 37 * block
        for x_dt in (f32, bf16):
            xq = (randn((m,)) * 3).to(x_dt)
            for one_u in (False, True):
                u = (torch.full((1,), 0.5, device=dev).expand(m) if one_u
                     else torch.rand(m, generator=g, device=dev))
                rq, rs = quantize_ref(xq, u, block=block)
                for off in (0, 1):
                    qq, ss = quantize(at_offset(xq, off),
                                      u if one_u else at_offset(u, off),
                                      block=block)
                    what = (f"block={block} x={x_dt} u="
                            f"{'one value' if one_u else 'random'} "
                            f"offset={off}")
                    if not (torch.equal(qq, rq) and torch.equal(ss, rs)):
                        fail(f"quantize not bit-exact ({what})")
                    for out_dt in (f32, bf16):
                        if not torch.equal(
                                dequantize(at_offset(qq, off), ss,
                                           block=block, out_dtype=out_dt),
                                dequantize_ref(rq, rs, block=block,
                                               out_dtype=out_dt)):
                            fail(f"dequantize not bit-exact ({what}, "
                                 f"out={out_dt})")
                    cases += 1
    e = torch.zeros(0, device=dev)
    if quantize(e, e)[0].numel() or dequantize(*quantize(e, e)).numel():
        fail("quantize/dequantize of n = 0 returned values")
    # the table's shape: the engine's KV rows of a 320-token admission
    # (30 layers x 320 rows x K*hd = 256), f32 x and u, at three magnitudes
    n = 30 * 320 * K * HD
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
    print(f"quant: {cases + 6} cases bit-exact (blocks {QUANT_BLOCKS}, f32/"
          f"bf16 x, random/one-value u, f32/bf16 out, odd offsets; n = 0)",
          flush=True)
    u = torch.full_like(x, 0.5)
    qq, ss = quantize(x, u, block=K * HD)
    nb = ss.numel()

    def lib_dq():                        # one PyTorch call: int8 x f32 -> f32
        return torch.mul(qq.view(nb, K * HD), ss.view(nb, 1))

    if not torch.equal(lib_dq().reshape(-1), dequantize_ref(qq, ss,
                                                           block=K * HD)):
        fail("torch.mul(q, scales) is not dequantize's function")
    # the engine's shape: bf16 rows, u of one value, bf16 out
    xe = x.to(bf16)
    ue = torch.full((1,), 0.5, device=dev).expand(n)
    qe, se = quantize(xe, ue, block=K * HD)
    eng_q = timed_ms(torch, lambda: quantize(xe, ue, block=K * HD))
    eng_dq = timed_ms(torch, lambda: dequantize(qe, se, block=K * HD,
                                                out_dtype=bf16))
    eng_qb = bound(n * 2 + 4 + n + nb * 4, 6 * n, F32_FLOPS)
    eng_dqb = bound(n + nb * 4 + n * 2, n, F32_FLOPS)
    for name, fn, ref, lib, nbytes, ops, eng in [
            ("quantize", lambda: quantize(x, u, block=K * HD),
             lambda: quantize_ref(x, u, block=K * HD), None,
             n * 4 * 2 + n + nb * 4, 6 * n, (eng_q, eng_qb)),
            ("dequantize", lambda: dequantize(qq, ss, block=K * HD),
             lambda: dequantize_ref(qq, ss, block=K * HD), lib_dq,
             n + nb * 4 + n * 4, n, (eng_dq, eng_dqb))]:
        rows[name] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/quant.cu",
            replaces=("src/repro/kernels/quant/kernel.py:34"
                      if name == "quantize"
                      else "src/repro/kernels/quant/kernel.py:52"),
            max_abs_err=0.0, ms=timed_ms(torch, fn),
            plain_ms=timed_ms(torch, ref),
            library_ms=None if lib is None else timed_ms(torch, lib),
            shape=f"n={n} (30 layers x 320 rows x 256), block=256, f32 x"
                  + (" and u" if name == "quantize" else ", f32 out"),
            bound=bound(nbytes, ops, F32_FLOPS),
            extra=f" engine_shape(bf16 x, one-value u, bf16 out)_ms="
                  f"{eng[0]:.4f} engine_bound_ms={eng[1][0]:.6f} "
                  f"({eng[1][1]})")
    for name, r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = r.get("extra", "")
        print(f"kernel {name}: max_abs_err={r['max_abs_err']:.3g} "
              f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={lib} bound_ms={r['bound'][0]:.4f} "
              f"({r['bound'][1]}){extra} [{r['shape']}]", flush=True)
    return rows


def check_scan(torch):
    """The selective scan against its plain version at falcon-mamba-7b's
    width (D = 8192, N = 16), and at N = 4, 8 and 32; with x, dt, Bm and
    Cm in f32 and bf16, Bm and Cm contiguous or as bf16 views of an x_proj
    output (the model's form); from zeros and from h0 written in place.
    Then timed at the serve's shapes on the model's inputs (x and dt bf16,
    Bm and Cm bf16 views, A = -(1..16)): a decode tick (B = 8, S = 1, h0
    updated in place, the kernels line's row) and prefills of the 16, 96,
    256 and 512-token buckets (B = 1, no h0), each beside its bound."""
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    D, R = 8192, 256                     # d_inner, dt_rank

    def A_of(N):
        return -torch.arange(1, N + 1, dtype=f32, device=dev).expand(
            D, N).contiguous()

    def case(B, S, xdt, dtdt, h0, N=16, views=False):
        x = torch.randn((B, S, D), generator=g, device=dev).to(xdt)
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, D), generator=g, device=dev)).to(dtdt)
        if views:                        # as mamba1_block hands them over
            proj = torch.randn((B, S, R + 2 * N), generator=g,
                               device=dev).to(bf16)
            _, Bm, Cm = proj.split([R, N, N], dim=-1)
        else:
            Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev)
                      for _ in range(2))
        h = (torch.randn((B, D, N), generator=g, device=dev) if h0
             else None)
        return x, dt, Bm, Cm, A_of(N), h

    err = 0.0
    cases = [(1, S, xdt, xdt, h0) for S in (1, 16, 37, 256, 512)
             for h0 in (False, True) for xdt in (f32, bf16)]
    cases += [(1, 256, bf16, f32, False), (8, 1, bf16, f32, True),
              (8, 1, f32, f32, True), (8, 5, bf16, f32, True)]
    cases = [c + (16, False) for c in cases]
    cases += [(B, S, bf16, bf16, h0, 16, True) for B, S, h0 in [
        (8, 1, True), (8, 5, True), (1, 16, False), (1, 96, False),
        (1, 256, False), (1, 512, False), (2, 37, True)]]
    cases += [(B, S, bf16, bf16, h0, N, views) for N in (4, 8, 32)
              for B, S, h0, views in [(8, 1, True, True), (2, 37, True, True),
                                      (1, 96, False, True),
                                      (1, 96, False, False)]]
    for B, S, xdt, dtdt, h0, N, views in cases:
        x, dt, Bm, Cm, A_, h = case(B, S, xdt, dtdt, h0, N, views)
        ry, rh = selective_scan_ref(x, dt, Bm, Cm, A_, h)
        hs = None if h is None else h.clone()
        y, hl = selective_scan(x, dt, Bm, Cm, A_, hs, h_out=hs)
        torch.cuda.synchronize()
        what = (f"selective_scan B={B} S={S} N={N} x={xdt} dt={dtdt} "
                f"B/C={'bf16 views' if views else Bm.dtype} "
                f"h0={'yes' if h0 else 'no'}")
        if hs is not None and hl.data_ptr() != hs.data_ptr():
            fail(f"{what}: h_out was not written in place")
        err = max(err, check_close(torch, what + " y", y, ry, SCAN_TOL),
                  check_close(torch, what + " h", hl, rh, SCAN_TOL))

    clock = sm_clock_ghz()

    def scan_bound(x, dt, Bm, Cm, A_, h):
        """Each input read once (Bm and Cm: the N values of each row the
        scan reads), y and h_last written once; operations: the B S D N
        exponentials on the SFU, the f32 FMAs beside them."""
        B, S, _ = x.shape
        N = A_.shape[1]
        n = B * S * D
        nbytes = (x.numel() * x.element_size() + dt.numel() * dt.element_size()
                  + 2 * B * S * N * Bm.element_size() + A_.numel() * 4
                  + n * 4 + B * D * N * 4 * (2 if h is not None else 1))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_exp = n * N / (SFU_PER_SM_CLOCK * N_SMS * clock * 1e9) * 1e3
        t_fma = (6 * n * N + n) / F32_FLOPS * 1e3
        t_ops = max(t_exp, t_fma)
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations")), t_bytes, t_exp, t_fma

    timed = {}
    for label, B, S, h0 in [("decode", 8, 1, True)] + [
            ("prefill", 1, S, False) for S in (16, 96, 256, 512)]:
        x, dt, Bm, Cm, A_, h = case(B, S, bf16, bf16, h0, views=True)
        ms = timed_ms(torch, lambda: selective_scan(x, dt, Bm, Cm, A_, h,
                                                    h_out=h))
        plain = timed_ms(torch, lambda: selective_scan_ref(x, dt, Bm, Cm,
                                                           A_, h))
        b, tb, te, tf = scan_bound(x, dt, Bm, Cm, A_, h)
        timed[label, S] = (ms, plain, b)
        print(f"kernel selective_scan[{label} B={B} S={S}]: "
              f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms="
              f"{b[0]:.4f} ({b[1]}; bytes {tb:.4f}, exponentials {te:.4f} "
              f"at {clock:.3f} GHz x {N_SMS} SMs x {SFU_PER_SM_CLOCK}/clock,"
              f" f32 FMAs {tf:.4f})", flush=True)
    ms, plain, b = timed["decode", 1]
    pre = "; ".join(f"S={S} {timed['prefill', S][0]:.4f} ms (plain "
                    f"{timed['prefill', S][1]:.4f}, bound "
                    f"{timed['prefill', S][2][0]:.4f} "
                    f"{timed['prefill', S][2][1]})" for S in (16, 96, 256, 512))
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan/kernel.py:58",
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None, bound=b,
        shape=f"decode B=8 S=1 D={D} N=16, x/dt bf16, Bm/Cm bf16 views, h0 "
              f"in place; prefill B=1: {pre}")


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
class LaunchSpans:
    """A tracer for the engine that counts the kernel launches made inside
    each span name (``serve.prefill``, ``serve.decode``, ...)."""

    def __init__(self, launches: dict):
        self.launches = launches
        self.by_span: dict = {}

    @contextlib.contextmanager
    def span(self, name, **_):
        before = dict(self.launches)
        try:
            yield
        finally:
            d = self.by_span.setdefault(name, dict.fromkeys(before, 0))
            for k, n in self.launches.items():
                d[k] += n - before[k]


def serve_arm(torch, cfg, params, setting, trace, label, tracer=None):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import Request, ServingEngine, serve_loop
    dev = torch.device("cuda")
    eng = ServingEngine(params, cfg, setting, max_seq=1024, device=dev,
                        tracer=tracer)
    eng.warm_start(max_prompt=max(len(r.prompt) for r in trace))
    # one unrelated request first: cuBLAS and allocator warm-up stays out
    # of the measured run (its blocks stay cached and never match)
    warm = Request(rid=-1, prompt=torch.randint(
        0, cfg.vocab_size, (40,), generator=torch.Generator().manual_seed(9)
    ).numpy().astype("int32"), max_new=2)
    serve_loop(eng, [warm])
    if tracer is not None:
        tracer.by_span.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stats = serve_loop(eng, trace)
    launches = dict(LAUNCHES)
    done = [r for r in eng.finished if r.rid >= 0]
    if stats["completed"] != len(trace) or len(done) != len(trace):
        fail(f"{label}: {stats['completed']}/{len(trace)} requests completed")
    short = [r.rid for r in done if len(r.tokens_out) != r.max_new]
    if short:
        fail(f"{label}: requests {short} stopped before max_new tokens")
    snap = eng.pool.snapshot()
    if eng.pool.kind == "paged":
        eng.pool.check_invariants()
        if eng.pool.n_active or (snap["blocks_held"]
                                 != snap["prefix_cached_blocks"]):
            fail(f"{label}: blocks leaked after the drain: {snap}")
    elif eng.pool.n_active or any(eng.pool.slot_live):
        fail(f"{label}: slots still live after the drain: {snap}")
    print(f"serve[{label}]: {stats['completed']}/{len(trace)} requests, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.3f}s = "
          f"{stats['tokens_per_s']:.1f} tok/s, ttft p50 "
          f"{stats['p50_ttft_s']:.4f}s, decode {stats['decode_tok_per_s']:.1f}"
          f" tok/s, prefill {stats['prefill_tokens_computed']}/"
          f"{stats['prefill_tokens_total']} tokens computed, "
          f"{stats['cow_copies']} COW copies, launches {launches}, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB", flush=True)
    cap = eng.capture_stats
    print(f"serve[{label}]: warm-start captured {cap['steps']} steps as "
          f"CUDA graphs in {cap['capture_s']:.2f}s, graph memory pool and "
          f"static buffers {cap['graph_bytes'] / 2 ** 20:.1f} MiB; step "
          f"cache {stats['exec_cache']}; speculation "
          f"{stats['speculation']}", flush=True)
    return eng, done, stats, launches


def quant_roundtrip(torch, eng, cfg):
    """The int8 arm's ``_quant_exec(320)`` on one (30, 320, 2, 128) bf16
    tensor, as a 320-token admission hands it over: bit-exact against the
    plain path on the CPU (f32 quantize, f32 dequantize, the pool write's
    cast, as the JAX engine does); its device time and the device
    operations one call runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.quant import dequantize_ref, quantize_ref
    g = torch.Generator(device="cuda").manual_seed(3)
    kv = torch.randn((cfg.n_layers, 320, cfg.n_kv_heads, cfg.hd), generator=g,
                     device="cuda").to(torch.bfloat16)
    f = eng._quant_exec(320)
    before = dict(LAUNCHES)
    out = f(kv)
    torch.cuda.synchronize()
    launched = {k: LAUNCHES[k] - before[k] for k in ("quantize", "dequantize")}
    block = cfg.n_kv_heads * cfg.hd
    flat = kv.cpu().reshape(-1).float()
    rq, rs = quantize_ref(flat, torch.full_like(flat, 0.5), block=block)
    want = dequantize_ref(rq, rs, block=block).to(eng.pool.kv["k"].dtype)
    if not torch.equal(out.cpu(), want.reshape(kv.shape)):
        fail(f"_quant_exec(320) on the card differs from the plain path: "
             f"{int((out.cpu() != want.reshape(kv.shape)).sum())} values")
    if launched != {"quantize": 1, "dequantize": 1}:
        fail(f"_quant_exec(320) launched {launched}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        f(kv)
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if "CUDA" in str(e.device_type))
    print(f"quant: _quant_exec(320) on {tuple(kv.shape)} bf16 rows -> "
          f"{out.dtype}: bit-exact against the CPU plain path, "
          f"{timed_ms(torch, lambda: f(kv)):.4f} ms device time, {ops} "
          f"device operations a call ({launched})", flush=True)


def check_tokens(torch, cfg, params, reqs, tol):
    """The served tokens against one full-sequence prefill (no decode
    cache) over prompt + generated tokens: at every generated position the
    served token's logit is within ``tol`` (the parity phase's bound for
    two paths that differ only in rounding) of the row's maximum — a
    tie-aware greedy check of the decode path (paged KV or stored ssm
    state) against an independent path."""
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
    print(f"tokens: {exact}/{total} served tokens are the prefill path's "
          f"argmax, worst logit gap {worst:.4g} (tolerance {tol})",
          flush=True)
    if worst > tol:
        fail(f"served tokens disagree with the prefill path: logit gap "
             f"{worst} > {tol}")


# ------------------------------------------------------------ phase 7
def ssm_parity(torch, cfg, params):
    """Token-by-token decode (S = 1 from the stored state, the scan kernel
    with h0 written in place) against one prefill of the same sequence
    (the scan kernel from zeros), at full width.

    - 12 tokens from a zero state, 2 sequences: one layer deep the last
      logits agree within 2e-2; at all 64 layers they are held against a
      rounding-noise floor measured in the run — the decode path against
      itself with its stored state h scaled by (1 + 2^-22), two f32 ulps,
      before every step — within 2e-2 + 1.5 x that floor.
    - At the serve's shapes, 8 sequences: a 288-token prefill, then 12
      decode steps of 8 rows, against one 300-token prefill.  Their
      matmuls round bf16 products in other orders (cuBLAS picks other
      kernels for 8 rows than for 2,400), and the bf16 residual stream
      carries those roundings through 64 layers.  The largest logit
      difference over the 12 steps is the rounding floor of "served vs
      one prefill", and every argmax mismatch must be a near-tie within
      2e-2 + 1.5 x that floor.

    Returns that bound: the served-token check's tolerance."""
    import dataclasses

    from repro_torch.models import lm
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)

    def model(depth):
        return (dataclasses.replace(cfg, n_layers=depth),
                dict(params, layers=_slice(params["layers"], depth)))

    def decode(c, p, tok, t0, cache, eps=0.0):
        """Logits (B, S - t0, V) of decode steps t0.. of ``tok``."""
        B, S = tok.shape
        out = []
        for t in range(t0, S):
            cache["h"].mul_(1 + eps)
            logits, cache = lm.decode_step(
                p, cache, tok[:, t:t + 1],
                torch.full((B,), t, dtype=torch.int32, device=dev), c)
            out.append(logits[:, 0].float())
        torch.cuda.synchronize()
        out = torch.stack(out, 1)
        if not torch.isfinite(out).all():
            fail("ssm decode logits not finite")
        return out

    def zero_cache(c, B):
        shapes = lm.init_cache_shapes(c, B)
        return {"conv": torch.zeros(shapes["conv"], dtype=torch.bfloat16,
                                    device=dev),
                "h": torch.zeros(shapes["h"], device=dev)}

    def near_ties(out, ref, tol, what):
        miss = out.argmax(-1) != ref.argmax(-1)
        gap = ref.max(-1).values - ref.gather(
            -1, out.argmax(-1, keepdim=True))[..., 0]
        if float((gap * miss).max()) > tol:
            fail(f"{what}: argmax gap {float((gap * miss).max())} beyond "
                 f"{tol}")
        return 1 - float(miss.float().mean())

    tok = torch.randint(0, cfg.vocab_size, (2, 12), generator=g, device=dev)
    errs = {}
    for depth in (1, cfg.n_layers):
        c, p = model(depth)
        ref = lm.prefill(p, tok, c)[0][:, -1].float()
        out = decode(c, p, tok, 0, zero_cache(c, 2))[:, -1]
        errs[depth] = (out, ref)
    err1 = check_close(torch, "1-layer ssm decode vs prefill", *errs[1],
                       BF16_TOL)
    out, ref = errs[cfg.n_layers]
    noise = max_err(torch, decode(cfg, params, tok, 0, zero_cache(cfg, 2),
                                  eps=2.0 ** -22)[:, -1], out)
    tol = BF16_TOL + 1.5 * noise
    err = max_err(torch, out, ref)
    if err > tol:
        fail(f"full-width ssm decode vs prefill: max abs err {err} beyond "
             f"{tol}")
    agree = near_ties(out, ref, tol, "full-width ssm decode vs prefill")
    print(f"parity[{cfg.name}]: decode (S=1 from the stored state) vs one "
          f"prefill of 12 tokens at full width: 1 layer max_abs_err="
          f"{err1:.4g} (bound {BF16_TOL}); {cfg.n_layers} layers "
          f"max_abs_err={err:.4g} against a rounding-noise floor of "
          f"{noise:.4g} (bound {tol:.4g}), argmax agreement {agree:.3f}, "
          f"|logit| max {float(ref.abs().max()):.3f}", flush=True)

    tok = torch.randint(0, cfg.vocab_size, (8, 300), generator=g,
                        device=dev)
    ref = lm.logits_fn(params, lm.forward(params, tok, cfg)[0][:, 288:],
                       cfg).float()
    cache = lm.forward(params, tok[:, :288], cfg)[1]
    floor = max_err(torch, decode(cfg, params, tok, 288, cache), ref)
    tol = BF16_TOL + 1.5 * max(floor, noise)
    agree = near_ties(decode(cfg, params, tok, 288,
                             lm.forward(params, tok[:, :288], cfg)[1]),
                      ref, tol, "serve-shaped ssm decode vs prefill")
    print(f"parity[{cfg.name}]: 288-token prefill + 12 decode steps of 8 "
          f"rows vs one 300-token prefill: max_abs_err={floor:.4g} "
          f"(the served-token check's floor; bound {tol:.4g}), argmax "
          f"agreement {agree:.3f}", flush=True)
    return tol


def ssm_trace(cfg):
    from repro_torch.serving.workload import make_trace
    return make_trace("mixed_lengths", 400.0, 0.04, vocab=cfg.vocab_size,
                      seed=5, short_lens=(16, 96), long_lens=(256, 512),
                      long_frac=0.25, max_news=(32, 32))


def ssm_path(torch, card):
    """Phase 7 on full-width falcon-mamba-7b.  Returns the scan's launch
    count in the serves."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.serving import DEFAULT_SERVING_SETTING
    cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {cfg.name} full width, {n_params / 1e9:.3f} B params "
          f"bf16, init {time.perf_counter() - t0:.1f}s", flush=True)
    tol = ssm_parity(torch, cfg, params)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=8, cache_dtype="bf16")
    spans = LaunchSpans(LAUNCHES)
    eng, done, stats, launches = serve_arm(torch, cfg, params, setting,
                                           ssm_trace(cfg),
                                           "falcon-mamba bf16",
                                           tracer=spans)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by = {k: v["selective_scan"] for k, v in spans.by_span.items()
          if k in ("serve.prefill", "serve.decode")}
    print(f"serve[falcon-mamba bf16]: selective_scan launches by span "
          f"{by}", flush=True)
    if min(by.get("serve.prefill", 0), by.get("serve.decode", 0)) == 0:
        fail(f"the ssm serve did not launch selective_scan in both prefill "
             f"and decode: {by}")
    check_tokens(torch, cfg, params, [done[0], done[1], max(
        done, key=lambda r: len(r.prompt))], tol)
    print(f"serve[falcon-mamba bf16]: {stats['tokens_per_s']:.1f} tok/s, "
          f"ttft p50 {stats['p50_ttft_s']:.4f}s, decode "
          f"{stats['decode_tok_per_s']:.1f} tok/s on {card}; peak device "
          f"memory in the serve {peak:.2f} GiB", flush=True)
    g = fill_pool(torch, eng, 7)
    check_graphs(torch, eng, "falcon-mamba-7b",
                 step_cases(torch, eng, cfg, g))
    profile_decode(torch, eng, cfg, g)
    del eng
    # speculation: the truncated drafter (the first 32 layers) proposes 2
    # tokens a slot; each tick verifies 3 and rolls partial accepts back
    # by a replay from the snapshot
    spans = LaunchSpans(LAUNCHES)
    _, sdone, _, sl = serve_arm(
        torch, cfg, params, dict(setting, spec_k=2.0, drafter="truncated"),
        ssm_trace(cfg), "falcon-mamba spec_k=2 truncated", tracer=spans)
    by = {k: v["selective_scan"] for k, v in spans.by_span.items()
          if k.startswith("decode.")}
    print(f"spec[falcon-mamba]: selective_scan launches by span {by} "
          f"(decode.verify at S = 3, decode.rollback = _ssm_replay from "
          f"the snapshot at S = 1-2, decode.draft = the truncated "
          f"drafter's prefill)", flush=True)
    if min(by.get("decode.verify", 0), by.get("decode.rollback", 0),
           by.get("decode.draft", 0)) == 0:
        fail(f"the ssm spec arm did not verify, replay and draft through "
             f"the scan: {by}")
    same_tokens(torch, cfg, params, "spec[falcon-mamba]", sdone, done,
                tol)
    time_snapshot(torch, cfg)
    ssm_relayout(torch, cfg, params, {r.rid: r for r in done}, tol)
    return launches["selective_scan"] + sl["selective_scan"]


def time_snapshot(torch, cfg):
    """The ssm rollback's snapshot: every slot's state copied into the
    persistent buffer before a verify step (h f32 and the bf16 conv window
    of 8 slots), device time."""
    from repro_torch.models import lm
    shapes = lm.init_cache_shapes(cfg, 8)
    state = {"conv": torch.zeros(shapes["conv"], dtype=torch.bfloat16,
                                 device="cuda"),
             "h": torch.zeros(shapes["h"], device="cuda")}
    saved = {k: torch.empty_like(v) for k, v in state.items()}
    nbytes = sum(v.numel() * v.element_size() for v in state.values())

    def snap():
        for k, v in state.items():
            saved[k].copy_(v)

    ms = timed_ms(torch, snap)
    print(f"spec[falcon-mamba]: the rollback snapshot copies "
          f"{nbytes / 1e6:.1f} MB a speculative tick in {ms:.4f} ms "
          f"(bound {2 * nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, read and "
          f"write)", flush=True)


def same_tokens(torch, cfg, params, label, got, ref, tol,
                ref_name="spec_k=0"):
    """The tokens of one arm (speculative, or reconfigured mid-serve)
    against a reference arm's (``ref_name``: spec_k = 0, or no
    reconfiguration) on the same requests; a request that differs is held
    to the prefill path tie-aware (``check_tokens``): other query widths
    and batch sizes round the matmuls in other orders."""
    want = {r.rid: r.tokens_out for r in ref}
    differ = [r for r in got if r.tokens_out != want[r.rid]]
    print(f"{label}: {len(got) - len(differ)}/{len(got)} requests "
          f"served exactly the {ref_name} arm's tokens", flush=True)
    if differ:
        check_tokens(torch, cfg, params, differ, tol)


# ------------------------------------------------------------ phase 6
def fill_pool(torch, eng, seed):
    """Random state in the serve arm's drained pool, as 8 live slots would
    hold it: KV rows and a table of distinct blocks for every slot (paged),
    or a conv window and h for every slot (ssm).  Returns the generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = eng.pool
    for t in (pool.kv if pool.kind == "paged" else pool.state).values():
        for i in range(t.shape[0]):
            t[i].copy_(torch.randn(t.shape[1:], generator=g, device="cuda"))
    if pool.kind == "paged":
        n = pool.n_slots
        pool.tables[:] = (torch.arange(n * pool.mb).reshape(n, pool.mb)
                          + 1).numpy()
    return g


def _flat(out):
    if isinstance(out, dict):
        return [t for v in out.values() for t in _flat(v)]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _flat(v)]
    return [out]


def step_cases(torch, eng, cfg, g, quant_eng=None):
    """(name, entry, arguments) of the serve arm's steps: the decode step
    of every context bucket, the 320-token prefill at two last_idx, the
    96-token suffix prefill (paged pools) and ``quant_eng``'s
    _quant_exec(320)."""
    dev = torch.device("cuda")
    n, bs = eng.pool.n_slots, getattr(eng.pool, "bs", 16)

    def toks(B, S):
        return torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                             device=dev)

    for cols in eng._ctx_buckets():
        hi = cols * bs if cols else 1000
        pos = torch.randint(max(hi - 2 * bs, 0), hi, (n,), generator=g,
                            device=dev).to(torch.int32)
        yield (f"decode(cols={cols})", eng._decode_exec(cols),
               (eng.params, eng.pool.decode_cache(), toks(n, 1), pos))
    for last in (100, 319):
        yield (f"prefill(320, last_idx={last})", eng._prefill_exec(320),
               (eng.params, toks(1, 320), torch.tensor([last], device=dev)))
    if eng.pool.kind == "paged":
        yield ("chunk_prefill(96)", eng._chunk_prefill_exec(96),
               (eng.params, {"k": eng.pool.kv["k"], "v": eng.pool.kv["v"]},
                torch.as_tensor(eng.pool.tables[1:2], device=dev),
                toks(1, 96), torch.tensor([256], dtype=torch.int32,
                                          device=dev),
                torch.tensor([40], device=dev)))
    if quant_eng is not None:
        rows = torch.randn((cfg.n_layers, 320, cfg.n_kv_heads, cfg.hd),
                           generator=g, device=dev).to(torch.bfloat16)
        yield "quant(320)", quant_eng._quant_exec(320), (rows,)


def check_graphs(torch, eng, label, cases):
    """Each step replayed as its captured graph, then run by its eager
    callable on a copy of the same pool: outputs and every pool tensor
    bit for bit."""
    pool = eng.pool
    state = pool.kv if pool.kind == "paged" else pool.state
    names = []
    for name, entry, args in cases:
        if not hasattr(entry, "graph"):
            fail(f"graphs[{label}]: {name} is not a captured graph")
        before = {k: v.clone() for k, v in state.items()}
        got = [t.clone() for t in _flat(entry(*args))]
        after = {k: v.clone() for k, v in state.items()}
        for k, v in state.items():
            v.copy_(before[k])
        want = _flat(entry.eager(*args))
        torch.cuda.synchronize()
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if not torch.equal(a, b)]
        bad += [k for k, v in state.items() if not torch.equal(after[k], v)]
        if bad or len(got) != len(want):
            fail(f"graphs[{label}]: {name}: the replay differs from the "
                 f"eager step in {bad}")
        names.append(name)
        del before, after, got, want
    print(f"graphs[{label}]: replay == eager bit for bit (outputs and the "
          f"pool) for {len(names)} steps: {', '.join(names)}", flush=True)


def profile_decode(torch, eng, cfg, g):
    """Where a decode tick's time goes, the eager step beside its captured
    graph in one process.  Dense: 8 slots, 289-373 tokens of context, bf16
    pool, bs 16, context bucket 33; ssm: 8 slots of stored state (bf16
    conv window, f32 h).  Each is timed without the profiler (host clock
    around a synchronised step; CUDA events around 10 back-to-back steps),
    then under ``torch.profiler``: the card's kernel time per step against
    the wall time, the kernels a step and the host's launch calls a step
    (kernel launches, graph launches and asynchronous copies)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import LAUNCHES
    dev = torch.device("cuda")
    n = eng.pool.n_slots
    tok = torch.randint(0, cfg.vocab_size, (n, 1), generator=g, device=dev)
    pos = torch.tensor([300, 317, 333, 351, 288, 299, 345, 372], device=dev,
                       dtype=torch.int32)
    entry = eng._decode_exec(eng._ctx_cols(372))
    args = (eng.params, eng.pool.decode_cache(), tok, pos)
    host_launch = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|"
                             r"MemcpyAsync|LaunchKernelExC)")

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    for mode, fn in (("eager", entry.eager), ("graph", entry)):
        def step():
            fn(*args)
            torch.cuda.synchronize()

        for _ in range(3):
            step()
        before = dict(LAUNCHES)
        step()
        wrapped = sum(LAUNCHES[k] - before[k] for k in LAUNCHES)
        steps = 10
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        wall = (time.perf_counter() - t0) / steps * 1e3
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(steps):
            fn(*args)
        b.record()
        b.synchronize()
        ev_ms = a.elapsed_time(b) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
        events = prof.key_averages()
        kernels = [e for e in events if "CUDA" in str(e.device_type)]
        calls = sum(e.count for e in events
                    if "CUDA" not in str(e.device_type)
                    and host_launch.match(e.key))
        busy = sum(dev_us(e) for e in kernels) / steps / 1e3
        print(f"profile[{cfg.name}] {mode}: decode step (8 slots, "
              f"{cfg.n_layers} layers) {wall:.3f} ms wall, {ev_ms:.3f} ms "
              f"a step between CUDA events over {steps} back-to-back steps, "
              f"{busy:.3f} ms of kernels on the card = busy share "
              f"{busy / wall:.3f}; {sum(e.count for e in kernels) // steps} "
              f"kernels and {calls // steps} host launch calls a step, "
              f"{wrapped} launches of the port's kernels", flush=True)
        if mode == "eager":
            continue
        for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
            print(f"profile:   {dev_us(e) / steps / 1e3:8.4f} ms/step "
                  f"{e.count // steps:5d} x  {e.key[:90]}", flush=True)
        port = [e for e in kernels if re.search(
            r"\b(paged_attention|flash_attention|quantize|dequantize)"
            r"(_scalar)?_kernel\b|\bscan_(direct|chunked)\b", e.key)]
        for e in port:
            print(f"profile:   the port's kernel {e.key[:70]}: "
                  f"{dev_us(e) / steps / 1e3:.4f} ms/step, "
                  f"{e.count // steps} launches a step", flush=True)


def dense_trace(cfg):
    """The shared_prefix trace of the bf16 arm plus one prompt that is a
    whole template, arriving with the first: its last token re-lands in a
    shared block, so admission copies it (COW)."""
    from repro_torch.serving import Request
    from repro_torch.serving.workload import make_trace
    trace = make_trace("shared_prefix", 400.0, 0.04, vocab=cfg.vocab_size,
                       seed=4, prefix_len=256, tail_lens=(16, 96),
                       max_news=(32, 32))
    trace.append(Request(rid=len(trace), prompt=trace[0].prompt[:256].copy(),
                         max_new=32, arrival_s=trace[0].arrival_s))
    return trace


def dense_path(torch, card):
    """Phases 4-6 on full-width starcoder2-3b.  Returns the launch counts of
    the dense path's kernels in its serve arms."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.serving import DEFAULT_SERVING_SETTING
    from repro_torch.serving.workload import make_trace
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
    eng, done, stats, la = serve_arm(torch, cfg, params, share,
                                     dense_trace(cfg), "prefix_share bf16")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if stats["cow_copies"] == 0:
        fail("the whole-template request made no copy-on-write copy")
    check_tokens(torch, cfg, params, [done[0], done[1]] + [
        r for r in done if r.rid == len(done) - 1], tol)
    int8 = dict(share, quant="int8")
    trace8 = make_trace("shared_prefix", 400.0, 0.015, vocab=cfg.vocab_size,
                        seed=100, prefix_len=192, tail_lens=(8, 48),
                        max_news=(8, 8))
    eng8, _, _, lb = serve_arm(torch, cfg, params, int8, trace8, "int8")
    quant_roundtrip(torch, eng8, cfg)
    g = fill_pool(torch, eng, 7)
    check_graphs(torch, eng, "starcoder2-3b",
                 step_cases(torch, eng, cfg, g, quant_eng=eng8))
    profile_decode(torch, eng, cfg, g)
    del eng, eng8
    # speculation: the n-gram drafter proposes 3 tokens a slot over the
    # same trace; one S = 4 paged decode verifies them
    spans = LaunchSpans(LAUNCHES)
    _, sdone, sstats, lc = serve_arm(
        torch, cfg, params, dict(share, spec_k=3.0, drafter="ngram"),
        dense_trace(cfg), "prefix_share bf16 spec_k=3 ngram", tracer=spans)
    by = {k: v["paged_attention"] for k, v in spans.by_span.items()
          if k.startswith("decode.")}
    print(f"spec[starcoder2-3b]: paged_attention launches by span {by} "
          f"(decode.verify at S = 4)", flush=True)
    if by.get("decode.verify", 0) == 0:
        fail(f"the dense spec arm did not verify through paged attention: "
             f"{by}")
    if sstats["speculation"]["accepted"] == 0:
        fail(f"the n-gram drafter had no draft accepted: "
             f"{sstats['speculation']}")
    same_tokens(torch, cfg, params, "spec[starcoder2-3b]", sdone, done,
                tol)
    launches = {k: la[k] + lb[k] + lc[k] for k in DENSE_KERNELS}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"the serve path never launched {missing}: {launches}")
    print(f"serve: {stats['tokens_per_s']:.1f} tok/s, ttft p50 "
          f"{stats['p50_ttft_s']:.4f}s on {card}; peak device memory in the "
          f"prefix_share serve {peak:.2f} GiB", flush=True)
    forced_reconfigs(torch, cfg, params, tol)
    ld = selftuned_serve(torch, cfg, params, card)
    return {k: launches[k] + ld[k] for k in DENSE_KERNELS}


# ------------------------------------------------------------ phase 8
def drive(eng, reqs, hooks=None, max_ticks=2000):
    """Submit ``reqs`` at once and tick until drained; ``hooks[tick](eng)``
    runs after that tick (a forced reconfiguration with live requests).
    Returns the finished requests of this drive."""
    from repro_torch.serving import Request
    fin0 = len(eng.finished)
    for r in reqs:
        eng.submit(Request(rid=r.rid, prompt=r.prompt.copy(),
                           max_new=r.max_new))
    tick = 0
    while eng.has_work():
        eng.step()
        tick += 1
        if hooks and tick in hooks:
            hooks[tick](eng)
        if tick > max_ticks:
            fail(f"drive: {len(reqs)} requests not served in {tick} ticks")
    done = eng.finished[fin0:]
    short = [r.rid for r in done if len(r.tokens_out) != r.max_new]
    if len(done) != len(reqs) or short:
        fail(f"drive: {len(done)}/{len(reqs)} requests completed, {short} "
             f"short of max_new")
    return done


def replay_check(torch, eng, label):
    """The live slots' decode step, replayed as its graph and run eagerly
    from the same pool state: the live slots' logits and every pool
    tensor bit for bit — all but a paged pool's trash block, where every
    idle slot writes its row at position 0 and the last writer is
    arbitrary; the pool is left as it was.  Returns the step."""
    pool = eng.pool
    state = pool.kv if pool.kind == "paged" else pool.state
    live = 1 if pool.kind == "paged" else 0      # first compared block
    active = [i for i, r in enumerate(eng.slot_req) if r is not None]
    if not active:
        fail(f"reconfig[{label}]: no live slot to check the step on")
    entry = eng._decode_exec(eng._ctx_cols(int(eng.slot_pos[active].max())))
    if not hasattr(entry, "graph"):
        fail(f"reconfig[{label}]: the decode step is not a captured graph")
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
    bad = [k for k, v in state.items()
           if not torch.equal(after[k][:, live:], v[:, live:])]
    if not torch.equal(got, want) or bad:
        fail(f"reconfig[{label}]: the decode graph's replay differs from "
             f"its eager step (logits equal: {torch.equal(got, want)}, "
             f"pool tensors that differ: {bad})")
    for k, v in state.items():
        v.copy_(before[k])
    del before, after
    return entry


def check_pool(eng, label):
    pool = eng.pool
    if pool.kind == "paged":
        pool.check_invariants()
    live = sum(r is not None for r in eng.slot_req)
    if pool.n_active != live or len(pool.slot_live) != eng.n_slots:
        fail(f"reconfig[{label}]: pool holds {pool.n_active} live slots, "
             f"the engine {live}")


def reconfig_plan(eng, **new):
    from repro_torch.core.reconfig import plan
    from repro_torch.serving import SERVING_RELAYOUT_KNOBS
    return plan(eng.setting, {**eng.setting, **new},
                mesh_knobs=SERVING_RELAYOUT_KNOBS)


def logical_rows(torch, eng):
    """{rid: {k, v: rows [0, written)}} read through the block tables."""
    out = {}
    for s, r in enumerate(eng.slot_req):
        if r is None:
            continue
        bt = torch.as_tensor(eng.pool.tables[s], dtype=torch.long,
                             device=eng.device)
        out[r.rid] = {k: v[:, bt].flatten(1, 2)[:, :int(eng.slot_pos[s])]
                      .clone() for k, v in eng.pool.kv.items()}
    return out


def forced_reconfigs(torch, cfg, params, tol):
    """Phase 8a, full-width starcoder2-3b: forced reconfigurations with live
    requests — a staged grow max_batch 4 -> 8 (begin_reconfig; a twin
    engine takes the same switch stop-the-world through apply_plan), a
    re-block block_size 16 -> 8 -> 16 through apply_plan (A -> B -> A: the
    last geometry has the first one's step keys and new tensors), then,
    on a second wave, a cache_dtype bf16 -> f32 relayout.  After each: the
    pool's invariants, the decode graph's replay equal to its eager step
    bit for bit; the dtype-preserving arm serves the tokens of an engine
    that never reconfigured (tie-aware), and the dtype switch moves every
    row to exactly its f32 value."""
    from repro_torch.serving import DEFAULT_SERVING_SETTING, ServingEngine
    from repro_torch.serving.workload import make_trace
    dev = torch.device("cuda")
    base = dict(DEFAULT_SERVING_SETTING, max_batch=4, block_size=16,
                cache_dtype="bf16", prefix_share=True)
    reqs = make_trace("poisson", 100.0, 0.1, vocab=cfg.vocab_size, seed=11,
                      prompt_lens=(48, 192), max_news=(48, 48))

    def engine():
        eng = ServingEngine(params, cfg, base, max_seq=1024, device=dev)
        eng.warm_start(max_prompt=192)
        return eng

    ref = {r.rid: r for r in drive(engine(), reqs)}
    costs = {}

    def stop_grow(e):
        costs["grow_stw"] = e.apply_plan(reconfig_plan(e, max_batch=8))
        check_pool(e, "grow stop-the-world")
        replay_check(torch, e, "grow stop-the-world")

    twin = drive(engine(), reqs, {4: stop_grow})
    eng = engine()
    seen = {}

    def stage(e):
        e.begin_reconfig(reconfig_plan(e, max_batch=8))
        seen["st"] = e._staged

    def committed(e):
        if e._staged is not None or "ev" in seen:
            return
        (ev,) = e.take_reconfig_events()
        seen["ev"] = ev
        check_pool(e, "staged grow")
        misses = e._steps.misses
        entry = replay_check(torch, e, "staged grow")
        if e._steps.misses != misses or entry not in \
                seen["st"]["graphs"].values():
            fail("reconfig[staged grow]: the commit did not adopt the "
                 "steps captured on the staged buffer")
        if not ev["staged"] or ev["bg_capture_failures"]:
            fail(f"reconfig[staged grow]: commit event {ev}")
        seen["tick"] = e.ticks

    def reblock(bs, key):
        def hook(e):
            seen[key + "_before"] = replay_check(torch, e, key + " before")
            costs[key] = e.apply_plan(reconfig_plan(e, block_size=bs))
            check_pool(e, key)
            seen[key] = replay_check(torch, e, key)
        return hook

    hooks = {t: committed for t in range(5, 40)}
    hooks[4] = stage
    hooks[44] = reblock(8, "reblock 16->8")
    hooks[48] = reblock(16, "reblock 8->16")
    done = drive(eng, reqs, hooks)
    ev = seen.get("ev")
    if ev is None or seen["tick"] >= 44:
        fail("reconfig[staged grow]: no commit before the re-block")
    a0, a1 = seen["reblock 16->8_before"], seen["reblock 8->16"]
    live = [t.data_ptr() for t in eng.pool.decode_cache().values()]
    if a1 is a0 or a1._bound[1] != live:
        fail("reconfig[reblock A -> B -> A]: the decode step of the first "
             "geometry survived the round trip or is not bound to the "
             "live pool")
    print(f"reconfig[staged grow 4->8]: stall_s {ev['stall_s']:.4f} (the "
          f"commit and the work between ticks), commit cost_s "
          f"{ev['cost_s']:.4f}, "
          f"bg_migrate_s {ev['bg_migrate_s']:.4f}, bg_precompile_s "
          f"{ev['bg_precompile_s']:.4f}, bg_blocks {ev['bg_blocks']}, "
          f"delta_blocks {ev['delta_blocks']}, bg_capture_failures "
          f"{ev['bg_capture_failures']}, staged over "
          f"{ev['staged_wall_s']:.3f}s wall; the same switch stop-the-"
          f"world (apply_plan, twin engine): {costs['grow_stw']:.4f}s",
          flush=True)
    print(f"reconfig[reblock 16->8->16]: apply_plan "
          f"{costs['reblock 16->8']:.4f}s and "
          f"{costs['reblock 8->16']:.4f}s (stop-the-world, "
          f"captures included); the returning geometry's decode step is a "
          f"new capture bound to the new tensors", flush=True)
    for label, got in (("staged grow + reblock", done),
                       ("stop-the-world grow", twin)):
        same_tokens(torch, cfg, params, f"reconfig[{label}]", got,
                    list(ref.values()), tol, "never-reconfigured")

    # second wave: the dtype switch with live requests
    wave = make_trace("poisson", 100.0, 0.05, vocab=cfg.vocab_size,
                      seed=12, prompt_lens=(48, 192), max_news=(24, 24))
    rows = {}

    def to_f32(e):
        rows["before"] = logical_rows(torch, e)
        costs["dtype"] = e.apply_plan(reconfig_plan(e, cache_dtype="f32"))
        rows["after"] = logical_rows(torch, e)
        check_pool(e, "dtype")
        replay_check(torch, e, "dtype")

    done2 = drive(eng, wave, {4: to_f32})
    if eng.pool.kv["k"].dtype != torch.float32 or not rows["before"]:
        fail("reconfig[dtype]: the pool is not f32 after the switch")
    n = 0
    for rid, kv in rows["before"].items():
        for k, v in kv.items():
            if not torch.equal(rows["after"][rid][k], v.to(torch.float32)):
                fail(f"reconfig[dtype]: request {rid}'s {k} rows are not "
                     f"the old rows in f32")
            n += v.numel()
    check_tokens(torch, cfg, params, done2, tol)
    print(f"reconfig[dtype bf16->f32]: apply_plan {costs['dtype']:.4f}s; "
          f"{n} relocated values equal .to(float32) of the old rows bit for "
          f"bit", flush=True)


def selftuned_serve(torch, cfg, params, card):
    """Phase 8b, full-width starcoder2-3b: the ``launch/serve.py
    --selftune`` path — ``warm_start(space)``, the launcher's
    ``selftune_manager`` (TuningManager + ServingObjective) and
    ``serve_loop`` — over a Poisson trace long enough for the Latin-
    hypercube init to visit its settings.  Every request completes, every
    kind of reconfiguration the tuner proposed commits at least once, and
    no staged capture fails."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import selftune_manager
    from repro_torch.serving import (DEFAULT_SERVING_SETTING, ServingEngine,
                                     serve_loop, serving_knob_space)
    from repro_torch.serving.workload import make_trace
    dev = torch.device("cuda")
    space = serving_knob_space(max_batch_ceiling=8, include_batches=(4,),
                               family=cfg.family)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=4)
    eng = ServingEngine(params, cfg, setting, max_seq=1024, device=dev)
    gc.collect()                  # the earlier arms' engines and caches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.warm_start(space, max_prompt=128)
    warm_s = time.perf_counter() - t0
    trace = make_trace("poisson", 20.0, 6.0, vocab=cfg.vocab_size, seed=0,
                       prompt_lens=(16, 128), max_news=(16, 32))
    tuner = selftune_manager(eng, space, setting, window=40,
                             init_settings=5, seed=0)
    proposed = []
    begin = eng.begin_reconfig

    def record(p):
        proposed.append(p)
        begin(p)

    eng.begin_reconfig = record
    reset_launches()
    stats = serve_loop(eng, trace, tuner, verbose=True, max_wall_s=240.0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_reserved() - reserved0
    if not launches["paged_attention"] or not launches["flash_attention"]:
        fail(f"selftune: the serve did not run the attention kernels: "
             f"{launches}")
    if stats["completed"] != len(trace):
        fail(f"selftune: {stats['completed']}/{len(trace)} requests "
             f"completed")
    got = {k for r in stats["reconfigs"] for k in r["kinds"]}
    want = {k for p in proposed for k in p.kinds}
    if not stats["reconfigs"] or not want <= got:
        fail(f"selftune: proposed kinds {sorted(want)}, committed "
             f"{sorted(got)} ({stats['reconfig_count']} commits)")
    bad = [r for r in stats["reconfigs"] if r["bg_capture_failures"]]
    if bad:
        fail(f"selftune: staged captures failed: {bad}")
    check_pool(eng, "selftune")
    staged = [r for r in stats["reconfigs"] if r["staged"]]
    print(f"selftune: {stats['completed']}/{len(trace)} requests, "
          f"{stats['tokens_per_s']:.1f} tok/s, ttft p50 "
          f"{stats['p50_ttft_s']:.4f}s, {len(proposed)} plans proposed, "
          f"{stats['reconfig_count']} committed ({len(staged)} staged) in "
          f"{stats['reconfig_total_s']:.3f}s of stalls, kinds "
          f"{sorted(got)}; final setting {stats['final_setting']}", flush=True)
    print(f"selftune: step cache {stats['exec_cache']}; warm_start(space, "
          f"max_prompt=128) captured {eng.capture_stats['steps']} steps in {warm_s:.2f}s, "
          f"holding {eng.capture_stats['graph_bytes'] / 2 ** 20:.1f} MiB; "
          f"peak memory reserved over the warm-start and the serve (graphs "
          f"of every geometry visited, pools, staged buffers) "
          f"{peak / 2 ** 20:.1f} MiB on {card}", flush=True)
    for r in stats["reconfigs"]:
        print(f"selftune:   commit {r['kinds']} staged={r['staged']} "
              f"stall_s {r['stall_s']} cost_s {r['cost_s']} "
              f"bg_migrate_s {r['bg_migrate_s']} "
              f"bg_precompile_s {r['bg_precompile_s']} bg_blocks "
              f"{r['bg_blocks']} delta_blocks {r['delta_blocks']}",
              flush=True)
    print(f"selftune: kernel launches in the serve {launches}", flush=True)
    return launches


def ssm_relayout(torch, cfg, params, ref, tol):
    """Phase 8c, full-width falcon-mamba-7b: the short requests of the ssm
    trace with max_batch 8 -> 4 while 8 are live (the pool holds its slot
    count until they drain, then shrinks in the tick) and back to 8 with
    live requests; after each the decode graph's replay equals its eager
    step, and the tokens are the phase-7 serve's (tie-aware)."""
    from repro_torch.serving import DEFAULT_SERVING_SETTING, ServingEngine
    dev = torch.device("cuda")
    reqs = [r for r in ssm_trace(cfg) if len(r.prompt) <= 96]
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          max_batch=8, cache_dtype="bf16"),
                        max_seq=1024, device=dev)
    eng.warm_start(max_prompt=96)
    seen = {}

    def shrink(e):
        seen["shrink"] = e.apply_plan(reconfig_plan(e, max_batch=4))
        seen["held"] = e.n_slots
        replay_check(torch, e, "ssm shrink held")

    def grow(e):
        if "grow" in seen or e.n_slots != 4 or not e.n_active:
            return
        seen["grow"] = e.apply_plan(reconfig_plan(e, max_batch=8))
        replay_check(torch, e, "ssm grow")
        seen["slots"] = e.n_slots

    hooks = {t: grow for t in range(3, 200)}
    hooks[2] = shrink
    done = drive(eng, reqs, hooks)
    if seen.get("held") != 8 or seen.get("slots") != 8:
        fail(f"reconfig[ssm]: slot counts {seen}")
    same_tokens(torch, cfg, params, "reconfig[ssm]", done,
                [ref[r.rid] for r in reqs], tol, "phase-7 serve")
    print(f"reconfig[ssm max_batch 8->4->8]: apply_plan {seen['shrink']:.4f}"
          f"s with 8 live (held at 8 slots, shrunk after the drain), "
          f"{seen['grow']:.4f}s back to 8; replays equal their eager steps",
          flush=True)


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    from repro_torch.kernels import build_all

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
    rows["selective_scan"] = check_scan(torch)
    launches = dense_path(torch, card)
    # free the dense model (and its engines' pools) before falcon-mamba
    gc.collect()
    torch.cuda.empty_cache()
    print(f"freed the dense model: {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
          f" GiB still allocated", flush=True)
    launches["selective_scan"] = ssm_path(torch, card)

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
