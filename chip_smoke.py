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
             out), dequantize beside torch.mul.  The training path's
             kernels: the flash forward's log-sum-exp against the plain
             logsumexp; the flash backward (two launches: dq with delta,
             then dk/dv in clusters that split a group's heads) against
             autograd through the plain version at the training shape
             (B=4, S=512, H=24, K=2, hd 128), at S=1024, hd 64, a ragged S,
             not causal and G = 3, bit for bit across two calls; timed
             whole and by launch beside SDPA's backward, the flash forward
             beside SDPA's forward;
             quantize and dequantize at one block the size of
             layers/mlp/wi (1,132,462,080 bf16 values, the grid-wide path)
             and at ragged odd n, bit for bit, and timed.  The hybrid
             path's shapes: the scan at N = 64, D = 4096 on mamba2's f32
             inputs (prefill 1-512 from zeros and h0, decode B = 8 at S = 1
             and 3 in place), flash at H = K = 32, hd 64 (G = 1) beside
             SDPA, paged attention over the shared block's slab viewed as
             blocks beside SDPA with a mask; each timed beside its bound.
             The moe path's shapes (llama4-scout, 40 q / 8 kv heads, G =
             5) and the vlm path's (phi-3-vision, 32 q = 32 kv heads of hd
             96, G = 1): paged attention at decode, verify and a suffix
             prefill over bf16 and f32 pools, flash at S = 320 and at the
             training shape with lse beside SDPA, and the flash backward
             at the training shape with one CTA a cluster (P = 1; at hd 96
             over tiles padded to 128 columns) beside SDPA's backward.
             The encoder's (hubert-xlarge, 16 q = 16 kv heads of hd 80, not
             causal): the flash forward at (4, 1024), S = 1000 and keys at
             negative positions (masked), with the log-sum-exp, and the
             flash backward at the same cases (tiles padded from 80 to 128
             columns), bit for bit across two calls; timed at the training
             shape with lse, at the encode without, and the backward by
             launch, beside SDPA (is_causal=False) and its backward.
             The ssm and hybrid training shapes (4 x 512 tokens):
             the scan's forward with interval checkpoints (h_chk) and
             its backward (two launches, no atomics) at falcon-mamba's
             (D 8192, N 16, bf16 x and dt, Bm/Cm bf16 views) and
             zamba2's (D 4096, N 64, f32), a ragged S and S <= 8: y and
             h_last bit for bit with and without h_chk, h_chk against
             the plain states, every gradient against autograd through
             the plain recurrence in f64 within twice the f32 plain
             version's own gap, bit for bit across two calls; both timed
             beside their bounds and plain versions (no library call);
             the flash forward and backward at zamba2's shared block in
             training, (4, 512, 32/32, 64) causal, G = 1, beside SDPA.
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

9. train  — falcon-mamba is freed; full-width starcoder2-3b training
             through ``repro_torch.ps`` (the launcher's path): one step's
             loss and gradients, the kernel path against the plain path,
             one layer deep and all 30 layers against a measured
             rounding-noise floor; a fixed run (DEFAULT_LM_SETTING, 30
             layers, 4 x 512 tokens, 30 steps): the loss falls, step time,
             tokens/s, busy share, FLOP share, flash launches a step (30
             each), peak memory; a checkpoint saved at step 10 of a
             2-layer full-width run and restored into a fresh state gives
             step 11's loss (bit for bit, or the gap printed); the depth at
             which the knob space's worst corner fits, from the measured
             peak; every value of every knob stepped there (int8: one
             quantize and dequantize a leaf; the staleness queue as deep
             as asked); a self-tuned run (TuningManager + SelfTuningLoop,
             160 iterations) in which every plan executes.

10. hybrid — the training state is freed; full-width zamba2-1.2b (38
             mamba2 layers, d_inner 4096 in 64 heads of 64, N 64; one
             shared attention + MLP block after layers 0, 6, ..., 36, 32
             heads of hd 64, its KV in a dense per-slot slab): decode from
             the stored state and slab against one prefill (1 layer and
             38, against a measured noise floor); a mixed_lengths serve
             (16 requests of 16-512 tokens, 32 new, 8 slots, max_seq 1024,
             bf16 pool) in which the scan and flash run in prefill and the
             scan and paged attention in decode, tokens checked against a
             full prefill; phase 6's graph checks (the S = 3 verify and the
             S = 2 replay included) and decode profile on its pool;
             spec_k = 2 with the truncated drafter, the spec_k = 0 arm's
             tokens; max_batch 8 -> 4 -> 8 and cache_dtype bf16 -> f32
             with live requests (every relocated row its old value in
             f32); the serve and a spec arm again at 7 layers (the shared
             block twice), where the random-init model's decode-vs-prefill
             rounding floor is a small part of the logits (at 38 layers it
             is their own size, in the JAX package too): every served
             token the prefill path's argmax within it, the spec arm's
             tokens the plain arm's; two self-tuned serves through
             ``launch/serve.py --selftune --tuning-store`` on one fresh
             store under build/smoke/, the second warm-started from the
             first's golden incumbent and observations.  Layer by layer
             (``layer_by_layer``): each of the 38 layers of the kernel path
             and of the plain path (every kernel replaced by its plain
             version) on the same input, the plain path's output of the
             layer before, in a decode step from a stored state and slab
             and in a prefill; each layer's gap within 1.5 x its own noise
             (the plain path with its input moved one ulp).

11. moe    — the hybrid model is freed; llama4-scout-17b-a16e at full width
             (d_model 5120, 40 q / 8 kv heads of hd 128, 16 experts of d_ff
             8192 a layer, top-1, capacity factor 1.25, vocab 202048) cut
             to 12 of its 48 layers (54 GB of weights): the per-layer check
             of a decode step (paged vs gather) and of a 320-token prefill
             (flash vs plain), with the tokens whose expert differs and
             their router margins, then phase 4's decode parity at 1 and 12
             layers as the drift bound; phase 5's shared_prefix arm and
             int8 arm, phase 6's graph checks and decode profile (the
             expert products' share against the weight read), a spec_k = 3
             arm, each served token held to a replay of the engine's
             prefill groups and decode steps on the plain paths; a
             self-tuned serve with at least one relayout.  Then training
             at 1 layer (4.15 B parameters, 4 x 512 tokens): loss, router
             aux and gradients of the kernel path against the plain path
             within a measured noise floor, fixed steps in which the loss
             falls, one step with the int8 push.

12. vlm    — the moe model is freed; phi-3-vision-4.2b at full width and
             depth (32 layers, d_model 3072, 32 q = 32 kv heads of hd 96,
             SwiGLU d_ff 8192, vocab 32064, untied head, a patch frontend
             1024 -> 3072; 3.824 B params): the per-layer check of a decode
             step (paged vs gather) and of a prefill of 64 image patches +
             256 tokens (flash vs plain), phase 4's decode parity at 1 and
             32 layers; served from tokens, as the JAX engine serves vlm:
             phase 5's shared_prefix bf16 arm with every served token held
             to a full prefill (tie-aware), the int8 arm, phase 6's graph
             checks and decode profile, a spec_k = 3 arm with the spec_k =
             0 arm's tokens, a self-tuned serve; then training with
             patches, 4 x (64 patches + 448 tokens): loss and gradients
             (frontend/proj among them) of the kernel path against the
             plain path at 1 layer within a measured noise floor, fixed
             steps at full depth in which the loss falls, one step with
             the int8 push.

13. encoder — the vlm model is freed; hubert-xlarge at full width and
             depth (48 layers, d_model 1280, 16 q = 16 kv heads of hd 80,
             not causal, SwiGLU d_ff 5120, 504 targets, untied head, a
             frame frontend 512 -> 1280; 1.260 B params): 4 x 1024 frames
             (synthetic_batch, prefill kind) encoded through
             lm.forward(mode="prefill") and logits_fn over every frame
             (wall and CUDA-event time, flash launches); the per-layer
             check of that encode (flash vs plain, each layer within 1.5 x
             its one-ulp noise); every frame's logits at 1 layer within
             2e-2 and at 48 against a measured noise floor, each argmax
             the plain path's or a near-tie; the serving engine's refusal
             ("encoder-only models have no decode step"); then training
             over 4 x 1024 frame batches: loss and gradients of the kernel
             path against the plain path at 1 layer within a measured
             noise floor (embed/tokens' gradient exactly zero), 8 Adam
             steps of build_train_step at full depth on one repeated batch
             in which the loss falls (step time, frames/s, busy share, the
             Adam pass alone, peak memory, flash launches a step), one
             step with remat="full" (the flash forward twice a layer).

14. ssm train — the encoder is freed; the ssm and hybrid families trained
             through ``ps.stepfn`` at full width, 4 x 512 tokens, Adam.
             zamba2-1.2b (38 layers, 1.170 B params): loss and gradients
             of the kernel path (the scan's forward with h_chk and its
             backward, flash forward and backward) against the plain path
             at 1 layer within a measured noise floor; 8 fixed steps at
             full depth on one repeated batch in which the loss falls (38
             scan forwards, 38 backwards, 7 flash forwards and 7
             backwards a step; step time, tokens/s, busy share, device ms
             by kind, the Adam pass alone, peak memory); remat none /
             dots / full at 2 layers with the same gradients (the scan's
             forward twice a layer under dots and full); a checkpoint
             resume at 2 layers, bit for bit.  falcon-mamba-7b (64 mamba1
             layers, 7.27 B params at full depth): parity at 1 layer; its
             depth cut to the deepest that leaves 8 GB of the card free
             (predicted from the allocator's reserved peaks at 4 and 8
             layers; the phase fails if a step at that depth runs out of
             memory), and 8 fixed steps there.

15. mesh   — the ssm and hybrid states are freed; a world-1 NCCL process
             group over a file:// store in a temporary directory, a 1x1
             MeshSpec over its live DeviceMesh (one all-reduce proves the
             group).  Full-width starcoder2-3b at phase 9's depth (30
             layers, 4 x 512 tokens): the mesh build_train_step(ms=...)
             (pull, compute, push, update) against the single-device step
             from the same state on the same batches, 3 steps with no
             compression and 3 with the int8 push: every loss and every
             parameter leaf bit for bit, wall and CUDA-event ms of each
             step, the flash and quant launches of the mesh steps.  At 4
             layers: the checkpoint baseline's round trip (save under the
             1x1 placement, restore_pytree(ms=1x1) into a fresh state)
             bit for bit, with its seconds.  llama4-scout-17b-a16e at full
             width, 1 layer: moe_block_ep on the 1x1 mesh against moe_block
             on the same tokens at T = 8 and 2,048, bit for bit.
16. serve  — on phase 15's world-1 mesh, full-width starcoder2-3b (30
             layers) through ``ps.stepfn``'s serve steps:
             build_prefill_step over 8 prompts of 320 tokens, the rows
             copied into lm.init_cache(cfg, 8, 1024), then 32 greedy steps
             of build_decode_step over that dense per-slot cache (paged
             attention over it viewed as blocks, G = 12), against
             lm.prefill / lm.decode_step with no mesh: every step's logits
             and the cache bit for bit, 30 flash launches a prefill and 30
             paged launches a decode step; each layer of a dense-cache
             decode step against the plain path within 1.5 x its one-ulp
             noise; paged attention over the dense cache, (8, 1, 24, 128)
             over (8, 1024, 2, 128), checked and timed beside its plain
             version, SDPA with a mask and its bound; the dry run's
             prediction (launch/dryrun.py: meta tensors on the host, no
             card) of phase 9's fixed run's peak and transient allocated
             bytes against what phase 9 measured (within 10%, else the
             miss is printed), and its collective bytes (0 at one rank).
17. engine — on the same mesh, the serving engine under it
             (``ServingEngine(ms=ms, param_specs=serve_param_specs(cfg,
             ms))``) against ``ms=None``, both driven tick by tick
             (``drive``, no wall clock) over the same requests: every
             token, the final pool (blocks 1.. and the tables of a paged
             pool, every leaf of an ssm pool) and each kernel's launches
             equal.  Full-width starcoder2-3b (30 layers, 8 slots,
             max_seq 1024, blocks of 16, prefix sharing) over
             ``dense_trace``: bf16, int8 (quantize and dequantize),
             spec_k = 3 n-gram (the S = 4 verify), then a stop-the-world
             max_batch 8 -> 4 and a staged 4 -> 8 taken by both engines
             at the same ticks (each relayout places its new tensors,
             ``pool.placed``, keeping them; tokens also held to the
             never-reconfigured arm, tie-aware), and one ``serve_loop``
             under the mesh (tokens tie-aware).  Full-width, full-depth
             zamba2-1.2b (the ssm pool and its KV slab: the scan, flash,
             paged attention at G = 1) over ``hybrid_trace``, then its
             short prompts with max_batch 8 -> 4 on both engines.

Prints one JSON ``kernels`` line (launches: the serve arms', the training
runs', the hybrid, moe, vlm, encoder, ssm training, mesh, serve-step and
mesh-engine paths'), the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

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
LSE_TOL = 1e-4                     # flash lse: f32 exp2/log2 vs logsumexp,
                                   # relative to max(1, |lse|)
BWD_RTOL = 2e-2                    # flash backward vs autograd through the
                                   # plain version, relative to the largest
                                   # |gradient|: P and dS rounded to bf16 for
                                   # the tensor-core products, bf16 results
TRAIN_GRAD_TOL = 5e-2              # train parity: gradients (relative to a
TRAIN_LOSS_TOL = 2e-2              # leaf's largest |value|) and the loss,
                                   # kernel vs plain path, plus 1.5 x the
                                   # rounding-noise floor measured in the run
TRAIN_STEPS = 30                   # the fixed run at full width and depth
CKPT_DEPTH = 2                     # checkpoint resume: full width, 2 layers
SELFTUNE_ITERS = 160               # the self-tuned run
TOLS: dict = {}                    # phase 4's token tolerance by model, for
                                   # phase 17's tie-aware checks
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


def launch_ms(torch, fn, pattern: str, iters: int = 20) -> dict:
    """Mean device time of each kernel whose name matches ``pattern`` in
    one call of ``fn`` (torch.profiler), with the L2 flushed before every
    call as ``timed_ms`` flushes it: {kernel name: ms a launch}."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if m and "CUDA" in str(e.device_type):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            out[m.group(0)] = us / e.count / 1e3
    return out


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


def step_cases(torch, eng, cfg, g, quant_eng=None, spec=False):
    """(name, entry, arguments) of the serve arm's steps: the decode step
    of every context bucket, the 320-token prefill at two last_idx, the
    96-token suffix prefill (paged pools), ``quant_eng``'s
    _quant_exec(320), and with ``spec`` (an ssm pool) the S = 3 verify
    step and the rollback's S = 2 replay step on the pool's snapshot."""
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
    if spec:
        pos = torch.randint(600, 900, (n,), generator=g,
                            device=dev).to(torch.int32)
        yield ("verify(S=3)", eng._decode_exec(0, 3),
               (eng.params, eng.pool.decode_cache(), toks(n, 3), pos))
        saved = eng.pool.save_state()        # the replay step reads it
        yield ("replay(S=2)", eng._replay_exec(2),
               (eng.params, saved, toks(n, 2), pos))


def check_graphs(torch, eng, label, cases):
    """Each step replayed as its captured graph, then run by its eager
    callable on a copy of the same pool: outputs and every pool tensor
    (the speculative snapshot's included) bit for bit."""
    pool = eng.pool
    names = []
    for name, entry, args in cases:
        state = dict(pool.kv if pool.kind == "paged" else pool.state)
        if getattr(pool, "saved", None) is not None:
            state.update({"saved_" + k: v for k, v in pool.saved.items()})
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
    (kernel launches, graph launches and asynchronous copies).  Returns the
    graph's wall and kernel ms a step, and the device ms a step of the
    eager step's ``aten::bmm`` calls (the moe experts' products: cuBLAS
    names a batched and a plain GEMM alike, and a graph replay records no
    operator)."""
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

    out = {}
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
            out["bmm_ms"] = sum(
                getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0.0))
                for e in events if e.key == "aten::bmm") / steps / 1e3
            continue
        out.update(wall_ms=wall, busy_ms=busy)
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
    return out


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
    TOLS[cfg.name] = tol

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


def selftuned_serve(torch, cfg, params, card, need_relayout=False):
    """Phase 8b, full-width starcoder2-3b: the ``launch/serve.py
    --selftune`` path — ``warm_start(space)``, the launcher's
    ``selftune_manager`` (TuningManager + ServingObjective) and
    ``serve_loop`` — over a Poisson trace long enough for the Latin-
    hypercube init to visit its settings.  Every request completes, every
    kind of reconfiguration the tuner proposed commits at least once, and
    no staged capture fails; with ``need_relayout`` at least one commit
    re-lays the pool out (Type I-b)."""
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
    if need_relayout and "I-b" not in got:
        fail(f"selftune: no relayout committed (kinds {sorted(got)})")
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


# ------------------------------------------------------------ phase 3 (training shapes)
def check_train_kernels(torch, rows):
    """The training path's kernels against their plain versions: the flash
    forward's log-sum-exp; the flash backward at the training shape (B=4,
    S=512, H=24, K=2, hd=128), at S=1024, at hd 64, at a ragged S, not
    causal and at G = 3 (H=6), each twice, bit for bit; quantize and dequantize at one block the size of
    ``layers/mlp/wi`` (1,132,462,080 bf16 values, the gradient push's
    largest leaf) and at a ragged odd n, bit for bit.  Then their times
    beside the plain versions, the library's and the bounds.  Adds the
    ``flash_attention_bwd`` row to ``rows`` and the training shapes to the
    other rows' ``extra``."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.quant import (dequantize, dequantize_ref,
                                           quantize, quantize_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    bf16 = torch.bfloat16

    def inputs(B, S, h, hd):
        r = [torch.randn(shape, generator=g, device=dev).to(bf16)
             for shape in ((B, S, h, hd), (B, S, K, hd), (B, S, K, hd),
                           (B, S, h, hd))]
        return r + [torch.arange(S, device=dev)[None].expand(B, S)]

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    err, lse_err = 0.0, 0.0
    for B, S, h, hd, causal in [(4, 512, H, HD, True), (1, 1024, H, HD, True),
                                (2, 512, H, 64, True), (2, 333, H, HD, True),
                                (1, 320, H, HD, False), (1, 190, 6, HD, True)]:
        q, k, v, do, pos = inputs(B, S, h, hd)
        out, lse = flash_attention(q, k, v, pos, pos, causal=causal,
                                   return_lse=True)
        if not torch.equal(out, flash_attention(q, k, v, pos, pos,
                                                causal=causal)):
            fail(f"flash forward with lse differs from without (S={S})")
        ref = attention_lse_ref(q, k, pos, pos, causal=causal)
        lse_err = max(lse_err, float((lse - ref).abs().max()))
        if lse_err > LSE_TOL * max(1.0, float(ref.abs().max())):
            fail(f"flash lse B={B} S={S} hd={hd}: max abs err {lse_err}")
        got = flash_attention_bwd(q, k, v, out, do, lse, pos, pos,
                                  causal=causal)
        again = flash_attention_bwd(q, k, v, out, do, lse, pos, pos,
                                    causal=causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_bwd B={B} S={S} H={h} hd={hd}: two calls "
                 f"differ (the kernel must be deterministic)")
        want = attention_bwd_ref(q, k, v, do, pos, pos, causal=causal)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            e = rel(a, b)
            if not torch.isfinite(a.float()).all() or e > BWD_RTOL:
                fail(f"flash_attention_bwd {name} B={B} S={S} hd={hd} "
                     f"causal={causal}: max err {e} of the largest |value| "
                     f"(bound {BWD_RTOL})")
            err = max(err, float((a.float() - b.float()).abs().max()))
    print(f"flash training: lse max abs err {lse_err:.3g} (bound "
          f"{LSE_TOL} x max(1, |lse|)); backward within {BWD_RTOL} of the "
          f"largest |gradient| at B=4 S=512, S=1024, hd 64, ragged S=333, "
          f"not causal, G=3, bit for bit across two calls (max abs err "
          f"{err:.3g})", flush=True)

    # times at the training shape: 4 x 512 tokens, the model's heads
    B, S = 4, 512
    q, k, v, do, pos = inputs(B, S, H, HD)
    out, lse = flash_attention(q, k, v, pos, pos, return_lse=True)
    ms = timed_ms(torch, lambda: flash_attention_bwd(q, k, v, out, do, lse,
                                                     pos, pos))
    plain = timed_ms(torch, lambda: attention_bwd_ref(q, k, v, do, pos, pos))
    fwd_lse = timed_ms(torch, lambda: flash_attention(
        q, k, v, pos, pos, return_lse=True))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    lib = timed_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))

    def lib_fb():
        o = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    def ker_fb():
        o, l_ = flash_attention(q, k, v, pos, pos, return_lse=True)
        return flash_attention_bwd(q, k, v, o, do, l_, pos, pos)

    lib_fb_ms, ker_fb_ms = timed_ms(torch, lib_fb), timed_ms(torch, ker_fb)
    # SDPA's forward with grad on (so it keeps its log-sum-exp for the
    # backward), beside the flash forward with lse
    with torch.enable_grad():
        lib_fwd = timed_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                               enable_gqa=True))
    per = launch_ms(torch, lambda: flash_attention_bwd(
        q, k, v, out, do, lse, pos, pos), r"flash_bwd_(dq|dkdv)_kernel")
    pairs = B * H * S * (S + 1) / 2
    big, small = B * S * H * HD * 2, B * S * K * HD * 2
    b = bound(4 * big + 4 * small + B * H * S * 4, 10 * HD * pairs,
              BF16_FLOPS)
    rows["flash_attention_bwd"] = dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:79",
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound=b,
        shape=f"training B={B} S={S} H={H} K={K} hd={HD} causal bf16 "
              f"(dq with delta + dk/dv launches)",
        extra="".join(f" {name}_ms={t:.4f}" for name, t in sorted(
            per.items())) + f" fwd+bwd: kernels_ms={ker_fb_ms:.4f} "
                            f"sdpa_ms={lib_fb_ms:.4f}")
    if set(per) != {"flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"}:
        print(f"flash_attention_bwd: the profiler saw {per}: per-launch "
              f"times not measured", flush=True)
    rows["flash_attention"]["extra"] += (
        f" training(B=4 S=512, with lse)_ms={fwd_lse:.4f} "
        f"sdpa_training_fwd_ms={lib_fwd:.4f}")

    # quantize / dequantize at one block per tensor
    n = 30 * 3072 * 12288                       # layers/mlp/wi
    x = (torch.randn(n, generator=g, device=dev) * 1e-3).to(bf16)
    u = torch.rand(n, generator=g, device=dev)
    qq, ss = quantize(x, u, block=n)
    rq, rs = quantize_ref(x, u, block=n)
    if not (torch.equal(qq, rq) and torch.equal(ss, rs)):
        fail(f"quantize at one block of n={n}: {int((qq != rq).sum())} "
             f"values differ, scale {float(ss)} vs {float(rs)}")
    del rq
    dq_ref = dequantize_ref(qq, ss, block=n, out_dtype=bf16)
    if not torch.equal(dequantize(qq, ss, block=n, out_dtype=bf16), dq_ref):
        fail(f"dequantize at one block of n={n} not bit-exact")
    del dq_ref
    for m in (3_000_017, 1_000_001):           # ragged odd n, f32 and bf16
        for x_dt in (torch.float32, bf16):
            xs = torch.randn(m, generator=g, device=dev).to(x_dt)
            us = torch.rand(m, generator=g, device=dev)
            a, s1 = quantize(xs, us, block=m)
            r, s2 = quantize_ref(xs, us, block=m)
            if not (torch.equal(a, r) and torch.equal(s1, s2)):
                fail(f"quantize at one ragged block n={m} {x_dt}")
            if not torch.equal(dequantize(a, s1, block=m, out_dtype=x_dt),
                               dequantize_ref(r, s2, block=m,
                                              out_dtype=x_dt)):
                fail(f"dequantize at one ragged block n={m} {x_dt}")
    qt_ms = timed_ms(torch, lambda: quantize(x, u, block=n), iters=10)
    dq_ms = timed_ms(torch, lambda: dequantize(qq, ss, block=n,
                                               out_dtype=bf16), iters=10)
    qb = bound(n * 2 + n * 4 + n + 4, 6 * n, F32_FLOPS)
    q2 = (n * 2 * 2 + n * 4 + n + 4) / HBM_BYTES_PER_S * 1e3
    dqb = bound(n + 4 + n * 2, n, F32_FLOPS)
    print(f"quant per tensor: n={n} bf16 (layers/mlp/wi) and ragged odd "
          f"n=3000017, 1000001 bit-exact", flush=True)
    del x, u, qq
    rows["quantize"]["extra"] += (
        f" per_tensor(n={n} bf16 x, f32 u, one block)_ms={qt_ms:.4f} "
        f"bound_ms={qb[0]:.4f} (inputs once; the two-pass floor, x read "
        f"twice, {q2:.4f})")
    rows["dequantize"]["extra"] += (
        f" per_tensor(n={n}, bf16 out)_ms={dq_ms:.4f} "
        f"bound_ms={dqb[0]:.4f}")
    r = rows["flash_attention_bwd"]
    print(f"kernel flash_attention_bwd: max_abs_err={r['max_abs_err']:.3g} "
          f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"library_ms={r['library_ms']:.4f} (SDPA backward) bound_ms="
          f"{r['bound'][0]:.4f} ({r['bound'][1]}){r['extra']} "
          f"[{r['shape']}]", flush=True)
    for name in ("flash_attention", "quantize", "dequantize"):
        print(f"kernel {name} (training shapes):{rows[name]['extra']}",
              flush=True)


# ------------------------------------------------------------ phase 9
TRAIN_B, TRAIN_S = 4, 512          # tokens a step: 2,048


def _train_cfg(depth=None):
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = get_config("starcoder2-3b")
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


@contextlib.contextmanager
def plain_attention(torch, eps=0.0):
    """The training attention of ``lm`` replaced by a plain masked softmax
    in f32 (autograd through it), its scores scaled by (1 + eps): the
    parity run's reference and its rounding-noise floor.  Causal or not
    (the encoder), masked as the kernels mask."""
    from repro_torch.models import lm

    def attn(q, k, v, *, causal, q_positions, kv_positions, k_chunk=0):
        G = q.shape[2] // k.shape[2]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         k.repeat_interleave(G, dim=2).float())
        s = s * (q.shape[-1] ** -0.5 * (1 + eps))
        if causal:
            mask = q_positions[:, :, None] >= kv_positions[:, None, :]
        else:
            mask = (kv_positions >= 0)[:, None, :].expand(
                -1, q.shape[1], -1)
        s = torch.where(mask[:, None], s, -1e30)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                           v.repeat_interleave(G, dim=2).float())
        return out.to(q.dtype)

    real = lm.chunked_attention
    lm.chunked_attention = attn
    try:
        yield
    finally:
        lm.chunked_attention = real


def train_parity(torch):
    """One train step's loss and gradients of full-width starcoder2-3b, the
    kernel path (flash forward and backward) against the plain path on
    the same parameters and batch: one layer deep, and all 30 layers
    against a rounding-noise floor measured in the run (the plain path
    against itself with its scores scaled by 1 + 2^-20)."""
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    from repro_torch.ps.stepfn import _grads
    cfg = _train_cfg()
    params = lm.init_params(cfg, seed=0, device="cuda")
    batch = next(lm_batch_iterator(cfg, TRAIN_B, TRAIN_S, seed=0))
    out = {}
    for depth in (1, cfg.n_layers):
        c = _train_cfg(depth)
        p = dict(params, layers=_slice(params["layers"], depth))

        def run():
            loss, _, g = _grads(p, batch, c, ModelKnobs())
            return float(loss), list(_leaves(g))

        before = LAUNCHES["flash_attention_bwd"]
        k_loss, k_g = run()
        if LAUNCHES["flash_attention_bwd"] - before != depth:
            fail(f"train parity: {LAUNCHES['flash_attention_bwd'] - before}"
                 f" flash backward launches for {depth} layers")
        with plain_attention(torch):
            p_loss, p_g = run()
        with plain_attention(torch, eps=2.0 ** -20):
            n_loss, n_g = run()

        def worst(a, b):
            return max(float((x.float() - y.float()).abs().max()
                             / y.float().abs().max().clamp_min(1e-30))
                       for x, y in zip(a, b))

        err, noise = worst(k_g, p_g), worst(n_g, p_g)
        tol = TRAIN_GRAD_TOL + 1.5 * noise
        lerr, lnoise = abs(k_loss - p_loss), abs(n_loss - p_loss)
        ltol = TRAIN_LOSS_TOL + 1.5 * lnoise
        print(f"parity[train {depth} layer(s)]: loss kernel {k_loss:.6f} "
              f"plain {p_loss:.6f} (|diff| {lerr:.3g}, floor {lnoise:.3g}, "
              f"bound {ltol:.3g}); gradients: worst leaf max err "
              f"{err:.4g} of its largest |value| against a rounding-noise "
              f"floor of {noise:.4g} (bound {tol:.4g})", flush=True)
        if not (err <= tol and lerr <= ltol) or any(
                not torch.isfinite(x.float()).all() for x in k_g):
            fail(f"train parity at {depth} layers")
        out[depth] = (err, noise)
        del k_g, p_g, n_g
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _profile_steps(torch, step, state, batches, steps=3):
    """The card's kernel time against the wall time over ``steps`` steps
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, next(batches))
            float(m["loss"])
        wall = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.key_averages()
               if "CUDA" in str(e.device_type)]
    busy = sum(dev_us(e) for e in kernels) / steps / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    groups = {}                          # ms a step and kernels a step
    for e in kernels:
        g = next((name for name, pat in TRAIN_KERNEL_GROUPS
                  if re.search(pat, e.key)), "other")
        ms, n = groups.get(g, (0.0, 0))
        groups[g] = (ms + dev_us(e) / steps / 1e3, n + e.count // steps)
    return state, wall, busy, [(e.key[:70], dev_us(e) / steps / 1e3,
                                e.count // steps) for e in top], groups


# kernel name -> kind, for the training step's breakdown (the first match)
TRAIN_KERNEL_GROUPS = (
    ("gemm", r"nvjet|gemm|cutlass|sm90_xmma|ampere|Kernel2"),
    ("flash", r"flash_bwd|flash_attention"),
    ("scan", r"scan_bwd|scan_chunked|scan_direct"),
    ("copy", r"direct_copy|Memcpy|Memset|CatArrayBatched"),
    ("fill", r"FillFunctor|fill_kernel"),
    ("reduce", r"reduce_kernel|softmax|logsumexp|Reduce"),
    ("index", r"index|gather|scatter|embedding"),
    ("elementwise", r"elementwise"),
)


def time_optimizer(torch, job, state, reps=3):
    """One Adam update of the whole state on its own (gradients of zeros,
    the parameters' shapes and dtype), median of ``reps`` between CUDA
    events.  It moves the state on: call it last on a state."""
    from repro_torch.core.tree import tree_map
    from repro_torch.optim import make_optimizer
    _, update = make_optimizer(job.tc)
    grads = tree_map(torch.zeros_like, state["params"])
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        update(state["params"], grads, state["opt"])
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del grads
    return sorted(times)[len(times) // 2]


def fixed_run(torch, job_cls, setting):
    """DEFAULT_LM_SETTING at full width and depth, 4 x 512 tokens, 30 steps:
    the loss falls; step time (wall and CUDA events), tokens/s, busy share,
    the model FLOP share, flash launches a step, peak memory.  Returns
    (peak GB, state GB, launches, memory): memory the allocated bytes
    before the state, with it and at the peak over the steps, and the
    setting (what phase 16's dry run predicts)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg = _train_cfg()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    job = job_cls(cfg, batch=TRAIN_B, seq=TRAIN_S)
    state = job.init_state(setting, seed=0)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    step = job.step_builder(setting)
    batches = job.batches(0)
    losses, walls, evs, peaks = [], [], [], []
    reset_launches()
    for it in range(TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step(state, next(batches))
        b.record()
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        evs.append(a.elapsed_time(b))
        peaks.append(torch.cuda.max_memory_allocated())
        if it == 0:
            per_step = dict(LAUNCHES)
    launches = dict(LAUNCHES)
    if not (per_step["flash_attention"] == per_step["flash_attention_bwd"]
            == cfg.n_layers):
        fail(f"fixed run: flash launches a step {per_step}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    memory = dict(base=base, state=state_gb * 1e9, peak=peak * 1e9,
                  setting=dict(setting))
    print(f"train[fixed]: allocated peak after each step (GB): "
          f"{[round(x / 1e9, 3) for x in peaks]}", flush=True)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not np.isfinite(losses).all() or not last < first:
        fail(f"fixed run: the loss did not fall ({first} -> {last})")
    state, pwall, busy, top, groups = _profile_steps(torch, step, state,
                                                     batches)
    opt_ms = time_optimizer(torch, job, state)
    wall = float(np.median(walls[5:]))
    ev = float(np.median(evs[5:]))
    n = cfg.n_params()
    tokens = TRAIN_B * TRAIN_S
    pairs = TRAIN_B * cfg.n_heads * TRAIN_S * (TRAIN_S + 1) / 2
    flops = (6 * (n - cfg.vocab_size * cfg.d_model) * tokens
             + 12 * cfg.hd * pairs * cfg.n_layers)
    print(f"train[fixed]: {cfg.name} full width and depth ({cfg.n_layers} "
          f"layers, {n / 1e9:.3f} B params), {TRAIN_B} x {TRAIN_S} tokens, "
          f"{TRAIN_STEPS} steps of {setting}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (mean of the first 5 {first:.4f}, of the last "
          f"5 {last:.4f})", flush=True)
    print(f"train[fixed]: step {wall:.2f} ms wall, {ev:.2f} ms between CUDA "
          f"events (medians of steps 6-{TRAIN_STEPS}), {tokens / wall * 1e3:.0f}"
          f" tokens/s; under torch.profiler {pwall:.2f} ms wall, {busy:.2f} "
          f"ms of kernels = busy share {busy / pwall:.3f}; model FLOPs "
          f"{flops:.4g} a step = {flops / (ev * 1e-3) / BF16_FLOPS:.3f} of "
          f"989 TFLOP/s; flash launches a step: {per_step['flash_attention']}"
          f" forward, {per_step['flash_attention_bwd']} backward; state "
          f"{state_gb:.2f} GB, peak {peak:.2f} GB allocated", flush=True)
    for key, ms, cnt in top:
        print(f"train[fixed] profile: {ms:8.3f} ms/step {cnt:5d} x  {key}",
              flush=True)
    print("train[fixed] by kind: " + ", ".join(
        f"{g} {ms:.2f} ms ({n} kernels)" for g, (ms, n) in
        sorted(groups.items(), key=lambda kv: -kv[1][0]))
        + f"; the Adam pass alone {opt_ms:.2f} ms between CUDA events (22 "
          f"bytes a parameter would take {22 * cfg.n_params() / HBM_BYTES_PER_S * 1e3:.1f}"
          f" ms at 3.35 TB/s)", flush=True)
    print(f"train[fixed] losses: {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return peak, state_gb, launches, memory


def checkpoint_resume(torch, job_cls, setting, depth, cfg=None, label=""):
    """Save at step 10, restore into a fresh state (another seed), run step
    11: its loss against the uninterrupted run's, bit for bit (the gap is
    printed if cuBLAS or an atomic breaks that).  ``cfg``: starcoder2-3b
    at ``depth`` layers unless given."""
    from repro_torch.checkpoint import CheckpointManager, restore_pytree
    cfg = cfg or _train_cfg(depth)
    d = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(d, ignore_errors=True)
    job = job_cls(cfg, batch=TRAIN_B, seq=TRAIN_S)
    state = job.init_state(setting, seed=0)
    step = job.step_builder(setting)
    batches = job.batches(0)
    mgr = CheckpointManager(str(d), every=10, keep=1)
    t_save = 0.0
    for it in range(1, 12):
        state, m = step(state, next(batches))
        loss = float(m["loss"])
        t0 = time.perf_counter()
        if mgr.maybe_save(state, it, {"loss": loss}):
            t_save = time.perf_counter() - t0
    del state
    gc.collect()
    fresh = job.init_state(setting, seed=1)
    t0 = time.perf_counter()
    fresh, meta = restore_pytree(fresh, str(d))
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    batches = job.batches(0)
    for _ in range(10):
        next(batches)
    fresh, m = step(fresh, next(batches))
    resumed = float(m["loss"])
    size = sum(f.stat().st_size for f in d.rglob("*")) / 1e9
    shutil.rmtree(d, ignore_errors=True)
    same = resumed == loss
    print(f"train[checkpoint{' ' + label if label else ''}]: "
          f"{cfg.n_layers} layers at full width, "
          f"{size:.2f} GB on disk (save {t_save:.1f}s, restore "
          f"{t_restore:.1f}s, from step {meta['step']}): step 11 loss "
          f"{resumed!r} resumed vs {loss!r} uninterrupted: "
          + ("bit for bit" if same else f"GAP {abs(resumed - loss):.3g}"),
          flush=True)
    if not np.isfinite(resumed) or abs(resumed - loss) > 1e-2:
        fail("checkpoint resume: the resumed step's loss is off")
    del fresh, step
    gc.collect()
    torch.cuda.empty_cache()


def sweep_depth(torch, peak_gb, state_gb):
    """The largest depth at which the knob space's worst corner fits: the
    fixed run's measured peak scaled to D layers, plus an f32 microbatch
    accumulator and a 2-deep bf16 staleness queue (8 bytes a parameter)
    and the int8 push's transient for the largest leaf (7 bytes a
    value), within 90% of the card."""
    cfg = _train_cfg()
    L = cfg.n_layers
    per_layer_params = (cfg.n_params() - 2 * cfg.vocab_size * cfg.d_model) / L
    edge_params = 2 * cfg.vocab_size * cfg.d_model
    edge_gb = edge_params * 12 / 1e9             # params, grads, m, v
    per_layer_gb = (peak_gb - edge_gb) / L       # state and activations
    extra_gb = 8 * per_layer_params / 1e9        # acc f32 + queue 2 x bf16
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    wi = cfg.d_model * cfg.d_ff
    depth = 1
    while depth < L:
        d = depth + 1
        need = (edge_gb + 8 * edge_params / 1e9 + d * (per_layer_gb
                                                       + extra_gb)
                + 7 * d * wi / 1e9)
        if need > 0.9 * total:
            break
        depth = d
    print(f"train[depth]: fixed-run peak {peak_gb:.2f} GB (state "
          f"{state_gb:.2f} GB) -> {per_layer_gb:.3f} GB a layer; the worst "
          f"corner (microbatches 4 with an f32 accumulator, staleness 2, "
          f"int8) adds {extra_gb:.3f} GB a layer: {depth} layers fit in 90% "
          f"of {total:.1f} GB", flush=True)
    return depth


def knob_sweep(torch, job_cls, space, default, depth):
    """Every value of every knob of ``lm_knob_space(1)`` takes steps at
    ``depth`` layers: a finite loss, int8 launches quantize and dequantize
    once a leaf, the staleness queue as deep as the setting asks."""
    from repro_torch.core import reconfig as rc
    from repro_torch.core.tree import leaves
    from repro_torch.kernels import LAUNCHES
    cfg = _train_cfg(depth)
    job = job_cls(cfg, batch=TRAIN_B, seq=TRAIN_S)
    state = job.init_state(default, seed=0)
    batches = job.batches(0)
    n_leaves = len(leaves(state["params"]))
    settings = [dict(default)] + [dict(default, **{kn.name: v})
                                  for kn in space.knobs for v in kn.values
                                  if v != default[kn.name]]
    torch.cuda.reset_peak_memory_stats()
    launches = dict.fromkeys(LAUNCHES, 0)
    cur = dict(default)
    for s in settings:
        state = job.state_adapter(state, rc.plan(cur, s))
        cur = s
        step = job.step_builder(s)
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        state, m = step(state, next(batches))
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        d = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        for k in d:
            launches[k] += d[k]
        if not np.isfinite(loss):
            fail(f"sweep {s}: loss {loss}")
        if s["compression"] == "int8" and not (
                d["quantize"] == d["dequantize"] == n_leaves):
            fail(f"sweep {s}: {d['quantize']} quantize / {d['dequantize']} "
                 f"dequantize launches for {n_leaves} leaves")
        q = state.get("grad_queue")
        depth_q = leaves(q)[0].shape[0] if q else 0
        if depth_q != s["staleness"]:
            fail(f"sweep {s}: queue depth {depth_q}")
        print(f"train[sweep] {s}: loss {loss:.4f}, {dt * 1e3:.0f} ms "
              f"(first step of the setting), flash {d['flash_attention']}/"
              f"{d['flash_attention_bwd']} fwd/bwd, quantize "
              f"{d['quantize']}, queue depth {depth_q}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"train[sweep]: {len(settings)} settings at {depth} layers, every "
          f"value of every knob stepped; peak {peak:.2f} GB allocated",
          flush=True)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def selftuned_run(torch, job_cls, space, default, depth):
    """The --self-tune path: TuningManager over lm_knob_space(1) driving
    SelfTuningLoop for SELFTUNE_ITERS iterations at ``depth`` layers.
    Every plan the tuner proposes executes (the adapter runs once for each
    and the tuner commits it)."""
    from repro_torch.core.tuner import TunerConfig, TuningManager
    from repro_torch.kernels import LAUNCHES
    from repro_torch.ps.trainer import SelfTuningLoop
    cfg = _train_cfg(depth)
    job = job_cls(cfg, batch=TRAIN_B, seq=TRAIN_S)
    state = job.init_state(default, seed=0)
    torch.cuda.reset_peak_memory_stats()
    tuner = TuningManager(space, default, TunerConfig(eps=0.05, a=8, b=6,
                                                      seed=0))
    applied = []

    def adapter(st, plan):
        applied.append(plan)
        return job.state_adapter(st, plan)

    losses = []
    real_record = tuner.record_iteration

    def record(loss, dt):
        losses.append(loss)
        real_record(loss, dt)

    tuner.record_iteration = record
    loop = SelfTuningLoop(tuner, job.step_builder, adapter)
    before = dict(LAUNCHES)
    res, state = loop.run(state, job.batches(0), max_iters=SELFTUNE_ITERS)
    launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_rec = len(tuner.audit.of_type("reconfig"))
    if tuner._pending is not None or n_rec != len(applied) or not applied:
        fail(f"self-tuned run: {len(applied)} plans applied, {n_rec} "
             f"recorded, pending {tuner._pending}")
    rep = tuner.progress_report()
    print(f"train[selftune]: {res.iterations} iterations at {depth} layers "
          f"in {res.wall_time_s:.1f}s, {len(applied)} plans proposed and "
          f"executed ({', '.join(sorted({'+'.join(p.kinds) for p in applied}))}"
          f"), reconfiguration {res.reconfig_total_s:.3f}s in all, final "
          f"setting {tuner.current}, final loss {res.final_loss:.4f}, "
          f"converged {res.converged}; progress: remaining ~"
          f"{rep['remaining_iters']:.0f} iters / {rep['remaining_time_s']:.1f}"
          f"s; step cache {loop._steps.stats()}; peak {peak:.2f} GB "
          f"allocated", flush=True)
    print(f"train[selftune] losses every 10: "
          f"{' '.join(f'{x:.3f}' for x in losses[::10])}", flush=True)
    if not np.isfinite(losses).all():
        fail("self-tuned run: a loss is not finite")
    del state, loop
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_path(torch):
    """Phase 9 on full-width starcoder2-3b.  Returns the launch counts of
    the training runs (fixed, sweep, self-tuned) and the fixed run's
    memory (``fixed_run``)."""
    from repro_torch.ps.lm_job import (DEFAULT_LM_SETTING, LMJob,
                                       lm_knob_space)
    t0 = time.perf_counter()
    train_parity(torch)
    peak, state_gb, launches, memory = fixed_run(torch, LMJob,
                                                 DEFAULT_LM_SETTING)
    checkpoint_resume(torch, LMJob, DEFAULT_LM_SETTING, CKPT_DEPTH)
    depth = sweep_depth(torch, peak, state_gb)
    space = lm_knob_space(1)
    for counts in (knob_sweep(torch, LMJob, space, DEFAULT_LM_SETTING, depth),
                   selftuned_run(torch, LMJob, space, DEFAULT_LM_SETTING,
                                 depth)):
        for k, n in counts.items():
            launches[k] += n
    print(f"train: phase 9 in {time.perf_counter() - t0:.1f}s, launches "
          f"{launches}", flush=True)
    return launches, memory


# ------------------------------------------------------------ phase 3 (hybrid shapes)
HY_NH, HY_P, HY_N = 64, 64, 64     # zamba2-1.2b: ssm heads, head dim, state
HY_D = HY_NH * HY_P                # d_inner 4096
HY_H, HY_HD = 32, 64               # shared block: 32 q = 32 kv heads, hd 64
HY_POS = [300, 317, 333, 351, 288, 299, 345, 372]   # a decode tick's slots


def check_hybrid_kernels(torch, rows):
    """The three kernels at the hybrid path's shapes, against their plain
    versions, then timed beside their bounds (printed lines; the kernels
    line keeps each kernel's first row and adds the hybrid path's
    launches):

    - the selective scan at N = 64, D = 4096 as ``mamba2_block`` hands it
      over (x f32, dt a head's value repeated over its 64 channels, Bm and
      Cm f32 views of one projection, A a head's scalar over (P, N)):
      prefills of 1-512 tokens from zeros and from h0, decode B = 8 at
      S = 1 and S = 3 written in place;
    - flash attention at H = K = 32, hd 64 (G = 1), S = 320 and 512,
      k_chunk 128 and 256, timed beside SDPA;
    - paged attention over the shared block's slab (8, 1024, 32, 64) bf16
      and f32 viewed as blocks of 16 through the identity tables, S = 1
      and 3, against the dense ``decode_attention``, timed beside SDPA with
      a boolean mask over the same slab."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_ref)
    from repro_torch.models.attention import (decode_attention,
                                              identity_tables,
                                              slab_decode_attention)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    bf16, f32 = torch.bfloat16, torch.float32
    clock = sm_clock_ghz()

    def scan_inputs(B, S, h0):
        x = torch.randn((B, S, HY_D), generator=g, device=dev)
        dt = torch.nn.functional.softplus(torch.randn(
            (B, S, HY_NH), generator=g, device=dev))
        dt = dt[..., None].expand(B, S, HY_NH, HY_P).reshape(B, S, HY_D)
        Bm, Cm = torch.randn((B, S, 2 * HY_N), generator=g,
                             device=dev).split(HY_N, dim=-1)
        A = -torch.rand((HY_NH,), generator=g, device=dev) * 2 - 0.05
        A = A[:, None, None].expand(HY_NH, HY_P, HY_N).reshape(HY_D, HY_N)
        h = (torch.randn((B, HY_D, HY_N), generator=g, device=dev) if h0
             else None)
        return x, dt, Bm, Cm, A.contiguous(), h

    err = 0.0
    for B, S, h0 in [(1, S, h0) for S in (1, 16, 37, 256, 512)
                     for h0 in (False, True)] + [(8, 1, True), (8, 3, True)]:
        x, dt, Bm, Cm, A, h = scan_inputs(B, S, h0)
        ry, rh = selective_scan_ref(x, dt, Bm, Cm, A, h)
        y, hl = selective_scan(x, dt, Bm, Cm, A, h, h_out=h)
        torch.cuda.synchronize()
        what = f"selective_scan N=64 B={B} S={S} h0={h0}"
        if h is not None and hl.data_ptr() != h.data_ptr():
            fail(f"{what}: h_out was not written in place")
        err = max(err, check_close(torch, what + " y", y, ry, SCAN_TOL),
                  check_close(torch, what + " h", hl, rh, SCAN_TOL))
    rows["selective_scan"]["max_abs_err"] = max(
        rows["selective_scan"]["max_abs_err"], err)

    def scan_bound(B, S, h0):
        """x, dt, Bm, Cm, A read once, y and h written once (h0 read);
        the B S D N exponentials on the SFU."""
        n = B * S * HY_D
        nbytes = (n * 4 * 2 + 2 * B * S * HY_N * 4 + HY_D * HY_N * 4
                  + n * 4 + B * HY_D * HY_N * 4 * (2 if h0 else 1))
        t_exp = n * HY_N / (SFU_PER_SM_CLOCK * N_SMS * clock * 1e9) * 1e3
        return nbytes / HBM_BYTES_PER_S * 1e3, t_exp

    for label, B, S, h0 in [("decode", 8, 1, True), ("verify", 8, 3, True)] + [
            ("prefill", 1, S, False) for S in (16, 96, 256, 512)]:
        x, dt, Bm, Cm, A, h = scan_inputs(B, S, h0)
        ms = timed_ms(torch, lambda: selective_scan(x, dt, Bm, Cm, A, h,
                                                    h_out=h))
        plain = timed_ms(torch, lambda: selective_scan_ref(x, dt, Bm, Cm, A,
                                                           h), iters=5)
        tb, te = scan_bound(B, S, h0)
        b = (tb, "bytes") if tb >= te else (te, "operations")
        print(f"kernel selective_scan[hybrid {label} B={B} S={S} D={HY_D} "
              f"N={HY_N}, f32 x/dt/Bm/Cm]: kernel_ms={ms:.4f} plain_ms="
              f"{plain:.4f} library_ms=n/a bound_ms={b[0]:.4f} ({b[1]}; "
              f"bytes {tb:.4f}, exponentials {te:.4f})", flush=True)

    err = 0.0
    for S, kc in [(S, kc) for S in (37, 320, 512) for kc in (128, 256)]:
        q, k, v = (torch.randn((1, S, HY_H, HY_HD), generator=g,
                               device=dev).to(bf16) for _ in range(3))
        out = flash_attention(q, k, v, block_k=kc)
        torch.cuda.synchronize()
        err = max(err, check_close(torch, f"flash_attention hybrid S={S} "
                                   f"kc={kc}", out, attention_ref(q, k, v),
                                   BF16_TOL))
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], err)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for S in (320, 512):
        q, k, v = (torch.randn((1, S, HY_H, HY_HD), generator=g,
                               device=dev).to(bf16) for _ in range(3))
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        ms = timed_ms(torch, lambda: flash_attention(q, k, v, pos, pos,
                                                     block_k=128))
        plain = timed_ms(torch, lambda: attention_ref(q, k, v, pos, pos))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = timed_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
        b = bound(4 * q.numel() * 2 + 2 * S * 4,
                  4 * HY_H * HY_HD * S * (S + 1) / 2, BF16_FLOPS)
        print(f"kernel flash_attention[hybrid prefill B=1 S={S} H=K="
              f"{HY_H} hd={HY_HD} bf16, k_chunk=128]: kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} (SDPA) "
              f"bound_ms={b[0]:.4f} ({b[1]})", flush=True)

    B, T = 8, 1024
    tables = identity_tables(B, T, dev)
    err = 0.0
    for S, dtype in [(1, bf16), (3, bf16), (1, f32), (3, f32)]:
        q = torch.randn((B, S, HY_H, HY_HD), generator=g, device=dev).to(
            bf16)
        ks, vs = (torch.randn((B, T, HY_H, HY_HD), generator=g,
                              device=dev).to(dtype) for _ in range(2))
        pos = torch.tensor([0, 5, 100, 333, 512, 700, T - S - 1, T - S],
                           dtype=torch.int32, device=dev)
        for _ in range(2):               # the split counters return to 0
            out = slab_decode_attention(q, ks, vs, tables, pos=pos)
            torch.cuda.synchronize()
            err = max(err, check_close(
                torch, f"paged_attention over the slab S={S} {dtype}", out,
                decode_attention(q, ks, vs, pos=pos), BF16_TOL))
    rows["paged_attention"]["max_abs_err"] = max(
        rows["paged_attention"]["max_abs_err"], err)
    for S in (1, 3):
        q = torch.randn((B, S, HY_H, HY_HD), generator=g, device=dev).to(
            bf16)
        ks, vs = (torch.randn((B, T, HY_H, HY_HD), generator=g,
                              device=dev).to(bf16) for _ in range(2))
        pos = torch.tensor(HY_POS, dtype=torch.int32, device=dev)
        ms = timed_ms(torch, lambda: slab_decode_attention(q, ks, vs, tables,
                                                           pos=pos))
        plain = timed_ms(torch, lambda: decode_attention(q, ks, vs, pos=pos))
        qp = pos.long()[:, None] + torch.arange(S, device=dev)
        mask = (torch.arange(T, device=dev)[None, None, :]
                <= qp[:, :, None])[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, ks, vs))
        lib = timed_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask))
        seen = sum(p + S for p in HY_POS)
        pairs = sum(p + j + 1 for p in HY_POS for j in range(S))
        b = bound(seen * HY_H * HY_HD * 2 * 2 + 2 * q.numel() * 2
                  + tables.numel() * 4, 4 * pairs * HY_H * HY_HD, BF16_FLOPS)
        print(f"kernel paged_attention[hybrid slab decode B=8 S={S} H=K="
              f"{HY_H} hd={HY_HD} G=1, slab (8, {T}) bf16 as blocks of 16, "
              f"ctx {min(HY_POS) + 1}-{max(HY_POS) + S}]: kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} (SDPA, boolean "
              f"mask over the slab) bound_ms={b[0]:.4f} ({b[1]})",
              flush=True)


# ------------------------------------------------------------ per-layer parity
def bump_ulp(torch, x, sign):
    """``x`` with every nonzero element moved one ulp of its dtype away
    from zero (``sign`` 1), toward it (-1), or each its own way (``sign``
    a tensor of +-1 like ``x``); zeros stay."""
    it = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[x.dtype]
    if isinstance(sign, torch.Tensor):
        sign = sign.to(it)
    return torch.where(x == 0, x, (x.view(it) + sign).view(x.dtype))


@contextlib.contextmanager
def plain_path(torch):
    """Every kernel the model calls replaced by its plain PyTorch version
    on the card: prefill attention by ``blocked_attention`` (the JAX
    package's chunked attention), paged attention over a block table or a
    slab by the dense gather + masked softmax, the selective scan by
    ``selective_scan_ref`` (h written where the kernel writes it)."""
    from repro_torch.kernels.mamba_scan import selective_scan_ref
    from repro_torch.models import attention, lm, mamba

    def scan(x, dt, Bm, Cm, A, h0=None, *, h_out=None):
        y, h = selective_scan_ref(x, dt, Bm, Cm, A, h0)
        return y, (h if h_out is None else h_out.copy_(h))

    def paged(q, k_pool, v_pool, block_tables, *, pos, ctx_cols=0):
        NB, bs, K, hd = k_pool.shape
        B, MB = block_tables.shape
        w = min(ctx_cols, MB) if ctx_cols else MB
        bt = block_tables[:, :w].long()
        return attention.decode_attention(
            q, k_pool[bt].reshape(B, w * bs, K, hd),
            v_pool[bt].reshape(B, w * bs, K, hd), pos=pos)

    saved = (lm.chunked_attention, lm.paged_decode_attention,
             attention.paged_decode_attention, mamba.selective_scan)
    lm.chunked_attention = attention.blocked_attention
    lm.paged_decode_attention = attention.paged_decode_attention = paged
    mamba.selective_scan = scan
    try:
        yield
    finally:
        (lm.chunked_attention, lm.paged_decode_attention,
         attention.paged_decode_attention, mamba.selective_scan) = saved


class RouteRecorder:
    """Records what each moe block routed (the router's probabilities, the
    chosen experts and which (token, choice) pairs kept a capacity slot)
    while active, by wrapping ``models/moe.py``'s ``_route`` and
    ``_dispatch``; the block itself runs unchanged.  ``pinned(routes)``
    imposes recorded choices instead: each block computes its router's
    probabilities and aux loss itself but takes the next recorded top-k
    indices, so its gates and dispatch are the recorded run's; ``flips``
    counts the tokens whose own choice differed."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.moe, self.torch, self.calls, self.flips = moe, torch, [], 0

    @contextlib.contextmanager
    def pinned(self, routes):
        moe, route, it = self.moe, self.moe._route, iter(routes)

        def pin(x, router, topk):
            probs, _, topi = route(x, router, topk)
            want = next(it)
            self.flips += int((topi != want).any(-1).sum())
            topw = probs.gather(-1, want)
            topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
            return probs, topw, want

        moe._route = pin
        try:
            yield self
        finally:
            moe._route = route

    @contextlib.contextmanager
    def active(self):
        moe, torch = self.moe, self.torch
        route, dispatch = moe._route, moe._dispatch
        rec = {}

        def routed(x, router, topk):
            out = route(x, router, topk)
            rec["probs"], rec["topi"] = out[0].detach(), out[2]
            return out

        def dispatched(x, topw, topi, n_experts, cap):
            xe, meta, order = dispatch(x, topw, topi, n_experts, cap)
            keep = torch.empty_like(meta[3]).scatter_(0, order, meta[3])
            self.calls.append((rec["probs"], rec["topi"],
                               keep.view(topi.shape)))
            return xe, meta, order

        moe._route, moe._dispatch = routed, dispatched
        try:
            yield self
        finally:
            moe._route, moe._dispatch = route, dispatch

    def take(self):
        """(probs, topi, keep) of the last block run, or None."""
        out = self.calls[-1] if self.calls else None
        self.calls.clear()
        return out


def layer_by_layer(torch, label, x0, n_layers, run):
    """Each layer of the kernel path and of the plain path on the same
    input, the plain path's output of the layer before: ``run(i, x,
    plain)`` -> (y, route), route (router probabilities, chosen experts,
    kept pairs) for a routed layer, else None, restoring any state the
    layer writes before it runs.  Per layer:

    - the gap: the largest |kernel - plain| of the layer's output over the
      tokens that both paths routed alike (same experts, same pairs kept);
    - the noise: the largest |plain(x') - plain(x)| with x' = x moved one
      ulp, over the tokens that routed alike in both, of four draws:
      every element away from zero, every element toward it (which the
      RMSNorm nearly divides out), and twice each element a seeded random
      way; the bound is 1.5 x that noise;
    - the tokens whose chosen experts differ, each with the plain path's
      router margin (1st minus 2nd probability, or k-th minus (k+1)-th):
      each margin must be within 3 x the largest router-probability move
      of the noise draws (1.5 x the two probabilities it takes to swap),
      i.e. a swap that the layer's own rounding noise could make; tokens
      that only lost or won a capacity slot are counted.

    Fails when a gap passes its bound or a swap its
    margin bound.  Returns the per-layer rows (gap, noise, swaps, tokens
    that only won or lost a slot) and the largest router-probability move
    between the kernel path and the plain path over the layers (0 without
    routed layers)."""
    x = x0
    rows, kernel_move = [], 0.0
    g = torch.Generator(device=x0.device).manual_seed(7)
    for i in range(n_layers):
        yk, rk = run(i, x, False)
        ways = [torch.randint(0, 2, x.shape, generator=g,
                              device=x.device) * 2 - 1 for _ in range(2)]
        noisy = [run(i, bump_ulp(torch, x, s), True)
                 for s in [1, -1] + ways]
        yp, rp = run(i, x, True)
        if not all(torch.isfinite(y.float()).all() for y in (yk, yp)):
            fail(f"layers[{label}] layer {i}: output not finite")
        T = yp.shape[0] * yp.shape[1]

        def alike(ra, rb):
            if ra is None:
                return torch.ones(T, dtype=torch.bool, device=yp.device)
            return ((ra[1] == rb[1]).all(-1) & (ra[2] == rb[2]).all(-1))

        def diff(y, ok):
            d = (y.float() - yp.float()).abs().reshape(T, -1).amax(-1)
            return float((d * ok).max())

        same = alike(rk, rp)
        gap = diff(yk, same)
        noise = max(diff(yn, alike(rn, rp)) for yn, rn in noisy)
        swaps, lost = [], 0
        if rp is not None:
            k = rp[1].shape[1]
            srt = rp[0].sort(-1, descending=True).values
            margin = srt[:, k - 1] - srt[:, k]
            rn_move = max(float((rn[0] - rp[0]).abs().max())
                          for _, rn in noisy)
            kernel_move = max(kernel_move,
                              float((rk[0] - rp[0]).abs().max()))
            moved = (rk[1] != rp[1]).any(-1)
            swaps = [(int(t), float(margin[t])) for t in
                     torch.nonzero(moved).flatten().tolist()]
            lost = int((~same & ~moved).sum())
            bad = [s for s in swaps if s[1] > 3 * rn_move]
            if bad:
                fail(f"layers[{label}] layer {i}: experts swapped at router "
                     f"margins {bad} beyond 3 x the noise's probability "
                     f"move {rn_move:.3g}")
        rows.append((gap, noise, swaps, lost))
        print(f"layers[{label}] {i:2d}: gap {gap:.4g} noise {noise:.4g} "
              f"(bound {1.5 * noise:.4g}, gap/noise "
              f"{gap / max(noise, 1e-30):.3f})"
              + (f"; {len(swaps)} tokens of {T} chose other experts, router "
                 f"margins {[round(m, 5) for _, m in swaps[:6]]}; {lost} "
                 f"only won or lost a capacity slot" if rp is not None
                 else ""), flush=True)
        if gap > 1.5 * noise:
            fail(f"layers[{label}] layer {i}: kernel-vs-plain gap {gap} "
                 f"beyond 1.5 x the layer's noise {noise}")
        x = yp
    worst = max(r[0] / max(r[1], 1e-30) for r in rows)
    print(f"layers[{label}]: {n_layers} layers each within 1.5 x its own "
          f"one-ulp noise (worst gap/noise {worst:.3f})"
          + (f"; the router's probabilities, kernel against plain path, "
             f"moved by at most {kernel_move:.3g}" if kernel_move else ""),
          flush=True)
    return rows, kernel_move


def attn_layer_runs(torch, cfg, params, rec, decode, seed, patches=0,
                    frames=None, slab=False):
    """(x0, run) for ``layer_by_layer`` over the dense, moe, vlm and
    encoder families' layers (``lm._attn_layer``): a 320-token prefill
    (flash against the plain chunked attention; with ``patches``, that
    many random image patches through the vlm's frontend before 320 -
    patches tokens), the encoder's ``frames`` (B, S, F) through its frame
    frontend (flash not causal against the plain chunked attention), or a
    decode step of 8 slots at 289-373 tokens of context over a random
    bf16 pool (paged attention against the gather path), the step's KV
    rows written before they are read; with ``slab``, over a random bf16
    dense per-slot cache of 1,024 rows a slot (``lm.init_cache``'s, read
    as blocks under identity tables) instead of the pool."""
    from repro_torch.models import common, lm
    from repro_torch.models.attention import identity_tables
    from repro_torch.models.lm import ModelKnobs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    if frames is not None:
        B, S = frames.shape[:2]
        x0 = lm._embed(params, cfg, None, frames)
    else:
        B, S = (8, 1) if decode else (1, 320)
        tok = torch.randint(0, cfg.vocab_size, (B, S - patches), generator=g,
                            device=dev)
        fr = (torch.randn((B, patches, cfg.frontend_dim), generator=g,
                          device=dev).to(torch.bfloat16) if patches else None)
        x0 = lm._embed(params, cfg, tok, fr)
    kw = {}
    if decode:
        bs, mb = 16, 64
        shape = (lm.init_cache_shapes(cfg, B, bs * mb) if slab else
                 lm.init_paged_cache_shapes(cfg, B * mb + 1, bs))["k"]
        kv = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2)]
        tables = (identity_tables(B, bs * mb, dev) if slab else
                  (torch.arange(B * mb, device=dev).reshape(B, mb) + 1
                   ).to(torch.int32))
        pos = torch.tensor([300, 317, 333, 351, 288, 299, 345, 372],
                           dtype=torch.int32, device=dev)
        positions = pos.long()[:, None]
        kw = dict(pos=pos, block_tables=tables, slab=slab,
                  rows=(lm.slab_rows(positions, bs * mb) if slab else
                        lm.paged_rows(positions, tables, bs)))
    else:
        positions = torch.arange(S, device=dev)[None].expand(B, S)
    rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)

    def run(i, x, plain):
        lp = lm._layer(params["layers"], i)
        cache = (kv[0][i], kv[1][i]) if decode else None
        with (plain_path(torch) if plain else contextlib.nullcontext()), \
                rec.active():
            y, _, _ = lm._attn_layer(x, lp, cfg, ModelKnobs(), positions,
                                     rope, cache, **kw)
        return y, rec.take()

    return x0, run


def hybrid_layer_runs(torch, cfg, params, decode, seed):
    """(x0, run) for ``layer_by_layer`` over the hybrid's layers (mamba2,
    then the shared block after layers 0, k, 2k, ...): a 128-token prefill
    of 2 sequences (the scan from zeros and flash against their plain
    versions), or the decode of token 12 of 2 sequences from the state and
    slab of an 11-token prefill (the scan from h0 and paged attention over
    the slab against theirs).  Each run restores the layer's conv, h and
    slab first."""
    from repro_torch.models import common, lm
    from repro_torch.models.attention import identity_tables
    from repro_torch.models.lm import ModelKnobs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    every = cfg.shared_attn_every
    B, S, max_seq = 2, (12 if decode else 128), 16
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    kw, cache = {}, None
    if decode:
        cache = {k: torch.zeros(s, device=dev, dtype=torch.float32
                                if k == "h" else torch.bfloat16)
                 for k, s in lm.init_cache_shapes(cfg, B, max_seq).items()}
        for k, v in lm.forward(params, tok[:, :-1], cfg)[1].items():
            if k.startswith("shared"):
                cache[k][:, :, :v.shape[2]] = v
            else:
                cache[k].copy_(v)
        pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        positions = pos.long()[:, None]
        kw = dict(pos=pos, tables=identity_tables(B, max_seq, dev),
                  rows=lm.slab_rows(positions, max_seq))
        tok = tok[:, -1:]
    else:
        positions = torch.arange(S, device=dev)[None].expand(B, S)
    rope = common.rope_tables(positions, cfg.hd, cfg.rope_theta)
    x0 = params["embed"]["tokens"][tok].to(torch.bfloat16)
    saved = {}

    def run(i, x, plain):
        lp = lm._layer(params["layers"], i)
        a = i // every if i % every == 0 else None
        st = slab = None
        if decode:
            st = {"conv": cache["conv"][i], "h": cache["h"][i]}
            if a is not None:
                slab = (cache["shared_k"][a], cache["shared_v"][a])
            keep = list(st.values()) + list(slab or ())
            if i not in saved:
                saved.clear()
                saved[i] = [t.clone() for t in keep]
            for t, s in zip(keep, saved[i]):
                t.copy_(s)
        with plain_path(torch) if plain else contextlib.nullcontext():
            h, _ = lm.mamba2_block(common.rms_norm(x, lp["ln1"]["scale"],
                                                   cfg.norm_eps),
                                   lp["ssm"], cfg, st)
            y = x + h
            if a is not None:
                y, _ = lm._shared_block(y, params["shared"], cfg,
                                        ModelKnobs(), positions, rope, slab,
                                        **kw)
        return y, None

    return x0, run


# ------------------------------------------------------------ phase 10
def hybrid_parity(torch, cfg, params):
    """Token-by-token decode (S = 1 from the stored state and slab: the
    scan with h0 in place, paged attention over the slab) against one
    prefill of the same sequence (the scan from zeros, flash), at full
    width: 12 tokens of 2 sequences one layer deep (within 2e-2 x the
    logits' scale) and at all 38 layers against a rounding-noise floor
    measured in the run (the decode path against itself with h scaled by
    1 + eps before every step, the largest difference over eps = 2^-22,
    -2^-22 and 2^-21: the random-init model at full depth amplifies a
    perturbation of one f32 ulp to whole logits, so one draw of it
    understates the floor); the same at ``SHALLOW`` layers (the shared
    block twice), where the floor is a small part of the logits; then, at
    both depths, a 288-token prefill of 8 sequences and 12 decode steps
    against one 300-token prefill, whose largest logit difference is the
    served-token check's floor at that depth.  Returns the served-token
    checks' tolerances at full depth and at ``SHALLOW`` layers."""

    from repro_torch.models import lm
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)

    def model(depth):
        return _depth(cfg, params, depth)

    def cache_for(c, B, max_seq, pc=None):
        cache = {k: torch.zeros(s, device=dev, dtype=torch.float32
                                if k == "h" else torch.bfloat16)
                 for k, s in lm.init_cache_shapes(c, B, max_seq).items()}
        if pc is not None:
            for k, v in pc.items():
                if k.startswith("shared"):
                    cache[k][:, :, :v.shape[2]] = v
                else:
                    cache[k].copy_(v)
        return cache

    def decode(c, p, tok, t0, cache, eps=0.0):
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
            fail("hybrid decode logits not finite")
        return out

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
    for depth in (1, SHALLOW, cfg.n_layers):
        c, p = model(depth)
        ref = lm.prefill(p, tok, c)[0][:, -1].float()
        errs[depth] = (decode(c, p, tok, 0, cache_for(c, 2, 16))[:, -1], ref)
    out, ref = errs[1]
    tol1 = BF16_TOL * max(1.0, float(ref.abs().max()))
    err1 = max_err(torch, out, ref)
    if err1 > tol1:
        fail(f"1-layer hybrid decode vs prefill: max abs err {err1} beyond "
             f"{tol1}")
    print(f"parity[{cfg.name}]: decode (S=1 from the stored state and slab) "
          f"vs one prefill of 12 tokens at full width: 1 layer max_abs_err="
          f"{err1:.4g} (bound {tol1:.4g})", flush=True)
    noise_at = {}
    for depth in (SHALLOW, cfg.n_layers):
        c, p = model(depth)
        out, ref = errs[depth]
        noises = [max_err(torch, decode(c, p, tok, 0, cache_for(c, 2, 16),
                                        eps=eps)[:, -1], out)
                  for eps in (2.0 ** -22, -2.0 ** -22, 2.0 ** -21)]
        noise = noise_at[depth] = max(noises)
        tol = BF16_TOL + 1.5 * noise
        err = max_err(torch, out, ref)
        print(f"parity[{cfg.name}]: {depth} layers max_abs_err={err:.4g} "
              f"against a rounding-noise floor of {noise:.4g} "
              f"({', '.join(f'{n:.4g}' for n in noises)}; bound {tol:.4g}), "
              f"|logit| max {float(ref.abs().max()):.3f}", flush=True)
        if err > tol:
            fail(f"{depth}-layer hybrid decode vs prefill: max abs err {err} "
                 f"beyond {tol}")
        agree = near_ties(out, ref, tol, f"{depth}-layer hybrid decode vs "
                          f"prefill")
        print(f"parity[{cfg.name}]: {depth} layers argmax agreement "
              f"{agree:.3f}", flush=True)

    tok = torch.randint(0, cfg.vocab_size, (8, 300), generator=g,
                        device=dev)
    tols = {}
    for depth in (SHALLOW, cfg.n_layers):
        c, p = model(depth)
        ref = lm.logits_fn(p, lm.forward(p, tok, c)[0][:, 288:], c).float()

        def served():
            pc = lm.forward(p, tok[:, :288], c)[1]
            return decode(c, p, tok, 288, cache_for(c, 8, 304, pc))

        floor = max_err(torch, served(), ref)
        tol = tols[depth] = BF16_TOL + 1.5 * max(floor, noise_at[depth])
        agree = near_ties(served(), ref, tol, f"serve-shaped {depth}-layer "
                          f"hybrid decode vs prefill")
        print(f"parity[{cfg.name}]: {depth} layers, 288-token prefill + 12 "
              f"decode steps of 8 rows vs one 300-token prefill: "
              f"max_abs_err={floor:.4g} (the served-token check's floor; "
              f"bound {tol:.4g}), argmax agreement {agree:.3f}", flush=True)
    return tols[cfg.n_layers], tols[SHALLOW]


SHALLOW = 7     # hybrid layers with the shared block twice (after 0 and 6)


def _depth(cfg, params, depth):
    """The model cut to its first ``depth`` layers (the shared block and
    the embeddings whole)."""
    import dataclasses
    return (dataclasses.replace(cfg, n_layers=depth),
            dict(params, layers=_slice(params["layers"], depth)))


def hybrid_shallow(torch, cfg, params, tol):
    """The serve and its speculative arm at ``SHALLOW`` layers, where the
    random-init model's decode-vs-prefill floor is a small part of the
    logits (at 38 layers it is the logits' own size): every served token
    within ``tol`` of the prefill path's argmax (tie-aware), and the
    spec_k = 2 arm's tokens those of the spec_k = 0 arm.  Returns the
    kernel launches of both arms."""
    from repro_torch.serving import DEFAULT_SERVING_SETTING
    c, p = _depth(cfg, params, SHALLOW)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=8, cache_dtype="bf16")
    _, done, _, la = serve_arm(torch, c, p, setting, hybrid_trace(c),
                               f"zamba2 {SHALLOW} layers")
    check_tokens(torch, c, p, done, tol)
    _, sdone, sstats, ls = serve_arm(
        torch, c, p, dict(setting, spec_k=2.0, drafter="truncated"),
        hybrid_trace(c), f"zamba2 {SHALLOW} layers spec_k=2 truncated")
    same_tokens(torch, c, p, f"spec[zamba2 {SHALLOW} layers]", sdone, done,
                tol)
    return {k: la[k] + ls[k] for k in la}


def hybrid_trace(cfg):
    from repro_torch.serving.workload import make_trace
    return make_trace("mixed_lengths", 400.0, 0.04, vocab=cfg.vocab_size,
                      seed=10, short_lens=(16, 96), long_lens=(256, 512),
                      long_frac=0.25, max_news=(32, 32))


def hybrid_relayout(torch, cfg, params, ref, tol):
    """max_batch 8 -> 4 while 8 are live (held, shrunk after the drain) and
    back to 8 with live requests, then cache_dtype bf16 -> f32: after each
    switch the decode graph's replay equals its eager step; every
    relocated conv row and slab row is its old value in f32 and h is
    unchanged; the tokens are the plain serve's (tie-aware).  Returns the
    kernel launches of the drive."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import DEFAULT_SERVING_SETTING, ServingEngine
    dev = torch.device("cuda")
    reqs = [r for r in hybrid_trace(cfg) if len(r.prompt) <= 96]
    eng = ServingEngine(params, cfg, dict(DEFAULT_SERVING_SETTING,
                                          max_batch=8, cache_dtype="bf16"),
                        max_seq=1024, device=dev)
    eng.warm_start(max_prompt=96)
    seen = {}

    def shrink(e):
        seen["shrink"] = e.apply_plan(reconfig_plan(e, max_batch=4))
        seen["held"] = e.n_slots
        replay_check(torch, e, "hybrid shrink held")

    def grow(e):
        if "grow" in seen or e.n_slots != 4 or not e.n_active:
            return
        seen["grow"] = e.apply_plan(reconfig_plan(e, max_batch=8))
        replay_check(torch, e, "hybrid grow")
        seen["slots"] = e.n_slots

    def to_f32(e):
        if "grow" not in seen or "dtype" in seen or not e.n_active:
            return
        live = sorted(i for i, r in enumerate(e.slot_req) if r is not None)
        before = {k: v[:, live].clone() for k, v in e.pool.state.items()}
        seen["dtype"] = e.apply_plan(reconfig_plan(e, cache_dtype="f32"))
        n = 0
        for k, v in before.items():
            new = e.pool.state[k][:, :len(live)]
            if new.dtype != torch.float32 or not torch.equal(
                    new, v.to(torch.float32)):
                fail(f"reconfig[hybrid dtype]: the relocated {k} rows are "
                     f"not the old rows in f32")
            n += v.numel()
        seen["values"] = n
        replay_check(torch, e, "hybrid dtype")

    hooks = {t: (lambda e: (grow(e), to_f32(e))) for t in range(3, 400)}
    hooks[2] = shrink
    reset_launches()
    done = drive(eng, reqs, hooks)
    launches = dict(LAUNCHES)
    if seen.get("held") != 8 or seen.get("slots") != 8 or "dtype" not in seen:
        fail(f"reconfig[hybrid]: switches {seen}")
    same_tokens(torch, cfg, params, "reconfig[hybrid]", done,
                [ref[r.rid] for r in reqs], tol, "plain serve")
    print(f"reconfig[hybrid max_batch 8->4->8, bf16->f32]: apply_plan "
          f"{seen['shrink']:.4f}s with 8 live (held at 8 slots, shrunk after "
          f"the drain), {seen['grow']:.4f}s back to 8, {seen['dtype']:.4f}s "
          f"to f32 ({seen['values']} relocated conv, h and slab values equal "
          f"their old values in f32); replays equal their eager steps",
          flush=True)
    return launches


def hybrid_store(torch, cfg, card):
    """Two self-tuned serves (``launch/serve.py --selftune --tuning-store
    DIR``, Poisson 20 req/s for 6 s, prompts of 4-128 tokens, 4-32 new) on
    one fresh store under build/smoke/: the first writes observations,
    compacts the store and writes GOLDEN.json; the second starts from the
    golden incumbent (exact tier), absorbs its observations and skips init
    settings.  Each run's output goes to build/smoke/; its warm start,
    init quanta and seconds, tok/s and TTFT p50 are printed.  Returns the
    kernel launches of both runs."""
    import io

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve as launch_serve
    out_dir = ROOT / "build" / "smoke"
    store = out_dir / "hybrid_tuning_store"
    shutil.rmtree(store, ignore_errors=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    total = dict.fromkeys(LAUNCHES, 0)
    runs = []
    for i in (1, 2):
        stats_path = out_dir / f"hybrid_store_run{i}.json"
        args = ["--arch", cfg.name, "--selftune", "--tuning-store",
                str(store), "--scenario", "poisson", "--rate", "20",
                "--duration", "6", "--max-seq", "1024", "--prompt-len",
                "128", "--gen", "32", "--json-out", str(stats_path)]
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            launch_serve.main(args)
        wall = time.perf_counter() - t0
        gc.collect()                     # the run's model and engine
        torch.cuda.empty_cache()
        for k, n in LAUNCHES.items():
            total[k] += n
        text = buf.getvalue()
        (out_dir / f"hybrid_store_run{i}.log").write_text(text)
        stats = json.loads(stats_path.read_text())
        ws = stats.get("warm_start") or {}
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("tuning-store", "served", "latency"))]
        for ln in lines:
            print(f"store[run {i}]: {ln}", flush=True)
        if stats["completed"] != stats["requests"]:
            fail(f"store[run {i}]: {stats['completed']}/{stats['requests']} "
                 f"requests completed")
        if not text.rstrip().endswith("OK"):
            fail(f"store[run {i}]: the launcher did not end in OK")
        runs.append((stats, ws))
        print(f"store[run {i}]: {stats['completed']}/{stats['requests']} "
              f"requests, {stats['tokens_per_s']:.1f} tok/s, ttft p50 "
              f"{stats['p50_ttft_s']:.4f}s, tuner init phase "
              f"{stats['tuner_init_quanta']} quanta in "
              f"{stats['tuner_init_time_s']:.4f}s, warm start {ws}, "
              f"{stats['reconfig_count']} reconfigurations, final setting "
              f"{stats['final_setting']}; {wall:.1f}s with start-up on "
              f"{card}", flush=True)
    first, (second, ws) = runs[0][0], runs[1]
    if not (store / "GOLDEN.json").exists():
        fail("store: the first run wrote no GOLDEN.json")
    text2 = (out_dir / "hybrid_store_run2.log").read_text()
    if "golden incumbent" not in text2 or "(exact match" not in text2:
        fail("store: the second run did not start from the golden "
             "incumbent at the exact tier")
    if not (ws.get("tier") == "exact" and ws.get("absorbed_obs", 0) > 0
            and ws.get("init_settings_skipped", 0) > 0):
        fail(f"store: the second run's warm start {ws}")
    print(f"store: the warm-started run's init phase "
          f"{second['tuner_init_quanta']} quanta / "
          f"{second['tuner_init_time_s']:.4f}s against the first run's "
          f"{first['tuner_init_quanta']} / {first['tuner_init_time_s']:.4f}s",
          flush=True)
    return total


def hybrid_path(torch, card):
    """Phase 10 on full-width zamba2-1.2b.  Returns the launch counts of
    the hybrid path's kernels (the serve arms, the relayout drive and the
    two store runs)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.serving import DEFAULT_SERVING_SETTING
    t0 = time.perf_counter()
    cfg = get_config("zamba2-1.2b")
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {cfg.name} full width, {n_params / 1e9:.3f} B params "
          f"bf16 ({cfg.n_layers} mamba2 layers, d_inner {cfg.d_inner}, "
          f"{cfg.n_ssm_heads} heads x {cfg.ssm_head_dim}, N "
          f"{cfg.ssm_state}; the shared block {lm.n_shared_apps(cfg)} "
          f"times), init {time.perf_counter() - t0:.1f}s", flush=True)
    tol, tol_shallow = hybrid_parity(torch, cfg, params)
    for decode, what in ((True, "decode: scan from h0 + paged over the slab "
                                "vs plain"),
                         (False, "prefill: scan + flash vs plain")):
        x0, run = hybrid_layer_runs(torch, cfg, params, decode, seed=33)
        layer_by_layer(torch, f"{cfg.name} {what}", x0, cfg.n_layers, run)
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=8, cache_dtype="bf16")
    spans = LaunchSpans(LAUNCHES)
    eng, done, stats, la = serve_arm(torch, cfg, params, setting,
                                     hybrid_trace(cfg), "zamba2 bf16",
                                     tracer=spans)
    kernels = ("selective_scan", "flash_attention", "paged_attention")
    by = {k: {n: v[n] for n in kernels} for k, v in spans.by_span.items()
          if k in ("serve.prefill", "serve.decode")}
    print(f"serve[zamba2 bf16]: launches by span {by}", flush=True)
    pre, dec = by.get("serve.prefill", {}), by.get("serve.decode", {})
    if not (pre.get("selective_scan") and pre.get("flash_attention")
            and dec.get("selective_scan") and dec.get("paged_attention")):
        fail(f"the hybrid serve did not run the scan and flash in prefill "
             f"and the scan and paged attention in decode: {by}")
    check_tokens(torch, cfg, params, [done[0], done[1], max(
        done, key=lambda r: len(r.prompt))], tol)
    print(f"serve[zamba2 bf16]: {stats['tokens_per_s']:.1f} tok/s, ttft p50 "
          f"{stats['p50_ttft_s']:.4f}s, decode "
          f"{stats['decode_tok_per_s']:.1f} tok/s on {card}; peak device "
          f"memory in the serve "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    g = fill_pool(torch, eng, 17)
    check_graphs(torch, eng, "zamba2-1.2b",
                 step_cases(torch, eng, cfg, g, spec=True))
    profile_decode(torch, eng, cfg, g)
    del eng
    spans = LaunchSpans(LAUNCHES)
    _, sdone, sstats, ls = serve_arm(
        torch, cfg, params, dict(setting, spec_k=2.0, drafter="truncated"),
        hybrid_trace(cfg), "zamba2 spec_k=2 truncated", tracer=spans)
    by = {k: {n: v[n] for n in kernels} for k, v in spans.by_span.items()
          if k.startswith("decode.")}
    print(f"spec[zamba2]: launches by span {by} (decode.verify at S = 3, "
          f"decode.rollback = _ssm_replay from the snapshot of conv and h "
          f"at S = 1-2, decode.draft = the truncated drafter's prefill: 19 "
          f"layers, the shared block 4 times)", flush=True)
    ver, rb = by.get("decode.verify", {}), by.get("decode.rollback", {})
    dr = by.get("decode.draft", {})
    if not (ver.get("selective_scan") and ver.get("paged_attention")
            and rb.get("selective_scan") and dr.get("selective_scan")
            and dr.get("flash_attention")):
        fail(f"the hybrid spec arm did not verify, replay and draft through "
             f"the kernels: {by}")
    same_tokens(torch, cfg, params, "spec[zamba2]", sdone, done, tol)
    lr = hybrid_relayout(torch, cfg, params, {r.rid: r for r in done}, tol)
    lh = hybrid_shallow(torch, cfg, params, tol_shallow)
    lt = hybrid_store(torch, cfg, card)
    launches = {k: la[k] + ls[k] + lr[k] + lh[k] + lt[k] for k in kernels}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"the hybrid path never launched {missing}: {launches}")
    print(f"hybrid: phase 10 in {time.perf_counter() - t0:.1f}s, launches "
          f"{launches}", flush=True)
    return launches


# --------------------------------------------- phase 3 (moe and vlm shapes)
MOE_H, MOE_K = 40, 8               # llama4-scout: 40 q / 8 kv heads, G = 5
VLM_H, VLM_HD = 32, 96             # phi-3-vision: 32 q = 32 kv heads of hd
                                   # 96, G = 1


def check_group_kernels(torch, rows, tag, H_, K_, hd, seed):
    """The attention kernels at one model's heads (H_ q / K_ kv heads of
    ``hd``), against their plain versions, then timed beside their bounds
    (printed ``kernel ...[tag ...]`` lines; the kernels line keeps each
    kernel's first row and the largest error):

    - paged attention, decode (8, 1, H_, hd) and verify (8, 4, H_, hd)
      over (NB, 16, K_, hd) bf16 and f32 pools, and a suffix prefill of
      S = 64 over a 256-token prefix;
    - the flash forward at (1, 320, H_ / K_, hd) (the vlm's 64 patches
      and 256 tokens), and at the training shape (4, 512, H_ / K_, hd)
      with the rows' log-sum-exp;
    - the flash backward at the training shape, where a cluster splits a
      kv head's G query heads over P CTAs (P the largest divisor of G up
      to 4: 1 at G = 5 and G = 1; tiles of 128 columns at hd 96): bit for
      bit across two calls, timed whole and by launch beside SDPA's
      backward."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    G = H_ // K_
    P = max(p for p in range(1, min(G, 4) + 1) if G % p == 0)
    geo = f"H={H_} K={K_} hd={hd} G={G}"
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def pool(B, pool_dt, bs=16, max_seq=1024):
        mb = max_seq // bs
        nb = B * mb + 1
        bt = (torch.randperm(nb - 1, generator=g, device=dev)[:B * mb]
              .reshape(B, mb) + 1).to(torch.int32)
        return randn((nb, bs, K_, hd), pool_dt), randn((nb, bs, K_, hd),
                                                       pool_dt), bt

    pos8 = [300, 317, 333, 351, 288, 299, 345, 372]
    err = 0.0
    for B, S, pool_dt, pos in [(8, 1, bf16, pos8), (8, 4, bf16, pos8),
                               (8, 1, f32, [0, 15, 16, 255, 256, 600, 999,
                                            1000]),
                               (8, 4, f32, pos8), (1, 64, bf16, [256])]:
        kp, vp, bt = pool(B, pool_dt)
        q = randn((B, S, H_, hd))
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        for _ in range(2):               # the split counters return to 0
            out = paged_attention(q, kp, vp, bt, p)
            torch.cuda.synchronize()
            err = max(err, check_close(
                torch, f"paged_attention {tag} {geo} B={B} S={S} "
                f"pool={pool_dt}", out, paged_attention_ref(q, kp, vp, bt, p),
                BF16_TOL))
    rows["paged_attention"]["max_abs_err"] = max(
        rows["paged_attention"]["max_abs_err"], err)
    for B, S, pos in [(8, 1, pos8), (8, 4, pos8), (1, 64, [256])]:
        kp, vp, bt = pool(B, bf16)
        q = randn((B, S, H_, hd))
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        cols = ((max(pos) + S - 1) // 16 // 11 + 1) * 11   # a 1/6 bucket
        ms = timed_ms(torch, lambda: paged_attention(q, kp, vp, bt, p,
                                                     ctx_cols=cols))
        plain = timed_ms(torch, lambda: paged_attention_ref(
            q, kp, vp, bt[:, :cols], p))
        seen = sum(x + S for x in pos)
        pairs = sum(x + j + 1 for x in pos for j in range(S))
        b = bound(seen * K_ * hd * 2 * 2 + 2 * q.numel() * 2
                  + bt[:, :cols].numel() * 4, 4 * pairs * H_ * hd,
                  BF16_FLOPS)
        print(f"kernel paged_attention[{tag} B={B} S={S} {geo} bs=16 bf16 "
              f"pool, ctx {min(pos) + 1}-{max(pos) + S}, ctx_cols={cols}]: "
              f"kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms=n/a "
              f"bound_ms={b[0]:.4f} ({b[1]})", flush=True)

    err = 0.0
    for S, kc in [(37, 128), (320, 128), (320, 256), (1000, 128)]:
        q, k, v = randn((1, S, H_, hd)), randn((1, S, K_, hd)), randn(
            (1, S, K_, hd))
        out = flash_attention(q, k, v, block_k=kc)
        torch.cuda.synchronize()
        err = max(err, check_close(torch, f"flash_attention {tag} {geo} "
                                   f"S={S}", out, attention_ref(q, k, v),
                                   BF16_TOL))
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], err)
    for B, S, lse in [(1, 320, False), (4, 512, True)]:
        q, k, v = randn((B, S, H_, hd)), randn((B, S, K_, hd)), randn(
            (B, S, K_, hd))
        pos = torch.arange(S, device=dev)[None].expand(B, S)
        if lse:
            o, l_ = flash_attention(q, k, v, pos, pos, return_lse=True)
            e = float((l_ - attention_lse_ref(q, k, pos, pos)).abs().max())
            if e > LSE_TOL * max(1.0, float(l_.abs().max())):
                fail(f"flash lse {tag} B={B} S={S}: max abs err {e}")
        ms = timed_ms(torch, lambda: flash_attention(q, k, v, pos, pos,
                                                     return_lse=lse))
        plain = timed_ms(torch, lambda: attention_ref(q, k, v, pos, pos))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = timed_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                           enable_gqa=G > 1))
        b = bound((2 * q.numel() + k.numel() + v.numel()) * 2
                  + B * H_ * S * 4 * lse, 4 * B * H_ * hd * S * (S + 1) / 2,
                  BF16_FLOPS)
        print(f"kernel flash_attention[{tag} B={B} S={S} {geo} bf16"
              f"{', with lse' if lse else ''}]: kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} (SDPA) "
              f"bound_ms={b[0]:.4f} ({b[1]})", flush=True)

    # the backward at the training shape
    B, S = TRAIN_B, TRAIN_S
    q, k, v, do = (randn((B, S, h, hd)) for h in (H_, K_, K_, H_))
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    out, lse = flash_attention(q, k, v, pos, pos, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, do, lse, pos, pos)
    again = flash_attention_bwd(q, k, v, out, do, lse, pos, pos)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"flash_attention_bwd {tag}: two calls differ")
    err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got,
                          attention_bwd_ref(q, k, v, do, pos, pos)):
        e = float((a.float() - b.float()).abs().max()
                  / b.float().abs().max())
        if not torch.isfinite(a.float()).all() or e > BWD_RTOL:
            fail(f"flash_attention_bwd {tag} {name}: max err {e} of the "
                 f"largest |value| (bound {BWD_RTOL})")
        err = max(err, float((a.float() - b.float()).abs().max()))
    rows["flash_attention_bwd"]["max_abs_err"] = max(
        rows["flash_attention_bwd"]["max_abs_err"], err)
    ms = timed_ms(torch, lambda: flash_attention_bwd(q, k, v, out, do, lse,
                                                     pos, pos))
    plain = timed_ms(torch, lambda: attention_bwd_ref(q, k, v, do, pos, pos))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=G > 1)
    lib = timed_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    per = launch_ms(torch, lambda: flash_attention_bwd(
        q, k, v, out, do, lse, pos, pos), r"flash_bwd_(dq|dkdv)_kernel")
    pairs = B * H_ * S * (S + 1) / 2
    big, small = B * S * H_ * hd * 2, B * S * K_ * hd * 2
    b = bound(4 * big + 4 * small + B * H_ * S * 4, 10 * hd * pairs,
              BF16_FLOPS)
    print(f"kernel flash_attention_bwd[{tag} training B={B} S={S} {geo}, "
          f"P={P} CTA{'s' if P > 1 else ''} a cluster]: max_abs_err="
          f"{err:.3g} (within {BWD_RTOL} of the largest |gradient|, bit for "
          f"bit across two calls) kernel_ms={ms:.4f}"
          + "".join(f" {n}_ms={t:.4f}" for n, t in sorted(per.items()))
          + f" plain_ms={plain:.4f} library_ms={lib:.4f} (SDPA backward) "
          f"bound_ms={b[0]:.4f} ({b[1]})", flush=True)


# ------------------------------------------------------------ phase 11
MOE_DEPTH = 12                     # llama4-scout's 48 layers cut to 12
MOE_SHALLOW = 2                    # the token checks' depth (see moe_path)
MOE_TRAIN_DEPTH = 1                # training: one layer (Adam state)


class AdmitLog(LaunchSpans):
    """``LaunchSpans`` that also records, for each admitted request, how
    many prompt tokens it took from the prefix cache (0: prefilled whole;
    s > 0: its suffix prefilled against s shared tokens)."""

    def __init__(self, launches):
        super().__init__(launches)
        self.shared: dict = {}
        self._rid = None

    @contextlib.contextmanager
    def span(self, name, **kw):
        if name == "serve.admit":
            self._rid = kw.get("rid")
        elif name == "serve.prefill":
            self.shared[self._rid] = 0
        elif name == "serve.chunk_prefill":
            self.shared[self._rid] = kw["shared"]
        with super().span(name, **kw):
            yield


def moe_replay(torch, cfg, params, reqs, everyone, shared, setting, tol,
               label, margin=0.0):
    """The served tokens of ``reqs`` against a replay of the engine's
    computation on the plain paths, outside the engine (no pool, no graphs,
    no kernels): each prompt prefilled as the engine prefilled it — whole,
    right-padded to its bucket, or its suffix padded to its bucket against
    the first s rows of the prefill of the request that put that prefix in
    the cache (the first request of ``everyone`` prefilled whole with the
    same first s tokens) — then the served tokens fed back one decode step
    at a time, all requests in one batch, through the gather path.  A
    moe layer routes a prefill's tokens together and drops the pairs past
    an expert's capacity, so a prefill of other tokens, or of the same
    tokens in another group, is a different computation: the replay keeps
    the engine's groups.  Decode groups (a tick's live slots, at most 16
    tokens) never drop.  Every served token must be within ``tol`` of the
    replay's largest logit at its position (tie-aware), unless the token
    that produced that position's logits had, in some layer of the replay,
    a router margin (the chosen experts' least probability minus the
    next) within ``margin``: there rounding alone can choose another
    expert, as the per-layer check measures, and the position's logits are
    another computation's; such positions are counted and printed.
    Prints how many prompt tokens lost an expert to capacity in the
    replayed prefills."""
    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    dev = torch.device("cuda")
    bs, max_seq, chunk = 16, 1024, setting["prefill_chunk"]
    mb = max_seq // bs
    kn = ModelKnobs(k_chunk=setting["k_chunk"])
    n = len(reqs)
    shape = lm.init_paged_cache_shapes(cfg, n * mb + 1, bs)["k"]
    cache = {k: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
             for k in "kv"}
    tables = (torch.arange(n * mb, device=dev).reshape(n, mb) + 1).to(
        torch.int32)
    cache["block_tables"] = tables
    rec = RouteRecorder(torch)
    first, first_m, dropped, prompt_toks = [], [], 0, 0
    k = cfg.moe_top_k

    def margins(rows):
        """The least router margin over the layers' recorded calls of the
        token rows ``rows`` of each call: (len(rows),)."""
        out = None
        for probs, _, _ in rec.calls:
            srt = probs[rows].sort(-1, descending=True).values
            m = srt[:, k - 1] - srt[:, k]
            out = m if out is None else torch.minimum(out, m)
        rec.calls.clear()
        return out

    def padded(toks):
        b = min(-(-len(toks) // chunk) * chunk, max_seq)
        t = torch.zeros((1, b), dtype=torch.long, device=dev)
        t[0, :len(toks)] = torch.as_tensor(np.asarray(toks), device=dev)
        return t

    with plain_path(torch), rec.active():
        for i, r in enumerate(reqs):
            P, s = len(r.prompt), shared[r.rid]
            src = r.prompt if s == 0 else next(
                o.prompt for o in sorted(everyone, key=lambda o: o.rid)
                if shared.get(o.rid) == 0
                and len(o.prompt) >= s
                and np.array_equal(o.prompt[:s], r.prompt[:s]))
            hidden, pc = lm.forward(params, padded(src), cfg, kn,
                                    mode="prefill")
            for _, _, keep in rec.calls:
                dropped += int((~keep[:len(src)]).any(-1).sum())
            prompt_toks += len(src) * cfg.n_layers
            if s == 0:
                m0 = margins([P - 1])
            rec.calls.clear()
            m = P if s == 0 else s
            rows = lm.paged_rows(torch.arange(m, device=dev)[None],
                                 tables[i:i + 1], bs)
            for name in "kv":
                cache[name][:, rows[0][0], rows[1][0]] = pc[name][:, 0, :m]
            if s == 0:
                lg = lm.logits_fn(params, hidden[:, P - 1:P], cfg)[0, 0]
            else:
                sfx = padded(r.prompt[s:])
                sub = dict(cache, block_tables=tables[i:i + 1])
                out, _ = lm.decode_step(params, sub, sfx, torch.tensor(
                    [s], dtype=torch.int32, device=dev), cfg, kn)
                lg = out[0, P - s - 1]
                for _, _, keep in rec.calls:
                    dropped += int((~keep[:P - s]).any(-1).sum())
                prompt_toks += (P - s) * cfg.n_layers
                m0 = margins([P - s - 1])
            first.append(lg.float())
            first_m.append(m0)
        steps, mins = [torch.stack(first)], [torch.cat(first_m)]
        gen = len(reqs[0].tokens_out)
        for j in range(1, gen):
            tok = torch.tensor([[r.tokens_out[j - 1]] for r in reqs],
                               device=dev)
            pos = torch.tensor([len(r.prompt) + j - 1 for r in reqs],
                               dtype=torch.int32, device=dev)
            out, _ = lm.decode_step(params, cache, tok, pos, cfg, kn)
            steps.append(out[:, 0].float())
            mins.append(margins(list(range(n))))
    lg = torch.stack(steps, 1)                                # (n, gen, V)
    ambiguous = torch.stack(mins, 1) <= margin                # (n, gen)
    if not torch.isfinite(lg).all():
        fail(f"{label}: replayed logits not finite")
    got = torch.tensor([r.tokens_out for r in reqs], device=dev)
    gap = lg.max(-1).values - lg.gather(-1, got[..., None])[..., 0]
    exact = int((gap == 0).sum())
    off = gap > tol
    excused = int((off & ambiguous).sum())
    worst = float((gap * ~(off & ambiguous)).max())
    print(f"{label}: {exact}/{gap.numel()} served tokens of {n} requests are "
          f"the replay's argmax, worst logit gap {worst:.4g} (tolerance "
          f"{tol:.4g}) beside {excused} beyond it at positions whose token "
          f"had a router margin within {margin:.3g} in some layer (of "
          f"{int(ambiguous.sum())} such positions; largest gap there "
          f"{float((gap * ambiguous).max()):.4g}); {dropped} of "
          f"{prompt_toks} (token, layer) pairs of the replayed prefills lost "
          f"an expert to capacity", flush=True)
    mins = torch.stack(mins, 1)
    for r, j in torch.nonzero(off).tolist()[:8]:
        print(f"{label}:   request {reqs[r].rid} token {j}: gap "
              f"{float(gap[r, j]):.4g}, least router margin "
              f"{float(mins[r, j]):.3g}", flush=True)
    if worst > tol:
        fail(f"{label}: served tokens disagree with the replay: logit gap "
             f"{worst} > {tol}")


def moe_serve(torch, cfg, params, card, tol, margin, full=True):
    """Phase 11's serving on llama4-scout at full width and ``cfg``'s
    depth: the shared_prefix bf16 arm (prefill through flash, suffix
    prefill and decode through paged attention at G = 5, copy-on-write)
    and a spec_k = 3 arm, every served token held to the replay
    (``moe_replay``, within ``tol`` outside router margins within
    ``margin``); with ``full`` also an int8 arm, the graph checks and the
    decode profile (the expert products' share against the weight read).

    The spec arm verifies 4 tokens a slot.  With ``full`` it has 8 slots,
    32 tokens a verify step: past the capacity's small-step floor of 16,
    so a verify step can drop pairs (idle slots and rejected drafts take
    capacity too, as in the JAX engine) and its tokens are not the plain
    arm's by construction; without ``full`` it has 4 slots, 16 tokens a
    step, which never drop, and the replay holds it like the plain arm.
    Returns the arms' launches."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.serving import DEFAULT_SERVING_SETTING
    from repro_torch.serving.workload import make_trace
    share = dict(DEFAULT_SERVING_SETTING, max_batch=8, block_size=16,
                 cache_dtype="bf16", prefix_share=True)
    tag = f"moe {cfg.n_layers} layers"
    log = AdmitLog(LAUNCHES)
    eng, done, stats, la = serve_arm(torch, cfg, params, share,
                                     dense_trace(cfg), f"{tag} bf16",
                                     tracer=log)
    by = {k: {n: v[n] for n in ("flash_attention", "paged_attention")}
          for k, v in log.by_span.items()
          if k in ("serve.prefill", "serve.chunk_prefill", "serve.decode")}
    print(f"serve[{tag} bf16]: launches by span {by}; {stats['cow_copies']} "
          f"COW copies; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    if not (by.get("serve.prefill", {}).get("flash_attention")
            and by.get("serve.chunk_prefill", {}).get("paged_attention")
            and by.get("serve.decode", {}).get("paged_attention")
            and stats["cow_copies"]):
        fail(f"the moe serve did not run flash in prefill and paged "
             f"attention in suffix prefill and decode, or made no COW copy: "
             f"{by}")
    moe_replay(torch, cfg, params, done, done, log.shared, share, tol,
               f"tokens[{tag} bf16]", margin)
    launches = {k: la[k] for k in DENSE_KERNELS}
    if full:
        trace8 = make_trace("shared_prefix", 400.0, 0.015,
                            vocab=cfg.vocab_size, seed=100, prefix_len=192,
                            tail_lens=(8, 48), max_news=(8, 8))
        eng8, _, _, lb = serve_arm(torch, cfg, params,
                                   dict(share, quant="int8"), trace8,
                                   f"{tag} int8")
        quant_roundtrip(torch, eng8, cfg)
        g = fill_pool(torch, eng, 7)
        check_graphs(torch, eng, cfg.name, step_cases(torch, eng, cfg, g,
                                                      quant_eng=eng8))
        prof = profile_decode(torch, eng, cfg, g)
        experts = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * 2 * cfg.n_layers
        rest = sum(t.numel() * t.element_size() for t in _leaves(params)) - (
            experts + params["embed"]["tokens"].numel() * 2)
        print(f"profile[{cfg.name}]: expert GEMMs (bmm, eager step) "
              f"{prof['bmm_ms']:.3f} ms a step beside {prof['busy_ms']:.3f} "
              f"ms of kernels a graph step; every expert's weights "
              f"({experts / 1e9:.2f} GB) read at 3.35 TB/s take "
              f"{experts / HBM_BYTES_PER_S * 1e3:.3f} ms, the other weights "
              f"({rest / 1e9:.2f} GB) {rest / HBM_BYTES_PER_S * 1e3:.3f} ms: "
              f"the step's weight-read bound "
              f"{(experts + rest) / HBM_BYTES_PER_S * 1e3:.3f} ms against "
              f"{prof['wall_ms']:.3f} ms wall", flush=True)
        for k in DENSE_KERNELS:
            launches[k] += lb[k]
        del eng8
    del eng
    log = AdmitLog(LAUNCHES)
    from repro_torch.models.moe import _capacity
    slots = 8 if full else 4
    cap = _capacity(4 * slots, cfg.moe_top_k, cfg.n_experts,
                    cfg.capacity_factor)
    _, sdone, sstats, lc = serve_arm(
        torch, cfg, params, dict(share, spec_k=3.0, drafter="ngram",
                                 max_batch=slots),
        dense_trace(cfg), f"{tag} bf16 spec_k=3 ngram {slots} slots",
        tracer=log)
    ver = log.by_span.get("decode.verify", {}).get("paged_attention", 0)
    print(f"spec[{tag}]: paged_attention launches in decode.verify (S = 4 "
          f"at {slots} slots: {4 * slots} tokens a step against a capacity "
          f"of {cap} an expert) {ver}; "
          f"{sstats['speculation']}", flush=True)
    if not ver:
        fail("the moe spec arm did not verify through paged attention")
    want = {r.rid: r.tokens_out for r in done}
    differ = [r for r in sdone if r.tokens_out != want[r.rid]]
    print(f"spec[{tag}]: {len(sdone) - len(differ)}/{len(sdone)} requests "
          f"served exactly the spec_k=0 arm's tokens", flush=True)
    if differ:
        moe_replay(torch, cfg, params, differ, sdone, log.shared, share, tol,
                   f"spec[{tag}] requests that differ", margin)
    for k in DENSE_KERNELS:
        launches[k] += lc[k]
    return launches


def moe_train(torch, card):
    """Phase 11's training on llama4-scout at full width cut to one layer
    (4.15 B parameters; their Adam state, 4 x 512 tokens a step): one
    step's loss (the router aux in it) and gradients, the kernel path
    (flash forward and backward at G = 5, P = 1) against the plain path on
    the same parameters and batch, within a measured rounding-noise floor
    as in phase 9, the plain runs pinned to the kernel run's expert
    choices (``RouteRecorder.pinned``: a router near-tie that the two
    paths' rounding breaks apart moves a token's whole gradient to another
    expert, up to 0.94 of a leaf's largest value on an H100, so unpinned
    the comparison measures the ties, not the kernels); then fixed-setting
    steps in which
    the loss falls (step time, tokens/s, peak memory) and one step with the
    int8 push (one quantize and dequantize a leaf).  Returns the launches
    of the runs."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import flatten, leaves
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, LMJob
    from repro_torch.ps.stepfn import _grads
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_layers=MOE_TRAIN_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device="cuda")
    batch = next(lm_batch_iterator(cfg, TRAIN_B, TRAIN_S, seed=0))

    def run():
        loss, aux, g = _grads(params, batch, cfg, ModelKnobs())
        return float(loss), float(aux["aux"]), flatten(g)

    rec = RouteRecorder(torch)
    before = LAUNCHES["flash_attention_bwd"]
    with rec.active():
        k_loss, k_aux, (names, k_g) = run()
    if LAUNCHES["flash_attention_bwd"] - before != cfg.n_layers:
        fail("moe train parity: the flash backward did not run once a layer")
    routes = [topi for _, topi, _ in rec.calls]
    with plain_attention(torch), rec.pinned(routes):
        p_loss, p_aux, (_, p_g) = run()
    flips = rec.flips
    with plain_attention(torch, eps=2.0 ** -20), rec.pinned(routes):
        n_loss, n_aux, (_, n_g) = run()

    def worst(a, b):
        return max((float((x.float() - y.float()).abs().max()
                          / y.float().abs().max().clamp_min(1e-30)), n)
                   for x, y, n in zip(a, b, names))

    (err, leaf), (noise, _) = worst(k_g, p_g), worst(n_g, p_g)
    tol = TRAIN_GRAD_TOL + 1.5 * noise
    lerr, lnoise = abs(k_loss - p_loss), abs(n_loss - p_loss)
    ltol = TRAIN_LOSS_TOL + 1.5 * lnoise
    print(f"parity[train moe {cfg.n_layers} layer]: loss kernel {k_loss:.6f} "
          f"plain {p_loss:.6f} (|diff| {lerr:.3g}, floor {lnoise:.3g}, bound "
          f"{ltol:.3g}), router aux {k_aux:.6f} / {p_aux:.6f}; gradients: "
          f"worst leaf ({leaf}) max err {err:.4g} of its largest |value| "
          f"against a rounding-noise floor of {noise:.4g} (bound "
          f"{tol:.4g}); the plain run's own expert choice differed for "
          f"{flips} of {TRAIN_B * TRAIN_S} tokens (pinned to the kernel "
          f"run's)", flush=True)
    if not (err <= tol and lerr <= ltol and k_aux > 0) or any(
            not torch.isfinite(x.float()).all() for x in k_g):
        fail("moe train parity")
    del params, k_g, p_g, n_g
    gc.collect()
    torch.cuda.empty_cache()

    job = LMJob(cfg, batch=TRAIN_B, seq=TRAIN_S)
    state = job.init_state(DEFAULT_LM_SETTING, seed=0)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    step = job.step_builder(DEFAULT_LM_SETTING)
    batches = job.batches(0)
    losses, walls, evs = [], [], []
    reset_launches()
    for _ in range(MOE_TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step(state, next(batches))
        b.record()
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        evs.append(a.elapsed_time(b))
    launches = dict(LAUNCHES)
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not np.isfinite(losses).all() or not last < first:
        fail(f"moe fixed run: the loss did not fall ({first} -> {last})")
    state, pwall, busy, top, groups = _profile_steps(torch, step, state,
                                                     batches, steps=2)
    opt_ms = time_optimizer(torch, job, state, reps=2)
    wall, ev = float(np.median(walls[2:])), float(np.median(evs[2:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = cfg.n_params()
    print(f"train[moe fixed]: {cfg.name} full width at {cfg.n_layers} layer "
          f"({n / 1e9:.3f} B params, {cfg.n_active_params() / 1e9:.3f} B "
          f"active a token), {TRAIN_B} x {TRAIN_S} tokens, "
          f"{MOE_TRAIN_STEPS} steps of {DEFAULT_LM_SETTING}: loss "
          f"{' '.join(f'{x:.4f}' for x in losses)} (mean of the first 3 "
          f"{first:.4f}, of the last 3 {last:.4f})", flush=True)
    print(f"train[moe fixed]: step {wall:.2f} ms wall, {ev:.2f} ms between "
          f"CUDA events (medians of steps 3-{MOE_TRAIN_STEPS}), "
          f"{TRAIN_B * TRAIN_S / wall * 1e3:.0f} tokens/s; under "
          f"torch.profiler {pwall:.2f} ms wall, busy share {busy / pwall:.3f};"
          f" by kind: " + ", ".join(
              f"{g_} {ms:.2f} ms ({k} kernels)" for g_, (ms, k) in
              sorted(groups.items(), key=lambda kv: -kv[1][0]))
          + f"; the Adam pass alone {opt_ms:.2f} ms; state {state_gb:.2f} GB,"
          f" peak {peak:.2f} GB allocated on {card}", flush=True)
    int8 = dict(DEFAULT_LM_SETTING, compression="int8")
    step8 = job.step_builder(int8)
    before = dict(LAUNCHES)
    state, m = step8(state, next(batches))
    loss8 = float(m["loss"])
    d = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    n_leaves = len(leaves(state["params"]))
    if not np.isfinite(loss8) or not (d["quantize"] == d["dequantize"]
                                      == n_leaves):
        fail(f"moe int8 step: loss {loss8}, {d['quantize']} quantize / "
             f"{d['dequantize']} dequantize launches for {n_leaves} leaves")
    print(f"train[moe int8]: one step with the int8 push, loss {loss8:.4f}, "
          f"one quantize and dequantize for each of {n_leaves} leaves (the "
          f"largest, layers/moe/wi, "
          f"{state['params']['layers']['moe']['wi'].numel():,} values in one "
          f"block)", flush=True)
    for k in launches:
        launches[k] += d[k]
    del state, step, step8
    gc.collect()
    torch.cuda.empty_cache()
    return launches


MOE_TRAIN_STEPS = 8


def moe_path(torch, card):
    """Phase 11 on llama4-scout-17b-a16e at full width (d_model 5120, 40 q
    / 8 kv heads of hd 128, 16 experts of d_ff 8192 a layer, top-1,
    capacity factor 1.25, vocab 202048): serving and the per-layer parity
    at ``MOE_DEPTH`` layers, training at ``MOE_TRAIN_DEPTH``.  Returns the
    launches of the serve arms, the self-tuned serve and the training
    runs."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_layers=MOE_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {cfg.name} full width at {cfg.n_layers} of 48 layers, "
          f"{n_params / 1e9:.3f} B params bf16 ({cfg.n_experts} experts of "
          f"d_ff {cfg.d_ff}, top-{cfg.moe_top_k}, capacity factor "
          f"{cfg.capacity_factor}), init {time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    rec = RouteRecorder(torch)
    moves = []
    for decode, what in ((True, "decode: paged vs gather"),
                         (False, "prefill: flash vs plain")):
        x0, run = attn_layer_runs(torch, cfg, params, rec, decode, seed=31)
        moves.append(layer_by_layer(torch, f"{cfg.name} {what}", x0,
                                    cfg.n_layers, run)[1])
        del x0, run                  # the closure holds the parameters
    # a router margin within 3 x the largest probability move between the
    # kernel and the plain path in one layer (1.5 x the two probabilities
    # a swap takes): a choice that the paths' rounding alone can flip
    margin = 3 * max(moves)
    tol = decode_parity(torch, cfg, params)
    print(f"phase 11: parity done at {time.perf_counter() - t0:.1f}s, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; router "
          f"margins within {margin:.3g} count as ties", flush=True)
    launches = moe_serve(torch, cfg, params, card, tol, margin)
    print(f"phase 11: serve arms done at {time.perf_counter() - t0:.1f}s, "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    # at 12 layers the random-init model's rounding floor is the logits'
    # own size (a flipped expert anywhere moves every later token): the
    # token checks there only bound the drift; at MOE_SHALLOW layers the
    # floor is small, and the same arms are held to it
    c, p = _depth(cfg, params, MOE_SHALLOW)
    shallow = moe_serve(torch, c, p, card, decode_parity(torch, c, p),
                        margin, full=False)
    del c, p
    for k in DENSE_KERNELS:
        launches[k] += shallow[k]
    gc.collect()
    torch.cuda.empty_cache()
    ls = selftuned_serve(torch, cfg, params, card, need_relayout=True)
    for k in DENSE_KERNELS:
        launches[k] += ls[k]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 11: serving done at {time.perf_counter() - t0:.1f}s; freed "
          f"the serving model: {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB still allocated", flush=True)
    lt = moe_train(torch, card)
    launches = {k: launches.get(k, 0) + lt.get(k, 0)
                for k in set(launches) | set(lt)}
    missing = [k for k in ("paged_attention", "flash_attention",
                           "flash_attention_bwd", "quantize", "dequantize")
               if not launches.get(k)]
    if missing:
        fail(f"the moe path never launched {missing}: {launches}")
    print(f"moe: phase 11 in {time.perf_counter() - t0:.1f}s, launches "
          f"{launches}, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB", flush=True)
    return launches


# ------------------------------------------------------------ phase 12
VLM_PATCHES = 64                   # phi-3-vision's frontend_len
VLM_TEXT = TRAIN_S - VLM_PATCHES   # text tokens behind the patches: 448
VLM_TRAIN_STEPS = 8


def vlm_serve(torch, cfg, params, tol):
    """Phase 12's serving on phi-3-vision, from tokens only as the JAX
    engine serves the vlm family: phase 5's shared_prefix bf16 arm (flash
    in prefill, paged attention at hd 96 in suffix prefill and decode,
    copy-on-write) with every served token held to a full-sequence prefill
    within ``tol`` (tie-aware), the int8 arm and its _quant_exec(320) round
    trip, phase 6's graph checks and decode profile (beside the step's
    weight read), and a spec_k = 3 arm whose tokens are the spec_k = 0
    arm's (a request that differs is held to the prefill path).  Returns
    the arms' launches."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.serving import DEFAULT_SERVING_SETTING
    from repro_torch.serving.workload import make_trace
    share = dict(DEFAULT_SERVING_SETTING, max_batch=8, block_size=16,
                 cache_dtype="bf16", prefix_share=True)
    tag = f"vlm {cfg.n_layers} layers"
    spans = LaunchSpans(LAUNCHES)
    eng, done, stats, la = serve_arm(torch, cfg, params, share,
                                     dense_trace(cfg), f"{tag} bf16",
                                     tracer=spans)
    by = {k: {n: v[n] for n in ("flash_attention", "paged_attention")}
          for k, v in spans.by_span.items()
          if k in ("serve.prefill", "serve.chunk_prefill", "serve.decode")}
    print(f"serve[{tag} bf16]: launches by span {by}; {stats['cow_copies']} "
          f"COW copies", flush=True)
    if not (by.get("serve.prefill", {}).get("flash_attention")
            and by.get("serve.chunk_prefill", {}).get("paged_attention")
            and by.get("serve.decode", {}).get("paged_attention")
            and stats["cow_copies"]):
        fail(f"the vlm serve did not run flash in prefill and paged "
             f"attention in suffix prefill and decode, or made no COW copy: "
             f"{by}")
    check_tokens(torch, cfg, params, done, tol)
    trace8 = make_trace("shared_prefix", 400.0, 0.015, vocab=cfg.vocab_size,
                        seed=100, prefix_len=192, tail_lens=(8, 48),
                        max_news=(8, 8))
    eng8, _, _, lb = serve_arm(torch, cfg, params, dict(share, quant="int8"),
                               trace8, f"{tag} int8")
    quant_roundtrip(torch, eng8, cfg)
    g = fill_pool(torch, eng, 7)
    check_graphs(torch, eng, cfg.name, step_cases(torch, eng, cfg, g,
                                                  quant_eng=eng8))
    prof = profile_decode(torch, eng, cfg, g)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"profile[{cfg.name}]: the step's weight read ({nbytes / 1e9:.2f} "
          f"GB) at 3.35 TB/s takes {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"against {prof['wall_ms']:.3f} ms wall and {prof['busy_ms']:.3f} "
          f"ms of kernels a graph step", flush=True)
    del eng, eng8
    spans = LaunchSpans(LAUNCHES)
    _, sdone, sstats, lc = serve_arm(
        torch, cfg, params, dict(share, spec_k=3.0, drafter="ngram"),
        dense_trace(cfg), f"{tag} bf16 spec_k=3 ngram", tracer=spans)
    ver = spans.by_span.get("decode.verify", {}).get("paged_attention", 0)
    print(f"spec[{tag}]: paged_attention launches in decode.verify (S = 4) "
          f"{ver}; {sstats['speculation']}", flush=True)
    if not ver:
        fail("the vlm spec arm did not verify through paged attention")
    same_tokens(torch, cfg, params, f"spec[{tag}]", sdone, done, tol)
    return {k: la[k] + lb[k] + lc[k] for k in DENSE_KERNELS}


def vlm_batches(cfg, shape):
    """Text batches of ``lm_batch_iterator`` (learnable, as the LMJob
    draws them) with ``synthetic_batch``'s image patches, new each step."""
    from repro_torch.data.synthetic import lm_batch_iterator, synthetic_batch
    text = lm_batch_iterator(cfg, shape.global_batch,
                             shape.seq_len - cfg.frontend_len, seed=0)
    for i in itertools.count():
        b = next(text)
        b["frontend"] = synthetic_batch(cfg, shape, seed=1000 + i)["frontend"]
        yield b


def vlm_train(torch, card):
    """Phase 12's training on phi-3-vision at full width with image
    patches, ``synthetic_batch`` of 4 x (64 patches + 448 tokens), the
    loss over the text: one step's loss and gradients (``frontend/proj``
    included), the kernel path (flash forward and backward at hd 96)
    against the plain path within a measured rounding-noise floor as in
    phase 9, at 1 layer; then at full depth (32 layers, 3.824 B
    parameters and their Adam state) fixed-setting steps on text with
    fresh patches in which the loss falls (step time, tokens/s, busy
    share, peak memory) and one step with the int8 push (one quantize and
    dequantize a leaf).  Returns the launches of the runs."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import flatten, leaves
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, LMJob
    from repro_torch.ps.stepfn import _grads
    full = get_config("phi-3-vision-4.2b")
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    cfg = dataclasses.replace(full, n_layers=1)
    params = lm.init_params(cfg, seed=0, device="cuda")
    batch = synthetic_batch(cfg, shape, seed=0)

    def run():
        loss, _, g = _grads(params, batch, cfg, ModelKnobs())
        return float(loss), flatten(g)

    before = LAUNCHES["flash_attention_bwd"]
    k_loss, (names, k_g) = run()
    if LAUNCHES["flash_attention_bwd"] - before != 1:
        fail("vlm train parity: the flash backward did not run once")
    with plain_attention(torch):
        p_loss, (_, p_g) = run()
    with plain_attention(torch, eps=2.0 ** -20):
        n_loss, (_, n_g) = run()

    def worst(a, b):
        return max((float((x.float() - y.float()).abs().max()
                          / y.float().abs().max().clamp_min(1e-30)), n)
                   for x, y, n in zip(a, b, names))

    (err, leaf), (noise, _) = worst(k_g, p_g), worst(n_g, p_g)
    tol = TRAIN_GRAD_TOL + 1.5 * noise
    lerr, lnoise = abs(k_loss - p_loss), abs(n_loss - p_loss)
    ltol = TRAIN_LOSS_TOL + 1.5 * lnoise
    proj = float(k_g[names.index("frontend/proj")].abs().max())
    print(f"parity[train vlm 1 layer, {TRAIN_B} x ({VLM_PATCHES} patches + "
          f"{VLM_TEXT} tokens)]: loss kernel {k_loss:.6f} plain "
          f"{p_loss:.6f} (|diff| {lerr:.3g}, floor {lnoise:.3g}, bound "
          f"{ltol:.3g}); gradients: worst leaf ({leaf}) max err {err:.4g} of "
          f"its largest |value| against a rounding-noise floor of "
          f"{noise:.4g} (bound {tol:.4g}); frontend/proj's largest |grad| "
          f"{proj:.4g}", flush=True)
    if not (err <= tol and lerr <= ltol and proj > 0) or any(
            not torch.isfinite(x.float()).all() for x in k_g):
        fail("vlm train parity")
    del params, batch, k_g, p_g, n_g
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    job = LMJob(full, batch=TRAIN_B, seq=VLM_TEXT)
    state = job.init_state(DEFAULT_LM_SETTING, seed=0)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    step = job.step_builder(DEFAULT_LM_SETTING)
    batches = vlm_batches(full, shape)
    losses, walls, evs = [], [], []
    reset_launches()
    for _ in range(VLM_TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step(state, next(batches))
        b.record()
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        evs.append(a.elapsed_time(b))
    launches = dict(LAUNCHES)
    if launches["flash_attention_bwd"] != VLM_TRAIN_STEPS * full.n_layers:
        fail(f"vlm fixed run: {launches['flash_attention_bwd']} flash "
             f"backward launches in {VLM_TRAIN_STEPS} steps")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not np.isfinite(losses).all() or not last < first:
        fail(f"vlm fixed run: the loss did not fall ({first} -> {last})")
    state, pwall, busy, _, groups = _profile_steps(torch, step, state,
                                                   batches, steps=2)
    opt_ms = time_optimizer(torch, job, state, reps=2)
    wall, ev = float(np.median(walls[2:])), float(np.median(evs[2:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = full.n_params()
    print(f"train[vlm fixed]: {full.name} full width and depth "
          f"({n / 1e9:.3f} B params), {TRAIN_B} x ({VLM_PATCHES} patches + "
          f"{VLM_TEXT} tokens), {VLM_TRAIN_STEPS} steps of "
          f"{DEFAULT_LM_SETTING}: loss {' '.join(f'{x:.4f}' for x in losses)}"
          f" (mean of the first 3 {first:.4f}, of the last 3 {last:.4f})",
          flush=True)
    print(f"train[vlm fixed]: step {wall:.2f} ms wall, {ev:.2f} ms between "
          f"CUDA events (medians of steps 3-{VLM_TRAIN_STEPS}), "
          f"{TRAIN_B * TRAIN_S / wall * 1e3:.0f} positions/s; under "
          f"torch.profiler {pwall:.2f} ms wall, busy share {busy / pwall:.3f};"
          f" by kind: " + ", ".join(
              f"{g_} {ms:.2f} ms ({k} kernels)" for g_, (ms, k) in
              sorted(groups.items(), key=lambda kv: -kv[1][0]))
          + f"; the Adam pass alone {opt_ms:.2f} ms; state {state_gb:.2f} GB,"
          f" peak {peak:.2f} GB allocated on {card}", flush=True)
    step8 = job.step_builder(dict(DEFAULT_LM_SETTING, compression="int8"))
    before = dict(LAUNCHES)
    state, m = step8(state, next(batches))
    loss8 = float(m["loss"])
    d = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    n_leaves = len(leaves(state["params"]))
    if not np.isfinite(loss8) or not (d["quantize"] == d["dequantize"]
                                      == n_leaves):
        fail(f"vlm int8 step: loss {loss8}, {d['quantize']} quantize / "
             f"{d['dequantize']} dequantize launches for {n_leaves} leaves")
    print(f"train[vlm int8]: one step with the int8 push, loss {loss8:.4f}, "
          f"one quantize and dequantize for each of {n_leaves} leaves "
          f"(frontend/proj among them)", flush=True)
    for k in launches:
        launches[k] += d[k]
    del state, step, step8
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def vlm_path(torch, card):
    """Phase 12 on phi-3-vision-4.2b at full width and depth (32 layers,
    d_model 3072, 32 q = 32 kv heads of hd 96, SwiGLU d_ff 8192, vocab
    32064, untied head, a patch frontend 1024 -> 3072; 3.824 B params):
    the per-layer check of a decode step (paged vs gather) and of a prefill
    of 64 patches + 256 tokens (flash vs plain), phase 4's decode parity
    at 1 and 32 layers as the drift bound, ``vlm_serve``, a self-tuned
    serve, then ``vlm_train``.  Returns the launches of the serve arms,
    the self-tuned serve and the training runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = get_config("phi-3-vision-4.2b")
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {cfg.name} full width and depth, {n_params / 1e9:.3f} B "
          f"params bf16, init {time.perf_counter() - t0:.1f}s", flush=True)
    rec = RouteRecorder(torch)
    for decode, what, patches in (
            (True, "decode: paged vs gather", 0),
            (False, f"prefill of {VLM_PATCHES} patches + "
                    f"{320 - VLM_PATCHES} tokens: flash vs plain",
             VLM_PATCHES)):
        x0, run = attn_layer_runs(torch, cfg, params, rec, decode, seed=41,
                                  patches=patches)
        layer_by_layer(torch, f"{cfg.name} {what}", x0, cfg.n_layers, run)
        del x0, run                  # the closure holds the parameters
    tol = decode_parity(torch, cfg, params)
    print(f"phase 12: parity done at {time.perf_counter() - t0:.1f}s",
          flush=True)
    launches = vlm_serve(torch, cfg, params, tol)
    gc.collect()
    torch.cuda.empty_cache()
    ls = selftuned_serve(torch, cfg, params, card)
    for k in DENSE_KERNELS:
        launches[k] += ls[k]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12: serving done at {time.perf_counter() - t0:.1f}s; freed "
          f"the serving model: {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB still allocated", flush=True)
    lt = vlm_train(torch, card)
    launches = {k: launches.get(k, 0) + lt.get(k, 0)
                for k in set(launches) | set(lt)}
    missing = [k for k in ("paged_attention", "flash_attention",
                           "flash_attention_bwd", "quantize", "dequantize")
               if not launches.get(k)]
    if missing:
        fail(f"the vlm path never launched {missing}: {launches}")
    print(f"vlm: phase 12 in {time.perf_counter() - t0:.1f}s, launches "
          f"{launches}, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB", flush=True)
    return launches


# ------------------------------------------------------------ phase 13
ENC_H, ENC_HD = 16, 80             # hubert-xlarge: 16 q = 16 kv heads of hd
                                   # 80 (G = 1), not causal
ENC_B, ENC_S = 4, 1024             # frames a batch: encode and training
ENC_TRAIN_STEPS = 8


def check_encoder_kernels(torch, rows):
    """The flash kernels at the encoder's heads (16 q = 16 kv heads of hd
    80, not causal) against their plain versions, then timed beside their
    bounds and SDPA (printed ``kernel ...[encoder ...]`` lines):

    - the forward at (4, 1024), a ragged S = 1000 and keys at negative
      positions (masked, as the model's chunked attention masks them),
      with the rows' log-sum-exp; timed at the training shape with the
      lse and at the encode (the same shape) without, beside
      ``scaled_dot_product_attention(is_causal=False)``;
    - the backward at the training shape (one CTA a cluster, tiles padded
      from 80 to 128 columns), at S = 1000 and with keys at negative
      positions (which get exactly no dk and dv): bit for bit across two
      calls, timed whole and by launch beside SDPA's backward."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(25)
    H_, hd = ENC_H, ENC_HD
    geo = f"H=K={H_} hd={hd} G=1, not causal"
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def case(B, S, start):
        q, k, v, do = (torch.randn((B, S, H_, hd), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        pos = (torch.arange(S, device=dev) + start)[None].expand(B, S)
        return q, k, v, do, pos

    ferr, berr = 0.0, 0.0
    for B, S, start in [(ENC_B, ENC_S, 0), (2, 1000, 0), (1, 300, -100)]:
        q, k, v, do, pos = case(B, S, start)
        out, lse = flash_attention(q, k, v, pos, pos, causal=False,
                                   return_lse=True)
        ferr = max(ferr, check_close(
            torch, f"flash_attention encoder {geo} B={B} S={S} keys from "
            f"{start}", out, attention_ref(q, k, v, pos, pos, causal=False),
            BF16_TOL))
        ref = attention_lse_ref(q, k, pos, pos, causal=False)
        e = float((lse - ref).abs().max())
        if e > LSE_TOL * max(1.0, float(ref.abs().max())):
            fail(f"flash lse encoder B={B} S={S}: max abs err {e}")
        got = flash_attention_bwd(q, k, v, out, do, lse, pos, pos,
                                  causal=False)
        again = flash_attention_bwd(q, k, v, out, do, lse, pos, pos,
                                    causal=False)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_bwd encoder B={B} S={S}: two calls differ")
        for name, a, b in zip(("dq", "dk", "dv"), got, attention_bwd_ref(
                q, k, v, do, pos, pos, causal=False)):
            e = float((a.float() - b.float()).abs().max()
                      / b.float().abs().max())
            if not torch.isfinite(a.float()).all() or e > BWD_RTOL:
                fail(f"flash_attention_bwd encoder B={B} S={S} {name}: max "
                     f"err {e} of the largest |value| (bound {BWD_RTOL})")
            berr = max(berr, float((a.float() - b.float()).abs().max()))
        if start < 0 and (got[1][:, :-start].any()
                          or got[2][:, :-start].any()):
            fail("flash_attention_bwd encoder: a key at a negative position "
                 "got a gradient")
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], ferr)
    rows["flash_attention_bwd"]["max_abs_err"] = max(
        rows["flash_attention_bwd"]["max_abs_err"], berr)
    print(f"kernel flash_attention[encoder {geo}]: forward max_abs_err "
          f"{ferr:.3g}, backward max_abs_err {berr:.3g} (within {BWD_RTOL} "
          f"of the largest |gradient|, bit for bit across two calls) at "
          f"S = {ENC_S}, 1000 and keys from -100", flush=True)

    B, S = ENC_B, ENC_S
    q, k, v, do, pos = case(B, S, 0)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = B * H_ * S * S
    for what, lse in (("training, with lse", True), ("encode", False)):
        ms = timed_ms(torch, lambda: flash_attention(
            q, k, v, pos, pos, causal=False, return_lse=lse))
        plain = timed_ms(torch, lambda: attention_ref(q, k, v, pos, pos,
                                                      causal=False))
        lib = timed_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=False))
        b = bound(4 * q.numel() * 2 + B * H_ * S * 4 * lse,
                  4 * hd * pairs, BF16_FLOPS)
        print(f"kernel flash_attention[encoder {what} B={B} S={S} {geo} "
              f"bf16]: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms={lib:.4f} (SDPA) bound_ms={b[0]:.4f} ({b[1]})",
              flush=True)
    out, lse = flash_attention(q, k, v, pos, pos, causal=False,
                               return_lse=True)
    ms = timed_ms(torch, lambda: flash_attention_bwd(
        q, k, v, out, do, lse, pos, pos, causal=False))
    plain = timed_ms(torch, lambda: attention_bwd_ref(q, k, v, do, pos, pos,
                                                      causal=False))
    lq, lk, lv = (x.detach().requires_grad_() for x in (qt, kt, vt))
    lib_out = sdpa(lq, lk, lv, is_causal=False)
    lib = timed_ms(torch, lambda: torch.autograd.grad(
        lib_out, (lq, lk, lv), do.transpose(1, 2), retain_graph=True))
    per = launch_ms(torch, lambda: flash_attention_bwd(
        q, k, v, out, do, lse, pos, pos, causal=False),
        r"flash_bwd_(dq|dkdv)_kernel")
    b = bound(8 * q.numel() * 2 + B * H_ * S * 4, 10 * hd * pairs,
              BF16_FLOPS)
    print(f"kernel flash_attention_bwd[encoder training B={B} S={S} {geo}, "
          f"P=1 CTA a cluster, tiles of 128 columns]: kernel_ms={ms:.4f}"
          + "".join(f" {n}_ms={t:.4f}" for n, t in sorted(per.items()))
          + f" plain_ms={plain:.4f} library_ms={lib:.4f} (SDPA backward) "
          f"bound_ms={b[0]:.4f} ({b[1]})", flush=True)


def encode_parity(torch, cfg, params, frames):
    """Every frame's logits of the full-depth encode, the kernel path
    (flash not causal) against the plain path (``blocked_attention``) on
    the same frames: at 1 layer within BF16_TOL; at full depth within
    BF16_TOL + 1.5 x a rounding-noise floor measured in the run (the plain
    path on the frames moved one bf16 ulp), every frame's argmax the plain
    path's or a near-tie of its logits within the same bound."""
    import dataclasses

    from repro_torch.models import lm

    def run(depth, plain, x=frames):
        c = dataclasses.replace(cfg, n_layers=depth)
        p = dict(params, layers=_slice(params["layers"], depth))
        with plain_path(torch) if plain else contextlib.nullcontext():
            hidden, _ = lm.forward(p, None, c, mode="prefill", frontend=x)
            lg = lm.logits_fn(p, hidden, c)
        if not torch.isfinite(lg).all() or lg.shape != (
                *frames.shape[:2], cfg.vocab_size):
            fail(f"encode logits: shape {tuple(lg.shape)} or not finite")
        return lg.float()

    err1 = check_close(torch, "1-layer encode flash vs plain",
                       run(1, False), run(1, True), BF16_TOL)
    ref = run(cfg.n_layers, True)
    noise = max_err(torch, run(cfg.n_layers, True,
                               bump_ulp(torch, frames, 1)), ref)
    tol = BF16_TOL + 1.5 * noise
    out = run(cfg.n_layers, False)
    err = max_err(torch, out, ref)
    miss = out.argmax(-1) != ref.argmax(-1)
    gap = (ref.max(-1).values
           - ref.gather(-1, out.argmax(-1, keepdim=True))[..., 0])
    print(f"parity[encode {cfg.name}]: every frame's logits, flash vs plain:"
          f" 1 layer max_abs_err={err1:.4g} (bound {BF16_TOL}); "
          f"{cfg.n_layers} layers max_abs_err={err:.4g} against a "
          f"rounding-noise floor of {noise:.4g} (bound {tol:.4g}), argmax "
          f"agreement {1 - float(miss.float().mean()):.4f} over "
          f"{miss.numel()} frames, largest gap of a mismatch "
          f"{float((gap * miss).max()):.4g}, |logit| max "
          f"{float(ref.abs().max()):.3f}", flush=True)
    if err > tol or float((gap * miss).max()) > tol:
        fail(f"full-depth encode: max abs err {err} or an argmax gap "
             f"{float((gap * miss).max())} beyond {tol}")


def encoder_train(torch, card):
    """Phase 13's training on hubert-xlarge at full width over frame
    batches (``synthetic_batch``, 4 x 1024 frames with a label each):
    one step's loss and gradients, the kernel path (flash forward and
    backward at hd 80, not causal) against the plain path within a
    measured rounding-noise floor at 1 layer, ``embed/tokens``'s gradient
    exactly zero; then at full depth (48 layers, 1.26 B parameters and
    their Adam state) ``build_train_step`` on one repeated batch, in which
    the loss falls (step time, frames/s, busy share, peak memory, the Adam
    pass alone, flash launches a step), and one step with ``remat="full"``
    (the flash forward twice a layer).  Returns the launches of the
    runs."""
    import dataclasses
    from types import SimpleNamespace

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import flatten
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    from repro_torch.optim import make_optimizer
    from repro_torch.ps.lm_job import (DEFAULT_LM_SETTING,
                                       setting_to_stepknobs)
    from repro_torch.ps.stepfn import _grads, build_train_step
    full = get_config("hubert-xlarge")
    shape = ShapeConfig("train", ENC_S, ENC_B, "train")
    cfg = dataclasses.replace(full, n_layers=1)
    params = lm.init_params(cfg, seed=0, device="cuda")
    batch = synthetic_batch(cfg, shape, seed=0)

    def run():
        loss, _, g = _grads(params, batch, cfg, ModelKnobs())
        return float(loss), flatten(g)

    before = LAUNCHES["flash_attention_bwd"]
    k_loss, (names, k_g) = run()
    if LAUNCHES["flash_attention_bwd"] - before != 1:
        fail("encoder train parity: the flash backward did not run once")
    with plain_attention(torch):
        p_loss, (_, p_g) = run()
    with plain_attention(torch, eps=2.0 ** -20):
        n_loss, (_, n_g) = run()

    def worst(a, b):
        return max((float((x.float() - y.float()).abs().max()
                          / y.float().abs().max().clamp_min(1e-30)), n)
                   for x, y, n in zip(a, b, names) if n != "embed/tokens")

    (err, leaf), (noise, _) = worst(k_g, p_g), worst(n_g, p_g)
    tol = TRAIN_GRAD_TOL + 1.5 * noise
    lerr, lnoise = abs(k_loss - p_loss), abs(n_loss - p_loss)
    ltol = TRAIN_LOSS_TOL + 1.5 * lnoise
    tokens_g = k_g[names.index("embed/tokens")]
    proj = float(k_g[names.index("frontend/proj")].abs().max())
    print(f"parity[train encoder 1 layer, {ENC_B} x {ENC_S} frames]: loss "
          f"kernel {k_loss:.6f} plain {p_loss:.6f} (|diff| {lerr:.3g}, floor "
          f"{lnoise:.3g}, bound {ltol:.3g}); gradients: worst leaf ({leaf}) "
          f"max err {err:.4g} of its largest |value| against a "
          f"rounding-noise floor of {noise:.4g} (bound {tol:.4g}); "
          f"frontend/proj's largest |grad| {proj:.4g}, embed/tokens' "
          f"{float(tokens_g.abs().max()):.1f}", flush=True)
    if not (err <= tol and lerr <= ltol and proj > 0) or tokens_g.any() or \
            any(not torch.isfinite(x.float()).all() for x in k_g):
        fail("encoder train parity")
    del params, batch, k_g, p_g, n_g, tokens_g
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    tc = TrainConfig()
    params = lm.init_params(full, seed=0, device="cuda")
    state = {"params": params, "opt": make_optimizer(tc)[0](params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    del params
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    knobs = setting_to_stepknobs(DEFAULT_LM_SETTING)
    step = build_train_step(full, tc, knobs)
    batch = synthetic_batch(full, shape, seed=0)
    losses, walls, evs = [], [], []
    reset_launches()
    for _ in range(ENC_TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step(state, batch)
        b.record()
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        evs.append(a.elapsed_time(b))
    launches = dict(LAUNCHES)
    n_steps = ENC_TRAIN_STEPS
    for k_ in ("flash_attention", "flash_attention_bwd"):
        if launches[k_] != n_steps * full.n_layers:
            fail(f"encoder fixed run: {launches[k_]} {k_} launches in "
                 f"{n_steps} steps")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not np.isfinite(losses).all() or not last < first:
        fail(f"encoder fixed run: the loss did not fall ({first} -> {last})")
    repeat = itertools.repeat(batch)
    state, pwall, busy, _, groups = _profile_steps(torch, step, state,
                                                   repeat, steps=2)
    opt_ms = time_optimizer(torch, SimpleNamespace(tc=tc), state, reps=2)
    wall, ev = float(np.median(walls[2:])), float(np.median(evs[2:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"train[encoder fixed]: {full.name} full width and depth "
          f"({full.n_params() / 1e9:.3f} B params), {ENC_B} x {ENC_S} "
          f"frames, {n_steps} steps of {DEFAULT_LM_SETTING} on one "
          f"repeated batch: loss {' '.join(f'{x:.4f}' for x in losses)} "
          f"(mean of the first 3 {first:.4f}, of the last 3 {last:.4f}); "
          f"flash launches a step: forward "
          f"{launches['flash_attention'] // n_steps}, backward "
          f"{launches['flash_attention_bwd'] // n_steps}", flush=True)
    print(f"train[encoder fixed]: step {wall:.2f} ms wall, {ev:.2f} ms "
          f"between CUDA events (medians of steps 3-{n_steps}), "
          f"{ENC_B * ENC_S / wall * 1e3:.0f} frames/s; under torch.profiler "
          f"{pwall:.2f} ms wall, busy share {busy / pwall:.3f}; by kind: "
          + ", ".join(f"{g_} {ms:.2f} ms ({k} kernels)" for g_, (ms, k) in
                      sorted(groups.items(), key=lambda kv: -kv[1][0]))
          + f"; the Adam pass alone {opt_ms:.2f} ms; state {state_gb:.2f} "
          f"GB, peak {peak:.2f} GB allocated on {card}", flush=True)
    step_r = build_train_step(full, tc, dataclasses.replace(knobs,
                                                            remat="full"))
    before = dict(LAUNCHES)
    state, m = step_r(state, batch)
    loss_r = float(m["loss"])
    d = {k_: LAUNCHES[k_] - before[k_] for k_ in LAUNCHES}
    if not np.isfinite(loss_r) or d["flash_attention"] != 2 * full.n_layers \
            or d["flash_attention_bwd"] != full.n_layers:
        fail(f"encoder remat=full step: loss {loss_r}, {d['flash_attention']}"
             f" forward / {d['flash_attention_bwd']} backward flash launches")
    print(f"train[encoder remat=full]: one step, loss {loss_r:.4f}, flash "
          f"launches: forward {d['flash_attention']} (2 x {full.n_layers}, "
          f"the recomputation's included), backward "
          f"{d['flash_attention_bwd']}", flush=True)
    for k_ in launches:
        launches[k_] += d[k_]
    del state, step, step_r, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def encoder_path(torch, card):
    """Phase 13 on hubert-xlarge at full width and depth (48 layers,
    d_model 1280, 16 q = 16 kv heads of hd 80, not causal, SwiGLU d_ff
    5120, 504 targets, untied head, a frame frontend 512 -> 1280; 1.260 B
    params): 4 x 1024 frames (``synthetic_batch``, prefill kind) encoded
    through ``lm.forward(mode="prefill")`` and ``logits_fn`` over every
    frame (wall and CUDA-event time); the per-layer check of that encode
    (flash vs plain, each layer within 1.5 x its own one-ulp noise);
    ``encode_parity`` as the drift bound; the serving engine's refusal;
    then ``encoder_train``.  Returns the launches of the encode and the
    training runs."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine
    t0 = time.perf_counter()
    cfg = get_config("hubert-xlarge")
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != cfg.n_params():
        fail(f"hubert-xlarge: {n_params} parameters, the config counts "
             f"{cfg.n_params()}")
    print(f"model: {cfg.name} full width and depth, {n_params / 1e9:.3f} B "
          f"params bf16, init {time.perf_counter() - t0:.1f}s", flush=True)
    frames = synthetic_batch(cfg, ShapeConfig("encode", ENC_S, ENC_B,
                                              "prefill"), seed=0)["frontend"]

    def encode():
        hidden, _ = lm.forward(params, None, cfg, mode="prefill",
                               frontend=frames)
        return lm.logits_fn(params, hidden, cfg)

    for _ in range(2):
        encode()
    torch.cuda.synchronize()
    walls, evs = [], []
    reset_launches()
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        a.record()
        logits = encode()
        b.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        evs.append(a.elapsed_time(b))
    launches = dict(LAUNCHES)
    if launches["flash_attention"] != 5 * cfg.n_layers:
        fail(f"encode: {launches['flash_attention']} flash launches in 5 "
             f"encodes of {cfg.n_layers} layers")
    if logits.shape != (ENC_B, ENC_S, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail(f"encode logits: shape {tuple(logits.shape)} or not finite")
    wall, ev = float(np.median(walls)), float(np.median(evs))
    del logits
    _, pwall, busy, _, groups = _profile_steps(
        torch, lambda s, _: (s, {"loss": encode()[0, 0, 0]}), None,
        itertools.repeat(None))
    print(f"encode[{cfg.name}]: {ENC_B} x {ENC_S} frames -> logits of every "
          f"frame {(ENC_B, ENC_S, cfg.vocab_size)}, {wall:.2f} ms wall, "
          f"{ev:.2f} ms between CUDA events (medians of 5), "
          f"{ENC_B * ENC_S / wall * 1e3:.0f} frames/s, flash launches an "
          f"encode {launches['flash_attention'] // 5}; under torch.profiler "
          f"{pwall:.2f} ms wall, busy share {busy / pwall:.3f}; by kind: "
          + ", ".join(f"{g_} {ms:.2f} ms ({k} kernels)" for g_, (ms, k) in
                      sorted(groups.items(), key=lambda kv: -kv[1][0]))
          + f" on {card}", flush=True)
    x0, run = attn_layer_runs(torch, cfg, params, RouteRecorder(torch),
                              False, seed=43, frames=frames)
    layer_by_layer(torch, f"{cfg.name} encode of {ENC_B} x {ENC_S} frames: "
                   f"flash (not causal) vs plain", x0, cfg.n_layers, run)
    del x0, run                  # the closure holds the parameters
    encode_parity(torch, cfg, params, frames)
    try:
        ServingEngine(params, cfg, max_seq=64, device="cuda")
    except NotImplementedError as e:
        if "encoder-only models have no decode step" not in str(e):
            fail(f"the engine refused the encoder with another text: {e}")
        print(f"refusal: ServingEngine({cfg.name}): {e}", flush=True)
    else:
        fail("the serving engine accepted an encoder")
    del params, frames
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 13: encode done at {time.perf_counter() - t0:.1f}s",
          flush=True)
    lt = encoder_train(torch, card)
    launches = {k: launches.get(k, 0) + lt.get(k, 0)
                for k in set(launches) | set(lt)}
    missing = [k for k in ("flash_attention", "flash_attention_bwd")
               if not launches.get(k)]
    if missing:
        fail(f"the encoder path never launched {missing}: {launches}")
    print(f"encoder: phase 13 in {time.perf_counter() - t0:.1f}s, launches "
          f"{launches}, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB", flush=True)
    return launches


# --------------------------------- phase 3 (ssm and hybrid training shapes)
SSM_FALCON = ("falcon", 8192, 16)  # d_inner and N of falcon-mamba-7b
SSM_ZAMBA = ("zamba2", HY_D, HY_N)  # of zamba2-1.2b (64 heads of 64)
SSM_R = 256                         # falcon-mamba's dt_rank: x_proj's head
SSM_SCAN_CASES = (                  # (form, B, S, L): the training shapes,
    ("falcon", 4, 512, 64), ("zamba2", 4, 512, 64),   # a ragged S, S <= 8
    ("falcon", 2, 333, 32), ("zamba2", 4, 5, 64), ("falcon", 4, 7, 32))


def scan_train_inputs(torch, g, form, B, S, dev="cuda"):
    """The scan's inputs as the model hands them over in training:
    falcon-mamba's x and dt bf16, Bm and Cm bf16 views of an x_proj output
    of R + 2N columns, A = -(1..16); zamba2's all f32, Bm and Cm f32 views
    of a 2N-column projection, dt and A a head's value repeated over its
    64 channels."""
    _, D, N = SSM_FALCON if form == "falcon" else SSM_ZAMBA
    f32 = torch.float32
    io = torch.bfloat16 if form == "falcon" else f32
    x = torch.randn((B, S, D), generator=g, device=dev).to(io)
    if form == "falcon":
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, D), generator=g, device=dev) - 1.0).to(io)
        A = -torch.arange(1, N + 1, dtype=f32, device=dev).expand(D, N)
        R = SSM_R
    else:
        dt = torch.nn.functional.softplus(torch.randn(
            (B, S, HY_NH), generator=g, device=dev) - 1.0)
        dt = dt[..., None].expand(B, S, HY_NH, HY_P).reshape(B, S, D)
        a = -torch.exp(torch.rand((HY_NH,), generator=g, device=dev))
        A = a[:, None, None].expand(HY_NH, HY_P, N).reshape(D, N)
        R = 0
    proj = torch.randn((B, S, R + 2 * N), generator=g, device=dev).to(io)
    _, Bm, Cm = proj.split([R, N, N], dim=-1)
    return x, dt.contiguous(), Bm, Cm, A.contiguous()


def scan_grads(torch, ins, gy, dtype):
    """Gradients of <y, gy> with respect to x, dt, Bm, Cm and A by autograd
    through the plain recurrence in ``dtype``: f64 (the reference, kept in
    f64) or f32 (``selective_scan_ref``'s arithmetic; each cast to its
    input's dtype as the kernel returns it, gB and gC to Bm's)."""
    leaves = [t.detach().to(dtype).requires_grad_() for t in ins]
    x, dt, Bm, Cm, A = leaves
    with torch.enable_grad():
        h = torch.zeros((x.shape[0], x.shape[2], A.shape[1]), dtype=dtype,
                        device=x.device)
        ys = []
        for t in range(x.shape[1]):
            h = (torch.exp(dt[:, t, :, None] * A) * h
                 + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :])
            ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
        g = torch.autograd.grad(torch.stack(ys, dim=1), leaves, gy.to(dtype))
    if dtype == torch.float64:
        return list(g)
    return [a.to(t.dtype) for a, t in zip(g, ins[:3] + (ins[2], ins[4]))]


def scan_bwd_bound(x, dt, Bm, A, h_chk, clock):
    """The backward's least time: each input read once (x, dt, the N
    columns of Bm and Cm a row, A, h_chk, gy f32), each output written once
    (gx, gdt, gB, gC, gA); operations: the B S D N exponentials a_t it
    needs (16 per SM per clock), beside its f32 FMAs (about 12 a
    state-step)."""
    B, S, D = x.shape
    N = A.shape[1]
    io = x.element_size() + dt.element_size()
    nbytes = (2 * B * S * D * io + 4 * B * S * N * Bm.element_size()
              + 2 * D * N * 4 + h_chk.numel() * 4 + B * S * D * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_exp = B * S * D * N / (SFU_PER_SM_CLOCK * N_SMS * clock * 1e9) * 1e3
    t_fma = 12 * B * S * D * N / F32_FLOPS * 1e3
    b = ((t_bytes, "bytes") if t_bytes >= max(t_exp, t_fma)
         else (max(t_exp, t_fma), "operations"))
    return b, t_bytes, t_exp, t_fma


def check_ssm_train_kernels(torch, rows):
    """The selective scan's training pair at falcon-mamba's and zamba2's
    training shapes (4 x 512 tokens; D 8192, N 16, bf16 x and dt, Bm and Cm
    bf16 views of an x_proj output; D 4096, N 64, all f32), a ragged S, S
    <= 8 and other intervals: the forward with ``h_chk`` leaves y and
    h_last bit for bit as without it, and h_chk within SCAN_TOL of the
    plain states; the backward (two launches) against autograd through the
    plain recurrence in f64, each gradient within twice the f32 plain
    version's own gap to it, bit for bit across two calls.  Then both
    timed beside their bounds and plain versions (no library call computes
    either).  Adds the ``selective_scan_bwd`` row to ``rows``."""
    from repro_torch.kernels.mamba_scan import selective_scan, selective_scan_bwd
    from repro_torch.kernels.mamba_scan.kernel import bwd_scratch
    from repro_torch.kernels.mamba_scan.ref import (scan_checkpoints_ref,
                                                    selective_scan_bwd_ref)
    g = torch.Generator(device="cuda").manual_seed(26)
    names = ("gx", "gdt", "gB", "gC", "gA")
    ferr, berr, ratio = 0.0, 0.0, 0.0
    for form, B, S, L in SSM_SCAN_CASES:
        x, dt, Bm, Cm, A = ins = scan_train_inputs(torch, g, form, B, S)
        D, N = A.shape
        what = f"selective_scan_bwd[{form} B={B} S={S} D={D} N={N} L={L}]"
        y0, hl0 = selective_scan(x, dt, Bm, Cm, A)
        h_chk = torch.empty((B, -(-S // L), D, N), device="cuda")
        y1, hl1 = selective_scan(x, dt, Bm, Cm, A, h_chk=h_chk, chunk=L)
        if not (torch.equal(y0, y1) and torch.equal(hl0, hl1)):
            fail(f"{what}: the forward's y or h_last moved with h_chk")
        want_chk = scan_checkpoints_ref(x, dt, Bm, Cm, A, None, L)[2]
        ferr = max(ferr, check_close(torch, f"{what} h_chk", h_chk,
                                     want_chk, SCAN_TOL))
        gy = torch.randn((B, S, D), generator=g, device="cuda")
        got = selective_scan_bwd(x, dt, Bm, Cm, A, h_chk, gy, chunk=L)[:5]
        again = selective_scan_bwd(x, dt, Bm, Cm, A, h_chk, gy, chunk=L)[:5]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{what}: two calls differ (the kernel must be "
                 f"deterministic)")
        want = scan_grads(torch, ins, gy, torch.float64)
        plain = scan_grads(torch, ins, gy, torch.float32)
        parts = []
        for name, k, w, p in zip(names, got, want, plain):
            scale = w.abs().max().clamp_min(1e-30)
            err = float((k.double() - w).abs().max() / scale)
            floor = float((p.double() - w).abs().max() / scale)
            if not torch.isfinite(k.float()).all() or err > 2 * floor:
                fail(f"{what} {name}: max err {err:.3g} of the largest "
                     f"|value| against f64, the f32 plain version's "
                     f"{floor:.3g} (bound 2 x that)")
            berr = max(berr, float((k.double() - w).abs().max()))
            ratio = max(ratio, err / max(floor, 1e-300))
            parts.append(f"{name} {err:.3g} (plain f32 {floor:.3g})")
        print(f"kernel {what}: against f64 autograd, of each gradient's "
              f"largest |value|: " + ", ".join(parts) + "; bit for bit "
              f"across two calls; the forward's y and h_last unchanged by "
              f"h_chk", flush=True)
        del ins, x, dt, Bm, Cm, A, h_chk, gy, got, again, want, plain
    print(f"scan training: h_chk max abs err {ferr:.3g} (bound {SCAN_TOL}); "
          f"backward max abs err {berr:.3g}, at most {ratio:.3f} x the f32 "
          f"plain version's gap to f64 (bound 2)", flush=True)

    clock = sm_clock_ghz()
    for form in ("falcon", "zamba2"):
        B, S, L = TRAIN_B, TRAIN_S, 64
        x, dt, Bm, Cm, A = scan_train_inputs(torch, g, form, B, S)
        D, N = A.shape
        h_chk = torch.empty((B, S // L, D, N), device="cuda")
        gy = torch.randn((B, S, D), generator=g, device="cuda")
        serve = timed_ms(torch, lambda: selective_scan(x, dt, Bm, Cm, A))
        fwd = timed_ms(torch, lambda: selective_scan(
            x, dt, Bm, Cm, A, h_chk=h_chk, chunk=L))
        fwd_plain = timed_ms(torch, lambda: scan_checkpoints_ref(
            x, dt, Bm, Cm, A, None, L), iters=3)
        bwd = timed_ms(torch, lambda: selective_scan_bwd(
            x, dt, Bm, Cm, A, h_chk, gy, chunk=L))
        bwd_plain = timed_ms(torch, lambda: selective_scan_bwd_ref(
            x, dt, Bm, Cm, A, h_chk, gy, L), iters=3)
        per = launch_ms(torch, lambda: selective_scan_bwd(
            x, dt, Bm, Cm, A, h_chk, gy, chunk=L), r"scan_bwd_reduce|scan_bwd")
        n = B * S * D
        fb_bytes = (n * (x.element_size() + dt.element_size())
                    + 2 * B * S * N * Bm.element_size() + D * N * 4 + n * 4
                    + B * D * N * 4 + h_chk.numel() * 4)
        t_exp = n * N / (SFU_PER_SM_CLOCK * N_SMS * clock * 1e9) * 1e3
        t_fb = fb_bytes / HBM_BYTES_PER_S * 1e3
        fb = (t_fb, "bytes") if t_fb >= t_exp else (t_exp, "operations")
        bb, tb, te, tf = scan_bwd_bound(x, dt, Bm, A, h_chk, clock)
        geo = (f"{form} training B={B} S={S} D={D} N={N} L={L}, "
               f"{'x/dt bf16, Bm/Cm bf16 views' if form == 'falcon' else 'f32'}")
        print(f"kernel selective_scan[{geo}, with h_chk]: kernel_ms={fwd:.4f}"
              f" (without h_chk {serve:.4f}) plain_ms={fwd_plain:.4f} "
              f"bound_ms={fb[0]:.4f} ({fb[1]}; bytes {t_fb:.4f}, exponentials "
              f"{t_exp:.4f}) library_ms=none", flush=True)
        print(f"kernel selective_scan_bwd[{geo}]: kernel_ms={bwd:.4f}"
              + "".join(f" {k}_ms={t:.4f}" for k, t in sorted(per.items()))
              + f" plain_ms={bwd_plain:.4f} bound_ms={bb[0]:.4f} ({bb[1]}; "
              f"bytes {tb:.4f}, exponentials {te:.4f} at {clock:.3f} GHz x "
              f"{N_SMS} SMs x {SFU_PER_SM_CLOCK}/clock, f32 FMAs {tf:.4f}) "
              f"library_ms=none; forward + backward {fwd + bwd:.4f}; scratch "
              f"{bwd_scratch(B, S, D, N) * 4 / 1e6:.1f} MB",
              flush=True)
        if form == "falcon":
            rows["selective_scan_bwd"] = dict(
                route="cuda",
                source="src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
                replaces="src/repro/models/mamba.py:93",
                max_abs_err=berr, ms=bwd, plain_ms=bwd_plain,
                library_ms=None, bound=bb)
        del x, dt, Bm, Cm, A, h_chk, gy
    gc.collect()
    torch.cuda.empty_cache()


def check_hybrid_train_flash(torch, rows):
    """Both flash kernels at zamba2's shared block in training: (4, 512,
    32 q = 32 kv heads, hd 64), causal, G = 1, with the log-sum-exp,
    against their plain versions (the backward bit for bit across two
    calls), then timed beside SDPA and their bounds."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)
    B, S, H_, hd = TRAIN_B, TRAIN_S, HY_H, HY_HD
    q, k, v, do = (torch.randn((B, S, H_, hd), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    out, lse = flash_attention(q, k, v, pos, pos, return_lse=True)
    ferr = check_close(torch, "flash_attention hybrid training", out,
                       attention_ref(q, k, v, pos, pos), BF16_TOL)
    ref = attention_lse_ref(q, k, pos, pos)
    if float((lse - ref).abs().max()) > LSE_TOL * max(
            1.0, float(ref.abs().max())):
        fail("flash lse at the hybrid training shape")
    got = flash_attention_bwd(q, k, v, out, do, lse, pos, pos)
    again = flash_attention_bwd(q, k, v, out, do, lse, pos, pos)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("flash_attention_bwd at the hybrid training shape: two calls "
             "differ")
    berr = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, attention_bwd_ref(
            q, k, v, do, pos, pos)):
        e = float((a.float() - b.float()).abs().max()
                  / b.float().abs().max())
        if not torch.isfinite(a.float()).all() or e > BWD_RTOL:
            fail(f"flash_attention_bwd hybrid training {name}: max err {e} "
                 f"of the largest |value| (bound {BWD_RTOL})")
        berr = max(berr, float((a.float() - b.float()).abs().max()))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    fwd = timed_ms(torch, lambda: flash_attention(q, k, v, pos, pos,
                                                  return_lse=True))
    fwd_plain = timed_ms(torch, lambda: attention_ref(q, k, v, pos, pos))
    with torch.enable_grad():
        fwd_lib = timed_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
    bwd = timed_ms(torch, lambda: flash_attention_bwd(q, k, v, out, do, lse,
                                                      pos, pos))
    bwd_plain = timed_ms(torch, lambda: attention_bwd_ref(q, k, v, do, pos,
                                                          pos))
    lib_out = sdpa(qt, kt, vt, is_causal=True)
    bwd_lib = timed_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    pairs = B * H_ * S * (S + 1) / 2
    fb = bound(4 * q.numel() * 2 + B * H_ * S * 4, 4 * hd * pairs,
               BF16_FLOPS)
    bb = bound(8 * q.numel() * 2 + B * H_ * S * 4, 10 * hd * pairs,
               BF16_FLOPS)
    geo = f"hybrid training B={B} S={S} H=K={H_} hd={hd} G=1 causal"
    print(f"kernel flash_attention[{geo}, with lse]: max_abs_err {ferr:.3g} "
          f"kernel_ms={fwd:.4f} plain_ms={fwd_plain:.4f} library_ms="
          f"{fwd_lib:.4f} (SDPA) bound_ms={fb[0]:.4f} ({fb[1]})", flush=True)
    print(f"kernel flash_attention_bwd[{geo}]: max_abs_err {berr:.3g} "
          f"(within {BWD_RTOL} of the largest |gradient|, bit for bit across "
          f"two calls) kernel_ms={bwd:.4f} plain_ms={bwd_plain:.4f} "
          f"library_ms={bwd_lib:.4f} (SDPA backward) bound_ms={bb[0]:.4f} "
          f"({bb[1]})", flush=True)


# ------------------------------------------------------------ phase 14
SSM_TRAIN_STEPS = 8                # fixed steps on one repeated batch
FALCON_FREE_GB = 8.0               # falcon-mamba's cut: the deepest model
                                   # whose step leaves this much free


@contextlib.contextmanager
def plain_scan(torch, eps=0.0):
    """The training scan of ``models/mamba.py`` (``SelectiveScan``)
    replaced by the plain scan in f32 (autograd through its step loop), dt
    scaled by (1 + eps): with ``plain_attention``, the parity run's plain
    path and its rounding-noise floor."""
    from types import SimpleNamespace

    from repro_torch.kernels.mamba_scan import selective_scan_ref
    from repro_torch.models import mamba

    def scan(x, dt, Bm, Cm, A):
        return selective_scan_ref(x, dt.float() * (1 + eps), Bm, Cm, A)[0]

    real = mamba.SelectiveScan
    mamba.SelectiveScan = SimpleNamespace(apply=scan)
    try:
        yield
    finally:
        mamba.SelectiveScan = real


def _scan_launches(cfg, d, steps=1, remat="none"):
    """(scan forwards, scan backwards, flash forwards, flash backwards)
    ``steps`` steps of ``cfg`` must launch."""
    from repro_torch.models import lm
    L = cfg.n_layers
    apps = lm.n_shared_apps(cfg) if cfg.family == "hybrid" else 0
    k = 1 if remat == "none" else 2
    want = (k * L * steps, L * steps, k * apps * steps, apps * steps)
    got = tuple(d.get(n, 0) for n in ("selective_scan", "selective_scan_bwd",
                                      "flash_attention",
                                      "flash_attention_bwd"))
    return got, want


def ssm_train_parity(torch, cfg, label):
    """One step's loss and gradients of ``cfg`` at 1 layer, full width, 4 x
    512 tokens: the kernel path (the scan's forward with h_chk and its
    backward; the hybrid's flash kernels) against the plain path (the
    plain scan in f32, plain attention), within TRAIN_GRAD_TOL /
    TRAIN_LOSS_TOL plus 1.5 x the rounding-noise floor measured in the run
    (the plain path with dt and the scores scaled by 1 + 2^-20)."""
    import dataclasses

    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    from repro_torch.ps.stepfn import _grads
    c = dataclasses.replace(cfg, n_layers=1)
    params = lm.init_params(c, seed=0, device="cuda")
    batch = next(lm_batch_iterator(c, TRAIN_B, TRAIN_S, seed=0))

    def run():
        loss, _, g = _grads(params, batch, c, ModelKnobs())
        return float(loss), list(_leaves(g))

    before = dict(LAUNCHES)
    k_loss, k_g = run()
    got, want = _scan_launches(c, {n: LAUNCHES[n] - before[n]
                                   for n in LAUNCHES})
    if got != want:
        fail(f"{label} train parity: launches (scan fwd, bwd, flash fwd, "
             f"bwd) {got}, want {want}")
    with plain_scan(torch), plain_attention(torch):
        p_loss, p_g = run()
    with plain_scan(torch, 2.0 ** -20), plain_attention(torch, 2.0 ** -20):
        n_loss, n_g = run()

    def worst(a, b):
        return max(float((x.float() - y.float()).abs().max()
                         / y.float().abs().max().clamp_min(1e-30))
                   for x, y in zip(a, b))

    err, noise = worst(k_g, p_g), worst(n_g, p_g)
    tol = TRAIN_GRAD_TOL + 1.5 * noise
    lerr, lnoise = abs(k_loss - p_loss), abs(n_loss - p_loss)
    ltol = TRAIN_LOSS_TOL + 1.5 * lnoise
    print(f"parity[train {label} 1 layer, {TRAIN_B} x {TRAIN_S} tokens]: "
          f"loss kernel {k_loss:.6f} plain {p_loss:.6f} (|diff| {lerr:.3g}, "
          f"floor {lnoise:.3g}, bound {ltol:.3g}); gradients: worst leaf max "
          f"err {err:.4g} of its largest |value| against a rounding-noise "
          f"floor of {noise:.4g} (bound {tol:.4g}); launches {got}",
          flush=True)
    if not (err <= tol and lerr <= ltol) or any(
            not torch.isfinite(x.float()).all() for x in k_g):
        fail(f"{label} train parity at 1 layer")
    del params, batch, k_g, p_g, n_g
    gc.collect()
    torch.cuda.empty_cache()


def _default_training(torch, cfg):
    """(state, step, batch) of DEFAULT_LM_SETTING on ``cfg``: random
    parameters and their Adam state on the card, and one 4 x 512 batch."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, setting_to_stepknobs
    from repro_torch.ps.stepfn import build_train_step
    tc = TrainConfig()
    params = lm.init_params(cfg, seed=0, device="cuda")
    state = {"params": params, "opt": make_optimizer(tc)[0](params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step = build_train_step(cfg, tc, setting_to_stepknobs(DEFAULT_LM_SETTING))
    return state, step, next(lm_batch_iterator(cfg, TRAIN_B, TRAIN_S, seed=0))


def ssm_fixed_run(torch, card, cfg, label):
    """``build_train_step`` at DEFAULT_LM_SETTING on ``cfg``, Adam, 4 x 512
    tokens, SSM_TRAIN_STEPS steps on one repeated batch: the loss falls,
    every layer launches each scan kernel once a step and every application
    of the shared block each flash kernel once; step time, tokens/s, busy
    share and device ms by kind under the profiler, the Adam pass alone,
    state and peak memory.  Returns (launches, peak GB)."""
    from types import SimpleNamespace

    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING
    torch.cuda.reset_peak_memory_stats()
    state, step, batch = _default_training(torch, cfg)
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    losses, walls, evs = [], [], []
    reset_launches()
    for _ in range(SSM_TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step(state, batch)
        b.record()
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        evs.append(a.elapsed_time(b))
    launches = dict(LAUNCHES)
    got, want = _scan_launches(cfg, launches, SSM_TRAIN_STEPS)
    if got != want:
        fail(f"{label} fixed run: launches (scan fwd, bwd, flash fwd, bwd) "
             f"{got} in {SSM_TRAIN_STEPS} steps, want {want}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not np.isfinite(losses).all() or not last < first:
        fail(f"{label} fixed run: the loss did not fall ({first} -> {last})")
    peak = torch.cuda.max_memory_allocated() / 1e9
    state, pwall, busy, _, groups = _profile_steps(
        torch, step, state, itertools.repeat(batch), steps=2)
    opt_ms = time_optimizer(torch, SimpleNamespace(tc=TrainConfig()), state,
                            reps=2)
    wall, ev = float(np.median(walls[2:])), float(np.median(evs[2:]))
    n = SSM_TRAIN_STEPS
    print(f"train[{label} fixed]: {cfg.name} at full width, {cfg.n_layers} "
          f"layers ({n_params / 1e9:.3f} B params), {TRAIN_B} x {TRAIN_S} "
          f"tokens, {n} steps of {DEFAULT_LM_SETTING} on one repeated batch: "
          f"loss {' '.join(f'{x:.4f}' for x in losses)} (mean of the first 3 "
          f"{first:.4f}, of the last 3 {last:.4f}); launches a step: scan "
          f"forward {got[0] // n}, backward {got[1] // n}, flash forward "
          f"{got[2] // n}, backward {got[3] // n}", flush=True)
    print(f"train[{label} fixed]: step {wall:.2f} ms wall, {ev:.2f} ms "
          f"between CUDA events (medians of steps 3-{n}), "
          f"{TRAIN_B * TRAIN_S / wall * 1e3:.0f} tokens/s; under "
          f"torch.profiler {pwall:.2f} ms wall, busy share {busy / pwall:.3f};"
          f" by kind: " + ", ".join(
              f"{g_} {ms:.2f} ms ({k} kernels)" for g_, (ms, k) in
              sorted(groups.items(), key=lambda kv: -kv[1][0]))
          + f"; the Adam pass alone {opt_ms:.2f} ms; state {state_gb:.2f} "
          f"GB, peak {peak:.2f} GB allocated of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} on "
          f"{card}", flush=True)
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches, peak


def ssm_remat(torch, cfg, label, depth=2):
    """One step's gradients at ``depth`` layers under remat none, dots and
    full: the same loss and gradients (bit for bit, or the gap printed and
    held within f32 rounding), the scan's forward launched twice a layer
    under dots and full."""
    import dataclasses

    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.models.lm import ModelKnobs
    from repro_torch.ps.stepfn import _grads
    c = dataclasses.replace(cfg, n_layers=depth)
    params = lm.init_params(c, seed=1, device="cuda")
    batch = next(lm_batch_iterator(c, TRAIN_B, TRAIN_S, seed=1))
    base, out, launches = None, [], {}
    for remat in ("none", "dots", "full"):
        reset_launches()
        loss, _, g = _grads(params, batch, c, ModelKnobs(remat=remat))
        d = dict(LAUNCHES)
        got, want = _scan_launches(c, d, remat=remat)
        if got != want:
            fail(f"{label} remat={remat}: launches {got}, want {want}")
        for k_, v_ in d.items():
            launches[k_] = launches.get(k_, 0) + v_
        leaves = [loss] + list(_leaves(g))
        if base is None:
            base = leaves
            out.append(f"none: scan forward {got[0]}, backward {got[1]}")
            continue
        gap = max(float((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp_min(1e-30))
                  for a, b in zip(leaves, base))
        same = all(torch.equal(a, b) for a, b in zip(leaves, base))
        out.append(f"{remat}: scan forward {got[0]}, backward {got[1]}, "
                   + ("bit for bit" if same else f"GAP {gap:.3g}"))
        if gap > 1e-5:
            fail(f"{label} remat={remat}: gradients differ by {gap}")
        del g, leaves
    print(f"train[{label} remat, {depth} layers]: loss {float(base[0]):.6f}; "
          + "; ".join(out), flush=True)
    del params, batch, base
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def falcon_depth(torch, cfg):
    """falcon-mamba-7b's cut: the peak memory the caching allocator holds
    (reserved, fragmentation included) over two default steps at 4 and 8
    layers, a line through them, and the deepest model (of 64 layers)
    whose predicted peak leaves FALCON_FREE_GB of the card free."""
    import dataclasses
    peaks = {}
    for depth in (4, 8):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step, batch = _default_training(
            torch, dataclasses.replace(cfg, n_layers=depth))
        for _ in range(2):
            state, m = step(state, batch)
            float(m["loss"])
        peaks[depth] = torch.cuda.max_memory_reserved() / 1e9
        del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    per = (peaks[8] - peaks[4]) / 4
    base = peaks[4] - 4 * per
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    depth = int(min(cfg.n_layers, (total - FALCON_FREE_GB - base) // per))
    if depth < 1:
        fail(f"falcon-mamba-7b: no depth leaves {FALCON_FREE_GB} GB free "
             f"({peaks})")
    print(f"train[falcon depth]: peak reserved {peaks[4]:.2f} GB at 4 "
          f"layers, {peaks[8]:.2f} at 8: {per:.3f} GB a layer over "
          f"{base:.2f}; the card holds {total:.2f} GB, so {depth} of "
          f"{cfg.n_layers} layers leave >= {FALCON_FREE_GB} GB free "
          f"(predicted peak {base + depth * per:.2f} GB)", flush=True)
    return depth


def ssm_train_path(torch, card):
    """Phase 14: training of the ssm and hybrid families at full width.
    zamba2-1.2b (38 layers, d_inner 4096 in 64 heads, N 64, the shared
    block after layers 0, 6, ..., 36): parity at 1 layer, the fixed run at
    full depth, remat none / dots / full at 2 layers and a checkpoint
    resume at 2 layers; falcon-mamba-7b (d_inner 8192, N 16): parity at 1
    layer, then the fixed run at the deepest cut that leaves
    FALCON_FREE_GB free.  Returns the launches of the counted runs (the
    fixed runs, the remat steps and the resume)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, LMJob
    t0 = time.perf_counter()
    launches = {}

    def add(d):
        for k_, v_ in d.items():
            launches[k_] = launches.get(k_, 0) + v_

    zamba = get_config("zamba2-1.2b")
    ssm_train_parity(torch, zamba, "zamba2-1.2b")
    add(ssm_fixed_run(torch, card, zamba, "zamba2-1.2b")[0])
    add(ssm_remat(torch, zamba, "zamba2-1.2b"))
    reset_launches()
    checkpoint_resume(torch, LMJob, DEFAULT_LM_SETTING, 2,
                      cfg=dataclasses.replace(zamba, n_layers=2),
                      label="zamba2-1.2b")
    add(LAUNCHES)
    print(f"phase 14: zamba2-1.2b done at {time.perf_counter() - t0:.1f}s",
          flush=True)
    falcon = get_config("falcon-mamba-7b")
    ssm_train_parity(torch, falcon, "falcon-mamba-7b")
    depth = falcon_depth(torch, falcon)
    cut = dataclasses.replace(falcon, n_layers=depth)
    try:
        got, peak = ssm_fixed_run(torch, card, cut, "falcon-mamba-7b")
    except torch.OutOfMemoryError as e:
        fail(f"falcon-mamba-7b: the predicted cut of {depth} layers ran out "
             f"of memory: {str(e).splitlines()[0]}")
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"train[falcon cut]: {depth} of {falcon.n_layers} layers at full "
          f"width ({cut.n_params() / 1e9:.3f} of {falcon.n_params() / 1e9:.3f}"
          f" B params; dataclasses.replace(cfg, n_layers={depth}), no "
          f"launcher flag), peak {peak:.2f} GB allocated: "
          f"{total - peak:.2f} GB free", flush=True)
    if total - peak < FALCON_FREE_GB:
        fail(f"falcon-mamba-7b at {depth} layers left {total - peak:.2f} GB")
    add(got)
    missing = [k for k in ("selective_scan", "selective_scan_bwd",
                           "flash_attention", "flash_attention_bwd")
               if not launches.get(k)]
    if missing:
        fail(f"phase 14 never launched {missing}: {launches}")
    print(f"ssm training: phase 14 in {time.perf_counter() - t0:.1f}s, "
          f"launches {launches}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    return launches


# ------------------------------------------------------------ phase 15
MESH_STEPS = 3                     # steps a mode and arm
MESH_CKPT_DEPTH = 4                # the baseline's round trip: 4 layers


def _bits_equal(torch, a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a, b))


def mesh_steps(torch, ms):
    """The mesh step against the single-device step at full width and
    depth, both from seed 0's state on the same batches: no compression,
    then the int8 push.  Returns the mesh steps' launches."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.ps.lm_job import (DEFAULT_LM_SETTING, LMJob,
                                       setting_to_stepknobs)
    from repro_torch.ps.stepfn import build_train_step
    cfg = _train_cfg()
    job = LMJob(cfg, batch=TRAIN_B, seq=TRAIN_S)
    launches = {}
    for mode in ("none", "int8"):
        setting = dict(DEFAULT_LM_SETTING, compression=mode)
        knobs = setting_to_stepknobs(setting)
        ref = None
        for arm in ("single", "mesh"):
            state = job.init_state(setting, seed=0)
            step = build_train_step(cfg, job.tc, knobs,
                                    ms=ms if arm == "mesh" else None)
            batches = job.batches(0)
            reset_launches()
            losses, walls, evs = [], [], []
            for _ in range(MESH_STEPS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                batch = next(batches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.record()
                state, m = step(state, batch)
                b.record()
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                evs.append(a.elapsed_time(b))
            leaves = list(_leaves(state["params"]))
            if leaves[0].device.type != "cuda":
                fail(f"mesh[{mode}]: the {arm} state is not on the card")
            print(f"mesh[{mode} {arm}]: {cfg.n_layers} layers, "
                  f"{TRAIN_B} x {TRAIN_S} tokens: losses {losses}, wall ms "
                  f"{[round(w, 2) for w in walls]}, CUDA-event ms "
                  f"{[round(e, 2) for e in evs]}", flush=True)
            if arm == "single":
                ref = (losses, [t.clone() for t in leaves])
            else:
                for k, n in LAUNCHES.items():
                    launches[k] = launches.get(k, 0) + n
                diff = [i for i, (x, y) in enumerate(zip(ref[1], leaves))
                        if not _bits_equal(torch, x, y)]
                gap = max((float((ref[1][i].float() - leaves[i].float())
                                 .abs().max()) for i in diff), default=0.0)
                same = losses == ref[0] and not diff
                print(f"mesh[{mode}]: 1x1 mesh step vs single-device step: "
                      f"losses {'equal' if losses == ref[0] else 'DIFFER'}"
                      f", {len(leaves) - len(diff)} of {len(leaves)} "
                      f"parameter leaves bit for bit"
                      + ("" if same else f" (largest |diff| {gap:.3g})"),
                      flush=True)
                if not same:
                    fail(f"mesh[{mode}]: the 1x1 mesh step is not the "
                         f"single-device step")
            del state, step, leaves
            gc.collect()
            torch.cuda.empty_cache()
        del ref
    gc.collect()
    torch.cuda.empty_cache()
    need = ("flash_attention", "flash_attention_bwd", "quantize",
            "dequantize")
    print(f"mesh: launches of the mesh steps {launches}", flush=True)
    if not all(launches.get(k) for k in need):
        fail(f"the mesh steps never launched {need}: {launches}")
    return launches


def mesh_checkpoint(torch, ms):
    """The checkpoint baseline's round trip at full width, 4 layers: a
    state after one mesh step saved under the 1x1 placement and restored
    by the elastic re-mesh restore into another seed's state."""
    import tempfile

    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.ps.lm_job import DEFAULT_LM_SETTING, LMJob
    from repro_torch.ps.stepfn import build_train_step
    cfg = _train_cfg(MESH_CKPT_DEPTH)
    job = LMJob(cfg, batch=TRAIN_B, seq=TRAIN_S)
    state = job.init_state(DEFAULT_LM_SETTING, seed=0)
    state, _ = build_train_step(cfg, job.tc, ms=ms)(state,
                                                     next(job.batches(0)))
    specs = job.specs(DEFAULT_LM_SETTING)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_pytree(state, d, step=1, ms=ms, specs=specs)
        t_save = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(d).rglob("*")) / 1e9
        fresh = job.init_state(DEFAULT_LM_SETTING, seed=1)
        t0 = time.perf_counter()
        fresh, meta = restore_pytree(fresh, d, ms=ms)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    a, b = list(_leaves(state)), list(_leaves(fresh))
    same = sum(_bits_equal(torch, x, y) for x, y in zip(a, b))
    print(f"mesh[checkpoint]: {cfg.n_layers} layers at full width, "
          f"{size:.2f} GB: save {t_save:.1f}s, restore_pytree(ms=1x1) "
          f"{t_restore:.1f}s, from step {meta['step']}: {same} of {len(a)} "
          f"leaves bit for bit", flush=True)
    if same != len(a):
        fail("mesh checkpoint: the restored state differs")
    del state, fresh, a, b
    gc.collect()
    torch.cuda.empty_cache()


def mesh_moe(torch, ms):
    """moe_block_ep on the 1x1 mesh against moe_block, full-width
    llama4-scout-17b-a16e's layer 0, decode- and training-sized T."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm, moe
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_layers=1)
    p = lm._layer(lm.init_params(cfg, seed=0, device="cuda")["layers"],
                  0)["moe"]
    g = torch.Generator(device="cuda").manual_seed(3)
    for T in (8, TRAIN_B * TRAIN_S):
        x = torch.randn((T, cfg.d_model), generator=g, device="cuda").to(
            torch.bfloat16)
        with torch.no_grad():
            before = dict(moe.DISPATCH)
            ep = moe.moe_block_ep(x, p, cfg, ms)
            if moe.DISPATCH["ep"] - before["ep"] != 1:
                fail("mesh[moe]: moe_block_ep did not take expert "
                     "parallelism")
            ref = moe.moe_block(x, p, cfg)
            ms_ep = timed_ms(torch, lambda: moe.moe_block_ep(x, p, cfg, ms),
                             iters=5)
            ms_ref = timed_ms(torch, lambda: moe.moe_block(x, p, cfg),
                              iters=5)
        same = all(_bits_equal(torch, a, b) for a, b in zip(ep, ref))
        gap = float((ep[0].float() - ref[0].float()).abs().max())
        print(f"mesh[moe T={T}]: moe_block_ep on 1x1 vs moe_block: "
              + ("bit for bit" if same else f"|diff| {gap:.3g}")
              + f" (tolerance: bit for bit; {cfg.n_experts} experts on the "
              f"one model rank), aux {float(ep[1]):.6f}; {ms_ep:.3f} ms vs "
              f"{ms_ref:.3f} ms a call", flush=True)
        if not same:
            fail(f"mesh[moe T={T}]: moe_block_ep differs from moe_block")
    del p
    gc.collect()
    torch.cuda.empty_cache()


def mesh_path(torch, card, rows, phase9):
    """Phase 15: the mesh over NCCL at world size 1; then phase 16, the
    serve steps on the same mesh (``phase9``: the fixed run's memory).
    Returns the launches of both."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_meshspec
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        init_distributed("cuda", f"file://{d}/store", rank=0, world_size=1)
        try:
            if dist.get_backend() != "nccl":
                fail(f"mesh: the process group runs {dist.get_backend()}")
            ms = make_meshspec(1, 1)
            one = torch.ones(4, device="cuda")
            dist.all_reduce(one, group=ms.data_group)
            torch.cuda.synchronize()
            print(f"mesh: world 1 over {dist.get_backend()}, "
                  f"{ms.mesh}, coord {ms.coord}, one all-reduce done",
                  flush=True)
            launches = mesh_steps(torch, ms)
            print(f"phase 15: mesh steps done at "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            mesh_checkpoint(torch, ms)
            mesh_moe(torch, ms)
            print(f"mesh: phase 15 in {time.perf_counter() - t0:.1f}s, "
                  f"launches {launches}, peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
                  flush=True)
            for k, n in serve_path(torch, ms, rows, phase9).items():
                launches[k] = launches.get(k, 0) + n
            for k, n in engine_mesh_path(torch, ms).items():
                launches[k] = launches.get(k, 0) + n
        finally:
            dist.destroy_process_group()
    return launches

# ------------------------------------------------------------ phase 16
SERVE_B, SERVE_P, SERVE_MAX, SERVE_STEPS = 8, 320, 1024, 32
SLAB_POS = 336                     # the slots' position mid-run (timing)
DRYRUN_TOL = 0.10                  # predicted against measured peak bytes


def serve_steps_mesh(torch, ms):
    """Full-width starcoder2-3b (30 layers) through the serve steps on the
    1x1 mesh: ``build_prefill_step`` over 8 prompts of 320 tokens, the
    rows copied into ``lm.init_cache(cfg, 8, 1024)``, then 32 greedy steps
    of ``build_decode_step`` over that dense cache; the same through the
    single-device ``lm.prefill`` / ``lm.decode_step`` (no mesh).  Logits of
    every step and the final cache bit for bit; 30 flash launches a
    prefill and 30 paged-attention launches a decode step.  Returns the
    mesh arm's launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.ps.stepfn import build_decode_step, build_prefill_step
    cfg = get_config("starcoder2-3b")
    params = lm.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(16)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_P), generator=g,
                           device="cuda")
    arms = {"mesh": (build_prefill_step(cfg, ms),
                     build_decode_step(cfg, ms, max_seq=SERVE_MAX)),
            "single": (lambda p, b: lm.prefill(p, b["tokens"], cfg),
                       lambda p, c, t, pos: lm.decode_step(p, c, t, pos,
                                                           cfg))}
    out, launches = {}, {}
    for arm, (prefill, decode) in arms.items():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pc = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        t_pre = (time.perf_counter() - t0) * 1e3
        n_pre = dict(LAUNCHES)
        cache = lm.init_cache(cfg, SERVE_B, SERVE_MAX, device="cuda")
        for k in ("k", "v"):
            cache[k][:, :, :SERVE_P] = pc[k]
        del pc
        seq, walls = [logits], []
        reset_launches()
        for i in range(SERVE_STEPS):
            nt = seq[-1][:, -1].argmax(-1, keepdim=True)
            pos = torch.full((SERVE_B,), SERVE_P + i, dtype=torch.int32,
                             device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, c = decode(params, cache, nt, pos)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if c is not cache:
                fail(f"serve[{arm}]: the decode step did not write its cache "
                     f"in place")
            seq.append(lg)
        n_dec = dict(LAUNCHES)
        print(f"serve[{arm}]: {cfg.name} 30 layers, prefill {SERVE_B} x "
              f"{SERVE_P} tokens {t_pre:.1f} ms (eager, first call), "
              f"{SERVE_STEPS} decode steps over the dense cache ({SERVE_B}, "
              f"{SERVE_MAX}): median {float(np.median(walls[1:])):.2f} ms "
              f"wall (eager); launches: prefill {n_pre}, decode {n_dec}",
              flush=True)
        if (n_pre["flash_attention"] != cfg.n_layers
                or n_dec["paged_attention"] != cfg.n_layers * SERVE_STEPS):
            fail(f"serve[{arm}]: want {cfg.n_layers} flash launches a "
                 f"prefill and {cfg.n_layers * SERVE_STEPS} paged launches "
                 f"over {SERVE_STEPS} steps, got {n_pre}, {n_dec}")
        if arm == "mesh":
            launches = {k: n_pre[k] + n_dec[k] for k in n_pre}
        if not all(torch.isfinite(x.float()).all() for x in seq):
            fail(f"serve[{arm}]: logits not finite")
        out[arm] = (seq, cache)
    (ms_seq, ms_cache), (sd_seq, sd_cache) = out["mesh"], out["single"]
    same = [_bits_equal(torch, a, b) for a, b in zip(ms_seq, sd_seq)]
    cache_same = all(_bits_equal(torch, ms_cache[k], sd_cache[k])
                     for k in ("k", "v"))
    toks = torch.stack([x[:, -1].argmax(-1) for x in ms_seq[:-1]], 1)
    print(f"serve[1x1 mesh vs single-device]: {sum(same)} of {len(same)} "
          f"logits (prefill + {SERVE_STEPS} steps) and the cache "
          f"{'bit for bit' if cache_same else 'DIFFER'} (tolerance: bit "
          f"for bit, every collective skipped at one rank); greedy tokens "
          f"of slot 0: {toks[0, :12].tolist()}...", flush=True)
    if not (all(same) and cache_same):
        fail("serve: the 1x1 mesh serve steps are not the single-device "
             "steps")
    del out, ms_seq, sd_seq, ms_cache, sd_cache
    x0, run = attn_layer_runs(torch, cfg, params, RouteRecorder(torch),
                              True, seed=16, slab=True)
    layer_by_layer(torch, f"{cfg.name} dense-cache decode", x0,
                   cfg.n_layers, run)
    del params, x0, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def time_dense_slab(torch, rows):
    """Paged attention over the dense per-slot cache of phase 16's decode,
    (8, 1, 24, 128) queries over (8, 1024, 2, 128) bf16 k and v (G = 12)
    viewed as blocks of 16, every slot at position SLAB_POS: against the
    plain dense ``decode_attention``, then timed beside it, SDPA over the
    slab with a boolean mask (GQA), and its bound."""
    from repro_torch.models.attention import (decode_attention,
                                              identity_tables,
                                              slab_decode_attention)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    bf16 = torch.bfloat16
    B, T = SERVE_B, SERVE_MAX
    q = torch.randn((B, 1, H, HD), generator=g, device=dev).to(bf16)
    ks, vs = (torch.randn((B, T, K, HD), generator=g, device=dev).to(bf16)
              for _ in range(2))
    tables = identity_tables(B, T, dev)
    pos = torch.full((B,), SLAB_POS, dtype=torch.int32, device=dev)
    out = slab_decode_attention(q, ks, vs, tables, pos=pos)
    err = check_close(torch, "paged_attention over the dense cache", out,
                      decode_attention(q, ks, vs, pos=pos), BF16_TOL)
    ms = timed_ms(torch, lambda: slab_decode_attention(q, ks, vs, tables,
                                                       pos=pos))
    plain = timed_ms(torch, lambda: decode_attention(q, ks, vs, pos=pos))
    mask = (torch.arange(T, device=dev)[None, None, None, :]
            <= pos.long()[:, None, None, None])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, ks, vs))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = timed_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                       enable_gqa=True))
    seen = B * (SLAB_POS + 1)
    b = bound(seen * K * HD * 2 * 2 + 2 * q.numel() * 2 + tables.numel() * 4,
              4 * seen * H * HD, BF16_FLOPS)
    rows["paged_attention"]["max_abs_err"] = max(
        rows["paged_attention"]["max_abs_err"], err)
    print(f"kernel paged_attention[dense cache decode B={B} S=1 H={H} K={K} "
          f"hd={HD} G={H // K}, cache ({B}, {T}) bf16 as blocks of 16, ctx "
          f"{SLAB_POS + 1}]: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} (SDPA, GQA, boolean mask over the cache) "
          f"bound_ms={b[0]:.4f} ({b[1]}) max_abs_err={err:.3g}", flush=True)


def dryrun_vs_card(torch, m):
    """The dry run's prediction of phase 9's fixed run (starcoder2-3b, 30
    layers, 4 x 512 tokens, its setting, one card), traced on meta tensors
    on the host, against what phase 9 measured: the peak of allocated
    bytes over its steps (less what was allocated before its state) and
    the step's transient part (the peak less the state); each within
    DRYRUN_TOL, else the miss is printed.  ``m``: phase 9's measurement
    (``fixed_run``'s memory).  The prediction's collective bytes are 0 at
    one rank."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.ps.lm_job import setting_to_stepknobs
    setting = m["setting"]
    t0 = time.perf_counter()
    r = run_cell("starcoder2-3b", ShapeConfig("phase9", TRAIN_S, TRAIN_B,
                                              "train"),
                 mesh=(1, 1), knobs=setting_to_stepknobs(setting),
                 save=False)
    t = time.perf_counter() - t0
    mem, coll = r["memory"], r["collectives"]
    if coll["total"] != 0:
        fail(f"dry run: {coll['total']} collective bytes at one rank")
    pairs = [("total peak", mem["peak_estimate_bytes"], m["peak"] - m["base"]),
             ("transient", mem["temp_bytes"], m["peak"] - m["state"])]
    for what, pred, meas in pairs:
        err = pred / meas - 1
        print(f"dryrun[phase 9 cell]: {what} predicted {pred / 1e9:.3f} GB, "
              f"measured {meas / 1e9:.3f} GB allocated ({err * 100:+.1f}%; "
              f"{'held' if abs(err) <= DRYRUN_TOL else 'MISSED'} within "
              f"{DRYRUN_TOL:.0%})", flush=True)
    print(f"dryrun[phase 9 cell]: traced on the host in {t:.1f}s (meta "
          f"tensors, no card): state {mem['argument_bytes'] / 1e9:.3f} GB "
          f"(measured {(m['state'] - m['base']) / 1e9:.3f}), collective "
          f"bytes {coll['total']} (one rank), counted FLOPs "
          f"{r['flops_counted_dev']:.4g}, fits={mem['fits']}", flush=True)


def serve_path(torch, ms, rows, phase9):
    """Phase 16 on phase 15's world-1 mesh.  Returns its launches."""
    t0 = time.perf_counter()
    launches = serve_steps_mesh(torch, ms)
    time_dense_slab(torch, rows)
    dryrun_vs_card(torch, phase9)
    print(f"serve mesh: phase 16 in {time.perf_counter() - t0:.1f}s, "
          f"launches {launches}", flush=True)
    return launches


# ------------------------------------------------------------ phase 17
ENGINE_KERNELS = ("paged_attention", "flash_attention", "quantize",
                  "dequantize", "selective_scan")


class SpanCount:
    """A tracer for the engine that counts its spans by name."""

    def __init__(self):
        self.n: dict = {}

    @contextlib.contextmanager
    def span(self, name, **_):
        self.n[name] = self.n.get(name, 0) + 1
        yield


def pool_differs(torch, a, b) -> list:
    """The pool tensors of two engines that differ: a paged pool's block
    tables and every block but the trash block 0 (where every idle slot
    writes its row at position 0 and the last writer is arbitrary,
    ``replay_check``), an ssm pool's every leaf, bit for bit."""
    pa, pb = a.pool, b.pool
    if pa.kind == "paged":
        if not np.array_equal(pa.tables, pb.tables):
            return ["tables"]
        return [k for k, v in pa.kv.items()
                if not _bits_equal(torch, v[:, 1:], pb.kv[k][:, 1:])]
    return [k for k, v in pa.state.items()
            if not _bits_equal(torch, v, pb.state[k])]


def mesh_twins(torch, cfg, params, ms, setting, reqs, label, hooks=None):
    """``reqs`` driven (``drive``: ticks without a wall clock, the hooks at
    their ticks) through a no-mesh engine and an engine under ``ms``
    (``param_specs=serve_param_specs(cfg, ms)``): every token, the final
    pool and each kernel's launches must be equal.  Returns (mesh engine,
    its finished requests, its launches)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.ps.stepfn import serve_param_specs
    from repro_torch.serving import ServingEngine
    dev = torch.device("cuda")
    out = {}
    for arm in ("single", "mesh"):
        kw = ({} if arm == "single" else
              {"ms": ms, "param_specs": serve_param_specs(cfg, ms)})
        spans = SpanCount()
        eng = ServingEngine(params, cfg, setting, max_seq=SERVE_MAX,
                            device=dev, tracer=spans, **kw)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = drive(eng, reqs, dict(hooks or {}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = spans.n.get("serve.decode", 0) + spans.n.get(
            "decode.verify", 0)
        out[arm] = (eng, done, dict(LAUNCHES))
        print(f"engine mesh[{label} {arm}]: {len(done)} requests, "
              f"{sum(len(r.tokens_out) for r in done)} tokens in {wall:.3f}s "
              f"(captures included), {steps} decode steps, decode "
              f"{eng.decode_time_s * 1e3 / max(steps, 1):.3f} ms a step "
              f"(host clock around each step and its synchronize), "
              f"{len(eng._steps)} steps captured, launches {out[arm][2]}",
              flush=True)
        check_pool(eng, f"{label} {arm}")
    (se, sdone, sl), (me, mdone, ml) = out["single"], out["mesh"]
    want = {r.rid: r.tokens_out for r in sdone}
    same = sum(r.tokens_out == want[r.rid] for r in mdone)
    bad = pool_differs(torch, se, me)
    print(f"engine mesh[{label}]: ServingEngine(ms=1x1 NCCL mesh) vs "
          f"ms=None: {same}/{len(mdone)} requests the same tokens, final "
          f"pool {'bit for bit' if not bad else f'DIFFERS in {bad}'}, "
          f"launches {'equal' if ml == sl else 'DIFFER'} (tolerance: bit "
          f"for bit; every collective is skipped at one rank)", flush=True)
    if same != len(mdone) or len(mdone) != len(sdone) or bad or ml != sl:
        fail(f"engine mesh[{label}]: the mesh engine is not the no-mesh "
             f"engine (launches {ml} vs {sl})")
    del se
    return me, mdone, ml


def engine_mesh_dense(torch, ms):
    """Phase 17 on full-width starcoder2-3b (30 layers, 8 slots, max_seq
    1024, blocks of 16, prefix sharing): ``dense_trace`` through
    ``mesh_twins`` in bf16, int8 and spec_k = 3 (n-gram); then under the
    mesh a stop-the-world max_batch 8 -> 4 and a staged 4 -> 8, each
    relayout placing its new tensors (``pool.placed``, the tensors kept),
    against a no-mesh twin taking the same switches at the same ticks; one
    ``serve_loop`` under the mesh.  Returns the launches of the mesh
    arms."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.ps.stepfn import serve_param_specs
    from repro_torch.serving import (DEFAULT_SERVING_SETTING, ServingEngine,
                                     serve_loop)
    from repro_torch.serving import pool as pool_mod
    cfg = get_config("starcoder2-3b")
    params = lm.init_params(cfg, seed=0, device="cuda")
    share = dict(DEFAULT_SERVING_SETTING, max_batch=8, block_size=16,
                 cache_dtype="bf16", prefix_share=True)
    reqs = dense_trace(cfg)
    launches = dict.fromkeys(ENGINE_KERNELS, 0)

    def add(n):
        for k in ENGINE_KERNELS:
            launches[k] += n[k]

    _, ref, n = mesh_twins(torch, cfg, params, ms, share, reqs, "bf16")
    add(n)
    _, _, n = mesh_twins(torch, cfg, params, ms, dict(share, quant="int8"),
                         reqs, "int8")
    if not (n["quantize"] and n["dequantize"]):
        fail(f"engine mesh[int8]: no quantize/dequantize launch: {n}")
    add(n)
    me, _, n = mesh_twins(torch, cfg, params, ms,
                          dict(share, spec_k=3.0, drafter="ngram"), reqs,
                          "spec_k=3 ngram")
    if not (me.spec_ticks and me.spec_accepted):
        fail(f"engine mesh[spec]: {me.spec_ticks} verify steps, "
             f"{me.spec_accepted} drafts accepted")
    add(n)
    del me

    # the relayouts: placed() on the mesh engine's pool keeps its tensors
    seen = {"placed": 0}
    real = pool_mod.placed

    def spy(state, m):
        ids = {k: id(t) for k, t in state.items()}
        out = real(state, m)
        if m is not None:
            if {k: id(t) for k, t in out.items()} != ids:
                fail("engine mesh[relayout]: placing the pool copied it")
            seen["placed"] += 1
        return out

    def shrink(e):
        e.apply_plan(reconfig_plan(e, max_batch=4))

    def grow(e):                 # once the shrink has drained to 4
        if e.n_slots == 4 and e._staged is None:
            e.begin_reconfig(reconfig_plan(e, max_batch=8))

    hooks = {t: grow for t in range(5, 400)}
    hooks[4] = shrink
    pool_mod.placed = spy
    try:
        me, rdone, n = mesh_twins(torch, cfg, params, ms, share, reqs,
                                  "relayout 8->4, staged 4->8", hooks)
    finally:
        pool_mod.placed = real
    events = me.take_reconfig_events()
    if seen["placed"] < 3 or me.n_slots != 8 or not any(
            ev["staged"] for ev in events):
        fail(f"engine mesh[relayout]: {seen['placed']} placements, "
             f"{me.n_slots} slots, events {events}")
    print(f"engine mesh[relayout]: the mesh engine's pool placed "
          f"{seen['placed']} times (stop-the-world 8 -> 4 held, then shrunk "
          f"after the drain, a staged 4 -> 8 commit), every tensor kept; "
          f"the staged commit {[ev['staged'] for ev in events]}", flush=True)
    add(n)
    same_tokens(torch, cfg, params, "engine mesh[relayout]", rdone, ref,
                TOLS[cfg.name], "never-reconfigured")
    del me

    eng = ServingEngine(params, cfg, share, max_seq=SERVE_MAX,
                        device=torch.device("cuda"), ms=ms,
                        param_specs=serve_param_specs(cfg, ms))
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    stats = serve_loop(eng, dense_trace(cfg))
    add(LAUNCHES)
    if stats["completed"] != len(reqs):
        fail(f"engine mesh[serve_loop]: {stats['completed']}/{len(reqs)}")
    print(f"engine mesh[serve_loop]: {stats['completed']} requests, "
          f"{stats['tokens_per_s']:.1f} tok/s, decode "
          f"{stats['decode_tok_per_s']:.1f} tok/s under the 1x1 mesh",
          flush=True)
    same_tokens(torch, cfg, params, "engine mesh[serve_loop]",
                eng.finished, ref, TOLS[cfg.name], "drive")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def engine_mesh_hybrid(torch, ms):
    """Phase 17 on full-width, full-depth zamba2-1.2b (an SSMStatePool with
    its KV slab: the selective scan, flash in prefill, paged attention
    over the slab at G = 1): ``hybrid_trace`` through ``mesh_twins``, then
    its short prompts with a max_batch 8 -> 4 relayout on both engines.
    Returns the launches of the mesh arms."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serving import DEFAULT_SERVING_SETTING
    cfg = get_config("zamba2-1.2b")
    params = lm.init_params(cfg, seed=0, device="cuda")
    setting = dict(DEFAULT_SERVING_SETTING, max_batch=8, cache_dtype="bf16")
    trace = hybrid_trace(cfg)
    _, _, la = mesh_twins(torch, cfg, params, ms, setting, trace, "zamba2")
    short = [r for r in trace if len(r.prompt) <= 96]
    me, _, lb = mesh_twins(
        torch, cfg, params, ms, setting, short, "zamba2 relayout 8->4",
        {2: lambda e: e.apply_plan(reconfig_plan(e, max_batch=4))})
    if me.setting["max_batch"] != 4:
        fail(f"engine mesh[zamba2 relayout]: setting {me.setting}")
    kernels = ("selective_scan", "flash_attention", "paged_attention")
    if not all(la[k] for k in kernels):
        fail(f"engine mesh[zamba2]: a kernel never launched: {la}")
    del me, params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: la[k] + lb[k] for k in ENGINE_KERNELS}


def engine_mesh_path(torch, ms):
    """Phase 17 on phase 15's world-1 mesh.  Returns its launches."""
    t0 = time.perf_counter()
    launches = engine_mesh_dense(torch, ms)
    for k, n in engine_mesh_hybrid(torch, ms).items():
        launches[k] += n
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"the engine under the mesh never launched {missing}")
    print(f"engine mesh: phase 17 in {time.perf_counter() - t0:.1f}s, "
          f"launches {launches}", flush=True)
    return launches


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
    check_train_kernels(torch, rows)
    rows["selective_scan"] = check_scan(torch)
    check_hybrid_kernels(torch, rows)
    check_group_kernels(torch, rows, "moe", MOE_H, MOE_K, HD, seed=21)
    check_group_kernels(torch, rows, "vlm", VLM_H, VLM_H, VLM_HD, seed=23)
    check_encoder_kernels(torch, rows)
    check_ssm_train_kernels(torch, rows)
    check_hybrid_train_flash(torch, rows)
    launches = dict.fromkeys(rows, 0)
    launches.update(dense_path(torch, card))
    # free the dense model (and its engines' pools) before falcon-mamba
    gc.collect()
    torch.cuda.empty_cache()
    print(f"freed the dense model: {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
          f" GiB still allocated", flush=True)
    launches["selective_scan"] = ssm_path(torch, card)
    # free falcon-mamba before the training runs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve launches {launches}", flush=True)
    trained, phase9 = train_path(torch)
    for name in rows:
        launches[name] += trained.get(name, 0)
    # free the training state before the hybrid model
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in hybrid_path(torch, card).items():
        launches[name] += n
    # free the hybrid model before the moe model (54 GB of weights)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"freed the hybrid model: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
          f"allocated", flush=True)
    for name, n in moe_path(torch, card).items():
        launches[name] += n
    # free the moe model before the vlm model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"freed the moe model: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
          f"allocated", flush=True)
    for name, n in vlm_path(torch, card).items():
        launches[name] += n
    # free the vlm model before the encoder
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in encoder_path(torch, card).items():
        launches[name] += n
    # free the encoder before the ssm and hybrid training runs
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in ssm_train_path(torch, card).items():
        launches[name] += n
    # free the ssm and hybrid training states before the mesh
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in mesh_path(torch, card, rows, phase9).items():
        launches[name] += n

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
