"""Continuous-batching inference engine with online-reconfigurable knobs
(dense, moe, ssm and hybrid families).

The port of the JAX package's ``serving/engine.py`` main path:

  * a FIFO request queue with block-aware admission: at most
    ``max_batch`` requests in flight; while decodes run, the continuous
    ``admit_budget`` knob meters prefills per scheduling quantum, and a
    short bounded lookahead lets small requests pass a long prompt;
  * the state pool from ``make_state_pool`` (repro_torch.serving.pool):
    ``PagedKVPool`` (dense and moe: paged KV blocks, block tables,
    copy-on-write prompt-prefix sharing) or ``SSMStatePool`` (ssm and
    hybrid: one recurrent state per slot, and the hybrid's shared-block KV
    slab);
  * prefill per request at batch 1, padded to a multiple of
    ``prefill_chunk`` (flash-attention kernel; for ssm the selective-scan
    kernel, with the state stopped at the last prompt token, and the
    hybrid's shared block through the flash kernel); a prompt
    whose prefix is cached in a paged pool computes only its suffix, as
    one multi-token paged decode step against the shared blocks
    (paged-attention kernel);
  * decode advances every live slot one token per quantum: paged decode
    reads KV blocks in place through the block table (paged-attention
    kernel), per context bucket so short batches read only their live
    blocks; ssm decode continues each slot's stored state (selective-scan
    kernel), and the hybrid's shared block reads its slab through the
    paged-attention kernel;
  * speculative decoding (``spec_k`` > 0): a drafter proposes k tokens a
    slot, one S = k+1 decode step verifies them, and the rejected tail is
    rolled back — the pool's deferred copy-on-write records (paged), or a
    snapshot of the recurrent state and a replay of the accepted tokens
    (ssm, hybrid);
  * ``quant="int8"`` re-quantizes freshly written KV rows through the
    int8 quantize/dequantize kernels.  ``quant`` and ``prefix_share``
    apply to paged pools only and are ignored for ssm pools, as in the
    JAX engine;
  * online reconfiguration: Type II = swap the step (bounded LRU) or the
    admission policy; Type I-b = re-lay the state pool out for a new
    ``max_batch`` / ``block_size`` / ``cache_dtype``, moving only the live
    blocks or slots, never quiescing the queue — stop the world
    (``apply_plan``), or staged (``begin_reconfig``): between ticks the
    engine captures the target's decode steps against a double-buffered
    pool and copies held blocks into it, then commits atomically.

Every step is built once per shape key, under the JAX package's keys, by
``aot_compile``: on the card a CUDA graph (one dispatch a step, as the JAX
package's AOT-compiled executables are), on the CPU the eager callable.
The graphs read the parameters and the pool's tensors by address and take
their per-step inputs (tokens, positions, a block-table row) through
pinned host buffers.  So a relayout, which gives the pool new tensors,
drops every step that captured the old ones (``POOL_STEPS``); a staged
commit adopts the staged tensors together with the steps captured on
them.  Captures run on the tick's thread: the JAX engine compiles on a
worker thread, but a capture there would race the tick's launches (the
global capture mode, the launch counters a capture takes back).

``serve_loop(tuner=...)`` is the self-tuning loop: per busy quantum it
feeds (offered load, tick time) to a ``TuningManager`` and stages every
plan the tuner emits.
"""
from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.lru import LRUCache, aot_compile
from repro_torch.core.reconfig import ReconfigPlan
from repro_torch.core.reconfig import classify as rc_classify
from repro_torch.core.reconfig import plan as rc_plan
from repro_torch.device import Staging, resolve_device, synchronize
from repro_torch.kernels import build_all
from repro_torch.kernels.quant import dequantize, quantize
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs
from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.obs.trace import NOP_TRACER
from repro_torch.ps.odmr import timed_blocking
from repro_torch.serving.drafter import make_drafter
from repro_torch.serving.knobs import (DEFAULT_SERVING_SETTING,
                                       SERVING_RELAYOUT_KNOBS)
from repro_torch.serving.pool import make_state_pool, pool_dtype

# step keys whose graphs capture the state pool's tensors by address (the
# KV or state, the block tables, the ssm snapshot): they go whenever the
# pool's tensors are replaced
POOL_STEPS = ("decode", "chunkpf", "replay")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32 token ids
    max_new: int                  # tokens to generate (>= 1)
    arrival_s: float = 0.0        # virtual arrival time (trace replay)
    # engine-filled:
    submit_s: float | None = None
    first_token_s: float | None = None
    done_s: float | None = None
    tokens_out: list = field(default_factory=list)

    @property
    def latency_s(self) -> float | None:
        return None if self.done_s is None else self.done_s - self.arrival_s

    @property
    def ttft_s(self) -> float | None:
        return (None if self.first_token_s is None
                else self.first_token_s - self.arrival_s)


class ServingEngine:
    ADMIT_LOOKAHEAD = 4           # queue positions scanned past a head
                                  # request whose blocks don't fit yet

    def __init__(self, params, cfg, setting: dict | None = None, *,
                 max_seq: int = 96, step_cache_size: int = 24,
                 attn_impl: str = "paged", tracer=None, metrics=None,
                 device=None):
        """``device`` defaults to the CUDA device and raises without one;
        pass ``device="cpu"`` to run the plain versions on the CPU.
        ``params`` must already live on that device."""
        lm.check_decodes(cfg)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.attn_impl = attn_impl
        self.setting = dict(DEFAULT_SERVING_SETTING)
        self.setting.update(setting or {})
        self.tr = tracer or NOP_TRACER
        self.metrics = metrics or NULL_METRICS
        self._steps = LRUCache(step_cache_size)
        self._steps.tracer = self.tr
        cuda = self.device.type == "cuda"
        # one memory pool for every captured step of this engine
        self._graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        # per-step inputs reach the steps through pinned buffers (C5)
        self._stage = Staging(self.device).put
        self.queue: deque[Request] = deque()
        self._set_pool(make_state_pool(cfg, self.setting, max_seq,
                                       self.device))
        self.clock = 0.0              # wall time supplied by serve_loop
        self._admit_acc = 0.0         # fractional admit_budget carry
        self.submitted: list[int] = []
        self.finished: list[Request] = []
        self.total_tokens = 0
        self.ticks = 0
        self.prefill_tokens_computed = 0   # tokens actually prefilled
        self.prefill_tokens_total = 0      # tokens the prompts contained
        self.decode_time_s = 0.0           # wall time inside decode steps
        self.decode_tokens = 0             # tokens those steps produced
        # speculative decoding (spec_k / drafter are Type II knobs: the
        # drafters hold host token histories, and the truncated one its
        # own captured step, never pool state)
        self.spec_drafted = 0              # draft tokens proposed
        self.spec_accepted = 0             # draft tokens verified-accepted
        self.spec_ticks = 0                # speculative decode quanta
        self._drafters: dict = {}          # drafter name -> instance
        self._drafter_seed = 0
        self.capture_stats: dict = {}      # warm_start's captures
        self.last_reconfig_breakdown = {}  # measured per-kind s, last plan
        self.last_reconfig_scales = {}     # units migrated, last plan
        # staged (zero-downtime) reconfiguration — begin_reconfig stages a
        # plan, ticks capture + migrate in the background, and a commit
        # event is queued for the driver (serve_loop) to report to the tuner
        self._staged: dict | None = None
        self._reconfig_events: list[dict] = []
        self.async_precompile = True       # False: capture all in
                                           # begin_reconfig (tests)
        self.migrate_batch_blocks = 8      # bg blocks copied per tick
        self.migrate_drain_ticks = 200     # shrink-drain bail-out to the
                                           # stop-the-world relayout

    def _set_pool(self, pool):
        """Adopt a new state pool (and drop the steps of the old one)."""
        self.pool = pool
        self._drop_pool_steps()
        self._reset_slots()

    def _drop_pool_steps(self):
        """The graphs captured on the pool's previous tensors read and write
        them by address — replayed now, they would write freed memory — so
        they are destroyed whenever the tensors are replaced (a new pool, a
        relayout, a staged commit), inside that window."""
        self._steps.drop(lambda key: key[0] in POOL_STEPS)

    def _reset_slots(self):
        n = self.pool.n_slots
        self.slot_req: list[Request | None] = [None] * n
        self.slot_pos = np.zeros(n, np.int32)   # next KV write position
        self.slot_tok = np.zeros(n, np.int32)   # last sampled token

    # ----------------------------------------------------------- properties
    @property
    def n_slots(self) -> int:
        return self.pool.n_slots

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def load(self) -> int:
        return self.n_active + self.queue_depth

    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def _spec_k(self) -> int:
        """The continuous ``spec_k`` knob as a draft length: rounded and
        clamped to [0, 4]; 0 = speculation off (one token a tick)."""
        return max(0, min(int(round(float(self.setting.get("spec_k", 0.0)
                                          or 0.0))), 4))

    # ----------------------------------------------------------- lifecycle
    def set_tracer(self, tracer, metrics=None):
        """Attach (or, with NOP_TRACER, detach) observability sinks.  The
        step cache shares the tracer so capture time is attributed wherever
        it fires — inside a reconfiguration window when warmed, inside a
        tick when a cold step slips through."""
        self.tr = tracer
        self._steps.tracer = tracer
        if metrics is not None:
            self.metrics = metrics

    def submit(self, req: Request, now: float | None = None):
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if len(req.prompt) + req.max_new > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt({len(req.prompt)}) + "
                f"max_new({req.max_new}) exceeds max_seq({self.max_seq})")
        req.submit_s = self.clock if now is None else now
        self.queue.append(req)
        self.submitted.append(req.rid)

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _compile(self, fn, *example_args, inputs=(), state=()):
        """``aot_compile`` on this engine's device and graph memory pool."""
        return aot_compile(fn, *example_args, device=self.device,
                           inputs=inputs, state=state,
                           pool=self._graph_pool)

    def _zeros(self, shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    # ---------------------------------------------------------- step cache
    def _ctx_buckets(self) -> tuple:
        """Context buckets of the paged decode step: numbers of visible
        block-table columns (at most 6 per pool geometry); 0 = the full
        table (the gather path) or no table at all (ssm pools)."""
        if self.pool.kind != "paged":
            return (0,)
        return self._ctx_buckets_for(self.pool.mb)

    def _ctx_buckets_for(self, mb: int) -> tuple:
        if self.attn_impl == "gather":
            return (0,)
        g = -(-mb // 6)
        return tuple(sorted({min(t * g, mb) for t in range(1, 7)}))

    def _ctx_cols(self, last_pos: int) -> int:
        """Smallest context bucket covering logical position ``last_pos``."""
        buckets = self._ctx_buckets()
        if buckets == (0,):
            return 0
        need = min(last_pos // self.pool.bs + 1, self.pool.mb)
        return next(c for c in buckets if c >= need)

    def _decode_exec(self, ctx_cols: int = 0, s: int = 1):
        """Decode step of ``s`` query tokens per slot over the pool (s = 1
        is the classic decode step; s = spec_k + 1 is the speculative
        verify step).  Inputs: tok (n, s) int64, pos (n,) int32."""
        key = ("decode", self.attn_impl, ctx_cols, s) + self.pool.exec_key()
        return self._steps.get_or_create(
            key, lambda: self._decode_build(ctx_cols, s,
                                            self.pool.decode_cache(),
                                            self.pool.n_slots))

    def _replay_exec(self, s: int):
        """The ssm rollback's step: ``s`` tokens a slot decoded from the
        pool's speculative snapshot (``pool.saved``), written in place."""
        key = ("replay", s) + self.pool.exec_key()
        return self._steps.get_or_create(
            key, lambda: self._decode_build(0, s, self.pool.saved,
                                            self.pool.n_slots))

    def _decode_build(self, ctx_cols: int, s: int, cache: dict, n: int):
        """The decode step of ``n`` slots over ``cache`` — the live pool's
        tensors, its ssm snapshot, or a staged migration's double buffer."""
        cfg = self.cfg
        kn = ModelKnobs(attn_impl=self.attn_impl, attn_ctx=ctx_cols)

        def f(params, cache, tok, pos):
            return lm.decode_step(params, cache, tok, pos, cfg, kn)

        return self._compile(f, self.params, cache, self._zeros((n, s)),
                             self._zeros((n,), torch.int32), inputs=(2, 3),
                             state=(1,))

    def _prefill_exec(self, bucket: int):
        """Prefill of one right-padded prompt.  Inputs: tokens (1, bucket)
        int64, last_idx (1,) int64 — on the device, so one step serves
        every prompt length of its bucket."""
        key = ("prefill", bucket, self.setting["k_chunk"])

        def build():
            cfg = self.cfg
            kn = ModelKnobs(k_chunk=self.setting["k_chunk"])

            def f(params, tokens, last_idx):
                # valid_len: the ssm family must not fold right-pad tokens
                # into the recurrent state (attention ignores it)
                hidden, cache = lm.forward(params, tokens, cfg, kn,
                                           mode="prefill",
                                           valid_len=last_idx + 1)
                last = hidden.index_select(1, last_idx)
                return lm.logits_fn(params, last, cfg)[:, 0], cache

            return self._compile(f, self.params, self._zeros((1, bucket)),
                                 self._zeros((1,)), inputs=(1, 2))

        return self._steps.get_or_create(key, build)

    def _chunk_prefill_exec(self, bucket: int):
        """Suffix prefill against shared prefix blocks: one multi-token
        paged decode step; queries attend the prior blocks through the
        block table and write their own KV into the slot's blocks.  COW
        for shared blocks in the write range runs before the step.
        Inputs: the slot's table row (1, MB) int32, tokens (1, bucket)
        int64, start (1,) int32, last_idx (1,) int64."""
        key = ("chunkpf", bucket, self.attn_impl) + self.pool.exec_key()

        def build():
            cfg = self.cfg
            kn = ModelKnobs(attn_impl=self.attn_impl)

            def f(params, kv, tables, tokens, start, last_idx):
                cache = {"k": kv["k"], "v": kv["v"], "block_tables": tables}
                hidden, new_cache = lm.forward(params, tokens, cfg, kn,
                                               mode="decode", cache=cache,
                                               pos=start)
                last = hidden.index_select(1, last_idx)
                return (lm.logits_fn(params, last, cfg)[:, 0],
                        {"k": new_cache["k"], "v": new_cache["v"]})

            kv = {"k": self.pool.kv["k"], "v": self.pool.kv["v"]}
            return self._compile(
                f, self.params, kv,
                self._zeros((1, self.pool.mb), torch.int32),
                self._zeros((1, bucket)), self._zeros((1,), torch.int32),
                self._zeros((1,)), inputs=(2, 3, 4, 5), state=(1,))

        return self._steps.get_or_create(key, build)

    def _quant_exec(self, n: int):
        """int8 KV storage: per-(layer, position) blockwise quantization
        (block = K * hd) with deterministic rounding (u = 0.5), through the
        quantize/dequantize kernels.  The rows (L, n, K, hd) are bf16 (the
        model's activations), u is one value expanded (the kernel reads it
        once), and the rows come back in the pool's dtype.  One step per
        row count and pool dtype (a ``cache_dtype`` switch must not reuse
        the step that rounds to the old dtype)."""
        out_dtype = pool_dtype(self.setting)
        key = ("quant", n, str(out_dtype).removeprefix("torch."))

        def build():
            cfg = self.cfg
            block = max(cfg.n_kv_heads * cfg.hd, 1)
            half = torch.full((1,), 0.5, device=self.device)

            def f(kv):                       # (L, n, K, hd)
                flat = kv.reshape(-1)
                q, scales = quantize(flat, half.expand(flat.shape[0]),
                                     block=block)
                return dequantize(q, scales, block=block,
                                  out_dtype=out_dtype).reshape(kv.shape)

            rows = self._zeros((cfg.n_layers, n, cfg.n_kv_heads, cfg.hd),
                               torch.bfloat16)
            return self._compile(f, rows, inputs=(0,))

        return self._steps.get_or_create(key, build)

    # -------------------------------------------------------------- admit
    def _bucket(self, plen: int, chunk: int | None = None) -> int:
        chunk = chunk or self.setting["prefill_chunk"]
        return min(-(-plen // chunk) * chunk, self.max_seq)

    def _try_admit(self, req: Request) -> bool:
        with self.tr.span("serve.admit", rid=req.rid, plen=len(req.prompt)):
            return self._admit(req)

    def _admit(self, req: Request) -> bool:
        res = self.pool.try_admit(req.prompt, req.max_new)
        if res is None:
            return False
        slot, shared = res
        P = len(req.prompt)
        # every step's outputs are read (logits) or copied (KV rows) before
        # the next step runs: the captured steps share one memory pool, and
        # a replay may reuse the memory of another step's outputs
        if shared > 0:
            # shared-prefix path: prefill only the suffix as one multi-token
            # paged decode step.  COW runs first; bucket-pad positions
            # write into the slot's reserved/trash blocks and are rewritten
            # by decode before any query can see them.
            sfx = req.prompt[shared:]
            n = len(sfx)
            bucket = self._bucket(n)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :n] = sfx
            self.pool.prepare_write(slot, shared, P)
            with self.tr.span("serve.chunk_prefill", bucket=bucket,
                              suffix=n, shared=shared):
                logits, newc = self._chunk_prefill_exec(bucket)(
                    self.params, {"k": self.pool.kv["k"],
                                  "v": self.pool.kv["v"]},
                    self._stage("table", self.pool.tables[slot:slot + 1]),
                    self._stage("tokens", padded, torch.long),
                    self._stage("start", [shared]),
                    self._stage("last_idx", [n - 1], torch.long))
                self.pool.set_cache(newc)
                tok = int(torch.argmax(logits[0]))
            if self.setting["quant"] == "int8":
                # re-quantize the freshly written suffix rows at bucket
                # granularity; rows past the cache boundary are zero-padded
                # back to the bucket and discarded by the bounded write.
                # The rows are the step's bf16 activations (the pool holds
                # them exactly, in bf16 or f32), read back as bf16.
                with self.tr.span("serve.quant", bucket=bucket):
                    m = min(bucket, self.max_seq - shared)
                    pos = np.arange(shared, shared + m)
                    blk = self._tensor(self.pool.tables[slot,
                                                        pos // self.pool.bs],
                                       torch.long)
                    off = self._tensor(pos % self.pool.bs, torch.long)
                    for name in ("k", "v"):
                        rows = self.pool.kv[name][:, blk, off].to(
                            torch.bfloat16)
                        if m < bucket:
                            rows = torch.nn.functional.pad(
                                rows, (0, 0, 0, 0, 0, bucket - m))
                        rows = self._quant_exec(bucket)(rows)
                        self.pool.write_kv(slot, {name: rows[:, :n]},
                                           start=shared)
            self.prefill_tokens_computed += n
        else:
            bucket = self._bucket(P)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :P] = req.prompt
            with self.tr.span("serve.prefill", bucket=bucket, plen=P):
                logits, pcache = self._prefill_exec(bucket)(
                    self.params, self._stage("tokens", padded, torch.long),
                    self._stage("last_idx", [P - 1], torch.long))
                tok = int(torch.argmax(logits[0]))
                if self.pool.kind == "paged":
                    kv = {k: pcache[k][:, 0] for k in ("k", "v")}
                    if self.setting["quant"] == "int8":
                        # copied out first: the quant step's replays may
                        # reuse the prefill step's output memory
                        kv = {k: v.clone() for k, v in kv.items()}
                        with self.tr.span("serve.quant", bucket=bucket):
                            for name in ("k", "v"):
                                rows = self._quant_exec(bucket)(kv[name])
                                self.pool.write_kv(
                                    slot, {name: rows[:, :P]}, start=0)
                    else:
                        self.pool.write_kv(slot, {k: v[:, :P]
                                                  for k, v in kv.items()},
                                           start=0)
                else:
                    self.pool.write_prefill(slot, pcache, P)
            self.prefill_tokens_computed += P
        self.prefill_tokens_total += P
        req.tokens_out = [tok]
        req.first_token_s = self.clock
        self.total_tokens += 1
        self.slot_req[slot] = req
        self.slot_pos[slot] = P
        self.slot_tok[slot] = tok
        if len(req.tokens_out) >= req.max_new:
            self._complete(slot)
        return True

    def _complete(self, slot: int):
        req = self.slot_req[slot]
        req.done_s = self.clock
        self.finished.append(req)
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0       # stale positions must not inflate the
        self.pool.release(slot)       # next tick's decode context bucket
        for d in self._drafters.values():
            d.release(slot)

    # ------------------------------------------------- speculative decoding
    def _drafter(self):
        name = self.setting.get("drafter", "ngram")
        d = self._drafters.get(name)
        if d is None:
            d = make_drafter(name, self.params, self.cfg,
                             vocab=self.cfg.vocab_size,
                             seed=self._drafter_seed, device=self.device,
                             graph_pool=self._graph_pool)
            self._drafters[name] = d
        return d

    def reset_drafters(self, seed: int = 0):
        """Drop all drafter state and reseed, so n-gram tables never leak
        across runs and random fallback draws are deterministic per
        seed."""
        self._drafter_seed = int(seed)
        self._drafters = {}

    def _spec_decode(self, active: list, k: int) -> int:
        """One speculative decode quantum: draft k tokens per live slot,
        verify all of them in ONE batched S = k+1 decode step against the
        target model, commit the accepted prefix plus the target's own
        next token, and roll the rejected tail back.

        Greedy parity by construction: token j is emitted only if it is
        the target argmax at its position given the previously committed
        tokens.  KV rows of rejected positions were written during verify,
        but decode always writes its rows before attention reads them and
        masks kvp <= qp, so stale rows are overwritten before any query
        can see them: a paged pool only settles its deferred COW records.
        An ssm pool's state was written in place by the verify step, so it
        is restored from a snapshot taken before it, by replaying each
        slot's accepted tokens (``_ssm_replay``).

        The verify step (and the ssm replay steps) are captured on this,
        the tick's, thread at their first use, where the JAX engine builds
        them on a daemon thread and decodes one token at a time until they
        are ready: a capture is one eager step and one capture (no
        compiler), and a capture on a second thread would fail under the
        default global capture mode while this thread launches work."""
        S = k + 1
        drafter = self._drafter()
        tok = np.zeros((self.n_slots, S), np.int64)
        with self.tr.span("decode.draft", batch=len(active), k=k,
                          drafter=drafter.name):
            for s in active:
                req = self.slot_req[s]
                drafter.update(s, req.rid, req.prompt, req.tokens_out)
                tok[s, 0] = self.slot_tok[s]
                tok[s, 1:] = drafter.propose(s, k)
        self.spec_ticks += 1
        self.spec_drafted += k * len(active)

        pos0 = self.slot_pos.copy()          # pre-tick write positions
        recs = {}
        if self.pool.kind == "paged":
            # COW over the whole speculative write range [P, P+S), with
            # shared-block releases DEFERRED so the rollback can restore
            # the original block when the write turns out rejected
            for s in active:
                p = int(pos0[s])
                recs[s] = self.pool.prepare_spec_write(
                    s, p, min(p + S, self.max_seq))
        else:
            self.pool.save_state()           # a real copy: verify writes
                                             # the state in place
        cols = self._ctx_cols(int(pos0[active].max()) + k)
        with self.tr.span("decode.verify", batch=len(active), cols=cols,
                          s=S):
            t_dec = time.perf_counter()
            logits, new_cache = self._decode_exec(cols, S)(
                self.params, self.pool.decode_cache(),
                self._stage("tok", tok, torch.long),
                self._stage("pos", pos0))
            synchronize(self.device)
            self.decode_time_s += time.perf_counter() - t_dec
        self.pool.set_cache(new_cache)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()        # (n, S)

        emitted = 0
        accepted_len = {}                    # slot -> tokens emitted (a+1)
        done = []
        for s in active:
            req = self.slot_req[s]
            p = int(pos0[s])
            # emission cap: never emit past max_new, and keep the next
            # write position below max_seq - 1 (the submit-time contract)
            cap = min(req.max_new - len(req.tokens_out),
                      self.max_seq - 1 - p)
            a = 0
            while a < k and a + 1 < cap and tok[s, a + 1] == nxt[s, a]:
                a += 1
            for j in range(a + 1):
                req.tokens_out.append(int(nxt[s, j]))
            self.spec_accepted += a
            emitted += a + 1
            self.total_tokens += a + 1
            self.decode_tokens += a + 1
            accepted_len[s] = a + 1
            self.slot_pos[s] = p + a + 1
            self.slot_tok[s] = nxt[s, a]
            if (len(req.tokens_out) >= req.max_new
                    or self.slot_pos[s] >= self.max_seq - 1):
                done.append(s)

        with self.tr.span("decode.rollback", batch=len(active)):
            if self.pool.kind == "paged":
                # must run before _complete: release() frees the slot's
                # blocks, and the deferred-COW decrements settle refcounts
                for s in active:
                    self.pool.commit_spec_write(
                        s, recs[s], int(pos0[s]) + accepted_len[s])
            else:
                self._ssm_replay(active, accepted_len, tok, pos0, S)
        for s in done:
            self._complete(s)
        return emitted

    def _ssm_replay(self, active, accepted_len, tok, pos0, S):
        """Recurrent-state rollback: snapshot + replay.  Slots that
        accepted the whole draft keep the verify step's state; every other
        slot's state is recomputed from the snapshot by decoding exactly
        its accepted tokens.  The replay steps run on the snapshot itself,
        in place, in order of accepted length: each continues from where
        the last stopped (the state after ``done`` tokens) with the next
        ``L - done`` tokens, and then the slots that accepted L tokens copy
        their rows of the snapshot's leaves into the pool.  Each width is
        one step, 1..k.  The hybrid's slab is not snapshotted: the replay
        steps write its rows at the replayed positions again, and rows of
        rejected positions are masked and rewritten before any query reads
        them (``_spec_decode``)."""
        partial = sorted({accepted_len[s] for s in active
                          if accepted_len[s] < S})
        done = 0
        for L in partial:
            slots = [s for s in active if accepted_len[s] == L]
            self._replay_exec(L - done)(
                self.params, self.pool.saved,
                self._stage("tok", tok[:, done:L], torch.long),
                self._stage("pos", pos0 + done))
            idx = self._stage("slots", slots, torch.long)
            for name in self.pool.SNAPSHOT:
                self.pool.state[name][:, idx] = self.pool.saved[name][:, idx]
            done = L

    # ---------------------------------------------------------------- tick
    def step(self, now: float | None = None) -> dict:
        """One scheduling quantum.  Returns tick metrics for serve_loop."""
        if now is not None:
            self.clock = now
        with self.tr.span("serve.tick"):
            return self._tick()

    def _tick(self) -> dict:
        t0 = time.perf_counter()
        self.ticks += 1
        tokens = 0

        # admission: fill an idle engine greedily; while decodes run, the
        # continuous admit_budget knob meters prefills per quantum
        if self.n_active > 0:
            ab = float(self.setting.get("admit_budget", 1.0))
            self._admit_acc = min(self._admit_acc + ab, max(ab, 4.0))
            budget = int(self._admit_acc)
            self._admit_acc -= budget
        else:
            self._admit_acc = 0.0
            budget = self._max_batch_cap()
        while (self.queue and budget > 0
               and self.n_active < self._max_batch_cap()):
            admitted = False
            for i in range(min(len(self.queue), self.ADMIT_LOOKAHEAD)):
                if self._try_admit(self.queue[i]):
                    del self.queue[i]
                    admitted = True
                    break
            if not admitted:
                break
            tokens += 1
            budget -= 1

        # decode: every live slot advances one token, through the smallest
        # context bucket covering the batch's highest write position
        # (spec_k > 0: the drafter proposes k tokens a slot and one S = k+1
        # step verifies them — the served tokens are the plain greedy ones)
        if self.n_active > 0:
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            k = self._spec_k()
            tokens += (self._spec_decode(active, k) if k > 0
                       else self._decode(active))

        # staged reconfiguration: one capture of the target's steps, one
        # background-migration batch, commit when captured + copied; all on
        # this thread, so its seconds are the switch's (``reconfig_s``), not
        # the incumbent setting's
        reconfig_s = 0.0
        if self._staged is not None:
            r0 = time.perf_counter()
            self._advance_staged()
            reconfig_s = time.perf_counter() - r0

        # a shrink that had to wait for live slots (relayout keeps every
        # in-flight request) completes once the backlog drains; deferred
        # while a staged reconfiguration is in flight — its commit lands
        # the pool on the target geometry itself
        if (self._staged is None
                and self.pool.n_slots > self.setting["max_batch"]
                and self.n_active <= self.setting["max_batch"]):
            self._relayout_pool()

        dt = time.perf_counter() - t0
        if self.metrics.enabled:
            self.metrics.histogram("serve.tick_s").observe(dt)
            self.metrics.gauge("serve.active_slots").set(self.n_active)
            self.metrics.gauge("serve.queue_depth").set(self.queue_depth)
            snap = self.pool.snapshot()
            if "block_utilization" in snap:       # paged pools only
                self.metrics.gauge("pool.block_utilization").set(
                    snap["block_utilization"])
        return {"dt": dt, "reconfig_s": reconfig_s,
                "tokens": tokens, "active": self.n_active,
                "queued": self.queue_depth, "load": self.load,
                "idle": tokens == 0 and not self.has_work()}

    def _decode(self, active: list) -> int:
        """One decode quantum: every live slot advances one token."""
        self.pool.prepare_step_writes(active, self.slot_pos)
        cols = self._ctx_cols(int(self.slot_pos[active].max()))
        with self.tr.span("serve.decode", batch=len(active), cols=cols):
            t_dec = time.perf_counter()
            logits, new_cache = self._decode_exec(cols)(
                self.params, self.pool.decode_cache(),
                self._stage("tok", self.slot_tok[:, None], torch.long),
                self._stage("pos", self.slot_pos))
            synchronize(self.device)
            self.decode_time_s += time.perf_counter() - t_dec
            self.decode_tokens += len(active)
        self.pool.set_cache(new_cache)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for slot in active:
            req = self.slot_req[slot]
            self.slot_pos[slot] += 1
            self.slot_tok[slot] = nxt[slot]
            req.tokens_out.append(int(nxt[slot]))
            self.total_tokens += 1
            if (len(req.tokens_out) >= req.max_new
                    or self.slot_pos[slot] >= self.max_seq - 1):
                self._complete(slot)
        return len(active)

    # ------------------------------------------------------------ startup
    def warm_start(self, space=None, max_prompt: int | None = None):
        """Server startup: build the CUDA kernels (one nvcc per source, in
        parallel; a no-op when they are built or on the CPU) and the steps
        the knob ``space`` can reach (``None``: the current setting only).

        Steps that hold no pool tensor are built across the space: prefill
        per (length bucket, k_chunk) over every ``prefill_chunk``'s
        buckets, and int8 quantization per bucket and pool dtype when
        ``int8`` is reachable.  Steps that capture the pool by address are
        built for the live pool only: decode per context bucket (and the S
        = spec_k + 1 verify step per bucket when speculating), and for a
        paged pool shared-prefix suffix prefill per bucket when sharing is
        reachable.  Another geometry's steps would hold tensors that die at
        once: a relayout captures them in its window, a staged
        reconfiguration against its double buffer, and a cold verify width
        or suffix bucket at its first use.  The step cache is sized so
        that nothing warmed here is evicted.  On the card each step is a
        graph; the time the captures took and the memory they hold go to
        ``capture_stats`` and are printed."""
        assert self.n_active == 0, "warm_start before serving, not during"
        if space is None:
            values = {k: (v,) for k, v in self.setting.items()}
        else:
            # continuous knobs (admit_budget, spec_k, block_overcommit)
            # never change a step here
            values = {k.name: (k.values if k.kind != "continuous"
                               else (self.setting.get(k.name),))
                      for k in space.knobs}
        cuda = self.device.type == "cuda"
        if cuda:
            build_all()
            synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
        paged = self.pool.kind == "paged"
        chunks = values.get("prefill_chunk", (self.setting["prefill_chunk"],))
        hi = min(max_prompt or self.max_seq, self.max_seq)
        buckets = sorted({self._bucket(p, c)
                          for c in chunks for p in range(1, hi + 1)})
        kcs = values.get("k_chunk", (self.setting["k_chunk"],))
        cds = values.get("cache_dtype", (self.setting["cache_dtype"],))
        int8 = paged and "int8" in values.get("quant", ())
        share = paged and any(values.get("prefix_share", (False,)))
        spec_s = self._spec_k() + 1
        # verify widths the tuner can reach: the top of spec_k's range
        spec = [k for k in (space.knobs if space is not None else ())
                if k.name == "spec_k"]
        widths = int(spec[0].values[1]) if spec else spec_s - 1
        self._steps.capacity = max(
            self._steps.capacity,
            len(kcs) * len(buckets) + (len(cds) * len(buckets) if int8 else 0)
            + 6 * (1 + widths) + (len(buckets) if share else 0) + widths + 2)
        t0 = time.perf_counter()
        built = len(self._steps)
        for cols in self._ctx_buckets():
            self._decode_exec(cols)
            if spec_s > 1:
                self._decode_exec(cols, spec_s)
        if share:
            for b in buckets:
                self._chunk_prefill_exec(b)
        save = dict(self.setting)
        for kc in kcs:
            self.setting["k_chunk"] = kc
            for b in buckets:
                self._prefill_exec(b)
        for cd in (cds if int8 else ()):
            self.setting["cache_dtype"] = cd
            for b in buckets:
                self._quant_exec(b)
        self.setting = save
        if cuda:
            synchronize(self.device)
            torch.cuda.empty_cache()
            self.capture_stats = {
                "steps": len(self._steps) - built,
                "capture_s": time.perf_counter() - t0,
                "graph_bytes": (torch.cuda.memory_reserved(self.device)
                                - reserved)}
            print(f"warm-start: captured {self.capture_stats['steps']} "
                  f"steps as CUDA graphs in "
                  f"{self.capture_stats['capture_s']:.2f}s; the graph "
                  f"memory pool and static buffers hold "
                  f"{self.capture_stats['graph_bytes'] / 2 ** 20:.1f} MiB",
                  flush=True)

    # ------------------------------------------------------------ reconfig
    def reconfigure(self, new_setting: dict) -> float:
        """Plan + execute a switch to ``new_setting`` (classifying the
        engine's pool knobs as Type I-b).  Returns the observed cost."""
        p = rc_plan(self.setting, dict(new_setting),
                    mesh_knobs=SERVING_RELAYOUT_KNOBS)
        return self.apply_plan(p)

    def apply_plan(self, plan: ReconfigPlan) -> float:
        """Execute a reconfiguration stop-the-world; returns its observed
        cost (seconds, the device's work included).

        Type I-b: re-lay the pool out (new ``max_batch`` / ``block_size``
        / ``cache_dtype``) — only live blocks or slots move, the queue
        keeps filling, nothing is dropped.  Type II: the decode steps of
        the new setting are captured inside this window (policy-only knobs
        like ``admit_budget`` and ``prefix_share`` take effect at once).
        The relayout decision is re-derived with the engine's own knob
        classes rather than trusted from ``plan.kinds``."""
        with self.tr.span("reconfig.apply", kinds=",".join(plan.kinds)):
            t0 = time.perf_counter()
            kinds = rc_classify(self.setting, plan.new,
                                mesh_knobs=SERVING_RELAYOUT_KNOBS)
            self.setting.update(plan.new)
            relayout_s = 0.0
            if "I-b" in kinds:
                r0 = time.perf_counter()
                self._relayout_pool()
                relayout_s = time.perf_counter() - r0
            else:
                self.pool.update_policy(self.setting)    # policy knobs
            # every context bucket's decode step, so no tick pays a capture
            # (a verify width is captured at its first use)
            for cols in self._ctx_buckets():
                self._decode_exec(cols)
            synchronize(self.device)
            # the measured per-kind breakdown (the I-b portion is the timed
            # relayout) and the units it moved, for the cost model
            self.last_reconfig_breakdown = (
                {"I-b": relayout_s} if "I-b" in kinds else {})
            self.last_reconfig_scales = (
                {"I-b": self.pool.last_relayout_blocks}
                if "I-b" in kinds else {})
            return time.perf_counter() - t0

    def set_attn_impl(self, impl: str):
        """Switch the paged-attention implementation ("paged" | "gather").
        Steps are keyed on it, so this is a plain Type II swap."""
        assert impl in ("paged", "gather"), impl
        self.attn_impl = impl
        for cols in self._ctx_buckets():     # warm before the next tick
            self._decode_exec(cols)

    # ------------------------------------ staged (zero-downtime) reconfig
    def _max_batch_cap(self) -> int:
        """Admission ceiling.  While a staged shrink is in flight the cap
        is the *target* max_batch, so admissions do not refill the slots
        the migration waits to drain."""
        cap = int(self.setting["max_batch"])
        if self._staged is not None:
            cap = min(cap, int(self._staged["target"]["max_batch"]))
        return max(cap, 1)

    def _live_extents(self) -> dict:
        """{slot: (written, reserved)} for every live request — what both
        relayout and staged-migration commit preserve."""
        out = {}
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            written = int(self.slot_pos[slot])    # state valid for [0, w)
            reserved = min(len(req.prompt) + req.max_new, self.max_seq)
            out[slot] = (written, reserved)
        return out

    def _hot_blocks(self) -> set:
        """Blocks the very next decode tick will write: each live slot's
        current tail block.  The migration skips them (they would be dirty
        again one tick later) and they ride the commit-time delta."""
        hot: set = set()
        if self.pool.kind != "paged":
            return hot
        for s, r in enumerate(self.slot_req):
            if r is None:
                continue
            col = min(int(self.slot_pos[s]) // self.pool.bs,
                      self.pool.mb - 1)
            hot.add(int(self.pool.tables[s, col]))
        hot.discard(0)
        return hot

    def _target_geometry(self, setting: dict) -> dict:
        """The canonical paged-pool geometry ``make_state_pool(setting)``
        lands on (n_slots = max_batch, dense-worst-case block count) — what
        a staged migration double-buffers into, so the committed pool has
        exactly the keys of the steps captured against the buffer."""
        bs = int(setting["block_size"])
        mb = -(-self.max_seq // bs)
        n_slots = max(int(setting["max_batch"]), 1)
        return {"bs": bs, "mb": mb, "n_slots": n_slots,
                "nb": n_slots * mb + 1,
                "cache_dtype": setting.get("cache_dtype")}

    def begin_reconfig(self, plan: ReconfigPlan):
        """Stage a zero-downtime switch to ``plan.new``.  The incumbent
        setting keeps serving; between ticks the engine (1) captures the
        target geometry's decode steps against the double-buffered pool of
        ``PagedKVPool.begin_migration`` and (2) copies cold held blocks into
        it, then commits atomically once both are done
        (``_advance_staged``), adopting the staged tensors with their
        steps.  A move that cannot stage (a block-size change, an ssm pool,
        a Type II-only plan) commits at the next tick, where a Type I-b one
        pays the stop-the-world relayout and its captures.  The driver
        learns the outcome through ``take_reconfig_events``.  One staged
        plan at a time; a newer one supersedes an in-flight one."""
        if self._staged is not None:
            self.cancel_staged()
        target = dict(self.setting)
        target.update(plan.new)
        kinds = rc_classify(self.setting, plan.new,
                            mesh_knobs=SERVING_RELAYOUT_KNOBS)
        st = {"plan": plan, "target": target, "kinds": kinds,
              "t0": time.perf_counter(), "incremental": False,
              "todo": [], "graphs": {}, "drain_ticks": 0,
              "bg_migrate_s": 0.0, "bg_precompile_s": 0.0,
              "bg_capture_failures": 0}
        if self.pool.kind == "paged" and "I-b" in kinds:
            st["incremental"] = self.pool.begin_migration(target)
        if st["incremental"]:
            # only the S = 1 steps gate the commit; a verify width is
            # captured at its first use after the flip
            geom = self._target_geometry(target)
            st["todo"] = [("decode", self.attn_impl, cols, 1, "paged",
                           geom["n_slots"], geom["nb"], geom["bs"],
                           geom["cache_dtype"])
                          for cols in self._ctx_buckets_for(geom["mb"])]
        self._staged = st
        if not self.async_precompile:
            while st["todo"]:
                self._capture_staged(st)

    def _capture_staged(self, st: dict):
        """Capture one of the staged target's decode steps against the
        double buffer, on the tick's thread, between ticks.  A capture that
        fails is reported and counted (``bg_capture_failures`` in the
        commit event), and the commit captures that step in its own
        window."""
        key = st["todo"].pop(0)
        t0 = time.perf_counter()
        with self.tr.span("exec.precompile_bg", key=str(key)):
            try:
                st["graphs"][key] = self._decode_build(
                    key[2], 1, self.pool.staged_cache(), key[5])
            except Exception as e:  # noqa: BLE001 — counted and reported
                st["bg_capture_failures"] += 1
                print(f"staged capture of {key} failed: {e!r}",
                      file=sys.stderr, flush=True)
        dur = time.perf_counter() - t0
        st["bg_precompile_s"] += dur
        self._steps.build_time_s += dur

    def _advance_staged(self):
        """One between-ticks quantum of the staged pipeline: one capture,
        one bounded batch of cold blocks copied, and the commit once every
        step is captured, every block copied and (for a shrink) the live
        set drained."""
        st = self._staged
        if st["incremental"] and self.pool._mig is None:
            # relaid out stop-the-world mid-flight: the buffer is gone
            st.update(incremental=False, todo=[], graphs={})
        if st["todo"]:
            self._capture_staged(st)
        pending = 0
        if st["incremental"]:
            skip = self._hot_blocks()
            if self.pool.migration_pending(skip=skip) > 0:
                with self.tr.span("reconfig.migrate_bg",
                                  batch=self.migrate_batch_blocks):
                    pending, dt = timed_blocking(
                        self.pool.migration_step, self.migrate_batch_blocks,
                        skip, device=self.device)
                    st["bg_migrate_s"] += dt
        if st["todo"] or pending > 0:
            return
        if (st["incremental"]
                and self.n_active > int(st["target"]["max_batch"])):
            # shrink: wait for the admission cap to drain the live set
            # below the target slot count; a backlog that refuses to drain
            # bails out to the stop-the-world fallback (whose shrink
            # deferral keeps the old geometry until it can)
            st["drain_ticks"] += 1
            if st["drain_ticks"] < self.migrate_drain_ticks:
                return
        self._commit_staged()

    def _commit_staged(self):
        """Atomic adoption of the staged reconfiguration.  The foreground
        work left is the delta copy (blocks dirtied since their background
        copy), the table swap and the device barrier — the stall the
        staged pipeline exists to minimize."""
        st = self._staged
        plan = st["plan"]
        with self.tr.span("reconfig.commit", kinds=",".join(st["kinds"])):
            t0 = time.perf_counter()
            self.setting.update(plan.new)
            relayout_s = 0.0
            committed = False          # True = incremental commit succeeded
            if "I-b" in st["kinds"]:
                r0 = time.perf_counter()
                if st["incremental"]:
                    with self.tr.span("reconfig.relayout",
                                      live=self.n_active, staged=True):
                        mapping = self.pool.finish_migration(
                            self._live_extents())
                    if mapping is not None:
                        self._adopt_slots(mapping)
                        # the staged tensors are the pool's now: the old
                        # steps go, the ones captured on the buffer come
                        self._drop_pool_steps()
                        assert all(k[4:] == self.pool.exec_key()
                                   for k in st["graphs"])
                        for key, entry in st["graphs"].items():
                            self._steps.put(key, entry)
                        self.metrics.counter("pool.relayouts").inc()
                        committed = True
                    else:
                        self.pool.abort_migration()
                if not committed:          # fallback: stop-the-world
                    self._relayout_pool()
                relayout_s = time.perf_counter() - r0
            else:
                self.pool.update_policy(self.setting)
            for cols in self._ctx_buckets():   # captured (staged) or now
                self._decode_exec(cols)
            synchronize(self.device)
            cost = time.perf_counter() - t0
            # the staged captures and copies ran between ticks on this
            # thread: they stalled serving as the commit did, so the switch
            # is charged all three (``stall_s``), the I-b share with the
            # copies and the captures of the target geometry's steps, and
            # its scale with every block copied
            bg_s = st["bg_migrate_s"] + st["bg_precompile_s"]
            self.last_reconfig_breakdown = (
                {"I-b": relayout_s + bg_s} if "I-b" in st["kinds"] else {})
            blocks = (self.pool.last_migration_bg_blocks
                      + self.pool.last_migration_delta_blocks
                      if committed else self.pool.last_relayout_blocks)
            self.last_reconfig_scales = (
                {"I-b": max(int(blocks), 1)}
                if "I-b" in st["kinds"] else {})
            self._reconfig_events.append({
                "plan": plan, "cost_s": cost, "stall_s": cost + bg_s,
                "measured": dict(self.last_reconfig_breakdown),
                "scales": dict(self.last_reconfig_scales),
                "staged": committed,
                "bg_migrate_s": st["bg_migrate_s"],
                "bg_precompile_s": st["bg_precompile_s"],
                "bg_capture_failures": st["bg_capture_failures"],
                # blocks copied between ticks and in the commit (0 for a
                # switch that did not stage)
                "bg_blocks": (self.pool.last_migration_bg_blocks
                              if committed else 0),
                "delta_blocks": (self.pool.last_migration_delta_blocks
                                 if committed else 0),
                "staged_wall_s": time.perf_counter() - st["t0"],
            })
        self._staged = None

    def take_reconfig_events(self) -> list[dict]:
        """Drain committed-reconfiguration events (driver → tuner)."""
        ev, self._reconfig_events = self._reconfig_events, []
        return ev

    def cancel_staged(self):
        """Drop an in-flight staged reconfiguration (run teardown, or a
        newer proposal superseding it) with its buffer and its steps.
        Returns the abandoned plan so the driver can tell the tuner to
        reopen its window, or None."""
        st = self._staged
        if st is None:
            return None
        if st["incremental"] and self.pool._mig is not None:
            self.pool.abort_migration()
        self._staged = None
        return st["plan"]

    def _adopt_slots(self, mapping: dict):
        """Move the engine's per-slot state along a relayout's
        {old_slot: new_slot} mapping."""
        old_req, old_pos, old_tok = self.slot_req, self.slot_pos, self.slot_tok
        self._reset_slots()
        for old, new in mapping.items():
            self.slot_req[new] = old_req[old]
            self.slot_pos[new] = old_pos[old]
            self.slot_tok[new] = old_tok[old]

    def _relayout_pool(self):
        """Stop-the-world Type I-b relayout to ``self.setting``; waits for
        the device, so the span (and the caller's clock) covers the
        copies."""
        with self.tr.span("reconfig.relayout",
                          live=self.n_active,
                          block_size=self.setting.get("block_size"),
                          max_batch=self.setting.get("max_batch")):
            live_extents = self._live_extents()
            # a shrink below the live set must not land the pool on a
            # transient geometry (n_slots = live count) outside the knob
            # space: keep the current slot count instead; the drain check
            # in the tick finishes the shrink on the target geometry once
            # the backlog clears
            min_slots = (self.pool.n_slots
                         if len(live_extents) > self.setting["max_batch"]
                         else 0)
            mapping = self.pool.relayout(self.setting, live_extents,
                                         min_slots=min_slots)
            self._drop_pool_steps()
            self._adopt_slots(mapping)
            synchronize(self.device)
            self.metrics.counter("pool.relayouts").inc()


def serve_loop(engine: ServingEngine, trace, tuner=None, *,
               max_wall_s: float | None = None, idle_sleep_s: float = 0.001,
               verbose: bool = False) -> dict:
    """Replay an arrival trace through the engine, optionally self-tuning.

    Per busy quantum the driver records (context value = offered load,
    tick time) into the tuner and stages any ReconfigPlan it emits
    (``begin_reconfig``); each commit is reported back with its observed
    cost.
    """
    pending = deque(sorted(trace, key=lambda r: r.arrival_s))
    n_req = len(pending)
    tok0 = engine.total_tokens          # deltas: engines may be re-used
    fin0 = len(engine.finished)
    pf0 = engine.prefill_tokens_computed
    pt0 = engine.prefill_tokens_total
    dt0 = engine.decode_time_s
    dk0 = engine.decode_tokens
    sh0 = engine.pool.shared_blocks_hit
    cow0 = engine.pool.cow_copies
    sd0 = engine.spec_drafted
    sa0 = engine.spec_accepted
    st0 = engine.spec_ticks
    t_start = time.perf_counter()
    reconfigs = []
    reconfig_total_s = 0.0
    timeline = []                 # (t, total_tokens, load) every ~50 quanta
    busy_ticks = 0

    def _drain_reconfig_events():
        """Report staged commits to the tuner (confirming its pending
        plan) and log them; the cost it learns is the switch's whole stall
        of serving: the commit and the captures and copies that ran
        between ticks before it."""
        nonlocal reconfig_total_s
        for ev in engine.take_reconfig_events():
            tuner.record_reconfig(
                ev["plan"], ev["stall_s"], measured=ev["measured"],
                scales=ev["scales"])
            reconfig_total_s += ev["stall_s"]
            reconfigs.append({
                "t": round(time.perf_counter() - t_start, 3),
                "kinds": list(ev["plan"].kinds),
                "staged": ev["staged"],
                "cost_s": round(ev["cost_s"], 4),
                "stall_s": round(ev["stall_s"], 4),
                "bg_migrate_s": round(ev["bg_migrate_s"], 4),
                "bg_precompile_s": round(ev["bg_precompile_s"], 4),
                "bg_capture_failures": ev["bg_capture_failures"],
                "bg_blocks": ev["bg_blocks"],
                "delta_blocks": ev["delta_blocks"],
                "staged_wall_s": round(ev["staged_wall_s"], 4),
                "setting": dict(ev["plan"].new)})
            if verbose:
                print(f"[reconfig@{reconfigs[-1]['t']:.1f}s] "
                      f"{ev['plan'].kinds} -> {ev['plan'].new} "
                      f"(stall {ev['stall_s']:.3f}s, "
                      f"commit {ev['cost_s']:.3f}s)",
                      flush=True)

    while pending or engine.has_work():
        now = time.perf_counter() - t_start
        if max_wall_s is not None and now > max_wall_s:
            break
        while pending and pending[0].arrival_s <= now:
            engine.submit(pending.popleft(), now=now)
        tick = engine.step(now=now)
        if tuner is not None:
            # commits can land on any tick (idle ones included) — report
            # them before deciding whether to skip the tuner bookkeeping
            _drain_reconfig_events()
        if tick["idle"]:
            if pending:
                time.sleep(min(idle_sleep_s,
                               max(pending[0].arrival_s - now, 0.0)))
            continue
        busy_ticks += 1
        if busy_ticks % 50 == 1:
            timeline.append((round(now, 3), engine.total_tokens - tok0,
                             tick["load"]))
        if tuner is not None:
            # the incumbent is observed without the staged switch's work,
            # which the switch's stall_s already carries
            tuner.record_iteration(float(tick["load"]),
                                   tick["dt"] - tick["reconfig_s"])
            plan = tuner.maybe_advance()
            if plan is not None:
                # stage, don't stall: the engine keeps serving while the
                # target's steps are captured and its pool migrates between
                # ticks; the tuner holds the plan pending until the commit
                engine.begin_reconfig(plan)
    synchronize(engine.device)
    wall = time.perf_counter() - t_start
    # a plan still staged at run end never committed: tear it down and let
    # the tuner reopen the window it froze for the proposal
    leftover = engine.cancel_staged()
    if tuner is not None:
        _drain_reconfig_events()
        if leftover is not None:
            tuner.abandon_reconfig(leftover)
    done = engine.finished[fin0:]
    tokens = engine.total_tokens - tok0
    lats = [r.latency_s for r in done]
    ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
    drafted = engine.spec_drafted - sd0
    stats = {
        "requests": n_req,
        "completed": len(done),
        "wall_s": wall,
        "tokens": tokens,
        "tokens_per_s": tokens / max(wall, 1e-9),
        "p50_latency_s": float(np.percentile(lats, 50)) if lats else None,
        "p99_latency_s": float(np.percentile(lats, 99)) if lats else None,
        "p50_ttft_s": float(np.percentile(ttfts, 50)) if ttfts else None,
        "reconfigs": reconfigs,
        "reconfig_count": len(reconfigs),
        "reconfig_total_s": reconfig_total_s,
        "final_setting": dict(engine.setting),
        "timeline": timeline,
        "prefill_tokens_computed": engine.prefill_tokens_computed - pf0,
        "prefill_tokens_total": engine.prefill_tokens_total - pt0,
        "shared_blocks_hit": engine.pool.shared_blocks_hit - sh0,
        "cow_copies": engine.pool.cow_copies - cow0,
        # decode-only throughput: time inside the decode steps vs the
        # tokens they produced
        "decode_s": engine.decode_time_s - dt0,
        "decode_tok_per_s": ((engine.decode_tokens - dk0)
                             / max(engine.decode_time_s - dt0, 1e-9)),
        "pool": engine.pool.snapshot(),
        "exec_cache": engine._steps.stats(),
        "speculation": {
            "drafted": drafted,
            "accepted": engine.spec_accepted - sa0,
            "spec_ticks": engine.spec_ticks - st0,
            "accept_rate": ((engine.spec_accepted - sa0) / drafted
                            if drafted else 0.0),
            "spec_k": engine._spec_k(),
            "drafter": engine.setting.get("drafter", "ngram"),
        },
    }
    if tuner is not None:
        stats["tuner_init_quanta"] = tuner.init_quanta
        stats["tuner_init_time_s"] = round(tuner.init_time_s, 4)
        stats["tuner_horizon_s"] = tuner.effective_horizon()
        if tuner.warm_start_info is not None:
            stats["warm_start"] = dict(tuner.warm_start_info)
    return stats
