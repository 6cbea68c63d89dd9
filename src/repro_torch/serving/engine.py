"""Continuous-batching inference engine (fixed setting; dense and ssm
families).

The port of the JAX package's ``serving/engine.py`` main path:

  * a FIFO request queue with block-aware admission: at most
    ``max_batch`` requests in flight; while decodes run, the continuous
    ``admit_budget`` knob meters prefills per scheduling quantum, and a
    short bounded lookahead lets small requests pass a long prompt;
  * the state pool from ``make_state_pool`` (repro_torch.serving.pool):
    ``PagedKVPool`` (dense: paged KV blocks, block tables, copy-on-write
    prompt-prefix sharing) or ``SSMStatePool`` (ssm: one recurrent state
    per slot);
  * prefill per request at batch 1, padded to a multiple of
    ``prefill_chunk`` (flash-attention kernel; for ssm the selective-scan
    kernel, with the state stopped at the last prompt token); a prompt
    whose prefix is cached in a paged pool computes only its suffix, as
    one multi-token paged decode step against the shared blocks
    (paged-attention kernel);
  * decode advances every live slot one token per quantum: paged decode
    reads KV blocks in place through the block table (paged-attention
    kernel), per context bucket so short batches read only their live
    blocks; ssm decode continues each slot's stored state (selective-scan
    kernel);
  * speculative decoding (``spec_k`` > 0): a drafter proposes k tokens a
    slot, one S = k+1 decode step verifies them, and the rejected tail is
    rolled back — the pool's deferred copy-on-write records (paged), or a
    snapshot of the state and a replay of the accepted tokens (ssm);
  * ``quant="int8"`` re-quantizes freshly written KV rows through the
    int8 quantize/dequantize kernels.  ``quant`` and ``prefix_share``
    apply to paged pools only and are ignored for ssm pools, as in the
    JAX engine.

Every step is built once per shape key, under the JAX package's keys, by
``aot_compile``: on the card a CUDA graph (one dispatch a step, as the JAX
package's AOT-compiled executables are), on the CPU the eager callable.
The graphs read the parameters and the pool's tensors by address and take
their per-step inputs (tokens, positions, a block-table row) through
pinned host buffers.  The self-tuning loop and online reconfiguration
(relayout, staged migration) are later slices of the port and raise
``NotImplementedError``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.lru import LRUCache, aot_compile
from repro_torch.device import Staging, resolve_device, synchronize
from repro_torch.kernels import build_all
from repro_torch.kernels.quant import dequantize, quantize
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs
from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.obs.trace import NOP_TRACER
from repro_torch.serving.drafter import make_drafter
from repro_torch.serving.knobs import DEFAULT_SERVING_SETTING
from repro_torch.serving.pool import make_state_pool, pool_dtype

# step keys whose graphs capture the state pool's tensors by address: they
# go when the pool is replaced
POOL_STEPS = ("decode", "chunkpf", "replay")

LATER = {
    "tuner": "the tuning stack (--selftune)",
    "relayout": "online reconfiguration and relayout",
}


def _not_ported(what: str):
    return NotImplementedError(
        f"{LATER[what]} is not ported yet: it comes with a later slice of "
        f"the port")


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
        lm.check_family(cfg)
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

    def _set_pool(self, pool):
        """Adopt a new state pool.  The graphs captured on the old one read
        and write its tensors by address — replayed now, they would write
        freed memory — so they are dropped with it."""
        self._steps.drop(lambda key: key[0] in POOL_STEPS)
        self.pool = pool
        self._reset_slots()

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
        if self.pool.kind != "paged" or self.attn_impl == "gather":
            return (0,)
        mb = self.pool.mb
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
                                            self.pool.decode_cache()))

    def _replay_exec(self, s: int):
        """The ssm rollback's step: ``s`` tokens a slot decoded from the
        pool's speculative snapshot (``pool.saved``), written in place."""
        key = ("replay", s) + self.pool.exec_key()
        return self._steps.get_or_create(
            key, lambda: self._decode_build(0, s, self.pool.saved))

    def _decode_build(self, ctx_cols: int, s: int, cache: dict):
        cfg = self.cfg
        kn = ModelKnobs(attn_impl=self.attn_impl, attn_ctx=ctx_cols)

        def f(params, cache, tok, pos):
            return lm.decode_step(params, cache, tok, pos, cfg, kn)

        n = self.pool.n_slots
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
        row count."""
        key = ("quant", n)

        def build():
            cfg = self.cfg
            block = max(cfg.n_kv_heads * cfg.hd, 1)
            half = torch.full((1,), 0.5, device=self.device)
            out_dtype = pool_dtype(self.setting)

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
                    self.pool.write_prefill(slot, pcache)
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
        their rows into the pool.  Each width is one step, 1..k."""
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
            for name, t in self.pool.state.items():
                t[:, idx] = self.pool.saved[name][:, idx]
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

        dt = time.perf_counter() - t0
        if self.metrics.enabled:
            self.metrics.histogram("serve.tick_s").observe(dt)
            self.metrics.gauge("serve.active_slots").set(self.n_active)
            self.metrics.gauge("serve.queue_depth").set(self.queue_depth)
            snap = self.pool.snapshot()
            if "block_utilization" in snap:       # paged pools only
                self.metrics.gauge("pool.block_utilization").set(
                    snap["block_utilization"])
        return {"dt": dt, "tokens": tokens, "active": self.n_active,
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

    def _max_batch_cap(self) -> int:
        return max(int(self.setting["max_batch"]), 1)

    # ------------------------------------------------------------ startup
    def warm_start(self, space=None, max_prompt: int | None = None):
        """Server startup: build the CUDA kernels (one nvcc per source, in
        parallel; a no-op when they are built or on the CPU) and the steps
        of the current setting — decode per context bucket (and the S =
        spec_k + 1 verify step per bucket when speculating), prefill per
        length bucket, and for a paged pool shared-prefix suffix prefill
        per length bucket (an ssm pool shares nothing); int8 quantization
        per bucket.  On the card each is captured as a graph; the time the
        captures took and the memory they hold (the graph pool, the static
        buffers) go to ``capture_stats`` and are printed.  Warming a whole
        knob ``space`` is the self-tuning loop's and comes with that
        slice."""
        assert self.n_active == 0, "warm_start before serving, not during"
        if space is not None:
            raise _not_ported("tuner")
        cuda = self.device.type == "cuda"
        if cuda:
            build_all()
            synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
        hi = min(max_prompt or self.max_seq, self.max_seq)
        buckets = sorted({self._bucket(p) for p in range(1, hi + 1)})
        spec_s = self._spec_k() + 1
        self._steps.capacity = max(
            self._steps.capacity,
            6 * (2 if spec_s > 1 else 1) + 3 * len(buckets) + spec_s + 2)
        t0 = time.perf_counter()
        built = len(self._steps)
        for cols in self._ctx_buckets():
            self._decode_exec(cols)
            if spec_s > 1:
                self._decode_exec(cols, spec_s)
        for b in buckets:
            self._prefill_exec(b)
            if self.setting.get("prefix_share") and self.pool.kind == "paged":
                self._chunk_prefill_exec(b)
            if self.setting["quant"] == "int8":
                self._quant_exec(b)
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

    def reconfigure(self, new_setting: dict):
        raise _not_ported("relayout")


def serve_loop(engine: ServingEngine, trace, tuner=None, *,
               max_wall_s: float | None = None,
               idle_sleep_s: float = 0.001) -> dict:
    """Replay an arrival trace through the engine at a fixed setting.
    ``tuner`` (the self-tuning loop) comes with a later slice."""
    if tuner is not None:
        raise _not_ported("tuner")
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
    timeline = []                 # (t, total_tokens, load) every ~50 quanta
    busy_ticks = 0
    while pending or engine.has_work():
        now = time.perf_counter() - t_start
        if max_wall_s is not None and now > max_wall_s:
            break
        while pending and pending[0].arrival_s <= now:
            engine.submit(pending.popleft(), now=now)
        tick = engine.step(now=now)
        if tick["idle"]:
            if pending:
                time.sleep(min(idle_sleep_s,
                               max(pending[0].arrival_s - now, 0.0)))
            continue
        busy_ticks += 1
        if busy_ticks % 50 == 1:
            timeline.append((round(now, 3), engine.total_tokens - tok0,
                             tick["load"]))
    synchronize(engine.device)
    wall = time.perf_counter() - t_start
    done = engine.finished[fin0:]
    tokens = engine.total_tokens - tok0
    lats = [r.latency_s for r in done]
    ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
    drafted = engine.spec_drafted - sd0
    return {
        "requests": n_req,
        "completed": len(done),
        "wall_s": wall,
        "tokens": tokens,
        "tokens_per_s": tokens / max(wall, 1e-9),
        "p50_latency_s": float(np.percentile(lats, 50)) if lats else None,
        "p99_latency_s": float(np.percentile(lats, 99)) if lats else None,
        "p50_ttft_s": float(np.percentile(ttfts, 50)) if ttfts else None,
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
