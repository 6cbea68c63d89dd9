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
  * ``quant="int8"`` re-quantizes freshly written KV rows through the
    int8 quantize/dequantize kernels.  ``quant`` and ``prefix_share``
    apply to paged pools only and are ignored for ssm pools, as in the
    JAX engine.

Steps run eagerly; the LRU keeps one callable per shape key, under the
JAX package's keys.  Speculative decoding, the self-tuning loop and online
reconfiguration (relayout, staged migration) are later slices of the port
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.lru import LRUCache
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import build_all
from repro_torch.kernels.quant import dequantize, quantize
from repro_torch.models import lm
from repro_torch.models.lm import ModelKnobs
from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.obs.trace import NOP_TRACER
from repro_torch.serving.knobs import DEFAULT_SERVING_SETTING
from repro_torch.serving.pool import make_state_pool, pool_dtype

LATER = {
    "spec_k": "speculative decoding",
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
        if self._spec_k() > 0:
            raise _not_ported("spec_k")
        self.tr = tracer or NOP_TRACER
        self.metrics = metrics or NULL_METRICS
        self._steps = LRUCache(step_cache_size)
        self._steps.tracer = self.tr
        self.queue: deque[Request] = deque()
        self.pool = make_state_pool(cfg, self.setting, max_seq, self.device)
        self._reset_slots()
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
        """Decode step of ``s`` query tokens per slot over the pool."""
        key = ("decode", self.attn_impl, ctx_cols, s) + self.pool.exec_key()

        def build():
            cfg = self.cfg
            kn = ModelKnobs(attn_impl=self.attn_impl, attn_ctx=ctx_cols)

            def f(params, cache, tok, pos):
                return lm.decode_step(params, cache, tok, pos, cfg, kn)
            return f

        return self._steps.get_or_create(key, build)

    def _prefill_exec(self, bucket: int):
        key = ("prefill", bucket, self.setting["k_chunk"])

        def build():
            cfg = self.cfg
            kn = ModelKnobs(k_chunk=self.setting["k_chunk"])

            def f(params, tokens, last_idx: int):
                # valid_len: the ssm family must not fold right-pad tokens
                # into the recurrent state (attention ignores it)
                hidden, cache = lm.forward(params, tokens, cfg, kn,
                                           mode="prefill",
                                           valid_len=last_idx + 1)
                last = hidden[:, last_idx:last_idx + 1]
                return lm.logits_fn(params, last, cfg)[:, 0], cache
            return f

        return self._steps.get_or_create(key, build)

    def _chunk_prefill_exec(self, bucket: int):
        """Suffix prefill against shared prefix blocks: one multi-token
        paged decode step; queries attend the prior blocks through the
        block table and write their own KV into the slot's blocks.  COW
        for shared blocks in the write range runs before the step."""
        key = ("chunkpf", bucket, self.attn_impl) + self.pool.exec_key()

        def build():
            cfg = self.cfg
            kn = ModelKnobs(attn_impl=self.attn_impl)

            def f(params, cache, tokens, start, last_idx: int):
                hidden, new_cache = lm.forward(params, tokens, cfg, kn,
                                               mode="decode", cache=cache,
                                               pos=start)
                last = hidden[:, last_idx:last_idx + 1]
                return lm.logits_fn(params, last, cfg)[:, 0], new_cache
            return f

        return self._steps.get_or_create(key, build)

    def _quant_exec(self, n: int):
        """int8 KV storage: per-(layer, position) blockwise quantization
        (block = K * hd) with deterministic rounding (u = 0.5), through the
        quantize/dequantize kernels.  The rows are read in their own dtype,
        u is one value expanded (the kernel reads it once), and the rows
        come back in the pool's dtype.  One callable per row count."""
        key = ("quant", n)

        def build():
            block = max(self.cfg.n_kv_heads * self.cfg.hd, 1)
            half = torch.full((1,), 0.5, device=self.device)
            out_dtype = pool_dtype(self.setting)

            def f(kv):                       # (L, n, K, hd)
                flat = kv.reshape(-1)
                q, scales = quantize(flat, half.expand(flat.shape[0]),
                                     block=block)
                return dequantize(q, scales, block=block,
                                  out_dtype=out_dtype).reshape(kv.shape)
            return f

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
        if shared > 0:
            # shared-prefix path: prefill only the suffix as one multi-token
            # paged decode step.  COW runs first; bucket-pad positions
            # write into the slot's reserved/trash blocks and are rewritten
            # by decode before any query can see them.
            sfx = req.prompt[shared:]
            n = len(sfx)
            bucket = self._bucket(n)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = sfx
            self.pool.prepare_write(slot, shared, P)
            cache = {"k": self.pool.kv["k"], "v": self.pool.kv["v"],
                     "block_tables": self._tensor(
                         self.pool.tables[slot:slot + 1])}
            with self.tr.span("serve.chunk_prefill", bucket=bucket,
                              suffix=n, shared=shared):
                logits, newc = self._chunk_prefill_exec(bucket)(
                    self.params, cache, self._tensor(padded, torch.long),
                    self._tensor([shared]), n - 1)
                self.pool.set_cache(newc)
                tok = int(torch.argmax(logits[0]))
            if self.setting["quant"] == "int8":
                # re-quantize the freshly written suffix rows at bucket
                # granularity; rows past the cache boundary are zero-padded
                # back to the bucket and discarded by the bounded write
                with self.tr.span("serve.quant", bucket=bucket):
                    m = min(bucket, self.max_seq - shared)
                    pos = np.arange(shared, shared + m)
                    blk = self._tensor(self.pool.tables[slot,
                                                        pos // self.pool.bs],
                                       torch.long)
                    off = self._tensor(pos % self.pool.bs, torch.long)
                    kv = {k: self.pool.kv[k][:, blk, off] for k in ("k", "v")}
                    if m < bucket:
                        kv = {k: torch.nn.functional.pad(
                                  v, (0, 0, 0, 0, 0, bucket - m))
                              for k, v in kv.items()}
                    kv = {k: self._quant_exec(bucket)(v)
                          for k, v in kv.items()}
                    self.pool.write_kv(slot,
                                       {k: v[:, :n] for k, v in kv.items()},
                                       start=shared)
            self.prefill_tokens_computed += n
        else:
            bucket = self._bucket(P)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :P] = req.prompt
            with self.tr.span("serve.prefill", bucket=bucket, plen=P):
                logits, pcache = self._prefill_exec(bucket)(
                    self.params, self._tensor(padded, torch.long), P - 1)
                if self.pool.kind == "paged":
                    kv = {k: pcache[k][:, 0] for k in ("k", "v")}
                    if self.setting["quant"] == "int8":
                        with self.tr.span("serve.quant", bucket=bucket):
                            kv = {k: self._quant_exec(bucket)(v)
                                  for k, v in kv.items()}
                    self.pool.write_kv(slot, {k: v[:, :P]
                                              for k, v in kv.items()},
                                       start=0)
                else:
                    self.pool.write_prefill(slot, pcache)
                tok = int(torch.argmax(logits[0]))
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
        if self.n_active > 0:
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            self.pool.prepare_step_writes(active, self.slot_pos)
            tok = self._tensor(self.slot_tok[:, None], torch.long)
            pos = self._tensor(self.slot_pos)
            cols = self._ctx_cols(int(self.slot_pos[active].max()))
            with self.tr.span("serve.decode", batch=len(active), cols=cols):
                t_dec = time.perf_counter()
                logits, new_cache = self._decode_exec(cols)(
                    self.params, self.pool.decode_cache(), tok, pos)
                synchronize(self.device)
                self.decode_time_s += time.perf_counter() - t_dec
                self.decode_tokens += len(active)
            self.pool.set_cache(new_cache)
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    continue
                self.slot_pos[slot] += 1
                self.slot_tok[slot] = nxt[slot]
                req.tokens_out.append(int(nxt[slot]))
                tokens += 1
                self.total_tokens += 1
                if (len(req.tokens_out) >= req.max_new
                        or self.slot_pos[slot] >= self.max_seq - 1):
                    self._complete(slot)

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

    def _max_batch_cap(self) -> int:
        return max(int(self.setting["max_batch"]), 1)

    # ------------------------------------------------------------ startup
    def warm_start(self, space=None, max_prompt: int | None = None):
        """Server startup: build the CUDA kernels (one nvcc per source, in
        parallel; a no-op when they are built or on the CPU) and the step
        callables of the current setting — decode per context bucket,
        prefill per length bucket, and for a paged pool shared-prefix
        suffix prefill per length bucket (an ssm pool shares nothing);
        int8 quantization per bucket.  Warming a whole knob ``space`` is
        the self-tuning loop's and comes with that slice."""
        assert self.n_active == 0, "warm_start before serving, not during"
        if space is not None:
            raise _not_ported("tuner")
        if self.device.type == "cuda":
            build_all()
        hi = min(max_prompt or self.max_seq, self.max_seq)
        buckets = sorted({self._bucket(p) for p in range(1, hi + 1)})
        self._steps.capacity = max(self._steps.capacity,
                                   6 + 3 * len(buckets) + 2)
        for cols in self._ctx_buckets():
            self._decode_exec(cols)
        for b in buckets:
            self._prefill_exec(b)
            if self.setting.get("prefix_share") and self.pool.kind == "paged":
                self._chunk_prefill_exec(b)
            if self.setting["quant"] == "int8":
                self._quant_exec(b)

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
    }
