#!/usr/bin/env python3
"""Time the port's int8 quantize and dequantize kernels against an earlier
version of their CUDA source, in one process on one card, in turns (old,
new, new, old).

    python3 scripts/ab_quant_kernels.py --baseline DIR

DIR holds the earlier ``quant.cu`` and ``common.cuh`` (for example unpacked
with ``git archive <commit> src/repro_torch/kernels/csrc``).  Its C
interface is the one before the Hopper redesign: ``quantize(x, u, q,
scales, n, block, stream)`` with f32 x and an f32 (n,) u, and
``dequantize(q, scales, x, n, block, stream)`` into f32.  Shapes: the
engine's KV rows of a 320-token admission of starcoder2-3b (n = 30 x 320 x
256 = 2,457,600, block 256), and the same n at blocks 1024 and 2048 (a
warp and a CTA per block in the new kernel).  Both kernels get the same
f32 inputs; the new ones are also timed on the engine's (bf16 x, u of one
value, bf16 out).  Then ``ServingEngine._quant_exec(320)``'s round trip
on one (30, 320, 2, 128) bf16 tensor: the earlier composition (widen to
f32, a full tensor of 0.5, the old kernels, the cast back to bf16) against
the current one, with the device operations each runs.  Device time with
the L2 flushed before each launch (by a write, as ``chip_smoke.py`` does,
and at block 256 also by a read: clean_l2 below).  Needs a CUDA device and
nvcc.

    python3 scripts/ab_quant_kernels.py --phases

instead times the current vector kernels cut short after each phase (a
copy of the source, edited at fixed anchors, built beside the real one),
in turns, beside a one-element kernel for the launch floor: quantize after
its loads (and each thread's max), after the team's max and the scale,
and whole; dequantize after its loads, and whole; at the table's shape
and the engine's.

    python3 scripts/ab_quant_kernels.py --variants

times edited copies of the current kernels beside it, in turns, at the
same shapes: quantize without the next block's loads started early
(no_prefetch), held to 8 CTAs an SM by its launch bounds (occupancy8),
with the grid cut so that every team takes as many blocks (balanced) or
sized to the data, a team a block (data_grid); dequantize with streaming
stores (stcs) or as first written, each thread storing its own 16 values
with 16-byte gaps between lanes (thread_stores).  Every mode also times the current kernels with the L2
flushed by a read instead of a write (clean_l2): the write flush leaves
the L2 full of dirty lines that the kernel's own traffic must first write
back.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

N = 30 * 320 * 256                  # starcoder2-3b: layers x bucket x K*hd

# Phase cuts: (anchor in the source, text put in its place).  Each cut
# consumes what was loaded (u too) in a store that never happens, so the
# compiler keeps the loads.
_U_READ = ("      if constexpr (!U_ONE) {\n"
           "        for (int j = 0; j < VPL; ++j)\n"
           "          for (int k = 0; k < V / 4; ++k)\n"
           "            r_ += uc[j][k].x + uc[j][k].y + uc[j][k].z + uc[j][k].w;\n"
           "      }\n")


def _quant_cut(value):
    return ("    {\n      float r_ = " + value + ";\n" + _U_READ
            + "      if (r_ == 1234.5f) scales[0] = r_;\n      continue;\n    }\n")


# Variants: {tag: (kernels it edits, [(anchor, text put in its place)])}.
_LOAD_NOW = ("    Vec xc[VPL];\n    float4 uc[VPL][V / 4];\n"
             "    load_share<XT, U_ONE, TEAM, VPL>(x, u, blk, block, t, xc, uc);\n")
# The dequantizer as first written: each thread stores its own 16 values
# (4 float4 or 2 uint4 stores, 16-byte gaps between lanes), no shuffles.
_DQ_SPAN = ("template <typename OT>\n__global__ void __launch_bounds__(kCtaThreads)"
            "\ndequantize_kernel(",
            "template <typename OT>\n__global__ void __launch_bounds__(kCtaThreads)"
            "\ndequantize_scalar_kernel(")
_DQ_THREAD_STORES = """template <typename OT>
__global__ void __launch_bounds__(kCtaThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  OT* __restrict__ x, int n_chunks, int chunks_per_block) {
  for (int c = blockIdx.x * kCtaThreads + threadIdx.x; c < n_chunks;
       c += gridDim.x * kCtaThreads) {
    const uint4 raw = reinterpret_cast<const uint4*>(q)[c];
    const float s = scales[c / chunks_per_block];
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float f[kDqVals];
#pragma unroll
    for (int k = 0; k < kDqVals; ++k)
      f[k] = __fmul_rn(static_cast<float>(static_cast<int>(w[k / 4] << (24 - 8 * (k % 4))) >> 24), s);
    if constexpr (sizeof(OT) == 4) {
      float4* o = reinterpret_cast<float4*>(x) + (size_t)c * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
    } else {
      uint4* o = reinterpret_cast<uint4*>(x) + (size_t)c * 2;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        o[k] = make_uint4(pack_bf16(f[8 * k], f[8 * k + 1]), pack_bf16(f[8 * k + 2], f[8 * k + 3]),
                          pack_bf16(f[8 * k + 4], f[8 * k + 5]), pack_bf16(f[8 * k + 6], f[8 * k + 7]));
    }
  }
}

"""
VARIANTS = {
    "no_prefetch": (("quantize",), [
        ("  if (blk < n_blocks) load_share<XT, U_ONE, TEAM, VPL>(x, u, blk, "
         "block, t, xn, un);\n", ""),
        ("""    Vec xc[VPL];
    float4 uc[VPL][V / 4];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      xc[j] = xn[j];
      if constexpr (!U_ONE) {
#pragma unroll
        for (int k = 0; k < V / 4; ++k) uc[j][k] = un[j][k];
      }
    }
    if (blk + n_teams < n_blocks)
      load_share<XT, U_ONE, TEAM, VPL>(x, u, blk + n_teams, block, t, xn, un);
""", _LOAD_NOW)]),
    "occupancy8": (("quantize",), [
        ("__global__ void __launch_bounds__(kCtaThreads)\nquantize_kernel(",
         "__global__ void __launch_bounds__(kCtaThreads, 8)\nquantize_kernel(")]),
    "balanced": (("quantize",), [
        ("  const int grid = card_grid(kernel, n_sms, (n_blocks + kTeams - 1) "
         "/ kTeams);\n",
         "  int grid = card_grid(kernel, n_sms, (n_blocks + kTeams - 1) / kTeams);\n"
         "  const int per_team = (n_blocks + grid * kTeams - 1) / (grid * kTeams);\n"
         "  grid = ((n_blocks + per_team - 1) / per_team + kTeams - 1) / kTeams;\n")]),
    "data_grid": (("quantize",), [
        ("  const int grid = card_grid(kernel, n_sms, (n_blocks + kTeams - 1) "
         "/ kTeams);\n",
         "  const int grid = (n_blocks + kTeams - 1) / kTeams;\n")]),
    "stcs": (("dequantize",), [
        ("        *reinterpret_cast<float4*>(o) = make_float4(",
         "        __stcs(reinterpret_cast<float4*>(o), make_float4("),
        ("f[1], f[2], f[3]);\n", "f[1], f[2], f[3]));\n"),
        ("        *reinterpret_cast<uint4*>(o) = make_uint4(",
         "        __stcs(reinterpret_cast<uint4*>(o), make_uint4("),
        ("pack_bf16(f[6], f[7]));", "pack_bf16(f[6], f[7])));")]),
    "thread_stores": (("dequantize",), [(_DQ_SPAN, _DQ_THREAD_STORES)]),
}

PHASE_CUTS = {
    "loads": (("quantize", "dequantize"), [
        ("    // -- quantize: loaded\n", _quant_cut("amax")),
        ("    // -- dequantize: loaded\n",
         "    if (s + (float)(raw.x ^ raw.y ^ raw.z ^ raw.w) == 1234.5f)"
         " x[0] = port::from_f32<OT>(s);\n    continue;\n")]),
    "max": (("quantize",), [("    // -- quantize: reduced\n",
                             _quant_cut("scale"))]),
}


def build_cut(tag: str, cuts) -> ctypes.CDLL:
    """The current quant kernels with ``cuts`` applied, built beside the
    real library."""
    import subprocess

    from repro_torch.kernels import _build
    d = _build.BUILD_DIR / "phases"
    d.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "quant.cu").read_text()
    for anchor, text in cuts:          # an anchor pair: the span between
        if isinstance(anchor, tuple):
            if not all(a in src for a in anchor):
                sys.exit(f"ab_quant_kernels: span {anchor[0][-30:]!r} not found")
            anchor = src[src.index(anchor[0]):src.index(anchor[1])]
        if anchor not in src:
            sys.exit(f"ab_quant_kernels: anchor {anchor.strip()!r} not found")
        src = src.replace(anchor, text, 1)
    (d / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    (d / f"quant-{tag}.cu").write_text(src)
    out = d / f"quant-{tag}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(d / f"quant-{tag}.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def timed_clean_ms(torch, fn, iters: int = 20) -> float:
    """chip_smoke.timed_ms with the L2 flushed by reading 64 MB: the cache
    is left full of clean lines, so the kernel's traffic evicts without
    writing back."""
    flush = torch.ones(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        flush.max()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ops(torch, fn) -> int:
    """Device operations (kernels, copies, fills) one call of fn runs."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "CUDA" in str(e.device_type))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--baseline", type=Path)
    mode.add_argument("--phases", action="store_true")
    mode.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_quant_kernels: needs a CUDA device")
    from chip_smoke import card_line, timed_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.quant import (dequantize, dequantize_ref,
                                           quantize, quantize_ref)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    print(f"card: {card_line()}", flush=True)
    x = torch.randn(N, generator=g, device=dev) * 3
    u = torch.rand(N, generator=g, device=dev)
    xe = x.to(bf16)
    ue = torch.full((1,), 0.5, device=dev).expand(N)

    q, s = quantize(x, u, block=256)
    cases = {
        "quantize table (f32 x, f32 u)": lambda: quantize(x, u, block=256),
        "quantize engine (bf16 x, one-value u)":
            lambda: quantize(xe, ue, block=256),
        "dequantize table (f32 out)": lambda: dequantize(q, s, block=256),
        "dequantize engine (bf16 out)":
            lambda: dequantize(q, s, block=256, out_dtype=bf16)}
    if args.phases or args.variants:
        edits = PHASE_CUTS if args.phases else VARIANTS
        libs = {"whole": build_cut("whole", [])}
        libs.update((tag, build_cut(tag, cuts))
                    for tag, (_, cuts) in edits.items())
        one = torch.zeros(1, device=dev)
        print(f"launch floor (one-element add) "
              f"{timed_ms(torch, lambda: one.add_(1)):.4f} ms", flush=True)
        for rep in range(2):                 # the second pass in reverse
            for label, fn in cases.items():
                res = []
                for tag in list(libs) if rep == 0 else list(libs)[::-1]:
                    if tag != "whole" and label.split()[0] not in edits[tag][0]:
                        continue             # the edit leaves this kernel
                    _build._LIBS["quant"] = libs[tag]
                    fn()
                    torch.cuda.synchronize()
                    res.append(f"{tag} {timed_ms(torch, fn):.4f}")
                    if tag == "whole":
                        res.append(f"whole clean_l2 "
                                   f"{timed_clean_ms(torch, fn):.4f}")
                print(f"{'phases' if args.phases else 'variants'}[{label}] "
                      f"pass {rep}: {', '.join(res)} ms", flush=True)
        _build._LIBS.clear()
        return

    from ab_attention_kernels import build_baseline
    lib = build_baseline(args.baseline, "quant")
    oq, odq = lib.quantize, lib.dequantize
    oq.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    odq.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    oq.restype = odq.restype = ctypes.c_int

    def old_quantize(xf, uf, block):
        q = torch.empty(N, dtype=torch.int8, device=dev)
        s = torch.empty(N // block, device=dev)
        _build.check_launch(oq(xf.data_ptr(), uf.data_ptr(), q.data_ptr(),
                               s.data_ptr(), N, block, _build.stream_of(xf)),
                            "baseline quantize")
        return q, s

    def old_dequantize(q, s, block):
        out = torch.empty(N, device=dev)
        _build.check_launch(odq(q.data_ptr(), s.data_ptr(), out.data_ptr(),
                                N, block, _build.stream_of(q)),
                            "baseline dequantize")
        return out

    def turns(label, old, new, extra="", timer=timed_ms):
        t = [timer(torch, f) for f in (old, new, new, old)]
        print(f"ab[{label}]: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f}"
              f" / {t[2]:.4f} ms, speed-up {(t[0] + t[3]) / (t[1] + t[2]):.2f}x"
              f"{extra}", flush=True)

    for block in (256, 1024, 2048):
        oqs, nqs = old_quantize(x, u, block), quantize(x, u, block=block)
        rq, rs = quantize_ref(x, u, block=block)
        same = all(torch.equal(a, b) for a, b in zip(oqs + nqs, (rq, rs) * 2))
        turns(f"quantize f32 x, f32 u, block {block}",
              lambda: old_quantize(x, u, block),
              lambda: quantize(x, u, block=block),
              f"; old and new bit-exact against the plain version: {same}")
        q, s = nqs
        same = torch.equal(old_dequantize(q, s, block),
                           dequantize(q, s, block=block))
        turns(f"dequantize f32 out, block {block}",
              lambda: old_dequantize(q, s, block),
              lambda: dequantize(q, s, block=block),
              f"; old == new: {same}")
    q, s = quantize(x, u, block=256)
    turns("quantize f32 x, f32 u, block 256, clean_l2",
          lambda: old_quantize(x, u, 256), lambda: quantize(x, u, block=256),
          timer=timed_clean_ms)
    turns("dequantize f32 out, block 256, clean_l2",
          lambda: old_dequantize(q, s, 256), lambda: dequantize(q, s, block=256),
          timer=timed_clean_ms)
    q, s = quantize(xe, ue, block=256)
    print(f"engine shape (block 256): new quantize(bf16 x, one-value u) "
          f"{timed_ms(torch, lambda: quantize(xe, ue, block=256)):.4f} ms, "
          f"new dequantize(bf16 out) "
          f"{timed_ms(torch, lambda: dequantize(q, s, block=256, out_dtype=bf16)):.4f}"
          f" ms; the old kernels take f32 only (above)", flush=True)
    print(f"library: torch.mul(q, scales) "
          f"{timed_ms(torch, lambda: torch.mul(q.view(-1, 256), s.view(-1, 1))):.4f}"
          f" ms (f32 out)", flush=True)

    # the engine's round trip on one (30, 320, 2, 128) bf16 tensor
    kv = (torch.randn((30, 320, 2, 128), generator=g, device=dev) * 2).to(bf16)
    half = torch.full((1,), 0.5, device=dev)

    def old_roundtrip():
        flat = kv.reshape(-1).float()
        qq, ss = old_quantize(flat, torch.full_like(flat, 0.5), 256)
        return old_dequantize(qq, ss, 256).reshape(kv.shape).to(bf16)

    def new_roundtrip():
        flat = kv.reshape(-1)
        qq, ss = quantize(flat, half.expand(N), block=256)
        return dequantize(qq, ss, block=256, out_dtype=bf16).reshape(kv.shape)

    flat = kv.reshape(-1).float()
    want = dequantize_ref(*quantize_ref(flat, torch.full_like(flat, 0.5),
                                        block=256), block=256).to(bf16)
    same = (torch.equal(old_roundtrip().reshape(-1), want)
            and torch.equal(new_roundtrip().reshape(-1), want))
    turns("_quant_exec(320) round trip, bf16 rows", old_roundtrip,
          new_roundtrip, f"; device operations a call: old "
          f"{device_ops(torch, old_roundtrip)}, new "
          f"{device_ops(torch, new_roundtrip)}; both bit-exact against the "
          f"plain path: {same}")


if __name__ == "__main__":
    main()
