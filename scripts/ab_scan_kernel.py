#!/usr/bin/env python3
"""Time the port's selective-scan kernel against an earlier version of its
CUDA source, in one process on one card, in turns (old, new, new, old).

    python3 scripts/ab_scan_kernel.py --baseline DIR

DIR holds the earlier ``mamba_scan.cu`` and ``common.cuh`` (for example
unpacked with ``git archive <commit> src/repro_torch/kernels/csrc``).  Its
C interface is the one before the training checkpoints (h_chk) were added:
``selective_scan(x, dt, Bm, Cm, A, h0, y, h_out, B, S, D, N, ng, chunked,
b_sb, b_st, c_sb, c_st, x_bf16, dt_bf16, bc_bf16, stream)``, the same
launch plans.  Shapes: falcon-mamba-7b's decode tick (B = 8, S = 1, D =
8192, N = 16, h0 updated in place) and prefills of the serve's buckets (B
= 1, S = 16, 96, 256 and 512, no h0), on the inputs the model hands the
scan (x and dt bf16, Bm and Cm bf16 views of the x_proj output); the new
kernel is also timed on f32 dt and contiguous f32 Bm, Cm.  Device time
with the L2 flushed before each launch.  Needs a CUDA device and nvcc.

    python3 scripts/ab_scan_kernel.py --phases

instead times the current kernel cut short after each phase (a copy of the
source, edited at fixed anchors, built beside the real one), in turns,
beside a one-element kernel for the launch floor: the direct kernel
(decode) after its loads, after its compute (no stores), and whole; the
chunked kernel (prefill) with its cp.async ring and conversion alone, with
the compute but not the y rows, and whole.

    python3 scripts/ab_scan_kernel.py --plans

times the current kernel at N = 16 with 2, 4 and 8 states a thread, in
the direct and in the chunked kernel, at the same shapes: the evidence
behind ``launch_plan``.  The kernel builds only the plans ``launch_plan``
picks, so each NG is a copy of the source with its NG constants edited,
built beside the real one, and ``launch_plan`` is replaced for the call.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

D, N, R = 8192, 16, 256             # falcon-mamba-7b: d_inner, ssm_state, dt_rank
SHAPES = [("decode B=8 S=1", 8, 1, True)] + [
    (f"prefill B=1 S={S}", 1, S, False) for S in (16, 96, 256, 512)]

# Phase cuts: (anchor in the source, text put in its place).
_RETURN_IF_UNUSED = ("      if (s == 1234.5f) y[0] = s;\n      return;\n    }\n")
# The chunked kernel's cuts read back, after the barrier, an element another
# thread wrote, so the compiler keeps every shared-memory store before it.
_STAGED_ONLY = (
    "    if (c + 1 < n_chunks) stash(buf ^ 1);\n    __syncthreads();\n"
    "    if (s_dt[buf ^ 1][tid % kChunk][(tid + 1) % kDBlock]"
    " + s_u[buf ^ 1][tid % kChunk][tid % kDBlock]"
    " + s_b[buf ^ 1][tid % kChunk][tid % N]"
    " + s_c[buf ^ 1][tid % kChunk][(tid + 1) % N] == 1234.5f) y[0] = 0.f;\n"
    "    continue;\n")
PHASE_CUTS = {
    "loads": [
        ("    // -- direct: loaded\n",
         "    {\n      float s = dtv + u;\n#pragma unroll\n"
         "      for (int j = 0; j < NG; ++j) s += bv[j] + cv[j] + h[j] + a2[j];\n"
         + _RETURN_IF_UNUSED),
        ("    // -- chunked: staged\n", _STAGED_ONLY),
    ],
    "compute": [
        ("    // -- direct: computed\n",
         "    {\n      float s = p;\n#pragma unroll\n"
         "      for (int j = 0; j < NG; ++j) s += h[j];\n" + _RETURN_IF_UNUSED),
        ("    // -- chunked: computed\n", _STAGED_ONLY.replace(
            "s_dt[buf ^ 1]", "s_y[buf]")),
    ],
}

# Plan sweep: the kernel's NG constants, each made to give `ng` at N = 16.
PLAN_ANCHORS = ("constexpr int kDirectNG = N < 8 ? N : 8;",
                "constexpr int kChunkedNG = N / 8 > 2 ? N / 8 : 2;")


def plan_cuts(ng: int):
    return [(a, a.replace("= N", f"= N == {N} ? {ng} : N", 1))
            for a in PLAN_ANCHORS]


def build_cut(tag: str, cuts) -> ctypes.CDLL:
    """The current scan kernel with ``cuts`` applied, built beside the
    real library."""
    from repro_torch.kernels import _build
    d = _build.BUILD_DIR / "phases"
    d.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "mamba_scan.cu").read_text()
    for anchor, text in cuts:
        if anchor not in src:
            sys.exit(f"ab_scan_kernel: anchor {anchor.strip()!r} not found")
        src = src.replace(anchor, text, 1)
    (d / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    (d / f"mamba_scan-{tag}.cu").write_text(src)
    out = d / f"mamba_scan-{tag}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(d / f"mamba_scan-{tag}.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def inputs(torch, g, B, S, h0):
    """(f32-form inputs, model-form inputs): x bf16 and A = -(1..N) in
    both; dt f32 and contiguous f32 Bm, Cm in the first, dt bf16 and bf16
    views of one (B, S, R + 2N) projection in the second (same values)."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    x = torch.randn((B, S, D), generator=g, device=dev).to(bf16)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, D), generator=g, device=dev)).to(bf16)
    proj = torch.randn((B, S, R + 2 * N), generator=g, device=dev).to(bf16)
    _, Bm, Cm = proj.split([R, N, N], dim=-1)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(
        D, N).contiguous()
    h = (torch.randn((B, D, N), generator=g, device=dev) if h0 else None)
    old = (x, dt.float(), Bm.float().contiguous(), Cm.float().contiguous(),
           A, h)
    return old, (x, dt, Bm, Cm, A, h)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--baseline", type=Path)
    mode.add_argument("--phases", action="store_true")
    mode.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_scan_kernel: needs a CUDA device")
    from ab_attention_kernels import build_baseline
    from chip_smoke import card_line, timed_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan import selective_scan

    g = torch.Generator(device="cuda").manual_seed(0)
    print(f"card: {card_line()}", flush=True)
    cases = {label: (B, S, inputs(torch, g, B, S, h0))
             for label, B, S, h0 in SHAPES}

    def new(a):
        x, dt, Bm, Cm, A, h = a
        return selective_scan(x, dt, Bm, Cm, A, h, h_out=h)[0]

    if args.plans:
        launch_plan = scan_kernel.launch_plan
        libs = {ng: build_cut(f"ng{ng}", plan_cuts(ng)) for ng in (2, 4, 8)}
        for label, (B, S, (_, a)) in cases.items():
            res = []
            for ng, lib in libs.items():
                _build._LIBS["mamba_scan"] = lib
                for ch in (False, True):
                    scan_kernel.launch_plan = lambda S, N, p=(ng, ch): p
                    new(a)
                    torch.cuda.synchronize()
                    res.append(f"ng={ng} {'chunked' if ch else 'direct'} "
                               f"{timed_ms(torch, lambda: new(a)):.4f}")
            print(f"plans[{label}] (launch_plan {launch_plan(S, N)}): "
                  f"{', '.join(res)} ms", flush=True)
        scan_kernel.launch_plan = launch_plan
        _build._LIBS.clear()
        return
    if args.phases:
        libs = {tag: build_cut(tag, cuts) for tag, cuts in PHASE_CUTS.items()}
        libs["whole"] = build_cut("whole", [])
        x = torch.zeros(1, device="cuda")
        print(f"phases: launch floor (one-element add) "
              f"{timed_ms(torch, lambda: x.add_(1)):.4f} ms", flush=True)
        for rep in range(2):                 # the second pass in reverse
            for label, (_, _, (_, a)) in cases.items():
                res = []
                for tag in list(libs) if rep == 0 else list(libs)[::-1]:
                    _build._LIBS["mamba_scan"] = libs[tag]
                    new(a)
                    torch.cuda.synchronize()
                    res.append(f"{tag} {timed_ms(torch, lambda: new(a)):.4f}")
                print(f"phases[{label}] pass {rep}: {', '.join(res)} ms",
                      flush=True)
        _build._LIBS.clear()
        return

    fn = build_baseline(args.baseline, "mamba_scan").selective_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bf16 = torch.bfloat16

    def old(a, B, S):
        x, dt, Bm, Cm, A, h = a
        y = torch.empty((B, S, D), dtype=torch.float32, device="cuda")
        h_out = torch.empty((B, D, N), device="cuda") if h is None else h
        ng, chunked = scan_kernel.launch_plan(S, N)
        _build.check_launch(fn(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), None if h is None else h.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), B, S, D, N, ng, int(chunked),
            *scan_kernel.bc_strides("Bm", Bm),
            *scan_kernel.bc_strides("Cm", Cm), int(x.dtype == bf16),
            int(dt.dtype == bf16), int(Bm.dtype == bf16),
            _build.stream_of(x)), "baseline selective_scan")
        return y

    for label, (B, S, (a_f32, a)) in cases.items():
        h = a[5]
        keep = None if h is None else h.clone()
        yo = old(a, B, S)
        if keep is not None:
            h.copy_(keep)
        yn = new(a)
        torch.cuda.synchronize()
        diff = float((yo - yn).abs().max())
        t = [timed_ms(torch, f) for f in (lambda: old(a, B, S),
                                          lambda: new(a), lambda: new(a),
                                          lambda: old(a, B, S))]
        tm = timed_ms(torch, lambda: new(a_f32))
        print(f"ab[{label}]: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f}"
              f" / {t[2]:.4f} ms, speed-up {(t[0] + t[3]) / (t[1] + t[2]):.2f}x"
              f", max |old - new| y {diff:.3g}; new on f32 dt and contiguous "
              f"f32 Bm/Cm {tm:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
