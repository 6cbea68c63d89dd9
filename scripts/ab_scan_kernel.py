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

    python3 scripts/ab_scan_kernel.py --bwd-baseline DIR

times the backward (``mamba_scan_bwd.cu``, both launches) against an
earlier source in DIR with the C interface before clusters
(``selective_scan_bwd(x, dt, Bm, Cm, A, h_chk, gy, gx, gdt, gB, gC, gA,
gh0, part, B, S, D, N, L, ng, dblock, b_sb, b_st, c_sb, c_st, x_bf16,
dt_bf16, bc_bf16, stream)``, 256 threads a block, 4 states a thread, a
partial row a block and a gA partial a batch row), old, new, new, old, at
both training shapes (4 x 512 tokens, interval 64: falcon-mamba-7b's D
8192, N 16, x and dt bf16, Bm and Cm bf16 views; zamba2-1.2b's D 4096, N
64, f32), with the L2 flushed; it also prints the largest difference of
each gradient between the two, the scratch each allocates and the bound.

    python3 scripts/ab_scan_kernel.py --bwd-phases

times the backward cut short after staging (each segment's inputs loaded
and stored, nothing computed), after pass A, whole, without its sums over
d, and its core alone (the passes and the walk back without the sums over
d, the barriers, the lanes' reduce-scatter, the staging and the cluster's
exchange), in turns, beside a one-element kernel for the launch floor; and
how many clusters of 1, 2, 4 and 8 blocks the card holds at once (a query
added to the whole kernel's copy).

    python3 scripts/ab_scan_kernel.py --bwd-plans

times the backward with 2 and 4 states a thread (512 or 256 threads a
block at both shapes) and clusters of 1, 2 and 8 blocks along d (copies
of the source with kNG and kCluster edited; each plans its own scratch),
in turns, at both training shapes: the evidence behind kNG and kCluster.
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

# The backward's cuts: the next unit (a segment of a batch row) staged whole
# at the top of each unit, or after the unit's pass A; a value of the
# staged segment or the pass's states read so the compiler keeps them; no
# exchange and no gA at the end.
_BWD_STAGE = (
    "    if (more)\n      for (int p = 0; p < npiece; ++p) {\n"
    "        fetch(nxt, u + 1, p);\n        stash(nxt, cur ^ 1, p);\n      }\n")
_BWD_TAIL = ("  // -- bwd: tail\n", "  return;\n")
BWD_CUTS = {
    "staged": [("    // -- bwd: staged\n", _BWD_STAGE + (
        "    if (q.dt[tid % kSeg][tid % kDB] + q.x[tid % kSeg][(tid + 1) % kDB]"
        " + q.gy[(tid + 1) % kSeg][tid % kDB] + q.b[tid % kSeg][tid % N]"
        " + q.c[(tid + 1) % kSeg][tid % N] == 1234.5f) part[0] = 0.f;\n"
        "    __syncthreads();\n    continue;\n")), _BWD_TAIL],
    "pass_a": [("    // -- bwd: pass A\n", _BWD_STAGE + (
        "    if (h[0] + h[1] == 1234.5f) part[0] = 0.f;\n"
        "    __syncthreads();\n    continue;\n")), _BWD_TAIL],
}
# Whole kernels less one part: without the sums over d (the terms' stores
# and the block's sums), and the core alone (passes A and B and the walk
# back, without those sums, the two barriers a sub-interval, the lanes'
# reduce-scatter, the staging of the next unit and the cluster's exchange;
# every unit then reads what its slot last held).
_NO_SUMS = [
    ("        store_vec(&sm.red[0][k][tid * kNG], gb);\n"
     "        store_vec(&sm.red[1][k][tid * kNG], gc);\n",
     "        if (gb[0] + gb[kNG - 1] + gc[0] + gc[kNG - 1] == 1234.5f) part[1] = 0.f;\n"),
    ("      {                                          // the terms summed over the block's d's\n",
     "      if (false) {\n")]
BWD_CUTS["no_sums"] = _NO_SUMS
BWD_CUTS["core"] = _NO_SUMS + [
    ("      __syncthreads();\n      if (jj == 0 && u > 0) cluster_wait();",
     "      if (jj == 0 && u > 0) cluster_wait();"),
    ("        recompute<N>(q, &sm.ck[j - 1][tid * kNG], j - 1, dl, g, a2, hs, av);\n"
     "      }\n      __syncthreads();\n",
     "        recompute<N>(q, &sm.ck[j - 1][tid * kNG], j - 1, dl, g, a2, hs, av);\n      }\n"),
    ("      reduce_scatter<G / 2, 2 * kSub>(sv, g);\n      if ((g & dup) == 0) {\n",
     "      if (sv[0] + sv[3] == 1234.5f) part[2] = 0.f;\n      if (false) {\n"),
    ("        stash(nxt, cur ^ 1, jj);\n", ""),
    ("    if (more) fetch(nxt, u + 1, 0);\n", ""),
    ("        if (more) fetch(nxt, u + 1, jj + 1);\n", ""),
    ("      exchange(u - 1);\n", "")]
BWD_PLAN_ANCHORS = ("constexpr int kNG = ", "constexpr int kCluster = ")
# Added to the whole kernel's copy: how many clusters of `cluster` blocks of
# scan_bwd<N> the card holds at once (cudaOccupancyMaxActiveClusters), -1 on
# error.
BWD_OCCUPANCY = [("}  // namespace\n", """template <int N> int max_clusters(int cluster) {
  constexpr size_t smem = sizeof(Smem<N>);
  if (cudaFuncSetAttribute(scan_bwd<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(threads(N));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, scan_bwd<N>, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace

extern "C" int selective_scan_bwd_clusters(int N, int cluster) {
  return N == 16 ? max_clusters<16>(cluster) : N == 64 ? max_clusters<64>(cluster) : -1;
}
""")]

# Plan sweep: the kernel's NG constants, each made to give `ng` at N = 16.
PLAN_ANCHORS = ("constexpr int kDirectNG = N < 8 ? N : 8;",
                "constexpr int kChunkedNG = N / 8 > 2 ? N / 8 : 2;")


def plan_cuts(ng: int):
    return [(a, a.replace("= N", f"= N == {N} ? {ng} : N", 1))
            for a in PLAN_ANCHORS]


def build_cut(tag: str, cuts, name: str = "mamba_scan") -> ctypes.CDLL:
    """The current kernel ``name`` with ``cuts`` applied, built beside the
    real library."""
    from repro_torch.kernels import _build
    d = _build.BUILD_DIR / "phases"
    d.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / f"{name}.cu").read_text()
    for anchor, text in cuts:
        if anchor not in src:
            sys.exit(f"ab_scan_kernel: anchor {anchor.strip()!r} not found")
        src = src.replace(anchor, text, 1)
    (d / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    (d / f"{name}-{tag}.cu").write_text(src)
    out = d / f"{name}-{tag}.so"
    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(d / f"{name}-{tag}.cu")], capture_output=True,
                          text=True)
    if done.returncode != 0:
        sys.exit(f"ab_scan_kernel: {name}-{tag} failed to build:\n"
                 f"{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out))


def build_cuts(jobs, name: str) -> dict:
    """``build_cut`` for each (tag, cuts) in ``jobs``, in parallel."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {tag: ex.submit(build_cut, tag, cuts, name)
                for tag, cuts in jobs}
    return {tag: f.result() for tag, f in futs.items()}


def bwd_cases(torch, g):
    """The backward's two training shapes: (label, inputs, h_chk, gy)."""
    from chip_smoke import TRAIN_B, TRAIN_S, scan_train_inputs
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    L = scan_kernel.CHK_STEPS
    out = []
    for form in ("falcon", "zamba2"):
        ins = scan_train_inputs(torch, g, form, TRAIN_B, TRAIN_S)
        x, dt, Bm, Cm, A = ins
        B, S, D = x.shape
        N = A.shape[1]
        h_chk = torch.empty((B, -(-S // L), D, N), device="cuda")
        scan_kernel.selective_scan(*ins, h_chk=h_chk, chunk=L)
        gy = torch.randn((B, S, D), generator=g, device="cuda")
        out.append((f"{form} B={B} S={S} D={D} N={N} L={L}", ins, h_chk, gy))
    return out


def bwd_main(args, torch):
    """--bwd-baseline, --bwd-phases and --bwd-plans."""
    from ab_attention_kernels import build_baseline
    from chip_smoke import card_line, scan_bwd_bound, sm_clock_ghz, timed_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    g = torch.Generator(device="cuda").manual_seed(27)
    print(f"card: {card_line()}", flush=True)
    cases = bwd_cases(torch, g)
    L = scan_kernel.CHK_STEPS

    def new(ins, h_chk, gy):
        return scan_kernel.selective_scan_bwd(*ins, h_chk, gy, chunk=L)

    if args.bwd_phases or args.bwd_plans:
        if args.bwd_phases:
            jobs = list(BWD_CUTS.items()) + [("whole", BWD_OCCUPANCY)]
        else:
            src = (_build.CSRC / "mamba_scan_bwd.cu").read_text()
            lines = [next(ln for ln in src.splitlines() if ln.startswith(a))
                     for a in BWD_PLAN_ANCHORS]

            def edit(line, v):
                return line, line.split("=")[0] + f"= {v};" + line.split(";", 1)[1]

            jobs = [(f"ng{ng}_cl{c}", [edit(lines[0], ng), edit(lines[1], c)])
                    for ng in (2, 4) for c in (1, 2, 8)]
        libs = build_cuts(jobs, "mamba_scan_bwd")
        if args.bwd_phases:
            f = libs["whole"].selective_scan_bwd_clusters
            f.argtypes, f.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
            for N in (16, 64):
                print(f"clusters[N={N}]: the most the card holds at once: "
                      + ", ".join(f"{c} blocks {f(N, c)}" for c in (1, 2, 4, 8)),
                      flush=True)
            x = torch.zeros(1, device="cuda")
            print(f"phases: launch floor (one-element add) "
                  f"{timed_ms(torch, lambda: x.add_(1)):.4f} ms", flush=True)
        for rep in range(2):                 # the second pass in reverse
            for label, ins, h_chk, gy in cases:
                res = []
                for tag in list(libs) if rep == 0 else list(libs)[::-1]:
                    _build._LIBS["mamba_scan_bwd"] = libs[tag]
                    new(ins, h_chk, gy)
                    torch.cuda.synchronize()
                    res.append(f"{tag} "
                               f"{timed_ms(torch, lambda: new(ins, h_chk, gy)):.4f}")
                what = "phases" if args.bwd_phases else "plans"
                print(f"{what}[{label}] pass {rep}: {', '.join(res)} ms",
                      flush=True)
        _build._LIBS.pop("mamba_scan_bwd", None)
        return

    fn = build_baseline(args.bwd_baseline, "mamba_scan_bwd").selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 14 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bf16 = torch.bfloat16

    def old(ins, h_chk, gy):
        x, dt, Bm, Cm, A = ins
        B, S, D = x.shape
        N = A.shape[1]
        dblock = 256 // (N // 4)
        nblk = -(-D // dblock)
        dev = x.device
        gx = torch.empty_like(x)
        gdt = torch.empty_like(dt)
        gB = torch.empty((B, S, N), dtype=Bm.dtype, device=dev)
        gC = torch.empty((B, S, N), dtype=Bm.dtype, device=dev)
        gA = torch.empty((D, N), device=dev)
        part = torch.empty(2 * B * nblk * S * N + B * D * N, device=dev)
        _build.check_launch(fn(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), h_chk.data_ptr(), gy.data_ptr(), gx.data_ptr(),
            gdt.data_ptr(), gB.data_ptr(), gC.data_ptr(), gA.data_ptr(), None,
            part.data_ptr(), B, S, D, N, L, 4, dblock,
            *scan_kernel.bc_strides("Bm", Bm),
            *scan_kernel.bc_strides("Cm", Cm), int(x.dtype == bf16),
            int(dt.dtype == bf16), int(Bm.dtype == bf16),
            _build.stream_of(x)), "baseline selective_scan_bwd")
        return (gx, gdt, gB, gC, gA), part.numel()

    clock = sm_clock_ghz()
    for label, ins, h_chk, gy in cases:
        x, dt, Bm, Cm, A = ins
        B, S, D = x.shape
        N = A.shape[1]
        go, old_part = old(ins, h_chk, gy)
        gn = new(ins, h_chk, gy)[:5]
        torch.cuda.synchronize()
        diffs = ", ".join(
            f"{n} {float((a.double() - b.double()).abs().max() / b.double().abs().max()):.3g}"
            for n, a, b in zip(("gx", "gdt", "gB", "gC", "gA"), gn, go))
        t = [timed_ms(torch, f) for f in (lambda: old(ins, h_chk, gy),
                                          lambda: new(ins, h_chk, gy),
                                          lambda: new(ins, h_chk, gy),
                                          lambda: old(ins, h_chk, gy))]
        bb = scan_bwd_bound(x, dt, Bm, A, h_chk, clock)[0]
        new_part = scan_kernel.bwd_scratch(B, S, D, N)
        print(f"ab_bwd[{label}]: old {t[0]:.4f} / {t[3]:.4f} ms, new "
              f"{t[1]:.4f} / {t[2]:.4f} ms, speed-up "
              f"{(t[0] + t[3]) / (t[1] + t[2]):.2f}x; bound {bb[0]:.4f} ms "
              f"({bb[1]}); scratch old {old_part * 4 / 1e6:.1f} MB, new "
              f"{new_part * 4 / 1e6:.1f} MB; max |new - old| of the largest "
              f"|old|: {diffs}", flush=True)


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
    mode.add_argument("--bwd-baseline", type=Path)
    mode.add_argument("--bwd-phases", action="store_true")
    mode.add_argument("--bwd-plans", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_scan_kernel: needs a CUDA device")
    if args.bwd_baseline or args.bwd_phases or args.bwd_plans:
        return bwd_main(args, torch)
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
