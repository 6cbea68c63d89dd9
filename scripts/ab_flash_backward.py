#!/usr/bin/env python3
"""Check and time the flash-attention backward kernel on one card.

    python3 scripts/ab_flash_backward.py [--baseline DIR | --variants]

Builds ``csrc/flash_attention_bwd.cu`` and prints its kernels' ptxas lines
(registers, spills).  Holds (dq, dk, dv) to autograd through the plain
version at hd 64 and 128, group sizes G = 1, 2, 3 and 12, ragged lengths,
causal and not, and per-request positions: each gradient within
``BWD_RTOL`` of its largest |value|, and bit for bit across two calls.
Then at the training shape (B=4, S=512, H=24, K=2, hd 128, causal): the
whole call and each launch's device time (L2 flushed before every call),
the TFLOP/s of the products each launch executes, and SDPA's backward on
the same inputs.  With ``--baseline DIR`` also an earlier
``flash_attention_bwd.cu`` in DIR with the same C interface (for example
unpacked with ``git archive <commit> src/repro_torch/kernels/csrc``), in
turns: old, new, new, old.  With ``--variants`` instead edited copies of
the current source, each a choice of its constants (the register split
between the producer and consumer warpgroups, the dk/dv pass's product
width, the most CTAs that split a group's heads), built side by side and
timed in turns at the training shape beside their ptxas spill lines.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

H, K, HD = 24, 2, 128
BWD_RTOL = 2e-2            # as chip_smoke.py: P and dS rounded to bf16
CASES = [                  # B, Sq, Skv, H, K, hd, causal, shift
    (1, 64, 64, 2, 2, 64, False, 0),
    (1, 64, 64, 2, 2, 128, False, 0),
    (2, 128, 128, 2, 2, 64, True, 0),        # G = 1
    (1, 200, 200, 4, 2, 64, True, 0),        # G = 2, ragged
    (1, 190, 190, 6, 2, 128, True, 0),       # G = 3
    (2, 320, 320, 24, 2, 128, True, 0),      # G = 12
    (1, 77, 77, 24, 2, 128, False, 0),       # not causal, ragged
    (1, 64, 64, 8, 4, 64, False, 0),
    (2, 96, 300, 8, 2, 64, True, 0),         # suffix queries over a longer kv
    (2, 150, 150, 12, 1, 128, True, 70),     # per-request positions
    (4, 512, 512, H, K, HD, True, 0),        # the training shape
]


# name -> {constant: value}: edits of flash_attention_bwd.cu's constexprs
VARIANTS = {
    "as built": {},
    "regs 24/232": {"kProducerRegs": 24, "kConsumerRegs": 232},
    "regs 40/216": {"kProducerRegs": 40, "kConsumerRegs": 216},
    "regs 40/216, dkv width 32": {"kProducerRegs": 40, "kConsumerRegs": 216,
                                  "kDkvWidth": 32},
    "split 2": {"kMaxSplit": 2},
    "split 3": {"kMaxSplit": 3},
    "split 6": {"kMaxSplit": 6},
}

def build_variants():
    """Each variant's library, built in parallel beside the real one:
    {name: (CDLL, ptxas spill lines)}."""
    from repro_torch.kernels import _build
    d = _build.BUILD_DIR / "variants"
    d.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for h in _build.CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for const, value in edits.items():
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            if n != 1:
                sys.exit(f"ab_flash_backward: constant {const} not found")
        (d / f"v{i}.cu").write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"v{i}.so"),
             str(d / f"v{i}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), d / f"v{i}.so")
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"ab_flash_backward: variant {name} failed:\n{log}")
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", log)
        out[name] = (ctypes.CDLL(str(so)), spills)
    return out


def build_baseline(src_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "baseline-flash_attention_bwd.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src_dir / "flash_attention_bwd.cu")], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--baseline", type=Path)
    mode.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_flash_backward: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import card_line, launch_ms, timed_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)
    print(f"card: {card_line()}", flush=True)
    log = _build.build_all(("flash_attention_bwd",)).get("flash_attention_bwd")
    if log is None:
        log = _build.library_path("flash_attention_bwd").with_suffix(
            ".log").read_text()
    for line in log.splitlines():
        if re.search(r"Compiling entry|registers|spill|warning", line):
            print(f"ptxas: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    bad = 0
    for B, Sq, Skv, h, kv, hd, causal, shift in CASES:
        q, k, v, do = (randn(B, Sq, h, hd), randn(B, Skv, kv, hd),
                       randn(B, Skv, kv, hd), randn(B, Sq, h, hd))
        qp = torch.arange(Sq, device=dev) + (Skv - Sq)
        qp = torch.stack([qp - shift * b for b in range(B)]).clamp_min(0)
        kp = torch.arange(Skv, device=dev).expand(B, Skv)
        out, lse = flash_attention(q, k, v, qp, kp, causal=causal,
                                   return_lse=True)
        got = flash_attention_bwd(q, k, v, out, do, lse, qp, kp,
                                  causal=causal)
        again = flash_attention_bwd(q, k, v, out, do, lse, qp, kp,
                                    causal=causal)
        torch.cuda.synchronize()
        want = attention_bwd_ref(q, k, v, do, qp, kp, causal=causal)
        errs = []
        for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
            e = float((a.float() - b.float()).abs().max()
                      / b.float().abs().max().clamp_min(1e-30))
            ok = bool(torch.isfinite(a.float()).all()) and e <= BWD_RTOL
            same = torch.equal(a, c)
            bad += (not ok) + (not same)
            errs.append(f"{name} {e:.3g}{'' if ok else ' FAIL'}"
                        f"{'' if same else ' NOT-DETERMINISTIC'}")
        print(f"check B={B} Sq={Sq} Skv={Skv} H={h} K={kv} hd={hd} "
              f"causal={causal} shift={shift}: {', '.join(errs)}",
              flush=True)

    B, S = 4, 512
    q, k, v, do = (randn(B, S, H, HD), randn(B, S, K, HD), randn(B, S, K, HD),
                   randn(B, S, H, HD))
    pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
    out, lse = flash_attention(q, k, v, pos, pos, return_lse=True)

    def new():
        return flash_attention_bwd(q, k, v, out, do, lse, pos, pos)

    fns = {"new": new}
    tiles = B * H * (S // 64) * (S // 64 + 1) // 2
    flop = 2 * 64 * 64 * HD * tiles     # one product on whole 64 x 64 tiles
    if args.variants:
        libs = build_variants()
        want = new()
        # the same shape without the causal mask: every CTA of a pass has
        # the same work, so this time shows the per-item cost apart from
        # the causal load balance
        out_nc, lse_nc = flash_attention(q, k, v, pos, pos, causal=False,
                                         return_lse=True)

        def new_nc():
            return flash_attention_bwd(q, k, v, out_nc, do, lse_nc, pos, pos,
                                       causal=False)
        res = {n: [] for n in libs}
        for rep in range(2):                 # the second pass in reverse
            for name in (list(libs) if rep == 0 else list(libs)[::-1]):
                _build._LIBS["flash_attention_bwd"] = libs[name][0]
                got, again = new(), new()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                err = max(float((a.float() - b.float()).abs().max()
                                / b.float().abs().max()) for a, b in
                          zip(got, want))
                res[name].append((timed_ms(torch, new), same, err))
                if rep == 1:
                    res[name].append(timed_ms(torch, new_nc))
                    per = launch_ms(torch, new, r"flash_bwd_\w+_kernel")
                    res[name].append(per)
        for name, (a, b, nc, per) in res.items():
            print(f"variant[{name}]: {a[0]:.4f} / {b[0]:.4f} ms (not causal "
                  f"{nc:.4f}), launches "
                  + ", ".join(f"{k} {v:.4f}" for k, v in sorted(per.items()))
                  + f"; max rel diff to as-built {max(a[2], b[2]):.3g}, "
                  f"deterministic {a[1] and b[1]}; spill (stores, loads) a "
                  f"kernel {libs[name][1]}", flush=True)
        _build._LIBS.clear()
        return
    if args.baseline:
        old_fn = build_baseline(args.baseline)

        def old():
            dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                          torch.empty_like(v))
            delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
            _build.check_launch(old_fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                do.data_ptr(), lse.data_ptr(), pos.data_ptr(), pos.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                B, S, S, H, K, HD, 1, HD ** -0.5, _build.stream_of(q)),
                "baseline flash_attention_bwd")
            return dq, dk, dv

        fns["old"] = old
        a, b = old(), new()
        torch.cuda.synchronize()
        print("ab: max |old - new| " + ", ".join(
            f"{n} {float((x.float() - y.float()).abs().max()):.3g}"
            for n, x, y in zip(("dq", "dk", "dv"), a, b)), flush=True)
    order = ["old", "new", "new", "old"] if args.baseline else ["new", "new"]
    times = {n: [] for n in fns}
    for n in order:
        times[n].append(timed_ms(torch, fns[n]))
    # the products executed: 3 in the dq pass, 4 in dk/dv
    for n, ts in times.items():
        per = launch_ms(torch, fns[n], r"flash_bwd_\w+_kernel")
        parts = ", ".join(
            f"{name} {ms:.4f} ms" + (
                f" ({3 * flop / ms / 1e9:.0f} TFLOP/s)" if "_dq_" in name
                else f" ({4 * flop / ms / 1e9:.0f} TFLOP/s)"
                if "dkdv" in name else "")
            for name, ms in sorted(per.items()))
        print(f"time[{n}] B={B} S={S} H={H} K={K} hd={HD}: "
              f"{' / '.join(f'{t:.4f}' for t in ts)} ms; launches: {parts}",
              flush=True)
    # where the whole call's time goes besides the two kernels: the host's
    # enqueue time a call, and the device's gap between the launches
    import time

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        new()
    host = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flush.zero_()
            new()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if "flash_bwd" in e.name
                 and "CUDA" in str(e.device_type)),
                key=lambda e: e.time_range.start)
    gaps = [b.time_range.start - a.time_range.end for a, b in zip(ev, ev[1:])
            if "_dq_" in a.name and "dkdv" in b.name]
    print(f"time[new]: host {host:.4f} ms a call to enqueue; device gap "
          f"between the dq and dk/dv launches {sum(gaps) / max(len(gaps), 1) / 1e3:.4f}"
          f" ms (mean of {len(gaps)})", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    lib = timed_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    print(f"time[sdpa backward]: {lib:.4f} ms; products at 7 x "
          f"{flop / 1e9:.2f} GFLOP", flush=True)
    if bad:
        sys.exit(f"ab_flash_backward: {bad} check(s) failed")


if __name__ == "__main__":
    main()
