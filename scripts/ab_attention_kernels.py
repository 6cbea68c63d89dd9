#!/usr/bin/env python3
"""Time the port's attention kernels against an earlier version of their
CUDA sources, in one process on one card, in turns (old, new, new, old).

    python3 scripts/ab_attention_kernels.py --baseline DIR

DIR holds the earlier ``flash_attention.cu``, ``paged_attention.cu`` and
``common.cuh`` (for example unpacked with ``git archive <commit>
src/repro_torch/kernels/csrc``).  Their C interface is the one before the
split-KV redesign: ``flash_attention(q, k, v, q_pos, kv_pos, out, B, Sq, Skv,
H, K, hd, kc, causal, scale, stream)`` and ``paged_attention(q, k_pool,
v_pool, tables, pos, out, B, S, H, K, hd, bs, MB, n_vis, q_bf16, pool_bf16,
scale, stream)``.  The current kernels go through their wrappers.  Shapes:
the serve's decode tick and suffix prefill (paged) and prefills of 320 and
1024 tokens (flash), as ``chip_smoke.py`` times them; device time with the
L2 flushed before each launch.  Needs a CUDA device and nvcc.

    python3 scripts/ab_attention_kernels.py --phases

instead times the current kernels cut short after each phase (a copy of
the sources, edited at fixed anchors, built beside the real ones), in
turns, beside a one-element kernel for the launch floor: paged attention
after its position/q/table loads, after its block copies, without the
split merge, and whole; flash attention after its prologue (Q fragments,
positions, tile statistics, first tile), with its tile loop copying but
not computing, and whole.
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

H, K, HD = 24, 2, 128


def build_baseline(src_dir: Path, name: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"baseline-{name}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src_dir / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


# Phase cuts: (anchor in the source, text put in its place).
PAGED_CUTS = {
    "loads": ("  if (split >= n_live) return;                 // wholly in the future\n",
              "  if (split >= n_live) return;\n"
              "  if (phys[0][0] == -7 && qv[0].x == 7u) out[0] = QT();\n  return;\n"),
    "blocks": ("  // q rows of the tile, widened to f32\n",
               "  port::cp_async_wait<0>();\n  __syncthreads();\n  return;\n"),
    "no_merge": ("  // partials of this split, then the last CTA of the group merges\n",
                 "  return;\n"),
}
FLASH_CUTS = {
    "prologue": ("  int j_end = n_tiles;\n",
                 "  int j_end = n_tiles;\n  if (qf[0][0] == 12345u && qmin == -5)"
                 " out[0] = __nv_bfloat16();\n  port::cp_async_wait<0>();\n  return;\n"),
    "tile_loads": ("    if (causal && tmin[j] > qmax) continue;\n", "    continue;\n"),
}


def build_cut(name: str, tag: str, cut) -> ctypes.CDLL:
    """The current ``name`` kernel with ``cut`` applied, built beside the
    real library."""
    from repro_torch.kernels import _build
    d = _build.BUILD_DIR / "phases"
    d.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / f"{name}.cu").read_text()
    if cut is not None:
        if cut[0] not in src:
            sys.exit(f"ab_attention_kernels: anchor of {name}/{tag} not found")
        src = src.replace(cut[0], cut[1], 1)
    (d / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    (d / f"{name}-{tag}.cu").write_text(src)
    out = d / f"{name}-{tag}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(d / f"{name}-{tag}.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def phases(torch, cases, timed_ms):
    from repro_torch.kernels import _build
    libs = {}
    for name, cuts in (("paged_attention", PAGED_CUTS),
                       ("flash_attention", FLASH_CUTS)):
        for tag, cut in list(cuts.items()) + [("whole", None)]:
            libs[name, tag] = build_cut(name, tag, cut)
    x = torch.zeros(1, device="cuda")
    print(f"phases: launch floor (one-element add) "
          f"{timed_ms(torch, lambda: x.add_(1)):.4f} ms", flush=True)
    for rep in range(2):                     # the second pass in reverse
        for label, (_, new) in cases.items():
            name = "paged_attention" if "paged" in label else "flash_attention"
            tags = [t for (n, t) in libs if n == name]
            res = []
            for tag in tags if rep == 0 else tags[::-1]:
                _build._LIBS[name] = libs[name, tag]
                new()
                torch.cuda.synchronize()
                res.append(f"{tag} {timed_ms(torch, new):.4f}")
            print(f"phases[{label}] pass {rep}: {', '.join(res)} ms",
                  flush=True)
    _build._LIBS.clear()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--baseline", type=Path)
    mode.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_attention_kernels: needs a CUDA device")
    from chip_smoke import card_line, timed_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention

    flash_old = paged_old = None
    if args.baseline:
        flash_old = build_baseline(args.baseline,
                                   "flash_attention").flash_attention
        flash_old.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        paged_old = build_baseline(args.baseline,
                                   "paged_attention").paged_attention
        paged_old.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_void_p]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    cases = {}
    for label, B, S, pos, cols in (
            ("paged decode B=8 S=1 ctx 289-373 bf16 pool bs 16",
             8, 1, [300, 317, 333, 351, 288, 299, 345, 372], 33),
            ("paged suffix prefill S=64 over 256", 1, 64, [256], 22)):
        bs, mb = 16, 64
        q = randn((B, S, H, HD))
        kp, vp = randn((B * mb + 1, bs, K, HD)), randn((B * mb + 1, bs, K, HD))
        bt = (torch.randperm(B * mb, generator=g, device=dev).reshape(B, mb)
              + 1).to(torch.int32)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)

        def old(q=q, kp=kp, vp=vp, bt=bt, p=p, B=B, S=S, cols=cols, bs=bs,
                mb=mb):
            out = torch.empty_like(q)
            _build.check_launch(paged_old(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                p.data_ptr(), out.data_ptr(), B, S, H, K, HD, bs, mb, cols,
                1, 1, HD ** -0.5, _build.stream_of(q)), "baseline paged")
            return out

        def new(q=q, kp=kp, vp=vp, bt=bt, p=p, cols=cols):
            return paged_attention(q, kp, vp, bt, p, ctx_cols=cols)
        cases[label] = (old, new)
    for S in (320, 1024):
        q = randn((1, S, H, HD))
        k, v = randn((1, S, K, HD)), randn((1, S, K, HD))
        qp = torch.arange(S, device=dev, dtype=torch.int32)[None]

        def old(q=q, k=k, v=v, qp=qp, S=S):
            out = torch.empty_like(q)
            _build.check_launch(flash_old(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                qp.data_ptr(), out.data_ptr(), 1, S, S, H, K, HD, 128, 1,
                HD ** -0.5, _build.stream_of(q)), "baseline flash")
            return out

        def new(q=q, k=k, v=v, qp=qp):
            return flash_attention(q, k, v, qp, qp, block_k=128)
        cases[f"flash prefill B=1 S={S}"] = (old, new)

    print(f"card: {card_line()}", flush=True)
    if args.phases:
        return phases(torch, cases, timed_ms)
    for label, (old, new) in cases.items():
        a, b = old(), new()
        torch.cuda.synchronize()
        diff = float((a.float() - b.float()).abs().max())
        t = [timed_ms(torch, f) for f in (old, new, new, old)]
        print(f"ab[{label}]: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f}"
              f" / {t[2]:.4f} ms, speed-up {(t[0] + t[3]) / (t[1] + t[2]):.2f}x"
              f", max |old - new| {diff:.3g}", flush=True)


if __name__ == "__main__":
    main()
