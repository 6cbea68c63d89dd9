#!/usr/bin/env python3
"""The decode-vs-prefill logit gap of the reduced hybrid on the card, over
seeds: the number behind the bound of
``tests/test_torch_cuda_hybrid.py::test_reduced_hybrid_serve_launches_every_kernel``.

Reduced zamba2-1.2b at hd 64, 3 layers (the shared block twice), the
test's model: parameters from seed s, 2 sequences of 9 tokens from a
generator seeded 14 + s; token-by-token decode from a zero state (the
scan from h0, paged attention over the slab) against one prefill (the
scan from zeros, flash).  Prints each seed's largest |logit difference|
of the last token, and 1.5 x the largest over the seeds.  Needs an NVIDIA
GPU.

    PYTHONPATH=src python scripts/hybrid_decode_gap_card.py [--seeds 8]
"""
import argparse

import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import lm


def gap(seed: int, dev) -> float:
    cfg = get_config("zamba2-1.2b").reduced(head_dim=64, n_layers=3)
    params = lm.init_params(cfg, seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(14 + seed)
    tok = torch.randint(0, cfg.vocab_size, (2, 9), generator=g, device=dev)
    full, _ = lm.prefill(params, tok, cfg)
    cache = {k: torch.zeros(s, device=dev, dtype=torch.float32
                            if k == "h" else torch.bfloat16)
             for k, s in lm.init_cache_shapes(cfg, 2, 16).items()}
    for t in range(9):
        lg, cache = lm.decode_step(params, cache, tok[:, t:t + 1],
                                   torch.full((2,), t, device=dev), cfg)
    return float((lg[:, 0].float() - full[:, -1].float()).abs().max())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gaps = [gap(s, dev) for s in range(args.seeds)]
    for s, x in enumerate(gaps):
        print(f"seed {s}: decode vs prefill max |logit diff| {x:.6f}")
    print(f"largest {max(gaps):.6f}; 1.5 x largest {1.5 * max(gaps):.6f} "
          f"({torch.cuda.get_device_name(0)})")


if __name__ == "__main__":
    main()
