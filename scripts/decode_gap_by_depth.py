#!/usr/bin/env python3
"""How far the JAX package's own decode path drifts from its prefill path
with depth, on random-init zamba2-1.2b at reduced width (CPU): token by
token decode of 12 tokens from a zero cache against one prefill of the
same tokens, the largest logit difference and the argmax agreement at
each depth.  The port's full-depth parity checks (chip_smoke.py phase 10)
measure their own floor in the run; this shows the reference drifts the
same way, so the drift is the model's bf16 rounding, not the port.

    PYTHONPATH=src python scripts/decode_gap_by_depth.py
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_config
from repro.models import lm as jlm

DEPTHS = (1, 2, 6, 7, 12, 13, 19, 25, 38)


def main():
    for depth in DEPTHS:
        cfg = get_config("zamba2-1.2b").reduced(n_layers=depth,
                                                shared_attn_every=6)
        p = jlm.init_params(cfg, jax.random.PRNGKey(0))
        B, T = 4, 12
        tok = jnp.asarray(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, T)), jnp.int32)
        ref = np.asarray(jlm.prefill(p, {"tokens": tok}, cfg)[0][:, -1],
                         np.float32)
        cache = jlm.init_cache(cfg, B, 16)
        step = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos,
                                                             cfg))
        for t in range(T):
            lg, cache = step(p, cache, tok[:, t:t + 1],
                             jnp.full((B,), t, jnp.int32))
        out = np.asarray(lg[:, 0], np.float32)
        print(f"{depth:2d} layers: decode vs prefill max |logit diff| "
              f"{np.abs(out - ref).max():.4f} (|logit| max "
              f"{np.abs(ref).max():.3f}), argmax agreement "
              f"{(out.argmax(-1) == ref.argmax(-1)).mean():.2f}")


if __name__ == "__main__":
    main()
