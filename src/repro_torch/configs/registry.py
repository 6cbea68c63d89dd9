"""Registry of the 10 assigned architectures (+ the paper's own workloads).

Sources are the public configs cited in the assignment; ``head_dim`` follows
the published model cards where the naive ``d_model/n_heads`` would differ
(e.g. Qwen3-MoE uses head_dim=128).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

# --------------------------------------------------------------------------
# LM-family transformers
# --------------------------------------------------------------------------

MISTRAL_LARGE_123B = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768, rope_theta=1e6,
)

PHI4_MINI_38B = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=200064, rope_theta=1e4,
)

QWEN2_72B = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
)

STARCODER2_3B = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab_size=49152, rope_theta=1e5,
)

QWEN3_MOE_235B = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    n_experts=128, moe_top_k=8, rope_theta=1e6,
)

LLAMA4_SCOUT_17B = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=16, moe_top_k=1, rope_theta=5e5,
)

PHI3_VISION_42B = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064, rope_theta=1e4,
    frontend="patch", frontend_dim=1024, frontend_len=64,
)

ZAMBA2_12B = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_version=2, ssm_head_dim=64,
    shared_attn_every=6,
)

HUBERT_XLARGE = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504, causal=False,
    frontend="frame", frontend_dim=512, frontend_len=0,  # whole seq is frames
)

FALCON_MAMBA_7B = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_version=1, ssm_expand=2,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        MISTRAL_LARGE_123B, PHI4_MINI_38B, QWEN2_72B, STARCODER2_3B,
        QWEN3_MOE_235B, LLAMA4_SCOUT_17B, PHI3_VISION_42B, ZAMBA2_12B,
        HUBERT_XLARGE, FALCON_MAMBA_7B,
    )
}


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name.endswith("-reduced") and name[: -len("-reduced")] in ARCHS:
        return ARCHS[name[: -len("-reduced")]].reduced()
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
