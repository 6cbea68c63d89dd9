"""Model architecture config (a copy of the JAX package's ``ModelConfig``).

Every assigned architecture is expressed as a ``ModelConfig``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int            # query heads (0 => attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0       # 0 => d_model // n_heads
    qkv_bias: bool = False
    causal: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 1e6

    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1     # 1 = mamba1 (selective scan), 2 = mamba2 (SSD)
    ssm_head_dim: int = 64   # mamba2 head size P

    # --- hybrid (zamba2-style shared attention) ---
    shared_attn_every: int = 0   # apply one shared attn block every k layers

    # --- modality frontend stub (vlm / audio) ---
    frontend: str = "none"   # none | patch | frame
    frontend_dim: int = 0    # width of precomputed patch/frame embeddings
    frontend_len: int = 64   # positions consumed by the frontend inside seq

    # numerics
    param_dtype: str = "bfloat16"
    accum_dtype: str = "float32"

    # ---------------------------------------------------------------- helpers
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    @property
    def n_ssm_heads(self) -> int:
        return max(1, self.d_inner // self.ssm_head_dim)

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0 or self.shared_attn_every > 0

    @property
    def uses_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Analytic parameter count (matches the real init pytree)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        total = V * D                      # token embedding
        if not self.tie_embeddings:
            total += D * V                 # lm head
        total += D                         # final norm
        if self.frontend != "none":
            total += self.frontend_dim * D
        per_layer = 0
        if self.family in ("dense", "moe", "encoder", "vlm"):
            per_layer += self._attn_params()
            per_layer += 2 * D             # two norms
            if self.uses_moe:
                per_layer += D * self.n_experts                  # router
                per_layer += self.n_experts * 3 * D * F          # wi, wg, wo
            else:
                per_layer += 3 * D * F                           # swiglu
        elif self.family in ("ssm", "hybrid"):
            per_layer += self._mamba_params() + D                # norm
        total += per_layer * L
        if self.shared_attn_every:
            # one shared attention + mlp block
            total += self._attn_params() + 3 * D * self.d_ff + 2 * D
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.uses_moe:
            return self.n_params()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        dead = self.n_experts - self.moe_top_k
        return self.n_params() - L * dead * 3 * D * F

    def _attn_params(self) -> int:
        D, H, K, hd = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        p = D * H * hd + 2 * D * K * hd + H * hd * D
        if self.qkv_bias:
            p += H * hd + 2 * K * hd
        return p

    def _mamba_params(self) -> int:
        D, Di, N = self.d_model, self.d_inner, self.ssm_state
        p = D * 2 * Di                         # in_proj (x, z)
        p += Di * self.ssm_conv + Di           # conv1d
        p += Di * D                            # out_proj
        if self.ssm_version == 1:
            p += Di * (self.dt_rank + 2 * N)   # x_proj -> dt, B, C
            p += self.dt_rank * Di + Di        # dt_proj
            p += Di * N + Di                   # A_log, D
        else:
            nh = self.n_ssm_heads
            p += D * (2 * N + nh)              # B, C, dt projections
            p += nh * 3                        # A_log, D, dt_bias per head
            p += Di                            # pre-out-proj norm
        return p

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=4 if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.n_experts else 0,
            capacity_factor=4.0 if self.n_experts else self.capacity_factor,  # dropless at E=4
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            shared_attn_every=2 if self.shared_attn_every else 0,
            frontend_dim=32 if self.frontend != "none" else 0,
            frontend_len=4 if self.frontend != "none" else 64,
            name=self.name + "-reduced",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
