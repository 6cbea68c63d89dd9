"""Analytic per-device cost model: FLOPs, HBM bytes and collective bytes
of one step of a (model, shape, mesh) cell (a copy of the JAX package's
``distributed/costmodel.py``; its numbers equal that module's exactly).

It is arithmetic on ``ModelConfig``.  The dry run (``launch/dryrun.py``)
records it beside what it counts from its trace of the port's own step
(``distributed/trace_analysis.py``): the matrix products' FLOPs, the
collectives' bytes by kind and the peak of live bytes.

Conventions (the JAX package's):
  * params stored bf16 (2 B); optimizer moments fp32 (or bf16 >100B models);
  * chunked attention computes the full masked S^2 (2x causal-useful);
  * all-reduce bytes counted at operand size;
  * per-device = global / n_devices for tensors sharded on both axes.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class MeshDims:
    n_dev: int
    dsz: int   # data axes product (incl. pod)
    msz: int   # model axis


def _layer_matmul_params(cfg: ModelConfig) -> float:
    """Matmul params touched per token per layer (MoE: per *routed* copy)."""
    D, F = cfg.d_model, cfg.d_ff
    if cfg.family in ("dense", "vlm", "encoder"):
        return cfg._attn_params() + 3 * D * F
    if cfg.family == "moe":
        return cfg._attn_params() + D * cfg.n_experts  # router; experts below
    # ssm / hybrid: in/out/x/dt/BC projections
    return cfg._mamba_params()


def train_costs(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshDims,
                remat: str = "full", microbatches: int = 1,
                opt_bytes_per_param: float = 16.0, ssm_chunk: int = 0,
                attn_skip: bool = False) -> dict:
    B, S = shape.global_batch, shape.seq_len
    T = float(B * S)
    L, D, V, F = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff
    nd, dsz, msz = mesh.n_dev, mesh.dsz, mesh.msz
    Td = T / dsz                              # tokens per device row
    Bd = B / dsz

    m_mat = {"none": 6.0, "dots": 6.0, "full": 8.0}[remat]
    m_attn = {"none": 12.0, "dots": 12.0, "full": 16.0}[remat]
    w_passes = {"none": 3.0, "dots": 3.0, "full": 4.0}[remat]
    a_factor = {"none": 3.0, "dots": 3.0, "full": 4.0}[remat]

    # ------------------------------------------------ FLOPs (global)
    flops = 0.0
    p_layer = _layer_matmul_params(cfg)
    flops += m_mat * T * p_layer * L
    if cfg.uses_moe:
        routed = T * cfg.moe_top_k * cfg.capacity_factor
        flops += m_mat * routed * (3 * D * F) * L
    # causal-block skipping (flash kernel): only the lower triangle +
    # diagonal blocks are computed -> ~0.55x of the masked-full S^2
    attn_scale = 0.55 if (attn_skip and cfg.causal) else 1.0
    if cfg.family in ("dense", "vlm", "encoder", "moe"):
        flops += (m_attn / 4.0 * 4.0 * B * (S ** 2) * cfg.n_heads * cfg.hd * L
                  * attn_scale)
    if cfg.family in ("ssm", "hybrid"):
        flops += (m_mat / 2.0) * 8.0 * B * S * cfg.d_inner * cfg.ssm_state * L
        flops += m_mat * B * S * cfg.d_inner * cfg.ssm_conv * L
    if cfg.shared_attn_every:
        napps = -(-L // cfg.shared_attn_every)
        sh_p = cfg._attn_params() + 3 * D * F
        flops += m_mat * T * sh_p * napps
        flops += (m_attn / 4.0 * 4.0 * B * (S ** 2) * cfg.n_heads * cfg.hd
                  * napps * attn_scale)
    flops += 6.0 * T * D * V                  # logits fwd+bwd (outside remat)
    flops_dev = flops / nd

    # ------------------------------------------------ HBM bytes (per device)
    nbytes = 0.0
    P = cfg.n_params()
    # weights: read model-shard of gathered weights per pass per layer
    nbytes += w_passes * P * 2.0 / msz
    # optimizer: fully sharded update traffic
    nbytes += opt_bytes_per_param * P / nd
    # residual stream + projections (+2 = write+read each)
    if cfg.family in ("dense", "vlm", "encoder", "moe"):
        qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
        act_layer = (8 * Td * D + 2 * Td * qkv / msz
                     + 2 * Td * cfg.n_heads * cfg.hd / msz)
        if cfg.uses_moe:
            routed_d = Td * cfg.moe_top_k * cfg.capacity_factor
            act_layer += 4 * routed_d * D / msz + 4 * Td * D
        else:
            act_layer += 4 * Td * F / msz
        # flash KV re-reads: each q-chunk rereads K,V
        nq = max(1, S // 512)
        act_layer += nq * Bd * S * 2 * cfg.n_kv_heads * cfg.hd / msz
        nbytes += a_factor * act_layer * 2.0 * L
    else:
        Di, N = cfg.d_inner, cfg.ssm_state
        # state traffic: read+write h (fp32) once per *step*; with the
        # chunk-blocked schedule (the scan kernel) once per *chunk*
        state_steps = S / max(ssm_chunk, 1)
        state_traffic = state_steps * Bd * 16.0 * Di * N / msz
        stream_traffic = S * Bd * 12.0 * Di / msz          # dt/x/y streams
        act_layer = (8 * Td * D + 4 * Td * Di / msz
                     + (state_traffic + stream_traffic) / 2.0)
        nbytes += a_factor * act_layer * 2.0 * L
        if cfg.shared_attn_every:
            napps = -(-L // cfg.shared_attn_every)
            nq = max(1, S // 512)
            sh = (8 * Td * D + 4 * Td * F / msz
                  + nq * Bd * S * 2 * cfg.n_kv_heads * cfg.hd / msz)
            nbytes += a_factor * sh * 2.0 * napps
    # logits + CE
    nbytes += 3.0 * Td * V / msz * 2.0 + 3.0 * D * V * 2.0 / msz
    nbytes_dev = nbytes

    # ------------------------------------------------ collective bytes/device
    coll = 0.0
    gather_passes = w_passes - 1.0            # fwd, bwd (+ remat refetch)
    coll += gather_passes * P * 2.0 / msz     # FSDP all-gather of weights
    coll += P * 2.0 / msz                     # grad reduce-scatter
    # Megatron-style partial-sum ARs: 2 per layer per pass on (Td, D)
    coll += a_factor * 2.0 * Td * D * 2.0 * L / max(1, microbatches) \
        * (1.0 if msz > 1 else 0.0)
    if cfg.uses_moe:
        routed_d = Td * cfg.moe_top_k * cfg.capacity_factor
        coll += a_factor * 2.0 * routed_d * D * 2.0 * L
    coll_dev = coll

    model_flops = 6.0 * cfg.n_active_params() * T
    return {"flops_dev": flops_dev, "hbm_bytes_dev": nbytes_dev,
            "coll_bytes_dev": coll_dev, "model_flops_dev": model_flops / nd,
            "model_flops_global": model_flops}


def serve_costs(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshDims,
                serve_params: str = "fsdp") -> dict:
    B, S = shape.global_batch, shape.seq_len
    L, D, V, F = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff
    nd, dsz, msz = mesh.n_dev, mesh.dsz, mesh.msz
    P = cfg.n_params()
    is_prefill = shape.kind == "prefill"
    T = float(B * S) if is_prefill else float(B)
    Td, Bd = T / dsz, max(1.0, B / dsz)

    flops = 2.0 * T * _layer_matmul_params(cfg) * L
    if cfg.uses_moe:
        flops += 2.0 * T * cfg.moe_top_k * cfg.capacity_factor * 3 * D * F * L
    if cfg.family in ("dense", "vlm", "encoder", "moe"):
        kv_len = float(S)
        flops += 4.0 * B * (S * kv_len if is_prefill else kv_len) \
            * cfg.n_heads * cfg.hd * L
    if cfg.family in ("ssm", "hybrid"):
        flops += 8.0 * T * cfg.d_inner * cfg.ssm_state * L
        if cfg.shared_attn_every:
            napps = -(-L // cfg.shared_attn_every)
            sh_p = cfg._attn_params() + 3 * D * F
            flops += 2.0 * T * sh_p * napps
            flops += 4.0 * B * (S * S if is_prefill else S) \
                * cfg.n_heads * cfg.hd * napps
    flops += 2.0 * T * D * V
    flops_dev = flops / nd

    nbytes = P * 2.0 / msz                    # read every weight shard once
    if cfg.family in ("dense", "vlm", "encoder", "moe"):
        kv_bytes = L * Bd * S * 2 * cfg.n_kv_heads * cfg.hd * 2.0 / msz
        nbytes += kv_bytes * (1.0 if is_prefill else 1.0)   # write | read
    else:
        # sequential-scan state traffic: read+write h per step per layer
        steps = float(S) if is_prefill else 1.0
        nbytes += L * steps * Bd * cfg.d_inner * cfg.ssm_state * 4.0 * 2.0 / msz
        if cfg.shared_attn_every:
            napps = -(-L // cfg.shared_attn_every)
            nbytes += napps * Bd * S * 2 * cfg.n_kv_heads * cfg.hd * 2.0 / msz
    if is_prefill:
        act = 10 * Td * D * 2.0 * L
        nbytes += act
    nbytes += Td * V * 2.0 / msz
    nbytes_dev = nbytes

    # "tp_only" placement replicates params across data -> no per-step gather
    coll = P * 2.0 / msz if serve_params == "fsdp" else 0.0
    if msz > 1:
        coll += 2.0 * Td * D * 2.0 * L        # partial-sum ARs
    if cfg.uses_moe:
        coll += 2.0 * T / dsz * cfg.moe_top_k * cfg.capacity_factor * D * 2.0 * L
    coll_dev = coll

    n_act = cfg.n_active_params()
    model_flops = 2.0 * n_act * T
    return {"flops_dev": flops_dev, "hbm_bytes_dev": nbytes_dev,
            "coll_bytes_dev": coll_dev, "model_flops_dev": model_flops / nd,
            "model_flops_global": model_flops}


def cell_costs(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshDims,
               remat: str = "full", microbatches: int = 1,
               opt_bytes_per_param: float = 16.0, ssm_chunk: int = 0,
               attn_skip: bool = False, serve_params: str = "fsdp") -> dict:
    if shape.kind == "train":
        return train_costs(cfg, shape, mesh, remat, microbatches,
                           opt_bytes_per_param, ssm_chunk, attn_skip)
    return serve_costs(cfg, shape, mesh, serve_params)
