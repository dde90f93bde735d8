"""Analytic model-FLOP accounting for MFU reporting, the port's copy of
``kubeflow_tpu.train.flops``.

Convention: *model* FLOPs, not hardware FLOPs: rematerialised forward
passes are NOT counted (they are overhead, and counting them would inflate
MFU). Train step = 3x forward (backward costs 2x). Causal attention counts
the lower triangle only (S/2 average context per query).
"""

from __future__ import annotations

from typing import Any

#: NVIDIA H100 SXM, dense bf16 tensor-core peak (data sheet), TFLOP/s.
H100_BF16_TFLOPS = 989.0


def llama_matmul_params(cfg: Any) -> int:
    """Parameters participating in matmuls (projections, MLP, lm_head);
    excludes the embedding gather and norm scales (negligible FLOPs)."""
    E, H, Hkv, Dh, M = (
        cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        cfg.mlp_dim,
    )
    per_layer = E * H * Dh + 2 * E * Hkv * Dh + H * Dh * E + 3 * E * M
    head = cfg.vocab_size * cfg.embed_dim  # lm_head matmul (tied or not)
    return cfg.num_layers * per_layer + head


def moe_matmul_params_active(cfg: Any) -> int:
    """Mixtral-style MoE: only the per-token *active* experts count,
    ``experts_per_token`` of them where the config names it, else 2 (the
    top-2 router of ``parallel/moe.py``; no ported config names it)."""
    E, H, Hkv, Dh, M = (
        cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        cfg.mlp_dim,
    )
    attn = E * H * Dh + 2 * E * Hkv * Dh + H * Dh * E
    router = E * cfg.num_experts
    mlp_active = getattr(cfg, "experts_per_token", 2) * 3 * E * M
    per_layer = attn + router + mlp_active
    return cfg.num_layers * per_layer + cfg.vocab_size * cfg.embed_dim


def attention_flops_per_token(cfg: Any, seq_len: int,
                              causal: bool = True) -> int:
    """Forward QK^T + PV flops per token: 4*S*H*Dh per layer full,
    halved causal."""
    full = 4 * seq_len * cfg.num_heads * cfg.head_dim * cfg.num_layers
    return full // 2 if causal else full


def train_flops_per_token(cfg: Any, seq_len: int, *, causal: bool = True,
                          moe: bool = False) -> int:
    """Model FLOPs per trained token (fwd + bwd = 3x fwd)."""
    n = moe_matmul_params_active(cfg) if moe else llama_matmul_params(cfg)
    fwd = 2 * n + attention_flops_per_token(cfg, seq_len, causal=causal)
    return 3 * fwd


def serving_flops_per_token(cfg: Any, context_len: int, *,
                            causal: bool = True,
                            moe: bool = False) -> int:
    """Forward-only model FLOPs per generated/prefilled token at the given
    attention context (no backward, no 3x). Prefill uses ``causal=True``;
    decode attends to the whole resident cache, so pass ``causal=False``
    with ``context_len`` = current cache length."""
    n = moe_matmul_params_active(cfg) if moe else llama_matmul_params(cfg)
    return 2 * n + attention_flops_per_token(cfg, context_len,
                                             causal=causal)


def device_peak_tflops(device=None) -> float:
    """Dense bf16 peak of the local CUDA device in TFLOP/s: the H100's
    published figure when the device name says H100, else 0.0 (MFU is
    then reported as 0)."""
    import torch

    if not torch.cuda.is_available():
        return 0.0
    name = torch.cuda.get_device_name(device)
    return H100_BF16_TFLOPS if "H100" in name else 0.0
