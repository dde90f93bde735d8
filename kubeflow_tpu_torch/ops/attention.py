"""Reference multi-head attention (full softmax, O(S^2) memory).

The plain attention the serving decode path runs over the dense KV cache,
and the semantic ground truth for the flash kernel. Logits and softmax
statistics are f32 whatever the input dtype: bf16 inputs are upcast
before the products (a bf16 ``matmul`` would round the logits to bf16,
where the JAX reference keeps them f32 via ``preferred_element_type``).
"""

from __future__ import annotations

from typing import Optional

import torch


def causal_mask(q_len: int, kv_len: int, *, q_offset=0,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """[q_len, kv_len] bool mask, True = attend. ``q_offset`` is the
    absolute position of the first query row (an int or a 0-d tensor)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return q_pos >= kv_pos


def segment_mask(q_seg: torch.Tensor, kv_seg: torch.Tensor) -> torch.Tensor:
    """True where query and key belong to the same packed segment.
    q_seg: [B, Sq], kv_seg: [B, Skv] -> [B, 1, Sq, Skv]."""
    return (q_seg[:, :, None] == kv_seg[:, None, :])[:, None, :, :]


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] with H % Hkv == 0. Returns
    [B, Sq, H, D] in q.dtype.

    GQA folds the query group into the product instead of repeating k/v
    (a repeat would copy the whole cache every decode step). ``mask`` is
    bool, [Sq, Skv] or [B, 1|H, Sq, Skv]; True = attend. Causal aligns q
    to the END of kv (q row i sits at position Skv - Sq + i). Fully masked
    rows come out 0, not NaN. ``k_scale``/``v_scale`` ([B, Skv, Hkv, 1])
    declare k/v as absmax-quantized integers: k's scale applies to the
    logits and v's to the softmax weights, which is exact row for row."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if H % Hkv != 0:
        raise ValueError(f"query heads {H} not a multiple of kv heads {Hkv}")
    G = H // Hkv
    scale = (D ** -0.5) if scale is None else scale

    # [B, Hkv, G*Sq, D] x [B, Hkv, D, Skv] -> [B, Hkv, G, Sq, Skv], f32.
    qg = q.reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4).float()
    kf = k.to(q.dtype).float().permute(0, 2, 3, 1)         # [B, Hkv, D, Skv]
    logits = torch.matmul(qg.reshape(B, Hkv, G * Sq, D), kf)
    logits = logits.reshape(B, Hkv, G, Sq, Skv) * scale
    if k_scale is not None:
        logits = logits * k_scale[..., 0].permute(0, 2, 1).float()[
            :, :, None, None, :]
    if causal:
        cm = causal_mask(Sq, Skv, q_offset=Skv - Sq, device=q.device)
        logits = logits.masked_fill(~cm, float("-inf"))
    if mask is not None:
        if mask.dim() == 4 and mask.shape[1] == 1:
            mg = mask[:, :, None]                            # [B,1,1,Sq,Skv]
        elif mask.dim() == 4:
            mg = mask.reshape(B, Hkv, G, *mask.shape[2:])
        else:
            mg = mask
        logits = logits.masked_fill(~mg, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    weights = torch.nan_to_num(weights, nan=0.0)   # fully masked rows -> 0
    if v_scale is not None:
        weights = weights * v_scale[..., 0].permute(0, 2, 1).float()[
            :, :, None, None, :]
    vf = v.to(q.dtype).float().permute(0, 2, 1, 3)           # [B, Hkv, Skv, D]
    w = weights.to(q.dtype).float().reshape(B, Hkv, G * Sq, Skv)
    out = torch.matmul(w, vf).reshape(B, Hkv, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
