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


def decode_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cache_index: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    stage_key: Optional[torch.Tensor] = None,
    stage_value: Optional[torch.Tensor] = None,
    stage_step: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over a dense KV cache in plain PyTorch: the
    function ``ops/decode_attention.py``'s kernel computes, and the path
    CPU tensors take.

    q [B, Sq, H, D]; k, v [B, L, Hkv, D] (the activation dtype, or int8
    with ``k_scale``/``v_scale`` [B, L, Hkv, 1] f32); ``cache_index`` [B]
    counts the cache rows the LAST query row sees, so query row i sees
    rows ``< cache_index - (Sq - 1 - i)`` (an index past L sees all L).

    Unstaged (no ``stage_key``): the masked ``mha_reference`` over the
    cache that the JAX model's decode step runs, scales included
    (kubeflow_tpu/models/llama.py, ``Attention._decode_attention``).

    Staged: ``stage_key``/``stage_value`` [B, C, Hkv, D] hold this chunk's
    rows, and rows ``0..stage_step`` are live; ``cache_index`` is the
    flushed length. One softmax spans both parts, as in the JAX model's
    ``_staged_decode_attention`` (Sq == 1): f32 logits, k's scale on the
    cache logits, v's scale on the cache weights, the weights rounded to
    q's dtype before their products, the two products summed in f32."""
    B, Sq, H, D = q.shape
    L = k.shape[1]
    if stage_key is None:
        q_last = cache_index.long()[:, None] - Sq + torch.arange(
            1, Sq + 1, device=q.device)[None, :]                # [B, Sq]
        mask = torch.arange(L, device=q.device)[None, None, :] \
            < q_last[:, :, None]                                 # [B, Sq, L]
        return mha_reference(q, k, v, mask=mask[:, None], k_scale=k_scale,
                             v_scale=v_scale)
    if Sq != 1 or stage_step is None:
        raise ValueError("staged decode attention takes one query row and a "
                         "stage_step")
    Hkv = k.shape[2]
    G = H // Hkv
    C = stage_key.shape[1]
    scale = D ** -0.5
    qg = q.reshape(B, Hkv, G, D).float()                    # Sq == 1

    def logits(keys):                                       # -> [B, Hkv, G, S]
        kf = keys.to(q.dtype).float().permute(0, 2, 3, 1)   # [B, Hkv, D, S]
        return torch.matmul(qg, kf) * scale

    s1 = logits(k)
    if k_scale is not None:
        s1 = s1 * k_scale[..., 0].permute(0, 2, 1).float()[:, :, None, :]
    live = torch.arange(L, device=q.device)[None, :] \
        < cache_index.long()[:, None]                        # [B, L]
    s1 = s1.masked_fill(~live[:, None, None, :], float("-inf"))
    s2 = logits(stage_key)
    staged = torch.arange(C, device=q.device) <= stage_step
    s2 = s2.masked_fill(~staged, float("-inf"))
    w = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    w1, w2 = w[..., :L], w[..., L:]
    if v_scale is not None:
        w1 = w1 * v_scale[..., 0].permute(0, 2, 1).float()[:, :, None, :]

    def weighted(wt, values):                               # -> [B, Hkv, G, D]
        vf = values.to(q.dtype).float().permute(0, 2, 1, 3)  # [B, Hkv, S, D]
        return torch.matmul(wt.to(q.dtype).float(), vf)

    out = weighted(w1, v) + weighted(w2, stage_value)
    return out.reshape(B, 1, H, D).to(q.dtype)
