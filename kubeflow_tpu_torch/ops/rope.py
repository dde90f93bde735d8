"""Rotary position embeddings (split-half convention, Llama-style)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_frequencies(
    head_dim: int, max_len: int, *, theta: float = 10000.0,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute (cos, sin), each [max_len, head_dim // 2], in f32."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=device) / head_dim)
    )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x: [B, S, H, D]. positions: [B, S] absolute positions (defaults to
    arange).

    Positions past the table are CLAMPED to its last row, as a JAX gather
    clamps them: the serving engine's chained decode dispatches feed
    speculative positions past max_len, and an unclamped index on a CUDA
    tensor is a device-side assert that kills the process."""
    B, S, H, D = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    positions = positions.long().clamp(0, cos.shape[0] - 1)
    c = cos[positions][:, :, None, :]          # [B, S, 1, D/2]
    s = sin[positions][:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
