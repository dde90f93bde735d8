"""Loss functions, the port of ``kubeflow_tpu.train.losses`` (f32
statistics, optional z-loss for bf16 stability)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    z_loss_weight: float = 0.0,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [..., V] (any float dtype; promoted to f32), labels [...] int.

    Returns (mean loss over unmasked positions, total unmasked count).
    z-loss (PaLM §B.4) adds ``z_loss_weight * logz**2`` per position, which
    keeps bf16 logits from drifting."""
    logits = logits.float()
    V = logits.shape[-1]
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - label_logits
    if label_smoothing > 0.0:
        smooth = -(F.log_softmax(logits, dim=-1).sum(-1) / V)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    if z_loss_weight > 0.0:
        nll = nll + z_loss_weight * logz.square()
    if mask is not None:
        mask = mask.float()
        count = mask.sum().clamp_min(1.0)
        return (nll * mask).sum() / count, count
    count = torch.tensor(float(nll.numel()), device=nll.device)
    return nll.mean(), count


def _block_stats(h, kernel, y, w, z_loss_weight: float):
    """(sum nll, sum weight, sum hits) of one block of tokens: its
    [block, V] logits in f32 are made, reduced and dropped."""
    logits = F.linear(h, kernel.to(h.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - torch.gather(logits, -1, y[:, None])[:, 0]
    if z_loss_weight > 0.0:
        nll = nll + z_loss_weight * logz.square()
    hits = (logits.argmax(-1) == y).float()
    return (nll * w).sum(), w.sum(), (hits * w).sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,
    kernel: torch.Tensor,
    labels: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    z_loss_weight: float = 0.0,
    block: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused lm_head + cross-entropy, blockwise over tokens: each block of
    ``block`` tokens computes its [block, V] logits, folds them into the
    loss/count/hit sums, and the backward RECOMPUTES them
    (``torch.utils.checkpoint``), so the [N, V] logits never materialise.

    hidden: [N, E]; kernel: [V, E] (the port's lm_head weight, or the tied
    embedding); labels/mask: [N]. The tail is padded to a whole block with
    weight 0. Statistics are f32. Returns (mean nll [+ z-loss], count,
    hits): hits counts correct argmax predictions among unmasked tokens."""
    n, e = hidden.shape
    w = torch.ones(n, device=hidden.device) if mask is None \
        else mask.float().reshape(n)
    labels = labels.reshape(n).long()
    pad = (-n) % block
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        w = F.pad(w, (0, pad))
    s_nll = s_cnt = s_hit = torch.zeros((), device=hidden.device)
    for c0 in range(0, n + pad, block):
        sl = slice(c0, c0 + block)
        nll, cnt, hit = checkpoint(
            _block_stats, hidden[sl], kernel, labels[sl], w[sl],
            z_loss_weight, use_reentrant=False, preserve_rng_state=False)
        s_nll, s_cnt, s_hit = s_nll + nll, s_cnt + cnt, s_hit + hit
    count = s_cnt.clamp_min(1.0)
    return s_nll / count, count, s_hit


def softmax_accuracy(
    logits: torch.Tensor, labels: torch.Tensor, *,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    hit = (logits.argmax(-1) == labels).float()
    if mask is not None:
        mask = mask.float()
        return (hit * mask).sum() / mask.sum().clamp_min(1.0)
    return hit.mean()
