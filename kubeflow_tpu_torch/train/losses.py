"""Loss functions, the port of ``kubeflow_tpu.train.losses`` (f32
statistics, optional z-loss for bf16 stability)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.ops.cross_entropy import cross_entropy_sums

#: The logit of a padded class (finite in bf16 and f32; exp underflows).
_NO_CLASS = -1e30


def cross_entropy_stats(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    z_loss_weight: float = 0.0,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean loss over unmasked positions, unmasked count, unmasked argmax
    hits) of logits [..., V] (any float dtype; statistics in f32) and
    labels [...] int, in one pass over the logits (K8 on the card, see
    ``ops/cross_entropy.py``): ``hits / count`` is
    :func:`softmax_accuracy`."""
    V = logits.shape[-1]
    logits = logits.reshape(-1, V)
    if logits.is_cuda and V % 8 and label_smoothing == 0.0:
        # K8 reads rows in 16-byte chunks (V a multiple of 8): pad the
        # classes with a logit whose exp underflows to 0 and that is never
        # the argmax nor a label. Without smoothing (its mean runs over V)
        # nothing else reads them; the pad's backward drops their gradient.
        logits = F.pad(logits, (0, -V % 8), value=_NO_CLASS)
    s_nll, s_w, s_hit = cross_entropy_sums(
        logits, labels,
        None if mask is None else mask.float(),
        z_loss_weight=z_loss_weight, label_smoothing=label_smoothing)
    count = s_w.clamp_min(1.0)
    return s_nll / count, count, s_hit


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
    loss, count, _ = cross_entropy_stats(
        logits, labels, mask=mask, z_loss_weight=z_loss_weight,
        label_smoothing=label_smoothing)
    return loss, count


def _block_stats(h, kernel, y, w, z_loss_weight: float):
    """(sum nll, sum weight, sum hits) of one block of tokens: its
    [block, V] logits are made, reduced (K8 on the card, statistics in f32)
    and dropped."""
    logits = F.linear(h, kernel.to(h.dtype))
    return cross_entropy_sums(logits, y, w, z_loss_weight=z_loss_weight)


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
