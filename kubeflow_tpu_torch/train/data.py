"""Data pipelines, the port's copy of ``kubeflow_tpu.train.data``'s
numpy-only synthetic streams: tokens (``synthetic_text``) and labelled
images (``synthetic_images``), the same numpy calls in the same order.

Deterministic synthetic data keeps training, benchmarking and HPO
self-contained and reproducible: the same seed gives the same batches as
the JAX package's stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTextConfig:
    batch_size: int = 8
    seq_len: int = 1024
    vocab_size: int = 32000
    seed: int = 0


def synthetic_text(cfg: SyntheticTextConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-ish synthetic token stream: learnable (not uniform noise) so
    loss curves are meaningful in smoke tests and benchmarks. Each batch is
    {"inputs": int32 [batch_size, seq_len + 1]}."""
    rng = np.random.default_rng(cfg.seed)
    # Low-rank transition structure: next token predictable from current.
    proj = rng.integers(0, cfg.vocab_size, size=cfg.vocab_size, dtype=np.int64)
    while True:
        start = rng.integers(0, cfg.vocab_size, size=(cfg.batch_size, 1))
        toks = [start]
        cur = start
        for _ in range(cfg.seq_len):
            nxt = proj[cur] ^ (cur % 7)
            nxt = (nxt + rng.integers(0, 3, size=cur.shape)) % cfg.vocab_size
            toks.append(nxt)
            cur = nxt
        batch = np.concatenate(toks, axis=1).astype(np.int32)
        yield {"inputs": batch[:, : cfg.seq_len + 1]}


@dataclasses.dataclass(frozen=True)
class SyntheticImageConfig:
    batch_size: int = 32
    image_size: int = 224
    num_classes: int = 1000
    seed: int = 0


def synthetic_images(cfg: SyntheticImageConfig
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Labelled synthetic images with a class-dependent mean (a learnable
    signal). Each batch is {"inputs": float32 [batch_size, image_size,
    image_size, 3] (NHWC, the JAX layout), "labels": int32 [batch_size]}."""
    rng = np.random.default_rng(cfg.seed)
    while True:
        labels = rng.integers(0, cfg.num_classes, size=cfg.batch_size)
        base = (labels[:, None, None, None] % 16) / 16.0 - 0.5
        imgs = base + rng.normal(
            0, 0.5, size=(cfg.batch_size, cfg.image_size, cfg.image_size, 3)
        )
        yield {
            "inputs": imgs.astype(np.float32),
            "labels": labels.astype(np.int32),
        }
