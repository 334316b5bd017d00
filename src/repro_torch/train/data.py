"""Deterministic, resumable synthetic token pipeline (the port's own copy
of ``repro.train.data``, which is numpy-only; nothing here imports JAX).

Sequences are generated from a counter-based PRNG keyed by (seed, step) —
state is a single integer, so a restart restores the exact stream from the
checkpointed step (fault tolerance requires the data pipeline to be
replayable). A light Zipf-ish marginal over the vocabulary plus a repeated
n-gram structure gives the loss something learnable to descend. Batches are
numpy int32 arrays, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq: int
    batch: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenStream:
    """Stateless-per-step stream: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed Zipf-ish marginal
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self._p = (p / p.sum()).astype(np.float64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 32) ^ step)
        toks = rng.choice(cfg.vocab, size=(cfg.batch, cfg.seq + 1),
                          p=self._p).astype(np.int32)
        # inject learnable structure: mirror a window later in the sequence
        w = max(cfg.seq // 8, 1)
        toks[:, -w:] = toks[:, :w]
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
