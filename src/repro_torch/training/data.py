"""Deterministic synthetic data pipeline (training substrate).

Language-model batches synthesised from a seeded Markov-ish token
process — deterministic in (seed, step), so restarts reproduce the
exact byte stream without any data-state checkpointing beyond the step
counter (the property elastic restart relies on). Per-host sharding:
each data-parallel host materialises only its slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Zipf-distributed tokens with local correlations — enough signal
    that the training loss demonstrably falls (quickstart example)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / (1.0 / ranks).sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Returns {"tokens": (local_B, S), "labels": (local_B, S)}."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.host_id)
        B, S = self.local_batch, cfg.seq_len
        base = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self._probs)
        # Local correlation: with p=0.5 repeat the previous token + 1.
        rep = rng.random((B, S + 1)) < 0.5
        for t in range(1, S + 1):
            base[:, t] = np.where(rep[:, t],
                                  (base[:, t - 1] + 1) % cfg.vocab_size,
                                  base[:, t])
        return {"tokens": base[:, :-1].astype(np.int32),
                "labels": base[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
