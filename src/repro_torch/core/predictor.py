"""Output-length prediction.

The paper uses an open-source BERT-proxy predictor (µServe [44]) with
~80 % accuracy, and sweeps 100/80/60 % in Fig. 16. Accuracy is defined at
*bucket* granularity: a prediction is correct when it lands in the true
length's power-of-two bucket (the scheduler only needs coarse classes).

Two predictors ship:

- ``NoisyOraclePredictor`` — knows the truth, degrades it to a target
  accuracy. This is the evaluation instrument for Fig. 16-style sweeps.
- ``HistogramPredictor`` — a deployable predictor: per-adapter decayed
  histogram over buckets, predicts the median bucket's representative
  length. Mirrors the observation that output length is task-(adapter-)
  correlated.
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np


def bucket_of(length: int) -> int:
    """Power-of-two bucket index (1..)."""
    return max(0, int(math.ceil(math.log2(max(1, length)))))


def bucket_repr(bucket: int) -> int:
    """Representative length for a bucket: its geometric midpoint."""
    lo = 1 if bucket == 0 else 2 ** (bucket - 1)
    hi = 2 ** bucket
    return max(1, int(round(math.sqrt(lo * hi))))


class NoisyOraclePredictor:
    """Returns the true length with prob=accuracy, else a wrong bucket.

    Errors move the bucket by ±1..3 (geometric), matching how proxy-model
    misclassifications concentrate near the decision boundary.
    """

    def __init__(self, accuracy: float = 0.8, seed: int = 0):
        if not 0.0 <= accuracy <= 1.0:
            raise ValueError("accuracy must be in [0,1]")
        self.accuracy = accuracy
        self.rng = np.random.default_rng(seed)

    def predict(self, input_len: int, adapter_id: int, true_output: int) -> int:
        if self.rng.random() < self.accuracy:
            return max(1, true_output)
        b = bucket_of(true_output)
        # Proxy-model misclassifications concentrate near the boundary;
        # cap the walk at 3 buckets (an uncapped geometric step once
        # produced a 185k-token prediction whose quota charge could
        # never be admitted — found by a starved request in the DES).
        step = min(int(self.rng.geometric(0.6)), 3)
        sign = 1 if self.rng.random() < 0.5 else -1
        wrong = max(0, b + sign * step)
        if wrong == b:
            wrong = b + step
        return bucket_repr(wrong)

    def observe(self, adapter_id: int, true_output: int) -> None:  # no-op
        pass


class HistogramPredictor:
    """Per-adapter decayed bucket histogram; predicts the weighted median.

    ``decay`` is applied on every observation so that the histogram tracks
    non-stationary workloads (the paper's T_refresh-style adaptivity).
    A global histogram backs off cold adapters.
    """

    def __init__(self, decay: float = 0.98, default_output: int = 128):
        self.decay = decay
        self.default_output = default_output
        self._hist: dict[int, defaultdict[int, float]] = {}
        self._global: defaultdict[int, float] = defaultdict(float)

    def observe(self, adapter_id: int, true_output: int) -> None:
        b = bucket_of(true_output)
        h = self._hist.setdefault(adapter_id, defaultdict(float))
        for k in list(h):
            h[k] *= self.decay
        h[b] += 1.0
        for k in list(self._global):
            self._global[k] *= self.decay
        self._global[b] += 1.0

    @staticmethod
    def _median_bucket(h) -> int | None:
        total = sum(h.values())
        if total <= 0:
            return None
        acc = 0.0
        for b in sorted(h):
            acc += h[b]
            if acc >= total / 2:
                return b
        return None

    def predict(self, input_len: int, adapter_id: int,
                true_output: int | None = None) -> int:
        h = self._hist.get(adapter_id)
        b = self._median_bucket(h) if h else None
        if b is None:
            b = self._median_bucket(self._global)
        if b is None:
            return self.default_output
        return bucket_repr(b)


def predict_request(predictor, req, max_predicted: int = 4096) -> int:
    """Fill ``req.predicted_output`` from ``predictor`` — once.

    The single length-prediction hook shared by every consumer of a
    prediction: schedulers call it at queue admission, the gateway calls
    it earlier (lane classification + SLO wait estimates). Idempotent —
    an already-predicted request keeps its value, so whichever layer
    sees the request first decides and every later layer agrees (the
    gateway's lane choice and the scheduler's WRS are computed from the
    same number). Returns the (clamped, >=1) prediction.
    """
    if req.predicted_output <= 0:
        req.predicted_output = max(1, int(predictor.predict(
            req.input_len, req.adapter_id, req.output_len)))
    req.predicted_output = min(req.predicted_output, max_predicted)
    return req.predicted_output


def measure_accuracy(predictor, pairs) -> float:
    """Fraction of (input, adapter, truth) triples predicted in-bucket."""
    ok = 0
    for input_len, adapter_id, truth in pairs:
        p = predictor.predict(input_len, adapter_id, truth)
        ok += bucket_of(p) == bucket_of(truth)
    return ok / max(1, len(pairs))
