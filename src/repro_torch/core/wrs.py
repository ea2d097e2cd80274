"""Weighted Request Size (paper §4.2).

    WRS = A·In/MaxIn + B·Out/MaxOut + C·Adapter/MaxAdapter

with A=0.3, B=0.5, C=0.2 (the paper's sensitivity-tuned constants).
``Out`` is the *predicted* output length. Max values are workload
normalisers tracked online (decayed max so that a single outlier does not
permanently flatten the distribution).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class WRSWeights:
    a_input: float = 0.3
    b_output: float = 0.5
    c_adapter: float = 0.2


class WRSCalculator:
    def __init__(self, weights: WRSWeights | None = None,
                 max_input: int = 1, max_output: int = 1,
                 max_adapter: int = 1, decay: float = 0.999):
        self.w = weights or WRSWeights()
        self.max_input = float(max_input)
        self.max_output = float(max_output)
        self.max_adapter = float(max_adapter)
        self.decay = decay

    def update_normalisers(self, input_len: int, output_len: int,
                           adapter_size: int) -> None:
        self.max_input = max(self.max_input * self.decay, float(input_len), 1.0)
        self.max_output = max(self.max_output * self.decay, float(output_len), 1.0)
        self.max_adapter = max(self.max_adapter * self.decay,
                               float(adapter_size), 1.0)

    def wrs(self, input_len: int, predicted_output: int,
            adapter_size: int) -> float:
        self.update_normalisers(input_len, predicted_output, adapter_size)
        return (self.w.a_input * min(1.0, input_len / self.max_input)
                + self.w.b_output * min(1.0, predicted_output / self.max_output)
                + self.w.c_adapter * min(1.0, adapter_size / self.max_adapter))


class OutputOnlyCalculator(WRSCalculator):
    """Fig. 16 baseline: size = predicted output length only (µServe-like)."""

    def wrs(self, input_len: int, predicted_output: int,
            adapter_size: int) -> float:
        self.update_normalisers(input_len, predicted_output, adapter_size)
        return min(1.0, predicted_output / self.max_output)
