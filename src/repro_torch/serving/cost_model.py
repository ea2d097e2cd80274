"""Analytic per-iteration latency model for the serving simulator.

Structure (what the DES charges time for):

- ``prefill(tokens, ranks)``   — compute-bound: base FLOPs at mfu_prefill
                                 + decoupled LoRA compute at eff_adapter
                                 + per-layer adapter launch overhead.
- ``decode(batch, kv_tokens)`` — memory-bound: one full weight sweep +
                                 KV reads at hbm efficiency + LoRA BGMV
                                 per request + fixed iteration overhead.
- ``adapter_load(bytes)``      — host→device link at link_gbps
                                 (FIFO-contended in the simulator).

Calibration targets (paper Fig. 2, Llama-7B on A40, medium request):
rank-128 adapter load ≈ 17.5 % of TTFT and load+compute ≈ 60 %; decode
iteration ≈ tens of ms (TBT SLO 150 ms). The defaults below hit those
ratios; see EXPERIMENTS.md §Calibration for the verification table.

Presets: A40 (paper main), A100-80G (paper §5.5), TPU v5e (the target
platform of this reproduction — used for roofline-consistent serving
projections).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.lora import adapter_bytes


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_tflops: float          # dense bf16
    hbm_gbps: float
    link_gbps: float            # host->device effective (PCIe / DMA)
    hbm_gb: float

    @property
    def peak_flops(self) -> float:
        return self.peak_tflops * 1e12

    @property
    def hbm_bps(self) -> float:
        return self.hbm_gbps * 1e9

    @property
    def link_bps(self) -> float:
        return self.link_gbps * 1e9


A40 = HardwareSpec("a40", peak_tflops=149.7, hbm_gbps=696.0,
                   link_gbps=25.0, hbm_gb=48.0)
A100_80G = HardwareSpec("a100-80g", peak_tflops=311.8, hbm_gbps=2039.0,
                        link_gbps=20.0, hbm_gb=80.0)
TPU_V5E = HardwareSpec("tpu-v5e", peak_tflops=197.0, hbm_gbps=819.0,
                       link_gbps=100.0, hbm_gb=16.0)

HW_PRESETS = {h.name: h for h in (A40, A100_80G, TPU_V5E)}


@dataclass(frozen=True)
class ModelSpec:
    name: str
    n_params: float             # total parameters
    n_layers: int
    d_model: int
    n_kv_heads: int
    head_dim: int
    n_proj_adapted: int = 4
    dtype_bytes: int = 2

    @property
    def param_bytes(self) -> float:
        return self.n_params * self.dtype_bytes

    @property
    def kv_bytes_per_token(self) -> int:
        return (2 * self.n_layers * self.n_kv_heads * self.head_dim
                * self.dtype_bytes)


LLAMA_7B = ModelSpec("llama-7b", n_params=6.74e9, n_layers=32, d_model=4096,
                     n_kv_heads=32, head_dim=128)
LLAMA_13B = ModelSpec("llama-13b", n_params=13.0e9, n_layers=40, d_model=5120,
                      n_kv_heads=40, head_dim=128)
LLAMA_30B = ModelSpec("llama-30b", n_params=32.5e9, n_layers=60, d_model=6656,
                      n_kv_heads=52, head_dim=128)

MODEL_PRESETS = {m.name: m for m in (LLAMA_7B, LLAMA_13B, LLAMA_30B)}


@dataclass(frozen=True)
class CostModel:
    hw: HardwareSpec = A40
    model: ModelSpec = LLAMA_7B
    mfu_prefill: float = 0.75       # base-model prefill efficiency
    eff_adapter: float = 0.035      # decoupled LoRA GEMM efficiency (tiny K)
    adapter_launch_us: float = 40.0 # per layer·proj: launch + index gather
    hbm_eff: float = 0.80           # achieved fraction of HBM bandwidth
    decode_overhead_us: float = 500.0   # scheduler + kernel launches / iter
    prefill_overhead_us: float = 500.0
    bgmv_per_req_us: float = 12.0   # decode-time LoRA matvec per request
    link_latency_us: float = 150.0  # per-transfer setup cost
    per_tensor_us: float = 10.0     # S-LoRA loads adapters tensor-by-tensor:
                                    # n_layers x n_proj x 2 small H2D copies
                                    # dominate load latency (paper Fig. 2)

    # ---------------------------------------------------------------- prefill
    def prefill_time(self, seq_lens: list[int], ranks: list[int]) -> float:
        """One prefill iteration over the given requests (batched)."""
        total_tokens = sum(seq_lens)
        base_flops = 2.0 * self.model.n_params * total_tokens
        t = base_flops / (self.hw.peak_flops * self.mfu_prefill)
        # Rank padding: batched multi-adapter GEMMs (SGMV) execute every
        # request at the *largest* rank in the batch (CaraServe [25], the
        # paper's own §1 motivation) — smaller-rank requests pay the
        # padded cost.
        pad_rank = max(ranks) if ranks else 0
        for s, r in zip(seq_lens, ranks):
            lora_flops = (2.0 * self.model.n_layers
                          * self.model.n_proj_adapted
                          * 2 * (2.0 * self.model.d_model * pad_rank) * s)
            t += lora_flops / (self.hw.peak_flops * self.eff_adapter)
        if ranks:
            t += (self.model.n_layers * self.model.n_proj_adapted
                  * self.adapter_launch_us * 1e-6)
        return t + self.prefill_overhead_us * 1e-6

    # ---------------------------------------------------------------- decode
    def decode_time(self, batch_size: int, kv_tokens: int,
                    ranks: list[int]) -> float:
        """One decode iteration (1 token per running request)."""
        if batch_size == 0:
            return 0.0
        bytes_moved = (self.model.param_bytes
                       + kv_tokens * self.model.kv_bytes_per_token)
        t = bytes_moved / (self.hw.hbm_bps * self.hbm_eff)
        # BGMV is rank-padded across the batch like SGMV (see prefill).
        pad_rank = max(ranks) if ranks else 16
        t += len(ranks) * (self.bgmv_per_req_us * max(1.0, pad_rank / 16.0)
                           ) * 1e-6
        return t + self.decode_overhead_us * 1e-6

    # ------------------------------------------------------------ adapter IO
    def adapter_load_time(self, rank: int) -> float:
        nbytes = adapter_bytes(rank, self.model.d_model, self.model.n_layers,
                               self.model.n_proj_adapted,
                               self.model.dtype_bytes)
        n_tensors = self.model.n_layers * self.model.n_proj_adapted * 2
        return (nbytes / self.hw.link_bps
                + n_tensors * self.per_tensor_us * 1e-6
                + self.link_latency_us * 1e-6)

    def adapter_load_bytes(self, rank: int) -> int:
        return adapter_bytes(rank, self.model.d_model, self.model.n_layers,
                             self.model.n_proj_adapted, self.model.dtype_bytes)

    # ------------------------------------------------------------- isolated
    def isolated_time(self, input_len: int, output_len: int,
                      rank: int, cold_adapter: bool = True) -> float:
        """E2E latency of the request alone on an idle node (slowdown ref).

        Closed form: decode_time(1, kv, [r]) is affine in kv, so the sum
        over kv = input+1 .. input+output-1 is an arithmetic series.
        """
        t = self.adapter_load_time(rank) if cold_adapter else 0.0
        t += self.prefill_time([input_len], [rank])
        n = max(0, output_len - 1)
        if n:
            a = (self.model.param_bytes / (self.hw.hbm_bps * self.hbm_eff)
                 + self.bgmv_per_req_us * 1e-6
                 + self.decode_overhead_us * 1e-6)
            b = self.model.kv_bytes_per_token / (self.hw.hbm_bps
                                                 * self.hbm_eff)
            kv_sum = n * input_len + n * (n + 1) // 2
            t += n * a + b * kv_sum
        return t

    def isolated_ttft(self, input_len: int, rank: int,
                      cold_adapter: bool = True) -> float:
        t = self.adapter_load_time(rank) if cold_adapter else 0.0
        return t + self.prefill_time([input_len], [rank])

    def with_hw(self, hw: HardwareSpec) -> "CostModel":
        return replace(self, hw=hw)

    def with_model(self, model: ModelSpec) -> "CostModel":
        return replace(self, model=model)
