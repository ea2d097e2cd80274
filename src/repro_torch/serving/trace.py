"""Workload/trace synthesis (paper §5.1).

The paper replays the open-source Azure LLM inference trace [39]
("conversation" service) for input/output lengths, Poisson inter-arrival
times at a target RPS, and attaches adapters by a power-law over ranks
{8,16,32,64,128} with uniform choice within a rank.

The Azure conversation trace's published length statistics are
heavy-tailed; we synthesise lengths from the distributions reported in
Splitwise [39] (conversation: median input ≈ 1020, p90 ≈ 2.2k; median
output ≈ 129, long tail to 1k+), using log-normal bodies with Pareto
tails. Seeds make every experiment reproducible. A loader for the real
CSV (same schema) is included for environments where the trace file is
available: ``load_azure_csv``.
"""
from __future__ import annotations

import csv
import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.lora import AdapterInfo, assign_adapters
from repro_torch.core.request import Request


@dataclass
class TraceConfig:
    rps: float = 8.0
    duration_s: float = 120.0
    n_adapters: int = 100
    seed: int = 0
    adapter_alpha: float = 1.0         # power-law exponent over ranks
    # Azure-conversation-calibrated length model [39]:
    input_lognorm_mu: float = 5.1      # exp(5.1) ≈ 164 median body
    input_lognorm_sigma: float = 0.65
    input_max: int = 4096
    output_lognorm_mu: float = 4.2     # exp(4.2) ≈ 67 median body
    output_lognorm_sigma: float = 0.7
    output_pareto_frac: float = 0.05   # fraction of requests in the tail
    output_pareto_alpha: float = 1.6
    output_max: int = 1024
    burstiness: float = 0.0            # 0 = Poisson; >0 adds load spikes
    spike_period_s: float = 60.0
    spike_width_s: float = 8.0


@dataclass
class Trace:
    requests: list[Request]
    config: TraceConfig

    @property
    def n(self) -> int:
        return len(self.requests)

    def rps_realised(self) -> float:
        if not self.requests:
            return 0.0
        span = self.requests[-1].arrival_time - self.requests[0].arrival_time
        return (self.n - 1) / span if span > 0 else 0.0


def _sample_lengths(cfg: TraceConfig, n: int, rng: np.random.Generator,
                    ) -> tuple[np.ndarray, np.ndarray]:
    inp = rng.lognormal(cfg.input_lognorm_mu, cfg.input_lognorm_sigma, n)
    inp = np.clip(inp, 8, cfg.input_max).astype(np.int64)
    out = rng.lognormal(cfg.output_lognorm_mu, cfg.output_lognorm_sigma, n)
    # Heavy tail: a Pareto component captures the paper's Fig. 6 shape
    # (most requests short, a few very long).
    tail = rng.random(n) < cfg.output_pareto_frac
    pareto = (rng.pareto(cfg.output_pareto_alpha, n) + 1.0) * 128.0
    out = np.where(tail, np.maximum(out, pareto), out)
    out = np.clip(out, 1, cfg.output_max).astype(np.int64)
    return inp, out


def _arrival_times(cfg: TraceConfig, rng: np.random.Generator) -> np.ndarray:
    """Poisson arrivals; optional deterministic load spikes (Fig. 5/16)."""
    times = []
    t = 0.0
    while t < cfg.duration_s:
        rate = cfg.rps
        if cfg.burstiness > 0.0:
            phase = t % cfg.spike_period_s
            if phase < cfg.spike_width_s:
                rate = cfg.rps * (1.0 + cfg.burstiness)
        t += rng.exponential(1.0 / max(rate, 1e-9))
        if t < cfg.duration_s:
            times.append(t)
    return np.array(times)


def synthesize(cfg: TraceConfig, pool: list[AdapterInfo]) -> Trace:
    rng = np.random.default_rng(cfg.seed)
    times = _arrival_times(cfg, rng)
    n = len(times)
    inp, out = _sample_lengths(cfg, n, rng)
    adapters = assign_adapters(n, pool, rng, alpha=cfg.adapter_alpha)
    reqs = [Request(input_len=int(inp[i]), output_len=int(out[i]),
                    adapter_id=int(adapters[i]), arrival_time=float(times[i]))
            for i in range(n)]
    return Trace(requests=reqs, config=cfg)


def synthesize_shared_prefix(cfg: TraceConfig, pool: list[AdapterInfo],
                             n_prefixes: int = 4, prefix_len: int = 48,
                             suffix_min: int = 4, suffix_max: int = 16,
                             vocab_size: int = 32000) -> Trace:
    """Shared-prefix-heavy workload (prefix-cache A/B substrate).

    Production multi-tenant traffic concentrates on a handful of system
    prompts / few-shot preambles; this variant makes that structure
    explicit: every request's prompt is one of ``n_prefixes`` fixed
    preambles of ``prefix_len`` tokens (popularity power-law, like the
    paper's adapter skew) followed by a unique random suffix. Real
    token ids are attached (``Request.prompt``) so the engine's radix
    tree has material to match — the plain ``synthesize`` carries
    lengths only. Arrivals and adapter assignment follow ``cfg``
    exactly as in ``synthesize``.
    """
    rng = np.random.default_rng(cfg.seed)
    times = _arrival_times(cfg, rng)
    n = len(times)
    adapters = assign_adapters(n, pool, rng, alpha=cfg.adapter_alpha)
    _, out = _sample_lengths(cfg, n, rng)
    prefixes = [rng.integers(0, vocab_size, size=prefix_len).tolist()
                for _ in range(n_prefixes)]
    pop = 1.0 / np.arange(1, n_prefixes + 1)
    pop /= pop.sum()
    reqs = []
    for i in range(n):
        pre = prefixes[int(rng.choice(n_prefixes, p=pop))]
        suffix = rng.integers(
            0, vocab_size,
            size=int(rng.integers(suffix_min, suffix_max + 1))).tolist()
        prompt = pre + suffix
        reqs.append(Request(input_len=len(prompt), output_len=int(out[i]),
                            adapter_id=int(adapters[i]),
                            arrival_time=float(times[i]), prompt=prompt))
    return Trace(requests=reqs, config=cfg)


def synthesize_multitenant(cfg: TraceConfig, pool: list[AdapterInfo],
                           tenants: tuple = ("acme", "globex", "initech",
                                             "umbrella"),
                           heavy_hitter: str = "floodcorp",
                           heavy_rps_factor: float = 8.0,
                           heavy_output_factor: float = 4.0) -> Trace:
    """Multi-tenant workload with one adversarial heavy hitter
    (gateway A/B substrate).

    Each well-behaved tenant independently submits a ``cfg``-shaped
    stream at ``cfg.rps`` (same Azure-calibrated length model as
    ``synthesize``); ``heavy_hitter`` floods ``heavy_rps_factor``× that
    rate with ``heavy_output_factor``× longer decodes — the tenant a
    per-engine scheduler cannot tell apart from everyone else but a
    gateway must bound. Tenant streams use derived seeds and merge by
    arrival time, so the offered load is identical across A/B arms.
    ``Request.tenant`` carries the attribution.
    """
    streams = []
    for i, name in enumerate(tenants):
        sub = dataclasses.replace(cfg, seed=cfg.seed + 1 + i)
        t = synthesize(sub, pool)
        for r in t.requests:
            r.tenant = name
        streams.extend(t.requests)
    hcfg = dataclasses.replace(
        cfg, seed=cfg.seed + 101,
        rps=cfg.rps * heavy_rps_factor,
        output_lognorm_mu=cfg.output_lognorm_mu
        + math.log(heavy_output_factor))
    ht = synthesize(hcfg, pool)
    for r in ht.requests:
        r.tenant = heavy_hitter
    streams.extend(ht.requests)
    streams.sort(key=lambda r: r.arrival_time)
    return Trace(requests=streams, config=cfg)


def downscale_for_engine(trace: Trace, n_adapters: int,
                         max_input: int, max_output: int,
                         time_scale: float = 1.0) -> Trace:
    """Map a production-scale trace onto the reduced real-engine setting.

    The JAX engine in this container runs a reduced model with short
    context; this shrinks lengths *proportionally* (preserving the
    heavy-tailed shape that drives the paper's scheduling results),
    folds adapter ids into the engine's catalog (preserving the
    power-law popularity skew), and compresses arrival times by
    ``time_scale`` so minutes of trace replay in seconds of wall time.
    Fresh Request objects are returned — replaying the same trace twice
    (e.g. per routing policy) must not share mutable request state.
    """
    src = trace.requests
    if not src:
        return Trace(requests=[], config=trace.config)
    in_hi = max(r.input_len for r in src)
    out_hi = max(r.output_len for r in src)
    reqs = []
    for r in src:
        inp = max(4, int(round(r.input_len * max_input / max(in_hi, 1))))
        out = max(1, int(round(r.output_len * max_output / max(out_hi, 1))))
        reqs.append(Request(
            input_len=min(inp, max_input),
            output_len=min(out, max_output),
            adapter_id=r.adapter_id % n_adapters,
            arrival_time=r.arrival_time * time_scale))
    return Trace(requests=reqs, config=trace.config)


def load_azure_csv(path: str, cfg: TraceConfig,
                   pool: list[AdapterInfo]) -> Trace:
    """Load a real trace CSV (columns: arrival_s,input_tokens,output_tokens).

    Adapters are attached with the same power-law model as ``synthesize``
    (the Azure trace has no adapter column — the paper does the same).
    """
    rng = np.random.default_rng(cfg.seed)
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append((float(row["arrival_s"]),
                         int(row["input_tokens"]),
                         int(row["output_tokens"])))
    rows.sort()
    adapters = assign_adapters(len(rows), pool, rng, alpha=cfg.adapter_alpha)
    reqs = [Request(input_len=i, output_len=o, adapter_id=int(adapters[k]),
                    arrival_time=t) for k, (t, i, o) in enumerate(rows)]
    return Trace(requests=reqs, config=cfg)
