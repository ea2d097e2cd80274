#!/usr/bin/env python3
"""Device-time profile of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_profile.py

Builds and checks the kernels as ``chip_smoke.py`` phases 1 and 2 do,
then two torch.profiler windows, one JSON line each:

1. profile_kernel — each CUDA kernel behind a wrapper (sgmv launches
   a shrink and an expand kernel, the others one): launches and device
   µs per call at the phase-2 shapes, L2 warm; and the same for one
   draw of the seeded sampler's Gumbel noise (8 rows, V 32000), which
   is plain PyTorch.
2. profile — a few steady fused decode steps of ``chameleon-llama-7b``
   at full width under the default ``EngineConfig``, once every row of
   one wave is placed (``chip_smoke.decode_window``): ms per decode
   step on the host clock, then under torch.profiler the device's busy
   share of the wall time and the operations that take the most device
   time and the most host time.

Drives the engine through its public calls only and imports nothing of
JAX. Exits non-zero without a card or when a phase fails.
"""
from __future__ import annotations

import sys

from chip_smoke import (ROOT, PhaseError, decode_window, dev_us, emit,
                        phase_device, phase_kernels, warm_up)


def profile_kernels(calls: dict, iters: int = 20) -> None:
    """Device time per call of each CUDA kernel behind a wrapper."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        emit(dict(phase="profile_kernel", kernel=name,
                  launches_per_call=sum(e.count for e in kernels) / iters,
                  us_per_call=sum(dev_us(e) for e in kernels) / iters,
                  per_call=[dict(cuda_kernel=e.key[:70],
                                 us=dev_us(e) / iters)
                            for e in kernels[:12]]))


def sampler_call():
    """One draw of the seeded sampler's noise for the engine's 8 rows
    over Llama's 32000-token vocabulary (plain PyTorch, no kernel of
    its own): its launches and device time per sampled decode step."""
    import torch
    from repro_torch.models import lm
    seeds = torch.arange(8, device="cuda") + 1000
    pos = torch.arange(8, device="cuda", dtype=torch.int32) + 40
    return lambda: lm.gumbel_noise(seeds, pos, 32000)


def profile_decode(cfg, params) -> None:
    """``chip_smoke.decode_window`` on the default engine: a few steady
    fused decode steps of one wave, on the host clock and then under
    torch.profiler."""
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.systems import build_engine

    eng = build_engine("chameleon", cfg, params, EngineConfig())
    warm_up(eng, cfg.vocab_size)
    emit(dict(phase="profile", loop="fused",
              **decode_window(eng, cfg.vocab_size)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_profile: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = phase_device()
        _, calls = phase_kernels()
        calls["gumbel_noise"] = sampler_call()
        profile_kernels(calls)
        from repro_torch.configs import get_config
        from repro_torch.models import api
        cfg = get_config("chameleon-llama-7b")
        params = api.init_params(cfg, seed=0, dtype=torch.bfloat16)
        profile_decode(cfg, params)
    except PhaseError as exc:
        print(f"chip_profile: FAILED: {exc}", file=sys.stderr)
        return 1
    print(dev["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
