"""Shared set-up of the port's serving examples (``examples/torch_*.py``).

Example-facing: nothing in the library imports it. The examples run as
scripts from ``examples/``, so their shared code lives in the package
they already import.

- ``example_model``: the model follows the device. On the card,
  ``chameleon-llama-7b`` at full width (32 layers, d 4096, 32/32 heads,
  ff 11008, V 32000) with seeded bf16 weights, unless the caller hands
  over its own; elsewhere nothing, so ``build_system`` builds its
  reduced default (the JAX examples' model).
- ``counted_launches``: the kernels' launch counts around a served run
  on the card, and the contract that the run went through them.
- ``summary``: what an example reports of a served run.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

#: The kernels the default ``EngineConfig`` runs: sgmv for the suffix
#: prefill's LoRA, bgmv and paged_attention in decode. Its prefix cache
#: sends every prefill through the suffix path (einsum attention), so
#: flash_attention is not on it.
SERVE_PATH = ("bgmv", "sgmv", "paged_attention")
KERNELS = ("bgmv", "sgmv", "paged_attention", "flash_attention")


def example_model(device: torch.device, model_cfg=None, params=None):
    """(model_cfg, params) for ``build_system``: the caller's, else on
    the card full-width Llama-7B in bf16 from seed 0, else (None, None)
    (``build_system``'s reduced f32 model)."""
    if model_cfg is not None:
        if params is None:
            raise ValueError("model_cfg given without params")
        return model_cfg, params
    if device.type != "cuda":
        return None, None
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config("chameleon-llama-7b")
    return cfg, api.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                device=device)


@contextlib.contextmanager
def counted_launches(device: torch.device):
    """Count the kernel launches of the block's run. On the card every
    kernel's counts and the einsum LoRA's are zeroed on entry; on a
    normal exit the yielded dict gets ``launches`` ({kernel: n}),
    ``plain`` (calls a wrapper served with its plain version) and
    ``einsum`` (einsum LoRA calls), and a ``RuntimeError`` is raised
    unless every kernel of ``SERVE_PATH`` launched, no plain version ran
    and no einsum LoRA ran. On the CPU the wrappers serve their plain
    versions by design: nothing is counted or checked."""
    out: dict = {}
    if device.type != "cuda":
        yield out
        return
    from repro_torch.models.lora_apply import EINSUM
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    for st in stats.values():
        st.reset()
    EINSUM.reset()
    yield out
    out.update(launches={n: st.launches for n, st in stats.items()},
               plain=sum(st.plain for st in stats.values()),
               einsum=EINSUM.calls)
    missing = [n for n in SERVE_PATH if out["launches"][n] == 0]
    if missing or out["plain"] or out["einsum"]:
        raise RuntimeError(
            f"the run did not go through its kernels: never launched "
            f"{missing}, {out['plain']} plain calls, {out['einsum']} "
            f"einsum LoRA calls (launches {out['launches']})")


def summary(m) -> dict:
    """Of a run's ``RunMetrics`` (merged over the replicas of a tier):
    finished requests, TTFT p50/p99 (the system's clock) and the adapter
    cache's hits, misses and evictions."""
    return dict(finished=m.completed(), ttft_p50_s=m.p50_ttft(),
                ttft_p99_s=m.p99_ttft(),
                cache={k: m.cache_stats.get(k)
                       for k in ("hits", "misses", "evictions")})
