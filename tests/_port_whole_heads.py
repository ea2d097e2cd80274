"""Shared set-up of the tests of heads that the "model" axis does not
divide (``tests/test_torch_whole_heads.py``, the engine case of
``tests/test_torch_mesh_engine.py``, the case of
``tests/test_torch_cases.py``): reduced configs with such heads, the
port's seeded f32 weights, an unsharded prefill plus greedy decode
steps against the same on a mesh of repeated ``cpu`` positions, and
an engine's greedy tokens on a step clock. Port against port: the JAX
package's mesh engine does not run on this tree (ROADMAP Queue 3)."""
import dataclasses
import functools

import numpy as np
import torch

from _port_serving import ENGINE, StepClock
from _port_uneven import REL, rel_err, serve_mesh, serve_unsharded  # noqa
from repro_torch.configs import get_config
from repro_torch.models import api

#: family: (reduced config, its heads and KV heads, meshes). 6 heads on
#: 4 columns: q (128, 192) splits into blocks of 1.5 heads; whisper's 4
#: heads on 8 columns: half a head a block.
ODD = {
    "dense": ("internlm2-1.8b", dict(n_heads=6, n_kv_heads=2),
              [(1, 4), (2, 4)]),
    "moe": ("qwen3-moe-235b-a22b", dict(n_heads=6, n_kv_heads=2),
            [(1, 4), (2, 4)]),
    "vlm": ("qwen2-vl-7b", dict(n_heads=6, n_kv_heads=2),
            [(1, 4), (2, 4)]),
    "hybrid": ("zamba2-1.2b", dict(n_heads=6, n_kv_heads=2),
               [(1, 4), (2, 4)]),
    "encdec": ("whisper-base", dict(n_heads=4, n_kv_heads=4),
               [(1, 8)]),
}
#: Eight mesh positions for the port on the CPU (read at call time).
FORCE8 = "--xla_force_host_platform_device_count=8"


def odd_config(family: str, **kw):
    name, heads, _ = ODD[family]
    return dataclasses.replace(get_config(name).reduced(), **heads, **kw)


@functools.lru_cache(maxsize=None)
def odd_params(family: str):
    cfg = odd_config(family)
    return cfg, api.init_params(cfg, 0, torch.float32, device="cpu")


@functools.lru_cache(maxsize=None)
def unsharded(family: str):
    """The port's unsharded prefill and ``N_DECODE`` greedy decode
    steps: (logits list, greedy tokens list)."""
    return serve_unsharded(*odd_params(family))


def mesh_steps(family: str, shape: tuple):
    """The same on a mesh of ``shape``, teacher-forced with the
    unsharded tokens (``_port_uneven.serve_mesh``): (logits list, the
    prefill's state, MeshParams)."""
    return serve_mesh(*odd_params(family), unsharded(family)[1], shape)


def trace(n=8, seed=0):
    """A mixed greedy/sampled trace: (input_len, output_len, adapter,
    sampling seed or None)."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(8, 40)), int(rng.integers(4, 12)),
             int(rng.integers(0, 8)), i if i % 3 == 2 else None)
            for i in range(n)]


def engine_tokens(cfg, params, mesh_shape, **knobs) -> list:
    """The port engine's tokens on ``trace()`` at ``mesh_shape`` (None:
    unsharded), drained on a step clock."""
    from repro_torch.core import Request, SamplingParams
    from repro_torch.serving.engine import (AdapterCatalog, ChameleonEngine,
                                            EngineConfig)
    clock = StepClock()
    cat = AdapterCatalog(cfg, ENGINE["n_adapters"], 32, seed=0,
                         device="cpu")
    eng = ChameleonEngine(cfg, params, EngineConfig(
        **{**ENGINE, **knobs, "mesh_shape": mesh_shape}), catalog=cat,
        clock=clock, device="cpu")
    hs = []
    for L, out, a, seed in trace():
        sp = (SamplingParams(temperature=0.8, top_k=8, seed=seed)
              if seed is not None else None)
        hs.append(eng.submit(Request(input_len=L, output_len=out,
                                     adapter_id=a), sampling=sp))
    for _ in range(20_000):
        if not eng.busy():
            break
        eng.step()
        clock.t += 0.01
    assert not eng.busy(), "engine failed to drain"
    return [h.tokens for h in hs]
