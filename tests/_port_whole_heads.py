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

from _port_cases import (B, N_DECODE, S, cpu_mesh, decode_kw, inputs,
                         pad_slab, place_params, slab_from_prefill)
from _port_serving import ENGINE, StepClock
from repro_torch.configs import get_config
from repro_torch.distributed import act_sharding as acts
from repro_torch.models import api
from repro_torch.models.base import Family

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
REL = 1e-5            # mesh logits vs the unsharded port, f32
#: Eight mesh positions for the port on the CPU (read at call time).
FORCE8 = "--xla_force_host_platform_device_count=8"


def odd_config(family: str, **kw):
    name, heads, _ = ODD[family]
    return dataclasses.replace(get_config(name).reduced(), **heads, **kw)


@functools.lru_cache(maxsize=None)
def odd_params(family: str):
    cfg = odd_config(family)
    return cfg, api.init_params(cfg, 0, torch.float32, device="cpu")


def _prefill_kw(cfg) -> dict:
    return ({"kv_max_len": S + N_DECODE} if cfg.family == Family.HYBRID
            else {})


@functools.lru_cache(maxsize=None)
def unsharded(family: str):
    """The port's unsharded prefill and ``N_DECODE`` greedy decode
    steps: (logits list, greedy tokens list)."""
    cfg, params = odd_params(family)
    toks, kw = inputs(cfg)
    logits, state = api.prefill(
        cfg, params, torch.from_numpy(toks),
        **{a: torch.from_numpy(v) for a, v in kw.items()}, **_prefill_kw(cfg))
    state = pad_slab(cfg, state, lambda t: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, N_DECODE)))
    out, tokens = [logits], []
    for step in range(N_DECODE):
        nxt = torch.argmax(out[-1], -1).to(torch.int32)[:, None]
        tokens.append(nxt)
        clen = torch.full((B,), S + step, dtype=torch.int32)
        lg, state = api.decode_step(cfg, params, nxt, state, clen,
                                    **decode_kw(cfg, step, torch.from_numpy))
        out.append(lg)
    return out, tokens


def mesh_steps(family: str, shape: tuple):
    """The same on a mesh of ``shape``, teacher-forced with the
    unsharded tokens, batch rows over "data" in exact mode (MoE routes
    the whole batch, as the unsharded prefill does): (logits list, the
    prefill's state, MeshParams)."""
    cfg, params = odd_params(family)
    _, tokens = unsharded(family)
    mesh = cpu_mesh(shape)
    mp, plan = place_params(cfg, params, mesh)
    toks, kw = inputs(cfg)
    with acts.activation_sharding(("data",), mesh=mesh,
                                  exact_reductions=True):
        logits, state0 = api.prefill(
            cfg, mp, torch.from_numpy(toks),
            **{a: torch.from_numpy(v) for a, v in kw.items()},
            **_prefill_kw(cfg))
        out = [logits]
        if cfg.family in (Family.DENSE, Family.MOE, Family.VLM):
            state = slab_from_prefill(cfg, plan, state0)
        elif cfg.family == Family.ENCDEC:
            state = (slab_from_prefill(cfg, plan, state0[0]), state0[1])
        else:
            state = state0
        for step, nxt in enumerate(tokens):
            clen = torch.full((B,), S + step, dtype=torch.int32)
            lg, state = api.decode_step(cfg, mp, nxt, state, clen,
                                        **decode_kw(cfg, step,
                                                    torch.from_numpy))
            out.append(lg)
    return out, state0, mp


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


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
