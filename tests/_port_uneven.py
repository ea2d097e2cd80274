"""Shared set-up of the tests of blocks that a mesh axis does not divide
(``tests/test_torch_uneven_splits.py``): one reduced config a row of
``sharding.whole_blocks``' table, each with that dimension alone uneven
on its mesh, and cases where every block is whole; the port's seeded
f32 weights; an unsharded prefill plus greedy decode steps against the
same on a mesh of repeated ``cpu`` positions; the train batch each mesh
splits. Port against port: the JAX package's mesh engine does not run
on this tree (ROADMAP Queue 3)."""
import dataclasses
import functools

import numpy as np
import torch

from _port_cases import (B, N_DECODE, S, cpu_mesh, decode_kw, inputs,
                         pad_slab, place_params, slab_from_prefill)
from repro_torch.configs import get_config
from repro_torch.distributed import act_sharding as acts
from repro_torch.models import api
from repro_torch.models.base import Family

#: case: (reduced config, overrides, mesh, the blocks that run whole
#: serving, training). Reduced widths: d_model 128, d_ff 256, 4 heads
#: of 32 with 2 KV heads (granite 1), d_inner 256, 8 Mamba2 heads of
#: 32, 8 experts with hidden 64 (llama4: shared expert 64). A Mamba1
#: d_inner that M does not divide comes with a d_model it does not
#: divide (d_inner = 2 d_model), and then out_proj is whole with it.
CASES = {
    "heads": ("internlm2-1.8b", dict(n_heads=6, n_kv_heads=2), (1, 4),
              {"attn"}, {"attn"}),
    "kv_heads": ("internlm2-1.8b", dict(n_heads=12, n_kv_heads=3), (1, 2),
                 {"attn"}, {"attn"}),
    "d_model": ("internlm2-1.8b", dict(d_model=130), (1, 4), {"out"},
                set()),
    "d_model_ssm": ("falcon-mamba-7b", dict(d_model=126), (1, 4), {"out"},
                    set()),
    "d_model_encdec": ("whisper-base", dict(d_model=130), (1, 4), {"out"},
                       set()),
    "d_ff": ("internlm2-1.8b", dict(d_ff=250), (1, 4), {"mlp"}, {"mlp"}),
    "d_ff_vlm": ("qwen2-vl-7b", dict(d_ff=250), (1, 4), {"mlp"}, {"mlp"}),
    "shared_expert_ff": ("llama4-maverick-400b-a17b",
                         dict(shared_expert_ff=66), (1, 4), {"shared"},
                         {"shared"}),
    "d_inner": ("falcon-mamba-7b", {}, (1, 3), {"mixer", "out"},
                {"mixer"}),
    "ssm_heads": ("zamba2-1.2b", dict(ssm_head_dim=64, n_heads=8,
                                      n_kv_heads=8), (1, 8), {"mixer"},
                  {"mixer"}),
    "d_ff_expert": ("qwen3-moe-235b-a22b", dict(d_ff_expert=66), (1, 4),
                    set(), {"expert_ff"}),
    "n_experts": ("qwen3-moe-235b-a22b", {}, (3, 1), set(), {"experts"}),
    "all_dense": ("internlm2-1.8b", {}, (2, 3), {"attn", "out", "mlp"},
                  {"attn", "mlp"}),
    "all_moe": ("llama4-maverick-400b-a17b", dict(n_experts=5), (2, 3),
                {"attn", "out", "mlp", "shared"},
                {"attn", "mlp", "shared", "expert_ff", "experts"}),
    "all_hybrid": ("zamba2-1.2b", {}, (2, 3),
                   {"attn", "out", "mlp", "mixer"}, {"attn", "mlp",
                                                      "mixer"}),
}
REL = 1e-5            # mesh logits vs the unsharded port, f32
#: Eight mesh positions for the port on the CPU (read at call time).
FORCE8 = "--xla_force_host_platform_device_count=8"


def case_config(case: str, **kw):
    name, over, *_ = CASES[case]
    return dataclasses.replace(get_config(name).reduced(), **over, **kw)


@functools.lru_cache(maxsize=None)
def case_params(case: str):
    cfg = case_config(case)
    return cfg, api.init_params(cfg, 0, torch.float32, device="cpu")


def train_batch(case: str) -> tuple:
    """(B, S) of the train batch: the rows split over the mesh's batch
    shards."""
    rows = CASES[case][2][0]
    return (4 if 4 % rows == 0 else 2 * rows, 16)


def _prefill_kw(cfg) -> dict:
    return ({"kv_max_len": S + N_DECODE} if cfg.family == Family.HYBRID
            else {})


def serve_unsharded(cfg, params):
    """The port's unsharded prefill and ``N_DECODE`` greedy decode
    steps: (logits list, greedy tokens list)."""
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


def serve_mesh(cfg, params, tokens, shape):
    """The same on a mesh of ``shape``, teacher-forced with ``tokens``,
    batch rows over "data" in exact mode (MoE routes the whole batch,
    as the unsharded prefill does): (logits list, the prefill's state,
    MeshParams)."""
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


def assert_serves_unsharded(cfg, params, shape, want=None):
    """``serve_mesh`` against ``serve_unsharded`` (``want``: its result
    when already computed): logits within ``REL`` relative and every
    argmax the unsharded token. Returns (the prefill's state,
    MeshParams)."""
    want, tokens = want or serve_unsharded(cfg, params)
    got, state, mp = serve_mesh(cfg, params, tokens, shape)
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert rel_err(g, w) <= REL, (shape, step, rel_err(g, w))
        if step < len(tokens):
            assert torch.equal(torch.argmax(g, -1).to(torch.int32),
                               tokens[step][:, 0]), (shape, step)
    return state, mp


@functools.lru_cache(maxsize=None)
def unsharded(case: str):
    return serve_unsharded(*case_params(case))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))
