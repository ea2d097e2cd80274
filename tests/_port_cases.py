"""Shared set-up of the serving-mesh family tests
(``tests/test_torch_serve_mesh_families.py``) and the ``build_case``
tests (``tests/test_torch_cases.py``): meshes of repeated ``cpu``
positions, the JAX fake meshes, pytree walks over a case's arguments
and shardings, materialising a case's arguments from a seed, and the
unsharded and JAX references of a prefill plus greedy decode steps."""
import functools

import numpy as np
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from _port_families import jdecode_step, model
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import cases
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api
from repro_torch.models.base import Family
from repro_torch.serving.shard_plan import ShardPlan
from repro_torch.training import AdamWConfig

#: One reduced config a family.
FAMILIES = {"dense": "internlm2-1.8b", "moe": "qwen3-moe-235b-a22b",
            "vlm": "qwen2-vl-7b", "ssm": "falcon-mamba-7b",
            "hybrid": "zamba2-1.2b", "encdec": "whisper-base"}
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)]
B, S, N_DECODE = 4, 8, 4
REL = 1e-5          # mesh vs the unsharded port, off (1, 1)
JAX_TOL = 1e-4      # mesh vs the JAX api


def cpu_mesh(shape, axes=("data", "model")) -> Mesh:
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [torch.device("cpu")] * grid.size
    return Mesh(grid.reshape(shape), axes)


def fake_meshes(multi_pod: bool):
    """The reference's production mesh and the port's, over repeated
    host positions (spec logic only: nothing is placed on them)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    jdev = np.asarray(jax.devices()[:1] * n).reshape(shape)
    return JMesh(jdev, axes), cpu_mesh(shape, axes)


def walk(tree, path=()):
    """(path, leaf) of a nested dict/tuple, in order; an empty tuple is
    a leaf (the reference's "no LoRA")."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (k,))
    elif isinstance(tree, (tuple, list)) and len(tree):
        for i, v in enumerate(tree):
            yield from walk(v, path + (i,))
    else:
        yield path, tree


def dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


# --------------------------------------------------- running a case
def materialize(cfg, kind: str, args: tuple, seed: int = 0) -> tuple:
    """A case's arguments from a seed, every float in f32 (the gates hold
    mesh runs to unsharded ones at f32's resolution): params from
    ``init_params``, zero moments in the case's dtype, tokens in the
    vocabulary, adapter slots below ``LORA_SLOTS``, cache lengths inside
    the slab, M-RoPE positions of text, normal frames, LoRA and state."""
    rng = np.random.default_rng(seed)
    params = api.init_params(cfg, seed, torch.float32, device="cpu")

    def fill(path, t):
        name = path[-1] if path else ""
        if t.dtype == torch.int32:
            if name == "mrope_pos":
                n = t.shape[-1]
                base = (np.arange(n) if kind != "decode"
                        else np.full(n, S // 2))
                return torch.from_numpy(np.broadcast_to(
                    base, t.shape).astype(np.int32).copy())
            hi = {"adapter": cases.LORA_SLOTS}.get(name, cfg.vocab_size)
            return torch.from_numpy(
                rng.integers(0, hi, t.shape).astype(np.int32))
        x = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        if len(t.shape) == 4 and t.shape[1] == cases.LORA_SLOTS:
            x *= 0.1 * (t.shape[2] ** -0.5)
        return torch.from_numpy(x)

    def tree(x, path=()):
        if isinstance(x, dict):
            return {k: tree(v, path + (k,)) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(tree(v, path + (i,)) for i, v in enumerate(x))
        return fill(path, x)

    if kind == "train":
        opt = {k: torch.zeros(tuple(v.shape), dtype=v.dtype)
               for k, v in args[1].items()}
        return params, opt, tree(args[2])
    out = [params]
    for i, a in enumerate(args[1:], 1):
        name = {1: "tokens"}.get(i, "")
        if kind == "prefill" and i == 3 or kind == "decode" and i == 5:
            name = "adapter"
        if isinstance(a, torch.Tensor):
            t = fill((name,), a)
            if kind == "decode" and i == 3:          # cache lengths
                t = torch.from_numpy((S // 2 + np.arange(a.shape[0]) % 3)
                                     .astype(np.int32))
            out.append(t)
        else:
            out.append(tree(a))
    return tuple(out)


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(clone(v) for v in tree)
    return tree.clone()


def scope(mesh, kind: str):
    """The dry-run's activation scope: batch rows over every axis but
    "model", exact reductions and token-parallel MoE when serving."""
    axes = tuple(a for a in mesh.axis_names if a != "model")
    return acts.activation_sharding(axes, mesh=mesh,
                                    exact_reductions=kind != "train",
                                    moe_token_parallel=kind != "train")


OPT = AdamWConfig(moment_dtype="bfloat16")


# ------------------------------------- serving references (f32, reduced)
def inputs(cfg, seed: int = 0):
    """(tokens (B, S) int32, kwargs) as numpy: frames (enc-dec), M-RoPE
    positions of text (VLM)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    kw = {}
    if cfg.family == Family.ENCDEC:
        kw["frames"] = rng.standard_normal(
            (B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        kw["mrope_pos"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
    return toks, kw


def decode_kw(cfg, step: int, lib) -> dict:
    if not cfg.mrope:
        return {}
    pos = np.full((3, B, 1), S + step, np.int32)
    return {"mrope_pos": lib(pos)}


def pad_slab(cfg, state, lib_pad):
    """The prefill's state as decode takes it: K/V slabs padded by
    ``N_DECODE`` positions (the hybrid pads at prefill)."""
    if cfg.family in (Family.DENSE, Family.MOE, Family.VLM):
        return tuple(lib_pad(t) for t in state)
    if cfg.family == Family.ENCDEC:
        return (tuple(lib_pad(t) for t in state[0]), state[1])
    return state


def blocks(n_shards: int):
    return [slice(i * B // n_shards, (i + 1) * B // n_shards)
            for i in range(n_shards)]


def _prefill_blocks(prefill, toks, kw, n_shards, cat_state):
    """An MoE prefill under token parallelism: each data shard's rows
    route alone (their own capacity groups), so the unsharded reference
    is the prefill of each shard's rows, concatenated."""
    outs = []
    for rows in blocks(n_shards):
        k = {n: (v[:, rows] if n == "mrope_pos" else v[rows])
             for n, v in kw.items()}
        outs.append(prefill(toks[rows], k))
    return cat_state(outs)


@functools.lru_cache(maxsize=None)
def reference(name: str, n_shards: int = 1):
    """The port's unsharded prefill and ``N_DECODE`` greedy decode
    steps, and JAX's on the same numpy weights fed the port's tokens:
    {"logits": [...], "tokens": [...], "jax": [...]}. ``n_shards``: the
    MoE prefill's data shards (token parallelism)."""
    jcfg, cfg, jp, tp = model(name)
    toks, kw = inputs(cfg)
    pkw = {"kv_max_len": S + N_DECODE} if cfg.family == Family.HYBRID \
        else {}
    n = n_shards if cfg.family == Family.MOE else 1

    def tpre(t, k):
        return api.prefill(cfg, tp, torch.from_numpy(t),
                           **{a: torch.from_numpy(v) for a, v in k.items()},
                           **pkw)

    def jpre(t, k):
        return jax.device_get(japi_prefill(jcfg, jp, t, k, pkw))

    def tcat(outs):
        return (torch.cat([o[0] for o in outs]),
                tuple(torch.cat([o[1][j] for o in outs], dim=1)
                      for j in range(2)))

    def jcat(outs):
        return (np.concatenate([o[0] for o in outs]),
                tuple(np.concatenate([o[1][j] for o in outs], axis=1)
                      for j in range(2)))

    tl, tstate = _prefill_blocks(tpre, toks, kw, n, tcat) if n > 1 \
        else tpre(toks, kw)
    jl, jstate = _prefill_blocks(jpre, toks, kw, n, jcat) if n > 1 \
        else jpre(toks, kw)
    tstate = pad_slab(cfg, tstate, lambda t: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, N_DECODE)))
    jstate = pad_slab(cfg, jstate, lambda t: jnp.pad(
        jnp.asarray(t), ((0, 0), (0, 0), (0, N_DECODE), (0, 0), (0, 0))))
    out = {"logits": [tl], "tokens": [], "jax": [np.asarray(jl)]}
    for step in range(N_DECODE):
        nxt = torch.argmax(out["logits"][-1], -1).to(torch.int32)[:, None]
        out["tokens"].append(nxt)
        clen = np.full((B,), S + step, np.int32)
        tl, tstate = api.decode_step(cfg, tp, nxt, tstate,
                                     torch.from_numpy(clen),
                                     **decode_kw(cfg, step,
                                                 torch.from_numpy))
        jl, jstate = jdecode_step(jcfg, jp, jnp.asarray(nxt.numpy()),
                                  jstate, jnp.asarray(clen),
                                  **decode_kw(cfg, step, jnp.asarray))
        out["logits"].append(tl)
        out["jax"].append(np.asarray(jl))
    return out


def japi_prefill(jcfg, jp, toks, kw, pkw):
    from repro.models import api as japi
    return japi.prefill(jcfg, jp, jnp.asarray(toks),
                        **{a: jnp.asarray(v) for a, v in kw.items()}, **pkw)


def place_params(cfg, params, mesh):
    plan = ShardPlan(mesh, cfg)
    sh = plan.params(params)
    return tsh.MeshParams(cfg, {k: sh[k].shard(v)
                                for k, v in params.items()}, mesh), plan


def slab_from_prefill(cfg, plan, kv):
    """Placed (L, B, S + N_DECODE, Kh, Dh) slabs holding the prefill's
    placed K/V in their first S positions."""
    out = []
    for t in kv:
        full = torch.nn.functional.pad(t.full(), (0, 0, 0, 0, 0, N_DECODE))
        out.append(plan.zeros_kv_dense(tuple(full.shape), full.dtype)
                   .copy_(full))
    return tuple(out)


def run_mesh(name: str, shape: tuple, tokens: list, batch_rows=True):
    """Prefill and ``N_DECODE`` decode steps on a mesh of ``shape`` over
    repeated ``cpu`` positions, under the dry-run's scope (batch rows,
    token-parallel MoE; ``batch_rows=False``: the engine's full-batch
    scope), teacher-forced with ``tokens``: (logits list, prefill state,
    MeshParams)."""
    _, cfg, _, tp = model(name)
    mesh = cpu_mesh(shape)
    mp, plan = place_params(cfg, tp, mesh)
    toks, kw = inputs(cfg)
    pkw = {"kv_max_len": S + N_DECODE} if cfg.family == Family.HYBRID \
        else {}
    ctx = scope(mesh, "decode") if batch_rows else \
        acts.activation_sharding((), mesh=mesh, exact_reductions=True)
    with ctx:
        logits, state0 = api.prefill(
            cfg, mp, torch.from_numpy(toks),
            **{a: torch.from_numpy(v) for a, v in kw.items()}, **pkw)
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
