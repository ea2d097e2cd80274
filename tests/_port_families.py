"""Shared set-up of the model-API parity tests
(``tests/test_torch_families.py``, ``tests/test_torch_family_api.py``):
reduced configs in f32 on the JAX package's ``init_params`` bridged to
tensors, their inputs, and the checks each file parametrizes."""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models.base import Family

TOL = dict(rtol=1e-4, atol=1e-4)
B = 2
N_DECODE = 4


def close(port, ref, **kw):
    np.testing.assert_allclose(bridge.to_numpy(port),
                               np.asarray(ref, np.float32), **(kw or TOL))


def close_tree(port, ref):
    if isinstance(port, (tuple, list)):
        assert isinstance(ref, (tuple, list)) and len(port) == len(ref)
        for p, r in zip(port, ref):
            close_tree(p, r)
    else:
        assert tuple(port.shape) == tuple(ref.shape)
        close(port, ref)


_MODELS = {}
#: The JAX decode step, compiled once per config and shape (eager, each
#: call would trace and compile its layer scan again).
jdecode_step = jax.jit(japi.decode_step, static_argnums=0)


def model(name, small_decay=False):
    """(jcfg, cfg, JAX params, port params) of a reduced config, f32;
    ``small_decay``: A_log set to log(0.05) on both sides."""
    key = (name, small_decay)
    if key not in _MODELS:
        jcfg = jget_config(name).reduced()
        params = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
        if small_decay:
            params = dict(params, **{
                "layers/A_log": jnp.log(jnp.full_like(
                    params["layers/A_log"], 0.05))})
        _MODELS[key] = (jcfg, get_config(name).reduced(), params,
                        bridge.params_to_torch(params, "cpu"))
    return _MODELS[key]


def inputs(cfg, S, seed=0):
    """(tokens, JAX kwargs, port kwargs) for a (B, S) batch."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jkw, tkw = {}, {}
    if cfg.family == Family.ENCDEC:
        fr = rng.standard_normal((B, cfg.enc_ctx, cfg.d_model))
        fr = fr.astype(np.float32)
        jkw["frames"], tkw["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    if cfg.mrope:
        pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S))
        jkw["mrope_pos"] = jnp.asarray(pos)
        tkw["mrope_pos"] = torch.from_numpy(pos.copy())
    return toks, jkw, tkw


def pad_kv(kv, n, lib):
    if lib is jnp:
        return tuple(jnp.pad(t, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
                     for t in kv)
    return tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n)) for t in kv)


def serve_state(cfg, state, lib):
    """The prefill state as decode takes it: K/V slabs padded by
    ``N_DECODE`` positions (the hybrid pads at prefill,
    ``kv_max_len``)."""
    if cfg.family in (Family.DENSE, Family.MOE, Family.VLM):
        return pad_kv(state, N_DECODE, lib)
    if cfg.family == Family.ENCDEC:
        kv, cross = state
        return (pad_kv(kv, N_DECODE, lib), cross)
    return state


def check_forward_and_train_loss(arch, S, small):
    """forward logits and train_loss against JAX."""
    jcfg, cfg, jp, tp = model(arch, small)
    toks, jkw, tkw = inputs(cfg, S)
    logits = api.forward(cfg, tp, torch.from_numpy(toks), **tkw)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    close(logits, japi.forward(jcfg, jp, jnp.asarray(toks), **jkw))
    labels = np.roll(toks, -1, axis=1)
    loss = api.train_loss(cfg, tp, torch.from_numpy(toks),
                          torch.from_numpy(labels), **tkw)
    want = japi.train_loss(jcfg, jp, jnp.asarray(toks), jnp.asarray(labels),
                           **jkw)
    assert loss.shape == () and np.isfinite(float(want))
    close(loss, want)


def check_prefill_then_decode(arch, S, small):
    """Prefill (last logits and state), then 4 greedy decode steps (the
    JAX side's argmax fed to both): logits and state after each."""
    jcfg, cfg, jp, tp = model(arch, small)
    toks, jkw, tkw = inputs(cfg, S)
    pkw = dict(kv_max_len=S + N_DECODE) if cfg.family == Family.HYBRID \
        else {}
    jl, jstate = japi.prefill(jcfg, jp, jnp.asarray(toks), **jkw, **pkw)
    tl, tstate = api.prefill(cfg, tp, torch.from_numpy(toks), **tkw, **pkw)
    close(tl, jl)
    close_tree(tstate, jstate)
    jstate, tstate = serve_state(cfg, jstate, jnp), serve_state(cfg, tstate,
                                                                torch)
    dj, dt = {}, {}
    if cfg.family == Family.ENCDEC:
        jkw.pop("frames"), tkw.pop("frames")
    for step in range(N_DECODE):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        clen = np.full((B,), S + step, np.int32)
        if cfg.mrope:
            pos = np.broadcast_to(clen[None, :, None], (3, B, 1)).copy()
            dj["mrope_pos"], dt["mrope_pos"] = (jnp.asarray(pos),
                                                torch.from_numpy(pos))
        jl, jstate = jdecode_step(jcfg, jp, jnp.asarray(nxt), jstate,
                                      jnp.asarray(clen), **dj)
        tl, tstate = api.decode_step(cfg, tp, torch.from_numpy(nxt), tstate,
                                     torch.from_numpy(clen), **dt)
        assert torch.isfinite(tl).all()
        close(tl, jl)
        close_tree(tstate, jstate)


def check_init_serve_state(arch):
    """Shapes, dtypes and zeros of JAX's state; no shared storage."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    want = japi.init_serve_state(jcfg, 3, 24)
    got = api.init_serve_state(cfg, 3, 24, device="cpu")
    leaves_j = jax.tree_util.tree_leaves(want)
    leaves_t = jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(leaves_t) == len(leaves_j)
    for t, j in zip(leaves_t, leaves_j):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert not t.any()
    # Decode writes slabs in place: no two leaves share storage.
    ptrs = [t.data_ptr() for t in leaves_t]
    assert len(set(ptrs)) == len(ptrs)
