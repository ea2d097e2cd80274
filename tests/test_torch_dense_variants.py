"""The port's dense-family branches beyond Llama, on the CPU, vs JAX.

Four dense configs at ``.reduced()``, f32, each one case of a single
parametrised test: ``qwen2.5-32b`` (QKV bias), ``qwen3-14b`` (qk-norm),
``granite-34b`` (MQA with one kv head, non-gated GELU MLP) and
``internlm2-1.8b`` (the default speculative draft). The weights are the
JAX package's ``init_params``; its biases are zero and its norms one,
which would hide a fault in either branch, so every bias and norm
weight is redrawn from a numpy seed on both sides. Per config:
``prefill``, ``decode_step`` over the dense slab it fills,
``prefill_paged`` and ``decode_step_paged`` logits within ``TOL`` of
the JAX functions (LoRA on q/k/v/o), then one default-engine drain
whose greedy tokens equal the JAX engine's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _port_serving import ENGINE, StepClock, land_jax_loads  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.lora_apply import (  # noqa: E402
    init_lora_slots as jinit_slots, random_lora_weights as jrandom_lora,
    write_adapter_to_slot as jwrite_slot)
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Request  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = ("qwen2.5-32b", "qwen3-14b", "granite-34b", "internlm2-1.8b")
PAGE = 16
#: (input_len, output_len, adapter) of the engine drain.
TRACE = [(12, 6, 0), (21, 5, 1), (7, 7, 2)]


def perturbed_params(jcfg, seed):
    """JAX ``init_params`` with every bias and norm weight redrawn."""
    params = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(seed)
    out = {}
    for path, w in params.items():
        leaf = path.split("/")[-1]
        if leaf.endswith("_bias"):
            w = jnp.asarray(0.1 * rng.standard_normal(w.shape), jnp.float32)
        elif "norm" in leaf:
            w = jnp.asarray(1 + 0.2 * rng.standard_normal(w.shape),
                            jnp.float32)
        out[path] = w
    return out


def lora_slots(jcfg):
    slots = jinit_slots(jax.random.PRNGKey(1), 3, jcfg.n_layers,
                        jcfg.d_model, jcfg.q_dim, jcfg.kv_dim, 32,
                        dtype=jnp.float32)
    for i, rank in enumerate((8, 16, 32)):
        slots = jwrite_slot(slots, jrandom_lora(
            jax.random.PRNGKey(100 + i), rank, 32, jcfg.n_layers,
            jcfg.d_model, jcfg.q_dim, jcfg.kv_dim, dtype=jnp.float32), i)
    return slots


def step_logits(jcfg, cfg, jparams, params, jslots, slots):
    """[(what, port logits, JAX logits)] of the four step functions."""
    rng = np.random.default_rng(3)
    B, S, P = 3, 16, 2
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    seq_len = np.array([16, 9, 5], np.int32)
    tok1 = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    idx = np.array([2, 0, 1], np.int32)
    table = (1 + np.arange(B * P)).reshape(B, P).astype(np.int32)
    zero = np.zeros(B, np.int32)
    kw_j = dict(lora=jslots, adapter_idx=jnp.asarray(idx))
    kw_t = dict(lora=slots, adapter_idx=torch.from_numpy(idx))
    J = {k: jnp.asarray(v) for k, v in dict(
        toks=toks, seq_len=seq_len, tok1=tok1, table=table, zero=zero,
        last=seq_len - 1).items()}
    T = {k: torch.from_numpy(np.asarray(v)) for k, v in dict(
        toks=toks, seq_len=seq_len, tok1=tok1, table=table, zero=zero,
        last=seq_len - 1).items()}
    out = []
    # Dense: whole-prompt prefill, its K/V into a slab, one decode step.
    lj, (kj, vj) = japi.prefill(jcfg, jparams, J["toks"], last_pos=J["last"],
                                **kw_j)
    lt, (kt, vt) = api.prefill(cfg, params, T["toks"], last_pos=T["last"],
                               **kw_t)
    out.append(("prefill", lt, lj))
    slab_j = [jnp.zeros((jcfg.n_layers, B, 32, jcfg.n_kv_heads,
                         jcfg.head_dim), jnp.float32) for _ in range(2)]
    slab_t = list(api.init_serve_state(cfg, B, 32, torch.float32,
                                       device="cpu"))
    for b, L in enumerate(seq_len):
        slab_j = [s.at[:, b, :L].set(n[:, b, :L])
                  for s, n in zip(slab_j, (kj, vj))]
        for s, n in zip(slab_t, (kt, vt)):
            s[:, b, :L] = n[:, b, :L]
    lj, _ = japi.decode_step(jcfg, jparams, J["tok1"], tuple(slab_j),
                             J["seq_len"], **kw_j)
    lt, _ = api.decode_step(cfg, params, T["tok1"], tuple(slab_t),
                            T["seq_len"], **kw_t)
    out.append(("decode_step", lt, lj))
    # Paged: suffix prefill from 0, then one decode step.
    kv_j = japi.init_paged_serve_state(jcfg, 1 + B * P, PAGE, jnp.float32)
    kv_t = api.init_paged_serve_state(cfg, 1 + B * P, PAGE, torch.float32,
                                      device="cpu")
    lj, kv_j = japi.prefill_paged(jcfg, jparams, J["toks"], kv_j, J["table"],
                                  J["zero"], J["seq_len"], **kw_j)
    lt, kv_t = api.prefill_paged(cfg, params, T["toks"], kv_t, T["table"],
                                 T["zero"], T["seq_len"], **kw_t)
    out.append(("prefill_paged", lt, lj))
    lj, _ = japi.decode_step_paged(jcfg, jparams, J["tok1"], kv_j,
                                   J["table"], J["seq_len"], **kw_j)
    lt, _ = api.decode_step_paged(cfg, params, T["tok1"], kv_t, T["table"],
                                  T["seq_len"], **kw_t)
    out.append(("decode_step_paged", lt, lj))
    return out


def drain(eng, request_cls, clock, before_step=None):
    rng = np.random.default_rng(5)
    handles = [eng.submit(request_cls(
        input_len=L, output_len=O, adapter_id=a,
        prompt=[int(x) for x in rng.integers(1, 200, L)]))
        for L, O, a in TRACE]
    for _ in range(2000):
        if not eng.busy():
            break
        if before_step is not None:
            before_step(eng)
        eng.step()
        clock.t += 0.01
    assert not eng.busy(), "engine failed to drain"
    return [h.tokens for h in handles]


@pytest.mark.parametrize("name", CONFIGS)
def test_dense_variant_matches_jax(name):
    jcfg = jget_config(name).reduced()
    cfg = get_config(name).reduced()
    jparams = perturbed_params(jcfg, seed=len(name))
    params = bridge.params_to_torch(jparams, "cpu")
    jslots = lora_slots(jcfg)
    slots = bridge.lora_to_torch(jslots, "cpu")
    for what, port, ref in step_logits(jcfg, cfg, jparams, params, jslots,
                                       slots):
        np.testing.assert_allclose(bridge.to_numpy(port), np.asarray(ref),
                                   err_msg=f"{name}: {what}", **TOL)
    jcat = jengine.AdapterCatalog(jcfg, ENGINE["n_adapters"], 32, seed=0)
    cat = engine.AdapterCatalog(
        cfg, ENGINE["n_adapters"], 32,
        weights=bridge.catalog_weights_to_torch(jcat.weights, "cpu"))
    jclock, clock = StepClock(), StepClock()
    jeng = jengine.ChameleonEngine(jcfg, jparams,
                                   jengine.EngineConfig(**ENGINE),
                                   catalog=jcat, clock=jclock)
    eng = engine.ChameleonEngine(cfg, params, engine.EngineConfig(**ENGINE),
                                 catalog=cat, clock=clock, device="cpu")
    want = drain(jeng, JRequest, jclock, before_step=land_jax_loads)
    got = drain(eng, Request, clock)
    assert got == want, f"{name}: greedy tokens differ from the JAX engine"
    assert [len(t) for t in got] == [o for _, o, _ in TRACE]
