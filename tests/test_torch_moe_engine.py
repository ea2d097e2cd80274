"""The port's MoE engine on the CPU vs the JAX engine.

Reduced ``qwen3-moe-235b-a22b`` and ``llama4-maverick-400b-a17b``, f32,
the JAX package's weights and adapter catalog bridged to the port, the
engine shape of ``tests/test_disagg.py`` (4 batch slots, max_len 128,
4 LoRA slots, 8 adapters). MoE prefill drops assignments over capacity,
so a token depends on which requests share its prefill bucket: both
engines step on one virtual clock each, advanced together, and the JAX
engine's asynchronous adapter writes land before every step
(``land_jax_loads``), so both batch the same requests.

- The default ``EngineConfig()`` (``paged=True``) serves both from the
  dense KV slab, with no prefix cache: fused and seed loops, a greedy
  batch and a mixed one (every second request seeded), tokens equal.
- ``prefill_chunk_tokens > 0`` is inert in both: no chunked prefill,
  the same tokens as without it.
- ``spec_decode=True`` on an MoE target raises ``NotImplementedError``
  at the port's construction; the JAX ``api.verify`` fails with
  ``KeyError: 'mlp_norm'`` on the same model. The divergence is pinned.
"""
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _port_serving import (ENGINE, StepClock, core_classes,  # noqa: E402
                           models, spec_trace, step_once)
from repro.models import api as japi  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

MOE_CONFIGS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
#: (input_len, output_len, adapter) triples of the shared trace.
TRACE = spec_trace(n=8, seed=4)


def engines(name, **knobs):
    """A JAX engine and a port engine on the same weights, adapters and
    ``EngineConfig``, each with its own ``StepClock``."""
    m = models(name)
    kw = {**ENGINE, **knobs}
    jclock, clock = StepClock(), StepClock()
    jeng = jengine.ChameleonEngine(m["jcfg"], m["jparams"],
                                   jengine.EngineConfig(**kw),
                                   catalog=m["jcat"], clock=jclock)
    eng = engine.ChameleonEngine(m["cfg"], m["params"],
                                 engine.EngineConfig(**kw), catalog=m["cat"],
                                 clock=clock, device="cpu")
    return (jeng, jclock), (eng, clock)


def serve(eng, clock, mixed):
    """Submit ``TRACE`` (every second request seeded when ``mixed``) and
    step until drained. Returns each request's tokens."""
    req_cls, sp_cls = core_classes(eng)
    handles = [eng.submit(
        req_cls(input_len=i, output_len=o, adapter_id=a),
        sampling=(sp_cls(temperature=0.8, top_k=20, seed=50 + n)
                  if mixed and n % 2 else None))
        for n, (i, o, a) in enumerate(TRACE)]
    for _ in range(5000):
        if not eng.busy():
            break
        step_once(eng, clock)
    assert not eng.busy(), "engine failed to drain"
    return [h.tokens for h in handles]


@pytest.mark.parametrize("name", MOE_CONFIGS)
@pytest.mark.parametrize("fused,mixed", [(True, False), (False, False),
                                         (True, True), (False, True)])
def test_tokens_equal_jax_engine(name, fused, mixed):
    (jeng, jclock), (eng, clock) = engines(name, fused_hotloop=fused)
    # paged=True (the default) falls back to the dense slab in both.
    assert eng.ecfg.paged and not eng.paged and not jeng.paged
    assert eng.prefix is None and jeng.prefix is None
    assert eng.kv is not None and eng.kv_pages is None
    assert eng.fused == jeng.fused == fused
    want = serve(jeng, jclock, mixed)
    got = serve(eng, clock, mixed)
    assert got == want
    assert [len(t) for t in got] == [o for _, o, _ in TRACE]
    js, ts = jeng.stats(), eng.stats()
    for key in ("completed", "cache", "squashed", "async_loads", "pool"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_prefill_chunking_is_inert(name):
    """Chunked prefill needs paged KV: on MoE neither engine chunks,
    and the tokens are those of the engine without chunking."""
    (jeng, jclock), (eng, clock) = engines(name, prefill_chunk_tokens=8)
    want = serve(jeng, jclock, mixed=False)
    got = serve(eng, clock, mixed=False)
    assert got == want
    assert eng.n_chunked_prefills == jeng.n_chunked_prefills == 0
    assert not eng._chunked and not jeng._chunked
    _, (plain, pclock) = engines(name)
    assert serve(plain, pclock, mixed=False) == got


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_spec_decode_divergence_is_pinned(name):
    """The port refuses speculative decoding on an MoE target where the
    reference builds an engine whose first verify fails: its
    ``lm.verify`` runs the dense MLP on every layer, and MoE layers have
    no ``mlp_norm``."""
    m = models(name)
    with pytest.raises(NotImplementedError, match="spec_decode.*MOE"):
        engine.ChameleonEngine(m["cfg"], m["params"],
                               engine.EngineConfig(**ENGINE,
                                                   spec_decode=True),
                               catalog=m["cat"], draft=(m["cfg"],
                                                        m["params"]),
                               device="cpu")
    cfg = m["jcfg"]
    assert japi.supports_fused(cfg)
    kv = japi.init_serve_state(cfg, 1, 16, jnp.float32)
    with pytest.raises(KeyError, match="mlp_norm"):
        japi.verify(cfg, m["jparams"], jnp.zeros((1, 3), jnp.int32), kv,
                    jnp.zeros((1,), jnp.int32))
