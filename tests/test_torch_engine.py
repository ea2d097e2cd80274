"""The port's whole engine on the CPU vs the JAX engine.

Both engines are built on the same weights (the JAX package's
``init_params`` and ``AdapterCatalog``, bridged to tensors), the same
``EngineConfig`` (the ``BASE`` of ``tests/test_prefix_cache.py``) and
a virtual clock that both advance by the same step, so every
scheduling decision can match. They serve a shared-prefix trace over
more adapters than LoRA slots, so adapters load and evict and the
prefix cache hits and forks. Every fourth request is seeded-sampled
(temperature, top-k and top-p), the rest greedy. Every request's tokens
must be identical, sampled ones too (the port draws JAX's own threefry
noise), with equal prefix hits, COW forks and adapter loads, and the
pool invariants must hold after every step. The port's fused loop and
its seed loop must give identical tokens too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Request, SamplingParams  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.serving.systems import build_engine  # noqa: E402

BASE = dict(max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8,
            seed=0)
N_REQ, N_ADAPTERS_USED, DT = 12, 6, 0.01
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)


def sampling_for(i, params_cls):
    """Request i's sampling: every fourth request seeded-sampled."""
    return params_cls(**SAMPLED, seed=100 + i) if i % 4 == 3 else None


class StepClock:
    """Virtual time the test advances once per engine step."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def shared_prefix_prompts(n=8, prefix_len=40, n_prefixes=2, seed=11,
                          vocab=256):
    """As in ``tests/test_prefix_cache.py``: n prompts drawn from
    n_prefixes fixed preambles plus unique suffixes."""
    rng = np.random.default_rng(seed)
    pres = [rng.integers(3, vocab, size=prefix_len).tolist()
            for _ in range(n_prefixes)]
    return [pres[i % n_prefixes]
            + rng.integers(3, vocab, size=int(rng.integers(4, 13))).tolist()
            for i in range(n)]


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("chameleon-llama-7b").reduced()
    params = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jcat = jengine.AdapterCatalog(jcfg, BASE["n_adapters"], 32, seed=0)
    cfg = get_config("chameleon-llama-7b").reduced()
    cat = engine.AdapterCatalog(
        cfg, BASE["n_adapters"], 32,
        weights=bridge.catalog_weights_to_torch(jcat.weights, "cpu"))
    prompts = shared_prefix_prompts(n=N_REQ)
    # Prefix i % 2 pairs with adapter i % 6, so a repeat of an adapter
    # repeats its prefix (exact mode keys pages by adapter).
    adapters = [i % N_ADAPTERS_USED for i in range(N_REQ)]
    return dict(jcfg=jcfg, jparams=params, jcat=jcat, cfg=cfg,
                params=bridge.params_to_torch(params, "cpu"), cat=cat,
                prompts=prompts, adapters=adapters)


def land_jax_loads(eng):
    """Block until the JAX engine's in-flight slot writes are done, so
    its ``_poll_loads`` finds them ready at the next step, as the port's
    synchronous CPU copies are. Without this, ``is_ready()`` depends on
    how busy the host is, and so does the JAX engine's schedule."""
    for _, leaves, _ in eng._pending_loads.values():
        jax.block_until_ready(leaves)


def serve(eng, request_cls, prompts, adapters, clock, check, out_len=8,
          max_steps=5000, before_step=None, sampling_cls=None):
    handles = [eng.submit(request_cls(input_len=len(p), output_len=out_len,
                                      adapter_id=a, prompt=list(p)),
                          sampling=(sampling_for(i, sampling_cls)
                                    if sampling_cls else None))
               for i, (p, a) in enumerate(zip(prompts, adapters))]
    steps = 0
    while eng.busy() and steps < max_steps:
        if before_step is not None:
            before_step(eng)
        eng.step()
        if check:
            eng.pool.check_invariants(free_page_ids=eng.free_pages)
        clock.t += DT
        steps += 1
    assert not eng.busy(), "engine failed to drain"
    return [h.tokens for h in handles]


def summary(eng):
    s = eng.stats()
    return dict(completed=s["completed"], cache=s["cache"],
                async_loads=s["async_loads"],
                prefix_hit_tokens=s["prefix_hit_tokens"],
                prefix_hits=s["prefix_hits"], cow_forks=s["cow_forks"],
                preempted=s["preempted"])


@pytest.fixture(scope="module")
def jax_run(setup):
    clock = StepClock()
    eng = jengine.ChameleonEngine(setup["jcfg"], setup["jparams"],
                                  jengine.EngineConfig(**BASE),
                                  catalog=setup["jcat"], clock=clock)
    toks = serve(eng, JRequest, setup["prompts"], setup["adapters"], clock,
                 check=False, before_step=land_jax_loads,
                 sampling_cls=JSamplingParams)
    return toks, summary(eng)


def port_run(setup, **kw):
    clock = StepClock()
    eng = engine.ChameleonEngine(setup["cfg"], setup["params"],
                                 engine.EngineConfig(**BASE, **kw),
                                 catalog=setup["cat"], clock=clock,
                                 device="cpu")
    toks = serve(eng, Request, setup["prompts"], setup["adapters"], clock,
                 check=True, sampling_cls=SamplingParams)
    return toks, summary(eng)


@pytest.mark.parametrize("fused", [True, False])
def test_port_engine_matches_jax_engine(setup, jax_run, fused):
    jtoks, jsum = jax_run
    toks, s = port_run(setup, fused_hotloop=fused)
    assert s["completed"] == N_REQ
    assert all(len(t) == 8 for t in toks)
    differ = [(i, next(j for j, (a, b) in enumerate(zip(t, u)) if a != b),
               "sampled" if sampling_for(i, SamplingParams) else "greedy")
              for i, (t, u) in enumerate(zip(toks, jtoks)) if t != u]
    assert not differ, ("tokens differ from the JAX engine at (request, "
                        f"first differing token, kind): {differ}")
    assert s == jsum
    # The trace exercises what it is meant to.
    assert s["prefix_hit_tokens"] > 0 and s["cow_forks"] > 0
    assert s["cache"]["evictions"] > 0
    assert s["async_loads"] > BASE["n_lora_slots"]


def test_alora_mode_matches_jax_engine(setup):
    """``prefix_mode="alora"``: base-model prompt prefill, one prefix
    tree across adapters."""
    clock = StepClock()
    jeng = jengine.ChameleonEngine(
        setup["jcfg"], setup["jparams"],
        jengine.EngineConfig(**BASE, prefix_mode="alora"),
        catalog=setup["jcat"], clock=clock)
    p, a = setup["prompts"][:6], setup["adapters"][:6]
    jtoks = serve(jeng, JRequest, p, a, clock, check=False,
                  before_step=land_jax_loads)
    clock = StepClock()
    eng = build_engine("chameleon", setup["cfg"], setup["params"],
                       engine.EngineConfig(**BASE, prefix_mode="alora"),
                       catalog=setup["cat"], clock=clock, device="cpu")
    toks = serve(eng, Request, p, a, clock, check=True)
    assert toks == jtoks
    assert summary(eng) == summary(jeng)
    assert eng.prefix_hit_tokens > 0


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("knob", [dict(mesh_shape=(1, 3))])
def test_unported_knobs_raise_naming_the_knob(knob, monkeypatch):
    """A mesh serves the dense and MoE families on any "model" axis,
    one that splits the heads and widths unevenly too (3 columns of
    the reduced MoE model's 4 heads, d_model 128 and d_ff_expert 64:
    the attention and the o projection whole on the first column),
    with the ``mesh_shape=None`` engine's tokens; no knob of it
    raises."""
    from _port_whole_heads import engine_tokens
    from repro_torch.models import lm
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=3")
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    params = lm.init_params(cfg, 0, torch.float32, device="cpu")
    eng = engine.ChameleonEngine(cfg, params,
                                 engine.EngineConfig(**BASE, **knob),
                                 device="cpu")
    assert eng.params.whole == {"attn", "out"}
    assert engine_tokens(cfg, params, knob["mesh_shape"]) == \
        engine_tokens(cfg, params, None)


def test_spec_decode_builds_a_speculative_engine(setup):
    """``spec_decode=True`` is ported: the engine speculates with the
    default draft (``spec_draft``, weights from the engine seed + 1),
    whose vocabulary must match the target's."""
    draft = get_config("internlm2-1.8b").reduced(
        n_layers=2, vocab_size=setup["cfg"].vocab_size)
    eng = engine.ChameleonEngine(
        setup["cfg"], setup["params"],
        engine.EngineConfig(**BASE, spec_decode=True),
        catalog=setup["cat"], draft=(draft, None), device="cpu")
    assert eng.spec and eng.draft_cfg is draft
    assert eng.spec_stats()["spec_drafted_tokens"] == 0


def test_engine_config_has_the_jax_fields_and_defaults():
    import dataclasses
    want = {f.name: f.default for f in dataclasses.fields(
        jengine.EngineConfig)}
    got = {f.name: f.default for f in dataclasses.fields(
        engine.EngineConfig)}
    assert got == want
