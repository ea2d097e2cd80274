"""Shared set-up of the port's serving tests (chunked prefill, the
migration API and the tiers of ``build_system``).

``models()`` builds the reduced Llama (or the reduced config named)
once per process: the JAX package's weights and adapter catalog, and
the same bridged to tensors on the CPU, so the JAX engine and the port
serve identical models.
"""
import functools

import numpy as np

#: The engine shape of ``tests/test_disagg.py``'s engines.
ENGINE = dict(max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8,
              seed=0)


@functools.lru_cache(maxsize=None)
def models(name="chameleon-llama-7b"):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import api as japi
    from repro.serving import engine as jengine
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.serving import engine

    jcfg = jget_config(name).reduced()
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jcat = jengine.AdapterCatalog(jcfg, ENGINE["n_adapters"], 32, seed=0)
    cfg = get_config(name).reduced()
    cat = engine.AdapterCatalog(
        cfg, ENGINE["n_adapters"], 32,
        weights=bridge.catalog_weights_to_torch(jcat.weights, "cpu"))
    return dict(jcfg=jcfg, jparams=jparams, jcat=jcat, cfg=cfg,
                params=bridge.params_to_torch(jparams, "cpu"), cat=cat)


class StepClock:
    """Virtual time a test advances by hand; never the wall clock."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def reset(self) -> None:
        self.t = 0.0


def land_jax_loads(eng):
    """Block until the JAX engine's in-flight slot writes are done, so
    its ``_poll_loads`` finds them ready at the next step, as the port's
    synchronous CPU copies are."""
    import jax
    for _, leaves, _ in eng._pending_loads.values():
        jax.block_until_ready(leaves)


def prompt(rng, n):
    return [int(x) for x in rng.integers(1, 200, n)]


def check_pools(*engines):
    for e in engines:
        if e.paged:
            e.pool.check_invariants(free_page_ids=e.free_pages)


def run_to_generated(eng, handle, n):
    """Step until the request has streamed ``n`` tokens."""
    for _ in range(10_000):
        if len(handle.tokens) >= n or handle.done:
            return
        eng.step()
    raise AssertionError("request never reached the target progress")


def page_kv(eng, slot, n):
    """The first ``n`` positions of K and V in ``slot``'s pages, as
    (L, n, Kh, Dh) arrays."""
    import torch
    ps = eng.pool.page_size
    pos = torch.arange(n)
    pages = torch.as_tensor(eng.slot_pages[slot])[pos // ps]
    return [t[:, pages, pos % ps].numpy() for t in eng.kv_pages]


# ------------------------------------------------ speculative decoding
@functools.lru_cache(maxsize=None)
def draft_models():
    """The draft of ``tests/test_spec_decode.py``: ``internlm2-1.8b``
    cut to 2 layers and the target's vocabulary, weights from
    ``PRNGKey(7)``; returned as the (cfg, params) pair each engine
    takes, JAX's and bridged."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import api as japi
    from repro_torch import bridge
    from repro_torch.configs import get_config

    V = models()["cfg"].vocab_size
    jdcfg = jget_config("internlm2-1.8b").reduced(n_layers=2, vocab_size=V)
    jdparams = japi.init_params(jdcfg, jax.random.PRNGKey(7), jnp.float32)
    dcfg = get_config("internlm2-1.8b").reduced(n_layers=2, vocab_size=V)
    return (jdcfg, jdparams), (dcfg, bridge.params_to_torch(jdparams, "cpu"))


@functools.lru_cache(maxsize=None)
def zeroed_catalogs():
    """JAX and port adapter catalogs whose LoRA deltas are exactly zero:
    a base-weights self-draft then agrees with the target everywhere."""
    import jax.numpy as jnp

    from repro.serving import engine as jengine
    from repro_torch import bridge
    from repro_torch.serving import engine

    m = models()
    jcat = jengine.AdapterCatalog(m["jcfg"], ENGINE["n_adapters"], 32, seed=0)
    for aid in jcat.weights:
        jcat.weights[aid] = {k: (jnp.zeros_like(a), jnp.zeros_like(b))
                             for k, (a, b) in jcat.weights[aid].items()}
    cat = engine.AdapterCatalog(
        m["cfg"], ENGINE["n_adapters"], 32,
        weights=bridge.catalog_weights_to_torch(jcat.weights, "cpu"))
    return jcat, cat


def spec_trace(n=10, seed=3, adapters=8):
    """``tests/test_spec_decode.py``'s ``fixed_trace``: (input_len,
    output_len, adapter) triples."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(4, 30)), int(rng.integers(2, 40)),
             int(rng.integers(0, adapters))) for _ in range(n)]


def spec_engines(*, spec=True, draft="other", catalog="random", **knobs):
    """A JAX engine and a port engine on the same weights, adapters and
    ``EngineConfig``, each with its own ``StepClock``. ``draft``:
    "other" (the internlm2 draft), "self" (the target drafts for
    itself) or None; ``catalog``: "random" or "zero" (zero deltas).
    Returns ((jax engine, clock), (port engine, clock))."""
    from repro.serving import engine as jengine
    from repro_torch.serving import engine

    m = models()
    jcat, cat = ((m["jcat"], m["cat"]) if catalog == "random"
                 else zeroed_catalogs())
    if draft == "other":
        jdraft, tdraft = draft_models()
    elif draft == "self":
        jdraft, tdraft = (m["jcfg"], m["jparams"]), (m["cfg"], m["params"])
    else:
        jdraft = tdraft = None
    kw = {**ENGINE, **knobs, "spec_decode": spec}
    jclock, clock = StepClock(), StepClock()
    jeng = jengine.ChameleonEngine(m["jcfg"], m["jparams"],
                                   jengine.EngineConfig(**kw), catalog=jcat,
                                   clock=jclock, draft=jdraft)
    eng = engine.ChameleonEngine(m["cfg"], m["params"],
                                 engine.EngineConfig(**kw), catalog=cat,
                                 clock=clock, draft=tdraft, device="cpu")
    return (jeng, jclock), (eng, clock)


def is_port(eng) -> bool:
    return type(eng).__module__.startswith("repro_torch.")


def step_once(eng, clock, dt=0.01):
    """One engine step; the JAX engine's slot writes land first."""
    if not is_port(eng):
        land_jax_loads(eng)
    eng.step()
    clock.t += dt


def core_classes(eng):
    """(Request, SamplingParams) of the engine's own package."""
    if is_port(eng):
        from repro_torch.core import Request, SamplingParams
    else:
        from repro.core import Request, SamplingParams
    return Request, SamplingParams


def serve_trace(eng, clock, specs, sampling=None, after_step=None,
                max_steps=20_000):
    """Submit ``specs`` (``sampling``: SamplingParams keywords for every
    request, or None) and step until drained; ``after_step(eng)`` runs
    after every step. Returns the handles."""
    req_cls, sp_cls = core_classes(eng)
    sp = sp_cls(**sampling) if sampling else None
    handles = [eng.submit(req_cls(input_len=i, output_len=o, adapter_id=a),
                          sampling=sp) for i, o, a in specs]
    for _ in range(max_steps):
        if not eng.busy():
            break
        step_once(eng, clock)
        if after_step is not None:
            after_step(eng)
    assert not eng.busy(), "engine failed to drain"
    return handles
