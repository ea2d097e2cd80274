"""The port's dense-prefill paths on the CPU vs the JAX package.

Two engine configurations of the JAX package run the whole-prompt
dense prefill (``lm.prefill``, whose attention is the flash_attention
kernel's function): ``EngineConfig(paged=False)``, the dense KV slab,
and ``EngineConfig(prefix_cache=False)``, whose prompt K/V are copied
into the slot's pages. Both sides get the same weights (the JAX
package's ``init_params`` and ``AdapterCatalog`` through the bridge),
the same ``EngineConfig`` (``BASE`` of ``tests/test_torch_engine.py``)
and a virtual clock advanced once per step.

- ``prefill``, ``decode_step``, ``decode_fused`` and ``forward`` of the
  port at reduced Llama in f32 match the JAX functions: logits and the
  written slab within 1e-5, fused greedy tokens identical.
- Each engine's greedy tokens equal the JAX engine's, with equal
  ``stats()`` (adapter loads and evictions, squashes, pool), and the
  pool invariants hold after every step. The trace adds a request whose
  context reaches ``max_len`` and one whose prompt fills the slab but a
  position, whose done row keeps writing past the slab's end inside a
  fused horizon: JAX drops those writes and so must the port.
- The port's dense, paged and paged-prefix engines give identical
  greedy tokens, and identical seeded-sampled tokens.
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
from repro.models import api as japi  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.lora_apply import (  # noqa: E402
    init_lora_slots as jinit_slots, random_lora_weights as jrandom_lora,
    write_adapter_to_slot as jwrite_slot)
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Request, SamplingParams  # noqa: E402
from repro_torch.models import api, lm  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

from test_torch_engine import (BASE, N_ADAPTERS_USED, N_REQ,  # noqa: E402
                               StepClock, land_jax_loads, serve,
                               shared_prefix_prompts)

TOL = dict(rtol=1e-5, atol=1e-5)
#: Configs of the families with model functions but no engine (SSM,
#: hybrid, enc-dec): the reference engine cannot serve them either.
UNPORTED_API = ("falcon-mamba-7b", "zamba2-1.2b", "whisper-base")
R_MAX = 32
RANKS = (8, 16, 32)
MAX_LEN = BASE["max_len"]


def close(port, ref, **kw):
    np.testing.assert_allclose(bridge.to_numpy(port),
                               np.asarray(ref, np.float32), **(kw or TOL))


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("chameleon-llama-7b").reduced()
    params = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    slots = jinit_slots(jax.random.PRNGKey(1), len(RANKS), jcfg.n_layers,
                        jcfg.d_model, jcfg.q_dim, jcfg.kv_dim, R_MAX,
                        dtype=jnp.float32)
    for i, rank in enumerate(RANKS):
        w = jrandom_lora(jax.random.PRNGKey(100 + i), rank, R_MAX,
                         jcfg.n_layers, jcfg.d_model, jcfg.q_dim,
                         jcfg.kv_dim, dtype=jnp.float32)
        slots = jwrite_slot(slots, w, i)
    return dict(jcfg=jcfg, cfg=get_config("chameleon-llama-7b").reduced(),
                jparams=params, jslots=slots,
                params=bridge.params_to_torch(params, "cpu"),
                slots=bridge.lora_to_torch(slots, "cpu"))


def both(a):
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def prefill_into_slab(model, backend):
    """A right-padded prefill of three prompts on both sides, its K/V
    copied into an f32 slab (as the engine does), then one decode step
    over the slab. Returns [(what, port, jax), ...] and both slabs."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    rng = np.random.default_rng(3)
    B, S, Smax = 3, 32, 48
    lens = np.array([32, 19, 6], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    idx = np.array([2, 0, 1], np.int32)
    kw_j = dict(lora=model["jslots"], adapter_idx=jnp.asarray(idx),
                lora_backend=backend)
    kw_t = dict(lora=model["slots"], adapter_idx=torch.from_numpy(idx),
                lora_backend=backend)
    tj, tt = both(toks)
    pj, pt = both(lens - 1)
    lj, (kj, vj) = jlm.prefill(jcfg, model["jparams"], tj, last_pos=pj,
                               **kw_j)
    lt, (kt, vt) = lm.prefill(cfg, model["params"], tt, last_pos=pt, **kw_t)
    out = [("prefill logits", lt, lj), ("prefill k", kt, kj),
           ("prefill v", vt, vj)]
    slab_j = jlm.make_kv_caches(jcfg, B, Smax, jnp.float32)
    slab_t = lm.make_kv_caches(cfg, B, Smax, torch.float32, device="cpu")
    for b, L in enumerate(lens):
        slab_j = tuple(c.at[:, b, :L].set(n[:, b, :L])
                       for c, n in zip(slab_j, (kj, vj)))
        for c, n in zip(slab_t, (kt, vt)):
            c[:, b, :L] = n[:, b, :L]
    tok1 = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    t1j, t1t = both(tok1)
    cj, ct = both(lens)
    dj, slab_j = jlm.decode_step(jcfg, model["jparams"], t1j, slab_j, cj,
                                 **kw_j)
    dt, slab_t = lm.decode_step(cfg, model["params"], t1t, slab_t, ct,
                                **kw_t)
    out.append(("decode logits", dt, dj))
    for name, a, b in zip("kv", slab_t, slab_j):
        out.append((f"{name} slab", a, b))
    return out


class TestDenseLM:
    @pytest.mark.parametrize("backend", ["einsum", "kernel"])
    def test_prefill_and_decode_step_match_jax(self, model, backend):
        for what, port, ref in prefill_into_slab(model, backend):
            close(port, ref, err_msg=f"{backend}: {what}", **TOL)

    def test_forward_matches_jax(self, model):
        rng = np.random.default_rng(4)
        tj, tt = both(rng.integers(0, model["cfg"].vocab_size, (2, 40))
                      .astype(np.int32))
        got = lm.forward(model["cfg"], model["params"], tt)
        assert got.shape == (2, 40, model["cfg"].vocab_size)
        assert got.dtype == torch.float32
        close(got, jlm.forward(model["jcfg"], model["jparams"], tj))
        close(api.forward(model["cfg"], model["params"], tt), got,
              rtol=0, atol=0)

    def test_fused_greedy_horizon_tokens_identical(self, model):
        """K=8 over a slab of max_ctx positions; row 0 stops on its
        budget mid-horizon and row 1 starts one position short of the
        slab's end, so after its first token it keeps writing past the
        end (dropped on both sides)."""
        cfg, jcfg = model["cfg"], model["jcfg"]
        rng = np.random.default_rng(9)
        B, K, Smax = 3, 8, 40
        lens = np.array([20, Smax - 1, 13], np.int32)
        slab_np = [rng.standard_normal((cfg.n_layers, B, Smax,
                                        cfg.n_kv_heads, cfg.head_dim))
                   .astype(np.float32) for _ in range(2)]
        slab_j = tuple(jnp.asarray(a) for a in slab_np)
        slab_t = tuple(torch.from_numpy(a.copy()) for a in slab_np)
        first = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        idx = np.array([1, 2, 0], np.int32)
        f32 = np.zeros(B, np.float32)
        args = dict(tokens=first, cache_len=lens,
                    active=np.array([True, True, False]),
                    positions=np.ones(B, np.int32),
                    budget=np.array([6, 20, 20], np.int32),
                    stop_ids=np.full((B, 0), -1, np.int32), temperature=f32,
                    top_k=np.zeros(B, np.int32), top_p=f32 + 1,
                    seeds=np.zeros(B, np.int32))
        carry_j, toks_j, emits_j = jlm.decode_fused(
            jcfg, model["jparams"], kv_caches=slab_j,
            **{k: jnp.asarray(v) for k, v in args.items()}, n_steps=K,
            all_greedy=True, max_ctx=Smax, lora=model["jslots"],
            adapter_idx=jnp.asarray(idx))
        carry_t, toks_t, emits_t = api.decode_fused(
            cfg, model["params"], kv_caches=slab_t,
            **{k: torch.from_numpy(v) for k, v in args.items()}, n_steps=K,
            all_greedy=True, max_ctx=Smax, lora=model["slots"],
            adapter_idx=torch.from_numpy(idx))
        assert np.array_equal(bridge.to_numpy(toks_t), np.asarray(toks_j))
        assert np.array_equal(bridge.to_numpy(emits_t), np.asarray(emits_j))
        assert not bridge.to_numpy(emits_t)[6:, 0].any()
        assert bridge.to_numpy(emits_t)[:, 1].tolist() == [True] + [False] * 7
        for name, t, j in zip(("cache_len", "active", "positions"),
                              carry_t[2:], carry_j[2:]):
            assert np.array_equal(bridge.to_numpy(t), np.asarray(j)), name
        for t, j in zip(carry_t[1], carry_j[1]):
            close(t, j)

    def test_other_families_raise_naming_the_family(self):
        """The SSM, hybrid and enc-dec families have model functions now
        (held to JAX in ``tests/test_torch_families.py``): ``forward``,
        ``prefill``, ``decode_step`` and ``init_serve_state`` run on
        their reduced weights. The serving-only surfaces JAX gates to
        the dense and MoE families (fused decode, paged KV) still raise
        naming the family."""
        tok = torch.zeros((1, 4), dtype=torch.int32)
        for name in UNPORTED_API:
            cfg = get_config(name).reduced()
            params = lm.init_params(cfg, 0, torch.float32, device="cpu")
            kw = {}
            if cfg.family.name == "ENCDEC":
                kw["frames"] = torch.zeros((1, cfg.enc_ctx, cfg.d_model))
            logits = api.forward(cfg, params, tok, **kw)
            assert logits.shape == (1, 4, cfg.vocab_size)
            assert torch.isfinite(logits).all()
            last, _ = api.prefill(cfg, params, tok, **kw)
            assert torch.isfinite(last).all()
            state = api.init_serve_state(cfg, 1, 8, torch.float32,
                                         device="cpu")
            step, _ = api.decode_step(cfg, params, tok[:, :1], state,
                                      torch.zeros((1,), dtype=torch.int32))
            assert step.shape == (1, cfg.vocab_size)
            assert torch.isfinite(step).all()
            for call in (lambda: api.decode_fused(
                             cfg, params, tok, None, None, None, None, None,
                             None, None, None, None, None),
                         lambda: api.init_paged_serve_state(
                             cfg, 4, 16, device="cpu")):
                with pytest.raises(NotImplementedError,
                                   match=cfg.family.name):
                    call()


# ------------------------------------------------------------- engines
def engine_trace(vocab):
    """The shared-prefix trace of ``tests/test_torch_engine.py`` plus a
    request whose context reaches ``max_len`` (input + output = max_len)
    and one whose prompt is ``max_len - 1`` tokens."""
    prompts = shared_prefix_prompts(n=N_REQ)
    adapters = [i % N_ADAPTERS_USED for i in range(N_REQ)]
    rng = np.random.default_rng(21)
    for n, a in ((MAX_LEN - 8, 1), (MAX_LEN - 1, 2)):
        prompts.append(rng.integers(3, vocab, size=n).tolist())
        adapters.append(a)
    return prompts, adapters


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("chameleon-llama-7b").reduced()
    params = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jcat = jengine.AdapterCatalog(jcfg, BASE["n_adapters"], 32, seed=0)
    cfg = get_config("chameleon-llama-7b").reduced()
    cat = engine.AdapterCatalog(
        cfg, BASE["n_adapters"], 32,
        weights=bridge.catalog_weights_to_torch(jcat.weights, "cpu"))
    prompts, adapters = engine_trace(cfg.vocab_size)
    return dict(jcfg=jcfg, jparams=params, jcat=jcat, cfg=cfg,
                params=bridge.params_to_torch(params, "cpu"), cat=cat,
                prompts=prompts, adapters=adapters)


def jax_serve(setup, **kw):
    clock = StepClock()
    eng = jengine.ChameleonEngine(setup["jcfg"], setup["jparams"],
                                  jengine.EngineConfig(**BASE, **kw),
                                  catalog=setup["jcat"], clock=clock)
    toks = serve(eng, JRequest, setup["prompts"], setup["adapters"], clock,
                 check=False, before_step=land_jax_loads)
    return toks, eng.stats()


def port_engine(setup, **kw):
    return engine.ChameleonEngine(setup["cfg"], setup["params"],
                                  engine.EngineConfig(**BASE, **kw),
                                  catalog=setup["cat"], clock=StepClock(),
                                  device="cpu")


def port_serve(setup, **kw):
    eng = port_engine(setup, **kw)
    clock = eng._clock
    handles = [eng.submit(Request(input_len=len(p), output_len=8,
                                  adapter_id=a, prompt=list(p)))
               for p, a in zip(setup["prompts"], setup["adapters"])]
    for _ in range(5000):
        if not eng.busy():
            break
        eng.step()
        if eng.paged:
            eng.pool.check_invariants(free_page_ids=eng.free_pages)
        else:
            eng.pool.check_invariants()
        clock.t += 0.01
    assert not eng.busy(), "engine failed to drain"
    return [h.tokens for h in handles], eng.stats()


@pytest.fixture(scope="module")
def jax_runs(setup):
    return {name: jax_serve(setup, **kw) for name, kw in
            (("dense", dict(paged=False)),
             ("no_prefix", dict(prefix_cache=False)))}


CONFIGS = {"dense": dict(paged=False), "no_prefix": dict(prefix_cache=False)}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["dense", "no_prefix"])
def test_port_engine_matches_jax_engine(setup, jax_runs, name, fused):
    jtoks, jstats = jax_runs[name]
    toks, stats = port_serve(setup, **CONFIGS[name], fused_hotloop=fused)
    n = len(setup["prompts"])
    assert stats["completed"] == n
    # The long requests stop at the context bound: input + generated
    # reaches max_len - 1.
    assert [len(t) for t in toks[-2:]] == [7, 2]
    assert toks == jtoks, "greedy tokens differ from the JAX engine"
    assert stats["fused_hotloop"] is fused
    assert {k: v for k, v in stats.items() if k != "fused_hotloop"} == \
        {k: v for k, v in jstats.items() if k != "fused_hotloop"}
    assert stats["cache"]["evictions"] > 0
    assert stats["async_loads"] > BASE["n_lora_slots"]
    assert "prefix_hit_tokens" not in stats
    assert ("kv_pages_used" in stats) == (name == "no_prefix")


def test_dense_paged_and_prefix_engines_agree(setup):
    """As ``tests/test_paged_engine.py`` holds the JAX engine: the data
    plane does not change greedy tokens."""
    runs = [port_serve(setup, **kw)[0] for kw in
            (dict(paged=False), dict(prefix_cache=False), dict())]
    assert runs[0] == runs[1] == runs[2]


def test_seeded_sampling_same_on_paged_and_dense(setup):
    """As ``tests/test_serving_api.py`` holds the JAX engine: a
    request's sampled tokens depend on its seed and positions only."""
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.95, seed=123)
    outs = []
    for kw in (dict(paged=False), dict(prefix_cache=False), dict()):
        eng = port_engine(setup, **kw)
        handles = [eng.submit(Request(input_len=8 + i, output_len=6,
                                      adapter_id=i,
                                      prompt=list(range(3, 11 + i))),
                              sampling=sp) for i in range(3)]
        for _ in range(500):
            if not eng.busy():
                break
            eng.step()
            eng._clock.t += 0.01
        outs.append([h.tokens for h in handles])
    assert all(len(t) == 6 for t in outs[0])
    assert outs[0] == outs[1] == outs[2]


def test_dense_engine_drops_writes_past_the_slab(setup):
    """A prompt one short of ``max_len`` in the dense slab: the fused
    horizon keeps the done row writing at ``max_len``; the slab's last
    position holds the row's final K and nothing raises."""
    eng = port_engine(setup, paged=False)
    p = setup["prompts"][-1]
    h = eng.submit(Request(input_len=len(p), output_len=8, adapter_id=0,
                           prompt=list(p)))
    for _ in range(50):
        if not eng.busy():
            break
        eng.step()
        eng._clock.t += 0.01
    assert not eng.busy() and len(h.tokens) == 2
    slot_k = eng.kv[0][:, 0]
    assert torch.isfinite(slot_k).all()
    assert slot_k[:, MAX_LEN - 1].abs().sum() > 0


@pytest.mark.parametrize("paged", [False, True])
def test_non_dense_family_raises_naming_the_family(paged):
    """VLM has model functions but no engine (the reference engine
    threads no M-RoPE positions); MoE serves (``tests/
    test_torch_moe_engine.py``)."""
    cfg = get_config("qwen2-vl-7b").reduced()
    with pytest.raises(NotImplementedError, match="VLM"):
        engine.ChameleonEngine(cfg, {}, engine.EngineConfig(**BASE,
                                                            paged=paged),
                               device="cpu")


@pytest.mark.parametrize("name", UNPORTED_API)
def test_unported_family_engine_raises_naming_the_family(name):
    cfg = get_config(name).reduced()
    with pytest.raises(NotImplementedError, match=cfg.family.name):
        engine.ChameleonEngine(cfg, {}, engine.EngineConfig(**BASE),
                               device="cpu")


@pytest.mark.parametrize("name", UNPORTED_API)
def test_reference_engine_fails_for_the_family(name):
    """Why the port's engine refuses these families: the reference
    engine cannot serve them. SSM fails at construction (its adapter
    catalog scales LoRA-A by ``q_dim ** -0.5`` with ``q_dim == 0``);
    hybrid and enc-dec build, then fail at their first prefill (their
    ``prefill`` takes no ``last_pos``)."""
    import warnings
    jcfg = jget_config(name).reduced()
    params = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    ecfg = jengine.EngineConfig(max_slots=2, max_len=64, n_lora_slots=2,
                                n_adapters=2)
    if name == "falcon-mamba-7b":
        with pytest.raises(ZeroDivisionError):
            jengine.ChameleonEngine(jcfg, params, ecfg)
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # hybrid: no fused path
        eng = jengine.ChameleonEngine(jcfg, params, ecfg)
    eng.submit(JRequest(input_len=8, output_len=2, adapter_id=0,
                        prompt=list(range(1, 9))))
    with pytest.raises(TypeError, match="last_pos"):
        for _ in range(50):
            land_jax_loads(eng)
            eng.step()
