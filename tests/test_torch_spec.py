"""Speculative draft–verify decoding in the port vs the JAX package (CPU).

Model functions, f32, on the same weights (the JAX package's
``init_params`` and LoRA slots, bridged): ``verify`` and
``verify_paged`` logits and the K/V they write within ``TOL``; the
speculative threefry streams (the draft and residual Gumbel draws, the
scalar accept uniform) on bits equal to JAX's bit for bit, the uniform
itself bit for bit, the Gumbel noise within 1e-6; ``_spec_filtered``
within 1e-6 on rows full of ties; two rounds of the fused speculative
scan, dense and paged, greedy and seeded-sampled, with equal tokens,
emit masks and accepted counts. Then the contracts of
``tests/test_spec_decode.py`` that need no long run: the rejection
rule's distribution, the construction errors (messages equal to the JAX
engine's), the non-fused warning, the unported family, no gauges with
speculation off. The engine-run contracts are in
``tests/test_torch_spec_engine.py`` and
``tests/test_torch_spec_lifecycle.py``.
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
from repro.core.sampling import (SPEC_ACCEPT_FOLD,  # noqa: E402
                                 SPEC_DRAFT_FOLD, SPEC_RESIDUAL_FOLD)
from repro.models import api as japi  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.lora_apply import (  # noqa: E402
    init_lora_slots as jinit_slots, random_lora_weights as jrandom_lora,
    write_adapter_to_slot as jwrite_slot)
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api, lm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PAGE = 16


def close(port, ref, **kw):
    np.testing.assert_allclose(bridge.to_numpy(port),
                               np.asarray(ref, np.float32), **(kw or TOL))


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("chameleon-llama-7b").reduced()
    cfg = get_config("chameleon-llama-7b").reduced()
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    slots = jinit_slots(jax.random.PRNGKey(1), 3, jcfg.n_layers,
                        jcfg.d_model, jcfg.q_dim, jcfg.kv_dim, 32,
                        dtype=jnp.float32)
    for i, rank in enumerate((8, 16, 32)):
        slots = jwrite_slot(slots, jrandom_lora(
            jax.random.PRNGKey(100 + i), rank, 32, jcfg.n_layers,
            jcfg.d_model, jcfg.q_dim, jcfg.kv_dim, dtype=jnp.float32), i)
    # The draft of tests/test_spec_decode.py: another dense arch,
    # other weights, the target's vocabulary.
    jdcfg = jget_config("internlm2-1.8b").reduced(
        n_layers=2, vocab_size=jcfg.vocab_size)
    dcfg = get_config("internlm2-1.8b").reduced(
        n_layers=2, vocab_size=cfg.vocab_size)
    jdparams = japi.init_params(jdcfg, jax.random.PRNGKey(7), jnp.float32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jslots=slots,
                params=bridge.params_to_torch(jparams, "cpu"),
                slots=bridge.lora_to_torch(slots, "cpu"),
                jdcfg=jdcfg, dcfg=dcfg, jdparams=jdparams,
                dparams=bridge.params_to_torch(jdparams, "cpu"))


def both(a, dtype=None):
    a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


# ---------------------------------------------------------------- verify
@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_verify_dense_slab_matches_jax(model, backend):
    """Rows at 10 and 30 of a 32-slot slab (row 1's last three writes
    fall past the slab and are dropped) and at 0 with seq_len 3 (its
    last two are padding, dropped too)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    rng = np.random.default_rng(0)
    B, S, Smax = 3, 5, 32
    shape = (cfg.n_layers, B, Smax, cfg.n_kv_heads, cfg.head_dim)
    kj, kt = both(rng.standard_normal(shape), np.float32)
    vj, vt = both(rng.standard_normal(shape), np.float32)
    tj, tt = both(rng.integers(0, cfg.vocab_size, (B, S)), np.int32)
    cj, ct = both([10, 30, 0], np.int32)
    sj, st = both([5, 5, 3], np.int32)
    ij, it = both([2, 0, 1], np.int32)
    lj, (kj, vj) = japi.verify(jcfg, model["jparams"], tj, (kj, vj), cj,
                               seq_len=sj, lora=model["jslots"],
                               adapter_idx=ij, lora_backend=backend)
    lt, (kt, vt) = api.verify(cfg, model["params"], tt, (kt, vt), ct,
                              seq_len=st, lora=model["slots"],
                              adapter_idx=it, lora_backend=backend)
    assert lt.shape == (B, S, cfg.vocab_size) and lt.dtype == torch.float32
    close(lt, lj)
    close(kt, kj)
    close(vt, vj)


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_verify_paged_matches_jax(model, backend):
    """Row 0 mid-page, row 1 up to the end of its table (two positions
    past it go to the trash page), row 2 with one unmapped page and
    seq_len 2. Pages are compared without page 0."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    rng = np.random.default_rng(1)
    B, S, P = 3, 5, 3
    n_pages = 1 + B * P
    shape = (cfg.n_layers, n_pages, PAGE, cfg.n_kv_heads, cfg.head_dim)
    kj, kt = both(rng.standard_normal(shape), np.float32)
    vj, vt = both(rng.standard_normal(shape), np.float32)
    table = (1 + np.arange(B * P)).reshape(B, P).astype(np.int32)
    table[2, 2] = 0
    pj, pt = both(table)
    tj, tt = both(rng.integers(0, cfg.vocab_size, (B, S)), np.int32)
    cj, ct = both([13, P * PAGE - 3, 20], np.int32)
    sj, st = both([5, 5, 2], np.int32)
    ij, it = both([1, 2, 0], np.int32)
    lj, (kj, vj) = japi.verify_paged(
        jcfg, model["jparams"], tj, (kj, vj), pj, cj, seq_len=sj,
        lora=model["jslots"], adapter_idx=ij, lora_backend=backend)
    lt, (kt, vt) = api.verify_paged(
        cfg, model["params"], tt, (kt, vt), pt, ct, seq_len=st,
        lora=model["slots"], adapter_idx=it, lora_backend=backend)
    close(lt, lj)
    close(kt[:, 1:], np.asarray(kj)[:, 1:])
    close(vt[:, 1:], np.asarray(vj)[:, 1:])


# ----------------------------------------------------------------- draws
SEEDS = np.array([0, 1, 2**31 - 1, 1234, 77, 2**32 - 5], np.int64)
POS = np.array([[0, 1, 2, 3], [5, 6, 7, 8], [0, 300, 7, 9],
                [12, 13, 14, 15], [1, 1, 2, 2], [2**31 - 2, 3, 4, 5]],
               np.int32)


def jax_keys(fold):
    return jlm._spec_keys(jnp.asarray(SEEDS.astype(np.uint32)),
                          jnp.asarray(POS), fold)


@pytest.mark.parametrize("fold", [SPEC_DRAFT_FOLD, SPEC_RESIDUAL_FOLD])
def test_spec_gumbel_streams(fold):
    """The stream's bits equal ``jax.random.bits`` of ``_spec_keys``
    bit for bit; the Gumbel noise from them equals ``jax.random.gumbel``
    within 1e-6 (the two ``log`` implementations differ in the last
    ulps, as for the plain sampler in tests/test_torch_sampling.py)."""
    V = 300
    keys = jax_keys(fold)
    bits = np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.bits(k, (V,))))(keys))
    got_bits = lm.threefry_bits(torch.from_numpy(SEEDS),
                                torch.from_numpy(POS), V, fold).numpy()
    assert np.array_equal(got_bits, bits.astype(np.int64))
    want = np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.gumbel(k, (V,))))(keys))
    got = lm.gumbel_noise(torch.from_numpy(SEEDS), torch.from_numpy(POS),
                          V, fold).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # The (B,) form is the (B, S) form's column.
    col = lm.gumbel_noise(torch.from_numpy(SEEDS),
                          torch.from_numpy(POS[:, 2].copy()), V, fold)
    assert torch.equal(col, torch.from_numpy(got[:, 2]))


def test_spec_accept_uniform_bitwise():
    want = np.asarray(jax.vmap(jax.vmap(jax.random.uniform))(
        jax_keys(SPEC_ACCEPT_FOLD)))
    got = lm.uniform_noise(torch.from_numpy(SEEDS), torch.from_numpy(POS),
                           SPEC_ACCEPT_FOLD).numpy()
    assert got.shape == POS.shape and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got >= 0).all() and (got < 1).all()


def test_spec_filtered_matches_jax():
    rng = np.random.default_rng(2)
    B, K, V = 4, 3, 200
    # One decimal place: many exact ties inside each row.
    logits = np.round(rng.standard_normal((B, K, V)) * 2, 1) \
        .astype(np.float32)
    temp = np.repeat(np.array([0, 0.7, 1.3, 0.9], np.float32)[:, None], K, 1)
    top_k = np.repeat(np.array([0, 5, 0, 40], np.int32)[:, None], K, 1)
    top_p = np.repeat(np.array([1, 0.9, 0.5, 1], np.float32)[:, None], K, 1)
    mj, pj = jlm._spec_filtered(*(jnp.asarray(a) for a in
                                  (logits, temp, top_k, top_p)))
    mt, pt = lm._spec_filtered(*(torch.from_numpy(a) for a in
                                 (logits, temp, top_k, top_p)))
    assert np.array_equal(np.isinf(mt.numpy()), np.isinf(np.asarray(mj)))
    close(pt, pj, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ scan
def scan_state(model, paged):
    """Three rows prefilled (target: the layout under test; draft: its
    dense slab via the catch-up ``verify``) on both sides; row 2 is
    inactive. Returns (jax args, port args, extra kwargs)."""
    cfg, jcfg, dcfg, jdcfg = (model[k] for k in ("cfg", "jcfg", "dcfg",
                                                 "jdcfg"))
    rng = np.random.default_rng(3)
    B, S, P, Smax = 3, 16, 4, P_MAX
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    seq_len = np.array([16, 9, 5], np.int32)
    idx = np.array([2, 0, 1], np.int32)
    zero = np.zeros(B, np.int32)
    table = (1 + np.arange(B * P)).reshape(B, P).astype(np.int32)
    kw_j = dict(lora=model["jslots"], adapter_idx=jnp.asarray(idx))
    kw_t = dict(lora=model["slots"], adapter_idx=torch.from_numpy(idx))
    J = {k: jnp.asarray(v) for k, v in dict(
        toks=toks, seq_len=seq_len, zero=zero, table=table).items()}
    T = {k: torch.from_numpy(v.copy()) for k, v in dict(
        toks=toks, seq_len=seq_len, zero=zero, table=table).items()}
    if paged:
        kv_j = japi.init_paged_serve_state(jcfg, 1 + B * P, PAGE,
                                           jnp.float32)
        kv_t = api.init_paged_serve_state(cfg, 1 + B * P, PAGE,
                                          torch.float32, device="cpu")
        lj, kv_j = japi.prefill_paged(jcfg, model["jparams"], J["toks"],
                                      kv_j, J["table"], J["zero"],
                                      J["seq_len"], **kw_j)
        lt, kv_t = api.prefill_paged(cfg, model["params"], T["toks"], kv_t,
                                     T["table"], T["zero"], T["seq_len"],
                                     **kw_t)
    else:
        kv_j = jlm.make_kv_caches(jcfg, B, Smax, jnp.float32)
        kv_t = api.init_serve_state(cfg, B, Smax, torch.float32,
                                    device="cpu")
        lj, kv_j = japi.verify(jcfg, model["jparams"], J["toks"], kv_j,
                               J["zero"], seq_len=J["seq_len"], **kw_j)
        lt, kv_t = api.verify(cfg, model["params"], T["toks"], kv_t,
                              T["zero"], seq_len=T["seq_len"], **kw_t)
        last = seq_len - 1
        lj = lj[jnp.arange(B), last]
        lt = lt[torch.arange(B), torch.from_numpy(last).long()]
    dkv_j = jlm.make_kv_caches(jdcfg, B, Smax, jnp.float32)
    dkv_t = api.init_serve_state(dcfg, B, Smax, torch.float32, device="cpu")
    _, dkv_j = japi.verify(jdcfg, model["jdparams"], J["toks"], dkv_j,
                           J["zero"], seq_len=J["seq_len"])
    _, dkv_t = api.verify(dcfg, model["dparams"], T["toks"], dkv_t,
                          T["zero"], seq_len=T["seq_len"])
    first = np.asarray(jnp.argmax(lj, -1), np.int32)
    assert np.array_equal(bridge.to_numpy(torch.argmax(lt, -1)), first)
    state = dict(tokens=first[:, None], cache_len=seq_len,
                 active=np.array([True, True, False]),
                 positions=np.ones(B, np.int32),
                 budget=np.array([7, 30, 30], np.int32),  # row 0 stops
                 stop_ids=np.full((B, 1), -1, np.int32),
                 temperature=np.array([0.8, 1.0, 0.0], np.float32),
                 top_k=np.array([12, 0, 0], np.int32),
                 top_p=np.array([0.9, 1.0, 1.0], np.float32),
                 seeds=np.array([1234, 5, 0], np.int32))
    return (kv_j, dkv_j, J, kw_j), (kv_t, dkv_t, T, kw_t), state


P_MAX = 64


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("all_greedy", [True, False])
def test_spec_scan_two_rounds_matches_jax(model, paged, all_greedy):
    """Two rounds at spec_k 4 with the disagreeing draft: the port's
    toks, emits, accepted counts and carried state equal JAX's. Sampled
    rows use top-k and top-p, so their residuals max(p - q, 0) hold
    zeros (the log's 1e-38 floor is subnormal in f32)."""
    (kv_j, dkv_j, J, kw_j), (kv_t, dkv_t, T, kw_t), st = scan_state(
        model, paged)
    if all_greedy:
        st["temperature"] = np.zeros(3, np.float32)
    kw = dict(spec_k=4, n_rounds=2, all_greedy=all_greedy, max_ctx=P_MAX)
    order = ("tokens", "cache_len", "active", "positions", "budget",
             "stop_ids", "temperature", "top_k", "top_p", "seeds")
    sj = {k: jnp.asarray(st[k]) for k in order}
    s_t = {k: torch.from_numpy(np.asarray(st[k]).copy()) for k in order}
    if paged:
        cj, tj, ej, aj = japi.decode_spec_fused_paged(
            model["jcfg"], model["jparams"], model["jdcfg"],
            model["jdparams"], sj["tokens"], kv_j, J["table"], dkv_j,
            *(sj[k] for k in order[1:]), **kw, **kw_j)
        ct, tt, et, at = api.decode_spec_fused_paged(
            model["cfg"], model["params"], model["dcfg"], model["dparams"],
            s_t["tokens"], kv_t, T["table"], dkv_t,
            *(s_t[k] for k in order[1:]), **kw, **kw_t)
    else:
        cj, tj, ej, aj = japi.decode_spec_fused(
            model["jcfg"], model["jparams"], model["jdcfg"],
            model["jdparams"], sj["tokens"], kv_j, dkv_j,
            *(sj[k] for k in order[1:]), **kw, **kw_j)
        ct, tt, et, at = api.decode_spec_fused(
            model["cfg"], model["params"], model["dcfg"], model["dparams"],
            s_t["tokens"], kv_t, dkv_t, *(s_t[k] for k in order[1:]),
            **kw, **kw_t)
    assert tt.shape == (10, 3) and tt.dtype == torch.int32
    assert np.array_equal(tt.numpy(), np.asarray(tj))
    assert np.array_equal(et.numpy(), np.asarray(ej))
    assert np.array_equal(at.numpy(), np.asarray(aj))
    for name, t, j in zip(("tokens", "cache_len", "active", "positions"),
                          (ct[0], ct[3], ct[4], ct[5]),
                          (cj[0], cj[3], cj[4], cj[5])):
        assert np.array_equal(bridge.to_numpy(t), np.asarray(j)), name
    # A round emits its accepted drafts and one more token; row 0's
    # budget of 7 (from position 1) caps it at 6; row 2 never emits.
    em, acc = et.numpy(), at.numpy()
    assert not em[:, 2].any()
    assert em[:, 0].sum() == min(6, acc[:, 0].sum() + 2)
    if not all_greedy:
        # The sampled rows drafted and the rule rejected at least once.
        assert at.numpy()[:, :2].sum() < 2 * 2 * 4


def test_spec_api_gates():
    zcfg = get_config("zamba2-1.2b").reduced()
    cfg = get_config("chameleon-llama-7b").reduced()
    assert api.supports_spec_draft(cfg)
    assert not api.supports_spec_draft(zcfg)
    with pytest.raises(NotImplementedError, match="speculative draft"):
        api.decode_spec_fused(cfg, {}, zcfg, {}, *([None] * 12), spec_k=1,
                              n_rounds=1, all_greedy=True, max_ctx=8)
    with pytest.raises(NotImplementedError, match="target family"):
        api.decode_spec_fused_paged(zcfg, {}, cfg, {}, *([None] * 13),
                                    spec_k=1, n_rounds=1, all_greedy=True,
                                    max_ctx=8)
    with pytest.raises(NotImplementedError, match="paged verify"):
        api.verify_paged(zcfg, {}, None, None, None, None)


# ------------------------------------------------- rule, config, gauges
def test_rejection_rule_preserves_target_distribution():
    """Emitting draft d ~ q with probability min(1, p/q) and otherwise
    resampling the port's residual (``lm._spec_residual``, the scan's
    own) yields exactly p; the residual equals the pure-Python oracle
    of ``core.sampling``; p == q falls back to p."""
    from repro_torch.core.sampling import spec_residual_reference
    rng = np.random.default_rng(0)
    for _ in range(50):
        v = int(rng.integers(2, 12))
        p = rng.dirichlet(np.ones(v))
        q = rng.dirichlet(np.ones(v))
        res = lm._spec_residual(torch.from_numpy(p),
                                torch.from_numpy(q)).numpy()
        np.testing.assert_allclose(res, spec_residual_reference(
            list(p), list(q)), atol=1e-12)
        accept = np.minimum(1.0, p / np.maximum(q, 1e-30))
        reject_mass = float(np.sum(q * (1.0 - accept)))
        np.testing.assert_allclose(q * accept + reject_mass * res, p,
                                   atol=1e-12)
    p = rng.dirichlet(np.ones(8))
    np.testing.assert_allclose(
        lm._spec_residual(torch.from_numpy(p), torch.from_numpy(p)).numpy(),
        p, atol=1e-12)


def jax_and_port_errors(draft_pair, **knobs):
    """Build a JAX and a port spec engine that must refuse; returns the
    two ValueErrors. ``draft_pair``: (JAX draft, port draft) or None."""
    from _port_serving import ENGINE, models
    from repro.serving import engine as jengine
    from repro_torch.serving import engine
    m = models()
    kw = {**ENGINE, **knobs, "spec_decode": True}
    jd, td = draft_pair if draft_pair else (None, None)
    with pytest.raises(ValueError) as je:
        jengine.ChameleonEngine(m["jcfg"], m["jparams"],
                                jengine.EngineConfig(**kw),
                                catalog=m["jcat"], draft=jd)
    with pytest.raises(ValueError) as te:
        engine.ChameleonEngine(m["cfg"], m["params"],
                               engine.EngineConfig(**kw), catalog=m["cat"],
                               draft=td, device="cpu")
    return str(je.value), str(te.value)


def test_non_dense_draft_raises_at_construction():
    zj = jget_config("zamba2-1.2b").reduced()
    zt = get_config("zamba2-1.2b").reduced()
    want, got = jax_and_port_errors(((zj, {}), (zt, {})))
    assert got == want
    assert "zamba2" in got and zt.family.name in got
    assert "supports_spec_draft" in got and "internlm2-1.8b" in got


def test_non_dense_draft_by_name_raises():
    want, got = jax_and_port_errors(None, spec_draft="zamba2-1.2b")
    assert got == want and "dense draft" in got


def test_vocab_mismatch_raises():
    from _port_serving import draft_models
    (jd, _), (td, _) = draft_models()
    want, got = jax_and_port_errors(
        ((jd.reduced(n_layers=2, vocab_size=jd.vocab_size // 2), {}),
         (td.reduced(n_layers=2, vocab_size=td.vocab_size // 2), {})))
    assert got == want and "vocab_size" in got


def test_bad_spec_k_raises():
    from _port_serving import draft_models
    want, got = jax_and_port_errors(draft_models(), spec_k=0)
    assert got == want and "spec_k" in got


def test_nonfused_engine_warns_and_runs_nonspec():
    """spec in the seed loop is unsupported: the port warns once at
    construction, runs without speculation, and its tokens equal the
    JAX engine's (which warns too) and its own plain seed loop's."""
    from _port_serving import serve_trace, spec_engines, spec_trace
    with pytest.warns(RuntimeWarning, match="spec_decode"):
        (jeng, jclock), (eng, clock) = spec_engines(fused_hotloop=False)
    assert not eng.spec and not jeng.spec
    specs = spec_trace(n=3, seed=2)
    got = [h.tokens for h in serve_trace(eng, clock, specs)]
    assert got == [h.tokens for h in serve_trace(jeng, jclock, specs)]
    _, (ref, rclock) = spec_engines(spec=False, draft=None,
                                    fused_hotloop=False)
    assert got == [h.tokens for h in serve_trace(ref, rclock, specs)]
    assert eng.spec_stats() == {}


def test_unported_family_raises_naming_the_family():
    """The JAX engine warns that a hybrid SSM family has no fused path
    and runs the seed loop; the port does not serve the family at all
    and says so at construction."""
    from _port_serving import ENGINE
    from repro_torch.serving import engine
    zcfg = get_config("zamba2-1.2b").reduced()
    assert not api.supports_fused(zcfg)
    assert not japi.supports_fused(jget_config("zamba2-1.2b").reduced())
    with pytest.raises(NotImplementedError, match="model family HYBRID"):
        engine.ChameleonEngine(zcfg, {}, engine.EngineConfig(
            **ENGINE, fused_hotloop=True), device="cpu")


def test_spec_off_emits_no_gauges():
    from _port_serving import spec_engines
    (jeng, _), (eng, _) = spec_engines(spec=False, draft=None)
    assert eng.spec_stats() == jeng.spec_stats() == {}
    assert "spec_accept_rate" not in eng.stats()
    assert "spec_accept_rate" not in eng.metrics().sched_stats


def test_draft_mirror_freed_on_migration():
    """A request exported from a speculative engine frees its slot's
    draft mirror with the slot (``complete_migration``), so the next
    occupant's catch-up replays its whole context; the importing
    engine's catch-up then syncs the imported request from 0."""
    from _port_serving import core_classes, spec_engines, step_once
    _, (src, clock) = spec_engines()
    req_cls, _ = core_classes(src)
    req = req_cls(input_len=12, output_len=30, adapter_id=1)
    h = src.submit(req)
    while len(h.tokens) < 6:
        step_once(src, clock)
    slot = next(i for i, r in enumerate(src.slot_req) if r is req)
    assert src._draft_len[slot] > 0
    ship = src.begin_migration(req)
    src.complete_migration(req)
    assert int(np.sum(src._draft_len)) == 0
    _, (dst, dclock) = spec_engines()
    assert dst.import_request_kv(ship)
    h._system = dst
    while dst.busy():
        step_once(dst, dclock)
    assert h.state.name == "FINISHED" and len(h.tokens) == 30
    assert dst.spec_stats()["spec_drafted_tokens"] > 0
    assert int(np.sum(dst._draft_len)) == 0
