"""The port's MoE and VLM model functions on the CPU vs the JAX package.

Same inputs on both sides, drawn from numpy seeds (weights from the JAX
package's ``init_params``, through the bridge), f32 throughout:

- ``moe.route``: expert indices equal, weights and the aux loss within
  1e-6, also where router probabilities tie exactly (``jax.lax.top_k``
  puts the lower index first; the port must too).
- ``moe.moe_block`` (capacity buckets): output within 1e-4 of JAX's,
  in one group and in two, with and without drops; where capacity
  drops assignments, the kept/dropped pattern equals the one JAX's
  cumsum rank gives, and drops do occur. ``moe_block_gather``
  (dropless decode) within 1e-4.
- ``lm._moe`` with (llama4) and without (qwen3-moe) a shared expert,
  prefill and decode shapes, within 1e-4.
- ``forward``, ``prefill`` (logits and K/V), ``decode_step`` over the
  slab it fills and ``decode_fused`` (greedy tokens, emits, K/V) for
  reduced ``qwen3-moe-235b-a22b`` (top-2, MoE every layer, qk-norm) and
  ``llama4-maverick-400b-a17b`` (top-1, MoE every second layer, shared
  expert), LoRA on q/k/v/o, within 1e-4.
- ``layers.mrope_cos_sin`` and reduced ``qwen2-vl-7b`` ``forward``,
  ``prefill`` and ``decode_step`` with distinct t/h/w positions, within
  1e-4; a missing ``mrope_pos`` raises JAX's assertion message.
- The port's ``init_params`` and the bridge cover ``moe/*`` and
  ``dense_mlp/*`` with JAX's shapes; the api gates of JAX hold.
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
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.lora_apply import (  # noqa: E402
    init_lora_slots as jinit_slots, random_lora_weights as jrandom_lora,
    write_adapter_to_slot as jwrite_slot)
from _port_serving import models  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api, layers, lm, moe  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
TOL_ROUTE = dict(rtol=1e-6, atol=1e-6)
MOE_CONFIGS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
RANKS = (8, 16, 32)
R_MAX = 32


def close(port, ref, **kw):
    np.testing.assert_allclose(bridge.to_numpy(port),
                               np.asarray(ref, np.float32), **(kw or TOL))


def both(a):
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.fixture(scope="module", params=MOE_CONFIGS)
def moe_model(request):
    m = dict(models(request.param))
    jcfg = m["jcfg"]
    slots = jinit_slots(jax.random.PRNGKey(1), len(RANKS), jcfg.n_layers,
                        jcfg.d_model, jcfg.q_dim, jcfg.kv_dim, R_MAX,
                        dtype=jnp.float32)
    for i, rank in enumerate(RANKS):
        slots = jwrite_slot(slots, jrandom_lora(
            jax.random.PRNGKey(100 + i), rank, R_MAX, jcfg.n_layers,
            jcfg.d_model, jcfg.q_dim, jcfg.kv_dim, dtype=jnp.float32), i)
    m.update(jslots=slots, slots=bridge.lora_to_torch(slots, "cpu"))
    return m


def expert_weights(rng, E, D, F):
    """Router and expert weights at the JAX init's scale, (j, t) pairs."""
    return [both((rng.standard_normal(s) / np.sqrt(s[-2]))
                 .astype(np.float32))
            for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]


# ---------------------------------------------------------------- routing
class TestRoute:
    @pytest.mark.parametrize("top_k", [1, 2, 8])
    def test_route_matches_jax(self, top_k):
        rng = np.random.default_rng(0)
        xj, xt = both(rng.standard_normal((3, 7, 64)).astype(np.float32))
        wj, wt = both(rng.standard_normal((64, 16)).astype(np.float32))
        w_j, i_j, a_j = jmoe.route(xj, wj, top_k)
        w_t, i_t, a_t = moe.route(xt, wt, top_k)
        assert np.array_equal(i_t.numpy(), np.asarray(i_j))
        close(w_t, w_j, **TOL_ROUTE)
        close(a_t, a_j, **TOL_ROUTE)

    def test_route_ties_put_the_lower_expert_first(self):
        """All probabilities tie for the zero router; experts 1, 4 and 6
        tie for the other (equal router columns), and the lower wins."""
        rng = np.random.default_rng(1)
        xj, xt = both(rng.standard_normal((2, 5, 32)).astype(np.float32))
        w = rng.standard_normal((32, 8)).astype(np.float32)
        w[:, 4] = w[:, 6] = w[:, 1] = 3.0 * np.abs(w[:, 1])
        xj, xt = both(np.abs(np.asarray(xj)))
        for router in (np.zeros((32, 8), np.float32), w):
            rj, rt = both(router)
            w_j, i_j, a_j = jmoe.route(xj, rj, 2)
            w_t, i_t, a_t = moe.route(xt, rt, 2)
            assert np.array_equal(i_t.numpy(), np.asarray(i_j))
            close(w_t, w_j, **TOL_ROUTE)
            close(a_t, a_j, **TOL_ROUTE)
        assert (i_t.numpy() == [1, 4]).all()
        assert (moe.route(xt, torch.zeros(32, 8), 3)[1].numpy()
                == [0, 1, 2]).all()


# ---------------------------------------------------------------- blocks
def jax_keep(idx, E, cap, G):
    """The kept mask of ``jmoe.moe_block`` (its cumsum rank, lines
    computing ``pos`` and ``keep``), from JAX's own routing."""
    flat = idx.reshape(G, -1)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - 1) * onehot, axis=-1)
    return np.asarray(pos < cap)


class TestBlocks:
    @pytest.mark.parametrize("group_size,cf,skew", [
        (2048, 1.25, 0.0),       # one group, random routing
        (16, 1.25, 0.0),         # two groups
        (2048, 0.5, 2.0),        # skewed routing over a small capacity
        (16, 1.0, 2.0)])
    def test_moe_block_matches_jax(self, group_size, cf, skew):
        rng = np.random.default_rng(2)
        B, S, D, E, F, K = 2, 16, 32, 8, 24, 2
        xj, xt = both(rng.standard_normal((B, S, D)).astype(np.float32))
        (rj, rt), (gj, gt), (uj, ut), (dj, dt) = expert_weights(rng, E, D, F)
        if skew:
            # Pull every token towards experts 0 and 1: over capacity.
            r = np.asarray(rj).copy()
            r[:, :2] += skew * np.asarray(xj).mean(axis=(0, 1))[:, None]
            rj, rt = both(r)
        yj, aj = jmoe.moe_block(xj, rj, gj, uj, dj, K, cf, group_size)
        yt, at = moe.moe_block(xt, rt, gt, ut, dt, K, cf, group_size)
        close(yt, yj)
        close(at, aj, **TOL_ROUTE)
        T = B * S
        Tg = min(group_size, T)
        cap = moe._capacity(Tg, E, K, cf)
        _, i_j, _ = jmoe.route(xj, rj, K)
        _, i_t, _ = moe.route(xt, rt, K)
        G = T // Tg
        _, keep = moe.capacity_slots(i_t.reshape(G, -1), E, cap)
        want = jax_keep(i_j, E, cap, G)
        assert np.array_equal(keep.numpy(), want)
        if skew:
            assert (~want).any(), "the case was meant to drop assignments"

    def test_moe_block_counts_drops(self):
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal((1, 8, 16))
                             .astype(np.float32))
        router = torch.zeros(16, 4)          # every token: experts 0, 1
        w = [torch.ones(4, 16, 8), torch.ones(4, 16, 8), torch.ones(4, 8, 16)]
        moe.STATS.reset()
        moe.moe_block(x, router, *w, 2, capacity_factor=1.0)
        # cap = 8*2/4 = 4 slots of experts 0 and 1 for 8 tokens each.
        assert (moe.STATS.assignments, moe.STATS.dropped) == (16, 8)
        moe.moe_block_gather(x[:, :1], router, *w, 2)
        assert (moe.STATS.gather_calls, moe.STATS.experts_read) == (1, 2)

    @pytest.mark.parametrize("B,top_k", [(1, 1), (5, 2), (8, 8)])
    def test_moe_block_gather_matches_jax(self, B, top_k):
        rng = np.random.default_rng(4)
        D, E, F = 32, 16, 24
        xj, xt = both(rng.standard_normal((B, 1, D)).astype(np.float32))
        (rj, rt), (gj, gt), (uj, ut), (dj, dt) = expert_weights(rng, E, D, F)
        yj, aj = jmoe.moe_block_gather(xj, rj, gj, uj, dj, top_k)
        yt, at = moe.moe_block_gather(xt, rt, gt, ut, dt, top_k)
        close(yt, yj)
        close(at, aj, **TOL_ROUTE)

    @pytest.mark.parametrize("name", MOE_CONFIGS)
    @pytest.mark.parametrize("S", [1, 12])
    def test_moe_layer_matches_jax(self, name, S):
        """``lm._moe`` on layer 0's MoE weights: the gather block at
        S == 1, the capacity block otherwise; llama4 adds its shared
        expert."""
        m = models(name)
        assert bool(m["cfg"].shared_expert_ff) == ("llama4" in name)
        rng = np.random.default_rng(5)
        xj, xt = both(rng.standard_normal((3, S, m["cfg"].d_model))
                      .astype(np.float32))
        pj = {k[4:]: v[0] for k, v in m["jparams"].items()
              if k.startswith("moe/")}
        pt = {k[4:]: v[0] for k, v in m["params"].items()
              if k.startswith("moe/")}
        yj, aj = jlm._moe(m["jcfg"], xj, pj)
        yt, at = lm._moe(m["cfg"], xt, pt)
        close(yt, yj)
        close(at, aj, **TOL_ROUTE)


# ----------------------------------------------------------- model paths
class TestMoeModel:
    def test_step_functions_match_jax(self, moe_model):
        """Right-padded prefill (logits, K/V), its K/V into a slab, one
        decode step; ``forward`` over the same prompts."""
        m = moe_model
        cfg, jcfg = m["cfg"], m["jcfg"]
        rng = np.random.default_rng(6)
        B, S, Smax = 3, 16, 24
        lens = np.array([16, 9, 5], np.int32)
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        idx = np.array([2, 0, 1], np.int32)
        kw_j = dict(lora=m["jslots"], adapter_idx=jnp.asarray(idx))
        kw_t = dict(lora=m["slots"], adapter_idx=torch.from_numpy(idx))
        tj, tt = both(toks)
        lj_, lt_ = both(lens - 1)
        lj, (kj, vj) = jlm.prefill(jcfg, m["jparams"], tj, last_pos=lj_,
                                   **kw_j)
        lt, (kt, vt) = api.prefill(cfg, m["params"], tt, last_pos=lt_,
                                   **kw_t)
        close(lt, lj)
        close(kt, kj)
        close(vt, vj)
        slab_j = [jnp.zeros((cfg.n_layers, B, Smax, cfg.n_kv_heads,
                             cfg.head_dim), jnp.float32) for _ in range(2)]
        slab_t = list(api.init_serve_state(cfg, B, Smax, torch.float32,
                                           device="cpu"))
        for b, L in enumerate(lens):
            slab_j = [s.at[:, b, :L].set(n[:, b, :L])
                      for s, n in zip(slab_j, (kj, vj))]
            for s, n in zip(slab_t, (kt, vt)):
                s[:, b, :L] = n[:, b, :L]
        t1j, t1t = both(rng.integers(0, cfg.vocab_size, (B, 1))
                        .astype(np.int32))
        cj, ct = both(lens)
        dj, slab_j = jlm.decode_step(jcfg, m["jparams"], t1j, tuple(slab_j),
                                     cj, **kw_j)
        dt, slab_t = api.decode_step(cfg, m["params"], t1t, tuple(slab_t),
                                     ct, **kw_t)
        close(dt, dj)
        for t, j in zip(slab_t, slab_j):
            close(t, j)
        close(api.forward(cfg, m["params"], tt),
              jlm.forward(jcfg, m["jparams"], tj))

    def test_fused_horizon_matches_jax(self, moe_model):
        """K=6 greedy horizon over a random slab, one row stopping on
        its budget mid-horizon and one inactive."""
        m = moe_model
        cfg, jcfg = m["cfg"], m["jcfg"]
        rng = np.random.default_rng(7)
        B, K, Smax = 3, 6, 32
        slab_np = [rng.standard_normal((cfg.n_layers, B, Smax,
                                        cfg.n_kv_heads, cfg.head_dim))
                   .astype(np.float32) for _ in range(2)]
        slab_j = tuple(jnp.asarray(a) for a in slab_np)
        slab_t = tuple(torch.from_numpy(a.copy()) for a in slab_np)
        f32 = np.zeros(B, np.float32)
        args = dict(tokens=rng.integers(0, cfg.vocab_size, (B, 1))
                    .astype(np.int32),
                    cache_len=np.array([11, 20, 7], np.int32),
                    active=np.array([True, True, False]),
                    positions=np.ones(B, np.int32),
                    budget=np.array([4, 20, 20], np.int32),
                    stop_ids=np.full((B, 0), -1, np.int32),
                    temperature=f32, top_k=np.zeros(B, np.int32),
                    top_p=f32 + 1, seeds=np.zeros(B, np.int32))
        idx = np.array([1, 2, 0], np.int32)
        carry_j, toks_j, emits_j = jlm.decode_fused(
            jcfg, m["jparams"], kv_caches=slab_j,
            **{k: jnp.asarray(v) for k, v in args.items()}, n_steps=K,
            all_greedy=True, max_ctx=Smax, lora=m["jslots"],
            adapter_idx=jnp.asarray(idx))
        carry_t, toks_t, emits_t = api.decode_fused(
            cfg, m["params"], kv_caches=slab_t,
            **{k: torch.from_numpy(v) for k, v in args.items()}, n_steps=K,
            all_greedy=True, max_ctx=Smax, lora=m["slots"],
            adapter_idx=torch.from_numpy(idx))
        assert np.array_equal(toks_t.numpy(), np.asarray(toks_j))
        assert np.array_equal(emits_t.numpy(), np.asarray(emits_j))
        for t, j in zip(carry_t[1], carry_j[1]):
            close(t, j)

    @pytest.mark.parametrize("name", MOE_CONFIGS)
    def test_params_cover_moe_stacks(self, name):
        """The port's init and the bridge give JAX's paths and shapes,
        ``moe/*`` and (llama4) ``dense_mlp/*`` included."""
        m = models(name)
        want = {k: tuple(v.shape) for k, v in m["jparams"].items()}
        got = lm.init_params(m["cfg"], 0, torch.float32, device="cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == want
        assert {k: tuple(v.shape) for k, v in m["params"].items()} == want
        assert any(k.startswith("moe/w_gate") for k in want)
        assert any(k.startswith("dense_mlp/") for k in want) == (
            m["cfg"].moe_every > 1)


# ------------------------------------------------------------------- VLM
def mrope_positions(B, S, start=0):
    """Distinct t/h/w positions: t counts, h and w wrap on a 4x4 grid."""
    t = start + np.arange(S)
    pos = np.stack([t, t // 4, t % 4])
    return np.broadcast_to(pos[:, None], (3, B, S)).astype(np.int32)


class TestVlm:
    def test_mrope_cos_sin_matches_jax(self):
        pj, pt = both(mrope_positions(2, 9, start=3))
        for sections in ((4, 6, 6), (16, 24, 24)):
            head_dim = 2 * sum(sections)
            cj, sj = jlayers.mrope_cos_sin(pj, head_dim, 1e6, sections)
            ct, st = layers.mrope_cos_sin(pt, head_dim, 1e6, sections)
            close(ct, cj, rtol=1e-6, atol=1e-6)
            close(st, sj, rtol=1e-6, atol=1e-6)

    def test_vlm_model_paths_match_jax(self):
        m = models("qwen2-vl-7b")
        cfg, jcfg = m["cfg"], m["jcfg"]
        assert cfg.mrope and cfg.mrope_sections == jcfg.mrope_sections
        rng = np.random.default_rng(8)
        B, S, Smax = 2, 12, 16
        tj, tt = both(rng.integers(0, cfg.vocab_size, (B, S))
                      .astype(np.int32))
        mj, mt = both(mrope_positions(B, S))
        lj, (kj, vj) = jlm.prefill(jcfg, m["jparams"], tj, mrope_pos=mj)
        lt, (kt, vt) = api.prefill(cfg, m["params"], tt, mrope_pos=mt)
        close(lt, lj)
        close(kt, kj)
        close(vt, vj)
        close(api.forward(cfg, m["params"], tt, mrope_pos=mt),
              jlm.forward(jcfg, m["jparams"], tj, mrope_pos=mj))
        slab_j = tuple(jnp.zeros((cfg.n_layers, B, Smax, cfg.n_kv_heads,
                                  cfg.head_dim)).at[:, :, :S].set(n)
                       for n in (kj, vj))
        slab_t = api.init_serve_state(cfg, B, Smax, torch.float32,
                                      device="cpu")
        for s, n in zip(slab_t, (kt, vt)):
            s[:, :, :S] = n
        t1j, t1t = both(rng.integers(0, cfg.vocab_size, (B, 1))
                        .astype(np.int32))
        cj, ct = both(np.full(B, S, np.int32))
        m1j, m1t = both(mrope_positions(B, 1, start=S))
        dj, slab_j = jlm.decode_step(jcfg, m["jparams"], t1j, slab_j, cj,
                                     mrope_pos=m1j)
        dt, slab_t = api.decode_step(cfg, m["params"], t1t, slab_t, ct,
                                     mrope_pos=m1t)
        close(dt, dj)
        for t, j in zip(slab_t, slab_j):
            close(t, j)

    def test_missing_mrope_positions_raise_as_in_jax(self):
        m = models("qwen2-vl-7b")
        tj, tt = both(np.zeros((1, 4), np.int32))
        with pytest.raises(AssertionError) as ej:
            jlm.forward(m["jcfg"], m["jparams"], tj)
        with pytest.raises(AssertionError) as et:
            api.forward(m["cfg"], m["params"], tt)
        assert str(et.value) == str(ej.value)


# ------------------------------------------------------------------ gates
@pytest.mark.parametrize("name", MOE_CONFIGS + ("qwen2-vl-7b",))
def test_api_gates_match_jax(name):
    """MoE and VLM pass the model-function gates; fused decode takes MoE
    and not VLM, with JAX's message; paged KV takes neither, with JAX's
    message."""
    cfg, jcfg = get_config(name).reduced(), jget_config(name).reduced()
    assert api.supports_fused(cfg) == japi.supports_fused(jcfg)
    assert api.supports_paged(cfg) == japi.supports_paged(jcfg) is False
    state = api.init_serve_state(cfg, 2, 8, torch.float32, device="cpu")
    assert state[0].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                              cfg.head_dim)
    with pytest.raises(NotImplementedError) as et:
        api.init_paged_serve_state(cfg, 4, 16, device="cpu")
    with pytest.raises(NotImplementedError) as ej:
        japi.init_paged_serve_state(jcfg, 4, 16)
    assert str(et.value) == str(ej.value)
    if not api.supports_fused(cfg):
        z = torch.zeros(1)
        with pytest.raises(NotImplementedError) as et:
            api.decode_fused(cfg, {}, *([z] * 11), n_steps=1,
                             all_greedy=True, max_ctx=8)
        with pytest.raises(NotImplementedError) as ej:
            japi.decode_fused(jcfg, {}, *([None] * 11), n_steps=1,
                              all_greedy=True, max_ctx=8)
        assert str(et.value) == str(ej.value)
