"""Port layers and the paged dense LM on the CPU vs the JAX package.

The same weights go to both sides: the JAX package's ``init_params``
and LoRA slot buffers (reduced Llama, f32) reach the port through
``repro_torch.bridge``. Step functions are compared on logits and on
the KV pages they write (page 0, the trash page that padded rows
scatter into in no fixed order, is left out) at 1e-4, for both LoRA
backends; the K=8 fused greedy horizon must give identical tokens; the
sampler's noise-free core, fed JAX's own Gumbel draws, must pick the
same tokens as ``lm.sample_tokens``.
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
from repro.models.lora_apply import (  # noqa: E402
    init_lora_slots as jinit_slots, random_lora_weights as jrandom_lora,
    write_adapter_to_slot as jwrite_slot)
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
R_MAX = 32
RANKS = (8, 16, 32)
PAGE = 16


def close(port, ref, **kw):
    np.testing.assert_allclose(bridge.to_numpy(port),
                               np.asarray(ref, np.float32), **(kw or TOL))


def pair(a, dtype=np.float32):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("chameleon-llama-7b").reduced()
    cfg = get_config("chameleon-llama-7b").reduced()
    params = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    slots = jinit_slots(jax.random.PRNGKey(1), len(RANKS), jcfg.n_layers,
                        jcfg.d_model, jcfg.q_dim, jcfg.kv_dim, R_MAX,
                        dtype=jnp.float32)
    for i, rank in enumerate(RANKS):
        w = jrandom_lora(jax.random.PRNGKey(100 + i), rank, R_MAX,
                         jcfg.n_layers, jcfg.d_model, jcfg.q_dim,
                         jcfg.kv_dim, dtype=jnp.float32)
        slots = jwrite_slot(slots, w, i)
    return dict(jcfg=jcfg, cfg=cfg, jparams=params, jslots=slots,
                params=bridge.params_to_torch(params, "cpu"),
                slots=bridge.lora_to_torch(slots, "cpu"))


class TestLayers:
    def test_rms_norm(self):
        rng = np.random.default_rng(0)
        xj, xt = pair(rng.standard_normal((2, 5, 64)))
        wj, wt = pair(rng.standard_normal(64))
        close(layers.rms_norm(xt, wt), jlayers.rms_norm(xj, wj),
              rtol=1e-6, atol=1e-6)

    def test_apply_rope(self):
        rng = np.random.default_rng(1)
        xj, xt = pair(rng.standard_normal((2, 6, 4, 32)))
        pos = np.array([[0, 1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12]])
        cj, sj = jlayers.rope_cos_sin(jnp.asarray(pos), 32, 1e4)
        ct, st = layers.rope_cos_sin(torch.from_numpy(pos), 32, 1e4)
        close(ct, cj, rtol=1e-6, atol=1e-6)
        close(layers.apply_rope(xt, ct, st), jlayers.apply_rope(xj, cj, sj),
              rtol=1e-5, atol=1e-5)

    def test_suffix_attention(self):
        rng = np.random.default_rng(2)
        qj, qt = pair(rng.standard_normal((2, 5, 4, 32)))
        kj, kt = pair(rng.standard_normal((2, 24, 2, 32)))
        vj, vt = pair(rng.standard_normal((2, 24, 2, 32)))
        pos = np.array([[3, 4, 5, 6, 7], [16, 17, 18, 19, 20]])
        close(layers.suffix_attention(qt, kt, vt, torch.from_numpy(pos)),
              jlayers.suffix_attention(qj, kj, vj, jnp.asarray(pos)),
              rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("Sq,Sk,causal,q_offset,kv_len", [
        (5, 5, True, 0, None),          # plain causal prefill
        (3, 12, True, 9, None),         # causal at an offset
        (1, 16, False, 0, [7, 16]),     # padded decode cache
        (2048, 2048, True, 0, None),    # query-chunked path
    ])
    def test_gqa_attention(self, Sq, Sk, causal, q_offset, kv_len):
        rng = np.random.default_rng(Sq + Sk)
        B, H, Kh, D = 2, 4, 2, 8
        qj, qt = pair(rng.standard_normal((B, Sq, H, D)))
        kj, kt = pair(rng.standard_normal((B, Sk, Kh, D)))
        vj, vt = pair(rng.standard_normal((B, Sk, Kh, D)))
        lj, lt = (None, None) if kv_len is None else pair(kv_len, np.int32)
        close(layers.gqa_attention(qt, kt, vt, causal, q_offset, lt),
              jlayers.gqa_attention(qj, kj, vj, causal, q_offset, lj),
              rtol=1e-5, atol=1e-5)
        if Sq == 1:
            close(layers.decode_attention(qt, kt, vt, lt),
                  jlayers.decode_attention(qj, kj, vj, lj),
                  rtol=1e-5, atol=1e-5)

    def test_gelu_mlp_and_embed(self):
        rng = np.random.default_rng(5)
        xj, xt = pair(rng.standard_normal((2, 3, 64)))
        uj, ut = pair(rng.standard_normal((64, 96)) * 0.1)
        dj, dt = pair(rng.standard_normal((96, 64)) * 0.1)
        close(layers.gelu_mlp(xt, ut, dt), jlayers.gelu_mlp(xj, uj, dj),
              rtol=1e-5, atol=1e-5)
        tj, tt = pair(rng.standard_normal((50, 16)))
        ij, it = pair(rng.integers(0, 50, (2, 7)), np.int32)
        close(layers.embed(it, tt), jlayers.embed(ij, tj), rtol=0, atol=0)

    def test_swiglu(self):
        rng = np.random.default_rng(3)
        xj, xt = pair(rng.standard_normal((2, 3, 64)))
        ws = [pair(rng.standard_normal(s) * 0.1)
              for s in ((64, 96), (64, 96), (96, 64))]
        close(layers.swiglu(xt, *(w[1] for w in ws)),
              jlayers.swiglu(xj, *(w[0] for w in ws)), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("dt", ["f32", "bf16"])
    def test_unembed_f32_logits(self, dt):
        rng = np.random.default_rng(4)
        jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
        xj = jnp.asarray(rng.standard_normal((2, 1, 64)), jdt)
        tj = jnp.asarray(rng.standard_normal((64, 100)), jdt)
        got = layers.unembed(bridge.to_torch(xj, "cpu"),
                             bridge.to_torch(tj, "cpu"))
        assert got.dtype == torch.float32
        close(got, jlayers.unembed(xj, tj), rtol=1e-5, atol=1e-5)


def prefill_case(model, backend):
    """Two suffix prefills into the same pages — a miss batch, then a
    prefix-hit batch continuing those rows — then one decode step,
    on both sides. Returns [(what, port, jax), ...]."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    rng = np.random.default_rng(7)
    B, P = 3, 4
    n_pages = 1 + B * P
    table = (1 + np.arange(B * P)).reshape(B, P).astype(np.int32)
    table[2, 3] = 0      # row 2 maps only 3 pages; its tail is trash
    kv_j = jlm.make_paged_kv(jcfg, n_pages, PAGE, jnp.float32)
    kv_t = lm.make_paged_kv(cfg, n_pages, PAGE, torch.float32,
                            device="cpu")
    idx = np.array([2, 0, 1], np.int32)
    kw_j = dict(lora=model["jslots"], adapter_idx=jnp.asarray(idx),
                lora_backend=backend)
    kw_t = dict(lora=model["slots"], adapter_idx=torch.from_numpy(idx),
                lora_backend=backend)
    out = []
    lens = np.zeros(B, np.int32)
    for S, seq_len in ((16, [16, 9, 5]), (32, [20, 32, 1])):
        seq_len = np.asarray(seq_len, np.int32)
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        args = [(jnp.asarray(a), torch.from_numpy(a))
                for a in (toks, table, lens, seq_len)]
        lj, kv_j = jlm.prefill_paged(jcfg, model["jparams"], args[0][0],
                                     kv_j, args[1][0], args[2][0],
                                     args[3][0], **kw_j)
        lt, kv_t = lm.prefill_paged(cfg, model["params"], args[0][1], kv_t,
                                    args[1][1], args[2][1], args[3][1],
                                    **kw_t)
        out.append((f"prefill S={S} logits", lt, lj))
        lens = lens + seq_len
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    lj, kv_j = jlm.decode_step_paged(jcfg, model["jparams"], jnp.asarray(tok),
                                     kv_j, jnp.asarray(table),
                                     jnp.asarray(lens), **kw_j)
    lt, kv_t = lm.decode_step_paged(cfg, model["params"],
                                    torch.from_numpy(tok), kv_t,
                                    torch.from_numpy(table),
                                    torch.from_numpy(lens), **kw_t)
    out.append(("decode logits", lt, lj))
    for name, pt, pj in zip("kv", kv_t, kv_j):
        out.append((f"{name} pages", pt[:, 1:], np.asarray(pj)[:, 1:]))
    return out


class TestPagedLM:
    @pytest.mark.parametrize("backend", ["einsum", "kernel"])
    def test_prefill_and_decode_match_jax(self, model, backend):
        for what, port, ref in prefill_case(model, backend):
            close(port, ref, err_msg=f"{backend}: {what}", **TOL)

    def test_fused_greedy_horizon_tokens_identical(self, model):
        cfg, jcfg = model["cfg"], model["jcfg"]
        rng = np.random.default_rng(9)
        B, P, K = 3, 4, 8
        table = (1 + np.arange(B * P)).reshape(B, P).astype(np.int32)
        seq_len = np.array([20, 7, 13], np.int32)
        toks = rng.integers(0, cfg.vocab_size, (B, 32)).astype(np.int32)
        kv_j = jlm.make_paged_kv(jcfg, 1 + B * P, PAGE, jnp.float32)
        kv_t = lm.make_paged_kv(cfg, 1 + B * P, PAGE, torch.float32,
                                device="cpu")
        idx = np.array([1, 2, 0], np.int32)
        zero = np.zeros(B, np.int32)
        lj, kv_j = jlm.prefill_paged(
            jcfg, model["jparams"], jnp.asarray(toks), kv_j,
            jnp.asarray(table), jnp.asarray(zero), jnp.asarray(seq_len),
            lora=model["jslots"], adapter_idx=jnp.asarray(idx))
        lt, kv_t = lm.prefill_paged(
            cfg, model["params"], torch.from_numpy(toks), kv_t,
            torch.from_numpy(table), torch.from_numpy(zero),
            torch.from_numpy(seq_len), lora=model["slots"],
            adapter_idx=torch.from_numpy(idx))
        first = np.array(jnp.argmax(lj, -1), np.int32)
        assert np.array_equal(bridge.to_numpy(torch.argmax(lt, -1)), first)
        active = np.array([True, True, False])
        budget = np.array([6, 20, 20], np.int32)  # row 0 stops mid-horizon
        stop = np.full((B, 0), -1, np.int32)
        f32 = np.zeros(B, np.float32)
        args = dict(tokens=first[:, None], cache_len=seq_len, active=active,
                    positions=np.ones(B, np.int32), budget=budget,
                    stop_ids=stop, temperature=f32,
                    top_k=np.zeros(B, np.int32), top_p=f32 + 1,
                    seeds=np.zeros(B, np.int32))
        carry_j, toks_j, emits_j = jlm.decode_fused_paged(
            jcfg, model["jparams"], kv_pages=kv_j,
            page_table=jnp.asarray(table),
            **{k: jnp.asarray(v) for k, v in args.items()}, n_steps=K,
            all_greedy=True, max_ctx=P * PAGE, lora=model["jslots"],
            adapter_idx=jnp.asarray(idx))
        carry_t, toks_t, emits_t = lm.decode_fused_paged(
            cfg, model["params"], kv_pages=kv_t,
            page_table=torch.from_numpy(table),
            **{k: torch.from_numpy(v) for k, v in args.items()}, n_steps=K,
            all_greedy=True, max_ctx=P * PAGE, lora=model["slots"],
            adapter_idx=torch.from_numpy(idx))
        assert np.array_equal(bridge.to_numpy(toks_t), np.asarray(toks_j))
        assert np.array_equal(bridge.to_numpy(emits_t), np.asarray(emits_j))
        assert not bridge.to_numpy(emits_t)[6:, 0].any()
        for name, t, j in zip(("cache_len", "active", "positions"),
                              (carry_t[2], carry_t[3], carry_t[4]),
                              (carry_j[2], carry_j[3], carry_j[4])):
            assert np.array_equal(bridge.to_numpy(t), np.asarray(j)), name


def jax_gumbel(seeds, positions, V):
    keys = jax.vmap(lambda s, p: jax.random.fold_in(
        jax.random.PRNGKey(s), p))(jnp.asarray(seeds, jnp.uint32),
                                   jnp.asarray(positions, jnp.uint32))
    return np.array(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys))


class TestSampler:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_core_matches_jax_on_jax_noise(self, seed):
        rng = np.random.default_rng(seed)
        B, V = 8, 512
        # One decimal place: many exact ties inside each row.
        logits = np.round(rng.standard_normal((B, V)) * 2, 1)
        logits = logits.astype(np.float32)
        temp = np.array([0, 0.7, 1.0, 0.5, 1.3, 0.9, 2.0, 0.8], np.float32)
        top_k = np.array([0, 5, 0, 20, 3, 0, 1, 50], np.int32)
        top_p = np.array([1, 1, 0.8, 0.9, 1, 0.5, 1, 0.3], np.float32)
        seeds = rng.integers(0, 2**31, B).astype(np.uint32)
        pos = rng.integers(0, 300, B).astype(np.int32)
        want = jlm.sample_tokens(*(jnp.asarray(a) for a in
                                   (logits, temp, top_k, top_p, seeds, pos)))
        got = lm.sample_tokens_core(
            *(torch.from_numpy(a) for a in (logits, temp, top_k, top_p)),
            torch.from_numpy(jax_gumbel(seeds, pos, V)))
        assert np.array_equal(bridge.to_numpy(got), np.asarray(want))

    def test_port_noise_depends_on_seed_and_position_only(self):
        seeds = torch.tensor([5, 9, 5], dtype=torch.int64)
        pos = torch.tensor([3, 3, 3], dtype=torch.int32)
        g = lm.gumbel_noise(seeds, pos, 4096)
        assert torch.isfinite(g).all()
        assert torch.equal(g[0], g[2]) and not torch.equal(g[0], g[1])
        alone = lm.gumbel_noise(seeds[1:2], pos[1:2], 4096)
        assert torch.equal(alone[0], g[1])
        # Gumbel(0, 1): mean is Euler's constant.
        assert abs(g.mean().item() - 0.5772) < 0.05
