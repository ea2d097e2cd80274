"""Port kernels on the CPU vs the JAX package's Pallas kernels.

The port's kernel wrappers run their plain PyTorch version on CPU
tensors; here each is held to the Pallas kernel it replaces, run in
interpret mode as ``tests/test_kernels.py`` runs it, over that file's
shape/dtype sweep and tolerances (2e-5 f32, 2e-2 bf16). The port's
``ref`` oracles are held to ``repro.kernels.ref`` the same way. Inputs
are drawn with numpy from a seed and handed to both sides.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bgmv import bgmv as jbgmv  # noqa: E402
from repro.kernels.paged_attention import \
    paged_attention as jpaged  # noqa: E402
from repro.kernels.sgmv import pack_segments as jpack  # noqa: E402
from repro.kernels.sgmv import sgmv as jsgmv  # noqa: E402
from repro_torch.bridge import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# The kernels package re-exports functions named like its submodules
# (as the JAX package does), so the modules are fetched by path.
bgmv_mod = importlib.import_module("repro_torch.kernels.bgmv")
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
pa_mod = importlib.import_module("repro_torch.kernels.paged_attention")
sgmv_mod = importlib.import_module("repro_torch.kernels.sgmv")

DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(a, dt):
    """One numpy array as a JAX array of dtype ``dt`` and the identical
    values as a tensor (bf16 rounding happens once, on the JAX side)."""
    j = jnp.asarray(a, DTYPES[dt])
    return j, to_torch(j, "cpu")


def close(port, jax_out, **kw):
    np.testing.assert_allclose(to_numpy(port),
                               np.asarray(jax_out, np.float32), **kw)


BGMV_SHAPES = [(1, 128, 8, 128, 2), (4, 256, 16, 384, 6),
               (8, 512, 64, 512, 3), (5, 128, 128, 256, 10)]
SGMV_SHAPES = [(128, 128, 8, 128, 2, 64), (256, 128, 8, 256, 5, 64),
               (512, 256, 32, 384, 4, 128)]
PAGED_SHAPES = [(1, 1, 1, 64, 16, 2), (3, 2, 4, 64, 16, 4),
                (2, 4, 8, 128, 32, 3)]


def bgmv_inputs(Bt, din, r, dout, n, dt, seed=0):
    rng = np.random.default_rng(seed)
    x = both(rng.standard_normal((Bt, din)), dt)
    A = both(rng.standard_normal((n, din, r)) * 0.05, dt)
    B = both(rng.standard_normal((n, r, dout)) * 0.05, dt)
    idx = rng.integers(0, n, Bt).astype(np.int32)
    return x, A, B, (jnp.asarray(idx), torch.from_numpy(idx))


def sgmv_inputs(T, din, r, dout, n, tile, dt, seed=1):
    rng = np.random.default_rng(seed)
    x = both(rng.standard_normal((T, din)), dt)
    A = both(rng.standard_normal((n, din, r)) * 0.05, dt)
    B = both(rng.standard_normal((n, r, dout)) * 0.05, dt)
    ts = rng.integers(0, n, T // tile).astype(np.int32)
    return x, A, B, (jnp.asarray(ts), torch.from_numpy(ts))


def paged_inputs(B, Kh, G, dh, page, P, dt, seed=2):
    rng = np.random.default_rng(seed)
    n_pages = B * P + 4
    q = both(rng.standard_normal((B, Kh, G, dh)), dt)
    kp = both(rng.standard_normal((n_pages, page, Kh, dh)), dt)
    vp = both(rng.standard_normal((n_pages, page, Kh, dh)), dt)
    pt = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    lens = rng.integers(1, P * page + 1, B).astype(np.int32)
    return (q, kp, vp, (jnp.asarray(pt), torch.from_numpy(pt)),
            (jnp.asarray(lens), torch.from_numpy(lens)))


class TestBGMV:
    @pytest.mark.parametrize("dt", ["f32", "bf16"])
    @pytest.mark.parametrize("Bt,din,r,dout,n", BGMV_SHAPES)
    def test_plain_matches_pallas(self, Bt, din, r, dout, n, dt):
        (xj, xt), (Aj, At), (Bj, Bt_), (ij, it) = bgmv_inputs(
            Bt, din, r, dout, n, dt)
        want = jbgmv(xj, Aj, Bj, ij, out_tile=128, interpret=True)
        got = bgmv_mod.bgmv(xt, At, Bt_, it)
        assert got.dtype == xt.dtype
        close(got, want, **tol(dt))

    @pytest.mark.parametrize("dt", ["f32", "bf16"])
    @pytest.mark.parametrize("Bt,din,r,dout,n", BGMV_SHAPES)
    def test_ref_matches_jax_ref(self, Bt, din, r, dout, n, dt):
        (xj, xt), (Aj, At), (Bj, Bt_), (ij, it) = bgmv_inputs(
            Bt, din, r, dout, n, dt)
        close(ref.bgmv_ref(xt, At, Bt_, it), jref.bgmv_ref(xj, Aj, Bj, ij),
              **tol(dt))

    def test_mixed_dtypes_round_intermediate_to_weights(self):
        """The engine's mix: f32 activations, bf16 slots. The plain
        version rounds the rank-r intermediate to bf16 like Pallas."""
        rng = np.random.default_rng(3)
        x = rng.standard_normal((4, 128)).astype(np.float32)
        A = jnp.asarray(rng.standard_normal((3, 128, 16)) * 0.1,
                        jnp.bfloat16)
        B = jnp.asarray(rng.standard_normal((3, 16, 256)) * 0.1,
                        jnp.bfloat16)
        idx = np.array([2, 0, 1, 2], np.int32)
        want = jbgmv(jnp.asarray(x), A, B, jnp.asarray(idx), out_tile=128,
                     interpret=True)
        got = bgmv_mod.bgmv(torch.from_numpy(x), to_torch(A, "cpu"),
                            to_torch(B, "cpu"),
                            torch.from_numpy(idx))
        assert got.dtype == torch.float32
        close(got, want, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("prefer_kernel", [True, None])
    def test_ops_wrapper_matches_jax(self, prefer_kernel):
        """``ops.lora_bgmv`` on CPU tensors (the kernel wrapper's plain
        version) with a dout the TPU path pads to 128, against JAX's
        ``lora_bgmv`` through Pallas (True) or its jnp oracle (None)."""
        from repro.kernels import ops as jops
        (xj, xt), (Aj, At), (Bj, Bt_), (ij, it) = bgmv_inputs(
            3, 128, 8, 200, 4, "f32")
        want = jops.lora_bgmv(xj, Aj, Bj, ij, prefer_kernel=prefer_kernel,
                              interpret=True)
        got = ops.lora_bgmv(xt, At, Bt_, it)
        close(got, want, rtol=2e-5, atol=2e-5)

    def test_cpu_tensors_take_the_plain_version(self):
        (_, xt), (_, At), (_, Bt_), (_, it) = bgmv_inputs(
            2, 128, 8, 128, 2, "f32")
        bgmv_mod.STATS.reset()
        bgmv_mod.bgmv(xt, At, Bt_, it)
        assert (bgmv_mod.STATS.launches, bgmv_mod.STATS.plain) == (0, 1)

    def test_bad_rank_and_shapes_raise(self):
        x = torch.zeros(2, 64)
        with pytest.raises(ValueError):
            bgmv_mod.bgmv(x, torch.zeros(2, 64, 256), torch.zeros(2, 256, 8),
                          torch.zeros(2, dtype=torch.int32))
        with pytest.raises(ValueError):
            bgmv_mod.bgmv(x, torch.zeros(2, 32, 8), torch.zeros(2, 8, 8),
                          torch.zeros(2, dtype=torch.int32))


class TestSGMV:
    @pytest.mark.parametrize("dt", ["f32", "bf16"])
    @pytest.mark.parametrize("T,din,r,dout,n,tile", SGMV_SHAPES)
    def test_plain_matches_pallas(self, T, din, r, dout, n, tile, dt):
        (xj, xt), (Aj, At), (Bj, Bt_), (sj, st) = sgmv_inputs(
            T, din, r, dout, n, tile, dt)
        want = jsgmv(xj, Aj, Bj, sj, tile=tile, out_tile=128,
                     interpret=True)
        got = sgmv_mod.sgmv(xt, At, Bt_, st, tile)
        assert got.dtype == xt.dtype
        close(got, want, **tol(dt))

    @pytest.mark.parametrize("dt", ["f32", "bf16"])
    @pytest.mark.parametrize("T,din,r,dout,n,tile", SGMV_SHAPES)
    def test_ref_matches_jax_ref(self, T, din, r, dout, n, tile, dt):
        (xj, xt), (Aj, At), (Bj, Bt_), (sj, st) = sgmv_inputs(
            T, din, r, dout, n, tile, dt)
        close(ref.sgmv_ref(xt, At, Bt_, st, tile),
              jref.sgmv_ref(xj, Aj, Bj, sj, tile), **tol(dt))

    @pytest.mark.parametrize("seq_lens,slots,tile", [
        ([10, 33, 64, 7], [2, 0, 4, 1], 64),
        ([1, 200, 5], [0, 0, 3], 32),
        ([128], [4], 128),
    ])
    def test_pack_segments_identical(self, seq_lens, slots, tile):
        want = jpack(seq_lens, slots, tile)
        got = sgmv_mod.pack_segments(seq_lens, slots, tile)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert got[0].dtype == want[0].dtype == np.int32

    def test_ragged_wrapper_matches_jax(self):
        from repro.kernels import ops as jops
        rng = np.random.default_rng(4)
        din, r, dout, n = 128, 8, 256, 5
        seq_lens, slots = [10, 33, 64, 7], [2, 0, 4, 1]
        x = rng.standard_normal((sum(seq_lens), din)).astype(np.float32)
        A = (rng.standard_normal((n, din, r)) * 0.05).astype(np.float32)
        B = (rng.standard_normal((n, r, dout)) * 0.05).astype(np.float32)
        want = jops.lora_sgmv(jnp.asarray(x), jnp.asarray(A),
                              jnp.asarray(B), seq_lens, slots, tile=64,
                              prefer_kernel=True, interpret=True)
        got = ops.lora_sgmv(torch.from_numpy(x), torch.from_numpy(A),
                            torch.from_numpy(B), seq_lens, slots, tile=64)
        close(got, want, rtol=2e-5, atol=2e-5)


    @pytest.mark.parametrize("r", [1, 12, 32, 128])
    @pytest.mark.parametrize("tile", [1, 8, 24, 128])
    @pytest.mark.parametrize("xdt,wdt,want", [
        ("bf16", "bf16", "tensor_cores"), ("f32", "f32", "cuda_cores"),
        ("f32", "bf16", "cuda_cores"), ("bf16", "f32", "cuda_cores")])
    def test_instance_follows_dtypes_only(self, r, tile, xdt, wdt, want):
        dts = {"f32": torch.float32, "bf16": torch.bfloat16}
        assert sgmv_mod.sgmv_instance(dts[xdt], dts[wdt], r, tile) == want

    @pytest.mark.parametrize("r,tile", [(0, 8), (129, 8), (32, 0)])
    def test_instance_rejects_what_no_kernel_takes(self, r, tile):
        with pytest.raises(ValueError):
            sgmv_mod.sgmv_instance(torch.bfloat16, torch.bfloat16, r, tile)

    @pytest.mark.parametrize("T,tile,din", [
        (2048, 128, 4096), (256, 32, 4096), (8, 8, 4096), (120, 40, 1000),
        (64, 8, 200), (16, 1, 64), (4096, 128, 11008), (2048, 128, 11008)])
    def test_tc_splits_cover_din_in_whole_stages(self, T, tile, din):
        """Every split of the tensor-core shrink is a whole number of
        64-wide stages (the kernel's split length), at least four unless
        there is one split, non-empty, and the splits cover din; where
        din has room for two waves of 132 SMs the blocks fill one."""
        n = sgmv_mod.tc_splits(T, tile, din)
        step = sgmv_mod.TC_DIN_STEP
        split_len = -(-(-(-din // n)) // step) * step   # as sgmv.cu does
        assert 1 <= n <= 64
        assert (n - 1) * split_len < din <= n * split_len
        assert n == 1 or split_len >= 4 * step
        chunks = (T // tile) * -(-tile // sgmv_mod.TC_ROWS_PER_BLOCK)
        if din // (4 * step) >= -(-264 // chunks):
            assert chunks * n >= 132


class TestPagedAttention:
    @pytest.mark.parametrize("dt", ["f32", "bf16"])
    @pytest.mark.parametrize("B,Kh,G,dh,page,P", PAGED_SHAPES)
    def test_plain_matches_pallas(self, B, Kh, G, dh, page, P, dt):
        (qj, qt), (kj, kt), (vj, vt), (pj, ptt), (lj, lt) = paged_inputs(
            B, Kh, G, dh, page, P, dt)
        want = jpaged(qj, kj, vj, pj, lj, interpret=True)
        got = pa_mod.paged_attention(qt, kt, vt, ptt, lt)
        assert got.dtype == qt.dtype
        close(got, want, **tol(dt))

    @pytest.mark.parametrize("dt", ["f32", "bf16"])
    @pytest.mark.parametrize("B,Kh,G,dh,page,P", PAGED_SHAPES)
    def test_ref_matches_jax_ref(self, B, Kh, G, dh, page, P, dt):
        (qj, qt), (kj, kt), (vj, vt), (pj, ptt), (lj, lt) = paged_inputs(
            B, Kh, G, dh, page, P, dt)
        close(ref.paged_attention_ref(qt, kt, vt, ptt, lt),
              jref.paged_attention_ref(qj, kj, vj, pj, lj), **tol(dt))

    def test_engine_mix_bf16_queries_f32_pages(self):
        """The engine's mix: activation-dtype q against f32 KV pages."""
        rng = np.random.default_rng(5)
        B, Kh, G, dh, page, P = 2, 2, 2, 32, 16, 3
        q = jnp.asarray(rng.standard_normal((B, Kh, G, dh)), jnp.bfloat16)
        kp = rng.standard_normal((8, page, Kh, dh)).astype(np.float32)
        vp = rng.standard_normal((8, page, Kh, dh)).astype(np.float32)
        pt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
        lens = np.array([17, 48], np.int32)
        want = jpaged(q, jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(pt), jnp.asarray(lens), interpret=True)
        got = pa_mod.paged_attention(to_torch(q, "cpu"),
                                     torch.from_numpy(kp),
                                     torch.from_numpy(vp),
                                     torch.from_numpy(pt),
                                     torch.from_numpy(lens))
        assert got.dtype == torch.bfloat16
        close(got, want, rtol=2e-2, atol=2e-2)

    def test_ops_dispatch_takes_plain_version_on_cpu(self):
        """``ops.paged_attention`` routes by the tensors alone: CPU
        tensors take the kernel wrapper's plain version, which agrees
        with the ``ref`` oracle."""
        (_, qt), (_, kt), (_, vt), (_, ptt), (_, lt) = paged_inputs(
            1, 1, 1, 64, 16, 2, "f32")
        pa_mod.STATS.reset()
        got = ops.paged_attention(qt, kt, vt, ptt, lt)
        assert (pa_mod.STATS.plain, pa_mod.STATS.launches) == (1, 0)
        torch.testing.assert_close(
            got, ref.paged_attention_ref(qt, kt, vt, ptt, lt),
            rtol=2e-5, atol=2e-5)


class TestAutogradGuard:
    """The CUDA kernels record no autograd graph: bgmv, sgmv and
    paged_attention, given card tensors that require grad with grad mode
    on, raise rather than return a tensor cut off from its inputs;
    flash_attention, which has a backward kernel, goes through
    ``FlashAttentionFn`` instead. Shown on CPU tensors with the
    wrappers' "on the card" predicate patched to say yes (the kernel
    wrappers then serve both passes with their plain versions)."""

    def calls(self, grad):
        rng = np.random.default_rng(0)

        def t(*shape):
            return torch.tensor(rng.standard_normal(shape),
                                dtype=torch.float32, requires_grad=grad)
        A, B = t(3, 16, 4), t(3, 4, 8)
        idx = torch.tensor([2, 0], dtype=torch.int32)
        table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        lens = torch.tensor([5, 9], dtype=torch.int32)
        q, kv = t(1, 8, 2, 16), t(1, 8, 1, 16)
        return {
            "bgmv": lambda: ops.lora_bgmv(t(2, 16), A, B, idx),
            "sgmv": lambda: ops.lora_sgmv(t(7, 16), A, B, [3, 4], [2, 0],
                                          tile=8),
            "lora_delta_kernel": lambda: ops.lora_delta_kernel(
                t(2, 5, 16), A, B, idx),
            "paged_attention": lambda: ops.paged_attention(
                t(2, 2, 1, 16), t(5, 4, 2, 16), t(5, 4, 2, 16), table,
                lens),
            "flash_attention": lambda: ops.flash_attention(q, kv, kv),
        }

    @pytest.mark.parametrize("name", ["bgmv", "sgmv", "lora_delta_kernel",
                                      "paged_attention", "flash_attention"])
    def test_card_call_needing_grad_raises(self, name, monkeypatch):
        monkeypatch.setattr(ops, "_on_card", lambda t: True)
        if name == "flash_attention":
            self.flash_goes_through_its_backward()
        else:
            with pytest.raises(NotImplementedError,
                               match="no backward pass"):
                self.calls(grad=True)[name]()
        # No grad needed (grad mode off, or no input requires grad): the
        # call goes on to the kernel wrapper (here its plain version).
        with torch.no_grad():
            self.calls(grad=True)[name]()
        self.calls(grad=False)[name]()

    def flash_goes_through_its_backward(self):
        """The flash call needing grad is ``FlashAttentionFn``'s, and its
        gradients are plain autograd's through the same function."""
        rng = np.random.default_rng(2)
        q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                requires_grad=True)
                   for s in ((1, 8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16)))
        out = ops.flash_attention(q, k, v)
        assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
        dout = torch.tensor(rng.standard_normal(out.shape),
                            dtype=torch.float32)
        got = torch.autograd.grad(out, (q, k, v), dout)
        want = torch.autograd.grad(fa_mod.flash_attention_plain(q, k, v),
                                   (q, k, v), dout)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)

    def test_cpu_tensors_keep_autograd(self):
        """On CPU tensors the plain versions run and gradients flow."""
        rng = np.random.default_rng(1)
        q = torch.tensor(rng.standard_normal((1, 6, 2, 8)),
                         dtype=torch.float32, requires_grad=True)
        out = ops.flash_attention(q, q[:, :, :1].detach(),
                                  q[:, :, :1].detach())
        out.sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()
