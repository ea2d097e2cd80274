"""The port's flash_attention on the CPU vs the JAX package.

On CPU tensors the kernel wrapper runs its plain version
(``flash_attention_plain``, the port's ``gqa_attention``), which is held
here to the Pallas kernel it replaces, run in interpret mode as
``tests/test_kernels.py`` runs it (64-row blocks, that file's four
shapes in f32 and bf16), and to the JAX oracle ``ref.flash_attention_ref``
at ragged lengths the Pallas kernel cannot take and at S = 2048, where
the attention runs query-chunked. Inputs are drawn with numpy from a
seed and handed to both sides. Tolerances: 1e-5 abs+rel in f32 (both
sides compute in f32; only the order of the sums and the online
rescaling differ), and ``tol(bfloat16)`` of ``tests/test_kernels.py``
(2e-2 abs+rel) in bf16, where the plain version rounds the
probabilities to bf16 and the Pallas kernel keeps them in f32.

The f32 kernel instance's arithmetic (``tf32x3``: each f32 product as
three TF32 products, operands split to nearest), emulated in plain
torch (``tests/_port_flash.py`` ``emulate_fwd``), is held to the JAX
oracle at the card's f32 gate (1e-4 + 1e-4 |want|, the log-sum-exp
within 1e-5 of numpy's in f64) at internlm2-1.8b's head width cut to
4/2 heads and S 77, and at dh 64: 3xTF32 meets it with either split
(to nearest, the forward's, or truncated, the backward's), one TF32
product does not. The split to nearest leaves at most 2^-22 of |x| and
no bias; the truncated one more, always toward zero. The kernel itself
is checked on the card (``tests/test_torch_cuda.py``).
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
from repro.kernels.flash_attention import \
    flash_attention as jflash  # noqa: E402
from _port_flash import (emulate_fwd, round_tf32,  # noqa: E402
                         round_tf32_rn)
from repro_torch.bridge import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

# The kernels package re-exports ``flash_attention`` (the function), so
# the module is fetched by path.
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def qkv(B, S, H, Kh, dh, dt, seed):
    """q, k, v as JAX arrays of dtype ``dt`` and the identical values as
    tensors (bf16 rounding happens once, on the JAX side)."""
    rng = np.random.default_rng(seed)
    out = []
    for heads in (H, Kh, Kh):
        j = jnp.asarray(rng.standard_normal((B, S, heads, dh)), DTYPES[dt])
        out.append((j, to_torch(j, "cpu")))
    return out


def close(port, jax_out, dt):
    np.testing.assert_allclose(to_numpy(port),
                               np.asarray(jax_out, np.float32), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Kh,dh,causal", [
    (1, 128, 2, 2, 64, True),
    (2, 256, 4, 2, 64, True),     # GQA G=2
    (1, 256, 8, 1, 128, True),    # MQA
    (2, 128, 2, 2, 64, False),
])
def test_plain_matches_pallas(B, S, H, Kh, dh, causal, dt):
    (qj, qt), (kj, kt), (vj, vt) = qkv(B, S, H, Kh, dh, dt, seed=S + H)
    want = jflash(qj, kj, vj, causal=causal, q_block=64, kv_block=64,
                  interpret=True)
    got = fa_mod.flash_attention_plain(qt, kt, vt, causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Kh,dh,causal", [
    (2, 5, 4, 2, 32, True),       # shorter than any block
    (1, 100, 8, 8, 64, True),     # ragged MHA
    (2, 100, 4, 1, 32, False),    # ragged MQA, no mask
    (1, 2048, 2, 1, 32, True),    # query-chunked path
])
def test_plain_matches_jax_ref(B, S, H, Kh, dh, causal, dt):
    (qj, qt), (kj, kt), (vj, vt) = qkv(B, S, H, Kh, dh, dt, seed=S)
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal)
    close(fa_mod.flash_attention_plain(qt, kt, vt, causal), want, dt)
    close(ref.flash_attention_ref(qt, kt, vt, causal), want, dt)


def test_first_token_attends_only_itself():
    (_, qt), (_, kt), (_, vt) = qkv(1, 128, 2, 2, 64, "f32", seed=1)
    got = ops.flash_attention(qt, kt, vt, causal=True)
    np.testing.assert_allclose(to_numpy(got[0, 0]), to_numpy(vt[0, 0]),
                               rtol=1e-5, atol=1e-5)


def test_ops_on_cpu_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the CUDA path: the wrapper counts a
    plain call, no launch, and no kernel library is built or loaded."""

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU call tried to build a CUDA kernel")

    monkeypatch.setattr(build, "build_all", no_build)
    monkeypatch.setattr(fa_mod, "library", no_build)
    fa_mod.STATS.reset()
    (_, qt), (_, kt), (_, vt) = qkv(2, 40, 4, 2, 32, "f32", seed=2)
    got = ops.flash_attention(qt, kt, vt)
    assert fa_mod.STATS.plain == 1 and fa_mod.STATS.launches == 0
    assert torch.equal(got, fa_mod.flash_attention_plain(qt, kt, vt))
    assert "flash_attention" not in build._LIBS


@pytest.mark.parametrize("bad", ["heads", "dtype", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    if bad == "heads":
        k = torch.zeros(1, 8, 3, 32)
    elif bad == "dtype":
        k = k.bfloat16()
    else:
        q = q[0]
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, k.clone())


@pytest.mark.parametrize("dh", [16, 32, 36, 64, 80, 100, 128, 256])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_instance_follows_dtype_and_head_dim(dh, dt):
    """bf16: tensor cores with dh % 16 == 0, CUDA cores at any other dh;
    f32: tf32x3 at every dh."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    if dt == "f32":
        want = "tf32x3"
    else:
        want = "tensor_cores" if dh % 16 == 0 else "cuda_cores"
    assert fa_mod.flash_instance(dtype, dh) == want


@pytest.mark.parametrize("dh", [2, 6, 258, 272])
def test_instance_rejects_head_dims_no_kernel_takes(dh):
    with pytest.raises(ValueError):
        fa_mod.flash_instance(torch.bfloat16, dh)


@pytest.mark.parametrize("mode,passes", [
    ("tf32x3_rn", True), ("tf32x3", True), ("tf32", False)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [128, 64])
def test_kernel_arithmetic_meets_the_gate(dh, causal, mode, passes):
    """The f32 instance's rounding (``emulate_fwd``) at internlm2-1.8b's
    head widths (dh 128, GQA 2; heads 16/8 cut to 4/2, S to a ragged 77)
    and at dh 64, against the JAX oracle in f32: within 1e-4 + 1e-4
    |want|, the log-sum-exp within 1e-5 + 1e-5 |want| of numpy's in f64.
    Three TF32 products an f32 product pass, split to nearest (the
    kernel's) or truncated; one TF32 product fails both."""
    B, S, H, Kh = 2, 77, 4, 2
    (qj, qt), (kj, kt), (vj, vt) = qkv(B, S, H, Kh, dh, "f32", seed=S + dh)
    want = np.asarray(jref.flash_attention_ref(qj, kj, vj, causal=causal))
    s = np.einsum("bqhd,bkhd->bhqk", to_numpy(qt).astype(np.float64),
                  np.repeat(to_numpy(kt).astype(np.float64), H // Kh,
                            axis=2)) * dh ** -0.5
    if causal:
        s = np.where(np.triu(np.ones((S, S), bool), 1), -np.inf, s)
    mx = s.max(-1, keepdims=True)
    lse_want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    out, lse = emulate_fwd(qt, kt, vt, causal, mode)
    out_ok = bool((np.abs(to_numpy(out) - want)
                   <= 1e-4 + 1e-4 * np.abs(want)).all())
    lse_ok = bool((np.abs(to_numpy(lse) - lse_want)
                   <= 1e-5 + 1e-5 * np.abs(lse_want)).all())
    assert (out_ok, lse_ok) == (passes, passes)


def test_split_to_nearest_is_closer_and_unbiased():
    """hi + lo of ``round_tf32_rn`` (the forward's split) is within
    2**-22 |x| of x and its error has no sign; the truncated split's
    (the backward's) reaches past 2**-22 |x| (its bound is 2**-21) and
    always shrinks |x|."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        1 << 16).astype(np.float32) * 3)

    def split_sum(rnd):
        hi = rnd(x)
        return hi.double() + rnd(x - hi).double()

    err_rn = split_sum(round_tf32_rn) - x.double()
    err_tr = split_sum(round_tf32) - x.double()
    ax = x.double().abs()
    assert (err_rn.abs() <= 2.0 ** -22 * ax).all()
    assert abs(float((err_rn * x.double().sign()).mean())) \
        < 0.05 * float(err_rn.abs().mean())
    assert (err_tr * x.double().sign() <= 0).all()
    assert (err_tr.abs() < 2.0 ** -21 * ax).all()
    assert float((err_tr.abs() / ax).max()) > 2.0 ** -22
