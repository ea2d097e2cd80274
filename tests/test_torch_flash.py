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
    """Tensor cores for bf16 with dh % 16 == 0; CUDA cores for f32 and
    for bf16 at any other dh."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    want = ("tensor_cores" if dt == "bf16" and dh % 16 == 0
            else "cuda_cores")
    assert fa_mod.flash_instance(dtype, dh) == want


@pytest.mark.parametrize("dh", [2, 6, 258, 272])
def test_instance_rejects_head_dims_no_kernel_takes(dh):
    with pytest.raises(ValueError):
        fa_mod.flash_instance(torch.bfloat16, dh)
