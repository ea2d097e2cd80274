"""The port's seeded sampler on the CPU vs JAX's own random draws.

The JAX sampler draws ``jax.random.gumbel(fold_in(PRNGKey(seed),
position), (V,))`` per row; the port computes the same threefry2x32
bits in plain torch. Nothing from JAX is fed to the port here:

- the port's bits equal ``jax.random.bits`` of the folded key bit for
  bit, over seeds that wrap to uint32 (negative, 2**31 - 1, 2**32 - 1);
- its Gumbel noise equals ``jax.random.gumbel`` within 1e-6 absolute:
  the uniforms are equal, only the two f32 logs may round one ulp apart
  (the noise stays below 16, where an f32 ulp is at most 2**-20);
- ``sample_tokens`` picks the JAX sampler's tokens on logits full of
  exact ties, every row drawing its own noise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import lm  # noqa: E402

SEEDS = [0, 1, 2**31 - 1, 2**32 - 1, -5]
POSITIONS = [0, 33, 250]
VOCABS = [512, 32000]


def jax_key(seed: int, pos: int):
    """The JAX sampler's key for one row: seeds and positions cast to
    uint32 as ``sample_tokens`` casts them."""
    s = jnp.asarray(np.int64(seed)).astype(jnp.uint32)
    p = jnp.asarray(np.int64(pos)).astype(jnp.uint32)
    return jax.random.fold_in(jax.random.PRNGKey(s), p)


def port_args(seed: int, pos: int):
    return (torch.tensor([seed], dtype=torch.int64),
            torch.tensor([pos], dtype=torch.int32))


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_equal_jax(seed, pos, V):
    want = np.asarray(jax.random.bits(jax_key(seed, pos), (V,)))
    got = lm.threefry_bits(*port_args(seed, pos), V)
    assert got.shape == (1, V)
    assert np.array_equal(bridge.to_numpy(got[0]), want.astype(np.int64))


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_equals_jax(seed, pos, V):
    want = np.asarray(jax.random.gumbel(jax_key(seed, pos), (V,)))
    got = lm.gumbel_noise(*port_args(seed, pos), V)
    assert got.dtype == torch.float32 and got.shape == (1, V)
    np.testing.assert_allclose(bridge.to_numpy(got[0]), want, rtol=0,
                               atol=1e-6)


def test_rows_draw_independently_of_the_batch():
    """A batch of rows gives each row the noise it gets alone."""
    seeds = torch.tensor(SEEDS, dtype=torch.int64)
    pos = torch.tensor([0, 33, 250, 7, 1], dtype=torch.int32)
    both = lm.threefry_bits(seeds, pos, 512)
    for i in range(len(SEEDS)):
        assert torch.equal(both[i], lm.threefry_bits(seeds[i:i + 1],
                                                     pos[i:i + 1], 512)[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_equal_jax(seed):
    """The tied-logits case of ``tests/test_torch_lm.py``'s sampler
    test, with each side drawing its own noise."""
    rng = np.random.default_rng(seed)
    B, V = 8, 512
    # One decimal place: many exact ties inside each row.
    logits = np.round(rng.standard_normal((B, V)) * 2, 1).astype(np.float32)
    temp = np.array([0, 0.7, 1.0, 0.5, 1.3, 0.9, 2.0, 0.8], np.float32)
    top_k = np.array([0, 5, 0, 20, 3, 0, 1, 50], np.int32)
    top_p = np.array([1, 1, 0.8, 0.9, 1, 0.5, 1, 0.3], np.float32)
    seeds = rng.integers(0, 2**31, B).astype(np.uint32)
    pos = rng.integers(0, 300, B).astype(np.int32)
    args = (logits, temp, top_k, top_p, seeds, pos)
    want = jlm.sample_tokens(*(jnp.asarray(a) for a in args))
    got = lm.sample_tokens(*(torch.from_numpy(a.astype(np.int64)
                                              if a is seeds else a)
                             for a in args))
    assert np.array_equal(bridge.to_numpy(got), np.asarray(want))
