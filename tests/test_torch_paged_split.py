"""The port's paged_attention split-and-combine, on the CPU, against the
Pallas kernel in interpret mode.

The CUDA kernel splits each (row, kv head)'s visited pages over the
blocks of a thread-block cluster and merges their softmax states in
split order. ``tests/_paged_split.py`` mirrors that arithmetic in plain
torch; here it must equal the Pallas kernel within 1e-5 (f32 sums in
another order) at lengths 0 (every page visited, fully masked: the
mean of V), 1, page - 3, a split boundary (128: 8 whole pages, every
run full at 2, 4 or 8 splits), one past it (129: runs of one more page,
so trailing runs are empty at 8 splits) and every position (P * page),
for G 1, 4 and 16, dh 64 and 128, and 2, 4 and 8 splits. The card tests
hold the CUDA kernel to the same mirror.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _paged_split import (paged_attention_split, split_pages,  # noqa: E402
                          split_states)
from repro.kernels.paged_attention import \
    paged_attention as jpaged  # noqa: E402

PAGE, P, KH = 16, 16, 2
LENGTHS = [0, 1, PAGE - 3, 128, 129, P * PAGE]


def inputs(G, dh, seed=0):
    rng = np.random.default_rng(seed + 31 * G + dh)
    B = len(LENGTHS)
    n_pages = B * P + 1
    q = rng.standard_normal((B, KH, G, dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, PAGE, KH, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PAGE, KH, dh)).astype(np.float32)
    table = (1 + rng.permutation(n_pages - 1))[:B * P].reshape(B, P)
    lens = np.array(LENGTHS, np.int32)
    return q, kp, vp, table.astype(np.int32), lens


_PALLAS = {}


def pallas(G, dh):
    if (G, dh) not in _PALLAS:
        _PALLAS[(G, dh)] = np.asarray(jpaged(
            *(jnp.asarray(a) for a in inputs(G, dh)), interpret=True))
    return _PALLAS[(G, dh)]


@pytest.mark.parametrize("splits", [2, 4, 8])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_split_combine_equals_pallas(G, dh, splits):
    got = paged_attention_split(
        *(torch.from_numpy(a) for a in inputs(G, dh)), splits)
    np.testing.assert_allclose(got.numpy(), pallas(G, dh), rtol=0,
                               atol=1e-5)


def test_split_pages_runs():
    """Runs of whole pages: the boundary cases the lengths above pick."""
    assert split_pages(128, P, PAGE, 8) == [(i, i + 1)
                                                   for i in range(8)]
    assert split_pages(129, P, PAGE, 8) == [
        (0, 2), (2, 4), (4, 6), (6, 8), (8, 9), (9, 9), (9, 9), (9, 9)]
    assert split_pages(0, P, PAGE, 4) == [(0, 4), (4, 8), (8, 12),
                                                 (12, 16)]
    assert split_pages(1, P, PAGE, 2) == [(0, 1), (1, 1)]


def test_empty_split_carries_no_weight():
    """A row of 129 tokens at 8 splits: the three trailing runs are
    empty (m = -inf, l = 0, acc = 0) and the result stays finite."""
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in inputs(1, 64))
    rows = split_states(q, kp, vp, table, lens, 8)
    row = rows[LENGTHS.index(129)]
    for m, l, acc in row[5:]:
        assert torch.isinf(m).all() and (l == 0).all() and (acc == 0).all()
    out = paged_attention_split(q, kp, vp, table, lens, 8)
    assert torch.isfinite(out).all()
