"""The flash_attention backward's inputs and precision design on the CPU.

- The forward's log-sum-exp (``return_lse=True``; on CPU tensors
  ``flash_attention_lse_plain``) against numpy in f64 on the same
  seeded inputs that ``layers.gqa_attention`` of the JAX package takes,
  causal and full, ragged S: 1e-5. The numpy log-sum-exp also rebuilds
  the JAX function's output (exp(s - lse) v) within 1e-5, so it is the
  normaliser of the attention the backward differentiates.
- ``flash_attention_bwd`` on CPU tensors, given that log-sum-exp,
  against ``jax.vjp`` of ``layers.gqa_attention`` at the shapes of
  ``tests/test_torch_training.py``: 1e-5 in f32.
- The backward kernel's arithmetic emulated in plain torch
  (``tests/_port_flash.py``: tf32 splits truncated and bf16 splits
  rounded to nearest even, both by masking mantissa bits; f32 sums) at
  a reduced internlm2-1.8b head shape (16/8 heads cut to 4/2, dh 128,
  ragged S), held to the gate the card
  run uses (``flash_bwd_tol``) against the f32 plain gradient: 3xTF32
  for f32 and bf16 with P and dS split into hi + lo pass; one TF32
  product, or P and dS rounded once to bf16, do not. The kernel itself
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

from _port_flash import (emulate_bwd, flash_bwd_tol, round_bf16,  # noqa: E402
                         round_tf32)
from repro.models import layers as jlayers  # noqa: E402

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")


def qkv(seed, B, S, H, Kh, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, dh)).astype(np.float32)
                 for h in (H, Kh, Kh))


def np_lse(q, k, causal):
    """(B, H, S) log-sum-exp of the scaled scores in f64, and the
    scores themselves (B, H, S, S)."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k.astype(np.float64), G, axis=2)) * dh ** -0.5
    if causal:
        s = np.where(np.triu(np.ones((S, S), bool), 1), -np.inf, s)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0], s


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kh,dh", [
    (2, 37, 4, 2, 16), (1, 21, 6, 1, 8), (2, 64, 4, 4, 32),
    (1, 130, 8, 2, 128)])
def test_forward_lse_matches_numpy(B, S, H, Kh, dh, causal):
    q, k, v = qkv(S + H, B, S, H, Kh, dh)
    want, s = np_lse(q, k, causal)
    fa_mod.STATS.reset()
    out, lse = fa_mod.flash_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), causal, return_lse=True)
    assert fa_mod.STATS.plain == 1 and fa_mod.STATS.launches == 0
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        fa_mod.flash_attention_lse_plain(torch.from_numpy(q),
                                         torch.from_numpy(k), causal).numpy(),
        want, rtol=1e-5, atol=1e-5)
    # The same normaliser rebuilds the JAX attention.
    G = H // Kh
    rebuilt = np.einsum("bhqk,bkhd->bqhd", np.exp(s - want[..., None]),
                        np.repeat(v.astype(np.float64), G, axis=2))
    jout = np.asarray(jlayers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(jout, rebuilt, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kh,dh", [
    (2, 37, 4, 2, 16), (1, 64, 4, 4, 32), (2, 21, 6, 1, 8),
    (1, 2048, 2, 1, 16)])
def test_bwd_with_lse_matches_jax_grad(B, S, H, Kh, dh, causal):
    """The backward on CPU tensors, handed the forward's log-sum-exp,
    against ``jax.vjp`` of ``layers.gqa_attention`` on the same f32
    values."""
    q, k, v = qkv(S + H, B, S, H, Kh, dh)
    dout = np.random.default_rng(S).standard_normal(
        (B, S, H, dh)).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b, c: jlayers.gqa_attention(
        a, b, c, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    out, lse = fa_mod.flash_attention(tq, tk, tv, causal, return_lse=True)
    fa_mod.BWD_STATS.reset()
    got = fa_mod.flash_attention_bwd(tq, tk, tv, out, torch.from_numpy(dout),
                                     causal, lse=lse)
    assert (fa_mod.BWD_STATS.plain, fa_mod.BWD_STATS.launches) == (1, 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_bwd_checks_lse():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="lse must be float32"):
        fa_mod.flash_attention_bwd(q, q, q, q, q, lse=torch.zeros((1, 8, 2)))
    with pytest.raises(ValueError, match="lse must be float32"):
        fa_mod.flash_attention_bwd(q, q, q, q, q,
                                   lse=torch.zeros((1, 2, 8)).double())


def test_mantissa_masks_round_as_the_card_does():
    """``round_bf16`` is torch's round-to-nearest-even cast; ``round_tf32``
    keeps the top 10 mantissa bits (truncation toward zero)."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        4096).astype(np.float32) * 3)
    assert torch.equal(round_bf16(x), x.bfloat16().float())
    t = round_tf32(x)
    assert ((t.view(torch.int32) & 0x1FFF) == 0).all()
    assert (t.abs() <= x.abs()).all()
    assert ((x - t).abs() < x.abs() * 2.0 ** -10).all()
    assert torch.equal(round_tf32(torch.tensor([1 + 2.0 ** -11 + 2.0 ** -12,
                                                -3.0])),
                       torch.tensor([1.0, -3.0]))


@pytest.mark.parametrize("mode,dt,passes", [
    ("tf32x3", torch.float32, True), ("bf16", torch.bfloat16, True),
    ("tf32", torch.float32, False), ("bf16_once", torch.bfloat16, False)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_arithmetic_meets_the_gate(mode, dt, passes, causal):
    """The kernel's rounding at internlm2-1.8b's head widths (dh 128,
    GQA 2; heads 16/8 cut to 4/2, S to a ragged 77), against the f32
    plain gradient under ``flash_bwd_tol``: the chosen design passes,
    the cheaper one beside it fails."""
    B, S, H, Kh, dh = 2, 77, 4, 2, 128
    gen = torch.Generator().manual_seed(77)
    q, k, v, dout = (torch.randn((B, S, h, dh), generator=gen).to(dt)
                     for h in (H, Kh, Kh, H))
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, dout))
    out = fa_mod.flash_attention_plain(q32, k32, v32, causal).to(dt)
    lse = fa_mod.flash_attention_lse_plain(q32, k32, causal)
    want = fa_mod.flash_attention_bwd_plain(q32, k32, v32, out.float(), do32,
                                            causal)
    got = emulate_bwd(q32, k32, v32, out.float(), do32, lse, causal, mode)
    bounds = flash_bwd_tol(q, k, v, out, dout, causal, want)
    within = all(bool(((g.to(dt).float() - w).abs() <= bd).all())
                 for g, w, bd in zip(got, want, bounds))
    assert within == passes
