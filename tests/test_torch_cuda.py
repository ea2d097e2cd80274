"""The port's CUDA kernels and engine on the card.

Marked ``cuda``: these need an NVIDIA GPU and the CUDA toolkit
(``nvcc``) and skip elsewhere. On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same card
tensors over ragged shapes the full-width smoke run does not reach
(rank 128 and ranks not a multiple of 4, dout not a multiple of the
256-column block, tiles not a multiple of 16 rows, G up to 8, rows
shorter than a page). Tolerances: 1e-4 where every operand is f32 (f32
sums in another order); 2e-2 for bgmv/sgmv where bf16 is involved (the
rank-r intermediate is rounded to bf16 from sums taken in another
order, so it can land one bf16 ulp apart). paged_attention computes in
f32 from the same page values on both sides: 1e-4 for an f32 output,
and one bf16 ulp (2**-7 of |want|, plus 1e-4) for a bf16 one.
flash_attention: 1e-4 in f32; in bf16 one ulp of the output plus
2**-8 * sum_s p_s |v_s|, because its plain version rounds each
probability to bf16 (at most 2**-8 relative, bf16's unit roundoff)
before the product with V and the kernel keeps them in f32. The
reduced engine must serve a shared-prefix trace through all three
decode-path kernels, the dense slab and the non-prefix paged engines
through flash_attention, their fused and seed loops must agree, and
their greedy tokens must equal the CPU port's. So must the tokens of
the chunked-prefill engine (chunks of 4, 8 and 32) and of a request
exported from one card engine and imported into another (paged and
dense, and with the source's pipelined horizon in flight); migration
payloads are pinned host copies within 1e-4 of the CPU's.

sgmv and flash_attention each have two instances, chosen from dtype and
shape alone (``sgmv_instance``, ``flash_instance``): every case asserts
which one launched, tensor cores for bf16 (flash: dh % 16 == 0), CUDA
cores for f32 and for bf16 flash at dh 36. The bf16 flash cases also
hold the kernel to one bf16 ulp of the all-f32 plain version rounded
once, the accuracy the split of P into two bf16 parts is there to keep.

paged_attention splits each row's pages over a thread-block cluster:
rows of length 0 (every page fully masked), P * page and at and past a
split boundary (empty trailing splits), G up to 16, at 1, 2, 4 and 8
splits, are held to the plain version and to the split-and-combine
mirror of ``tests/_paged_split.py`` at the same tolerance. bgmv runs as
one CUDA kernel per call (torch.profiler counts it) at every cluster
size, empty din and dout slices included. The seeded sampler's
threefry bits on the card equal the CPU's exactly, its Gumbel noise
within 1e-6 (the f32 logs may round one ulp apart). The families
without an engine (reduced falcon-mamba, zamba2 with kernel LoRA,
whisper) and their scans give the CPU's numbers within 1e-4 in f32,
and bgmv, sgmv and paged_attention refuse card tensors that require
grad. The flash_attention backward kernel is held to its plain version
(autograd through ``flash_attention_plain`` on the same values in f32)
over ragged S, GQA, dh 4 to 256, causal and full: 1e-4 in f32; in bf16
one ulp of the gradient plus what the bf16 rounding of the forward's
output moves D = rowsum(dO * out) by (``flash_bwd_tol``, shared with
``tests/test_torch_flash_bwd.py`` through ``tests/_port_flash.py``);
each case asserts the instance that launched (``tensor_cores`` for bf16,
``tf32x3`` for f32) and that a second call gives the same bits. The
forward's log-sum-exp (``return_lse=True``) is held to
``flash_attention_lse_plain`` within 1e-5 in both instances. Attention
under grad on the card runs one forward and one backward launch, and
two train steps of one reduced config a family give the CPU port's
loss, grad norm, params and moments (``tests/_port_training.py``).
The mesh step functions over repeated positions of the card (MoE with
its experts over "data", MQA granite-34b with its one KV head shared by
both columns) give the unsharded CPU port's prefill and decode logits
within 1e-4 in f32, and ``moe_block_a2a`` equals ``moe_block`` on each
batch shard within 1e-4. An MoE engine whose mesh holds bare ``cuda``
devices loads every adapter into every shard of its arena and gives
the tokens of ``EngineConfig()``. The dense train step on a state
placed over repeated positions of the card gives the unsharded CPU
port's loss, grad norm, params and moments (``tests/_port_training.py``),
with one flash forward and backward launch a layer a position a step;
with ``remat=True`` two forward launches a layer a step; with heads the
"model" axis does not divide, one a layer a batch row.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _paged_split import paged_attention_split  # noqa: E402
from _port_flash import flash_bwd_tol  # noqa: E402

pytestmark = pytest.mark.cuda

bgmv_mod = importlib.import_module("repro_torch.kernels.bgmv")
sgmv_mod = importlib.import_module("repro_torch.kernels.sgmv")
pa_mod = importlib.import_module("repro_torch.kernels.paged_attention")
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def card():
    """The card, or a skip. Decided here, not at import, so every
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def tol(*dtypes):
    t = 1e-4 if all(d == "f32" for d in dtypes) else 2e-2
    return dict(rtol=t, atol=t)


def out_tol(out_dtype):
    """An output computed in f32 on both sides and rounded to
    ``out_dtype``: bf16 results may round to neighbouring values."""
    return dict(rtol=1e-4, atol=1e-4) if out_dtype == "f32" \
        else dict(rtol=2 ** -7, atol=1e-4)


def randn(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)


@pytest.mark.parametrize("xdt,wdt", [("f32", "f32"), ("f32", "bf16"),
                                     ("bf16", "bf16")])
@pytest.mark.parametrize("Bt,din,r,dout,n", [
    (1, 128, 8, 128, 2), (8, 4096, 32, 4096, 8), (5, 300, 128, 700, 3),
    (3, 96, 6, 257, 4)])
def test_bgmv_matches_plain(card, Bt, din, r, dout, n, xdt, wdt):
    gen = torch.Generator().manual_seed(Bt * 7 + r)
    x = randn(gen, (Bt, din), DT[xdt], card)
    A = randn(gen, (n, din, r), DT[wdt], card, din ** -0.5)
    B = randn(gen, (n, r, dout), DT[wdt], card, r ** -0.5)
    idx = torch.randint(0, n, (Bt,), generator=gen).int().to(card)
    bgmv_mod.STATS.reset()
    got = bgmv_mod.bgmv(x, A, B, idx)
    torch.cuda.synchronize()
    assert bgmv_mod.STATS.launches == 1 and bgmv_mod.STATS.plain == 0
    assert got.dtype == x.dtype and got.shape == (Bt, dout)
    torch.testing.assert_close(got.float(),
                               bgmv_mod.bgmv_plain(x, A, B, idx).float(),
                               **tol(xdt, wdt))


@pytest.mark.parametrize("splits", [1, 4, 8, 16])
@pytest.mark.parametrize("Bt,din,r,dout,n", [
    (3, 96, 6, 257, 4), (5, 300, 128, 700, 3), (2, 8, 32, 16, 2)])
def test_bgmv_cluster_sizes_match_plain(card, Bt, din, r, dout, n, splits):
    """Every cluster size, with slices of din or dout that are empty
    (din 8 over 16 blocks; dout 16 in 8-column chunks) or ragged."""
    gen = torch.Generator().manual_seed(Bt * 11 + splits)
    for xdt, wdt in (("f32", "f32"), ("bf16", "bf16")):
        x = randn(gen, (Bt, din), DT[xdt], card)
        A = randn(gen, (n, din, r), DT[wdt], card, din ** -0.5)
        B = randn(gen, (n, r, dout), DT[wdt], card, r ** -0.5)
        idx = torch.randint(0, n, (Bt,), generator=gen).int().to(card)
        got = bgmv_mod.bgmv(x, A, B, idx, splits=splits)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(),
                                   bgmv_mod.bgmv_plain(x, A, B, idx).float(),
                                   **tol(xdt, wdt))


def test_bgmv_slot_out_of_range_yields_zeros(card):
    gen = torch.Generator().manual_seed(3)
    x = randn(gen, (4, 256), torch.bfloat16, card)
    A = randn(gen, (2, 256, 32), torch.bfloat16, card, 256 ** -0.5)
    B = randn(gen, (2, 32, 300), torch.bfloat16, card, 32 ** -0.5)
    idx = torch.tensor([1, -1, 2, 0], dtype=torch.int32, device=card)
    got = bgmv_mod.bgmv(x, A, B, idx).float()
    want = bgmv_mod.bgmv_plain(x, A, B, idx.clamp(0, 1)).float()
    assert (got[1:3] == 0).all()
    torch.testing.assert_close(got[[0, 3]], want[[0, 3]], **tol("bf16"))


def test_bgmv_is_one_cuda_kernel(card):
    """One call at the engine's decode width launches one CUDA kernel
    and allocates no scratch tensor."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(4)
    x = randn(gen, (8, 4096), torch.bfloat16, card)
    A = randn(gen, (8, 4096, 32), torch.bfloat16, card, 4096 ** -0.5)
    B = randn(gen, (8, 32, 4096), torch.bfloat16, card, 32 ** -0.5)
    idx = torch.randperm(8, generator=gen).int().to(card)
    bgmv_mod.bgmv(x, A, B, idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bgmv_mod.bgmv(x, A, B, idx)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in kernels) == 1, [e.key for e in kernels]
    assert "bgmv" in kernels[0].key


@pytest.mark.parametrize("xdt,wdt", [("f32", "f32"), ("f32", "bf16"),
                                     ("bf16", "bf16")])
@pytest.mark.parametrize("T,din,r,dout,n,tile", [
    (128, 128, 8, 128, 2, 64), (96, 256, 32, 384, 5, 24),
    (64, 200, 128, 300, 3, 8), (256, 512, 12, 257, 4, 128)])
def test_sgmv_matches_plain(card, T, din, r, dout, n, tile, xdt, wdt):
    gen = torch.Generator().manual_seed(T + r)
    x = randn(gen, (T, din), DT[xdt], card)
    A = randn(gen, (n, din, r), DT[wdt], card, din ** -0.5)
    B = randn(gen, (n, r, dout), DT[wdt], card, r ** -0.5)
    ts = torch.randint(0, n, (T // tile,), generator=gen).int().to(card)
    sgmv_mod.STATS.reset()
    got = sgmv_mod.sgmv(x, A, B, ts, tile)
    torch.cuda.synchronize()
    assert sgmv_mod.STATS.launches == 1 and sgmv_mod.STATS.plain == 0
    assert sgmv_mod.STATS.instances == {sgmv_instance(xdt, wdt): 1}
    assert got.dtype == x.dtype and got.shape == (T, dout)
    torch.testing.assert_close(got.float(),
                               sgmv_mod.sgmv_plain(x, A, B, ts, tile).float(),
                               **tol(xdt, wdt))


def sgmv_instance(xdt, wdt):
    return "tensor_cores" if xdt == wdt == "bf16" else "cuda_cores"


@pytest.mark.parametrize("T,din,r,dout,n,tile,offset", [
    (64, 200, 12, 257, 3, 8, 0),        # din and dout tails, r % 8 != 0
    (96, 256, 32, 384, 5, 24, 0),       # tiles shorter than 64 rows
    (256, 4096, 32, 4096, 8, 128, 0),   # din split over 16 blocks
    (128, 200, 128, 257, 2, 128, 0),    # rank 128
    (48, 512, 32, 257, 4, 24, 1),       # x rows not 16-byte aligned
    (16, 64, 1, 24, 2, 1, 0),           # rank 1, one-token tiles
    (120, 1000, 48, 520, 3, 40, 0)])    # din split with a ragged last split
def test_sgmv_tensor_cores_matches_plain(card, T, din, r, dout, n, tile,
                                         offset):
    gen = torch.Generator().manual_seed(T * 3 + r)
    x = randn(gen, (T * din + offset,), torch.bfloat16, card)[offset:]
    x = x.view(T, din)
    A = randn(gen, (n, din, r), torch.bfloat16, card, din ** -0.5)
    B = randn(gen, (n, r, dout), torch.bfloat16, card, r ** -0.5)
    ts = torch.randint(0, n, (T // tile,), generator=gen).int().to(card)
    sgmv_mod.STATS.reset()
    got = sgmv_mod.sgmv(x, A, B, ts, tile)
    torch.cuda.synchronize()
    assert sgmv_mod.STATS.instances == {"tensor_cores": 1}
    assert got.dtype == x.dtype and got.shape == (T, dout)
    torch.testing.assert_close(got.float(),
                               sgmv_mod.sgmv_plain(x, A, B, ts, tile).float(),
                               **tol("bf16", "bf16"))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sgmv_slot_out_of_range_yields_zeros(card, dt):
    """Tiles whose slot is -1 or n_slots come out zero; the others are
    untouched by them."""
    gen = torch.Generator().manual_seed(5)
    T, din, r, dout, n, tile = 128, 256, 32, 300, 3, 32
    x = randn(gen, (T, din), DT[dt], card)
    A = randn(gen, (n, din, r), DT[dt], card, din ** -0.5)
    B = randn(gen, (n, r, dout), DT[dt], card, r ** -0.5)
    ts = torch.tensor([1, -1, n, 0], dtype=torch.int32, device=card)
    got = sgmv_mod.sgmv(x, A, B, ts, tile).float()
    ok = torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=card)
    want = sgmv_mod.sgmv_plain(x, A, B, ok, tile).float()
    assert (got[tile:3 * tile] == 0).all()
    torch.testing.assert_close(got[:tile], want[:tile], **tol(dt, dt))
    torch.testing.assert_close(got[3 * tile:], want[3 * tile:], **tol(dt, dt))


@pytest.mark.parametrize("qdt,kvdt", [("f32", "f32"), ("bf16", "f32"),
                                      ("f32", "bf16"), ("bf16", "bf16")])
@pytest.mark.parametrize("B,Kh,G,dh,page,P", [
    (1, 1, 1, 64, 16, 2), (3, 2, 4, 64, 16, 4), (2, 4, 8, 128, 32, 3),
    (4, 8, 2, 128, 16, 20), (2, 2, 1, 256, 16, 3)])
def test_paged_attention_matches_plain(card, B, Kh, G, dh, page, P, qdt,
                                       kvdt):
    gen = torch.Generator().manual_seed(B * 13 + G)
    n_pages = B * P + 3
    q = randn(gen, (B, Kh, G, dh), DT[qdt], card)
    kp = randn(gen, (n_pages, page, Kh, dh), DT[kvdt], card)
    vp = randn(gen, (n_pages, page, Kh, dh), DT[kvdt], card)
    table = torch.randperm(n_pages, generator=gen)[:B * P].view(B, P)
    table = table.int().to(card)
    # A row of one token, a row inside its first page, the rest random.
    lens = torch.randint(1, P * page + 1, (B,), generator=gen)
    lens[0] = 1
    if B > 1:
        lens[1] = min(page - 3, P * page)
    lens = lens.int().to(card)
    pa_mod.STATS.reset()
    got = pa_mod.paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert pa_mod.STATS.launches == 1 and pa_mod.STATS.plain == 0
    assert got.dtype == q.dtype and got.shape == q.shape
    want = pa_mod.paged_attention_plain(q, kp, vp, table, lens)
    torch.testing.assert_close(got.float(), want.float(), **out_tol(qdt))


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("G,dh", [(1, 128), (4, 64), (16, 128), (16, 256),
                                  (2, 36)])
def test_paged_attention_splits_match_plain_and_mirror(card, G, dh, splits):
    """Rows of length 0 (all P pages visited, fully masked: the mean of
    V), 1, page - 3, the split boundary 128, one past it (trailing
    splits empty at 8) and P * page, every dtype case; dh 36 gives bf16
    rows of 72 bytes, copied in 8-byte chunks."""
    page, P, Kh = 16, 16, 2
    lens = torch.tensor([0, 1, page - 3, 128, 129, P * page],
                        dtype=torch.int32)
    B = lens.numel()
    n_pages = B * P + 1
    gen = torch.Generator().manual_seed(G * 5 + dh + splits)
    table = (1 + torch.randperm(n_pages - 1, generator=gen))[:B * P]
    table = table.view(B, P).int().to(card)
    for qdt, kvdt in (("f32", "f32"), ("bf16", "f32"), ("f32", "bf16"),
                      ("bf16", "bf16")):
        q = randn(gen, (B, Kh, G, dh), DT[qdt], card)
        kp = randn(gen, (n_pages, page, Kh, dh), DT[kvdt], card)
        vp = randn(gen, (n_pages, page, Kh, dh), DT[kvdt], card)
        pa_mod.STATS.reset()
        got = pa_mod.paged_attention(q, kp, vp, table, lens.to(card),
                                     splits=splits)
        torch.cuda.synchronize()
        assert pa_mod.STATS.launches == 1 and pa_mod.STATS.plain == 0
        assert torch.isfinite(got.float()).all()
        want = pa_mod.paged_attention_plain(q, kp, vp, table, lens.to(card))
        torch.testing.assert_close(got.float(), want.float(), **out_tol(qdt))
        mirror = paged_attention_split(q, kp, vp, table, lens, splits)
        torch.testing.assert_close(got.float().cpu(), mirror.float(),
                                   **out_tol(qdt))


def test_paged_attention_is_deterministic(card):
    """The split merge runs in a fixed order: two calls agree bit for
    bit."""
    gen = torch.Generator().manual_seed(9)
    q = randn(gen, (8, 32, 1, 128), torch.bfloat16, card)
    kp = randn(gen, (161, 16, 32, 128), torch.float32, card)
    vp = randn(gen, (161, 16, 32, 128), torch.float32, card)
    table = (1 + torch.randperm(160, generator=gen))[:128].view(8, 16)
    table = table.int().to(card)
    lens = torch.randint(1, 257, (8,), generator=gen).int().to(card)
    a = pa_mod.paged_attention(q, kp, vp, table, lens)
    b = pa_mod.paged_attention(q, kp, vp, table, lens)
    assert torch.equal(a, b)


@pytest.mark.parametrize("V", [512, 32000])
def test_gumbel_noise_card_equals_cpu(card, V):
    """The sampler's threefry bits on the card equal the CPU's bit for
    bit (integer arithmetic); its noise agrees within 1e-6."""
    from repro_torch.models import lm
    seeds = torch.tensor([0, 1, 2**31 - 1, 2**32 - 1, -5], dtype=torch.int64)
    pos = torch.tensor([0, 33, 250, 7, 1000], dtype=torch.int32)
    bits = lm.threefry_bits(seeds.to(card), pos.to(card), V)
    assert bits.is_cuda
    assert torch.equal(bits.cpu(), lm.threefry_bits(seeds, pos, V))
    noise = lm.gumbel_noise(seeds.to(card), pos.to(card), V)
    torch.testing.assert_close(noise.cpu(), lm.gumbel_noise(seeds, pos, V),
                               rtol=0, atol=1e-6)


def flash_tol(q, k, v, causal, want):
    """Per-element bound |got - want| may reach (see the module doc)."""
    if q.dtype == torch.float32:
        return 1e-4 + 1e-4 * want.float().abs()
    pv = fa_mod.flash_attention_plain(q.float(), k.float(),
                                      v.float().abs(), causal)
    return 1e-4 + 2 ** -7 * want.float().abs() + 2 ** -8 * pv


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kh,dh", [
    (1, 1, 1, 1, 32), (2, 5, 4, 2, 32), (1, 100, 8, 8, 64),
    (2, 100, 4, 1, 128), (1, 130, 40, 8, 128), (3, 64, 6, 3, 80),
    (1, 300, 2, 2, 256), (2, 256, 32, 32, 128)])
def test_flash_attention_matches_plain(card, B, S, H, Kh, dh, causal, dt):
    gen = torch.Generator().manual_seed(S * 7 + H)
    q = randn(gen, (B, S, H, dh), DT[dt], card)
    k = randn(gen, (B, S, Kh, dh), DT[dt], card)
    v = randn(gen, (B, S, Kh, dh), DT[dt], card)
    fa_mod.STATS.reset()
    got = fa_mod.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa_mod.STATS.launches == 1 and fa_mod.STATS.plain == 0
    assert fa_mod.STATS.instances == {flash_instance(dt, dh): 1}
    assert got.dtype == q.dtype and got.shape == q.shape
    check_flash(got, q, k, v, causal)


def flash_instance(dt, dh):
    return ("tensor_cores" if dt == "bf16" and dh % 16 == 0
            else "cuda_cores")


def check_flash(got, q, k, v, causal):
    """Within ``flash_tol`` of the plain version and, in bf16, within one
    ulp of the all-f32 plain version rounded once."""
    want = fa_mod.flash_attention_plain(q, k, v, causal)
    err = (got.float() - want.float()).abs()
    assert (err <= flash_tol(q, k, v, causal, want)).all(), err.max()
    if q.dtype == torch.bfloat16:
        w32 = fa_mod.flash_attention_plain(q.float(), k.float(), v.float(),
                                           causal).to(q.dtype).float()
        d32 = (got.float() - w32).abs()
        assert (d32 <= 1e-4 + 2 ** -7 * w32.abs()).all(), d32.max()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kh,dh", [
    (1, 1, 4, 4, 32), (2, 5, 4, 2, 64), (1, 63, 40, 8, 128),
    (2, 64, 8, 1, 80), (1, 65, 4, 4, 256), (2, 100, 40, 8, 64),
    (1, 2048, 8, 2, 128), (1, 100, 2, 1, 256), (3, 130, 6, 3, 16)])
def test_flash_attention_tensor_cores_matches_plain(card, B, S, H, Kh, dh,
                                                    causal):
    gen = torch.Generator().manual_seed(S * 5 + dh)
    q = randn(gen, (B, S, H, dh), torch.bfloat16, card)
    k = randn(gen, (B, S, Kh, dh), torch.bfloat16, card)
    v = randn(gen, (B, S, Kh, dh), torch.bfloat16, card)
    fa_mod.STATS.reset()
    got = fa_mod.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa_mod.STATS.instances == {"tensor_cores": 1}
    assert got.dtype == q.dtype and got.shape == q.shape
    check_flash(got, q, k, v, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_dh36_takes_cuda_cores(card, causal):
    gen = torch.Generator().manual_seed(36)
    q = randn(gen, (2, 70, 4, 36), torch.bfloat16, card)
    k = randn(gen, (2, 70, 2, 36), torch.bfloat16, card)
    v = randn(gen, (2, 70, 2, 36), torch.bfloat16, card)
    fa_mod.STATS.reset()
    got = fa_mod.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa_mod.STATS.instances == {"cuda_cores": 1}
    check_flash(got, q, k, v, causal)


@pytest.mark.parametrize("pad", [0, 4])
def test_flash_attention_tensor_cores_reads_strided_views(card, pad):
    """bf16 q/k/v as (B, H, S, dh + pad) tensors viewed as (B, S, H, dh):
    read in place (16-byte copies when pad is 0, element copies when the
    rows are not 16-byte aligned), same result as contiguous copies."""
    gen = torch.Generator().manual_seed(12 + pad)
    q, k, v = (randn(gen, (2, h, 70, 64 + pad), torch.bfloat16, card)
               [..., pad:].transpose(1, 2) for h in (4, 2, 2))
    fa_mod.STATS.reset()
    got = fa_mod.flash_attention(q, k, v)
    want = fa_mod.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    torch.cuda.synchronize()
    assert fa_mod.STATS.instances == {"tensor_cores": 2}
    assert torch.equal(got, want)


def test_flash_attention_reads_strided_views(card):
    """q/k/v as (B, H, S, dh) tensors viewed as (B, S, H, dh): read in
    place through their strides, same result as contiguous copies."""
    gen = torch.Generator().manual_seed(11)
    q, k, v = (randn(gen, (2, h, 70, 64), torch.float32, card)
               .transpose(1, 2) for h in (4, 2, 2))
    got = fa_mod.flash_attention(q, k, v)
    want = fa_mod.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _shared_prefix_trace(vocab, n=10, seed=3):
    rng = np.random.default_rng(seed)
    pres = [rng.integers(3, vocab, size=40).tolist() for _ in range(2)]
    return [(pres[i % 2] + rng.integers(3, vocab, size=int(
        rng.integers(4, 13))).tolist(), i % 6) for i in range(n)]


def test_reduced_engine_on_the_card(card):
    """Reduced Llama, f32, more adapters than LoRA slots: the card
    engine runs every kernel and no plain path, the fused and seed loops
    agree, and greedy tokens equal the CPU port's on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.core import Request
    from repro_torch.models import api
    from repro_torch.serving.engine import AdapterCatalog, EngineConfig
    from repro_torch.serving.systems import build_engine
    cfg = get_config("chameleon-llama-7b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    base = dict(max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8)
    catalog = AdapterCatalog(cfg, 8, 32, seed=0, device="cpu")
    trace = _shared_prefix_trace(cfg.vocab_size)
    stats = (bgmv_mod.STATS, sgmv_mod.STATS, pa_mod.STATS)
    out = {}
    for dev, fused in (("cpu", True), ("cuda", True), ("cuda", False)):
        t = [0.0]
        eng = build_engine("chameleon", cfg, params,
                           EngineConfig(**base, fused_hotloop=fused,
                                        lora_backend="kernel"),
                           catalog=catalog, clock=lambda: t[0], device=dev)
        for s in stats:
            s.reset()
        out[(dev, fused)] = _serve(eng, trace, Request, t)
        if dev == "cuda":
            assert all(s.launches > 0 for s in stats), \
                [s.launches for s in stats]
            assert all(s.plain == 0 for s in stats)
            assert eng.prefix_hit_tokens > 0
    assert out[("cuda", True)] == out[("cuda", False)]
    assert out[("cuda", True)] == out[("cpu", True)]


@pytest.mark.parametrize("knob", [dict(paged=False),
                                  dict(prefix_cache=False)])
def test_reduced_dense_prefill_engines_on_the_card(card, knob):
    """The dense slab and the non-prefix paged engine at reduced width,
    f32: prefill runs flash_attention on the card and no plain path,
    the fused and seed loops agree, and greedy tokens equal the CPU
    port's."""
    from repro_torch.configs import get_config
    from repro_torch.core import Request
    from repro_torch.models import api
    from repro_torch.serving.engine import AdapterCatalog, EngineConfig
    from repro_torch.serving.systems import build_engine
    cfg = get_config("chameleon-llama-7b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    base = dict(max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8)
    catalog = AdapterCatalog(cfg, 8, 32, seed=0, device="cpu")
    trace = _shared_prefix_trace(cfg.vocab_size)
    stats = {"bgmv": bgmv_mod.STATS, "sgmv": sgmv_mod.STATS,
             "paged_attention": pa_mod.STATS,
             "flash_attention": fa_mod.STATS}
    out = {}
    for dev, fused in (("cpu", True), ("cuda", True), ("cuda", False)):
        t = [0.0]
        eng = build_engine("chameleon", cfg, params,
                           EngineConfig(**base, **knob, fused_hotloop=fused,
                                        lora_backend="kernel"),
                           catalog=catalog, clock=lambda: t[0], device=dev)
        for st in stats.values():
            st.reset()
        out[(dev, fused)] = _serve(eng, trace, Request, t)
        if dev == "cuda":
            launched = {n: st.launches > 0 for n, st in stats.items()}
            assert launched == {"bgmv": True, "sgmv": True,
                                "flash_attention": True,
                                "paged_attention": eng.paged}, launched
            assert all(st.plain == 0 for st in stats.values())
    assert out[("cuda", True)] == out[("cuda", False)]
    assert out[("cuda", True)] == out[("cpu", True)]


def _serve(eng, trace, request_cls, t, dt=0.01):
    """Submit the trace, step to drained on the virtual clock ``t``."""
    handles = [eng.submit(request_cls(input_len=len(p), output_len=8,
                                      adapter_id=a, prompt=list(p)))
               for p, a in trace]
    for _ in range(5000):
        if not eng.busy():
            break
        for stream in eng._load_streams.values():
            # Land side-stream slot copies before the step polls them,
            # as the CPU engine's synchronous copies are: the schedule
            # then does not depend on copy timing.
            stream.synchronize()
        eng.step()
        t[0] += dt
    assert not eng.busy(), "engine failed to drain"
    assert all(len(h.tokens) == 8 for h in handles)
    return [h.tokens for h in handles]


def _reduced_model():
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import AdapterCatalog
    cfg = get_config("chameleon-llama-7b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    return cfg, params, AdapterCatalog(cfg, 8, 32, seed=0, device="cpu")


def _engine(model, dev, **kw):
    """A reduced f32 engine on ``dev`` with its own virtual clock."""
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.systems import build_engine
    cfg, params, catalog = model
    t = [0.0]
    eng = build_engine("chameleon", cfg, params,
                       EngineConfig(max_slots=4, max_len=128,
                                    n_lora_slots=4, n_adapters=8,
                                    lora_backend="kernel", **kw),
                       catalog=catalog, clock=lambda: t[0], device=dev)
    return eng, t


def _step(eng, t, dt=0.01):
    for stream in eng._load_streams.values():
        stream.synchronize()
    eng.step()
    t[0] += dt


#: (input_len, output_len, adapter) of tests/test_disagg.py's chunked
#: prefill test.
CHUNK_SPEC = [(25, 8, 0), (6, 5, 1), (40, 6, 2), (10, 4, 0), (33, 7, 3)]


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_reduced_chunked_engine_on_the_card(card, chunk):
    """Chunked prefill at reduced width, f32: the card's tokens equal
    the CPU port's; each chunk is a suffix prefill (sgmv) and decode
    runs paged_attention and bgmv, with no plain path."""
    from repro_torch.core import Request
    model = _reduced_model()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 200, L).tolist() for L, _, _ in CHUNK_SPEC]
    stats = (bgmv_mod.STATS, sgmv_mod.STATS, pa_mod.STATS)
    out = {}
    for dev in ("cpu", "cuda"):
        eng, t = _engine(model, dev, prefill_chunk_tokens=chunk)
        for s in stats:
            s.reset()
        hs = [eng.submit(Request(input_len=L, output_len=O, adapter_id=a,
                                 prompt=list(p)))
              for (L, O, a), p in zip(CHUNK_SPEC, prompts)]
        for _ in range(5000):
            if not eng.busy():
                break
            _step(eng, t)
        assert not eng.busy()
        out[dev] = [h.tokens for h in hs]
        assert eng.n_chunked_prefills == sum(L > chunk
                                             for L, _, _ in CHUNK_SPEC)
        if dev == "cuda":
            assert all(s.launches > 0 for s in stats)
            assert all(s.plain == 0 for s in stats)
    assert out["cuda"] == out["cpu"]


def _migrate(model, dev, paged, prompt, pipelined=False):
    """Export the request after 3 tokens (from a horizon-1 source, or
    from a default source with a horizon in flight), import it into a
    default engine, finish there. Returns (tokens, shipment)."""
    from repro_torch.core import Request
    knobs = ({} if pipelined
             else dict(max_horizon=1, pipeline_readback=False))
    src, ts = _engine(model, dev, paged=paged, **knobs)
    dst, td = _engine(model, dev, paged=paged)
    req = Request(input_len=len(prompt), output_len=10, adapter_id=1,
                  prompt=list(prompt))
    h = src.submit(req)
    for _ in range(200):
        if len(h.tokens) >= 3 and (not pipelined
                                   or src._inflight is not None):
            break
        _step(src, ts)
    assert (src._inflight is not None) == pipelined
    ship = src.begin_migration(req)
    assert ship["cache_len"] == len(prompt) + req.generated - 1
    assert dst.import_request_kv(ship)
    src.complete_migration(req)
    h._system = dst
    for _ in range(1000):
        if not dst.busy():
            break
        _step(dst, td)
    assert h.done and len(h.tokens) == 10
    return h.tokens, ship


@pytest.mark.parametrize("paged", [True, False])
def test_reduced_migration_on_the_card(card, paged):
    """A request exported after 3 tokens and imported into a second
    card engine streams the CPU port's tokens; the payload is a pinned
    host copy within 1e-4 of the CPU's."""
    model = _reduced_model()
    prompt = np.random.default_rng(5).integers(1, 200, 25).tolist()
    want, cpu_ship = _migrate(model, "cpu", paged, prompt)
    got, ship = _migrate(model, "cuda", paged, prompt)
    assert got == want
    for key in ("k", "v"):
        assert ship[key].device.type == "cpu" and ship[key].is_pinned()
        torch.testing.assert_close(ship[key], cpu_ship[key], rtol=1e-4,
                                   atol=1e-4)
    assert ship["nbytes"] == cpu_ship["nbytes"]


def test_export_with_a_pipelined_horizon_in_flight_on_the_card(card):
    """Default engines: the export drains the in-flight horizon, and the
    migrated request streams the CPU port's single-engine tokens."""
    from repro_torch.core import Request
    model = _reduced_model()
    prompt = np.random.default_rng(5).integers(1, 200, 25).tolist()
    eng, t = _engine(model, "cpu")
    h = eng.submit(Request(input_len=25, output_len=10, adapter_id=1,
                           prompt=list(prompt)))
    while eng.busy():
        _step(eng, t)
    got, _ = _migrate(model, "cuda", True, prompt, pipelined=True)
    assert got == h.tokens


# ------------------------------------------------ speculative decoding
@pytest.mark.parametrize("dout", [4096, 1024])
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_sgmv_verify_shape_tile8_matches_plain(card, xdt, dout):
    """sgmv at the speculative verify pass's shape: 8 rows of S 8 (a
    verify of 2-8 tokens pads to one tile of 8), tile 8, r 32, 8 slots,
    din 4096, dout 4096 (q, o) and 1024 (an 8-kv-head k, v)."""
    gen = torch.Generator().manual_seed(dout + len(xdt))
    x = randn(gen, (64, 4096), DT[xdt], card)
    A = randn(gen, (8, 4096, 32), torch.bfloat16, card, 4096 ** -0.5)
    B = randn(gen, (8, 32, dout), torch.bfloat16, card, 32 ** -0.5)
    ts = torch.randint(0, 8, (8,), generator=gen).int().to(card)
    sgmv_mod.STATS.reset()
    got = sgmv_mod.sgmv(x, A, B, ts, 8)
    torch.cuda.synchronize()
    assert sgmv_mod.STATS.tiles == {8: 1}
    assert sgmv_mod.STATS.instances == {sgmv_instance(xdt, "bf16"): 1}
    torch.testing.assert_close(got.float(),
                               sgmv_mod.sgmv_plain(x, A, B, ts, 8).float(),
                               **tol(xdt, "bf16"))


def test_lora_delta_at_verify_length_runs_sgmv_at_tile_8(card):
    """The verify pass's LoRA (S = spec_k + 1 = 5 tokens a row) pads
    each row to one tile of 8 tokens."""
    from repro_torch.kernels.ops import lora_delta_kernel
    gen = torch.Generator().manual_seed(8)
    x = randn(gen, (8, 5, 256), torch.bfloat16, card)
    A = randn(gen, (4, 256, 16), torch.bfloat16, card, 256 ** -0.5)
    B = randn(gen, (4, 16, 384), torch.bfloat16, card, 16 ** -0.5)
    idx = torch.randint(0, 4, (8,), generator=gen).int().to(card)
    sgmv_mod.STATS.reset()
    got = lora_delta_kernel(x, A, B, idx)
    torch.cuda.synchronize()
    assert sgmv_mod.STATS.tiles == {8: 1}
    want = lora_delta_kernel(x.cpu(), A.cpu(), B.cpu(), idx.cpu())
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               **tol("bf16", "bf16"))


def _spec_draft():
    from repro_torch.configs import get_config
    from repro_torch.models import api
    dcfg = get_config("internlm2-1.8b").reduced(n_layers=2, vocab_size=512)
    return dcfg, api.init_params(dcfg, 7, torch.float32, device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_verify_on_the_card(card, paged):
    """``verify`` / ``verify_paged`` at reduced width, f32, LoRA through
    the kernels: the card against the CPU port. Logits and K/V within
    2e-4 (f32 sums in another order, four layers deep); the q/k/v/o LoRA
    runs sgmv at tile 8, four launches a layer."""
    from repro_torch.models import api
    from repro_torch.models.lora_apply import (init_lora_slots,
                                               random_lora_weights,
                                               write_adapter_to_slot)
    cfg, params, _ = _reduced_model()
    slots = init_lora_slots(3, cfg.n_layers, cfg.d_model, cfg.q_dim,
                            cfg.kv_dim, 32, dtype=torch.float32,
                            device="cpu")
    gen = torch.Generator().manual_seed(5)
    for i, rank in enumerate((8, 16, 32)):
        write_adapter_to_slot(slots, random_lora_weights(
            gen, rank, 32, cfg.n_layers, cfg.d_model, cfg.q_dim,
            cfg.kv_dim, dtype=torch.float32), i)
    B, S, P, page = 3, 5, 4, 16
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).int()
    clen = torch.tensor([13, P * page - 3, 20], dtype=torch.int32)
    seq = torch.tensor([5, 5, 2], dtype=torch.int32)
    idx = torch.tensor([1, 2, 0], dtype=torch.int32)
    table = (1 + torch.arange(B * P)).view(B, P).int()
    out = {}
    for dev in ("cpu", "cuda"):
        g = torch.Generator().manual_seed(6)
        if paged:
            kv = tuple(torch.randn((cfg.n_layers, 1 + B * P, page,
                                    cfg.n_kv_heads, cfg.head_dim),
                                   generator=g).to(dev) for _ in range(2))
        else:
            kv = tuple(torch.randn((cfg.n_layers, B, P * page,
                                    cfg.n_kv_heads, cfg.head_dim),
                                   generator=g).to(dev) for _ in range(2))
        kw = dict(seq_len=seq.to(dev), adapter_idx=idx.to(dev),
                  lora={k: (a.to(dev), b.to(dev))
                        for k, (a, b) in slots.items()},
                  lora_backend="kernel")
        mv = {k: v.to(dev) for k, v in params.items()}
        sgmv_mod.STATS.reset()
        if paged:
            logits, kv = api.verify_paged(cfg, mv, toks.to(dev), kv,
                                          table.to(dev), clen.to(dev), **kw)
            kv = tuple(t[:, 1:] for t in kv)      # page 0 is the trash
        else:
            logits, kv = api.verify(cfg, mv, toks.to(dev), kv, clen.to(dev),
                                    **kw)
        out[dev] = [t.cpu() for t in (logits, *kv)]
        if dev == "cuda":
            torch.cuda.synchronize()
            assert sgmv_mod.STATS.tiles == {8: 4 * cfg.n_layers}
            assert sgmv_mod.STATS.plain == 0
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("paged", [True, False])
def test_reduced_spec_engine_on_the_card(card, paged):
    """A speculative engine at reduced width, f32, with the 2-layer
    internlm2 draft, every second request seeded-sampled: the card's
    tokens and drafted/accepted counts equal the CPU port's; the verify
    LoRA ran sgmv at tile 8, with no plain path."""
    from repro_torch.core import Request, SamplingParams
    from repro_torch.serving.engine import ChameleonEngine, EngineConfig
    cfg, params, catalog = _reduced_model()
    draft = _spec_draft()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 200, L).tolist() for L, _, _ in CHUNK_SPEC]
    stats = (bgmv_mod.STATS, sgmv_mod.STATS)
    out = {}
    for dev in ("cpu", "cuda"):
        t = [0.0]
        eng = ChameleonEngine(
            cfg, params, EngineConfig(
                max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8,
                lora_backend="kernel", paged=paged, spec_decode=True),
            catalog=catalog, clock=lambda: t[0], draft=draft, device=dev)
        for s in stats:
            s.reset()
        hs = [eng.submit(Request(input_len=L, output_len=O + 8,
                                 adapter_id=a, prompt=list(p)),
                         sampling=(SamplingParams(temperature=0.8, top_k=20,
                                                  seed=i) if i % 2 else None))
              for i, ((L, O, a), p) in enumerate(zip(CHUNK_SPEC, prompts))]
        for _ in range(5000):
            if not eng.busy():
                break
            _step(eng, t)
        assert not eng.busy()
        st = eng.spec_stats()
        out[dev] = ([h.tokens for h in hs], st["spec_drafted_tokens"],
                    st["spec_accepted_tokens"])
        if dev == "cuda":
            assert sgmv_mod.STATS.tiles.get(8, 0) > 0
            assert all(s.plain == 0 for s in stats)
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][1] > 0


@pytest.mark.parametrize("B,S,top_k,cf", [(4, 32, 4, 1.25), (2, 64, 2, 0.5),
                                          (8, 1, 8, 1.25)])
def test_moe_blocks_on_the_card(card, B, S, top_k, cf):
    """The MoE blocks in f32 on the card against the CPU on the same
    inputs: routing, the kept/dropped pattern and the drop count equal,
    outputs within 1e-4 (f32 sums in another order). S == 1 is the
    dropless expert gather; cf 0.5 drops assignments."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(21)
    D, E, F = 256, 16, 192
    x = torch.randn(B, S, D, generator=gen)
    w = [torch.randn(s, generator=gen) / s[-2] ** 0.5
         for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    out = {}
    for dev in ("cpu", "cuda"):
        args = [t.to(dev) for t in (x, *w)]
        moe.STATS.reset()
        if S == 1:
            y, aux = moe.moe_block_gather(*args, top_k)
        else:
            y, aux = moe.moe_block(*args, top_k, cf)
        _, idx, _ = moe.route(args[0], args[1], top_k)
        out[dev] = (y.cpu(), aux.cpu(), idx.cpu(), moe.STATS.dropped,
                    moe.STATS.experts_read)
    (yc, ac, ic, dc, ec), (yg, ag, ig, dg, eg) = out["cpu"], out["cuda"]
    assert torch.equal(ig, ic)
    assert (dg, eg) == (dc, ec)
    if cf < 1:
        assert dc > 0
    torch.testing.assert_close(yg, yc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ag, ac, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_reduced_moe_engine_on_the_card(card, name):
    """A reduced MoE engine, f32, under ``EngineConfig()`` (which serves
    MoE from the dense slab): the card's fused and seed loops give the
    CPU port's tokens; prefill runs flash_attention and sgmv, decode
    bgmv, paged_attention never, and no plain path."""
    from repro_torch.configs import get_config
    from repro_torch.core import Request
    from repro_torch.models import api
    from repro_torch.serving.engine import AdapterCatalog
    cfg = get_config(name).reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    model = (cfg, params, AdapterCatalog(cfg, 8, 32, seed=0, device="cpu"))
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 200, L).tolist() for L, _, _ in CHUNK_SPEC]
    stats = {"bgmv": bgmv_mod.STATS, "sgmv": sgmv_mod.STATS,
             "paged_attention": pa_mod.STATS,
             "flash_attention": fa_mod.STATS}
    out = {}
    for dev, fused in (("cpu", True), ("cuda", True), ("cuda", False)):
        eng, t = _engine(model, dev, fused_hotloop=fused)
        assert not eng.paged
        for st in stats.values():
            st.reset()
        hs = [eng.submit(Request(input_len=L, output_len=O + 6,
                                 adapter_id=a, prompt=list(p)))
              for (L, O, a), p in zip(CHUNK_SPEC, prompts)]
        for _ in range(5000):
            if not eng.busy():
                break
            _step(eng, t)
        assert not eng.busy()
        out[(dev, fused)] = [h.tokens for h in hs]
        if dev == "cuda":
            launched = {n: st.launches > 0 for n, st in stats.items()}
            assert launched == {"bgmv": True, "sgmv": True,
                                "flash_attention": True,
                                "paged_attention": False}, launched
            assert all(st.plain == 0 for st in stats.values())
    assert out[("cuda", True)] == out[("cuda", False)] == out[("cpu", True)]


def _repeated_mesh(shape, dev):
    from repro_torch.launch.mesh import Mesh
    grid = np.empty(shape[0] * shape[1], dtype=object)
    grid[:] = [dev] * grid.size
    return Mesh(grid.reshape(shape), ("data", "model"))


@pytest.mark.parametrize("name,shape", [("qwen3-moe-235b-a22b", (2, 1)),
                                        ("llama4-maverick-400b-a17b",
                                         (2, 1)),
                                        ("qwen3-moe-235b-a22b", (2, 2)),
                                        ("granite-34b", (1, 2))])
def test_mesh_step_functions_on_the_card(card, name, shape):
    """The step functions on a mesh over repeated positions of the card,
    f32, against the unsharded CPU port on the same weights and inputs:
    the whole-prompt prefill's logits and K/V, then one decode step over
    the slab holding the CPU's prompt K/V (MoE: experts over "data";
    granite-34b: one KV head shared by both columns, the slab split
    along its positions), within 1e-4; flash_attention, sgmv and bgmv
    launch, no plain version runs."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import MeshParams
    from repro_torch.models import api
    from repro_torch.serving.shard_plan import ShardPlan
    cfg = get_config(name).reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    rng = np.random.default_rng(31)
    B, S, Smax = 4, 24, 48
    toks = torch.as_tensor(rng.integers(3, cfg.vocab_size, (B, S)),
                           dtype=torch.int32)
    nxt = torch.as_tensor(rng.integers(3, cfg.vocab_size, (B, 1)),
                          dtype=torch.int32)
    clen = torch.full((B,), S, dtype=torch.int32)
    from repro_torch.models.lora_apply import (init_lora_slots,
                                               random_lora_weights,
                                               write_adapter_to_slot)
    lora = init_lora_slots(4, cfg.n_layers, cfg.d_model, cfg.q_dim,
                           cfg.kv_dim, 8, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for i in range(4):
        write_adapter_to_slot(lora, random_lora_weights(
            gen, 8, 8, cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim,
            torch.float32), i)
    aidx = torch.arange(B, dtype=torch.int32)
    kw = dict(adapter_idx=aidx, lora_backend="kernel")
    want, (k, v) = api.prefill(cfg, params, toks, lora=lora, **kw)
    slab = api.init_serve_state(cfg, B, Smax, torch.float32, device="cpu")
    for t, new in zip(slab, (k, v)):
        t[:, :, :S] = new
    want_step, _ = api.decode_step(cfg, params, nxt,
                                   tuple(t.clone() for t in slab), clen,
                                   lora=lora, **kw)
    mesh = _repeated_mesh(shape, card)
    plan = ShardPlan(mesh, cfg)
    sh = plan.params(params)
    mp = MeshParams(cfg, {p: sh[p].shard(t.to(card))
                          for p, t in params.items()}, mesh)
    lsh = plan.lora_slots(lora)
    mlora = {p: (lsh[p][0].shard(a.to(card)), lsh[p][1].shard(b.to(card)))
             for p, (a, b) in lora.items()}
    stats = [bgmv_mod.STATS, sgmv_mod.STATS, fa_mod.STATS, pa_mod.STATS]
    for st in stats:
        st.reset()
    dkw = dict(adapter_idx=aidx.to(card), lora_backend="kernel")
    got, _ = api.prefill(cfg, mp, toks.to(card), lora=mlora, **dkw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    mslab = tuple(plan.zeros_kv_dense(tuple(t.shape), torch.float32)
                  .copy_(t.to(card)) for t in slab)
    got_step, mslab = api.decode_step(cfg, mp, nxt.to(card), mslab,
                                      clen.to(card), lora=mlora, **dkw)
    torch.testing.assert_close(got_step.cpu(), want_step, rtol=1e-4,
                               atol=1e-4)
    assert all(s.launches > 0 for s in stats[:3])
    assert pa_mod.STATS.launches == 0
    assert all(s.plain == 0 for s in stats)


@pytest.mark.parametrize("n", [2, 4])
def test_moe_a2a_on_the_card(card, n):
    """``moe_block_a2a`` over n data shards at repeated positions of
    the card, f32: within 1e-4 of ``moe_block`` run on each batch shard
    on the card (the same group-local capacity, so the same drops) and
    of the same a2a on the CPU."""
    from repro_torch.models import moe
    from repro_torch.models.moe_shard_map import moe_block_a2a
    gen = torch.Generator().manual_seed(23)
    B, S, D, E, F = 8, 32, 128, 8, 96
    x = torch.randn(B, S, D, generator=gen)
    w = [torch.randn(s, generator=gen) / s[-2] ** 0.5
         for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    out = {}
    for dev in ("cpu", "cuda"):
        args = [t.to(dev) for t in (x, *w)]
        mesh = _repeated_mesh((n, 1), torch.device(dev))
        moe.STATS.reset()
        blocks = [list(t.chunk(n)) for t in args[2:]]
        y, aux = moe_block_a2a(*args[:2], *blocks, 2, 1.0, mesh,
                               group_size=64)
        out[dev] = (y.cpu(), aux.cpu(), moe.STATS.dropped)
        if dev == "cuda":
            per = [moe.moe_block(xs, *args[1:], 2, 1.0, group_size=64)
                   for xs in args[0].chunk(n)]
            torch.testing.assert_close(
                y, torch.cat([p[0] for p in per]), rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(
                aux, torch.stack([p[1] for p in per]).mean(), rtol=1e-5,
                atol=1e-6)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    assert out["cuda"][2] == out["cpu"][2] > 0


def test_moe_engine_on_a_mesh_of_bare_cuda_positions(card, monkeypatch):
    """An engine whose mesh is built from bare ``cuda`` devices (two
    data shards at repeated positions of the card), reduced qwen3-moe
    in f32: every adapter it loads lands in every shard of its arena,
    and it serves the tokens of ``EngineConfig()`` on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core import Request
    from repro_torch.models import api
    from repro_torch.serving import engine
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    model = (cfg, params, engine.AdapterCatalog(cfg, 8, 32, seed=0,
                                                device="cpu"))
    monkeypatch.setattr(engine, "make_serving_mesh",
                        lambda n, m, device=None: _repeated_mesh(
                            (n // m, m), torch.device("cuda")))
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 200, L).tolist() for L, _, _ in CHUNK_SPEC]
    out = {}
    for shape in (None, (2, 1)):
        eng, t = _engine(model, "cuda", mesh_shape=shape)
        hs = [eng.submit(Request(input_len=L, output_len=O + 6,
                                 adapter_id=a, prompt=list(p)))
              for (L, O, a), p in zip(CHUNK_SPEC, prompts)]
        for _ in range(5000):
            if not eng.busy():
                break
            _step(eng, t)
        assert not eng.busy()
        out[shape] = [h.tokens for h in hs]
        if shape is not None:
            assert eng._load_streams and all(
                d.index is not None for d in eng._load_streams)
            a, b = eng.lora["q"]
            for slot in eng.slot_of.values():
                assert all(bool(x[:, slot].abs().sum() > 0)
                           for st in (a, b) for _, x in st.unique())
    assert out[(2, 1)] == out[None]


@pytest.mark.parametrize("T", [16, 70])
def test_ssm_scans_on_the_card(card, T):
    """The Mamba1 fused scan and the Mamba2 SSD, f32, chunk 32: the card
    within 1e-4 of the CPU on the same inputs."""
    from repro_torch.models import ssm
    g = torch.Generator().manual_seed(T)

    def r(*s, lo=None, hi=None):
        if lo is None:
            return torch.randn(s, generator=g)
        return lo + (hi - lo) * torch.rand(s, generator=g)
    m1 = (r(2, T, 64, lo=0.01, hi=0.5), -r(64, 16, lo=1.0, hi=16.0),
          r(2, T, 64), r(2, T, 16), r(2, T, 16), r(2, 64, 16))
    m2 = (r(2, T, 4, 32), r(2, T, 4, lo=0.01, hi=2.0),
          -r(4, lo=1.0, hi=16.0), r(2, T, 16), r(2, T, 16))
    for fn, args in ((lambda *a: ssm._mamba1_fused_scan(*a, 32), m1),
                     (lambda *a: ssm.ssd_chunked(*a, 32), m2)):
        want = fn(*args)
        got = fn(*(a.cuda() for a in args))
        for g_, w in zip(got, want):
            assert torch.isfinite(g_).all()
            torch.testing.assert_close(g_.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-1.2b",
                                  "whisper-base"])
def test_reduced_family_on_the_card(card, name):
    """The families without an engine, reduced, f32: ``forward``,
    ``train_loss``, ``prefill`` and 3 decode steps fed the CPU's greedy
    tokens, the card within 1e-4 of the CPU; the hybrid's LoRA through
    sgmv and bgmv, flash_attention in the hybrid and enc-dec prefill,
    no plain version on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, hybrid
    from repro_torch.models.lora_apply import (init_lora_slots,
                                               random_lora_weights,
                                               write_adapter_to_slot)
    cfg = get_config(name).reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    g = torch.Generator().manual_seed(3)
    B, S, n = 2, 40, 3
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g).int()
    kw, lora, idx = {}, None, torch.tensor([1, 0], dtype=torch.int32)
    if name == "whisper-base":
        kw["frames"] = torch.randn((B, cfg.enc_ctx, cfg.d_model),
                                   generator=g)
    if name == "zamba2-1.2b":
        n_sites = len(hybrid.attn_sites(cfg))
        lora = init_lora_slots(2, n_sites, cfg.d_model, cfg.q_dim,
                               cfg.kv_dim, 8, dtype=torch.float32,
                               device="cpu")
        for i, rank in enumerate((4, 8)):
            write_adapter_to_slot(lora, random_lora_weights(
                g, rank, 8, n_sites, cfg.d_model, cfg.q_dim, cfg.kv_dim,
                dtype=torch.float32), i)
    stats = {"bgmv": bgmv_mod.STATS, "sgmv": sgmv_mod.STATS,
             "flash_attention": fa_mod.STATS}
    out, feed = {}, None
    for dev in ("cpu", "cuda"):
        mv = {k: v.to(dev) for k, v in params.items()}
        k = {a: v.to(dev) for a, v in kw.items()}
        t = toks.to(dev)
        pkw = dict(k)
        dkw = {}
        if lora is not None:
            lr = {p: (a.to(dev), b.to(dev)) for p, (a, b) in lora.items()}
            dkw = dict(lora=lr, adapter_idx=idx.to(dev),
                       lora_backend="kernel")
            pkw.update(dkw, kv_max_len=S + n)
        for st in stats.values():
            st.reset()
        with torch.no_grad():
            res = [api.forward(cfg, mv, t, **k),
                   api.train_loss(cfg, mv, t, t.roll(-1, 1), **k)]
            last, state = api.prefill(cfg, mv, t, **pkw)
            res.append(last)
            if name == "whisper-base":
                (ks, vs), cross = state
                pad = (0, 0, 0, 0, 0, n)
                state = ((torch.nn.functional.pad(ks, pad),
                          torch.nn.functional.pad(vs, pad)), cross)
            fed, logits = [], last
            for i in range(n):
                tok = (feed[:, i:i + 1].to(dev) if feed is not None
                       else logits.argmax(-1)[:, None].int())
                fed.append(tok.cpu())
                logits, state = api.decode_step(
                    cfg, mv, tok, state,
                    torch.full((B,), S + i, dtype=torch.int32, device=dev),
                    **dkw)
                res.append(logits)
        feed = torch.cat(fed, 1)
        out[dev] = [x.cpu() for x in res]
        if dev == "cuda":
            want = {"falcon-mamba-7b": set(),
                    "zamba2-1.2b": {"bgmv", "sgmv", "flash_attention"},
                    "whisper-base": {"flash_attention"}}[name]
            assert {n_ for n_, st in stats.items() if st.launches} == want
            assert all(st.plain == 0 for st in stats.values())
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_kernel_wrappers_refuse_grad_on_the_card(card):
    """bgmv, sgmv and paged_attention, called on card tensors that
    require grad, raise (no backward kernel; the same calls without
    grad run the kernel); flash_attention goes through its backward
    kernel."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(5)
    x = randn(gen, (2, 64), torch.float32, card).requires_grad_(True)
    A = randn(gen, (2, 64, 8), torch.float32, card)
    Bw = randn(gen, (2, 8, 32), torch.float32, card)
    idx = torch.tensor([1, 0], dtype=torch.int32, device=card)
    qd = randn(gen, (2, 2, 1, 32), torch.float32, card).requires_grad_(True)
    pages = randn(gen, (4, 16, 2, 32), torch.float32, card)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=card)
    lens = torch.tensor([20, 9], dtype=torch.int32, device=card)
    calls = {"bgmv": lambda: ops.lora_bgmv(x, A, Bw, idx),
             "sgmv": lambda: ops.lora_delta_kernel(x[None], A, Bw,
                                                   idx[:1]),
             "paged_attention": lambda: ops.paged_attention(
                 qd, pages, pages, table, lens)}
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="no backward pass"):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()).all()
    q = torch.randn((1, 64, 2, 32), device="cuda", requires_grad=True)
    k = torch.randn((1, 64, 2, 32), device="cuda")
    fa_mod.STATS.reset()
    fa_mod.BWD_STATS.reset()
    out = ops.flash_attention(q, k, k)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (fa_mod.STATS.launches, fa_mod.BWD_STATS.launches) == (1, 1)
    assert torch.isfinite(q.grad).all()


def check_flash_bwd(q, k, v, causal):
    """The backward kernel on (q, k, v, their forward's output and
    log-sum-exp, a random dO) against the plain version on the same
    values in f32, within ``flash_bwd_tol``; one launch of the instance
    ``flash_bwd_instance`` names, no plain call, and a second call
    returns the same bits (no atomics)."""
    gen = torch.Generator().manual_seed(q.shape[1] + 3)
    out, lse = fa_mod.flash_attention(q, k, v, causal, return_lse=True)
    dout = randn(gen, q.shape, q.dtype, q.device)
    fa_mod.BWD_STATS.reset()
    got = fa_mod.flash_attention_bwd(q, k, v, out, dout, causal, lse=lse)
    torch.cuda.synchronize()
    inst = fa_mod.flash_bwd_instance(q.dtype, q.shape[-1])
    assert inst == ("tf32x3" if q.dtype == torch.float32 else "tensor_cores")
    assert fa_mod.BWD_STATS.instances == {inst: 1}
    assert fa_mod.BWD_STATS.plain == 0
    again = fa_mod.flash_attention_bwd(q, k, v, out, dout, causal, lse=lse)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    want = fa_mod.flash_attention_bwd_plain(
        *(t.float() for t in (q, k, v, out, dout)), causal)
    for name, g, w, t, bound in zip(
            "qkv", got, want, (q, k, v),
            flash_bwd_tol(q, k, v, out, dout, causal, want)):
        assert g.dtype == t.dtype and g.shape == t.shape
        err = (g.float() - w).abs()
        assert (err <= bound).all(), (name, err.max().item())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kh,dh", [
    (1, 1, 1, 1, 32), (2, 5, 4, 2, 4), (1, 100, 8, 8, 64),
    (2, 100, 4, 1, 128), (1, 130, 40, 8, 128), (3, 64, 6, 3, 36),
    (1, 300, 2, 2, 256), (2, 256, 32, 32, 128), (1, 129, 8, 2, 80)])
def test_flash_attention_bwd_matches_plain(card, B, S, H, Kh, dh, causal,
                                           dt):
    gen = torch.Generator().manual_seed(S * 11 + H)
    q = randn(gen, (B, S, H, dh), DT[dt], card)
    k = randn(gen, (B, S, Kh, dh), DT[dt], card)
    v = randn(gen, (B, S, Kh, dh), DT[dt], card)
    check_flash_bwd(q, k, v, causal)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Kh,dh,causal", [
    (8, 512, 16, 8, 128, True),      # internlm2-1.8b, the launcher's batch
    (8, 256, 32, 32, 128, True),     # Llama prefill bucket
    (1, 2048, 32, 32, 128, True),
    (8, 1500, 8, 8, 64, False),      # whisper's encoder
    (8, 512, 32, 32, 64, True),      # zamba2's shared block
    (1, 1024, 64, 4, 128, True),     # qwen3-moe's (2, 1) shard: G 16
    (2, 1024, 32, 2, 128, True),     # qwen3-moe's (1, 2) shard
    (4, 512, 28, 4, 128, True),      # qwen2-vl's (2, 1) shard: G 7
    (1, 16384, 2, 1, 128, False),    # dq walks 2048 k-steps, dk/dv 4096
    (4, 512, 32, 32, 64, True),      # zamba2's (2, 1) shard
    (8, 512, 16, 16, 64, True),      # zamba2's (1, 2) shard
    (4, 1500, 8, 8, 64, False),      # whisper's encoder, (2, 1) shard
    (8, 1500, 4, 4, 64, False),      # whisper's encoder, (1, 2) shard
    (4, 256, 4, 4, 64, True)])       # whisper's decoder, (2, 2) shard
def test_flash_attention_bwd_at_the_training_shapes(card, B, S, H, Kh, dh,
                                                    causal, dt):
    gen = torch.Generator().manual_seed(S + H + dh)
    q = randn(gen, (B, S, H, dh), DT[dt], card)
    k = randn(gen, (B, S, Kh, dh), DT[dt], card)
    v = randn(gen, (B, S, Kh, dh), DT[dt], card)
    check_flash_bwd(q, k, v, causal)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("dh", [8, 64, 128, 256])
@pytest.mark.parametrize("S", [21, 37])
def test_flash_attention_bwd_ragged_gqa(card, S, dh, G, causal, dt):
    """Ragged S, every instance width (dh 8 zero-padded to 32; 256 with
    its 32-row dk/dv blocks and, in f32, 16-key dq tiles) and GQA groups
    up to 8 summed inside the dk/dv block."""
    gen = torch.Generator().manual_seed(S * 31 + dh + G)
    q = randn(gen, (2, S, 2 * G, dh), DT[dt], card)
    k = randn(gen, (2, S, 2, dh), DT[dt], card)
    v = randn(gen, (2, S, 2, dh), DT[dt], card)
    check_flash_bwd(q, k, v, causal)


def test_flash_attention_bwd_without_lse_runs_the_forward(card):
    """Given no log-sum-exp, the wrapper takes it from one forward
    launch (counted in ``STATS``): same bits as with the forward's."""
    gen = torch.Generator().manual_seed(8)
    q, k, v, dout = (randn(gen, (2, 50, h, 64), torch.float32, card)
                     for h in (4, 2, 2, 4))
    out, lse = fa_mod.flash_attention(q, k, v, return_lse=True)
    want = fa_mod.flash_attention_bwd(q, k, v, out, dout, lse=lse)
    fa_mod.STATS.reset()
    fa_mod.BWD_STATS.reset()
    got = fa_mod.flash_attention_bwd(q, k, v, out, dout)
    torch.cuda.synchronize()
    assert (fa_mod.STATS.launches, fa_mod.BWD_STATS.launches) == (1, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [36, 64, 128])
def test_flash_attention_forward_lse_matches_plain(card, dh, causal, dt):
    """Both forward instances' log-sum-exp against
    ``flash_attention_lse_plain`` on the same values (1e-5 abs+rel; the
    scores and sums are f32 on both sides), and the output is the same
    bits with and without it."""
    gen = torch.Generator().manual_seed(dh + 5)
    q, k, v = (randn(gen, (2, 77, h, dh), DT[dt], card) for h in (8, 2, 2))
    fa_mod.STATS.reset()
    out, lse = fa_mod.flash_attention(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa_mod.STATS.instances == {fa_mod.flash_instance(DT[dt], dh): 1}
    assert torch.equal(out, fa_mod.flash_attention(q, k, v, causal))
    want = fa_mod.flash_attention_lse_plain(q, k, causal)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def test_flash_attention_bwd_reads_strided_views(card):
    """q/k/v and dO as (B, H, S, dh) tensors viewed as (B, S, H, dh):
    read in place, same gradients as contiguous copies."""
    gen = torch.Generator().manual_seed(13)
    q, k, v, dout = (randn(gen, (2, h, 70, 64), torch.float32, card)
                     .transpose(1, 2) for h in (4, 2, 2, 4))
    out = fa_mod.flash_attention(q, k, v)
    got = fa_mod.flash_attention_bwd(q, k, v, out, dout)
    want = fa_mod.flash_attention_bwd(*(t.contiguous()
                                        for t in (q, k, v, out, dout)))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_autograd_on_the_card(card, dt):
    """``ops.flash_attention`` on card tensors that require grad: one
    forward and one backward launch, no second forward, gradients
    within ``flash_bwd_tol`` of plain autograd."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(21)
    q, k, v = (randn(gen, (2, 96, h, 64), DT[dt], card).requires_grad_(True)
               for h in (8, 2, 2))
    dout = randn(gen, q.shape, DT[dt], card)
    fa_mod.STATS.reset()
    fa_mod.BWD_STATS.reset()
    out = ops.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (fa_mod.STATS.launches, fa_mod.BWD_STATS.launches) == (1, 1)
    assert fa_mod.STATS.plain == fa_mod.BWD_STATS.plain == 0
    args = [t.detach() for t in (q, k, v, out)]
    want = fa_mod.flash_attention_bwd_plain(
        *(t.float() for t in args + [dout]), True)
    for g, w, bound in zip(got, want, flash_bwd_tol(*args, dout, True,
                                                     want)):
        assert ((g.float() - w).abs() <= bound).all()


@pytest.mark.parametrize("name", [
    "internlm2-1.8b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
    "zamba2-1.2b", "whisper-base", "qwen2-vl-7b"])
def test_reduced_train_steps_on_the_card(card, name):
    """Two train steps of a reduced config in f32 on the card and on the
    CPU port from the same params and batches, within the tolerances of
    ``_port_training`` (loss, grad norm and lr 1e-4 relative; params
    after the first step 1e-4 where f32 resolves the gradient; after
    the second within lr a step, moments 1e-4); on the card every flash
    forward launch had its backward launch (none for the SSM) and no
    plain version ran."""
    from repro_torch.training import AdamWConfig
    from _port_training import TOL, card_vs_cpu_train_steps, states_ok
    torch.backends.cudnn.allow_tf32 = False
    out = card_vs_cpu_train_steps(name, AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10, clip_norm=0.5))
    assert out["metrics_err"] <= TOL, out
    assert states_ok(out["first"], out["final"]), out
    assert out["plain"] == 0, out
    assert out["bwd_launches"] == out["fwd_launches"], out
    assert (out["bwd_launches"] > 0) == (name != "falcon-mamba-7b"), out


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("name", ["internlm2-1.8b", "granite-34b",
                                  "qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b", "qwen2-vl-7b",
                                  "falcon-mamba-7b", "zamba2-1.2b",
                                  "whisper-base"])
def test_sharded_train_steps_on_the_card(card, name, shape):
    """Two train steps of a reduced config of any family in f32 with the
    state placed on a mesh over repeated positions of the card against
    the unsharded CPU port (``_port_training`` tolerances); flash
    forward and backward once an attention layer a position a step."""
    from repro_torch.configs import get_config
    from repro_torch.training import AdamWConfig
    from _port_training import (TOL, attention_layers,
                                card_vs_cpu_train_steps, states_ok)
    torch.backends.cudnn.allow_tf32 = False
    out = card_vs_cpu_train_steps(name, AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10, clip_norm=0.5),
        mesh_shape=shape)
    assert out["metrics_err"] <= TOL, out
    assert states_ok(out["first"], out["final"]), out
    assert out["plain"] == 0, out
    layers = attention_layers(get_config(name).reduced())
    assert out["fwd_launches"] == out["bwd_launches"] \
        == out["positions"] * layers * 2, out


@pytest.mark.parametrize("name", ["internlm2-1.8b", "qwen3-moe-235b-a22b",
                                  "zamba2-1.2b", "whisper-base"])
def test_remat_train_steps_on_the_card(card, name):
    """Two train steps with ``remat=True`` on the card against the CPU
    port (``_port_training`` tolerances): each layer body recomputed in
    the backward, so the flash forward launches twice a layer a step and
    its backward once."""
    from repro_torch.configs import get_config
    from repro_torch.training import AdamWConfig
    from _port_training import (TOL, attention_layers,
                                card_vs_cpu_train_steps, states_ok)
    torch.backends.cudnn.allow_tf32 = False
    out = card_vs_cpu_train_steps(name, AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10, clip_norm=0.5),
        remat=True)
    assert out["metrics_err"] <= TOL, out
    assert states_ok(out["first"], out["final"]), out
    assert out["plain"] == 0, out
    layers = attention_layers(get_config(name).reduced())
    assert out["fwd_launches"] == 2 * out["bwd_launches"] \
        == 2 * layers * 2, out


@pytest.mark.parametrize("name,heads,shape", [
    ("internlm2-1.8b", dict(n_heads=6, n_kv_heads=2), (2, 4)),
    ("qwen2-vl-7b", dict(n_heads=6, n_kv_heads=2), (1, 4)),
    ("zamba2-1.2b", dict(n_heads=6, n_kv_heads=2), (1, 4)),
    ("whisper-base", dict(n_heads=4), (1, 8))])
def test_whole_heads_train_steps_on_the_card(card, name, heads, shape):
    """Heads the "model" axis does not divide, the state placed over
    repeated positions of the card, against the unsharded CPU port: the
    attention whole on each batch row's first column, so the flash
    forward and backward launch once an attention layer a batch row a
    step."""
    from repro_torch.configs import get_config
    from repro_torch.training import AdamWConfig
    from _port_training import (TOL, attention_layers,
                                card_vs_cpu_train_steps, states_ok)
    torch.backends.cudnn.allow_tf32 = False
    out = card_vs_cpu_train_steps(name, AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10, clip_norm=0.5),
        mesh_shape=shape, **heads)
    assert out["metrics_err"] <= TOL, out
    assert states_ok(out["first"], out["final"]), out
    assert out["plain"] == 0, out
    layers = attention_layers(get_config(name).reduced(**heads))
    assert out["fwd_launches"] == out["bwd_launches"] \
        == shape[0] * layers * 2, out
