"""The flash_attention backward's tolerance and a plain-torch emulation
of its kernel's arithmetic, shared by ``tests/test_torch_flash_bwd.py``
(CPU) and ``tests/test_torch_cuda.py`` (card).

``flash_bwd_tol`` is the gate ``chip_smoke.py`` holds the kernel to
(``flash_bwd_allowance``). ``emulate_bwd`` computes the gradient with
the kernel's rounding of each operand and f32 accumulation, but over
whole (S, S) matrices rather than tiles: it checks the precision design
(which operands are split, and how), not the order of the sums.
"""
import importlib

import torch

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")


def flash_bwd_tol(q, k, v, out, dout, causal, want):
    """Per-gradient bound |got - want| may reach, ``want`` the plain
    backward on the same values in f32: 1e-4 + 1e-4 |want| in f32; in
    bf16 one ulp of the gradient (2**-7 |want| + 1e-4) plus what the
    bf16 rounding of ``out`` moves D = rowsum(dO * out) by, carried
    into dq (scale * r * sum_j P |k_j|) and dk (scale * P^T (r |q|)),
    r = sum_d |dO| |out - out32| per query row."""
    if q.dtype == torch.float32:
        return [1e-4 + 1e-4 * w.abs() for w in want]
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    o32 = fa_mod.flash_attention_plain(q32, k32, v32, causal)
    r = (do32.abs() * (out.float() - o32).abs()).sum(-1, keepdim=True)
    extra_dq = scale * r * fa_mod.flash_attention_plain(
        q32, k32, k32.abs(), causal)
    _, _, extra_dk = fa_mod.flash_attention_bwd_plain(
        q32, k32, v32, o32, r * q32.abs(), causal)
    extra = [extra_dq, scale * extra_dk, 0.0]
    return [1e-4 + 2 ** -7 * w.abs() + e for w, e in zip(want, extra)]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 (10 explicit mantissa bits) by masking the 13 low
    mantissa bits: the kernel's hi part, and what the tf32 mma reads of
    its lo part."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 values (kept in f32), round to nearest even, as
    ``__floats2bfloat162_rn``: add 0x7FFF plus the lowest kept bit,
    then mask the 16 dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) & ~0xFFFF).view(
        torch.float32)


def _split(x, rnd):
    hi = rnd(x)
    return hi, rnd(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, mode: str,
            split_a: bool) -> torch.Tensor:
    """a @ b (batched, f32) with the kernel's operand rounding: "tf32x3"
    splits both into tf32 hi + lo (each truncated, as the card reads
    them) and adds lo·hi + hi·lo + hi·hi; "tf32" one TF32 product;
    "bf16" splits a into bf16 hi + lo when ``split_a`` (P, dS), b being
    exact bf16; "bf16_once" rounds a split
    operand once to bf16. Each partial product is an f32 matmul: exact
    products (tf32 x tf32 and bf16 x bf16 fit in f32), f32 sums."""
    if mode == "tf32x3":
        ah, al = _split(a, round_tf32)
        bh, bl = _split(b, round_tf32)
        return al @ bh + ah @ bl + ah @ bh
    if mode == "tf32":
        return round_tf32(a) @ round_tf32(b)
    if not split_a:
        return a @ b
    if mode == "bf16_once":
        return round_bf16(a) @ b
    ah, al = _split(a, round_bf16)
    return ah @ b + al @ b


def emulate_bwd(q, k, v, out, dout, lse, causal, mode):
    """(dq, dk, dv) in f32 as the kernel forms them from q, k, v, out,
    dout (f32 tensors holding the working dtype's values) and the
    forward's lse: S = q k^T, dP = dO v^T, P = exp(S scale - lse) masked,
    D = rowsum(dO * out), dS = P (dP - D), dq = scale dS k,
    dk = scale dS^T q (summed over the GQA group), dv = P^T dO."""
    B, S, H, dh = q.shape
    Kh = k.shape[2]
    G = H // Kh
    scale = dh ** -0.5
    qh, dh_o, oh = (t.permute(0, 2, 1, 3) for t in (q, dout, out))
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
              for t in (k, v))
    s = product(qh, kh.transpose(-1, -2), mode, False)
    dp = product(dh_o, vh.transpose(-1, -2), mode, False)
    p = torch.exp(s * scale - lse[..., None])
    if causal:
        p = p.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), 0.0)
    d = (dh_o * oh).sum(-1, keepdim=True)
    ds = p * (dp - d)
    dq = scale * product(ds, kh, mode, True)
    dk = scale * product(ds.transpose(-1, -2), qh, mode, True)
    dv = product(p.transpose(-1, -2), dh_o, mode, True)
    dk, dv = (t.reshape(B, Kh, G, S, dh).sum(2) for t in (dk, dv))
    return tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))
