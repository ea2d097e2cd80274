"""Zamba2-style hybrid: Mamba2 backbone + one shared attention block
(PyTorch).

Port of ``src/repro/models/hybrid.py``. ``cfg.n_layers`` Mamba2 layers;
a single *shared* (attention + MLP) transformer block runs after every
``attn_every``-th mamba layer with the same weights each time. The JAX
scan over periods of ``attn_every`` layers becomes a loop over the
periods; layers past the last full period run without attention. KV
caches exist only at the shared-block sites: (n_sites, B, S, Kh, Dh).

The shared block is ``lm._attn`` and ``lm._mlp``: prefill attention
through ``kernels.ops.flash_attention`` (causal), LoRA on its q/k/v/o
from stacks of shape (n_sites, slots, din, r), through sgmv (prefill)
and bgmv (decode) when ``lora_backend="kernel"``.

Serve state: (ssm (L,B,H,P,N) f32, conv (L,B,K-1,C), (k, v) each
(n_sites,B,Smax,Kh,Dh)). ``decode_step`` writes the new token's K/V
into the (k, v) tensors it is given, in place (``lm._attn``), where the
JAX function returns new arrays; the ssm and conv stacks it returns are
new tensors.

On a placed train state (``sharding.device_put`` with the train rule
table) ``forward`` and ``train_loss`` run sharded: each Mamba2 layer
over the "model" columns (``ssm_lm._mixer_train``), and the shared
block at each site through ``lm._attn_train``/``_mlp_train`` (causal
flash_attention per shard, o and down row-parallel). The shared
leaves are not stacked: every site gathers them again, and their
gradient is reduced once, after the last site's backward
(``sharding.FsdpStep`` waits for every gather of a key).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed.sharding import TrainView
from repro_torch.models.base import ModelConfig
from repro_torch.models.layers import cross_entropy, einsum, embed, rms_norm
from repro_torch.models.lm import (_attn, _attn_train, _embed_train, _head,
                                   _head_train, _logits, _mlp, _mlp_train,
                                   _placed, _positions, _slice_group,
                                   mesh_forward, mesh_train_loss)
from repro_torch.models.ssm import mamba2_seq, mamba2_step
from repro_torch.models.ssm_lm import _mixer_train


def attn_sites(cfg: ModelConfig) -> list[int]:
    return [i for i in range(cfg.n_layers)
            if (i + 1) % cfg.attn_every == 0]


def _split_periods(cfg: ModelConfig, stack: dict):
    """(scanned (n_per, E, ...), tail (n_tail, ...), n_per, n_tail)
    views of the layer stack."""
    E = cfg.attn_every
    n_per = cfg.n_layers // E
    n_scan = n_per * E
    scanned = {k: v[:n_scan].reshape((n_per, E) + v.shape[1:])
               for k, v in stack.items()}
    tail = {k: v[n_scan:] for k, v in stack.items()}
    return scanned, tail, n_per, cfg.n_layers - n_scan


def _mamba_block(cfg, x, p, decode, ssm_state=None, conv_state=None):
    """One Mamba2 layer + residual: (x, ssm state, conv state). A
    prefill's conv state is the last K-1 raw x/B/C conv inputs (fewer
    when S < K-1, as in JAX)."""
    h_in = rms_norm(x, p["ssm_norm"], cfg.norm_eps)
    if decode:
        y, h, cstate = mamba2_step(h_in[:, 0], p, cfg.d_state,
                                   cfg.ssm_head_dim, ssm_state,
                                   conv_state)
        return x + y[:, None], h, cstate
    y, h = mamba2_seq(h_in, p, cfg.d_state, cfg.ssm_head_dim,
                      cfg.ssm_chunk)
    # The projection of the last K-1 positions only: the rows JAX keeps
    # of its whole-sequence recomputation.
    zx = einsum("bsd,de->bse", h_in[:, -(cfg.d_conv - 1):], p["in_proj"])
    cstate = zx[..., cfg.d_inner:2 * cfg.d_inner + 2 * cfg.d_state]
    return x + y, h, cstate


def _run(cfg: ModelConfig, params: dict, x: torch.Tensor, cos, sin,
         ssm_states=None, conv_states=None, kv_caches=None,
         cache_len=None, decode: bool = False, lora=None,
         adapter_idx=None, need_state: bool = True,
         lora_backend: str = "einsum"):
    """The period loop. Returns (x, ssm (L,...), conv (L,...),
    kv (n_sites,...) or None); the three states are None when
    ``need_state`` is False (forward, training)."""
    shared = _slice_group(params, "shared/")
    scanned, tail, n_per, n_tail = _split_periods(
        cfg, _slice_group(params, "layers/"))
    E = cfg.attn_every
    serving = ssm_states is not None
    new_ssm, new_conv, ks, vs = [], [], [], []
    for i in range(n_per):
        for e in range(E):
            layer = i * E + e
            p = {k: v[i, e] for k, v in scanned.items()}
            x, h, c = _mamba_block(
                cfg, x, p, decode,
                ssm_states[layer] if serving else None,
                conv_states[layer] if serving else None)
            new_ssm.append(h)
            new_conv.append(c)
        kv = ((kv_caches[0][i], kv_caches[1][i])
              if kv_caches is not None else None)
        lr = ({proj: (a[i], b[i]) for proj, (a, b) in lora.items()}
              if lora is not None else None)
        x, kv_new = _attn(cfg, x, shared, cos, sin, kv, cache_len, lr,
                          adapter_idx, lora_backend=lora_backend)
        x = _mlp(cfg, x, shared)
        if need_state and kv_caches is None:
            ks.append(kv_new[0])
            vs.append(kv_new[1])
    for i in range(n_tail):
        layer = n_per * E + i
        p = {k: v[i] for k, v in tail.items()}
        x, h, c = _mamba_block(
            cfg, x, p, decode,
            ssm_states[layer] if serving else None,
            conv_states[layer] if serving else None)
        new_ssm.append(h)
        new_conv.append(c)
    if not need_state:
        return x, None, None, None
    kv_out = (kv_caches if kv_caches is not None
              else (torch.stack(ks), torch.stack(vs)))
    return x, torch.stack(new_ssm), torch.stack(new_conv), kv_out


def forward(cfg: ModelConfig, params: dict, tokens,
            mrope_pos=None) -> torch.Tensor:
    """Full-sequence logits (B, S, V) f32."""
    if _placed(params):
        tv = TrainView(cfg, params)
        return mesh_forward(tv, lambda: _logits_mesh(cfg, tv, tokens))
    x = embed(tokens, params["embed/tok"])
    cos, sin = _positions(cfg, tokens, 0)
    x, *_ = _run(cfg, params, x, cos, sin, need_state=False)
    return _logits(cfg, params, x)


def train_loss(cfg, params, tokens, labels, mrope_pos=None,
               aux_weight=0.0) -> torch.Tensor:
    if _placed(params):
        tv = TrainView(cfg, params)
        return mesh_train_loss(tv, lambda: _logits_mesh(cfg, tv, tokens),
                               labels)
    return cross_entropy(forward(cfg, params, tokens), labels)


def _logits_mesh(cfg: ModelConfig, tv: TrainView, tokens):
    """([batch shard][column] f32 logits, None) on a placed state."""
    toks = acts.batch_shards(tokens)
    h = _embed_train(tv, toks)
    rope = [[_positions(cfg, t, 0) for t in row] for row in toks]
    sites = set(attn_sites(cfg))
    for i in range(cfg.n_layers):
        h = [_mixer_train(cfg, tv, hb, b, i) for b, hb in enumerate(h)]
        if i in sites:
            h = [_mlp_train(cfg, tv,
                            _attn_train(tv, hb, rope[b], b, None, "shared/"),
                            b, None, "shared/")
                 for b, hb in enumerate(h)]
    return _head_train(cfg, tv, h), None


def init_serve_state(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16,
                     device: torch.device | str | None = None):
    """(ssm (L,B,H,P,N) f32, conv (L,B,K-1,C), (k, v) each
    (n_sites,B,max_len,Kh,Dh)) in ``dtype``, zeroed; k and v are two
    tensors (decode writes them in place)."""
    dev = resolve_device(device)
    n_sites = len(attn_sites(cfg))
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    ssm = torch.zeros((cfg.n_layers, batch, cfg.n_ssm_heads,
                       cfg.ssm_head_dim, cfg.d_state), dtype=torch.float32,
                      device=dev)
    conv = torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1, conv_dim),
                       dtype=dtype, device=dev)
    shape = (n_sites, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv = (torch.zeros(shape, dtype=dtype, device=dev),
          torch.zeros(shape, dtype=dtype, device=dev))
    return ssm, conv, kv


def prefill(cfg: ModelConfig, params: dict, tokens,
            kv_max_len: int | None = None, lora=None, adapter_idx=None,
            lora_backend: str = "einsum"):
    """Returns (last logits (B,V), (ssm, conv, (k, v))); the K/V are
    zero-padded along the sequence to ``kv_max_len`` when it exceeds
    S."""
    S = tokens.shape[1]
    x = embed(tokens, params["embed/tok"])
    cos, sin = _positions(cfg, tokens, 0)
    x, ssm, conv, kv = _run(cfg, params, x, cos, sin, lora=lora,
                            adapter_idx=adapter_idx,
                            lora_backend=lora_backend)
    if kv_max_len is not None and kv_max_len > S:
        pad = (0, 0, 0, 0, 0, kv_max_len - S)
        kv = (F.pad(kv[0], pad), F.pad(kv[1], pad))
    return _head(cfg, params, x[:, -1:]), (ssm, conv, kv)


def decode_step(cfg: ModelConfig, params: dict, tokens, state, cache_len,
                lora=None, adapter_idx=None, lora_backend: str = "einsum"):
    """tokens (B,1); state = (ssm, conv, (k, v)); cache_len (B,).

    Writes the token's K/V into the state's (k, v) tensors in place
    (a caller that needs the old state clones it first). Returns
    (logits (B,V) f32, (new ssm, new conv, (k, v)))."""
    ssm, conv, kv = state
    x = embed(tokens, params["embed/tok"])
    cos, sin = _positions(cfg, tokens, cache_len)
    x, ssm, conv, kv = _run(cfg, params, x, cos, sin, ssm_states=ssm,
                            conv_states=conv, kv_caches=kv,
                            cache_len=cache_len, decode=True, lora=lora,
                            adapter_idx=adapter_idx,
                            lora_backend=lora_backend)
    return _head(cfg, params, x), (ssm, conv, kv)
