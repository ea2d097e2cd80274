"""Dry-run case construction: (arch × shape × mesh) → a closure plus
fully-sharded inputs that hold no storage (PyTorch).

Port of ``src/repro/launch/cases.py``. ``build_case`` returns:
    fn            — the step to run on placed arguments
    args          — tuple of ``meta`` tensors (pytrees): shape and dtype,
                    the counterparts of ``jax.ShapeDtypeStruct``
    in_shardings  — the matching pytree of ``NamedSharding``s

The structure, shapes, dtypes and specs are the reference's, cell for
cell. ``place`` puts materialised arguments where the shardings say,
in the form the port's step functions take them on a mesh: serving
weights as ``MeshParams``, a train state leaf by leaf
(``sharding.device_put``), LoRA arenas and serve state as
``ShardedTensor``s (a slab whose positions split over "model" with a
write sink a shard), and the batch inputs (tokens, frames, M-RoPE
positions, adapter indices, cache lengths) whole on the mesh's first
device, which the step functions split into their batch rows. Run
``fn`` under ``act_sharding.activation_sharding(batch_axes, mesh=mesh,
exact_reductions=kind != "train", moe_token_parallel=kind != "train")``
to compute batch rows over the batch axes, as the reference's dry-run
lowers the cells.
"""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.distributed import sharding as shp
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api
from repro_torch.models.base import Family, ModelConfig, param_shapes
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import make_train_step

LORA_SLOTS = 8
LORA_RMAX = 64

# Gradient-accumulation factors for train_4k: MoE all-to-all receive
# buffers scale with per-step tokens; microbatching is how the big MoE
# cells fit 16 GB/chip (EXPERIMENTS.md §Dry-run).
MICROBATCHES = {
    "qwen3-moe-235b-a22b": 8,
    "llama4-maverick-400b-a17b": 4,
}


def _sds(shape, dtype) -> torch.Tensor:
    """Shape and dtype, no storage (``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _named(mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, spec)


def _param_sds(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    out = {}
    for path, shape in param_shapes(cfg).items():
        leaf = path.split("/")[-1]
        dt = torch.float32 if leaf in ("A_log", "ssm_D") else dtype
        out[path] = _sds(shape, dt)
    return out


def _opt_sds(params_sds: dict, moment_dtype=torch.bfloat16) -> dict:
    out = {"step": _sds((), torch.int32)}
    for k, v in params_sds.items():
        out[f"m/{k}"] = _sds(v.shape, moment_dtype)
        out[f"v/{k}"] = _sds(v.shape, moment_dtype)
    return out


def _batch_sds(cfg: ModelConfig, B: int, S: int) -> dict:
    batch = {"tokens": _sds((B, S), torch.int32),
             "labels": _sds((B, S), torch.int32)}
    if cfg.family == Family.ENCDEC:
        batch["frames"] = _sds((B, cfg.enc_ctx, cfg.d_model),
                               torch.bfloat16)
    if cfg.mrope:
        batch["mrope_pos"] = _sds((3, B, S), torch.int32)
    return batch


def _batch_shardings(cfg, mesh, B_axes, B, S) -> dict:
    fit = shp.fit_spec
    sh = {"tokens": _named(mesh, fit((B, S), P(B_axes, None), mesh)),
          "labels": _named(mesh, fit((B, S), P(B_axes, None), mesh))}
    if cfg.family == Family.ENCDEC:
        sh["frames"] = _named(mesh, fit(
            (B, cfg.enc_ctx, cfg.d_model), P(B_axes, None, None), mesh))
    if cfg.mrope:
        sh["mrope_pos"] = _named(mesh, fit(
            (3, B, S), P(None, B_axes, None), mesh))
    return sh


def _lora_sds(cfg: ModelConfig, n_stack: int) -> dict:
    def pair(din, dout):
        return (_sds((n_stack, LORA_SLOTS, din, LORA_RMAX), torch.bfloat16),
                _sds((n_stack, LORA_SLOTS, LORA_RMAX, dout), torch.bfloat16))
    return {"q": pair(cfg.d_model, cfg.q_dim),
            "k": pair(cfg.d_model, cfg.kv_dim),
            "v": pair(cfg.d_model, cfg.kv_dim),
            "o": pair(cfg.q_dim, cfg.d_model)}


def _lora_shardings(cfg, mesh) -> dict:
    pod, data, model = shp._axes(mesh)
    dims = {"q": (cfg.d_model, cfg.q_dim), "k": (cfg.d_model, cfg.kv_dim),
            "v": (cfg.d_model, cfg.kv_dim), "o": (cfg.q_dim, cfg.d_model)}
    out = {}
    for proj, (din, dout) in dims.items():
        a_spec = shp.fit_spec((cfg.n_layers, LORA_SLOTS, din, LORA_RMAX),
                              P(None, None, model, None), mesh)
        b_desired = (P(None, None, None, None) if proj == "o"
                     else P(None, None, None, model))
        b_spec = shp.fit_spec((cfg.n_layers, LORA_SLOTS, LORA_RMAX, dout),
                              b_desired, mesh)
        out[proj] = (_named(mesh, a_spec), _named(mesh, b_spec))
    return out


def _b_axes(mesh) -> tuple:
    pod, data, model = shp._axes(mesh)
    return pod + (data,)


# ----------------------------------------------------------------- cases
def build_case(arch: str, shape_name: str, mesh: Mesh,
               batch_override: int | None = None, *,
               config: ModelConfig | None = None,
               seq_override: int | None = None):
    """The cell (``arch``, ``shape_name``) on ``mesh``: (fn, args,
    in_shardings). ``config`` stands in for ``arch``'s published config
    and ``seq_override`` for the shape's sequence length (a cut depth,
    width or length for runs that must fit a card or a test budget).
    The serving closures run LoRA through the sgmv and bgmv kernels, as
    the engine does on the card (the reference's closures take its
    einsum oracle)."""
    cfg = config or get_config(arch)
    spec = SHAPE_BY_NAME[shape_name]
    B = batch_override or spec.global_batch
    S = seq_override or spec.seq_len
    B_axes = _b_axes(mesh)
    kind = spec.kind

    params_sds = _param_sds(cfg)
    params_sh = shp.param_shardings(
        cfg, {k: tuple(v.shape) for k, v in params_sds.items()}, mesh, kind)

    if kind == "train":
        opt_cfg = AdamWConfig(moment_dtype="bfloat16")
        step = make_train_step(cfg, opt_cfg,
                               microbatches=MICROBATCHES.get(arch, 1))
        opt_sds = _opt_sds(params_sds)
        opt_sh = shp.opt_shardings(params_sh, mesh)
        batch_sds = _batch_sds(cfg, B, S)
        batch_sh = _batch_shardings(cfg, mesh, B_axes, B, S)
        return (step,
                (params_sds, opt_sds, batch_sds),
                (params_sh, opt_sh, batch_sh))

    use_lora = cfg.family in (Family.DENSE, Family.MOE, Family.VLM,
                              Family.HYBRID)
    if cfg.family == Family.HYBRID:
        from repro_torch.models.hybrid import attn_sites
        lora_stack_n = len(attn_sites(cfg))
    else:
        lora_stack_n = cfg.n_layers

    if kind == "prefill":
        # Keep chunk batch divisible by the data extent (16/32) — a
        # sub-extent chunk loses batch sharding and replicates.
        n_mb = min(MICROBATCHES.get(arch, 1), max(1, B // 16))

        def fn(params, tokens, lora, adapter_idx, extra):
            kw = {}
            if cfg.family == Family.HYBRID:
                kw["kv_max_len"] = S

            def one(tb, idx_b, extra_b):
                kw_i = dict(kw, **extra_b)
                if use_lora:
                    kw_i.update(lora=lora, adapter_idx=idx_b,
                                lora_backend="kernel")
                return api.prefill(cfg, params, tb, **kw_i)

            if n_mb == 1 or B % n_mb != 0:
                return one(tokens, adapter_idx if use_lora else None, extra)
            # Batch-chunked prefill: the MoE all-to-all receive buffers
            # scale with tokens-per-invocation; chunking the request
            # batch bounds them (serving engines chunk prefill anyway).
            Bc = B // n_mb
            outs = []
            for c in range(n_mb):
                rows = slice(c * Bc, (c + 1) * Bc)
                extra_c = {k: (v[:, rows] if k == "mrope_pos" else v[rows])
                           for k, v in extra.items()}
                outs.append(one(tokens[rows],
                                adapter_idx[rows] if use_lora else None,
                                extra_c))
            logits = torch.cat([o[0] for o in outs])
            kv = tuple(_cat_batch([o[1][j] for o in outs])
                       for j in range(len(outs[0][1])))
            return logits, kv

        tokens = _sds((B, S), torch.int32)
        tok_sh = _named(mesh, shp.fit_spec((B, S), P(B_axes, None), mesh))
        extra_sds, extra_sh = {}, {}
        if cfg.family == Family.ENCDEC:
            extra_sds["frames"] = _sds((B, cfg.enc_ctx, cfg.d_model),
                                       torch.bfloat16)
            extra_sh["frames"] = _named(mesh, shp.fit_spec(
                (B, cfg.enc_ctx, cfg.d_model), P(B_axes, None, None), mesh))
        if cfg.mrope:
            extra_sds["mrope_pos"] = _sds((3, B, S), torch.int32)
            extra_sh["mrope_pos"] = _named(mesh, shp.fit_spec(
                (3, B, S), P(None, B_axes, None), mesh))
        lora_sds = _lora_sds(cfg, lora_stack_n) if use_lora else ()
        lora_sh = _lora_shardings(cfg, mesh) if use_lora else ()
        idx_sds = _sds((B,), torch.int32) if use_lora else ()
        idx_sh = (_named(mesh, shp.fit_spec((B,), P(B_axes), mesh))
                  if use_lora else ())
        return (fn,
                (params_sds, tokens, lora_sds, idx_sds, extra_sds),
                (params_sh, tok_sh, lora_sh, idx_sh, extra_sh))

    # ---- decode -------------------------------------------------------
    state_sds, state_sh = _serve_state(cfg, mesh, B, S, B_axes)

    def fn(params, tokens, state, cache_len, lora, adapter_idx, extra):
        kw = dict(extra)
        if use_lora:
            kw.update(lora=lora, adapter_idx=adapter_idx,
                      lora_backend="kernel")
        return api.decode_step(cfg, params, tokens, state, cache_len, **kw)

    tokens = _sds((B, 1), torch.int32)
    tok_sh = _named(mesh, shp.fit_spec((B, 1), P(B_axes, None), mesh))
    clen_sds = _sds((B,), torch.int32)
    clen_sh = _named(mesh, shp.fit_spec((B,), P(B_axes), mesh))
    extra_sds, extra_sh = {}, {}
    if cfg.mrope:
        extra_sds["mrope_pos"] = _sds((3, B, 1), torch.int32)
        extra_sh["mrope_pos"] = _named(mesh, shp.fit_spec(
            (3, B, 1), P(None, B_axes, None), mesh))
    lora_sds = _lora_sds(cfg, lora_stack_n) if use_lora else ()
    lora_sh = _lora_shardings(cfg, mesh) if use_lora else ()
    idx_sds = _sds((B,), torch.int32) if use_lora else ()
    idx_sh = (_named(mesh, shp.fit_spec((B,), P(B_axes), mesh))
              if use_lora else ())
    return (fn,
            (params_sds, tokens, state_sds, clen_sds, lora_sds, idx_sds,
             extra_sds),
            (params_sh, tok_sh, state_sh, clen_sh, lora_sh, idx_sh,
             extra_sh))


def _serve_state(cfg: ModelConfig, mesh: Mesh, B: int, S: int, B_axes):
    pod, data, model = shp._axes(mesh)
    bf16, f32 = torch.bfloat16, torch.float32
    if cfg.family in (Family.DENSE, Family.MOE, Family.VLM):
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        kv_sp = _named(mesh, shp.kv_cache_spec(mesh, shape))
        return ((_sds(shape, bf16), _sds(shape, bf16)), (kv_sp, kv_sp))
    if cfg.family == Family.SSM:
        sshape = (cfg.n_layers, B, cfg.d_inner, cfg.d_state)
        cshape = (cfg.n_layers, B, cfg.d_conv - 1, cfg.d_inner)
        return ((_sds(sshape, f32), _sds(cshape, bf16)),
                (_named(mesh, shp.ssm_state_spec(mesh, sshape)),
                 _named(mesh, shp.conv_state_spec(mesh, cshape))))
    if cfg.family == Family.HYBRID:
        from repro_torch.models.hybrid import attn_sites
        n_sites = len(attn_sites(cfg))
        conv_dim = cfg.d_inner + 2 * cfg.d_state
        sshape = (cfg.n_layers, B, cfg.n_ssm_heads, cfg.ssm_head_dim,
                  cfg.d_state)
        cshape = (cfg.n_layers, B, cfg.d_conv - 1, conv_dim)
        kshape = (n_sites, B, S, cfg.n_kv_heads, cfg.head_dim)
        ssm_sp = _named(mesh, shp.fit_spec(
            sshape, P(None, B_axes, model, None, None), mesh))
        conv_sp = _named(mesh, shp.fit_spec(
            cshape, P(None, B_axes, None, model), mesh))
        kv_sp2 = _named(mesh, shp.kv_cache_spec(mesh, kshape))
        return ((_sds(sshape, f32), _sds(cshape, bf16),
                 (_sds(kshape, bf16), _sds(kshape, bf16))),
                (ssm_sp, conv_sp, (kv_sp2, kv_sp2)))
    if cfg.family == Family.ENCDEC:
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        xshape = (cfg.n_layers, B, cfg.enc_ctx, cfg.n_kv_heads,
                  cfg.head_dim)
        kv_sp = _named(mesh, shp.kv_cache_spec(mesh, shape))
        kvx_sp = _named(mesh, shp.kv_cache_spec(mesh, xshape))
        return (((_sds(shape, bf16), _sds(shape, bf16)),
                 (_sds(xshape, bf16), _sds(xshape, bf16))),
                ((kv_sp, kv_sp), (kvx_sp, kvx_sp)))
    raise ValueError(cfg.family)


def _cat_batch(parts: list):
    """Batch chunks (L, Bc, ...) of a prefill's K or V concatenated on
    dim 1: plain tensors, or placed stacks re-placed over the whole
    batch in ``kv_cache_spec`` layout."""
    if not isinstance(parts[0], shp.ShardedTensor):
        return torch.cat(parts, dim=1)
    mesh = parts[0].mesh
    Bc = parts[0].shape[1]
    shape = (parts[0].shape[0], Bc * len(parts)) + parts[0].shape[2:]
    pieces = []
    for c, st in enumerate(parts):
        for slc, t in st.unique():
            box = list(slc)
            box[1] = slice(slc[1].start + c * Bc, slc[1].stop + c * Bc)
            pieces.append((tuple(box), t))
    spec = shp.kv_cache_spec(mesh, shape)
    split = len(spec) > 2 and spec[2] is not None
    return shp.assemble(NamedSharding(mesh, spec), shape, pieces,
                        sink_dim=2 if split else None)


# ------------------------------------------------------------ placement
def place(cfg: ModelConfig, kind: str, args: tuple, shardings: tuple,
          device=None) -> tuple:
    """Materialised ``args`` (the structure ``build_case`` gives, tensors
    in place of its meta tensors) placed where ``shardings`` say, as the
    step functions take them: the serving weights as ``MeshParams``, a
    train state leaf by leaf (``sharding.device_put``), LoRA arenas and
    serve state as fresh ``ShardedTensor``s (a KV slab split along its
    positions with a write sink a shard), the batch inputs (tokens,
    labels, frames, M-RoPE positions, adapter indices, cache lengths)
    whole on ``device`` (the mesh's first position by default)."""
    mesh = next(iter(shardings[0].values())).mesh
    dev = device if device is not None else mesh.devices.flat[0]

    def whole(x):
        if isinstance(x, dict):
            return {k: v.to(dev) for k, v in x.items()}
        return x if isinstance(x, tuple) else x.to(dev)

    if kind == "train":
        params, opt, batch = args
        return (shp.device_put(params, shardings[0]),
                shp.device_put(opt, shardings[1]), whole(batch))
    mp = shp.MeshParams(cfg, {k: shardings[0][k].shard(v)
                              for k, v in args[0].items()}, mesh)
    if kind == "prefill":
        _, tokens, lora, idx, extra = args
        return (mp, whole(tokens), _placed(lora, shardings[2]), whole(idx),
                whole(extra))
    _, tokens, state, clen, lora, idx, extra = args
    return (mp, whole(tokens), _placed(state, shardings[2]), whole(clen),
            _placed(lora, shardings[4]), whole(idx), whole(extra))


def _placed(x, sh):
    """A LoRA arena or serve state (nested tuples and dicts of tensors)
    as fresh shards; a 5-D KV stack split along its positions keeps a
    write sink a shard."""
    if isinstance(x, dict):
        return {k: _placed(v, sh[k]) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_placed(v, s) for v, s in zip(x, sh))
    split = x.dim() == 5 and len(sh.spec) > 2 and sh.spec[2] is not None
    return sh.zeros(tuple(x.shape), x.dtype,
                    sink_dim=2 if split else None).copy_(x)
