"""ShardPlan: the serving data plane's tensor→device placement map.

Port of ``src/repro/serving/shard_plan.py``, method for method. One
object, built once per engine from (mesh, model config), that turns the
rule table in ``distributed/sharding.py`` into the concrete
``NamedSharding``s the engine needs (DESIGN §4):

- weights           — "model" axis (tensor parallel; resident, never
                      gathered per step), MoE experts over "data"
                      (expert parallel, their FFN whole)
- LoRA slot arena   — A replicated, B dout over "model" (the delta adds
                      to the projection output without a reshard)
- dense KV caches   — batch over "data", kv heads over "model" when
                      divisible, else the positions over "model"
- paged KV pool     — *pages* over "data" (per-device memory sizing),
                      kv heads over "model" when divisible, else whole
- batch state       — (B,)/(B, X) vectors over "data"
- page tables       — host-side and global; uploaded whole (page ids
                      address the logical pool)

Everything routes through ``fit_spec`` so shapes that don't divide the
mesh (a B=1 prefill bucket on a 2-way data axis) degrade to replicated
instead of erroring. The plan is metadata plus ``put``, which places a
tensor; control-plane decisions (and therefore emitted tokens) cannot
depend on it.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (P, NamedSharding,
                                              ShardedTensor, fit_spec,
                                              kv_cache_spec, kv_pages_spec,
                                              lora_spec, param_shardings)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.base import ModelConfig


class ShardPlan:
    """Shardings for every tensor class the serving engine moves."""

    def __init__(self, mesh: Mesh, model_cfg: ModelConfig):
        self.mesh = mesh
        self.cfg = model_cfg
        self.data_size = mesh.shape["data"]
        self.model_size = mesh.shape["model"]

    # -------------------------------------------------------------- core
    def named(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    def fitted(self, shape: tuple, spec: P, *,
               warn_label: str | None = None) -> NamedSharding:
        return self.named(fit_spec(tuple(shape), spec, self.mesh,
                                   warn_label=warn_label))

    @property
    def replicated(self) -> NamedSharding:
        return self.named(P())

    def put(self, x: torch.Tensor, sharding: NamedSharding
            ) -> ShardedTensor:
        """Commit a host/device value to this plan's placement."""
        return sharding.shard(x)

    # ----------------------------------------------------------- weights
    def params(self, params: dict) -> dict:
        """{path: NamedSharding} for the serving weights ("model" only —
        inference never FSDP-shards; warns once per tensor whose spec
        axis doesn't divide)."""
        return param_shardings(self.cfg, params, self.mesh, kind="decode")

    # -------------------------------------------------------- LoRA slots
    def lora_slots(self, slots: dict) -> dict:
        """Slot-arena shardings, same structure as ``init_lora_slots``:
        {proj: (A_sharding, B_sharding)} over (L, slots, din|r, r|dout)."""
        out = {}
        for proj, (a, b) in slots.items():
            sh_a = self.fitted(a.shape, lora_spec(proj, "a", self.mesh))
            sh_b = self.fitted(b.shape, lora_spec(proj, "b", self.mesh),
                               warn_label=f"lora/{proj}/b")
            out[proj] = (sh_a, sh_b)
        return out

    def adapter_weights(self, weights: dict) -> dict:
        """Shardings for one *host* adapter's weights (L, din, r) /
        (L, r, dout) so an adapter uploads straight into the sharded
        slot layout — each device receives only its B-column slice,
        never the full tensor."""
        out = {}
        for proj, (a, b) in weights.items():
            spec_a = lora_spec(proj, "a", self.mesh)
            spec_b = lora_spec(proj, "b", self.mesh)
            # Slot specs are (L, slots, din|r, ...); per-adapter weights
            # drop the slot axis.
            out[proj] = (
                self.fitted(a.shape, P(*([*spec_a][:1] + [*spec_a][2:]))),
                self.fitted(b.shape, P(*([*spec_b][:1] + [*spec_b][2:]))),
            )
        return out

    # ---------------------------------------------------------------- KV
    def kv_dense(self, shape: tuple) -> NamedSharding:
        """(L, B, Smax, Kh, Dh) dense cache."""
        return self.named(kv_cache_spec(self.mesh, tuple(shape)))

    def kv_pages(self, shape: tuple) -> NamedSharding:
        """(L, n_pages, page, Kh, Dh) paged pool."""
        return self.named(kv_pages_spec(self.mesh, tuple(shape)))

    def zeros_kv_pages(self, shape: tuple, dtype: torch.dtype
                       ) -> ShardedTensor:
        """A zeroed paged pool in :meth:`kv_pages` placement. Split over
        "data", each shard keeps one page past its block as the write
        sink for rows whose page another shard owns."""
        sh = self.kv_pages(shape)
        split = len(sh.spec) > 1 and sh.spec[1] is not None
        return sh.zeros(shape, dtype, sink_dim=1 if split else None)

    def zeros_kv_dense(self, shape: tuple, dtype: torch.dtype
                       ) -> ShardedTensor:
        """A zeroed dense slab in :meth:`kv_dense` placement. Split along
        the positions (KV heads that do not divide "model"), each shard
        keeps one position past its block as the write sink for tokens
        whose position another shard holds."""
        sh = self.kv_dense(shape)
        split = len(sh.spec) > 2 and sh.spec[2] is not None
        return sh.zeros(shape, dtype, sink_dim=2 if split else None)

    # ------------------------------------------------------- batch state
    def batch(self, shape: tuple) -> NamedSharding:
        """Per-request state: leading dim over "data", rest replicated —
        (B,) cache_len/adapter_slot/seeds, (B, 1) tokens, (B, n_stop)
        stop sets; (K, B) horizon outputs use :meth:`horizon`."""
        spec = P("data", *([None] * (len(shape) - 1)))
        return self.fitted(shape, spec)

    def horizon(self, shape: tuple) -> NamedSharding:
        """(K, B) per-horizon-step outputs: batch dim is second."""
        return self.fitted(shape, P(None, "data"))

    def logits(self, shape: tuple) -> NamedSharding:
        """(B, V) logits: batch rows over "data", vocab *unsharded* —
        the sampler (sort / cumsum / top-k over V) must see each row
        whole, in single-device FP order, for token parity."""
        return self.fitted(shape, P("data"))
