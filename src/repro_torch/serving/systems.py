"""System assembly: build (pool, cache, scheduler, simulator) per design.

Port of ``src/repro/serving/systems.py``: the same system matrix and
the same tiers, with PyTorch engines on the real-engine tiers (on the
card unless ``device=`` names another device). ``mesh_shape`` is
threaded to every real-engine tier (``engine``, ``cluster``,
``disagg``) through ``EngineConfig.mesh_shape``; the sim tiers reject
it.

Names match the paper's evaluation:

- ``slora``              FIFO, no adapter cache (drop-on-idle), queued prefetch
- ``userve-sjf``         SJF + aging, no adapter cache
- ``chameleon``          full design (cache w/ cost-aware eviction + MLQ)
- ``chameleon-nocache``  scheduler only (ChameleonNoCache in Fig. 10/13)
- ``chameleon-nosched``  cache only, FIFO   (ChameleonNoSched in Fig. 10)
- ``chameleon-lru``      full sched + LRU cache          (Fig. 14)
- ``chameleon-fairshare``full sched + equal-weight cache (Fig. 14)
- ``chameleon-prefetch`` full design + histogram prefetcher (Fig. 15)
- ``chameleon-outputonly`` WRS = predicted output only   (Fig. 16)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import (AdapterCache, ChameleonScheduler,
                              CostAwareEviction, FairShareEviction,
                              FIFOScheduler, LRUEviction, MemoryPool,
                              NoisyOraclePredictor, SJFScheduler,
                              build_adapter_pool)
from repro_torch.core.wrs import OutputOnlyCalculator

from .cost_model import CostModel, HW_PRESETS, MODEL_PRESETS
from .simulator import NodeSimulator, SimConfig

SYSTEM_NAMES = ("slora", "userve-sjf", "chameleon", "chameleon-nocache",
                "chameleon-nosched", "chameleon-lru", "chameleon-fairshare",
                "chameleon-prefetch", "chameleon-outputonly")


@dataclass
class NodeConfig:
    hw: str = "a40"
    model: str = "llama-7b"
    n_adapters: int = 100
    predictor_accuracy: float = 0.8
    slo_ttft_s: float = 5.0            # refined by benchmarks via lowload
    max_batch_requests: int = 256
    t_refresh: float = 20.0
    workspace_frac: float = 0.10       # HBM held back for activations etc.
    seed: int = 0
    sim: SimConfig = field(default_factory=SimConfig)


def build_node(system: str, cfg: NodeConfig):
    """Returns (simulator, adapters_catalog, cost_model)."""
    if system not in SYSTEM_NAMES:
        raise ValueError(f"unknown system {system!r}; one of {SYSTEM_NAMES}")
    hw = HW_PRESETS[cfg.hw]
    model = MODEL_PRESETS[cfg.model]
    cost = CostModel(hw=hw, model=model)

    tok_bytes = model.kv_bytes_per_token
    hbm_free = (hw.hbm_gb * 1e9) * (1 - cfg.workspace_frac) \
        - model.param_bytes
    if hbm_free <= 0:
        raise ValueError(f"{model.name} does not fit {hw.name}")
    capacity_tokens = int(hbm_free // tok_bytes)
    pool = MemoryPool(capacity_tokens=capacity_tokens)

    adapters = {a.adapter_id: a for a in build_adapter_pool(
        cfg.n_adapters, model.d_model, model.n_layers, tok_bytes,
        n_proj=model.n_proj_adapted, dtype_bytes=model.dtype_bytes)}

    cache_enabled = system not in ("slora", "userve-sjf",
                                   "chameleon-nocache")
    policy = CostAwareEviction()
    if system == "chameleon-lru":
        policy = LRUEviction()
    elif system == "chameleon-fairshare":
        policy = FairShareEviction()
    cache = AdapterCache(pool, adapters, policy=policy,
                         enabled=cache_enabled)

    pred = NoisyOraclePredictor(accuracy=cfg.predictor_accuracy,
                                seed=cfg.seed)

    if system in ("slora", "chameleon-nosched"):
        sched = FIFOScheduler(pool, cache, adapters, pred,
                              max_batch_requests=cfg.max_batch_requests)
    elif system == "userve-sjf":
        sched = SJFScheduler(pool, cache, adapters, pred,
                             max_batch_requests=cfg.max_batch_requests)
    else:
        wrs_calc = (OutputOnlyCalculator()
                    if system == "chameleon-outputonly" else None)
        sched = ChameleonScheduler(
            pool, cache, adapters, pred, wrs_calc=wrs_calc,
            slo=cfg.slo_ttft_s, t_refresh=cfg.t_refresh,
            max_batch_requests=cfg.max_batch_requests, seed=cfg.seed)

    sim_cfg = SimConfig(**cfg.sim.__dict__)
    if system == "chameleon-prefetch":
        sim_cfg.histogram_prefetch = True
    if system in ("slora", "userve-sjf"):
        # Paper Fig. 1: conventional systems load missing adapters before
        # launching the batch -> the engine stalls on the load.
        sim_cfg.sync_adapter_load = True
    sim = NodeSimulator(cost, pool, cache, sched, adapters, sim_cfg)
    return sim, adapters, cost


# System -> (scheduler class, adapter cache enabled) for the *real*
# engine data plane. The subset of SYSTEM_NAMES whose behavioural
# difference lives in the control plane the engine actually runs
# (cost-model-only variants like -prefetch stay simulator-only).
ENGINE_SYSTEMS = {
    "chameleon": (ChameleonScheduler, True),
    "chameleon-nocache": (ChameleonScheduler, False),
    "chameleon-nosched": (FIFOScheduler, True),
    "slora": (FIFOScheduler, False),
    "userve-sjf": (SJFScheduler, False),
}


def build_engine(system: str, cfg, params, ecfg=None, catalog=None,
                 clock=None, device: torch.device | str | None = None):
    """Assemble one real-engine replica for ``system`` (CUDA by default).

    Mirrors ``build_node`` for the PyTorch data plane: same policy
    matrix, but the returned object runs prefill/decode on real tokens.
    ``catalog`` (shared AdapterCatalog) and ``clock`` let a cluster
    deduplicate host adapter weights and share a timebase across
    replicas.
    """
    from .engine import ChameleonEngine
    if system not in ENGINE_SYSTEMS:
        raise ValueError(f"unknown engine system {system!r}; "
                         f"one of {tuple(ENGINE_SYSTEMS)}")
    sched_cls, cache_enabled = ENGINE_SYSTEMS[system]
    return ChameleonEngine(cfg, params, ecfg, scheduler_cls=sched_cls,
                           cache_enabled=cache_enabled, catalog=catalog,
                           clock=clock, device=device)


# ------------------------------------------------------------------
# The single serving factory (DESIGN §3): one system matrix, three
# execution tiers, one ServingSystem surface.
# ------------------------------------------------------------------
TIERS = ("sim", "engine", "cluster", "sim-cluster", "disagg")


def _default_model(device):
    """Reduced Llama-style model for the real-engine tiers (the JAX
    package's default), f32 weights from the port's seeded init."""
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config("chameleon-llama-7b").reduced()
    return cfg, api.init_params(cfg, 0, torch.float32, device=device)


def build_system(system: str = "chameleon", tier: str = "engine", *,
                 node: NodeConfig | None = None,
                 model_cfg=None, params=None, ecfg=None,
                 n_nodes: int = 2, policy: str = "adapter_affinity",
                 seed: int = 0, mesh_shape: tuple | None = None,
                 gateway=None, device: torch.device | str | None = None):
    """Build a ``ServingSystem`` (see ``serving.handles``): one factory
    over the full system × tier matrix.

    tier="sim"          one DES node (``NodeSimulator``): paper-scale
                        traffic in seconds of CPU time;
    tier="engine"       one real PyTorch engine (``ChameleonEngine``);
    tier="cluster"      N real engines behind a router
                        (``EngineCluster``, shared AdapterCatalog);
    tier="sim-cluster"  N DES nodes behind the same router
                        (``Cluster``);
    tier="disagg"       N real engines split into prefill and decode
                        roles with a paged-KV handoff between them
                        (``DisaggCluster``; n_nodes splits
                        floor(n/2) prefill / rest decode).

    Every tier serves the same surface: ``submit() -> RequestHandle``,
    ``step``, ``busy``, ``drain``, ``cancel``, ``queue_pressure``,
    ``stats``, ``metrics``. The engine tiers build a reduced model
    when ``model_cfg``/``params`` are not supplied.

    ``mesh_shape`` ((data, model), real-engine tiers only): every engine
    replica spans a ("data", "model") mesh of d*m devices
    (``EngineConfig.mesh_shape``); sim tiers reject it.

    ``device``: where the real-engine tiers run (the CUDA device by
    default; ``"cpu"`` on request). The sim tiers run no device code.

    ``gateway``: wrap the built tier in the multi-tenant admission
    layer (``serving.gateway.Gateway``) — pass ``True`` for the default
    policy or a ``GatewayConfig``. The return value is then the Gateway
    (itself a ``ServingSystem``); on the sim tier it inherits the
    node's cost model so SLO wait estimates start calibrated.
    """
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; one of {TIERS}")
    if mesh_shape is not None and tier not in ("engine", "cluster",
                                               "disagg"):
        raise ValueError(
            f"mesh_shape applies to the real-engine tiers, not {tier!r}")

    def _gated(sys_, cost=None):
        if not gateway:
            return sys_
        from .gateway import Gateway, GatewayConfig
        gcfg = gateway if isinstance(gateway, GatewayConfig) else None
        return Gateway(sys_, gcfg, cost_model=cost)

    if tier == "sim":
        sim, _, cost = build_node(system, node or NodeConfig(seed=seed))
        return _gated(sim, cost)
    if tier == "sim-cluster":
        from .cluster import Cluster, ClusterConfig
        cl = Cluster(ClusterConfig(
            n_nodes=n_nodes, system=system, policy=policy,
            node=node or NodeConfig(seed=seed)))
        return _gated(cl, cl.nodes[0].cost if cl.nodes else None)
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    if model_cfg is None or params is None:
        model_cfg, params = _default_model(device)
    if mesh_shape is not None:
        import dataclasses

        from .engine import EngineConfig
        ecfg = dataclasses.replace(ecfg or EngineConfig(),
                                   mesh_shape=tuple(mesh_shape))
    if tier == "engine":
        return _gated(build_engine(system, model_cfg, params, ecfg,
                                   device=device))
    if tier == "disagg":
        from .disagg import DisaggCluster, DisaggConfig
        n_prefill = max(1, n_nodes // 2)
        return _gated(DisaggCluster(model_cfg, params, ecfg, DisaggConfig(
            n_prefill=n_prefill, n_decode=max(1, n_nodes - n_prefill),
            system=system, seed=seed), device=device))
    from .cluster import EngineCluster, EngineClusterConfig
    return _gated(EngineCluster(model_cfg, params, ecfg, EngineClusterConfig(
        n_engines=n_nodes, system=system, policy=policy, seed=seed),
        device=device))
