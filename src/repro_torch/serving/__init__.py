"""Serving runtime of the port: trace synthesis, cost model, simulator,
gateway, the tiers of ``build_system`` and the PyTorch engine.

``repro_torch.serving.engine`` (the data plane) is imported on demand.
"""
from .cost_model import (A40, A100_80G, TPU_V5E, CostModel, HardwareSpec,
                         HW_PRESETS, MODEL_PRESETS, ModelSpec)
from .handles import (RequestHandle, RequestResult, ServingSystem,
                      prepare_request)
from .gateway import (Gateway, GatewayConfig, GatewayDecision,
                      TenantPolicy)
from .metrics import (GAUGES, RequestRecord, RunMetrics, merge_metrics,
                      slo_from_lowload)
from .simulator import LinkChannel, NodeSimulator, SimConfig
from .systems import (ENGINE_SYSTEMS, SYSTEM_NAMES, TIERS, NodeConfig,
                      build_engine, build_node, build_system)
from .trace import (Trace, TraceConfig, downscale_for_engine,
                    load_azure_csv, synthesize, synthesize_multitenant)
from .cluster import (POLICIES, Cluster, ClusterConfig, EngineCluster,
                      EngineClusterConfig, Router, run_cluster)
from .disagg import (DisaggCluster, DisaggConfig, KVHandoff,
                     RoleAutoscaler)
