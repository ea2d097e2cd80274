"""Serving runtime of the port: handles, metrics, the PyTorch engine.

``repro_torch.serving.engine`` (the data plane) is imported on demand.
"""
from .handles import (RequestHandle, RequestResult, ServingSystem,
                      prepare_request)
from .metrics import (GAUGES, RequestRecord, RunMetrics, merge_metrics,
                      slo_from_lowload)
from .systems import ENGINE_SYSTEMS, TIERS, build_engine, build_system
