"""Chameleon core: the paper's contribution (adapter cache + scheduler).

Pure-Python control plane (host-side, as in the real system); the JAX
data plane lives in repro.serving / repro.models / repro.kernels.
"""
from .adapter_cache import (AdapterCache, AdapterState, CacheEntry,
                            CacheStats, CostAwareEviction, EvictionWeights,
                            FairShareEviction, LRUEviction)
from .baselines import FIFOScheduler, SJFScheduler
from .kmeans import choose_queues, kmeans_1d, queue_index
from .lora import (PAPER_RANKS, AdapterInfo, adapter_bytes, assign_adapters,
                   build_adapter_pool, powerlaw_rank_sampler)
from .memory_pool import MemoryPool, PoolError, kv_token_bytes
from .predictor import (HistogramPredictor, NoisyOraclePredictor, bucket_of,
                        bucket_repr, measure_accuracy, predict_request)
from .prefetcher import HistogramPrefetcher, QueuedRequestPrefetcher
from .prefix_cache import PrefixCache, PrefixNode
from .quotas import QueueStats, assign_quotas, tok_min
from .request import Request, RequestState, TERMINAL_STATES
from .sampling import GREEDY, SamplingParams
from .scheduler import BaseScheduler, ChameleonScheduler
from .wrs import OutputOnlyCalculator, WRSCalculator, WRSWeights

__all__ = [
    "AdapterCache", "AdapterState", "CacheEntry", "CacheStats",
    "CostAwareEviction",
    "EvictionWeights", "FairShareEviction", "LRUEviction",
    "FIFOScheduler", "SJFScheduler",
    "choose_queues", "kmeans_1d", "queue_index",
    "PAPER_RANKS", "AdapterInfo", "adapter_bytes", "assign_adapters",
    "build_adapter_pool", "powerlaw_rank_sampler",
    "MemoryPool", "PoolError", "kv_token_bytes",
    "HistogramPredictor", "NoisyOraclePredictor", "bucket_of",
    "bucket_repr", "measure_accuracy", "predict_request",
    "HistogramPrefetcher", "QueuedRequestPrefetcher",
    "PrefixCache", "PrefixNode",
    "QueueStats", "assign_quotas", "tok_min",
    "Request", "RequestState", "TERMINAL_STATES",
    "GREEDY", "SamplingParams",
    "BaseScheduler", "ChameleonScheduler",
    "OutputOnlyCalculator", "WRSCalculator", "WRSWeights",
]
