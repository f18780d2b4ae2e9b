"""The port's continuous-batching serving subsystem (twin of
``repro/serving/``): the engine, its typed requests and results, the
sampler's parameters, the paged and slot-state caches, the scheduler, the
metrics and telemetry, the Chrome tracer and the exporters.  The
reference's ``detok.py`` and ``cluster/`` are not ported yet.
"""
from repro_torch.serving.cache_manager import (PAGEABLE_KINDS,
                                               SLOT_STATE_KINDS,
                                               UnifiedCacheManager)
from repro_torch.serving.engine import (ContinuousBatchingEngine, Request,
                                        RequestOutput)
from repro_torch.serving.export import (SnapshotWriter, atomic_write_text,
                                        prometheus_text)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.paged_cache import BlockAllocator, PagedKVCache
from repro_torch.serving.prefix_hash import chain_keys
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.scheduler import RequestScheduler
from repro_torch.serving.telemetry import (Counter, Gauge, LogHistogram,
                                           SlidingWindow, Telemetry)
from repro_torch.serving.tracing import ChromeTracer, validate_chrome_trace

__all__ = ["ContinuousBatchingEngine", "Request", "RequestOutput",
           "SamplingParams", "GREEDY", "ServingMetrics", "BlockAllocator",
           "PagedKVCache", "UnifiedCacheManager", "RequestScheduler",
           "PAGEABLE_KINDS", "SLOT_STATE_KINDS",
           "Counter", "Gauge", "LogHistogram", "SlidingWindow", "Telemetry",
           "ChromeTracer", "validate_chrome_trace",
           "SnapshotWriter", "atomic_write_text", "prometheus_text",
           "chain_keys"]
