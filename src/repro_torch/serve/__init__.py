"""Serving engine: batched prefill + interleaved decode, instrumented
with a serving region tree (docs/serving.md), ``TorchBackend``, which
runs it on the port's model, and the analytic ``CostModelBackend`` the
serving corpus runs."""
from .cost import CostModelBackend, ServeCostModel, serving_analyzer_meta
from .engine import (DECODE, KV_APPEND, MOE, PREFILL, SAMPLE, LaneEvent,
                     RequestRecord, ServeConfig, ServeEngine, ServeScheduler,
                     serve_region_tree)
from .runtime import TorchBackend, call_costs, supports_chunk

__all__ = [
    "CostModelBackend", "ServeCostModel", "serving_analyzer_meta",
    "DECODE", "KV_APPEND", "MOE", "PREFILL", "SAMPLE", "LaneEvent",
    "RequestRecord", "ServeConfig", "ServeEngine", "ServeScheduler",
    "serve_region_tree", "TorchBackend", "call_costs", "supports_chunk",
]
