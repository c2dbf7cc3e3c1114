"""Serving engine: batched prefill + interleaved decode, instrumented
with a serving region tree (docs/serving.md), and ``TorchBackend``, which
runs it on the port's model.  The reference's analytic
``CostModelBackend`` (serve/cost.py) is not ported yet (ROADMAP.md
queue 1, item 3)."""
from .engine import (DECODE, KV_APPEND, MOE, PREFILL, SAMPLE, LaneEvent,
                     RequestRecord, ServeConfig, ServeEngine, ServeScheduler,
                     serve_region_tree)
from .runtime import TorchBackend, call_costs, supports_chunk

__all__ = [
    "DECODE", "KV_APPEND", "MOE", "PREFILL", "SAMPLE", "LaneEvent",
    "RequestRecord", "ServeConfig", "ServeEngine", "ServeScheduler",
    "serve_region_tree", "TorchBackend", "call_costs", "supports_chunk",
]
