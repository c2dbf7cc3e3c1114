"""The synthetic token pipeline (the reference's ``repro.data``, without
``batch_for_model``, which waits for the input-shape table: ROADMAP.md
queue 1, item 5)."""
from .pipeline import (DataConfig, batch_iterator, device_batch, host_batch,
                       to_device)

__all__ = ["DataConfig", "batch_iterator", "device_batch", "host_batch",
           "to_device"]
