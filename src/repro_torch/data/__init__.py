"""The synthetic token pipeline (the reference's ``repro.data``)."""
from .pipeline import (DataConfig, batch_for_model, batch_iterator,
                       device_batch, host_batch, to_device)

__all__ = ["DataConfig", "batch_for_model", "batch_iterator", "device_batch",
           "host_batch", "to_device"]
