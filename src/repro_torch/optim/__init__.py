"""The optimizer and the int8 compressed all-reduce (the reference's
``repro.optim``)."""
from .adamw import (AdamWConfig, apply_updates, global_norm, init_opt_state,
                    lr_at)
from .compression import (compressed_psum_fn, dequantize_int8,
                          pod_compressed_allreduce, quantize_int8,
                          quantize_tree)

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_opt_state",
           "lr_at", "compressed_psum_fn", "dequantize_int8",
           "pod_compressed_allreduce", "quantize_int8", "quantize_tree"]
