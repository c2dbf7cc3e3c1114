"""The paper's own workload, as a synthetic analogue: a ~100M dense LM used
by the end-to-end examples plus the ST-scenario behaviour injection (paper
§6.1).  This is the framework's "paper config".
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="st-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=32768,
    activation="gelu",
    tie_embeddings=True,
    dtype="float32",
    param_dtype="float32",
    source="paper §6.1 analogue",
)

SMOKE = FULL.with_(name="st-smoke", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=4, d_ff=128, vocab=256)

register("st-100m", FULL, SMOKE)
