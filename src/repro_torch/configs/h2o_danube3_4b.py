"""h2o-danube3-4b [dense] — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]  head_dim = 3840/32 = 120.
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="h2o-danube3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    window=4096,               # SWA (mistral-style)
    activation="silu",
    norm_eps=1e-5,
    tie_embeddings=False,
    source="arXiv:2401.16818; unverified",
    notes="assignment marks SWA; window=4096 per the mistral lineage",
)

SMOKE = FULL.with_(
    name="danube3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, window=16, dtype="float32", param_dtype="float32")

register("h2o-danube-3-4b", FULL, SMOKE)
