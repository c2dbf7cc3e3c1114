"""mistral-nemo-12b [dense] — 128k context, explicit head_dim=128
(n_heads*head_dim = 4096 != d_model).  [hf:mistralai/Mistral-Nemo-Base-2407]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,
    activation="silu",
    norm_eps=1e-5,
    tie_embeddings=False,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)

SMOKE = FULL.with_(
    name="nemo-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=256, dtype="float32", param_dtype="float32")

register("mistral-nemo-12b", FULL, SMOKE)
