"""gemma-7b [dense] — GeGLU, head_dim=256, MHA (16 q = 16 kv heads),
sqrt(d) embedding scale, tied embeddings, huge vocab.  [arXiv:2403.08295; hf]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    activation="gelu",         # GeGLU
    norm_eps=1e-6,
    tie_embeddings=True,
    scale_embed=True,
    source="arXiv:2403.08295; hf",
)

SMOKE = FULL.with_(
    name="gemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=256, dtype="float32", param_dtype="float32")

register("gemma-7b", FULL, SMOKE)
