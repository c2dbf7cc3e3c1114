"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (STUB:
``input_specs()`` provides precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    activation="silu",
    norm_eps=1e-5,
    tie_embeddings=False,
    frontend="vision",
    frontend_tokens=576,       # 24x24 CLIP patch grid stand-in
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    notes="modality frontend is a stub per the assignment",
)

SMOKE = FULL.with_(
    name="phi3v-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, frontend_tokens=8,
    dtype="float32", param_dtype="float32")

register("phi-3-vision-4.2b", FULL, SMOKE)
