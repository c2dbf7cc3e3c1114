"""chatglm3-6b [dense] — RoPE 2d (partial/interleaved), GQA kv=2.
[arXiv:2406.12793; hf:THUDM/chatglm3-6b]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope_style="partial",      # chatglm rotates half the head dims, interleaved pairs
    rope_fraction=0.5,
    activation="silu",
    norm_eps=1e-5,
    tie_embeddings=False,
    source="arXiv:2406.12793; hf",
)

SMOKE = FULL.with_(
    name="chatglm3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, dtype="float32", param_dtype="float32")

register("chatglm3-6b", FULL, SMOKE)
