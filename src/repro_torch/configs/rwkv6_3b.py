"""rwkv6-3b (Finch) [ssm] — attention-free, data-dependent decay; wkv head
size 64 (40 heads).  [arXiv:2404.05892; hf]
"""
from .base import ModelConfig, RecurrentConfig, register

FULL = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                # wkv heads = d_model / head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    activation="relu_sq",      # rwkv channel-mix uses squared relu
    norm_eps=1e-5,
    tie_embeddings=False,
    recurrent=RecurrentConfig(head_dim=64),
    source="arXiv:2404.05892; hf",
)

SMOKE = FULL.with_(
    name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, recurrent=RecurrentConfig(head_dim=16),
    dtype="float32", param_dtype="float32")

register("rwkv6-3b", FULL, SMOKE)
