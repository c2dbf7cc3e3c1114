"""recurrentgemma-9b (Griffin) [hybrid] — RG-LRU + local attention in a
(rec, rec, attn) 1:2 pattern; MQA (kv=1), head_dim=256, window 2048.
[arXiv:2402.19427; unverified]
"""
from .base import ModelConfig, RecurrentConfig, register

FULL = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    window=2048,
    activation="gelu",
    norm_eps=1e-6,
    tie_embeddings=True,
    scale_embed=True,
    recurrent=RecurrentConfig(lru_width=4096, conv_width=4,
                              block_pattern=("rec", "rec", "attn")),
    source="arXiv:2402.19427; unverified",
)

SMOKE = FULL.with_(
    name="rgemma-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
    head_dim=16, d_ff=128, vocab=256, window=16,
    recurrent=RecurrentConfig(lru_width=64, conv_width=4,
                              block_pattern=("rec", "rec", "attn")),
    dtype="float32", param_dtype="float32")

register("recurrentgemma-9b", FULL, SMOKE)
