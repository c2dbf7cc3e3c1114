"""mixtral-8x22b [moe] — 8 experts top-2, GQA kv=8, SWA per assignment.
[arXiv:2401.04088; hf]  8 experts < model-axis(16) => 'tp' expert sharding.
"""
from .base import ModelConfig, MoEConfig, register

FULL = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    window=4096,               # assignment marks SWA (mistral lineage)
    rope_theta=1e6,
    activation="silu",
    norm_eps=1e-5,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_ff=16384,
                  capacity_factor=1.25, sharding="tp"),
    source="arXiv:2401.04088; hf",
)

SMOKE = FULL.with_(
    name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=64, vocab=256, window=16,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_ff=64,
                  capacity_factor=2.0, sharding="tp"),
    dtype="float32", param_dtype="float32")

register("mixtral-8x22b", FULL, SMOKE)
