"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512), 2 shared + 64 routed
experts top-6, expert d_ff=1408.  [arXiv:2405.04434; hf]

Assignment line lists both '64e top-6' and '2 shared+160 routed'; we honor
the explicit inline numbers (64 routed, top-6, +2 shared) — see DESIGN.md §5.
"""
from .base import MLAConfig, ModelConfig, MoEConfig, register

FULL = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,             # MLA: kv heads == q heads post-decompression
    d_ff=1408,
    vocab=102400,
    activation="silu",
    norm_eps=1e-6,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff=1408,
                  capacity_factor=1.25, sharding="ep"),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    source="arXiv:2405.04434; hf",
)

SMOKE = FULL.with_(
    name="dsv2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_ff=32,
                  capacity_factor=2.0, sharding="ep"),
    mla=MLAConfig(kv_lora_rank=16, rope_head_dim=8, nope_head_dim=16,
                  v_head_dim=16),
    dtype="float32", param_dtype="float32")

register("deepseek-v2-lite-16b", FULL, SMOKE)
