"""seamless-m4t-medium [audio] — encoder-decoder transformer backbone;
the speech frontend is a STUB (``input_specs()`` provides precomputed frame
embeddings).  [arXiv:2308.11596; hf]
"""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,               # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    activation="gelu",
    norm_eps=1e-5,
    tie_embeddings=True,
    frontend="audio",
    frontend_tokens=1024,      # encoder frames provided by the stub
    source="arXiv:2308.11596; hf",
    notes="enc-dec; decode shapes lower the decoder against a precomputed "
          "encoder output",
)

SMOKE = FULL.with_(
    name="seamless-smoke", n_layers=2, n_encoder_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, frontend_tokens=16,
    dtype="float32", param_dtype="float32")

register("seamless-m4t-medium", FULL, SMOKE)
