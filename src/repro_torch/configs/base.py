"""Model configs (data only, copied from the reference ``repro.configs``
and held equal to it by tests/test_torch_configs_scenarios.py).

Each architecture the port uses provides a module
``repro_torch.configs.<id>`` with ``FULL`` (the exact published config)
and ``SMOKE`` (a reduced same-family config).  Today only the smoke
configs that ``scenarios.corpus.model_region_tree`` builds region trees
from are here; the other architectures, parameter counting and the input
shape table come with the models.  Dtypes are kept as strings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0
    d_ff: int = 0                  # per-expert hidden
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # 'ep' shards the expert dim over the model axis; 'tp' shards each
    # expert's hidden dim (used when n_experts < model-axis size).
    sharding: str = "ep"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 = no q compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    """RWKV6 / RG-LRU parameters."""

    head_dim: int = 64             # rwkv wkv head size
    lru_width: int = 0             # rg-lru width (0 = d_model)
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    # attention
    rope_theta: float = 10000.0
    rope_style: str = "half"       # half | interleaved | partial (chatglm 2d)
    rope_fraction: float = 1.0     # fraction of head_dim rotated
    window: Optional[int] = None   # sliding-window size (SWA)
    causal: bool = True
    attn_logit_softcap: Optional[float] = None
    # mlp
    activation: str = "silu"       # silu (swiglu) | gelu (geglu)
    # norm / embedding
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    scale_embed: bool = False      # gemma-style sqrt(d) embedding scale
    # families
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    n_encoder_layers: int = 0      # encdec only
    frontend: Optional[str] = None  # vision | audio (stub frontends)
    frontend_tokens: int = 0       # patches/frames provided by the stub
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat_policy: str = "nothing"  # nothing | dots | full
    use_flash: bool = False        # the reference's flash-attention kernel path
    # attention blocking (the reference's chunked path and dry-run cost model)
    attn_q_block: int = 512
    attn_k_block: int = 1024
    # probe mode: unroll every scan so cost_analysis counts true FLOPs
    # (dry-run cost probes only; see the reference's launch/dryrun.py)
    probe_unroll: bool = False
    # metadata
    source: str = ""
    notes: str = ""

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    full: ModelConfig
    smoke: ModelConfig


def register(arch_id: str, full: ModelConfig, smoke: ModelConfig) -> ArchEntry:
    e = ArchEntry(arch_id, full, smoke)
    _REGISTRY[arch_id] = e
    return e


def get_arch(arch_id: str) -> ArchEntry:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_ARCH_MODULES = ["chatglm3_6b", "gemma_7b", "deepseek_v2_lite",
                 "mixtral_8x22b"]

_loaded = False


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
