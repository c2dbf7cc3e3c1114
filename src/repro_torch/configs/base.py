"""Model configs (copied from the reference ``repro.configs`` and held
equal to it by tests/test_torch_configs_scenarios.py).

Each architecture provides a module ``repro_torch.configs.<id>`` with
``FULL`` (the exact published config) and ``SMOKE`` (a reduced
same-family config): all eleven of the reference's, one or more of every
family (dense, moe, ssm, vlm, hybrid, encdec).  Dtypes are kept as strings;
:meth:`ModelConfig.activation_dtype` and :meth:`ModelConfig.parameter_dtype`
turn them into torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch


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

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def parameter_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for 6ND model flops) -------------------------
    def param_count(self) -> int:
        d, dh, H, KV = self.d_model, self.resolved_head_dim, self.n_heads, self.n_kv_heads
        embed = self.vocab * d
        out_head = 0 if self.tie_embeddings else self.vocab * d

        def attn_params() -> int:
            if self.mla:
                m = self.mla
                q = d * H * (m.nope_head_dim + m.rope_head_dim)
                kv_a = d * (m.kv_lora_rank + m.rope_head_dim)
                kv_b = m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
                o = H * m.v_head_dim * d
                return q + kv_a + kv_b + o
            return d * H * dh + 2 * d * KV * dh + H * dh * d

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # gate, up, down

        def layer_params() -> int:
            p = 2 * d  # norms
            if self.family in ("ssm",):
                # rwkv6 time-mix + channel-mix (approximate real layout).
                # Kept equal to the reference's count, which leaves out
                # two d x d matrices, half the decay lora and three
                # d-vectors of each layer: 2,648,312,320 for
                # rwkv6-3b against 3,073,231,360 real parameters, so
                # serve/runtime.py counts weight bytes from the model.
                tm = 4 * d * d + d * dh + 6 * d  # r,k,v,g,o + decay lora + mixes
                cm = d * self.d_ff * 2
                return p + tm + cm
            p += attn_params() if self.family != "ssm" else 0
            if self.moe:
                mo = self.moe
                p += d * mo.n_experts  # router
                p += mo.n_experts * mlp_params(mo.d_ff)
                p += mo.n_shared * mlp_params(mo.d_ff)
            else:
                p += mlp_params(self.d_ff)
            return p

        n_dec = self.n_layers
        total = embed + out_head + d  # final norm
        if self.family == "encdec":
            # encoder self-attn+mlp, decoder self+cross+mlp
            enc = self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            dec = n_dec * (2 * attn_params() + mlp_params(self.d_ff) + 3 * d)
            return total + enc + dec
        if self.family == "hybrid":
            r = self.recurrent
            lru = r.lru_width or d
            n_rec = sum(1 for i in range(self.n_layers)
                        if r.block_pattern[i % len(r.block_pattern)] == "rec")
            n_att = self.n_layers - n_rec
            # Kept equal to the reference's count, which has three d x lru
            # matrices a recurrent block where the block has w_in, w_out,
            # w_a and w_x: 8,523,935,744 for recurrentgemma-9b against
            # 8,959,881,216 real parameters.  The vlm count also leaves out
            # vis_proj (d x d).  serve/runtime.py counts weight bytes from
            # the model.
            rec_p = 2 * d * lru + lru * d + 2 * lru + r.conv_width * lru + 2 * d
            att_p = attn_params() + 2 * d
            mlp_p = mlp_params(self.d_ff) + d
            return total + n_rec * rec_p + n_att * att_p + self.n_layers * mlp_p
        return total + n_dec * layer_params()

    def active_param_count(self) -> int:
        """Active params per token (= param_count for dense)."""
        if not self.moe:
            return self.param_count()
        mo = self.moe
        inactive = (mo.n_experts - mo.top_k) * 3 * self.d_model * mo.d_ff
        return self.param_count() - self.n_layers * inactive


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only the ssm and hybrid
# families take it.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shapes_for(cfg: ModelConfig) -> List[InputShape]:
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.family in LONG_CONTEXT_FAMILIES:
        out.append(SHAPES["long_500k"])
    return out


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


_ARCH_MODULES = ["chatglm3_6b", "h2o_danube3_4b", "mistral_nemo_12b",
                 "gemma_7b", "deepseek_v2_lite", "mixtral_8x22b", "rwkv6_3b",
                 "phi3_vision_4_2b", "recurrentgemma_9b",
                 "seamless_m4t_medium", "st_synthetic"]

_loaded = False


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
