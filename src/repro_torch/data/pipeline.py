"""Synthetic data pipeline with shard-aware host loading.

The PyTorch port of the reference's ``repro/data/pipeline.py``.  The numpy
token stream (:func:`_tokens_for`, :func:`host_batch`) is a copy of the
reference's, so a batch is the reference's bit for bit; only
:func:`device_batch` differs, placing the batch as tensors on a device.

Deterministic token streams per (step, shard) let any process of a
multi-host job materialise exactly its shard without coordination — the
property that makes checkpoint-restart and elastic re-meshing trivial (the
stream is addressed by global step, not by an iterator cursor).
:func:`batch_for_model` adds the stub frontends' embeddings for the vlm
and encdec families, drawn from a ``torch.Generator`` seeded with the
step (the reference draws them with ``jax.random``, so only their shapes
and dtypes match the reference's).

``skew`` injects per-shard load imbalance (padding fraction) used by the
AutoAnalyzer dissimilarity demos (the paper's ST scenario).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    vocab: int = 32768
    seed: int = 1234
    skew: Optional[Sequence[float]] = None   # per-shard pad fraction


def _tokens_for(step: int, shard: int, n: int, seq: int, vocab: int,
                seed: int) -> np.ndarray:
    rng = np.random.default_rng(np.uint64(seed) + np.uint64(step) * 1000003
                                + np.uint64(shard) * 7919)
    # Markov-ish stream: cheap but non-uniform so loss can decrease.
    base = rng.integers(0, vocab, size=(n, seq), dtype=np.int32)
    run = rng.integers(0, vocab, size=(n, 1), dtype=np.int32)
    mask = rng.random((n, seq)) < 0.5
    return np.where(mask, base, np.broadcast_to(run, (n, seq))).astype(np.int32)


def host_batch(cfg: DataConfig, step: int, n_shards: int = 1,
               shard: int = 0) -> Dict[str, np.ndarray]:
    """The shard's slice of the global batch at ``step`` (numpy, host)."""
    n = cfg.global_batch // n_shards
    toks = _tokens_for(step, shard, n, cfg.seq_len, cfg.vocab, cfg.seed)
    mask = np.ones_like(toks, dtype=np.float32)
    if cfg.skew is not None:
        pad_frac = float(cfg.skew[shard % len(cfg.skew)])
        pad = int(cfg.seq_len * pad_frac)
        if pad:
            toks[:, cfg.seq_len - pad:] = 0
            mask[:, cfg.seq_len - pad:] = 0.0
    return {"tokens": toks, "labels": toks.copy(), "mask": mask}


def to_device(batch: Dict[str, np.ndarray],
              device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: tokens and labels int64 (the
    embedding's and the loss's index type), the mask float32."""
    return {k: torch.from_numpy(v).to(
        device, dtype=torch.int64 if v.dtype.kind == "i" else None)
        for k, v in batch.items()}


def device_batch(cfg: DataConfig, step: int,
                 device: Union[None, str, torch.device] = None
                 ) -> Dict[str, torch.Tensor]:
    """The global batch at ``step`` as tensors on ``device`` (None: the
    card, which raises without one)."""
    return to_device(host_batch(cfg, step), resolve_device(device))


def batch_iterator(cfg: DataConfig, start_step: int = 0,
                   device: Union[None, str, torch.device] = None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    device = resolve_device(device)
    step = start_step
    while True:
        yield device_batch(cfg, step, device)
        step += 1


def batch_for_model(model_cfg: ModelConfig, shape: InputShape,
                    batch_override: Optional[int] = None,
                    seq_override: Optional[int] = None, step: int = 0,
                    device: Union[None, str, torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """A concrete batch matching a model config's inputs, as tensors on
    ``device`` (None: the card).  Tokens, labels and mask are
    :func:`host_batch`'s; a vlm or encdec config with a frontend adds
    ``embeds`` (B, frontend_tokens, d) in its activation dtype, drawn in
    float32 on the host from a generator seeded with ``step`` (the same
    values on every device), and a vlm's text is cut to the rest of the
    sequence, ``max(S - frontend_tokens, 2)`` tokens."""
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    dcfg = DataConfig(seq_len=S, global_batch=B, vocab=model_cfg.vocab)
    b = to_device(host_batch(dcfg, step), resolve_device(device))
    if model_cfg.family in ("vlm", "encdec", "audio") and model_cfg.frontend:
        P = model_cfg.frontend_tokens
        gen = torch.Generator().manual_seed(step)
        b["embeds"] = torch.randn((B, P, model_cfg.d_model), generator=gen
                                  ).to(b["tokens"].device,
                                       model_cfg.activation_dtype())
        if model_cfg.family == "vlm":
            S_text = max(S - P, 2)
            for k in ("tokens", "labels", "mask"):
                b[k] = b[k][:, :S_text].contiguous()
    return b
