"""RWKV-6 (Finch) blocks: time-mix with data-dependent decay, and
channel-mix.  The twin of the reference's ``repro.models.rwkv``.

The WKV-6 recurrence runs through the port's kernel
(:func:`repro_torch.kernels.wkv6`): on CUDA tensors the hand-written
``csrc/wkv6.cu``, on CPU tensors its plain version.  The reference runs a
``lax.scan`` below 512 tokens and its chunked jnp form from 512 on; the
kernel computes both, and rounds its output as the chunked form does.
Where autograd needs a graph the call goes through
:class:`repro_torch.kernels.Wkv6Function` instead (the same kernel
forward on a fresh state, and a plain backward), so training differentiates
it as the reference differentiates its scan and its chunked form.

Parameters are in the reference's layout (``init_rwkv_block``): the
token-shift mixes ``mu_r, mu_k, mu_v, mu_g, mu_w`` and ``mu_c`` (d,), the
projections ``wr, wk, wv, wg, wo, cr`` (d, d), the decay lora
``w_lora_a`` (d, 64) and ``w_lora_b`` (64, d), the base decay ``w0``, the
bonus ``u`` and the group-norm weight ``ln_x`` (d,), and the channel-mix
``ck`` (d, ff) and ``cv`` (ff, d).

A layer's decode state is ``{"S": (B, H, dh, dh) float32, "last_tm",
"last_cm": (B, d)}``; ``S`` is updated in place by the kernel (a call
without a gradient), and the mixes return the new ``last_*`` for the
caller to store.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import Wkv6Function, local, wkv6
from repro_torch.sharding import gather_seq

from .layers import _differentiable

LORA = 64          # the decay lora's rank (init_rwkv_block)
GROUP_NORM_EPS = 1e-5  # a literal in the reference, not cfg.norm_eps
ZERO_INIT = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "ln_x", "mu_c")


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of one block's parameters, in the reference's order."""
    d, ff = cfg.d_model, cfg.d_ff
    shapes = {nm: (d,) for nm in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")}
    shapes.update({nm: (d, d) for nm in ("wr", "wk", "wv", "wg", "wo")})
    shapes.update(w_lora_a=(d, LORA), w_lora_b=(LORA, d), w0=(d,), u=(d,),
                  ln_x=(d,), mu_c=(d,), ck=(d, ff), cv=(ff, d), cr=(d, d))
    return shapes


def heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(H, dh) of the WKV heads: d_model / head_dim heads of head_dim."""
    dh = cfg.recurrent.head_dim
    return cfg.d_model // dh, dh


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: x_{t-1}, with zeros (or the carried ``prev`` (B, D))
    at t = 0.  x: (B, T, D)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _heads(t: torch.Tensor, dh: int) -> torch.Tensor:
    """(..., H·dh) -> (..., H, dh); a DTensor shard by shard
    (``kernels.local.split_dim``)."""
    if local.is_dtensor(t):
        return local.split_dim(t, t.dim() - 1, dh)
    return t.reshape(*t.shape[:-1], -1, dh)


def rwkv_time_mix(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, T, D), the normed block input.  With ``state`` the token shift
    starts from ``state["last_tm"]`` and the recurrence from
    ``state["S"]``; without it both start from zeros.  A call that
    autograd records runs :class:`Wkv6Function` and returns the final
    state as a new tensor; any other call updates ``S`` in place.
    Under sequence parallelism x's sequence is gathered first.  Returns
    (y (B, T, D), {"S", "last_tm"})."""
    x = gather_seq(x)
    B, T, D = x.shape
    H, dh = heads(cfg)
    xs = _shift(x, None if state is None else state["last_tm"])

    def lerp(mu):
        return x + (xs - x) * mu

    r = lerp(p["mu_r"]) @ p["wr"]
    k = lerp(p["mu_k"]) @ p["wk"]
    v = lerp(p["mu_v"]) @ p["wv"]
    g = lerp(p["mu_g"]) @ p["wg"]
    dd = p["w0"] + (lerp(p["mu_w"]) @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(dd.float()))        # (B, T, D) in (0, 1)

    S = (state["S"] if state is not None else
         torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device))
    args = (*(_heads(t, dh).contiguous() for t in (r, k, v, w)),
            _heads(p["u"], dh).float().contiguous())
    if _differentiable(*args):
        call = Wkv6Function.apply
    else:
        call = wkv6
    if local.is_dtensor(args[0]):   # each rank's batch and heads
        out = local.wkv6(*args, S, call)
    else:
        out = call(*args, S)
    y, S = out if isinstance(out, tuple) else (out, S)
    # Per-head group norm with the population variance, then the gate in
    # the activation dtype.
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + GROUP_NORM_EPS)
    y = local.merge_dims(y, 2) if local.is_dtensor(y) else y.reshape(B, T, D)
    y = y * (1.0 + p["ln_x"].float())
    y = y.to(x.dtype) * F.silu(g)
    return y @ p["wo"], {"S": S, "last_tm": x[:, -1]}


def rwkv_channel_mix(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                     x: torch.Tensor, state: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, T, D), the normed input.  The key sees the token shift (from
    ``state["last_cm"]`` with a state); the receptance ``cr`` sees x
    unshifted; the activation is relu², whatever ``cfg.activation`` says.
    Returns (y (B, T, D), {"last_cm"})."""
    x = gather_seq(x)
    xs = _shift(x, None if state is None else state["last_cm"])
    xk = x + (xs - x) * p["mu_c"]
    k = torch.square(F.relu(xk @ p["ck"]))
    r = torch.sigmoid(x @ p["cr"])
    return r * (k @ p["cv"]), {"last_cm": x[:, -1]}
