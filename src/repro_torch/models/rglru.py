"""RG-LRU recurrent block (RecurrentGemma / Griffin): the twin of the
reference's ``repro.models.rglru``.

    r_t = sigmoid(W_a x_t)            # recurrence gate
    i_t = sigmoid(W_x x_t)            # input gate
    a_t = a ** (c * r_t)              # a = sigmoid(Λ), c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The recurrence is elementwise-gated and linear, so :func:`rglru_scan`
computes it in log depth: a Hillis–Steele doubling scan over the time
axis in float32, out of place so that autograd differentiates through
it (the reference uses ``lax.associative_scan``; it is not a Pallas
kernel).  :func:`rglru_scan_reference` is the sequential oracle.  A
decode call (one token, with a state) takes the recurrence's one step
directly, as the reference does.

Parameters, in the reference's layouts: ``w_in`` (d, w), ``w_out`` (w,
d), ``conv`` (cw, w), ``w_a`` and ``w_x`` (w, w), ``lam`` (w,).  The
decode state is ``{"conv": (B, cw - 1, w) in the activation dtype, "h":
(B, w) float32}``, updated in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_C = 8.0


def width(cfg: ModelConfig) -> int:
    return cfg.recurrent.lru_width or cfg.d_model


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The reference's ``init_rglru_block`` layouts; ``lam`` is drawn
    uniform in [3, 6) (so a = sigmoid(Λ) lies near 0.95..0.998), every
    matrix at 1/sqrt(fan_in)."""
    d, w, cw = cfg.d_model, width(cfg), cfg.recurrent.conv_width
    return {"w_in": (d, w), "w_out": (w, d), "conv": (cw, w),
            "w_a": (w, w), "w_x": (w, w), "lam": (w,)}


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, W), w (cw, W): a depthwise causal convolution.  ``state``
    is the last cw - 1 inputs before x (zeros without one).  Returns (out
    (B, T, W), the last cw - 1 inputs of the padded sequence)."""
    cw, T = w.shape[0], x.shape[1]
    pad = state if state is not None else x.new_zeros(
        (x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:T] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + T] * w[i]
    return out, xp[:, xp.shape[1] - (cw - 1):]


def rglru_scan(a: torch.Tensor, bx: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + bx_t for a, bx (B, T, W), from h0 (B, W) (zeros
    without one): every h_t (B, T, W).  Log depth: after the round of
    offset o each position holds the composition of the (a, b) pairs of
    the o·2 positions ending at it, (a1, b1) then (a2, b2) composing to
    (a1·a2, a2·b1 + b2)."""
    if h0 is not None:
        # h_1 = a_1 h_0 + b_1: fold the initial state into the first step
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]],
                       dim=1)
    T = a.shape[1]
    off = 1
    while off < T:
        b_new = a[:, off:] * bx[:, :-off] + bx[:, off:]
        a_new = a[:, :-off] * a[:, off:]
        bx = torch.cat([bx[:, :off], b_new], dim=1)
        a = torch.cat([a[:, :off], a_new], dim=1)
        off *= 2
    return bx


def rglru_scan_reference(a: torch.Tensor, bx: torch.Tensor,
                         h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential oracle for :func:`rglru_scan`."""
    h = a.new_zeros((a.shape[0], a.shape[2])) if h0 is None else h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_block(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """x (B, T, d) -> y (B, T, d).  With ``state`` ({"conv", "h"}) the
    block continues from it and updates it in place."""
    u = x @ p["w_in"]
    u, new_conv = causal_conv1d(u, p["conv"],
                                None if state is None else state["conv"])
    r = torch.sigmoid((u @ p["w_a"]).float())
    i = torch.sigmoid((u @ p["w_x"]).float())
    log_a = -_C * r * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.float())
    h0 = None if state is None else state["h"]
    if x.shape[1] == 1 and h0 is not None:
        h = a[:, 0] * h0 + bx[:, 0]
        hs = h[:, None]
    else:
        hs = rglru_scan(a, bx, h0)
        h = hs[:, -1]
    if state is not None:   # in place: the state keeps its addresses
        state["conv"].copy_(new_conv)
        state["h"].copy_(h)
    return hs.to(x.dtype) @ p["w_out"]
