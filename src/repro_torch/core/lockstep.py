"""Device lockstep greedy rounds for ``IncrementalClusterState``.

The host batched path of :meth:`IncrementalClusterState.cluster_batch`
still does O(trials) Python/numpy work per greedy round (one einsum per
trial for the toggle delta).  At fleet shapes — m = 16384 shards, one
trial per region — that host loop dominates Algorithm 2's cost.  This
module evaluates the same lockstep rounds as a few tensor operations per
round on the backend's torch device instead:

* toggled columns are gathered once per batch (:func:`_prep`) into a
  (trials, w, m) tensor; sentinel column ids (``n``) pad ragged toggle
  widths and are masked to zero, so padded slots contribute nothing;
* each round (:func:`_round`) computes per-trial seed-row deltas,
  thresholds, neighbourhood candidacy, the count gate and the
  label/cluster-count updates on the device; the per-trial state
  (labels, cluster counts, thresholds) lives in buffers allocated once per
  batch and updated in place round after round;
* base D² seed rows are fetched through the distance backend's batched
  device call (``device_rows`` — one kernel launch for *all* unique seeds
  a round introduces) and cached in a device-resident row cache that
  persists across rounds, sibling trial groups and windows of the same
  state, so each unique seed is fetched at most once per state.

Only zero-toggles at stack depth 0 are eligible (exactly the shape of
Algorithm 2's depth-1 sweep, its composite-window rounds, and the
baseline clustering); everything else falls back to the host path.  The
exact float64 numpy backend never routes here.

This is the PyTorch port of the reference's ``repro/core/lockstep.py``,
whose ``_prep`` and ``_round`` were jitted JAX functions (not Pallas
kernels); here they are plain PyTorch functions, run eagerly.  The
reference padded the trial count and the toggle width to powers of two
only to bound jit retraces, which eager PyTorch does not have, so they
are not padded.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _prep(Wd: torch.Tensor, Ad: torch.Tensor, cols: torch.Tensor, n: int):
    """Per-trial toggled-column gathers.

    Wd/Ad : (m, n) points and their elementwise squares.
    cols  : (nt, w) int64 toggled-column ids (sentinel ``n`` pads).
    Returns ``Wc`` (nt, w, m) toggled values and ``af`` (nt, m), the
    per-point masked squared mass ``sum_j W[q, j]^2`` over each trial's
    toggled columns.  Sentinel slots gather a real column and are masked
    to zero — column gathers touch only O(nt·w·m) values, so no
    transposed or padded copy of the full matrix is ever built.
    """
    cid = cols.clamp_max(n - 1)
    valid = (cols < n).to(Wd.dtype)                      # (nt, w)
    Wc = Wd[:, cid].permute(1, 2, 0) * valid[:, :, None]  # (nt, w, m)
    af = (Ad[:, cid] * valid[None, :, :]).sum(dim=2).T    # (nt, m)
    return Wc.contiguous(), af.contiguous()


def _round(Wc, af, sq, rcache, sidx, p, active, labels, ncl, used_thr,
           *, frac: float, fixed: Optional[float], ct: int):
    """One lockstep greedy round for every active trial — the device
    mirror of the host ``_batch_round`` semantics.

    For a zero-toggle the D² row of seed p under trial t is the base row
    plus ``-(af_t[q] + af_t[p] - 2 * sum_j W[q,j] W[p,j])`` (only toggled
    columns j contribute), and the trial's squared seed norm drops by
    ``af_t[p]`` — both O(w) per point.  The next round's seeds and
    activity are computed here too, so the driver pulls back only 2·nt
    values per round.

    ``labels``/``ncl``/``used_thr`` are updated in place: the reference
    donated these buffers to its jitted round (``donate_argnums``) so that
    each round reused the last round's memory; here they are allocated
    once per batch and overwritten.  Returns ``(p_next, active_next)``.
    """
    nt, m = labels.shape
    R = rcache[sidx]                                       # (nt, m)
    w = Wc.shape[1]
    wp = torch.gather(Wc, 2, p[:, None, None].expand(nt, w, 1))  # (nt,w,1)
    b = (Wc * wp).sum(dim=1)                               # (nt, m)
    afp = torch.gather(af, 1, p[:, None])                  # (nt, 1)
    # No zero clamp: candidacy compares against thr² >= 0, so negative
    # roundoff residue decides identically to the clamped row.
    rows = R - (af + afp - 2.0 * b)
    if fixed is None:
        sqp = (sq[p] - afp[:, 0]).clamp_min(0.0)
        thr = frac * torch.sqrt(sqp)
    else:
        thr = torch.full((nt,), fixed, dtype=rows.dtype, device=rows.device)
    used_thr.copy_(torch.where(active, torch.maximum(used_thr, thr),
                               used_thr))
    cand = (labels < 0) & (rows <= (thr * thr)[:, None])
    # cand includes the seed itself on every active trial (its own row
    # entry is exactly 0), so the neighbour count is the sum minus one.
    grow = active & (cand.sum(dim=1) - 1 >= ct)
    seed = active[:, None] & (
        torch.arange(m, device=labels.device)[None, :] == p[:, None])
    labels.copy_(torch.where((grow[:, None] & cand) | seed,
                             ncl[:, None], labels))
    ncl.add_(active.to(ncl.dtype))
    unass = labels < 0
    # argmax returns the first maximal index: the first unassigned point.
    p_next = unass.to(torch.uint8).argmax(dim=1)
    return p_next, unass.any(dim=1)


class DeviceLockstep:
    """Per-state device twin: owns the device matrices and the persistent
    device row cache, and runs eligible ``cluster_batch`` calls as
    lockstep device rounds."""

    def __init__(self, backend, handle, threshold, threshold_frac,
                 count_threshold, fetch_stats: Dict):
        self._backend = backend
        self._handle = handle
        Wd, sqd = backend.device_arrays(handle)
        self._m, self._n = int(Wd.shape[0]), int(Wd.shape[1])
        self._dev = Wd.device
        self._Wd = Wd
        self._Ad = Wd * Wd
        self._sqd = sqd
        self._fixed = None if threshold is None else float(threshold)
        self._frac = float(threshold_frac)
        self._ct = int(count_threshold)
        self._stats = fetch_stats
        # device row cache: seed -> slot in the (capacity, m) cache;
        # capacity doubles, so growing it costs O(log seeds) copies.
        self._slot: Dict[int, int] = {}
        self._rcache: Optional[torch.Tensor] = None
        self._used = 0

    # -- row cache ---------------------------------------------------------
    def _ensure_rows(self, seeds: Sequence[int]) -> None:
        """Fetch (one batched backend call) the base D² rows of every
        seed not yet cached; fetched rows stay device-resident for the
        lifetime of the state."""
        missing = [q for q in seeds if q not in self._slot]
        if not missing:
            return
        rows = self._backend.device_rows(
            self._handle, np.asarray(missing, dtype=np.int32))
        st = self._stats
        st["calls"] += 1
        st["rows"] += len(missing)
        for q in missing:
            st["per_seed"][q] = st["per_seed"].get(q, 0) + 1
        need = self._used + len(missing)
        cap = 0 if self._rcache is None else int(self._rcache.shape[0])
        if need > cap:
            newcap = max(cap * 2, 8)
            while newcap < need:
                newcap *= 2
            grown = torch.zeros((newcap, self._m), dtype=rows.dtype,
                                device=self._dev)
            if self._rcache is not None:
                grown[:cap] = self._rcache
            self._rcache = grown
        self._rcache[self._used:need] = rows
        for q in missing:
            self._slot[q] = self._used
            self._used += 1

    # -- lockstep driver ---------------------------------------------------
    def cluster_batch(self, cols_l: List[List[int]]):
        """Run every trial (each a zero-toggle of ``cols_l[t]`` on the
        base matrix) to completion in lockstep device rounds.  Returns
        ``(labels, n_clusters, used_thresholds)`` host arrays of shape
        (nt, m)/(nt,)/(nt,)."""
        nt = len(cols_l)
        m, dev = self._m, self._dev
        w = max(1, max((len(c) for c in cols_l), default=1))
        cols = np.full((nt, w), self._n, dtype=np.int64)
        for t, cl in enumerate(cols_l):
            cols[t, :len(cl)] = cl
        Wc, af = _prep(self._Wd, self._Ad, torch.as_tensor(cols, device=dev),
                       self._n)
        labels = torch.full((nt, m), -1, dtype=torch.int32, device=dev)
        ncl = torch.zeros((nt,), dtype=torch.int32, device=dev)
        used_thr = torch.full((nt,), -1.0, dtype=torch.float32, device=dev)
        # All labels start unassigned, so round 1's seeds are known
        # without a device round-trip: point 0, every trial active.
        p_h = np.zeros(nt, dtype=np.int64)
        act_h = np.ones(nt, dtype=bool)
        p = torch.zeros(nt, dtype=torch.int64, device=dev)
        active = torch.ones(nt, dtype=torch.bool, device=dev)
        while True:
            self._ensure_rows(
                sorted({int(q) for q, a in zip(p_h, act_h) if a}))
            sidx = np.zeros(nt, dtype=np.int64)
            for t in np.nonzero(act_h)[0]:
                sidx[t] = self._slot[int(p_h[t])]
            p, active = _round(
                Wc, af, self._sqd, self._rcache,
                torch.as_tensor(sidx, device=dev), p, active, labels, ncl,
                used_thr, frac=self._frac, fixed=self._fixed, ct=self._ct)
            p_h = p.cpu().numpy()
            act_h = active.cpu().numpy()
            if not act_h.any():
                break
        # Labels stay int32 — every consumer (same_partition, bincount,
        # members) is dtype-agnostic.
        return (labels.cpu().numpy(), ncl.cpu().numpy(),
                used_thr.cpu().numpy())
