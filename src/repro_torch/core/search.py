"""Bottleneck searching algorithms (paper §4.3).

* :func:`find_dissimilarity_bottlenecks` — Algorithm 2: top-down zeroing
  search over the code-region tree against the simplified-OPTICS clustering.
  Every step of the search toggles exactly one column (or one group of
  adjacent columns) of the (m, n) measurement matrix, so the default path
  runs on a memory-bounded :class:`IncrementalClusterState`: base D² seed
  rows are computed lazily (never the m×m matrix) and each toggle is an
  O(m)-per-row delta instead of an O(m²·n) from-scratch reclustering.
  Independent trials — the depth-1 zeroing sweep, each sibling group of
  ``analyze_children``, each composite-window round — evaluate as one
  lockstep batch, and trial partitions are memoized by toggle-set
  signature so identical toggles never re-cluster (the reference's
  docs/performance.md has the math).
* :func:`find_disparity_bottlenecks` — k-means severity bands over CRNM,
  then the leaf-or-dominant refinement to CCCRs.

The PyTorch port of ``repro/core/search.py``; unchanged apart from the
distance backends it hands down (see :mod:`repro_torch.core.clustering`).
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, FrozenSet, List, Optional,
                    Sequence)

import numpy as np

from .clustering import (HIGH, SEVERITY_NAMES, SEVERITY_SPAN_DECADES,
                         ClusterResult, DistanceBackendSpec,
                         IncrementalClusterState, _expand_column_values,
                         dissimilarity_severity, kmeans_severity,
                         optics_cluster, severity_scale)
from .regions import CodeRegion, RegionTree


@dataclasses.dataclass
class DissimilarityReport:
    exists: bool
    baseline: ClusterResult
    ccrs: List[int]
    cccrs: List[int]
    severity: float
    composite_s: int = 1  # >1 when composite regions were needed


@dataclasses.dataclass
class DisparityReport:
    severities: Dict[int, int]          # region_id -> 0..4
    ccrs: List[int]
    cccrs: List[int]
    values: Dict[int, float]            # region_id -> metric value (CRNM)


ClusterFn = Callable[[np.ndarray], ClusterResult]


class _ScratchToggleState:
    """The generic-path twin of :class:`IncrementalClusterState`: the same
    push/pop/cluster interface over an explicit work matrix and an opaque
    ``cluster_fn``, re-clustering from scratch per trial.  Lets one
    Algorithm 2 driver serve both paths."""

    def __init__(self, work: np.ndarray, cluster_fn: ClusterFn):
        self._W = work
        self._fn = cluster_fn
        self._stack: List[tuple] = []

    def push(self, cols, values) -> None:
        cols = [int(c) for c in cols]
        self._stack.append((cols, self._W[:, cols].copy()))
        self._W[:, cols] = _expand_column_values(values, self._W.shape[0],
                                                 len(cols))

    def pop(self) -> None:
        cols, old = self._stack.pop()
        self._W[:, cols] = old

    def cluster(self) -> ClusterResult:
        return self._fn(self._W)

    def cluster_batch(self, toggles) -> List[ClusterResult]:
        """Generic-path trials: an opaque cluster_fn cannot batch, so this
        is the sequential push/cluster/pop loop behind the same API."""
        out = []
        for cols, values in toggles:
            self.push(cols, values)
            out.append(self.cluster())
            self.pop()
        return out


class _TrialEvaluator:
    """Algorithm 2's trial driver over a toggle state.

    Every matrix Algorithm 2 ever clusters is the original T with some
    set of columns zeroed (pushes either zero columns or restore them to
    their original T values), so that set is a complete signature of the
    trial matrix.  The evaluator tracks it across push/pop, memoizes
    partitions by it — identical toggle sets never re-cluster, within a
    batch or across the search — and routes independent single-push
    trials through the state's batched path."""

    def __init__(self, state, T: np.ndarray,
                 initially_zeroed: Sequence[int]):
        self._state = state
        self._T = T
        self._zeroed = set(int(c) for c in initially_zeroed)
        self._saved: List[set] = []
        self._memo: Dict[FrozenSet[int], ClusterResult] = {}

    def cluster(self) -> ClusterResult:
        sig = frozenset(self._zeroed)
        if sig not in self._memo:
            self._memo[sig] = self._state.cluster()
        return self._memo[sig]

    def trials(self, col_groups: Sequence[Sequence[int]],
               zero: bool) -> List[ClusterResult]:
        """Evaluate one independent trial per column group: zero the
        group (``zero=True``) or restore it to its original T values, on
        top of the current stack.  Memo hits (and in-batch duplicates)
        are served without clustering; the rest run as one batch."""
        sigs = [frozenset(self._zeroed | set(map(int, g))) if zero
                else frozenset(self._zeroed - set(map(int, g)))
                for g in col_groups]
        todo: List[int] = []
        queued: set = set()
        for i, sig in enumerate(sigs):
            if sig not in self._memo and sig not in queued:
                todo.append(i)
                queued.add(sig)
        if todo:
            toggles = [(list(col_groups[i]),
                        0.0 if zero else self._T[:, list(col_groups[i])])
                       for i in todo]
            for i, res in zip(todo, self._state.cluster_batch(toggles)):
                self._memo[sigs[i]] = res
        return [self._memo[sig] for sig in sigs]

    def push_zero(self, cols: Sequence[int]) -> None:
        cols = [int(c) for c in cols]
        self._saved.append(set(self._zeroed))
        self._state.push(cols, 0.0)
        self._zeroed.update(cols)

    def push_restore(self, cols: Sequence[int]) -> None:
        cols = [int(c) for c in cols]
        self._saved.append(set(self._zeroed))
        self._state.push(cols, self._T[:, cols])
        self._zeroed.difference_update(cols)

    def pop(self) -> None:
        self._state.pop()
        self._zeroed = self._saved.pop()


def find_dissimilarity_bottlenecks(
    tree: RegionTree,
    T: np.ndarray,
    region_ids: Sequence[int],
    cluster_fn: Optional[ClusterFn] = None,
    max_composite: Optional[int] = None,
    threshold: Optional[float] = None,
    threshold_frac: float = 0.10,
    count_threshold: int = 1,
    backend: DistanceBackendSpec = "numpy",
) -> DissimilarityReport:
    """Algorithm 2 of the paper.

    ``T`` is the (m, n) per-process measurement matrix (CPU clock time by
    default), columns ordered as ``region_ids``.  Management regions must
    already be excluded by the caller.

    With the default ``cluster_fn=None`` the simplified-OPTICS parameters
    (``threshold``/``threshold_frac``/``count_threshold``) drive the
    memory-bounded incremental fast path, with distances computed by
    ``backend`` (:func:`repro_torch.core.clustering.get_distance_backend`).
    Passing an explicit ``cluster_fn`` keeps the generic contract — any
    callable mapping a matrix to a :class:`ClusterResult` — at the cost
    of a from-scratch clustering per trial.
    """
    T = np.asarray(T, dtype=np.float64)
    col = {rid: j for j, rid in enumerate(region_ids)}
    regions = {r.region_id: r for r in tree.regions()
               if r.region_id in col}

    def depth1() -> List[CodeRegion]:
        return [r for r in regions.values() if r.depth == 1]

    # Lines 3-9: zero depth>1 columns, baseline clustering.
    zeroed0 = [col[rid] for rid, r in regions.items() if r.depth > 1]
    if cluster_fn is None and not zeroed0:
        # Fast path, flat tree: nothing to zero and the incremental state
        # never mutates its input (copy-on-push), so skip the (m, n) copy.
        work = T
    else:
        work = T.copy()
        work[:, zeroed0] = 0.0

    if cluster_fn is not None:
        state = _ScratchToggleState(work, cluster_fn)
    else:
        state = IncrementalClusterState(work, threshold=threshold,
                                        threshold_frac=threshold_frac,
                                        count_threshold=count_threshold,
                                        backend=backend)
    ev = _TrialEvaluator(state, T, zeroed0)
    baseline = ev.cluster()
    if baseline.n_clusters == 1:
        return DissimilarityReport(False, baseline, [], [], 0.0)
    # Only reported on the bottleneck path, so only computed here.
    severity = dissimilarity_severity(baseline, work)

    ccrs: List[int] = []
    cccrs: List[int] = []

    def analyze_children(parent: CodeRegion) -> bool:
        """Restore each child alone (one batched sibling-group round); if
        the clustering equals the baseline (the dissimilarity is
        reproduced), the child is a CCR.  Returns True if any child is a
        CCR."""
        kids = [c for c in parent.children if c.region_id in col]
        if not kids:
            return False
        results = ev.trials([[col[c.region_id]] for c in kids], zero=False)
        any_child = False
        for child, res in zip(kids, results):
            if res.same_partition(baseline):
                ccrs.append(child.region_id)
                any_child = True
                ev.push_restore([col[child.region_id]])
                deeper = analyze_children(child)
                ev.pop()
                if child.is_leaf or not deeper:
                    cccrs.append(child.region_id)
        return any_child

    # Lines 10-30: zero each depth-1 region — one batched sweep; a change
    # in the clustering result marks it as a CCR.
    d1 = depth1()
    d1_results = ev.trials([[col[r.region_id]] for r in d1], zero=True)
    for r, res in zip(d1, d1_results):
        if not res.same_partition(baseline):
            ccrs.append(r.region_id)
            ev.push_zero([col[r.region_id]])
            had_child_ccr = analyze_children(r)
            ev.pop()
            if r.is_leaf or not had_child_ccr:
                cccrs.append(r.region_id)

    s = 1
    if not ccrs:
        # Lines 31-37: combine s adjacent 1-code regions into composite
        # regions and repeat, one batched round per window width.
        rmax = max_composite if max_composite is not None else len(d1) - 1
        s = 2
        while not ccrs and s <= max(rmax, 2) and s <= len(d1):
            windows = [d1[start:start + s]
                       for start in range(0, len(d1) - s + 1)]
            wres = ev.trials([[col[g.region_id] for g in w]
                              for w in windows], zero=True)
            for w, res in zip(windows, wres):
                if not res.same_partition(baseline):
                    ccrs.extend(g.region_id for g in w)
                    cccrs.extend(g.region_id for g in w)
            s += 1
        s -= 1

    return DissimilarityReport(True, baseline, sorted(set(ccrs)),
                               sorted(set(cccrs)), severity, s)


def time_share_weighting(tree: RegionTree, wall: np.ndarray,
                         region_ids: Sequence[int]
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Exclusive-time-share discount for the severity banding.

    Region timing is *inclusive*: a parent's wall time (and hence any
    time-flavoured metric) contains its children's, so a large enclosing
    region always sits near the top of the per-region value range even
    when every anomaly lives in a child.  This helper computes, per
    region, the share of its own wall time not accounted for by measured
    children:

        ratio_j = max(wall_j - sum(wall_children present), 0) / wall_j

    (1.0 for leaves and for regions without measured children).  Returns
    ``(ratios, weights)`` where ``weights`` are the exclusive wall times
    normalized to sum 1 (each region's share of the run's self time).
    Banding ``values * ratios`` flags a parent only for work it does
    *itself*; anomalies in children are flagged on the children, where
    the search can actually localize them.
    """
    wall = np.asarray(wall, dtype=np.float64)
    idx = {rid: j for j, rid in enumerate(region_ids)}
    excl = wall.copy()
    for rid, j in idx.items():
        try:
            region = tree[rid]
        except KeyError:
            continue
        child_wall = sum(wall[idx[c.region_id]] for c in region.children
                         if c.region_id in idx)
        excl[j] = max(wall[j] - child_wall, 0.0)
    ratios = np.where(wall > 0, excl / np.maximum(wall, 1e-30), 1.0)
    total = excl.sum()
    weights = (excl / total if total > 0
               else np.full(len(wall), 1.0 / max(len(wall), 1)))
    return ratios, weights


def time_share_severity(tree: RegionTree, values: np.ndarray,
                        region_ids: Sequence[int], wall: np.ndarray,
                        k: int = 5,
                        floor_decades: float = SEVERITY_SPAN_DECADES,
                        backend: DistanceBackendSpec = "numpy"
                        ) -> np.ndarray:
    """Time-share-weighted severity banding (ROADMAP carry-over study).

    Three corrections over banding raw inclusive values:

    1. **Range floor** — the banding range is floored at
       ``floor_decades`` so a mildly spread profile produces no high
       bands (see :data:`SEVERITY_SPAN_DECADES`).
    2. **Exclusive-share discount** — a region containing measured
       children is re-banded at the position of ``value * ratio`` (its
       metric scaled to the share of wall time it owns exclusively) on
       the *same* scale the raw values were banded with, so an enclosing
       region is banded only on work it does itself.
    3. **Child-max inheritance** — severity then propagates back up:
       a parent is at least as severe as its hottest measured child
       (timing is inclusive, so a disparity in the child *is* in the
       parent; the CCR->CCCR rule already prefers the child on ties,
       which keeps the paper's ST result: 11 and 14 both very-high,
       11 is the CCCR).

    Leaves band exactly as the legacy relative-position rule whenever
    the profile stretches past the floor — every §6 paper scenario is
    unchanged — while an inclusive parent over a clean or mildly
    stretched tree no longer produces a spurious bottleneck.
    """
    values = np.asarray(values, dtype=np.float64)
    sev = kmeans_severity(values, k=k, floor_decades=floor_decades,
                          backend=backend)
    ratios, _ = time_share_weighting(tree, wall, region_ids)
    inner = np.nonzero(ratios < 1.0)[0]
    top = values.max() if values.size else 0.0
    if inner.size and top > 0:
        lo, rng = severity_scale(values, k=k, floor_decades=floor_decades)
        for j in inner:
            u = np.log10(max(values[j] * ratios[j], top * 1e-4))
            s = int(np.clip(np.round((k - 1) * (u - lo) / rng), 0, k - 1))
            sev[j] = min(int(sev[j]), s)
    # inheritance, deepest regions first so chains propagate to the root
    idx = {rid: j for j, rid in enumerate(region_ids)}

    def depth(rid):
        d, node = 0, tree[rid]
        while node.parent is not None:
            d, node = d + 1, node.parent
        return d

    known = [rid for rid in region_ids if rid in {r.region_id
                                                  for r in tree.regions()}]
    for rid in sorted(known, key=depth, reverse=True):
        parent = tree[rid].parent
        if parent is not None and parent.region_id in idx:
            pj = idx[parent.region_id]
            sev[pj] = max(int(sev[pj]), int(sev[idx[rid]]))
    return sev


def find_disparity_bottlenecks(
    tree: RegionTree,
    values: np.ndarray,
    region_ids: Sequence[int],
    k: int = 5,
    wall: Optional[np.ndarray] = None,
    backend: DistanceBackendSpec = "numpy",
) -> DisparityReport:
    """Disparity search (paper §4.2.2 + §4.3).

    ``values`` are per-region scalars (average CRNM over processes).
    Severity >= HIGH marks a CCR; a CCR is a CCCR when it is a leaf or its
    severity exceeds that of every child CCR (the paper's ST case: equal
    child severity promotes the child, not the parent).

    With ``wall`` (per-region mean wall seconds, aligned with
    ``region_ids``) severities come from :func:`time_share_severity`:
    inclusive parents are banded on the share of time they own
    exclusively (then inherit their hottest child's band), and a mildly
    spread profile produces no bands at all.  Without ``wall`` the legacy
    relative banding is used unchanged.
    """
    values = np.asarray(values, dtype=np.float64)
    if wall is not None:
        sev = time_share_severity(tree, values, region_ids, wall, k=k,
                                  backend=backend)
    else:
        sev = kmeans_severity(values, k=k, backend=backend)
    sev_by_id = {rid: int(s) for rid, s in zip(region_ids, sev)}
    val_by_id = {rid: float(v) for rid, v in zip(region_ids, values)}
    regions = {r.region_id: r for r in tree.regions()
               if r.region_id in sev_by_id}
    ccrs = [rid for rid, s in sev_by_id.items() if s >= HIGH]
    ccr_set = set(ccrs)
    cccrs: List[int] = []
    for rid in ccrs:
        r = regions[rid]
        child_ccrs = [c for c in r.children if c.region_id in ccr_set]
        if r.is_leaf or not child_ccrs:
            cccrs.append(rid)
        else:
            # Non-leaf CCR is a CCCR only if its severity strictly exceeds
            # every child's.
            if all(sev_by_id[rid] > sev_by_id[c.region_id]
                   for c in child_ccrs):
                cccrs.append(rid)
    return DisparityReport(sev_by_id, sorted(ccrs), sorted(cccrs), val_by_id)


def severity_banding(report: DisparityReport) -> Dict[str, List[int]]:
    """Render the paper Fig. 12 style banding."""
    out: Dict[str, List[int]] = {name: [] for name in SEVERITY_NAMES[::-1]}
    for rid, s in sorted(report.severities.items(),
                         key=lambda kv: -report.values[kv[0]]):
        out[SEVERITY_NAMES[s]].append(rid)
    return out
