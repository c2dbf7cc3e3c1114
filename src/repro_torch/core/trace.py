"""RegionTrace: the persistent data layer between collection and analysis
(paper §4 Fig. 4–6; arXiv:0906.1326 makes the same separation).

The paper's pipeline is *decoupled*: lightweight collection produces a
small, portable artifact; behaviour analysis, bottleneck location and
root-cause uncovering run on it later — possibly on a different machine.
A :class:`RegionTrace` is that artifact's in-memory form: per
(step, repeat, process/shard, region) metric samples plus a region-tree
schema header, so a saved trace is self-describing (the analysis side
rebuilds the :class:`RegionTree` from the header alone).

Layout: ``data[metric]`` is an (S, R, m, n) float64 array — S steps,
R timing repeats, m processes/shards, n regions in ``region_ids`` order.
Collectors record raw samples; :meth:`RegionTrace.reduce` applies the
deterministic reduction the collectors used to fuse inline:

* min over repeats (the classic noise-robust timing statistic);
* the runtime collector's CPU-clock-tick snap, driven by the
  ``cpu_tick`` recorded in the trace header (portable: the reduction
  reproduces the collecting host's decision bit-for-bit);
* sum over steps for quantities (times, flops, bytes), mean over steps
  for rates (vmem_pressure, hbm_intensity);
* the derived-metric fill (hbm_intensity = bytes/flops) iff the
  collector declared it via ``meta["derived"]``.

Artifact format (versioned): a single ``.npz`` file holding a JSON
header under ``__header__`` (version, shape, region schema, meta) and
one array per metric under ``metric:<name>``.  float64 round-trips
bit-exactly, so save -> load -> reduce() equals the direct in-memory
path.  The artifact is the reference package's format, byte for byte (the
``format`` tag stays ``repro.region_trace``): a trace saved by either
package loads in the other (tests/test_torch_trace_roughset.py).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .metrics import (BYTES, COMM_BYTES, CPU_TIME, HBM_INTENSITY,
                      VMEM_PRESSURE, WALL_TIME, RegionMetrics)
from .regions import CodeRegion, RegionTree

TRACE_FORMAT_VERSION = 1


class TraceFormatError(ValueError):
    """Structured load failure for a RegionTrace artifact.

    Carries ``path`` (the artifact), ``member`` (the zip member that broke,
    or None for container/header-level damage) and ``reason`` — so spool
    recovery can quarantine with a recorded cause and
    ``python -m repro_torch.cli.analyze_trace`` can map corruption to a distinct exit
    code instead of leaking raw ``zipfile``/JSON tracebacks.  Subclasses
    ``ValueError`` so existing not-an-artifact handlers keep working.
    """

    def __init__(self, path: str, reason: str,
                 member: Optional[str] = None):
        self.path = path
        self.member = member
        self.reason = reason
        where = f"{path}[{member}]" if member else path
        super().__init__(f"{where}: {reason}")

# Metrics that are rates (averaged over steps); everything else is a
# quantity (summed over steps).
RATE_METRICS = frozenset({VMEM_PRESSURE, HBM_INTENSITY})

# Timing metrics reduced by min-of-repeats.  Non-timing samples are
# constant across repeats by construction; min is an exact, deterministic
# choice for them too, so one rule covers every metric.


def schema_from_tree(tree: RegionTree) -> List[Dict[str, Any]]:
    """Pre-order region list (parents before children) capturing ids,
    paths and management flags — enough to rebuild the tree offline."""
    out = []
    for node in tree.root.walk():
        out.append({
            "id": node.region_id,
            "name": node.name,
            "parent": node.parent.region_id if node.parent else None,
            "management": node.management,
        })
    return out


def tree_from_schema(schema: Sequence[Dict[str, Any]]) -> RegionTree:
    """Rebuild a :class:`RegionTree` from a trace header.

    Region callables are not serialized (a trace is data, not code); the
    rebuilt tree carries structure, ids, paths and management flags —
    everything the analysis side reads."""
    if not schema or schema[0]["parent"] is not None:
        raise ValueError("schema must start with the root region")
    root = schema[0]
    tree = RegionTree(root["name"])
    tree.root.region_id = root["id"]
    tree.root.management = bool(root.get("management", False))
    tree._by_id = {root["id"]: tree.root}
    for e in schema[1:]:
        parent = tree._by_id[e["parent"]]
        node = CodeRegion(e["name"], e["id"], parent=parent,
                          management=bool(e.get("management", False)))
        parent.children.append(node)
        tree._by_id[node.region_id] = node
        if node.path in tree._by_path:
            raise ValueError(f"duplicate region path {node.path!r}")
        tree._by_path[node.path] = node
    return tree


@dataclasses.dataclass
class RegionTrace:
    """Per-(step, repeat, process, region) measurement record."""

    region_ids: List[int]
    n_processes: int
    n_steps: int = 1
    n_repeats: int = 1
    schema: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    data: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        shape = (self.n_steps, self.n_repeats, self.n_processes,
                 len(self.region_ids))
        for k, v in list(self.data.items()):
            v = np.asarray(v, dtype=np.float64)
            if v.shape != shape:
                raise ValueError(f"{k}: shape {v.shape} != {shape}")
            self.data[k] = v
        self._col = {rid: j for j, rid in enumerate(self.region_ids)}

    # -- construction helpers ---------------------------------------------
    @classmethod
    def for_tree(cls, tree: RegionTree, region_ids: Sequence[int],
                 n_processes: int, n_steps: int = 1, n_repeats: int = 1,
                 metrics: Sequence[str] = (),
                 meta: Optional[Dict[str, Any]] = None) -> "RegionTrace":
        tr = cls(region_ids=list(region_ids), n_processes=n_processes,
                 n_steps=n_steps, n_repeats=n_repeats,
                 schema=schema_from_tree(tree), meta=dict(meta or {}))
        for m in metrics:
            tr.metric(m)
        return tr

    def metric(self, name: str) -> np.ndarray:
        if name not in self.data:
            self.data[name] = np.zeros(
                (self.n_steps, self.n_repeats, self.n_processes,
                 len(self.region_ids)))
        return self.data[name]

    def col(self, region_id: int) -> int:
        return self._col[region_id]

    def record(self, name: str, step: int, repeat: int, proc: int,
               region_id: int, value: float) -> None:
        self.metric(name)[step, repeat, proc, self._col[region_id]] = value

    def tree(self) -> RegionTree:
        return tree_from_schema(self.schema)

    # -- views -------------------------------------------------------------
    def step_views(self) -> Iterator[RegionMetrics]:
        """One :class:`RegionMetrics` *view* per (step, repeat) slice —
        the arrays alias the trace, so mutating a view (e.g. fault
        injection) writes through to the trace samples.  Only metrics
        already present in the trace alias it: a write to a metric the
        trace never recorded lands in a view-local array and is lost —
        pre-create such metrics with :meth:`metric` first (the injection
        seam, :func:`repro_torch.scenarios.faults.inject_trace`, does)."""
        for s in range(self.n_steps):
            for r in range(self.n_repeats):
                yield RegionMetrics(
                    region_ids=list(self.region_ids),
                    n_processes=self.n_processes,
                    data={k: v[s, r] for k, v in self.data.items()})

    def window(self, start: int, stop: Optional[int] = None) -> "RegionTrace":
        """A new trace over steps [start, stop) — windowed analysis of a
        long run.  Copies, so windows are independent artifacts."""
        stop = self.n_steps if stop is None else stop
        if not (0 <= start < stop <= self.n_steps):
            raise ValueError(f"bad window [{start}, {stop}) for "
                             f"{self.n_steps} steps")
        return RegionTrace(
            region_ids=list(self.region_ids), n_processes=self.n_processes,
            n_steps=stop - start, n_repeats=self.n_repeats,
            schema=list(self.schema),
            data={k: v[start:stop].copy() for k, v in self.data.items()},
            meta=dict(self.meta))

    # Header meta keys that drive the reduction: traces disagreeing on
    # one of these cannot be concatenated (the merged reduce() would be
    # ambiguous).  Single source of truth for merge AND for the streaming
    # spool's appends (the reference's stream.TraceSpool).
    REDUCTION_META_KEYS = ("cpu_tick", "derived")

    @staticmethod
    def check_mergeable(head: "RegionTrace", t: "RegionTrace") -> None:
        """Raise ValueError when ``t`` cannot be concatenated after
        ``head`` along the step axis."""
        if (t.region_ids != head.region_ids
                or t.n_processes != head.n_processes
                or t.n_repeats != head.n_repeats):
            raise ValueError("traces disagree on regions/processes/"
                             "repeats; cannot merge")
        if t.schema != head.schema:
            raise ValueError("traces disagree on region schema")
        for key in RegionTrace.REDUCTION_META_KEYS:
            if t.meta.get(key) != head.meta.get(key):
                raise ValueError(
                    f"traces disagree on meta[{key!r}] "
                    f"({head.meta.get(key)} vs {t.meta.get(key)}); "
                    f"the merged reduction would be ambiguous")

    @classmethod
    def merge(cls, traces: Sequence["RegionTrace"]) -> "RegionTrace":
        """Concatenate traces along the step axis (e.g. one per training
        step, or per-window artifacts reassembled into a whole run)."""
        if not traces:
            raise ValueError("merge of zero traces")
        head = traces[0]
        for t in traces[1:]:
            cls.check_mergeable(head, t)
        names = sorted({k for t in traces for k in t.data})
        data = {k: np.concatenate([t.metric(k) for t in traces], axis=0)
                for k in names}
        return cls(region_ids=list(head.region_ids),
                   n_processes=head.n_processes,
                   n_steps=sum(t.n_steps for t in traces),
                   n_repeats=head.n_repeats, schema=list(head.schema),
                   data=data, meta=dict(head.meta))

    # -- reduction ---------------------------------------------------------
    def reduce(self, window: Optional[Tuple[int, Optional[int]]] = None
               ) -> RegionMetrics:
        """Deterministic reduction to the analyzer's (m, n) form.

        Exactly reproduces what the collectors used to compute inline:
        min over repeats, the runtime CPU-tick snap (when the header
        carries ``cpu_tick``), sum/mean over steps, then the derived
        fill iff ``meta["derived"]``.  Restricting to a step ``window``
        analyzes that slice of a long run."""
        start, stop = (0, self.n_steps) if window is None else \
            (window[0], self.n_steps if window[1] is None else window[1])
        if not (0 <= start < stop <= self.n_steps):
            raise ValueError(f"bad window [{start}, {stop}) for "
                             f"{self.n_steps} steps")
        sl = slice(start, stop)
        reduced = {name: arr[sl].min(axis=1)   # (S', m, n): min over repeats
                   for name, arr in self.data.items()}
        tick = self.meta.get("cpu_tick")
        if tick is not None and CPU_TIME in reduced and WALL_TIME in reduced:
            # The runtime collector's quantization guard, replayed from
            # the header (see TimedRegionRunner): only compute regions
            # (no collective traffic) snap to wall.  Applied per step,
            # before the step sum: each step's CPU reading is jiffy-phase
            # noisy by up to one tick, so a summed |cpu - wall| gap grows
            # O(S * tick) and would escape a single-tick threshold.
            wall, cpu = reduced[WALL_TIME], reduced[CPU_TIME]
            comm = reduced.get(COMM_BYTES, np.zeros_like(wall))
            snap = (comm == 0) & ((wall < tick) | (np.abs(cpu - wall) < tick))
            reduced[CPU_TIME] = np.where(snap, wall, cpu)
        out = {name: (red.mean(axis=0) if name in RATE_METRICS
                      else red.sum(axis=0))
               for name, red in reduced.items()}
        rm = RegionMetrics(region_ids=list(self.region_ids),
                           n_processes=self.n_processes, data=out)
        if self.meta.get("derived"):
            rm.derived()
        return rm

    # -- artifact I/O ------------------------------------------------------
    def save(self, path: str) -> str:
        """Write the compact artifact: JSON header + one array per metric
        inside a single ``.npz``.

        Canonical and deterministic: members are written in sorted metric
        order (not dict insertion order) and ``np.savez_compressed`` pins
        zip timestamps — so any two traces holding the same samples and
        header produce the same bytes, which is what lets a streamed
        spool finalize byte-identically to the monolithic save of the
        same run, and what keeps artifacts byte-equal across the JAX and
        PyTorch packages."""
        header = {
            "format": "repro.region_trace",
            "version": TRACE_FORMAT_VERSION,
            "region_ids": list(self.region_ids),
            "n_processes": self.n_processes,
            "n_steps": self.n_steps,
            "n_repeats": self.n_repeats,
            "schema": self.schema,
            "meta": self.meta,
            "metrics": sorted(self.data),
        }
        payload = {f"metric:{k}": self.data[k] for k in sorted(self.data)}
        with open(path, "wb") as f:
            np.savez_compressed(f, __header__=json.dumps(header),
                                **payload)
        return path

    @classmethod
    def load(cls, path: str) -> "RegionTrace":
        """Load an artifact, raising :class:`TraceFormatError` (with path /
        member / reason) on truncation, corruption, or a malformed header —
        never a raw ``zipfile``/``zlib``/JSON exception.  A missing file
        still raises ``FileNotFoundError`` (absent and damaged are
        different failures: recovery quarantines one, not the other)."""
        import zipfile
        try:
            z = np.load(path, allow_pickle=False)
        except FileNotFoundError:
            raise
        except (zipfile.BadZipFile, OSError, ValueError) as e:
            raise TraceFormatError(
                path, f"not a readable .npz container: {e}") from e
        with z:
            if "__header__" not in z:
                raise TraceFormatError(
                    path, "no __header__ member — not a RegionTrace "
                    "artifact")
            try:
                header = json.loads(str(z["__header__"]))
            except Exception as e:
                raise TraceFormatError(
                    path, f"unreadable header: {e}",
                    member="__header__") from e
            if not isinstance(header, dict):
                raise TraceFormatError(
                    path, "header is not a JSON object",
                    member="__header__")
            if header.get("format") != "repro.region_trace":
                raise ValueError(f"{path}: not a RegionTrace artifact")
            try:
                version = header["version"]
                metrics = header["metrics"]
            except KeyError as e:
                raise TraceFormatError(
                    path, f"header missing required key {e}",
                    member="__header__") from e
            if version > TRACE_FORMAT_VERSION:
                raise ValueError(
                    f"{path}: format version {version} is newer "
                    f"than supported {TRACE_FORMAT_VERSION}")
            data = {}
            for k in metrics:
                member = f"metric:{k}"
                if member not in z:
                    raise TraceFormatError(
                        path, "metric member listed in header but absent",
                        member=member)
                try:
                    data[k] = z[member]
                except Exception as e:
                    raise TraceFormatError(
                        path, f"corrupt metric member: {e}",
                        member=member) from e
        try:
            return cls(region_ids=list(header["region_ids"]),
                       n_processes=header["n_processes"],
                       n_steps=header["n_steps"],
                       n_repeats=header["n_repeats"],
                       schema=header["schema"], data=data,
                       meta=header.get("meta", {}))
        except (KeyError, TypeError, ValueError) as e:
            # includes shape validation: header geometry vs actual arrays
            raise TraceFormatError(
                path, f"malformed header: {e!r}", member="__header__") from e
