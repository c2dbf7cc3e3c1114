"""TraceSpool: bounded-memory streaming collection of long-run traces.

The port's copy of the reference's ``repro/stream/spool.py`` (numpy only).
It reads and writes the same bytes — manifest, segment files and their
sha256 records — so a spool written by either package tails in the other,
and the fault-point names are the reference's.

The paper's collection side is "lightweight in terms of the size of
performance data to be collected"; a producer (the serving engine with
``trace_spool_dir`` set) would otherwise hold every per-step
:class:`RegionTrace` in memory until one monolithic save.  The spool
closes that gap: a :class:`TraceSpool` writer flushes completed
step-chunks to disk as numbered *segment* files — each segment is itself a
versioned ``RegionTrace`` artifact (same header + ``metric:<name>`` arrays
as ``trace.py``, so ``python -m repro_torch.cli.analyze_trace`` runs on a
single segment unchanged) — and a :class:`SpooledTrace` reader lazily
iterates segments, reassembles step windows on demand, and can
:meth:`~SpooledTrace.finalize` into the classic single-``.npz``
artifact **bitwise identical** to the monolithic ``RegionTrace.save`` of
the same run.

Peak writer memory is O(chunk): a flushed chunk leaves the process.  The
reader is windowed: analyzing steps ``[a, b)`` loads only the segments that
overlap, and window reassembly is exact — segments concatenate back into
the very float64 rows the writer was handed, so
``SpooledTrace.window(a, b).reduce()`` equals
``whole_trace.reduce(window=(a, b))`` bit-for-bit.

On-disk layout (one directory per run)::

    spool-dir/
      segment-00000.npz     RegionTrace artifact over steps [0, c0)
      segment-00001.npz     ... steps [c0, c0+c1) ...
      spool.json            manifest: segment index, invariants, completion
      quarantine/           damaged files moved aside by recover()

Crash safety:

* Segments are written to a ``.tmp`` sibling and ``os.replace``-d into
  place, and the manifest records each segment's **byte length and
  sha256**, so any torn or silently corrupted write is detectable.
* The manifest itself is rewritten atomically (tmp + rename) after every
  flush, so a live tail (``python -m repro_torch.cli.watch_trace``) never
  reads a torn index and can see new windows while the run is still
  going.
* :meth:`TraceSpool.recover` salvages a spool whose producer died:
  every intact manifest-listed segment is kept, torn/corrupt/unindexed
  files are *quarantined* (moved into ``quarantine/``, never silently
  dropped), a fully-written-but-unindexed trailing segment is adopted,
  and the whole event is logged under the manifest's ``recovery`` key.
* :meth:`TraceSpool.compact` / :meth:`SpooledTrace.compact` prune
  already-analyzed history; ``window()`` stays exact on the retained
  range and refuses pruned ranges with :class:`SpoolGapError`.

``complete`` flips true only in :meth:`TraceSpool.close` (or on
recovery), which also records the producer's *final* header meta — the
reader applies it on reassembly, which is what makes ``finalize()``
byte-identical to the producer's own monolithic save.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.faultpoints import fault_point
from repro_torch.core.trace import RegionTrace, TraceFormatError

SPOOL_FORMAT_VERSION = 2
MANIFEST_NAME = "spool.json"
QUARANTINE_DIR = "quarantine"

_SEGMENT_RE = re.compile(r"^segment-(\d{5})\.npz$")


class SpoolGapError(ValueError):
    """A requested step range is not fully covered by on-disk segments —
    either pruned by compaction or lost to a quarantined segment.  Carries
    ``missing``: the uncovered ``(start, stop)`` subranges."""

    def __init__(self, directory: str, start: int, stop: int,
                 missing: List[Tuple[int, int]]):
        self.directory = directory
        self.start, self.stop = start, stop
        self.missing = list(missing)
        gaps = ", ".join(f"[{a}, {b})" for a, b in self.missing)
        super().__init__(
            f"{directory}: window [{start}, {stop}) not covered by intact "
            f"segments; missing {gaps or 'retained range'}")


class ProducerStalledError(RuntimeError):
    """The spool's producer is presumed dead: no manifest progress for
    longer than the configured stall bound."""

    def __init__(self, directory: str, elapsed: float, max_stall: float):
        self.directory = directory
        self.elapsed = elapsed
        self.max_stall = max_stall
        super().__init__(
            f"{directory}: producer presumed dead — no spool progress for "
            f"{elapsed:.1f}s (stall bound {max_stall:.1f}s)")


def _write_manifest(directory: str, doc: Dict[str, Any]) -> None:
    """Atomic rewrite: a concurrent reader sees the old or the new index,
    never a torn file."""
    tmp = os.path.join(directory, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")
    fault_point("spool.manifest.written")
    os.replace(tmp, os.path.join(directory, MANIFEST_NAME))
    fault_point("spool.manifest.renamed")


def _file_digest(path: str) -> Tuple[str, int]:
    """(sha256 hexdigest, byte length) of a file, streamed."""
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
            n += len(block)
    return h.hexdigest(), n


def verify_segment(directory: str, seg: Dict[str, Any]) -> Optional[str]:
    """Check one manifest segment record against its file.

    Returns None when intact, else a human-readable reason.  Records with
    integrity fields are checked by length + sha256; legacy records
    (format v1, no checksum) fall back to a full artifact load."""
    path = os.path.join(directory, seg["file"])
    if not os.path.exists(path):
        return "missing file"
    if "sha256" in seg:
        size = os.path.getsize(path)
        if size != seg["bytes"]:
            return f"length {size} != recorded {seg['bytes']}"
        digest, _ = _file_digest(path)
        if digest != seg["sha256"]:
            return "sha256 mismatch"
        return None
    try:  # legacy record: integrity by parse
        tr = RegionTrace.load(path)
    except TraceFormatError as e:
        return f"unreadable artifact: {e.reason}"
    if tr.n_steps != seg["n_steps"]:
        return f"{tr.n_steps} steps on disk != recorded {seg['n_steps']}"
    return None


class TraceSpool:
    """Append-only segment writer for one run's :class:`RegionTrace` stream.

    ``append`` buffers per-step traces; once ``chunk_steps`` steps have
    accumulated the buffer is merged into one segment, written to disk, and
    dropped from memory.  Every appended trace must agree with the first on
    regions / processes / repeats / schema / reduction meta —
    :meth:`RegionTrace.check_mergeable`, the same invariants ``merge``
    enforces, so segments are guaranteed to reassemble.

    ``meta`` is the *provisional* final header meta, carried by the
    manifest from the first flush so a live reader resolves run-level
    configuration (e.g. ``analyzer_kw`` for the online analyzer) before
    the run ends; :meth:`close` replaces it with the definitive final
    meta (or keeps it when ``close(meta=None)``).
    """

    def __init__(self, directory: str, chunk_steps: int = 8,
                 meta: Optional[Dict[str, Any]] = None):
        if chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        if os.path.exists(os.path.join(directory, MANIFEST_NAME)):
            raise ValueError(
                f"{directory}: already contains a spool manifest; "
                f"spools are append-only per run — use a fresh directory")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.chunk_steps = chunk_steps
        self._meta = dict(meta) if meta is not None else None
        self._pending: List[RegionTrace] = []
        self._pending_steps = 0
        self._segments: List[Dict[str, Any]] = []
        self._seg_counter = 0       # segment file numbering survives compaction
        self._n_steps = 0
        self._retained_start = 0
        self._compaction: List[Dict[str, Any]] = []
        self._head: Optional[RegionTrace] = None
        self._closed = False

    # -- writer state ------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def n_steps(self) -> int:
        """Steps appended so far (flushed + buffered)."""
        return self._n_steps + self._pending_steps

    @property
    def head_meta(self) -> Dict[str, Any]:
        """Meta of the first appended trace (the stream's base header)."""
        if self._head is None:
            raise ValueError("empty spool has no head")
        return dict(self._head.meta)

    def append(self, step_trace: RegionTrace) -> None:
        if self._closed:
            raise ValueError("spool is closed")
        if self._head is None:
            self._head = step_trace
        else:
            # fail at the offending append, not at a later flush/merge
            RegionTrace.check_mergeable(self._head, step_trace)
        self._pending.append(step_trace)
        self._pending_steps += step_trace.n_steps
        if self._pending_steps >= self.chunk_steps:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        seg = (self._pending[0] if len(self._pending) == 1
               else RegionTrace.merge(self._pending))
        fname = f"segment-{self._seg_counter:05d}.npz"
        self._seg_counter += 1
        final = os.path.join(self.directory, fname)
        tmp = final + ".tmp"
        fault_point("spool.segment.pre_write")
        seg.save(tmp)
        fault_point("spool.segment.written")
        digest, nbytes = _file_digest(tmp)
        os.replace(tmp, final)
        fault_point("spool.segment.renamed")
        self._segments.append(
            {"file": fname, "start": self._n_steps, "n_steps": seg.n_steps,
             "bytes": nbytes, "sha256": digest})
        self._n_steps += seg.n_steps
        self._pending = []
        self._pending_steps = 0
        self._write_manifest(complete=False, meta=self._meta)

    def _write_manifest(self, complete: bool,
                        meta: Optional[Dict[str, Any]]) -> None:
        h = self._head
        doc = {
            "format": "repro.trace_spool",
            "version": SPOOL_FORMAT_VERSION,
            "chunk_steps": self.chunk_steps,
            "region_ids": list(h.region_ids) if h else [],
            "n_processes": h.n_processes if h else 0,
            "n_repeats": h.n_repeats if h else 1,
            "schema": list(h.schema) if h else [],
            "base_meta": dict(h.meta) if h else {},
            "n_steps": self._n_steps,
            # First step still on disk: 0 until compaction prunes history.
            "retained_start": self._retained_start,
            "segments": self._segments,
            "compaction": self._compaction,
            "complete": complete,
            # Header meta the producer wants the reassembled artifact to
            # carry (provisional while live, definitive after close;
            # None = keep the stream's base meta).  Applied by
            # SpooledTrace.
            "meta": meta,
        }
        _write_manifest(self.directory, doc)

    def close(self, meta: Optional[Dict[str, Any]] = None) -> str:
        """Flush the tail chunk and mark the spool complete.

        ``meta`` is the definitive final header meta for the reassembled
        artifact (e.g. the serving engine's ``collector``/``cpu_tick``/
        ``requests_completed``); ``meta=None`` keeps the provisional meta
        from construction, or — when neither was given — the stream's
        base meta.  Returns the manifest path."""
        if self._closed:
            raise ValueError("spool already closed")
        self._flush()
        if meta is not None:
            self._meta = dict(meta)
        self._write_manifest(complete=True, meta=self._meta)
        self._closed = True
        return os.path.join(self.directory, MANIFEST_NAME)

    # -- retention ---------------------------------------------------------
    def compact(self, upto_step: int) -> List[str]:
        """Prune flushed history: drop every segment wholly below
        ``upto_step`` (already analyzed, e.g. past the online analyzer's
        window frontier) and delete its file.

        Whole segments only — a partially-covered segment is retained, so
        ``window()`` stays *exact* on the retained range.  The manifest is
        rewritten (new ``retained_start``, compaction log) **before** the
        files are unlinked, so a crash mid-compact leaves orphans for
        :meth:`recover` to quarantine rather than a manifest pointing at
        nothing.  Returns the pruned file names."""
        if self._closed:
            raise ValueError("spool is closed; compact via SpooledTrace")
        keep, drop = [], []
        for s in self._segments:
            (drop if s["start"] + s["n_steps"] <= upto_step else keep).append(s)
        if not drop:
            return []
        self._segments = keep
        self._retained_start = (keep[0]["start"] if keep else self._n_steps)
        self._compaction.append(
            {"upto_step": upto_step, "retained_start": self._retained_start,
             "files": [s["file"] for s in drop]})
        self._write_manifest(complete=False, meta=self._meta)
        for s in drop:
            try:
                os.remove(os.path.join(self.directory, s["file"]))
            except FileNotFoundError:
                pass
        return [s["file"] for s in drop]

    # -- crash recovery ----------------------------------------------------
    @classmethod
    def recover(cls, directory: str) -> Dict[str, Any]:
        """Salvage a spool after a producer crash (or mid-write kill).

        Keeps every manifest-listed segment that verifies (length +
        sha256; legacy records verify by parse), **quarantines** — moves
        into ``quarantine/``, never deletes — every torn ``.tmp``, every
        corrupt or missing-from-integrity segment, and every unindexed
        segment file that does not chain onto the flushed high-water mark.
        A fully-written trailing segment that the crash orphaned between
        rename and manifest update is *adopted* (checksummed and indexed).
        The resulting manifest is marked ``complete`` with the whole event
        logged under its ``recovery`` key, so nothing is silently dropped.

        Returns the recovery event dict (also appended to the manifest):
        ``{"quarantined": [{file, reason, ...}], "adopted": [...],
        "n_steps": int, "lost_ranges": [[a, b), ...]}``."""
        man_path = os.path.join(directory, MANIFEST_NAME)
        qdir = os.path.join(directory, QUARANTINE_DIR)
        quarantined: List[Dict[str, Any]] = []
        adopted: List[str] = []

        def _quarantine(fname: str, reason: str, **extra: Any) -> None:
            os.makedirs(qdir, exist_ok=True)
            src = os.path.join(directory, fname)
            if os.path.exists(src):
                os.replace(src, os.path.join(qdir, fname))
            quarantined.append({"file": fname, "reason": reason, **extra})

        doc: Optional[Dict[str, Any]] = None
        if os.path.exists(man_path):
            with open(man_path) as f:
                doc = json.load(f)
            if doc.get("format") != "repro.trace_spool":
                raise ValueError(f"{man_path}: not a trace-spool manifest")
            if doc["version"] > SPOOL_FORMAT_VERSION:
                raise ValueError(
                    f"{man_path}: spool version {doc['version']} is newer "
                    f"than supported {SPOOL_FORMAT_VERSION}")

        # 1. Torn in-progress writes: any *.tmp is by construction
        #    incomplete (writers always replace-rename), quarantine it.
        for fname in sorted(os.listdir(directory)):
            if fname.endswith(".tmp"):
                _quarantine(fname, "torn in-progress write")

        # 2. No manifest at all (killed before the first flush finished):
        #    rebuild the index from whatever intact segments exist.
        if doc is None:
            doc = cls._rebuild_manifest_skeleton(directory)

        # 3. Verify every indexed segment; quarantine what fails.
        listed_files = {s["file"] for s in doc.get("segments", [])}
        segments: List[Dict[str, Any]] = []
        for seg in doc.get("segments", []):
            reason = verify_segment(directory, seg)
            if reason is None:
                segments.append(dict(seg))
            else:
                _quarantine(seg["file"], reason, start=seg["start"],
                            n_steps=seg["n_steps"])

        # 4. Unindexed segment files: adopt the one the crash orphaned
        #    between rename and manifest rewrite (it must parse cleanly
        #    and chain onto the flushed high-water mark); quarantine the
        #    rest (e.g. leftovers of a crashed compaction).
        high_water = int(doc.get("n_steps", 0))
        next_idx = cls._next_unindexed_index(doc)
        for fname in sorted(os.listdir(directory)):
            m = _SEGMENT_RE.match(fname)
            if not m or fname in listed_files:
                continue
            if int(m.group(1)) == next_idx:
                path = os.path.join(directory, fname)
                try:
                    tr = RegionTrace.load(path)
                except (TraceFormatError, ValueError) as e:
                    _quarantine(fname, f"orphan segment unreadable: {e}")
                    continue
                digest, nbytes = _file_digest(path)
                segments.append({"file": fname, "start": high_water,
                                 "n_steps": tr.n_steps, "bytes": nbytes,
                                 "sha256": digest})
                adopted.append(fname)
                next_idx += 1
                high_water += tr.n_steps
            else:
                _quarantine(fname, "unindexed segment file (does not chain "
                                   "onto the flushed stream)")

        segments.sort(key=lambda s: s["start"])
        retained_start = int(doc.get("retained_start", 0))
        n_steps = max((s["start"] + s["n_steps"] for s in segments),
                      default=retained_start)
        lost: List[List[int]] = []
        cur = retained_start
        for s in segments:
            if s["start"] > cur:
                lost.append([cur, s["start"]])
            cur = s["start"] + s["n_steps"]
        if n_steps < int(doc.get("n_steps", 0)):
            lost.append([n_steps, int(doc["n_steps"])])

        event = {"quarantined": quarantined, "adopted": adopted,
                 "n_steps": n_steps, "lost_ranges": lost}
        doc["segments"] = segments
        doc["n_steps"] = n_steps
        doc["retained_start"] = retained_start
        doc["complete"] = True
        doc.setdefault("compaction", [])
        doc.setdefault("recovery", []).append(event)
        _write_manifest(directory, doc)
        return event

    @staticmethod
    def _rebuild_manifest_skeleton(directory: str) -> Dict[str, Any]:
        """Minimal manifest for a spool killed before its first manifest
        write: head fields are derived from the first parseable segment."""
        head: Optional[RegionTrace] = None
        for fname in sorted(os.listdir(directory)):
            if _SEGMENT_RE.match(fname):
                try:
                    head = RegionTrace.load(os.path.join(directory, fname))
                    break
                except (TraceFormatError, ValueError):
                    continue
        if head is None:
            raise ValueError(
                f"{directory}: no manifest and no intact segment — "
                f"nothing recoverable")
        return {
            "format": "repro.trace_spool",
            "version": SPOOL_FORMAT_VERSION,
            "chunk_steps": head.n_steps,
            "region_ids": list(head.region_ids),
            "n_processes": head.n_processes,
            "n_repeats": head.n_repeats,
            "schema": list(head.schema),
            "base_meta": dict(head.meta),
            "n_steps": 0,
            "retained_start": 0,
            "segments": [],
            "compaction": [],
            "complete": False,
            "meta": None,
        }

    @staticmethod
    def _next_unindexed_index(doc: Dict[str, Any]) -> int:
        pruned = sum(len(c.get("files", []))
                     for c in doc.get("compaction", []))
        idxs = [int(_SEGMENT_RE.match(s["file"]).group(1))
                for s in doc.get("segments", [])
                if _SEGMENT_RE.match(s["file"])]
        return max(idxs, default=pruned - 1) + 1


class SpooledTrace:
    """Lazy reader over a spool directory (live or finished run).

    Loads at most the segments a request touches; :meth:`reload` refreshes
    the manifest so a tail sees newly flushed segments.  ``to_trace`` /
    ``finalize`` reassemble the whole run — an O(n_steps) materialization
    by construction, meant for end-of-run conversion; bounded-memory
    consumers use :meth:`window` / :class:`repro_torch.stream.OnlineAnalyzer`.

    After recovery or compaction the step axis may have holes;
    :meth:`window` refuses a range it cannot reassemble exactly
    (:class:`SpoolGapError`) rather than returning misaligned rows.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self.reload()

    def reload(self) -> "SpooledTrace":
        path = os.path.join(self.directory, MANIFEST_NAME)
        try:
            with open(path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            raise ValueError(f"{self.directory}: no spool manifest "
                             f"({MANIFEST_NAME}) — not a spool, or nothing "
                             f"flushed yet")
        if doc.get("format") != "repro.trace_spool":
            raise ValueError(f"{path}: not a trace-spool manifest")
        if doc["version"] > SPOOL_FORMAT_VERSION:
            raise ValueError(f"{path}: spool version {doc['version']} is "
                             f"newer than supported {SPOOL_FORMAT_VERSION}")
        self._doc = doc
        return self

    # -- manifest views ----------------------------------------------------
    @property
    def n_steps(self) -> int:
        """Steps flushed to disk so far (== total once ``complete``)."""
        return self._doc["n_steps"]

    @property
    def complete(self) -> bool:
        return self._doc["complete"]

    @property
    def schema(self) -> List[Dict[str, Any]]:
        return self._doc["schema"]

    @property
    def meta(self) -> Dict[str, Any]:
        """Final meta when closed with one, else the stream's base meta."""
        return dict(self._doc["meta"] or self._doc["base_meta"])

    @property
    def n_segments(self) -> int:
        return len(self._doc["segments"])

    @property
    def segment_records(self) -> List[Dict[str, Any]]:
        """Manifest records of the indexed segments (file, start, n_steps,
        integrity fields) — what an ingest tier verifies against disk
        before trusting a window."""
        return [dict(s) for s in self._doc["segments"]]

    @property
    def retained_start(self) -> int:
        """First step still on disk (> 0 once compaction pruned history)."""
        return self._doc.get("retained_start", 0)

    @property
    def recovery(self) -> List[Dict[str, Any]]:
        """Recovery events logged by :meth:`TraceSpool.recover` (empty for
        a spool that never crashed)."""
        return list(self._doc.get("recovery", []))

    @property
    def compaction(self) -> List[Dict[str, Any]]:
        return list(self._doc.get("compaction", []))

    def manifest_mtime(self) -> float:
        """mtime of the manifest — the producer's heartbeat: it is
        rewritten after every flush and at close."""
        return os.path.getmtime(os.path.join(self.directory, MANIFEST_NAME))

    def manifest_age(self) -> float:
        """Seconds since the producer last touched the manifest."""
        return max(0.0, time.time() - self.manifest_mtime())

    def verify(self) -> List[Dict[str, Any]]:
        """Integrity-check every indexed segment (length + sha256; legacy
        records by parse).  Returns ``[{file, reason}, ...]`` for the
        segments that fail — empty means the spool is intact."""
        bad = []
        for seg in self._doc["segments"]:
            reason = verify_segment(self.directory, seg)
            if reason is not None:
                bad.append({"file": seg["file"], "reason": reason})
        return bad

    def segment(self, index: int) -> RegionTrace:
        seg = self._doc["segments"][index]
        return RegionTrace.load(os.path.join(self.directory, seg["file"]))

    def segments(self) -> Iterator[RegionTrace]:
        """Lazily yield segment traces in step order, one in memory at a
        time."""
        for i in range(self.n_segments):
            yield self.segment(i)

    # -- reassembly --------------------------------------------------------
    def _covering(self, start: int, stop: int) -> List[int]:
        out = []
        for i, seg in enumerate(self._doc["segments"]):
            s0, s1 = seg["start"], seg["start"] + seg["n_steps"]
            if s0 < stop and s1 > start:
                out.append(i)
        return out

    def missing_ranges(self, start: int, stop: int) -> List[Tuple[int, int]]:
        """Subranges of ``[start, stop)`` not covered by any indexed
        segment (pruned history, or holes left by recovery)."""
        out: List[Tuple[int, int]] = []
        cur = start
        for seg in self._doc["segments"]:
            s0, s1 = seg["start"], seg["start"] + seg["n_steps"]
            if s1 <= cur or s0 >= stop:
                continue
            if s0 > cur:
                out.append((cur, s0))
            cur = s1
            if cur >= stop:
                break
        if cur < stop:
            out.append((cur, stop))
        return out

    def window(self, start: int, stop: Optional[int] = None) -> RegionTrace:
        """Reassemble steps ``[start, stop)`` from the overlapping segments
        — exact: the merged rows are the very float64 samples the writer
        flushed, so reducing this window is bit-identical to reducing the
        same window of the monolithic trace.  Raises
        :class:`SpoolGapError` when part of the range was pruned or lost."""
        stop = self.n_steps if stop is None else stop
        if not (0 <= start < stop <= self.n_steps):
            raise ValueError(f"bad window [{start}, {stop}) for "
                             f"{self.n_steps} flushed steps")
        missing = self.missing_ranges(start, stop)
        if missing:
            raise SpoolGapError(self.directory, start, stop, missing)
        idxs = self._covering(start, stop)
        traces = [self.segment(i) for i in idxs]
        merged = traces[0] if len(traces) == 1 else RegionTrace.merge(traces)
        base = self._doc["segments"][idxs[0]]["start"]
        return merged.window(start - base, stop - base)

    def to_trace(self) -> RegionTrace:
        """Reassemble the whole retained run, applying the producer's final
        meta.

        O(n_steps) memory — an explicit materialization for conversion and
        whole-run analysis, not the streaming path.  Raises
        :class:`SpoolGapError` if recovery left holes in the retained
        range."""
        if not self._doc["segments"]:
            raise ValueError(f"{self.directory}: empty spool")
        missing = self.missing_ranges(self.retained_start, self.n_steps)
        if missing:
            raise SpoolGapError(self.directory, self.retained_start,
                                self.n_steps, missing)
        traces = list(self.segments())
        merged = traces[0] if len(traces) == 1 else RegionTrace.merge(traces)
        if self._doc["meta"] is not None:
            merged.meta = dict(self._doc["meta"])
        return merged

    def finalize(self, path: str) -> str:
        """Convert to the classic single-``.npz`` artifact.

        Byte-identical to ``RegionTrace.save`` of the producer's own merged
        trace: merge is value-exact concatenation, float64 round-trips
        bit-exactly through segment files, the final meta is replayed from
        the manifest in producer key order, and ``np.savez_compressed``
        writes deterministically (fixed zip timestamps) — pinned by
        tests/test_torch_stream.py for the synthetic and serving producers.

        Only a complete, never-compacted, hole-free spool can reproduce
        the full artifact; anything else raises."""
        if not self.complete:
            raise ValueError(f"{self.directory}: spool is not complete; "
                             f"finalize only a closed run")
        if self.retained_start != 0:
            raise SpoolGapError(self.directory, 0, self.n_steps,
                                [(0, self.retained_start)])
        return self.to_trace().save(path)

    def compact(self, upto_step: int) -> List[str]:
        """Reader-side retention for a finished run (the writer-side
        equivalent is :meth:`TraceSpool.compact`): prune whole segments
        below ``upto_step`` and rewrite the manifest.  Refuses a live
        spool — the producer owns the manifest until it closes."""
        if not self.complete:
            raise ValueError(f"{self.directory}: spool is live; only its "
                             f"producer may compact")
        doc = self._doc
        keep, drop = [], []
        for s in doc["segments"]:
            (drop if s["start"] + s["n_steps"] <= upto_step else keep).append(s)
        if not drop:
            return []
        retained = keep[0]["start"] if keep else doc["n_steps"]
        doc["segments"] = keep
        doc["retained_start"] = retained
        doc.setdefault("compaction", []).append(
            {"upto_step": upto_step, "retained_start": retained,
             "files": [s["file"] for s in drop]})
        _write_manifest(self.directory, doc)
        for s in drop:
            try:
                os.remove(os.path.join(self.directory, s["file"]))
            except FileNotFoundError:
                pass
        return [s["file"] for s in drop]


class StallDetector:
    """Producer-death detection for live spool tails.

    The manifest is the producer's heartbeat (rewritten on every flush and
    at close); a consumer calls :meth:`observe` each poll and gets back a
    suggested sleep, which backs off exponentially while nothing changes.
    Once ``max_stall`` seconds pass with no progress — no manifest mtime
    change, no new steps, not complete — the producer is presumed dead and
    :class:`ProducerStalledError` is raised, so ``cli.watch_trace
    --max-stall`` exits with a documented code instead of polling forever.
    """

    def __init__(self, max_stall: float, base_interval: float = 0.5,
                 max_interval: float = 8.0, factor: float = 2.0,
                 time_fn: Callable[[], float] = time.monotonic):
        if max_stall <= 0:
            raise ValueError(f"max_stall must be > 0, got {max_stall}")
        self.max_stall = max_stall
        self.base_interval = base_interval
        self.max_interval = max_interval
        self.factor = factor
        self._time = time_fn
        self._sig: Optional[Tuple[float, int, bool]] = None
        self._since: Optional[float] = None
        self.interval = base_interval

    @property
    def stalled_for(self) -> float:
        """Seconds since the last observed progress (0 before the first
        observation)."""
        return 0.0 if self._since is None else self._time() - self._since

    def observe(self, spooled: SpooledTrace) -> float:
        """Record one poll of ``spooled`` (already reloaded).  Returns the
        suggested sleep before the next poll; raises
        :class:`ProducerStalledError` when the stall bound is exceeded."""
        now = self._time()
        try:
            mtime = spooled.manifest_mtime()
        except OSError:
            mtime = -1.0
        sig = (mtime, spooled.n_steps, spooled.complete)
        if sig != self._sig:
            self._sig = sig
            self._since = now
            self.interval = self.base_interval
        else:
            elapsed = now - self._since
            if elapsed > self.max_stall:
                raise ProducerStalledError(spooled.directory, elapsed,
                                           self.max_stall)
            self.interval = min(self.interval * self.factor,
                                self.max_interval)
        remaining = self.max_stall - (now - self._since)
        return min(self.interval, max(remaining, self.base_interval))
