"""The port's trace spool, chaos harness and fleet ingest against the
reference's contracts: mirrors of ``tests/test_chaos.py`` (its spool and
fleet part) and ``tests/test_fleet.py`` on the port's modules, every
analyzer on the kernel lane's plain version (``device="cpu"``), plus the
cross-package gates — a verdict index journal written by either package
opens in the other with equal counts.

* a producer killed at **any** write/rename boundary leaves a spool that
  ``TraceSpool.recover`` salvages to a hole-free, bit-exact prefix, with
  torn/corrupt files quarantined — moved aside and logged, never deleted;
* corrupt artifacts degrade the online analyzer (structured
  ``DegradedWindow``) instead of crashing it;
* ``VerdictIndex`` killed at any journal/snapshot fault point, reopened
  and re-fed, rebuilds the exact dedup report of an uninterrupted run;
* with >= 8 concurrent runs, one sick tenant cannot perturb any healthy
  run's window verdicts;
* the CLI twins hold the reference scripts' exit codes and output.
"""
import functools
import json
import os
import re

import numpy as np
import pytest

from repro.core import Verdict as RefVerdict
from repro.fleet import VerdictIndex as RefIndex
from repro_torch.core import Verdict, verdict_fingerprint
from repro_torch.core import faultpoints as FP
from repro_torch.core.faultpoints import InjectedCrash
from repro_torch.fleet import FleetConfig, FleetIngest, VerdictIndex
from repro_torch.scenarios.corpus import CORPUS, corpus_entries, run_entry
from repro_torch.stream import (QUARANTINE_DIR, OnlineAnalyzer,
                                ProducerStalledError, SpoolGapError,
                                SpooledTrace, StallDetector, TraceSpool)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every analyzer here runs the port's kernel lane through the kernel's
# plain version on the host.
CPU = {"device": "cpu"}
Online = functools.partial(OnlineAnalyzer, device="cpu")
Config = functools.partial(FleetConfig, device="cpu")


def chaos_trace(seed=0):
    """The chaos entries' base scenario: ST + a compute straggler active on
    every one of 16 steps, so each 4-step window flags ST/cr5."""
    entry = CORPUS["chaos/truncate-segment"]
    tree, coll = entry.build(seed)
    return tree, coll.make_trace()


def spool_up(trace, directory, chunk_steps=2, close=True):
    spool = TraceSpool(directory, chunk_steps=chunk_steps,
                       meta=dict(trace.meta))
    for s in range(trace.n_steps):
        spool.append(trace.window(s, s + 1))
    if close:
        spool.close(meta=dict(trace.meta))
    return spool


def assert_prefix_exact(spooled, trace):
    """The salvaged spool is a bit-exact prefix of the original trace."""
    n = spooled.n_steps
    if n == 0:
        return
    got = spooled.to_trace()
    want = trace.window(0, n)
    assert sorted(got.data) == sorted(want.data)
    for k, arr in got.data.items():
        assert np.array_equal(arr, want.data[k]), k


class TestFaultPoints:
    def test_noop_when_unarmed(self):
        FP.fault_point("nonexistent.point")   # must not raise

    def test_nth_hit_crashes(self):
        with FP.armed("p.x", nth=3):
            FP.fault_point("p.x")
            FP.fault_point("p.x")
            with pytest.raises(InjectedCrash) as ei:
                FP.fault_point("p.x")
            assert ei.value.point == "p.x"
        FP.fault_point("p.x")                 # disarmed on exit

    def test_hits_enumerates_schedule(self, tmp_path):
        _, trace = chaos_trace()
        with FP.hits() as h:
            spool_up(trace, str(tmp_path / "sp"), chunk_steps=2)
        assert h["spool.segment.written"] == 8
        assert h["spool.segment.renamed"] == 8
        assert h["spool.manifest.renamed"] >= 9   # 8 flushes + close

    def test_nested_arming_restores_previous(self):
        with FP.armed("q.y", nth=5):
            with FP.armed("q.y", nth=1):
                with pytest.raises(InjectedCrash):
                    FP.fault_point("q.y")
            FP.fault_point("q.y")   # outer arming back: needs 4 more hits
        FP.fault_point("q.y")


class TestSpoolKillSchedule:
    """Satellite: the kill-schedule sweep.  Interrupt the producer at every
    (fault point, hit) pair of a full spool run; after every single crash,
    recovery must yield a complete, hole-free, bit-exact prefix."""

    def test_every_boundary_is_crash_safe(self, tmp_path):
        _, trace = chaos_trace()
        with FP.hits() as schedule:
            spool_up(trace, str(tmp_path / "clean"), chunk_steps=2)
        spool_points = sorted(k for k in schedule if k.startswith("spool."))
        assert spool_points, "no spool fault points hit"
        salvaged = []
        for point in spool_points:
            for nth in range(1, schedule[point] + 1):
                d = str(tmp_path / f"{point}-{nth}")
                with FP.armed(point, nth=nth):
                    with pytest.raises(InjectedCrash):
                        spool_up(trace, d, chunk_steps=2)
                try:
                    event = TraceSpool.recover(d)
                except ValueError:
                    # killed before anything durable hit the disk
                    assert not [f for f in os.listdir(d)
                                if f.endswith(".npz")]
                    continue
                sp = SpooledTrace(d)
                assert sp.complete
                assert sp.n_steps == event["n_steps"] <= trace.n_steps
                assert sp.missing_ranges(sp.retained_start,
                                         sp.n_steps) == []
                assert sp.verify() == []
                assert_prefix_exact(sp, trace)
                salvaged.append(sp.n_steps)
        # the sweep genuinely exercised partial salvages, not just trivia
        assert any(0 < n < trace.n_steps for n in salvaged)


class TestRecoverSemantics:
    def test_torn_tmp_quarantined_and_logged(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        with FP.armed("spool.segment.written", nth=6):
            with pytest.raises(InjectedCrash):
                spool_up(trace, d, chunk_steps=2)
        event = TraceSpool.recover(d)
        assert len(event["quarantined"]) == 1
        q = event["quarantined"][0]
        assert q["file"].endswith(".tmp")
        assert "torn" in q["reason"]
        assert os.path.exists(os.path.join(d, QUARANTINE_DIR, q["file"]))
        sp = SpooledTrace(d)
        assert sp.n_steps == 10             # 5 intact segments
        assert sp.recovery[-1] == event     # logged in the manifest
        assert_prefix_exact(sp, trace)

    def test_orphan_segment_adopted(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        with FP.armed("spool.segment.renamed", nth=6):
            with pytest.raises(InjectedCrash):
                spool_up(trace, d, chunk_steps=2)
        event = TraceSpool.recover(d)
        assert event["adopted"] == ["segment-00005.npz"]
        assert event["quarantined"] == []
        sp = SpooledTrace(d)
        assert sp.n_steps == 12             # the orphan's 2 steps count
        assert sp.verify() == []            # adopted = checksummed too
        assert_prefix_exact(sp, trace)

    def test_corrupt_middle_segment_leaves_recorded_hole(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=2)
        with open(os.path.join(d, "segment-00001.npz"), "rb+") as f:
            f.truncate(40)
        event = TraceSpool.recover(d)
        assert event["lost_ranges"] == [[2, 4]]
        assert event["quarantined"][0]["file"] == "segment-00001.npz"
        sp = SpooledTrace(d)
        assert sp.missing_ranges(0, sp.n_steps) == [(2, 4)]
        with pytest.raises(SpoolGapError) as ei:
            sp.window(0, 4)
        assert ei.value.missing == [(2, 4)]
        with pytest.raises(SpoolGapError):
            sp.to_trace()
        # outside the hole the data is untouched
        got = sp.window(4, 16)
        for k, arr in got.data.items():
            assert np.array_equal(arr, trace.window(4, 16).data[k])

    def test_recover_without_manifest_rebuilds_index(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=4)
        os.remove(os.path.join(d, "spool.json"))
        event = TraceSpool.recover(d)
        assert len(event["adopted"]) == 4
        sp = SpooledTrace(d)
        assert sp.complete and sp.n_steps == 16
        assert_prefix_exact(sp, trace)

    def test_nothing_recoverable_raises(self, tmp_path):
        d = tmp_path / "empty"
        d.mkdir()
        with pytest.raises(ValueError, match="nothing recoverable"):
            TraceSpool.recover(str(d))

    def test_recover_is_idempotent(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        with FP.armed("spool.segment.written", nth=4):
            with pytest.raises(InjectedCrash):
                spool_up(trace, d, chunk_steps=2)
        first = TraceSpool.recover(d)
        second = TraceSpool.recover(d)
        assert second["quarantined"] == []
        assert second["n_steps"] == first["n_steps"]
        assert len(SpooledTrace(d).recovery) == 2   # both events logged


class TestCompaction:
    def test_reader_compact_keeps_window_exact(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        sp = spool_up(trace, d, chunk_steps=2)
        reader = SpooledTrace(d)
        pruned = reader.compact(upto_step=6)
        assert pruned == ["segment-00000.npz",
                          "segment-00001.npz", "segment-00002.npz"]
        assert reader.retained_start == 6
        assert not os.path.exists(os.path.join(d, "segment-00000.npz"))
        # retained range stays bit-exact
        got = reader.window(6, 16)
        for k, arr in got.data.items():
            assert np.array_equal(arr, trace.window(6, 16).data[k])
        with pytest.raises(SpoolGapError):
            reader.window(0, 8)
        with pytest.raises(SpoolGapError):
            reader.finalize(str(tmp_path / "out.npz"))
        assert reader.compaction[0]["upto_step"] == 6
        # fresh readers see the same retention state
        again = SpooledTrace(d)
        assert again.retained_start == 6
        assert again.missing_ranges(0, 16) == [(0, 6)]

    def test_producer_compact_midrun_then_resume(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        spool = TraceSpool(d, chunk_steps=2, meta=dict(trace.meta))
        for s in range(8):
            spool.append(trace.window(s, s + 1))
        assert spool.compact(upto_step=4) == ["segment-00000.npz",
                                              "segment-00001.npz"]
        for s in range(8, 16):
            spool.append(trace.window(s, s + 1))
        spool.close(meta=dict(trace.meta))
        sp = SpooledTrace(d)
        assert sp.retained_start == 4 and sp.n_steps == 16
        # numbering survives compaction: no reused segment file names
        assert sp.n_segments == 6
        got = sp.window(4, 16)
        for k, arr in got.data.items():
            assert np.array_equal(arr, trace.window(4, 16).data[k])

    def test_reader_compact_refuses_live_spool(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=2, close=False)
        with pytest.raises(ValueError, match="producer may compact"):
            SpooledTrace(d).compact(4)


class TestDegradedWindows:
    def test_nonfinite_window_degrades_and_onset_resumes(self):
        tree, trace = chaos_trace()
        trace.data["wall_time"][4:8] = np.nan
        online = Online(tree=tree, window_steps=4, persist=2)
        log = online.process_trace(trace)
        degraded = log.degraded_windows
        assert [w.index for w in degraded] == [1]
        assert degraded[0].reason == "non-finite samples"
        assert "wall_time" in degraded[0].detail["metrics"]
        assert not degraded[0].flagged()
        # windows 2,3 flag again -> onset resumes after the gap
        assert online.onset() == 2

    def test_gap_window_degrades_in_poll(self, tmp_path):
        tree, trace = chaos_trace()
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=2)
        with open(os.path.join(d, "segment-00001.npz"), "rb+") as f:
            f.truncate(40)
        TraceSpool.recover(d)
        online = Online(tree=tree, window_steps=4, persist=2)
        windows = online.poll(SpooledTrace(d))
        assert len(windows) == 4
        assert windows[0].degraded
        assert windows[0].reason == "window range lost"
        assert windows[0].detail["missing"] == [[2, 4]]
        assert all(not w.degraded and w.flagged() for w in windows[1:])


class TestStallDetector:
    def test_backoff_then_presumed_dead(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=2, close=False)   # incomplete, static
        clock = [0.0]
        det = StallDetector(max_stall=10.0, base_interval=1.0,
                            max_interval=4.0, time_fn=lambda: clock[0])
        sp = SpooledTrace(d)
        assert det.observe(sp) == 1.0      # first sighting = progress
        clock[0] = 1.0
        assert det.observe(sp) == 2.0      # backoff 1 -> 2
        clock[0] = 3.0
        assert det.observe(sp) == 4.0      # 2 -> 4 (cap)
        clock[0] = 7.0
        assert det.observe(sp) == pytest.approx(3.0)  # clipped to remaining
        clock[0] = 10.5
        with pytest.raises(ProducerStalledError, match="presumed dead"):
            det.observe(sp)
        assert det.stalled_for > 10.0

    def test_progress_resets_the_clock(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=2, close=False)
        clock = [0.0]
        det = StallDetector(max_stall=5.0, base_interval=1.0,
                            time_fn=lambda: clock[0])
        sp = SpooledTrace(d)
        det.observe(sp)
        clock[0] = 4.0
        det.observe(sp)
        os.utime(os.path.join(d, "spool.json"), (1, 1))   # heartbeat
        clock[0] = 8.0                      # 8s total, but only 4s since
        det.observe(sp.reload())            # progress -> no raise
        assert det.stalled_for == 0.0



# -- verdict index and fleet ingest ----------------------------------------


def make_verdict(paths=("ST/cr5",), disparity=(), causes=("flops",)):
    return Verdict(
        dissimilar=bool(paths), dissimilarity_paths=tuple(paths),
        dissimilarity_ccr_paths=tuple(paths),
        disparity_paths=tuple(disparity),
        disparity_ccr_paths=tuple(disparity),
        cause_attributes=frozenset(causes),
        dissimilarity_cause_attributes=frozenset(causes),
        per_path_causes=())


def fleet_trace(run: int, n_steps: int = 16, seed: int = 0):
    """One run of the fleet scenario: ST + a compute straggler active on
    every step (same planted fault per run, distinct per-run seed)."""
    _, coll = CORPUS["fleet/one-tenant-corruption"].build(seed)
    return coll.make_trace(run, n_steps)


def spool_upto(trace, directory, chunk_steps=2, upto=None, close=True):
    spool = TraceSpool(directory, chunk_steps=chunk_steps,
                       meta=dict(trace.meta))
    for s in range(upto if upto is not None else trace.n_steps):
        spool.append(trace.window(s, s + 1))
    if close:
        spool.close(meta=dict(trace.meta))
    return spool


def flip_bytes(path, n_flips=8, seed=3):
    rng = np.random.default_rng(seed)
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        for off in rng.choice(size, size=min(n_flips, size), replace=False):
            f.seek(int(off))
            b = f.read(1)
            f.seek(int(off))
            f.write(bytes([b[0] ^ 0xFF]))


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def tick_until_done(fleet, clock, max_ticks=400):
    for _ in range(max_ticks):
        if fleet.done:
            return True
        clock.now += 1.0
        fleet.tick()
    return fleet.done


# -- verdict fingerprint --------------------------------------------------


class TestVerdictFingerprint:
    def test_fingerprint_is_doc_equality(self):
        a, b = make_verdict(), make_verdict()
        assert a.doc() == b.doc()
        assert a.fingerprint() == b.fingerprint()
        c = make_verdict(paths=("ST/cr6",))
        assert a.doc() != c.doc()
        assert a.fingerprint() != c.fingerprint()

    def test_kind_prefix(self):
        assert make_verdict().fingerprint().startswith("dissim:")
        assert make_verdict(paths=(), disparity=("ST/cr2",)) \
            .fingerprint().startswith("disp:")
        assert make_verdict(disparity=("ST/cr2",)) \
            .fingerprint().startswith("both:")
        assert make_verdict(paths=(), causes=()) \
            .fingerprint().startswith("none:")

    def test_function_and_method_agree(self):
        v = make_verdict()
        assert verdict_fingerprint(v) == v.fingerprint()


# -- VerdictIndex ---------------------------------------------------------


def feed(index, records):
    for run, v, start, stop in records:
        index.record(run, v, start, stop)


def sample_records():
    va = make_verdict()                      # one recurring signature...
    vb = make_verdict(paths=("ST/cr6",))     # ...and a rarer second one
    recs = []
    for run in ("run-0", "run-1", "run-2"):
        for w in range(3):
            recs.append((run, va, w * 4, w * 4 + 4))
    recs.append(("run-1", vb, 0, 4))
    return recs


class TestVerdictIndex:
    def test_dedup_report(self, tmp_path):
        idx = VerdictIndex(str(tmp_path / "idx"), snapshot_every=4)
        feed(idx, sample_records())
        rows = idx.report()
        assert len(rows) == 2
        top = rows[0]               # widest blast radius first
        assert top["n_runs"] == 3 and top["n_windows"] == 9
        assert top["paths"] == ["ST/cr5"]
        assert rows[1]["n_runs"] == 1
        assert idx.seen_in(top["fingerprint"]) == 3

    def test_record_is_idempotent(self, tmp_path):
        idx = VerdictIndex(str(tmp_path / "idx"))
        feed(idx, sample_records())
        before = idx.report()
        feed(idx, sample_records())         # at-least-once delivery
        assert idx.report() == before

    def test_reopen_rebuilds_from_journal(self, tmp_path):
        d = str(tmp_path / "idx")
        idx = VerdictIndex(d, snapshot_every=1000)   # journal only
        feed(idx, sample_records())
        rows = idx.report()
        del idx
        again = VerdictIndex(d)
        assert again.report() == rows
        assert again.recovered_event["torn_tail"] is None

    def test_close_snapshots_and_reopen_replays_nothing(self, tmp_path):
        d = str(tmp_path / "idx")
        idx = VerdictIndex(d, snapshot_every=1000)
        feed(idx, sample_records())
        idx.close()
        again = VerdictIndex(d)
        assert again.recovered_event["replayed"] == 0
        assert again.report() == idx.report()

    def test_torn_tail_is_preserved_not_fatal(self, tmp_path):
        d = str(tmp_path / "idx")
        idx = VerdictIndex(d, snapshot_every=1000)
        feed(idx, sample_records())
        rows = idx.report()
        with open(os.path.join(d, "journal.jsonl"), "a") as f:
            f.write('{"run": "run-9", "fp": "tru')     # killed mid-append
        again = VerdictIndex(d)
        assert again.report() == rows       # unacknowledged -> old state
        assert again.recovered_event["torn_tail"].startswith('{"run"')

    def test_corrupt_nonfinal_line_is_fatal(self, tmp_path):
        d = str(tmp_path / "idx")
        idx = VerdictIndex(d, snapshot_every=1000)
        feed(idx, sample_records())
        path = os.path.join(d, "journal.jsonl")
        lines = open(path).read().splitlines(keepends=True)
        lines[1] = "GARBAGE\n"
        open(path, "w").write("".join(lines))
        with pytest.raises(ValueError, match="corrupt journal record"):
            VerdictIndex(d)

    def test_foreign_snapshot_rejected(self, tmp_path):
        d = str(tmp_path / "idx")
        os.makedirs(d)
        with open(os.path.join(d, "snapshot.json"), "w") as f:
            json.dump({"format": "something-else"}, f)
        with pytest.raises(ValueError, match="not a verdict-index"):
            VerdictIndex(d)


class TestVerdictIndexKillSchedule:
    """Tentpole gate: kill the index at every journal/snapshot boundary;
    reopen + re-feed (at-least-once) must rebuild the exact dedup
    counts of an uninterrupted run — for every single (point, nth)."""

    def test_every_boundary_rebuilds_exact_counts(self, tmp_path):
        recs = sample_records()
        with FP.hits() as schedule:
            clean = VerdictIndex(str(tmp_path / "clean"), snapshot_every=3)
            feed(clean, recs)
            clean.close()
        want = clean.report()
        points = sorted(k for k in schedule if k.startswith("vindex."))
        assert {"vindex.journal.pre_append", "vindex.journal.appended",
                "vindex.snapshot.written",
                "vindex.snapshot.renamed"} <= set(points)
        swept = 0
        for point in points:
            for nth in range(1, schedule[point] + 1):
                d = str(tmp_path / f"{point}-{nth}")
                with FP.armed(point, nth=nth):
                    with pytest.raises(InjectedCrash):
                        idx = VerdictIndex(d, snapshot_every=3)
                        feed(idx, recs)
                        idx.close()
                # crash-recover: reopen never raises on crash residue,
                # re-feeding every record is a no-op for survivors
                again = VerdictIndex(d, snapshot_every=3)
                feed(again, recs)
                assert again.report() == want, f"{point}#{nth}"
                again.close()
                final = VerdictIndex(d)
                assert final.report() == want, f"{point}#{nth} reopened"
                assert final.recovered_event["replayed"] == 0
                swept += 1
        assert swept >= 8       # the sweep is a real schedule, not trivia


class TestVerdictIndexRetention:
    """Carry-over: bounded index growth.  Aggregates age out past the
    ``retain_runs`` horizon and the journal collapses behind snapshots,
    but idempotence keys are never dropped and live counts never move."""

    def test_aged_out_runs_drop_from_report(self, tmp_path):
        idx = VerdictIndex(str(tmp_path / "idx"), retain_runs=2)
        feed(idx, sample_records())     # run-0, run-1, run-2 in order
        rows = idx.report()
        runs = {r for row in rows for r in row["runs"]}
        assert runs == {"run-1", "run-2"}   # run-0 aged out
        assert idx.evicted_runs == 1
        top = rows[0]
        assert top["n_runs"] == 2 and top["n_windows"] == 6

    def test_eviction_survives_refeed(self, tmp_path):
        """An evicted run's records stay dead on at-least-once redelivery
        — the idempotence keys outlive the aggregates."""
        idx = VerdictIndex(str(tmp_path / "idx"), retain_runs=2)
        recs = sample_records()
        feed(idx, recs)
        before = idx.report()
        feed(idx, (r for r in recs if r[0] == "run-0"))   # redeliver
        assert idx.report() == before
        # ...but a genuinely NEW window re-admits the run (fresh recency)
        idx.record("run-0", make_verdict(), 100, 104)
        runs = {r for row in idx.report() for r in row["runs"]}
        assert "run-0" in runs and len(runs) == 2

    def test_empty_fingerprints_disappear(self, tmp_path):
        """A signature whose every contributing run ages out leaves the
        report entirely."""
        idx = VerdictIndex(str(tmp_path / "idx"), retain_runs=1)
        # feed order: run-0 (3x va), run-1 (3x va), run-2 (3x va),
        # run-1 (1x vb) — the trailing vb record re-admits run-1 and
        # evicts run-2, so va loses its last contributor and vanishes
        feed(idx, sample_records())
        rows = idx.report()
        assert len(rows) == 1
        assert rows[0]["paths"] == ["ST/cr6"]
        assert rows[0]["runs"] == {"run-1": 1}

    def test_retained_state_replays_from_journal(self, tmp_path):
        d = str(tmp_path / "idx")
        idx = VerdictIndex(d, snapshot_every=1000, retain_runs=2)
        feed(idx, sample_records())
        rows = idx.report()
        again = VerdictIndex(d, retain_runs=2)     # journal-only replay
        assert again.report() == rows

    def test_tightened_horizon_on_reopen_evicts(self, tmp_path):
        d = str(tmp_path / "idx")
        idx = VerdictIndex(d)
        feed(idx, sample_records())
        idx.close()
        again = VerdictIndex(d, retain_runs=1)
        runs = {r for row in again.report() for r in row["runs"]}
        assert runs == {"run-1"}    # the last run to contribute a window

    def test_journal_truncation_bounds_growth(self, tmp_path):
        d = str(tmp_path / "idx")
        idx = VerdictIndex(d, snapshot_every=2, journal_max_records=4)
        feed(idx, sample_records())     # 10 records
        rows = idx.report()
        lines = [json.loads(ln) for ln in
                 open(os.path.join(d, "journal.jsonl")) if ln.strip()]
        assert "_base" in lines[0]
        # marker + the tail past the last truncation, never all 10
        assert len(lines) <= 1 + 4 + 2
        again = VerdictIndex(d)
        assert again.report() == rows
        assert again.n_records == 10

    def test_marker_past_snapshot_is_fatal(self, tmp_path):
        """A truncation marker claiming records the snapshot does not
        cover means data loss — refuse to open, never undercount."""
        d = str(tmp_path / "idx")
        idx = VerdictIndex(d, snapshot_every=1000)
        feed(idx, sample_records())
        del idx
        with open(os.path.join(d, "journal.jsonl"), "w") as f:
            f.write('{"_base": 99}\n')
        with pytest.raises(ValueError, match="unrecoverable"):
            VerdictIndex(d)

    def test_kill_sweep_never_loses_live_counts(self, tmp_path):
        """The tentpole-grade gate for retention: kill at every journal,
        snapshot AND truncation boundary; reopen + re-feed must rebuild
        exactly the retained report of an uninterrupted run."""
        recs = sample_records()
        kw = dict(snapshot_every=3, retain_runs=2, journal_max_records=4)
        with FP.hits() as schedule:
            clean = VerdictIndex(str(tmp_path / "clean"), **kw)
            feed(clean, recs)
            clean.close()
        want = clean.report()
        points = sorted(k for k in schedule if k.startswith("vindex."))
        assert {"vindex.journal.truncate.written",
                "vindex.journal.truncated"} <= set(points)
        swept = 0
        for point in points:
            for nth in range(1, schedule[point] + 1):
                d = str(tmp_path / f"{point}-{nth}")
                with FP.armed(point, nth=nth):
                    with pytest.raises(InjectedCrash):
                        idx = VerdictIndex(d, **kw)
                        feed(idx, recs)
                        idx.close()
                again = VerdictIndex(d, **kw)
                feed(again, recs)
                assert again.report() == want, f"{point}#{nth}"
                again.close()
                final = VerdictIndex(d, **kw)
                assert final.report() == want, f"{point}#{nth} reopened"
                swept += 1
        assert swept >= 10


# -- fleet ingest ---------------------------------------------------------


class TestFleetIsolation:
    def test_corrupt_tenant_cannot_perturb_siblings(self, tmp_path):
        """>= 8 concurrent runs; one tenant's segments rot; the sick run
        quarantines and every healthy run's windows stay bit-identical
        (Verdict.doc()) to a solo analysis of the same spool."""
        n_runs, victim = 8, 3
        dirs = []
        for r in range(n_runs):
            d = str(tmp_path / f"run-{r}")
            spool_up(fleet_trace(r), d)
            dirs.append(d)
        for seg in (1, 3, 5):       # 3 bad segments -> breaker trips
            flip_bytes(os.path.join(dirs[victim],
                                    f"segment-{seg:05d}.npz"), seed=seg)
        clock = FakeClock()
        idx = VerdictIndex(str(tmp_path / "idx"))
        fleet = FleetIngest(Config(), index=idx, time_fn=clock)
        for r, d in enumerate(dirs):
            fleet.add_run(f"run-{r}", d)
        assert tick_until_done(fleet, clock)

        sick = fleet.runs[f"run-{victim}"]
        assert sick.state == "quarantined"
        assert sick.integrity_failures >= 3
        assert not [w for w in sick.windows if not w.degraded], \
            "no verdict may be fabricated from corrupt bytes"
        kinds = [e.kind for e in sick.events]
        assert "integrity" in kinds and "quarantine" in kinds

        for r in range(n_runs):
            if r == victim:
                continue
            sup = fleet.runs[f"run-{r}"]
            assert sup.state == "done"
            solo = Online(window_steps=4, persist=2) \
                .poll(SpooledTrace(dirs[r]))
            assert len(sup.windows) == len(solo) == 4
            for got, want in zip(sup.windows, solo):
                assert not got.degraded and not want.degraded
                assert (got.start, got.stop) == (want.start, want.stop)
                assert got.verdict.doc() == want.verdict.doc()

        # the healthy runs' shared signature dedups to "seen in 7 runs"
        top = idx.report()[0]
        assert top["n_runs"] == n_runs - 1

    def test_internal_error_quarantines_run_not_fleet(self, tmp_path):
        d0, d1 = str(tmp_path / "a"), str(tmp_path / "b")
        spool_up(fleet_trace(0), d0)
        spool_up(fleet_trace(1), d1)
        clock = FakeClock()
        fleet = FleetIngest(Config(), time_fn=clock)
        fleet.add_run("a", d0)
        fleet.add_run("b", d1)

        def boom(*a, **k):
            raise RuntimeError("supervision bug")
        fleet.runs["a"].discover = boom
        assert tick_until_done(fleet, clock)
        assert fleet.runs["a"].state == "quarantined"
        assert "supervision bug" in fleet.runs["a"].error
        assert fleet.runs["b"].state == "done"
        assert len(fleet.runs["b"].windows) == 4


class TestBackpressure:
    def test_sheds_oldest_keeps_log_contiguous(self, tmp_path):
        d = str(tmp_path / "run")
        spool_up(fleet_trace(0, n_steps=24), d)
        clock = FakeClock()
        cfg = Config(queue_windows=2, max_workers=1)
        fleet = FleetIngest(cfg, time_fn=clock)
        fleet.add_run("run", d)
        assert tick_until_done(fleet, clock)
        sup = fleet.runs["run"]
        log = sup.windows
        assert [w.index for w in log] == list(range(6))
        shed = [w for w in log if w.degraded
                and w.reason == "shed: backpressure"]
        assert len(shed) == 4               # 6 discovered - 2 kept
        assert [w.index for w in shed] == [0, 1, 2, 3], \
            "shedding must drop the oldest first"
        kept = [w for w in log if not w.degraded]
        assert [(w.start, w.stop) for w in kept] == [(16, 20), (20, 24)]
        events = [e for e in sup.events if e.kind == "shed"]
        assert len(events) == 4
        assert all(e.doc()["event"] == "shed" for e in events)

    def test_default_budget_never_sheds(self, tmp_path):
        d = str(tmp_path / "run")
        spool_up(fleet_trace(0, n_steps=24), d)
        clock = FakeClock()
        fleet = FleetIngest(Config(), time_fn=clock)
        fleet.add_run("run", d)
        assert tick_until_done(fleet, clock)
        assert fleet.runs["run"].shed == 0
        assert len(fleet.runs["run"].windows) == 6


class TestStallRecovery:
    def test_dead_producer_is_recovered_and_drained(self, tmp_path):
        d = str(tmp_path / "run")
        spool_upto(fleet_trace(0), d, upto=10, close=False)   # dies at 10
        clock = FakeClock()
        fleet = FleetIngest(Config(max_stall=3.0), time_fn=clock)
        fleet.add_run("run", d)
        assert tick_until_done(fleet, clock)
        sup = fleet.runs["run"]
        assert sup.state == "done"
        kinds = [e.kind for e in sup.events]
        assert "stall" in kinds and "recover" in kinds
        # salvaged tail drained: [0,4), [4,8), then the partial [8,10)
        assert [(w.start, w.stop) for w in sup.windows] == \
            [(0, 4), (4, 8), (8, 10)]
        assert not any(w.degraded for w in sup.windows)

    def test_unreadable_manifest_retries_then_quarantines(self, tmp_path):
        d = str(tmp_path / "run")
        spool_up(fleet_trace(0), d)
        man = os.path.join(d, "spool.json")
        good = open(man).read()
        open(man, "w").write("NOT JSON")
        clock = FakeClock()
        fleet = FleetIngest(Config(), time_fn=clock)
        fleet.add_run("run", d)
        for _ in range(80):
            if fleet.done:
                break
            clock.now += 1.0
            fleet.tick()
        sup = fleet.runs["run"]
        assert sup.state == "quarantined"
        retries = [e for e in sup.events if e.kind == "retry"]
        assert len(retries) >= 3            # exponential backoff attempts
        assert retries[1].retry_tick - retries[0].retry_tick >= 1
        assert "unreadable" in sup.quarantine_reason \
            or "integrity" in sup.quarantine_reason

        # and a transient error heals: restore the manifest mid-backoff
        d2 = str(tmp_path / "run2")
        spool_up(fleet_trace(1), d2)
        man2 = os.path.join(d2, "spool.json")
        good2 = open(man2).read()
        open(man2, "w").write("NOT JSON")
        clock2 = FakeClock()
        fleet2 = FleetIngest(Config(), time_fn=clock2)
        fleet2.add_run("run", d2)
        clock2.now += 1.0
        fleet2.tick()                       # first failed read
        open(man2, "w").write(good2)
        assert tick_until_done(fleet2, clock2)
        assert fleet2.runs["run"].state == "done"
        assert len(fleet2.runs["run"].windows) == 4
        assert good                         # (unused restore for run 1)


# -- fleet corpus gates ---------------------------------------------------


FLEET = sorted(e.name for e in corpus_entries(backend="fleet"))


class TestFleetCorpus:
    def test_registry_has_all_archetypes(self):
        assert FLEET == ["fleet/analysis-lag-flood",
                         "fleet/concurrent-producer-kill",
                         "fleet/one-tenant-corruption"]

    def test_fleet_outcome_deterministic(self):
        name = "fleet/one-tenant-corruption"
        a = run_entry(CORPUS[name], seed=0,
                      analyzer_overrides=CPU).chaos_outcome
        b = run_entry(CORPUS[name], seed=0,
                      analyzer_overrides=CPU).chaos_outcome
        assert (a.quarantined, a.degraded, a.shed, a.matched,
                a.comparable) == (b.quarantined, b.degraded, b.shed,
                                  b.matched, b.comparable)
        assert a.verdict.fingerprint() == b.verdict.fingerprint()


# -- command-line twins ---------------------------------------------------


def cli(name):
    import importlib
    return importlib.import_module(f"repro_torch.cli.{name}").main


class TestWatchTraceExitCodes:
    def test_max_stall_exits_4(self, tmp_path, capsys):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=2, close=False)   # producer "dies"
        rc = cli("watch_trace")([d, "--follow", "--interval", "0.02",
                                 "--max-stall", "0.15", "--device", "cpu"])
        assert rc == 4
        assert "presumed dead" in capsys.readouterr().err

    def test_max_stall_bounds_startup_wait(self, tmp_path, capsys):
        # Producer died before its FIRST flush: no manifest ever appears.
        # --max-stall must bound the startup wait too, not just the tail.
        d = str(tmp_path / "never-born")
        os.makedirs(d)
        rc = cli("watch_trace")([d, "--follow", "--interval", "0.02",
                                 "--max-stall", "0.1", "--device", "cpu"])
        assert rc == 4
        assert "presumed dead" in capsys.readouterr().err

    def test_incomplete_without_follow_exits_3(self, tmp_path):
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=2, close=False)
        assert cli("watch_trace")([d, "--device", "cpu"]) == 3

    def test_default_device_is_the_card(self, tmp_path):
        """Without a card the default lane refuses before tailing; with
        ``--distance-backend numpy`` the exact lane needs no card."""
        import torch
        _, trace = chaos_trace()
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=2)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli("watch_trace")([d])
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli("fleet_watch")(["--run", f"a={d}"])
        assert cli("watch_trace")([d, "--distance-backend", "numpy"]) == 0


class TestFleetWatchCLI:
    def test_corrupt_tenant_report_and_resume(self, tmp_path, capsys):
        root = tmp_path / "fleet"
        for r in range(4):
            spool_up(fleet_trace(r, n_steps=8),
                     str(root / f"run-{r}"))
        for seg in range(3):
            flip_bytes(str(root / "run-3" / f"segment-{seg:05d}.npz"),
                       seed=seg)
        idx = str(tmp_path / "idx")
        argv = ["--root", str(root), "--index", idx, "--device", "cpu"]
        capsys.readouterr()
        assert cli("fleet_watch")(argv) == 4      # a run quarantined
        out = capsys.readouterr().out
        assert "quarantined" in out
        assert re.search(r"seen in 3 runs\s+6 windows", out), out
        # rerun against the persisted index: idempotent counts (the sick
        # run was recovered on disk, so this pass exits 0)
        assert cli("fleet_watch")(argv) == 0
        assert re.search(r"seen in 3 runs\s+6 windows",
                         capsys.readouterr().out)

    def test_json_and_no_runs(self, tmp_path, capsys):
        spool_up(fleet_trace(0, n_steps=8), str(tmp_path / "f" / "a"))
        capsys.readouterr()
        assert cli("fleet_watch")(["--root", str(tmp_path / "f"), "--json",
                                   "--device", "cpu"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["runs"][0]["state"] == "done"
        assert doc["index"][0]["n_runs"] == 1
        empty = tmp_path / "empty"
        empty.mkdir()
        assert cli("fleet_watch")(["--root", str(empty),
                                   "--device", "cpu"]) == 3

    def test_json_equals_reference_script(self, tmp_path, capsys):
        """The fleet status and dedup report of the port's twin equal the
        reference script's on the same spools (directories aside)."""
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "ref_fleet_watch", os.path.join(REPO, "scripts",
                                            "fleet_watch.py"))
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
        root = tmp_path / "fleet"
        for r in range(3):
            spool_up(fleet_trace(r, n_steps=8), str(root / f"run-{r}"))
        flip_bytes(str(root / "run-1" / "segment-00001.npz"))
        docs = []
        for main, lane in ((ref.main, []), (cli("fleet_watch"),
                                            ["--device", "cpu"])):
            capsys.readouterr()
            assert main(["--root", str(root), "--json", *lane]) == 0
            docs.append(json.loads(capsys.readouterr().out))
        assert docs[0] == docs[1]


class TestWatchTraceRecoverCLI:
    def test_recover_adopts_and_analyzes(self, tmp_path, capsys):
        d = str(tmp_path / "spool")
        trace = fleet_trace(0)
        with FP.armed("spool.segment.renamed", nth=6):
            with pytest.raises(InjectedCrash):
                spool_upto(trace, d)
        capsys.readouterr()
        assert cli("watch_trace")([d, "--recover", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "recover: adopted segment-00005.npz" in out
        assert "recover: sealed at 12 steps" in out
        assert "window   2" in out      # the salvaged tail analyzed

    def test_recover_nothing_salvageable_exits_3(self, tmp_path, capsys):
        d = tmp_path / "empty-spool"
        d.mkdir()
        assert cli("watch_trace")([str(d), "--recover",
                                   "--device", "cpu"]) == 3
        assert capsys.readouterr().err.strip()


# -- the index across packages ---------------------------------------------


def _to_ref(v: Verdict) -> RefVerdict:
    return RefVerdict(**{f: getattr(v, f)
                         for f in RefVerdict.__dataclass_fields__})


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("closed", [False, True], ids=["journal", "snapshot"])
def test_index_opens_in_the_other_package(tmp_path, writer, closed):
    """A VerdictIndex written by either package — journal only, or closed
    onto a snapshot — opens in the other with equal counts and report,
    and the two packages write the same bytes."""
    recs = sample_records()
    dirs = {}
    for pkg, cls, conv in (("port", VerdictIndex, lambda v: v),
                           ("reference", RefIndex, _to_ref)):
        d = str(tmp_path / pkg)
        idx = cls(d, snapshot_every=4 if closed else 1000)
        for run, v, start, stop in recs:
            idx.record(run, conv(v), start, stop)
        if closed:
            idx.close()
        dirs[pkg] = d
    for name in sorted(os.listdir(dirs["port"])):
        with open(os.path.join(dirs["port"], name), "rb") as a, \
                open(os.path.join(dirs["reference"], name), "rb") as b:
            assert a.read() == b.read(), name
    reader = RefIndex if writer == "port" else VerdictIndex
    other = reader(dirs[writer])
    mine = (VerdictIndex if writer == "port" else RefIndex)(dirs[writer])
    assert other.report() == mine.report()
    assert other.n_records == mine.n_records == len(recs)
    assert sorted(other.seen_in(fp) for fp in other.fingerprints) == \
        sorted(mine.seen_in(fp) for fp in mine.fingerprints) == [1, 3]


CHAOS = [e.name for e in corpus_entries(backend="chaos")]


class TestChaosCorpus:
    def test_registry_has_the_spool_archetypes(self):
        """The reference's six chaos entries: the five spool archetypes
        and, with training's checkpoint writer, the checkpoint one."""
        from repro.scenarios.corpus import corpus_entries as ref_entries
        ref = {e.name for e in ref_entries(backend="chaos")}
        assert set(CHAOS) == ref
        assert "chaos/corrupt-latest-checkpoint" in CHAOS
        assert len(CHAOS) == 6

    def test_chaos_outcome_deterministic(self):
        name = "chaos/kill-producer-torn-segment"
        a = run_entry(CORPUS[name], seed=0,
                      analyzer_overrides=CPU).chaos_outcome
        b = run_entry(CORPUS[name], seed=0,
                      analyzer_overrides=CPU).chaos_outcome
        assert (a.quarantined, a.adopted, a.degraded, a.matched,
                a.comparable) == (b.quarantined, b.adopted, b.degraded,
                                  b.matched, b.comparable)
        # fingerprint equality is doc() equality (core/report.py)
        assert a.verdict.fingerprint() == b.verdict.fingerprint()

    def test_default_lane_needs_the_card(self):
        """Without overrides the harness's analyzers run on the card: no
        card, no silent fallback to the host."""
        import torch
        if torch.cuda.is_available():
            pytest.skip("a card is present; the default lane runs on it")
        _, col = CORPUS["chaos/truncate-segment"].build(0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            col.run_chaos()
