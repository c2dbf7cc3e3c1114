"""The port's streaming layer against the reference: spool round-trips,
window reassembly, online verdicts — mirrors of ``tests/test_stream.py``
on the port's modules, every analyzer on the kernel lane's plain version
(``device="cpu"``) — and the cross-package gates:

* ``SpooledTrace.finalize()`` is **byte-identical** to the monolithic
  ``RegionTrace.save`` of the same run, for the synthetic scenarios and
  for a serving engine spooling its steps;
* the two packages write the same spool bytes, and a spool written by
  either tails in the other's ``OnlineAnalyzer`` with equal window
  verdicts;
* the onset detector localizes the thermal-drift corpus entry at its
  planted window across seeds {0, 7};
* the CPU-clock selection prefers the per-thread clock only when it is
  finer *and* attributable.
"""
import functools
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

from repro.core import RegionTrace as RefTrace
from repro.stream import OnlineAnalyzer as RefOnline
from repro.stream import SpooledTrace as RefSpooled
from repro.stream import TraceSpool as RefSpool
pytest.importorskip("torch")
from repro_torch.core import AutoAnalyzer, RegionTrace, TimedRegionRunner
from repro_torch.core import collector as collector_mod
from repro_torch.core.analyzer import Verdict
from repro_torch.scenarios.corpus import CORPUS
from repro_torch.stream import (OnlineAnalyzer, SpooledTrace, TraceSpool,
                                WindowVerdict, WindowVerdictLog)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = pathlib.Path(REPO)
# Every analyzer here runs the port's kernel lane through the kernel's
# plain version on the host.
Online = functools.partial(OnlineAnalyzer, device="cpu")


def drift_trace(seed=0):
    """The thermal-drift onset entry's trace: 16 steps, drift from step 8."""
    entry = CORPUS["st/thermal-drift-onset"]
    tree, coll = entry.build(seed)
    return entry, tree, coll.collect_trace()


def step_traces(trace):
    return [trace.window(s, s + 1) for s in range(trace.n_steps)]


def spool_up(trace, directory, chunk_steps, meta=None):
    spool = TraceSpool(directory, chunk_steps=chunk_steps)
    for st in step_traces(trace):
        spool.append(st)
    spool.close(meta=meta)
    return SpooledTrace(directory)


class TestSpool:
    def test_segmentation_and_manifest(self, tmp_path):
        _, _, trace = drift_trace()
        sp = spool_up(trace, str(tmp_path / "sp"), chunk_steps=5)
        assert sp.n_steps == 16
        assert sp.complete
        # 5 + 5 + 5 + tail 1
        assert sp.n_segments == 4
        assert [t.n_steps for t in sp.segments()] == [5, 5, 5, 1]
        assert sp.schema == trace.schema

    def test_finalize_byte_identical_synthetic(self, tmp_path):
        """The acceptance pin: streamed segments reassemble into the very
        bytes the monolithic save would have written."""
        _, _, trace = drift_trace()
        mono = str(tmp_path / "mono.npz")
        trace.save(mono)
        for chunk in (1, 5, 16):
            sp = spool_up(trace, str(tmp_path / f"sp{chunk}"),
                          chunk_steps=chunk)
            fin = str(tmp_path / f"fin{chunk}.npz")
            sp.finalize(fin)
            with open(mono, "rb") as a, open(fin, "rb") as b:
                assert a.read() == b.read(), f"chunk_steps={chunk}"

    def test_final_meta_applied(self, tmp_path):
        _, _, trace = drift_trace()
        final = {"collector": "synthetic", "note": "closed"}
        sp = spool_up(trace, str(tmp_path / "sp"), chunk_steps=4,
                      meta=final)
        assert sp.meta == final
        assert sp.to_trace().meta == final
        # ... and the monolithic twin with the same meta matches bytes
        trace.meta = dict(final)
        mono = str(tmp_path / "mono.npz")
        trace.save(mono)
        fin = str(tmp_path / "fin.npz")
        sp.finalize(fin)
        with open(mono, "rb") as a, open(fin, "rb") as b:
            assert a.read() == b.read()

    def test_window_reassembly_bit_identical(self, tmp_path):
        _, _, trace = drift_trace()
        sp = spool_up(trace, str(tmp_path / "sp"), chunk_steps=3)
        for (a, b) in [(0, 3), (2, 7), (5, 16), (0, 16), (15, 16)]:
            got = sp.window(a, b).reduce()
            want = trace.reduce(window=(a, b))
            for k in want.data:
                np.testing.assert_array_equal(got.metric(k),
                                              want.metric(k),
                                              err_msg=f"[{a},{b}) {k}")

    def test_live_tail_sees_flushed_steps(self, tmp_path):
        _, _, trace = drift_trace()
        spool = TraceSpool(str(tmp_path / "sp"), chunk_steps=2)
        steps = step_traces(trace)
        for st in steps[:5]:
            spool.append(st)
        # two chunks flushed, one step still buffered in the writer
        reader = SpooledTrace(str(tmp_path / "sp"))
        assert reader.n_steps == 4
        assert not reader.complete
        with pytest.raises(ValueError):
            reader.finalize(str(tmp_path / "early.npz"))
        for st in steps[5:]:
            spool.append(st)
        spool.close()
        reader.reload()
        assert reader.complete and reader.n_steps == 16

    def test_writer_guards(self, tmp_path):
        _, _, trace = drift_trace()
        d = str(tmp_path / "sp")
        spool = TraceSpool(d, chunk_steps=4)
        steps = step_traces(trace)
        spool.append(steps[0])
        bad = trace.window(0, 1)
        bad.region_ids = bad.region_ids[:-1]
        bad.schema = bad.schema[:-1]
        with pytest.raises(ValueError, match="disagree"):
            spool.append(RegionTrace(
                region_ids=bad.region_ids, n_processes=bad.n_processes,
                schema=bad.schema,
                data={k: v[:, :, :, :-1] for k, v in bad.data.items()}))
        spool.close()
        with pytest.raises(ValueError, match="closed"):
            spool.append(steps[1])
        with pytest.raises(ValueError, match="already contains"):
            TraceSpool(d)
        with pytest.raises(ValueError, match="no spool manifest"):
            SpooledTrace(str(tmp_path / "nowhere"))


def _verdict(flag: bool) -> Verdict:
    return Verdict(dissimilar=flag,
                   dissimilarity_paths=("X/r",) if flag else (),
                   dissimilarity_ccr_paths=(), disparity_paths=(),
                   disparity_ccr_paths=(), cause_attributes=frozenset(),
                   dissimilarity_cause_attributes=frozenset(),
                   per_path_causes=())


def _log(pattern: str, persist: int) -> WindowVerdictLog:
    log = WindowVerdictLog(persist=persist)
    for i, c in enumerate(pattern):
        log.append(WindowVerdict(index=i, start=i, stop=i + 1,
                                 verdict=_verdict(c == "T")))
    return log


class TestOnsetDetector:
    def test_persist_filters_single_blips(self):
        assert _log("FTFTTTT", persist=2).onset() == 3
        assert _log("FTFTTTT", persist=1).onset() == 1
        assert _log("FTFTFTF", persist=2).onset() is None
        assert _log("TTTT", persist=4).onset() == 0
        assert _log("TTT", persist=4).onset() is None   # not yet persisted

    def test_kind_filter(self):
        log = _log("TT", persist=2)
        assert log.onset("dissimilarity") == 0
        assert log.onset("disparity") is None

    def test_report_shape(self):
        rep = _log("FTT", persist=2).onset_report()
        assert rep["onset_window"] == 1
        assert rep["kinds"] == ["dissimilarity"]
        assert rep["paths"] == ["X/r"]
        assert _log("FFF", persist=2).onset_report() is None

    def test_out_of_order_append_rejected(self):
        log = WindowVerdictLog()
        with pytest.raises(ValueError, match="out of order"):
            log.append(WindowVerdict(index=3, start=0, stop=1,
                                     verdict=_verdict(False)))


class TestOnlineAnalyzer:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_drift_onset_window(self, seed):
        """The acceptance pin: the drifting fault is localized in time at
        its planted onset window, for both gate seeds."""
        entry, tree, trace = drift_trace(seed)
        online = Online(tree=tree, window_steps=4, persist=2)
        online.process_trace(trace)
        assert online.onset("dissimilarity") == 2
        rep = online.onset_report("dissimilarity")
        assert rep["onset_step"] == 8
        assert rep["paths"] == ["ST/cr5"]
        # the pre-onset windows are genuinely clean of dissimilarity
        assert [w.flagged("dissimilarity")
                for w in online.log.windows] == [False, False, True, True]

    def test_poll_equals_process_trace_equals_offline(self, tmp_path):
        """Streaming (poll over a growing spool), in-memory process_trace
        and the offline per-window replay agree verdict-for-verdict."""
        entry, tree, trace = drift_trace()
        offline = AutoAnalyzer(tree, device="cpu")
        want = [offline.analyze_trace(trace, window=(s, min(s + 4, 16)))
                .verdict for s in range(0, 16, 4)]

        mem = Online(tree=tree, window_steps=4)
        assert [w.verdict for w in mem.process_trace(trace).windows] == want

        spool = TraceSpool(str(tmp_path / "sp"), chunk_steps=3)
        online = Online(window_steps=4)   # tree from the schema
        seen = []
        reader = None
        for st in step_traces(trace):
            spool.append(st)
            try:
                reader = reader or SpooledTrace(str(tmp_path / "sp"))
            except ValueError:
                continue                           # nothing flushed yet
            seen += online.poll(reader)
        spool.close()
        seen += online.poll(reader)
        assert [w.verdict for w in seen] == want
        assert [(w.start, w.stop) for w in seen] == \
            [(0, 4), (4, 8), (8, 12), (12, 16)]

    def test_stride_and_trailing_partial(self):
        _, tree, trace = drift_trace()
        online = Online(tree=tree, window_steps=5)
        log = online.process_trace(trace)
        assert [(w.start, w.stop) for w in log.windows] == \
            [(0, 5), (5, 10), (10, 15), (15, 16)]
        hop = Online(tree=tree, window_steps=8, stride=4)
        assert [(w.start, w.stop)
                for w in hop.process_trace(trace).windows] == \
            [(0, 8), (4, 12), (8, 16), (12, 16)]

    def test_live_tail_resolves_provisional_analyzer_kw(self, tmp_path):
        """A live (not yet closed) spool carries the producer's run-level
        meta provisionally, so the online analyzer resolves analyzer_kw
        from the very first poll — identical to the post-close replay."""
        _, tree, trace = drift_trace()
        spool = TraceSpool(str(tmp_path / "sp"), chunk_steps=4,
                           meta={"analyzer_kw": {"threshold_frac": 9.0}})
        for st in step_traces(trace)[:8]:
            spool.append(st)
        reader = SpooledTrace(str(tmp_path / "sp"))
        assert not reader.complete
        assert reader.meta == {"analyzer_kw": {"threshold_frac": 9.0}}
        online = Online(window_steps=4, persist=1)
        online.poll(reader)
        # absurd threshold from the provisional meta mutes everything,
        # proving the live analyzer was built from it
        assert len(online.log.windows) == 2
        assert online.onset("dissimilarity") is None
        # close() replaces the provisional meta with the definitive one
        for st in step_traces(trace)[8:]:
            spool.append(st)
        spool.close(meta={"collector": "synthetic", "final": True})
        reader.reload()
        assert reader.meta == {"collector": "synthetic", "final": True}

    def test_analyzer_kw_resolution_matches_header(self, tmp_path):
        """Header analyzer_kw is the default, explicit kwargs override —
        the same contract as ``cli.analyze_trace``."""
        _, tree, trace = drift_trace()
        trace.meta["analyzer_kw"] = {"threshold_frac": 9.0}  # absurd: mute
        online = Online(window_steps=4, persist=2)
        online.process_trace(trace)
        assert online.onset("dissimilarity") is None   # muted by header kw
        override = Online(window_steps=4, persist=2,
                                  analyzer_kw={"threshold_frac": 0.10})
        override.process_trace(trace)
        assert override.onset("dissimilarity") == 2


class TestCpuClockSelection:
    @pytest.fixture(autouse=True)
    def reset_cache(self):
        saved = TimedRegionRunner._cpu_clock
        TimedRegionRunner._cpu_clock = None
        yield
        TimedRegionRunner._cpu_clock = saved

    def test_thread_clock_needs_finer_tick_and_attribution(self, monkeypatch):
        import time as time_mod
        fake_thread = lambda: 0.0
        monkeypatch.setattr(time_mod, "clock_gettime",
                            lambda _id: fake_thread(), raising=False)
        monkeypatch.setattr(time_mod, "CLOCK_THREAD_CPUTIME_ID", 3,
                            raising=False)
        monkeypatch.setattr(time_mod, "clock_getres", lambda _id: 1e-9,
                            raising=False)
        monkeypatch.setattr(collector_mod, "_cpu_clock_tick", lambda: 0.01)
        ticks = {"thread": 1e-6}
        monkeypatch.setattr(collector_mod, "_measure_tick",
                            lambda clock, res: ticks["thread"])
        # finer AND attributable -> thread
        monkeypatch.setattr(collector_mod, "_thread_clock_attributes_torch",
                            lambda clock, tick: True)
        _, tick, name = collector_mod._pick_cpu_clock()
        assert (name, tick) == ("thread", 1e-6)
        # finer but NOT attributable (intra-op worker threads) -> process
        monkeypatch.setattr(collector_mod, "_thread_clock_attributes_torch",
                            lambda clock, tick: False)
        assert collector_mod._pick_cpu_clock()[2] == "process"
        # coarser-or-equal tick -> process without probing
        ticks["thread"] = 0.01
        monkeypatch.setattr(collector_mod, "_thread_clock_attributes_torch",
                            lambda clock, tick: pytest.fail("probed"))
        assert collector_mod._pick_cpu_clock()[2] == "process"

    def test_runner_records_chosen_clock(self, monkeypatch):
        """The selection lands in the trace header; the measured-tick
        fallback (None tick) keeps the advertised resolution and is not
        cached, so it is re-attempted next run."""
        import time as time_mod
        monkeypatch.setattr(
            collector_mod, "_pick_cpu_clock",
            lambda: (time_mod.process_time, None, "process"))
        from repro_torch.core import RegionTree
        tree = RegionTree("t")
        tree.add("r", fn=lambda s, d: s)
        runner = TimedRegionRunner(tree, warmup=0, repeats=1, device="cpu")
        trace = runner.run_trace([0.0], [0.0])
        assert trace.meta["cpu_clock"] == "process"
        assert trace.meta["cpu_tick"] == \
            time_mod.get_clock_info("process_time").resolution
        assert TimedRegionRunner._cpu_clock is None   # retried next time

    def test_ambient_selection_is_cached_and_sane(self):
        clock, tick, name = collector_mod._pick_cpu_clock()
        assert name in ("thread", "process")
        assert tick is None or tick > 0
        x = clock()
        assert isinstance(x, float)


class TestOnsetBisection:
    """Step-granular onset: with overlapping windows
    (stride < window_steps) the report bisects the onset *step* inside
    the first flagged window instead of reporting the window boundary."""

    @pytest.mark.parametrize("stride", [1, 2, 3])
    def test_refines_to_planted_step(self, stride):
        """Drift planted at step 8: tumbling windows can only say
        "window [8, 12)"; overlapping ones must pin the step to 8 (or 9 —
        a single drifting step may sit below the detection threshold)."""
        _, tree, trace = drift_trace()
        online = Online(tree=tree, window_steps=4, stride=stride,
                                persist=2)
        online.process_trace(trace)
        rep = online.onset_report("dissimilarity")
        assert rep is not None
        assert 8 <= rep["onset_step"] <= 9
        # the refined step stays inside the flagged window
        assert rep["window"][0] <= rep["onset_step"] < rep["window"][1]

    def test_tumbling_keeps_window_boundary(self):
        """No overlap, no refinement: the report's onset_step stays the
        window start (exactly what the log itself says)."""
        _, tree, trace = drift_trace()
        online = Online(tree=tree, window_steps=4, persist=2)
        online.process_trace(trace)
        rep = online.onset_report("dissimilarity")
        assert rep["onset_step"] == 8 == rep["window"][0]
        assert online.log.onset_report("dissimilarity")["onset_step"] == 8

    def test_spool_backed_bisection(self, tmp_path):
        """The refinement works identically when the source is a spool:
        the onset window is reassembled from its segments for the prefix
        re-analysis."""
        _, tree, trace = drift_trace()
        sp = spool_up(trace, str(tmp_path / "sp"), chunk_steps=3)
        online = Online(tree=tree, window_steps=4, stride=2,
                                persist=2)
        online.poll(sp)
        rep = online.onset_report("dissimilarity")
        assert rep is not None
        assert 8 <= rep["onset_step"] <= 9


# -- across packages --------------------------------------------------------


def _spool_files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_both_packages_write_the_same_spool_bytes(tmp_path, chunk):
    """Manifest (key order, digests) and every segment file are the same
    bytes whichever package wrote them — live and after close."""
    _, _, trace = drift_trace()
    ref_trace = RefTrace.load(trace.save(str(tmp_path / "t.npz")))
    port = TraceSpool(str(tmp_path / "port"), chunk_steps=chunk,
                      meta={"analyzer_kw": {"threshold_frac": 0.1}})
    ref = RefSpool(str(tmp_path / "ref"), chunk_steps=chunk,
                   meta={"analyzer_kw": {"threshold_frac": 0.1}})
    for s in range(trace.n_steps):
        port.append(trace.window(s, s + 1))
        ref.append(ref_trace.window(s, s + 1))
        if s == 7:
            assert _spool_files(tmp_path / "port") == \
                _spool_files(tmp_path / "ref")
    port.close(meta=dict(trace.meta))
    ref.close(meta=dict(ref_trace.meta))
    assert _spool_files(tmp_path / "port") == _spool_files(tmp_path / "ref")


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("seed", [0, 7])
def test_spool_tails_in_the_other_package(tmp_path, writer, seed):
    """A spool written by either package — tailed live, chunk by chunk —
    gives equal window verdicts in the port's OnlineAnalyzer (kernel lane
    on the host) and the reference's (exact numpy lane), the same onset,
    and a finalized artifact byte-identical to the monolithic save."""
    _, _, trace = drift_trace(seed)
    mono = trace.save(str(tmp_path / "mono.npz"))
    src = trace if writer == "port" else RefTrace.load(mono)
    d = str(tmp_path / "sp")
    spool = (TraceSpool if writer == "port" else RefSpool)(d, chunk_steps=3)
    port_online, ref_online = Online(window_steps=4), RefOnline(
        window_steps=4)
    port_reader = ref_reader = None
    got, want = [], []
    for s in range(src.n_steps):
        spool.append(src.window(s, s + 1))
        if s < 2:
            continue                        # nothing flushed yet
        port_reader = port_reader or SpooledTrace(d)
        ref_reader = ref_reader or RefSpooled(d)
        got += port_online.poll(port_reader)
        want += ref_online.poll(ref_reader)
    spool.close()
    got += port_online.poll(port_reader)
    want += ref_online.poll(ref_reader)
    assert [(w.start, w.stop) for w in got] == \
        [(w.start, w.stop) for w in want] == \
        [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert [w.verdict.doc() for w in got] == [w.verdict.doc() for w in want]
    assert port_online.onset() == ref_online.onset() == 2
    assert port_online.onset_report() == ref_online.onset_report()
    for i, reader in enumerate((SpooledTrace(d), RefSpooled(d))):
        fin = str(tmp_path / f"fin{i}.npz")
        reader.finalize(fin)
        with open(mono, "rb") as a, open(fin, "rb") as b:
            assert a.read() == b.read()


def test_online_analyzer_runs_on_the_card_or_raises():
    """The default lane is the seed-row kernel on the card: without one
    the analyzer refuses at construction; the exact lane needs none."""
    import torch
    if torch.cuda.is_available():
        assert OnlineAnalyzer().analyzer_kw == {}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OnlineAnalyzer()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OnlineAnalyzer(distance_backend="kernel")
    assert OnlineAnalyzer(distance_backend="numpy").analyzer_kw == \
        {"distance_backend": "numpy"}
    online = OnlineAnalyzer(analyzer_kw={"distance_backend": "numpy"},
                            device="cpu")
    assert online.analyzer_kw == {"distance_backend": "numpy",
                                  "device": "cpu"}


# -- the watch command --------------------------------------------------------


def _ref_watch():
    spec = importlib.util.spec_from_file_location(
        "ref_watch_train", ROOT / "scripts" / "watch_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


class TestWatchTraceCLI:
    def test_json_stream_and_finalize(self, tmp_path, capsys):
        from repro_torch.cli.watch_trace import main
        _, _, trace = drift_trace()
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=4)
        fin = str(tmp_path / "fin.npz")
        capsys.readouterr()
        assert main([d, "--window", "4", "--kind", "dissimilarity",
                     "--json", "--finalize", fin, "--device", "cpu"]) == 0
        out = capsys.readouterr()
        doc = json.loads(out.out)
        assert doc["complete"] and doc["n_steps"] == 16
        assert len(doc["windows"]) == 4
        assert doc["onset"]["onset_window"] == 2
        assert doc["onset"]["paths"] == ["ST/cr5"]
        # the live lines and the lane's counts go to stderr
        err = out.err.splitlines()
        assert [ln.split()[1] for ln in err[:4]] == ["0", "1", "2", "3"]
        lane = json.loads(err[4])["lane"]
        assert lane["launches"] == 0       # the plain version on the host
        assert set(lane["decisions"]) == {"flagged", "redecided",
                                          "redecide_s", "kmeans_redecided"}
        # finalized artifact byte-identical to the monolithic save
        mono = str(tmp_path / "mono.npz")
        trace.save(mono)
        with open(mono, "rb") as a, open(fin, "rb") as b:
            assert a.read() == b.read()

    @pytest.mark.parametrize("argv", [["--json"],
                                      ["--json", "--window", "3",
                                       "--stride", "2", "--persist", "1"],
                                      []])
    def test_output_equals_reference_script(self, tmp_path, capsys, argv):
        """Same flags, same document (or text lines) as the reference's
        ``scripts/watch_train.py`` on the same spool."""
        from repro_torch.cli.watch_trace import main
        _, _, trace = drift_trace(7)
        d = str(tmp_path / "sp")
        spool_up(trace, d, chunk_steps=5)
        outs = []
        for fn, lane in ((_ref_watch(), []), (main, ["--device", "cpu"])):
            capsys.readouterr()
            assert fn([d, *argv, *lane]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]

    def test_incomplete_spool_exits_nonzero(self, tmp_path, capsys):
        from repro_torch.cli.watch_trace import main
        _, _, trace = drift_trace()
        spool = TraceSpool(str(tmp_path / "sp"), chunk_steps=2)
        for st in step_traces(trace)[:6]:
            spool.append(st)
        capsys.readouterr()
        assert main([str(tmp_path / "sp"), "--device", "cpu"]) == 3
        assert "still in progress" in capsys.readouterr().err


# -- the serving engine's spool ------------------------------------------------


class StubBackend:
    """A deterministic serving backend: each step's samples are drawn from
    a generator seeded with the step, shaped by that step's events."""

    def __init__(self, lanes):
        from repro_torch.serve import serve_region_tree
        self.tree = serve_region_tree()
        self.region_ids = [r.region_id for r in self.tree.regions()]
        self.lanes = lanes

    def warmup(self):
        pass

    def execute(self, step, events):
        from repro_torch.core import CPU_TIME, FLOPS, WALL_TIME
        tr = RegionTrace.for_tree(self.tree, self.region_ids, self.lanes,
                                  meta={"collector": "serve",
                                        "cpu_tick": 0.01})
        rng = np.random.default_rng(step)
        busy = np.zeros(self.lanes)
        for ev in events:
            busy[ev.lane] = 1 + ev.prefill_tokens + ev.decode_tokens
        for rid in self.region_ids:
            t = busy * rng.uniform(1e-4, 2e-4, self.lanes)
            tr.metric(WALL_TIME)[0, 0, :, tr.col(rid)] = t
            tr.metric(CPU_TIME)[0, 0, :, tr.col(rid)] = t * 0.9
            tr.metric(FLOPS)[0, 0, :, tr.col(rid)] = busy * 1e6
        return tr


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_serving_spool_finalizes_to_the_in_memory_trace(tmp_path, chunk):
    """The engine spooling its steps finalizes to the very bytes of the
    same traffic's in-memory trace, and the spool's manifest tails."""
    from repro_torch.scenarios.traffic import TrafficConfig, generate_traffic
    from repro_torch.serve import ServeConfig, ServeEngine
    traffic = generate_traffic(TrafficConfig(
        n_requests=5, arrival_rate=2.0, length_buckets=(12,),
        length_mix=(1.0,), gen_len=4, vocab=64), seed=3)
    paths = {}
    for mode in ("memory", "spool"):
        paths[mode] = str(tmp_path / f"{mode}.npz")
        scfg = ServeConfig(lanes=2, max_len=20, prefill_chunk=4,
                           trace_path=paths[mode], trace_chunk_steps=chunk,
                           trace_spool_dir=(str(tmp_path / "sp")
                                            if mode == "spool" else None),
                           trace_meta={"analyzer_kw":
                                       {"threshold_frac": 0.2}})
        engine = ServeEngine(scfg, traffic, StubBackend(2))
        engine.run()
        assert engine.completed == 5
    with open(paths["memory"], "rb") as a, open(paths["spool"], "rb") as b:
        assert a.read() == b.read()
    sp = SpooledTrace(str(tmp_path / "sp"))
    assert sp.complete and sp.n_steps == engine.step_idx
    assert sp.n_segments == -(-engine.step_idx // chunk)
    # the reference tails the port's serving spool to the same verdicts
    got = Online(window_steps=4).poll(sp)
    want = RefOnline(window_steps=4).poll(RefSpooled(str(tmp_path / "sp")))
    assert [w.verdict.doc() for w in got] == [w.verdict.doc() for w in want]


def test_live_tail_phase_rehearsed(tmp_path):
    """chip_smoke's phase 11 at a small size on the host: the server (a
    CPU smoke rwkv6) spools its steps while a child process tails the
    spool with ``cli.watch_trace --follow``; the child's verdicts equal the
    exact lane's replay, and the finalized spool equals the served trace."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    argv = ("--arch", "rwkv6-3b", "--smoke", "--lanes", "2", "--requests",
            "6", "--prompt-len", "24", "--gen", "32", "--seed", "0")
    served = cs.serve_phase(argv, "cpu", spool_dir=str(tmp_path / "spool"),
                            watch_interval=0.05)
    live = served["live"]
    assert live["windows"] >= 3
    assert live["verdicts_equal"] and live["finalized_equal"]
    assert live["first_verdict_before_last_step_s"] > 0
    assert live["launches"] == 0          # the plain version on the host
    assert len(live["lags_s"]) == live["windows"]
    assert served["launches"] == {"rmsnorm": 0, "wkv6": 0}


def test_stream_fleet_phase_rehearsed(tmp_path):
    """chip_smoke's phase 13 at a small fleet shape on the host: the
    straggler's onset at step 2 is window 1 on both lanes, the windows'
    verdicts are equal, and the spool is deleted after."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    spool = tmp_path / "spool_fleet"
    res = cs.stream_fleet_phase(256, 32, 32, "cpu", spool_dir=spool)
    assert res["onset"] == 1
    assert res["kinds"] == [["disparity"], ["disparity", "dissimilarity"]]
    assert len(res["kernel_walls_s"]) == len(res["numpy_walls_s"]) == 2
    assert res["spool_bytes"] > 0 and not spool.exists()


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 7])
def test_online_kernel_lane_on_the_card(tmp_path, cuda, seed):
    """The default lane tails a spool on the card, launching the seed-row
    kernel, with the exact lane's window verdicts and onset."""
    from repro_torch import kernels as K
    _, _, trace = drift_trace(seed)
    sp = spool_up(trace, str(tmp_path / "sp"), chunk_steps=3)
    K.reset_launches()
    online = OnlineAnalyzer(window_steps=4)
    got = online.poll(sp)
    assert K.LAUNCHES["multi_seed_rows"] > 0
    want = OnlineAnalyzer(window_steps=4, distance_backend="numpy").poll(sp)
    assert [w.verdict.doc() for w in got] == [w.verdict.doc() for w in want]
    assert online.onset() == 2 and online.decisions is not None
