"""The port's serving path against the reference's.

Traffic and prompts are the same at seeds 0, 1 and 7; the scheduler emits
the same lane events; ``TorchBackend(device="cpu")`` and the reference's
``JitBackend`` on the same gemma-smoke weights (moved across through
numpy) generate the same tokens and the same trace layout — tree, region
ids, header keys, and the ``kv_append`` bytes and occupancy, which are
computed, not timed, and so equal exactly.  The saved serving trace loads
in both packages and gives the same verdict.  chip_smoke.py's phases 6–8
are rehearsed at a small size on the CPU.
"""
import dataclasses
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.core import AutoAnalyzer as RefAnalyzer
from repro.core import RegionTrace as RefTrace
from repro.models import build as ref_build
from repro.scenarios import traffic as ref_traffic
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import ServeScheduler as RefScheduler
from repro.serve.runtime import JitBackend
from repro_torch import kernels as K
from repro_torch.configs import get_arch
from repro_torch.core import (BYTES, VMEM_PRESSURE, AutoAnalyzer,
                              RegionTrace)
from repro_torch.models import build, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.scenarios import traffic
from repro_torch.serve import (ServeConfig, ServeEngine, ServeScheduler,
                               TorchBackend, call_costs)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEEDS = (0, 1, 7)
TRAFFIC = {
    "default": {},
    "bursty-hot-sessions": dict(n_requests=40, burstiness=0.4,
                                hot_fraction=0.3, sessions=3,
                                gen_jitter=2, vocab=1000),
    "one-bucket": dict(n_requests=8, length_buckets=(512,),
                       length_mix=(1.0,), gen_len=32, vocab=256000),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(TRAFFIC))
def test_traffic_and_prompts_equal_reference(kind, seed):
    kw = TRAFFIC[kind]
    want = ref_traffic.generate_traffic(ref_traffic.TrafficConfig(**kw), seed)
    got = traffic.generate_traffic(traffic.TrafficConfig(**kw), seed)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    vocab = kw.get("vocab", 256)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(
            traffic.prompt_tokens(a, vocab, seed),
            ref_traffic.prompt_tokens(b, vocab, seed))


def test_saturated_sessions_equal_reference():
    kw = dict(lanes=3, requests_per_lane=2, tail_lane=1, stagger=2,
              hot=True)
    assert [dataclasses.asdict(r) for r in traffic.saturated_sessions(**kw)] \
        == [dataclasses.asdict(r)
            for r in ref_traffic.saturated_sessions(**kw)]


def _event_key(ev):
    return (ev.lane, None if ev.request is None else ev.request.rid,
            ev.new_request, ev.prefill_tokens, ev.prefill_start,
            ev.decode_tokens, ev.decode_pos, ev.kv_tokens,
            ev.sample_tokens, ev.occupancy, ev.finished)


@pytest.mark.parametrize("seed", SEEDS)
def test_scheduler_events_equal_reference(seed):
    kw = TRAFFIC["bursty-hot-sessions"]
    want_tr = ref_traffic.generate_traffic(ref_traffic.TrafficConfig(**kw),
                                           seed)
    got_tr = traffic.generate_traffic(traffic.TrafficConfig(**kw), seed)
    ref_s = RefScheduler(want_tr, lanes=3, prefill_chunk=8, max_len=80)
    s = ServeScheduler(got_tr, lanes=3, prefill_chunk=8, max_len=80)
    step = 0
    while not ref_s.done:
        assert not s.done
        assert [_event_key(e) for e in s.step(step)] == \
            [_event_key(e) for e in ref_s.step(step)]
        step += 1
    assert s.done and s.completed == ref_s.completed == kw["n_requests"]
    assert {k: dataclasses.asdict(v) for k, v in s.records.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_s.records.items()}


def _served_pair(arch, lanes, requests, prompt_len, chunk, gen, seed=0):
    """The same traffic through the reference's JitBackend and the port's
    TorchBackend on the same smoke weights."""
    rcfg, cfg = ref_arch(arch).smoke, get_arch(arch).smoke
    api = ref_build(rcfg)
    params, _ = api.init(jax.random.key(seed))
    port_api = build(cfg, "cpu")
    model = transformer.Transformer(cfg, "cpu", seed=None)
    model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu"))
    tkw = dict(n_requests=requests, arrival_rate=2.0,
               length_buckets=(prompt_len,), length_mix=(1.0,),
               gen_len=gen, vocab=cfg.vocab)
    max_len = prompt_len + gen + 1
    ref_b = JitBackend(rcfg, api, params, lanes=lanes, max_len=max_len,
                       prefill_chunk=chunk, seed=seed)
    ref_e = RefServeEngine(
        RefServeConfig(lanes=lanes, max_len=max_len, prefill_chunk=chunk),
        ref_traffic.generate_traffic(ref_traffic.TrafficConfig(**tkw), seed),
        ref_b)
    ref_e.run()
    b = TorchBackend(cfg, port_api, model, lanes=lanes, max_len=max_len,
                     prefill_chunk=chunk, seed=seed)
    e = ServeEngine(
        ServeConfig(lanes=lanes, max_len=max_len, prefill_chunk=chunk),
        traffic.generate_traffic(traffic.TrafficConfig(**tkw), seed), b)
    e.run()
    return (ref_e, ref_b), (e, b)


@pytest.mark.parametrize("arch,prompt_len,chunk", [
    ("gemma-7b", 16, 8), ("h2o-danube-3-4b", 24, 8)])
def test_torch_backend_matches_jit_backend(arch, prompt_len, chunk):
    (ref_e, ref_b), (e, b) = _served_pair(arch, lanes=2, requests=3,
                                          prompt_len=prompt_len,
                                          chunk=chunk, gen=4)
    assert b.outputs == ref_b.outputs and len(b.outputs) == 3
    assert e.step_idx == ref_e.step_idx and e.completed == 3
    tr, ref_tr = e.trace, ref_e.trace
    assert [r.path for r in b.tree.regions()] == \
        [r.path for r in ref_b.tree.regions()]
    assert b.region_ids == ref_b.region_ids
    assert tr.region_ids == ref_tr.region_ids
    assert list(tr.meta) == list(ref_tr.meta)
    assert tr.meta["collector"] == "serve" and tr.meta["derived"] is True
    j = tr.col(b.tree.by_path("serve/kv_append").region_id)
    for metric in (BYTES, VMEM_PRESSURE):
        np.testing.assert_array_equal(tr.metric(metric)[..., j],
                                      ref_tr.metric(metric)[..., j])
    # The warmup makes one call per steady-state shape, then one model
    # call per prefill chunk and per decoded token.
    chunks = 3 * -(-prompt_len // chunk)
    assert b.model_calls == 2 + chunks + e.tokens_decode


def test_serve_trace_replays_in_both_packages(tmp_path):
    """The launcher's saved trace: the port's CLI analyzes it, and the
    reference loads it and reaches the same verdict."""
    from repro_torch.cli import analyze_trace
    from repro_torch.launch import serve
    path = str(tmp_path / "serve.npz")
    assert serve.main(["--arch", "gemma-7b", "--smoke", "--device", "cpu",
                       "--lanes", "2", "--requests", "3", "--prompt-len",
                       "16", "--gen", "4", "--trace", path]) == 0
    assert analyze_trace.main([path, "--device", "cpu", "--json"]) == 0
    trace, ref_trace = RegionTrace.load(path), RefTrace.load(path)
    assert trace.meta["requests_completed"] == 3
    got = AutoAnalyzer(trace.tree(), distance_backend="numpy") \
        .analyze_trace(trace)
    want = RefAnalyzer(ref_trace.tree()).analyze_trace(ref_trace)
    assert got.verdict.doc() == want.verdict.doc()


def test_call_costs_formula():
    """gemma smoke (L=2, d=64, H=KV=4, dh=16, ff=128, V=256, float32) at
    S=8 tokens over a 20-slot cache, counted by hand; the weight bytes the
    backend counts from the dense model equal 4 · param_count."""
    cfg = get_arch("gemma-7b").smoke
    proj = 64 * 64 + 2 * 64 * 64 + 64 * 64 + 3 * 64 * 128
    flops = 2 * 8 * 2 * proj + 4 * 8 * 20 * 64 * 2 + 2 * 8 * 64 * 256
    nbytes = (4 * cfg.param_count() + 2 * 2 * 20 * 64 * 4
              + 2 * 2 * 8 * 64 * 4 + 4 * 8 * 256)
    assert call_costs(cfg, 8, 20, 4 * cfg.param_count()) == \
        (float(flops), float(nbytes))
    assert cfg.param_count() == ref_arch("gemma-7b").smoke.param_count()
    backend = TorchBackend(cfg, build(cfg, "cpu"),
                           transformer.Transformer(cfg, "cpu", seed=0),
                           lanes=1, max_len=8, prefill_chunk=4)
    assert backend.weight_bytes == 4 * cfg.param_count()


# -- chip_smoke rehearsal ----------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_rmsnorm_cases_rehearsed_on_cpu():
    """Phase 6's RMSNorm cases: both served decode rows, the prefill chunk,
    a d that is not a multiple of 8 and an unaligned view, each on the
    path the plan picks; the offset view is contiguous and held to the
    plain version like the others."""
    cs = _chip_smoke()
    shapes = {(n, d): off for n, d, off in cs.RMS_SHAPES}
    assert {(1, 3072), (1, 2560), (256, 3072)} <= set(shapes)
    assert cs.RMS_RWKV == (1, 2560) and cs.RMS_RWKV in cs.RMS_TIMED
    assert any(d % 8 for d in (d for _, d in shapes))
    assert any(shapes.values())
    paths = {(n, d, off): cs.rmsnorm_plan_of(n, d, torch.bfloat16, off).path
             for n, d, off in cs.RMS_SHAPES}
    assert paths == {(1, 3072, 0): "row", (1, 2560, 0): "row",
                     (256, 3072, 0): "row", (300, 3840, 0): "row",
                     (3, 3004, 0): "scalar", (4, 2560, 1): "scalar",
                     (1, 2048, 0): "row", (256, 2048, 0): "row",
                     (1, 4096, 0): "row", (1, 1024, 0): "row",
                     (1024, 1024, 0): "row"}
    assert cs.rmsnorm_plan_of(3, 3004, torch.float32).path == "row"
    x, _ = cs.rmsnorm_inputs(4, 40, torch.bfloat16, "cpu", 1)
    assert x.shape == (4, 40) and x.is_contiguous() and x.data_ptr() % 16
    for n, d, off in ((1, 64, 0), (3, 44, 0), (4, 40, 1)):
        errs = cs.check_rmsnorm(n, d, "cpu", off)
        assert errs["f32"] == 0.0 and errs["bf16"] <= 3 * cs.BF16_TOL


def test_chip_smoke_kernel_phase_rehearsed_on_cpu():
    cs = _chip_smoke()
    for n, d in ((1, 64), (5, 96)):
        errs = cs.check_rmsnorm(n, d, "cpu")
        assert errs["f32"] == 0.0 and errs["bf16"] <= 3 * cs.BF16_TOL
    for name in cs.ATTN_CASES:
        errs = cs.check_attention(name, "cpu")
        assert errs["f32"] == 0.0 and errs["bf16"] <= cs.BF16_TOL
    # gemma decode: k and v of the 273 written slots of the 545-slot cache
    # dominate the bytes; the unwritten slots weigh 0 and are not read.
    ms, by = cs.attention_bound_ms("gemma-decode", 2)
    nbytes = 2 * (2 * 16 * 256 + 2 * 273 * 16 * 256) + 4 * 546
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12
    ms, by = cs.rmsnorm_bound_ms(256, 3072, 2)
    assert by == "bytes" and abs(ms - 3151872 / 3.35e12 * 1e3) < 1e-12
    c = cs.attention_case("danube-decode")
    assert c["k_pos"][904] == 5000 and c["k_pos"][905] == 905
    # The first prefill chunk: positions 0..255, slots 256..544 unwritten;
    # the bound counts only its live pairs (the causal triangle) and the k
    # and v of its 256 live keys.
    c = cs.attention_case("gemma-prefill-first")
    assert list(c["q_pos"][[0, -1]]) == [0, 255]
    assert (c["k_pos"][255], c["k_pos"][256]) == (255, cs.UNWRITTEN)
    ms, by = cs.attention_bound_ms("gemma-prefill-first", 2)
    nbytes = 2 * (2 * 256 * 16 * 256 + 2 * 256 * 16 * 256) + 4 * (256 + 545)
    ops = 4 * 256 * 16 * (256 * 257 // 2)
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12
    assert ops / 989e12 < nbytes / 3.35e12
    # The path each case takes on the card, chosen from shapes alone.
    assert {n: cs.attention_plan_of(n, torch.bfloat16).path
            for n in cs.ATTN_CASES} == {
        "gemma-decode": "split", "danube-decode": "split",
        "gemma-prefill": "wgmma", "gemma-prefill-first": "wgmma",
        "danube-prefill": "wgmma", "mla-decode": "split",
        "mla-prefill": "wgmma", "phi3v-decode": "split",
        "phi3v-prefill": "wgmma", "rgemma-decode": "wgmma",
        "seamless-encode": "wgmma", "seamless-cross": "split"}
    assert cs.attention_plan_of("danube-prefill", torch.float32).path == \
        "simt"


def test_chip_smoke_attention_bound_reads_needed_keys():
    cs = _chip_smoke()
    live = np.array([[True, False, False], [True, True, False]])
    assert cs.needed_keys(live) == 2
    # A query with no live key averages v over every key: all K are read.
    assert cs.needed_keys(np.array([[True, False, False],
                                    [False, False, False]])) == 3
    # gemma's second chunk reads the 512 written slots; danube's window
    # keeps every slot of its ring live.
    ms, by = cs.attention_bound_ms("gemma-prefill", 2)
    nbytes = 2 * (2 * 256 * 16 * 256 + 2 * 512 * 16 * 256) + 4 * (256 + 545)
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12
    ms, by = cs.attention_bound_ms("danube-decode", 2)
    nbytes = 2 * (2 * 32 * 120 + 2 * 4096 * 8 * 120) + 4 * (1 + 4096)
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12


@pytest.mark.parametrize("tick,sample_cpu,ok", [
    (0.01, 0.0, True),       # a 2.56 ms phase under a 10 ms tick: reduced
    (1e-6, 0.0, False),      # a fine clock: the raw reading must be > 0
    (None, 0.0, False),      # no tick recorded: raw
    (1e-6, 1e-5, True),
])
def test_chip_smoke_phase_times_read_raw_where_the_tick_allows(
        tick, sample_cpu, ok):
    from repro_torch.core import CPU_TIME, WALL_TIME, RegionTrace
    from repro_torch.serve.engine import serve_region_tree
    cs = _chip_smoke()
    tree = serve_region_tree()
    ids = [r.region_id for r in tree.regions()]
    trace = RegionTrace.for_tree(tree, ids, n_processes=2, n_steps=128,
                                 metrics=(WALL_TIME, CPU_TIME),
                                 meta={"cpu_tick": tick})
    trace.metric(WALL_TIME)[:] = 1e-5
    trace.metric(CPU_TIME)[:] = 1.0
    j = trace.col(tree.by_path("serve/sample").region_id)
    trace.metric(CPU_TIME)[..., j] = sample_cpu
    phases = ("prefill", "decode", "sample")
    if ok:
        cs.check_phase_times(trace, tree, phases)
    else:
        with pytest.raises(AssertionError, match="serve/sample is 0.0"):
            cs.check_phase_times(trace, tree, phases)
    # A phase long enough to span RAW_CPU_TICKS ticks is read raw.
    trace.metric(WALL_TIME)[..., j] = 1.0
    trace.metric(CPU_TIME)[..., j] = 0.0
    with pytest.raises(AssertionError, match="raw"):
        cs.check_phase_times(trace, tree, phases)


def test_chip_smoke_model_phases_rehearsed_on_cpu():
    cs = _chip_smoke()
    parity = cs.model_parity_phase(get_arch("gemma-7b").smoke, "cpu")
    assert parity["max_abs_err"] == 0.0 and len(parity["tokens"]) == 5
    assert cs.parity_config().n_layers == 2
    argv = ("--arch", "gemma-7b", "--smoke", "--lanes", "2", "--requests",
            "3", "--prompt-len", "16", "--chunk", "8", "--gen", "4")
    served = cs.serve_phase(argv, "cpu")
    assert served["summary"]["requests_completed"] == 3
    assert served["trace_shape"] == [12, 2, 4]
    assert served["model_calls"] == 2 + 6 + 12
    # On the CPU the wrappers run their plain versions: no launches.
    assert served["launches"] == {"rmsnorm": 0, "flash_attention": 0}
    json.dumps(served["verdict"])
    assert "--chunk" in cs.SERVE_ARGV and K.LAUNCHES["rmsnorm"] == 0
