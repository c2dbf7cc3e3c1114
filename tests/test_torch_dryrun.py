"""The port's dry-run (``repro_torch.launch.dryrun``) on a (2, 4) fake
mesh, against the reference's (``repro.launch.dryrun``) on 8 fake
devices, for the reference test's cells (``tests/test_dryrun_small.py``:
chatglm3-6b, mixtral-8x22b, rwkv6-3b and recurrentgemma-9b smoke, float32,
``t_train`` = 128 x 8, ``t_dec`` = 128 x 8).

Both sides run in subprocesses: the port's joins a fake 8-rank world, the
reference's sets ``XLA_FLAGS``; the test process keeps no process group.

FLOPs ratios.  The two counts differ by design: the port counts matrix
products (``torch.utils.flop_counter``), its elementwise operations as
XLA's cost analysis counts them (``core.hlo.elementwise_flops``) and its
kernels' analytic work, every layer, the remat recompute as it runs and
the attention backward's plain formulas; XLA fuses, and its chunked
attention and MoE dispatch are other programs.  Both counts are
deterministic, so each cell's ratio (the port's per-rank FLOPs over the
reference's, measured on these cells, the training cells under sequence
parallelism on both sides) is pinned within 15%: a count that lost the
backward, a layer or a kernel's work moves its ratio out.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


# Children of these tests (reference compiles, gloo ranks) run below the
# test process's priority, so they take only the CPU that the
# timing-gated tests running beside them in a parallel run leave.
NICE = ("nice", "-n", "10")


def _background():
    os.nice(10)


ARCHS = ("chatglm3-6b", "mixtral-8x22b", "rwkv6-3b", "recurrentgemma-9b")
# (train, decode): the port's FLOPs over the reference's on each cell
RATIOS = {"chatglm3-6b": (1.013, 1.128), "mixtral-8x22b": (0.971, 1.017),
          "rwkv6-3b": (0.743, 1.036), "recurrentgemma-9b": (0.954, 0.547)}
RATIO_TOL = 0.15

_PORT = r"""
import json, sys
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch import dryrun
import repro_torch.configs.base as base
from repro_torch.configs import get_arch
fake_world(8)
mesh = make_mesh((2, 4), ("data", "model"))
base.SHAPES["t_train"] = base.InputShape("t_train", 128, 8, "train")
base.SHAPES["t_dec"] = base.InputShape("t_dec", 128, 8, "decode")
arch = sys.argv[1]
cfg = get_arch(arch).smoke.with_(dtype="float32", param_dtype="float32")
r = dryrun.run_cell(arch, "t_train", cfg_override=cfg, mesh=mesh)
d = dryrun.run_cell(arch, "t_dec", cfg_override=cfg, mesh=mesh,
                    probes=False)
print("RESULT" + json.dumps({"train": r, "dec": d,
                             "depth": dryrun._depth_units(cfg)}))
"""

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
from repro.launch.mesh import make_mesh
from repro.launch import dryrun
import repro.configs.base as base
from repro.configs import get_arch
mesh = make_mesh((2, 4), ("data", "model"))
base.SHAPES["t_train"] = base.InputShape("t_train", 128, 8, "train")
base.SHAPES["t_dec"] = base.InputShape("t_dec", 128, 8, "decode")
arch = sys.argv[1]
cfg = get_arch(arch).smoke.with_(dtype="float32", param_dtype="float32")
r = dryrun.run_cell(arch, "t_train", cfg_override=cfg, mesh=mesh)
d = dryrun.run_cell(arch, "t_dec", cfg_override=cfg, mesh=mesh)
print("RESULT" + json.dumps({"train": r["cost"], "dec": d["cost"],
                             "mem": r["memory"]}))
"""


def _run(script, arch, extra_env):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra_env)
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([*NICE, sys.executable, "-c", script, arch],
                       capture_output=True, text=True, env=env, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [l for l in p.stdout.splitlines() if l.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("arch", ARCHS)
def test_small_cell_against_the_reference(arch):
    """(h) The L=1,2 extrapolation equals the full-depth count (a
    one-block hybrid, depth 1, takes the larger probe by the reference's
    clamp); collectives cross the (2, 4) mesh; FLOPs within 15% of the
    pinned ratio to the reference's; the reference's JSON keys; the
    argument bytes are the reference's but for the int64 tokens and
    labels."""
    ours = _run(_PORT, arch, {})
    ref = _run(_REF, arch, {"JAX_PLATFORMS": "cpu"})
    train, dec = ours["train"], ours["dec"]
    raw, ext = train["production_cost_raw"], train["cost"]
    for k in ("flops", "bytes", "collective_bytes"):
        if ours["depth"] >= 2:
            assert ext[k] == raw[k], k
        else:
            assert ext[k] >= raw[k], k
    assert ext["collective_bytes"] > 0
    assert dec["production_cost_raw"]["collective_bytes"] > 0
    for got, want, pin in ((ext["flops"], ref["train"]["flops"],
                            RATIOS[arch][0]),
                           (dec["production_cost_raw"]["flops"],
                            ref["dec"]["flops"], RATIOS[arch][1])):
        assert abs(got / want / pin - 1) <= RATIO_TOL, (arch, got, want)
    assert set(train) >= {"production_cost_raw", "cost", "roofline",
                          "memory", "params_b", "active_params_b"}
    assert set(train["memory"]) == {"argument_size_in_bytes",
                                    "output_size_in_bytes",
                                    "temp_size_in_bytes"}
    assert set(dec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes"}
    token_bytes = 2 * (8 // 2) * 128 * 4      # int64 over int32, per rank
    assert train["memory"]["argument_size_in_bytes"] == \
        ref["mem"]["argument_size_in_bytes"] + token_bytes
    assert train["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")


def test_run_cell_takes_the_references_parameters():
    """``run_cell`` takes the reference's keywords with its defaults,
    ``sp=True`` among them (used for training cells only)."""
    import inspect
    from repro.launch import dryrun as ref
    from repro_torch.launch import dryrun
    want = inspect.signature(ref.run_cell).parameters
    got = inspect.signature(dryrun.run_cell).parameters
    assert list(got) == list(want)
    assert {k: p.default for k, p in got.items()} == \
        {k: p.default for k, p in want.items()}
    assert got["sp"].default is True


def test_helpers_equal_the_references():
    """``_extrapolate`` and ``iter_cells`` are the reference's; the probe
    configs keep the depth units."""
    import numpy as np
    from repro.launch import dryrun as ref
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    rng = np.random.default_rng(0)
    for _ in range(5):
        c1, c2 = ({k: float(v) for k, v in zip(
            ("flops", "bytes", "collective_bytes"), rng.random(3) * 100)}
            for _ in range(2))
        for c in (c1, c2):
            c["coll_by_op"] = {"all-gather": float(rng.random())}
            c["coll_counts"] = {"all-gather": float(rng.integers(5))}
        depth = float(rng.integers(1, 90))
        assert dryrun._extrapolate(c1, c2, depth) == \
            ref._extrapolate(c1, c2, depth)
    assert list(dryrun.iter_cells()) == list(ref.iter_cells())
    for arch in ("recurrentgemma-9b", "seamless-m4t-medium", "gemma-7b"):
        cfg = get_arch(arch).full
        p = dryrun._probe_cfg(cfg, 2)
        assert dryrun._depth_units(p) == 2.0
        assert dryrun._depth_units(cfg) > 2


def test_cli_runs_a_production_cell_on_the_host(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on a host with no card: a
    full-width decode cell on the (16, 16) mesh of a fake 256-rank world,
    with the reference's JSON keys."""
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([*NICE, sys.executable, "-m",
                        "repro_torch.launch.dryrun",
                        "--arch", "gemma-7b", "--shape", "decode_32k",
                        "--no-probes", "--out", str(out)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    (r,) = json.loads(out.read_text())
    assert r["ok"] and r["mesh"] == "16x16" and r["chips"] == 256
    assert {"production_cost_raw", "memory", "params_b", "active_params_b",
            "ok", "wall_s"} <= set(r)
    assert r["production_cost_raw"]["collective_bytes"] > 0
    # a rank holds 1/256 of the bf16 KV cache (batch over data, kv heads
    # over model) and of the weights (decode rules)
    cache = 28 * 128 * 32768 * 16 * 256 * 2 * 2
    want = (cache + r["params_b"] * 1e9 * 2) / 256
    assert abs(r["memory"]["argument_size_in_bytes"] / want - 1) < 0.02


def test_kernels_on_meta_return_shapes_and_count_their_work():
    """On ``meta`` each kernel wrapper returns its output's shape and its
    call counts the kernel's analytic work, as on the card; attention's
    live pairs on meta positions are those of consecutive positions."""
    import torch
    from repro_torch.core.hlo import cost_of
    from repro_torch.kernels import (flash_attention, multi_seed_rows,
                                     rmsnorm, wkv6)
    from repro_torch.kernels.distance import seed_rows_work
    from repro_torch.kernels.flash_attention import (attention_work,
                                                     live_mask, needed_keys)
    from repro_torch.kernels.rmsnorm import rmsnorm_work
    from repro_torch.kernels.wkv6 import wkv6_work
    m = torch.device("meta")
    x, w = torch.empty(6, 32, device=m), torch.empty(32, device=m)
    assert rmsnorm(x, w, 1e-6).shape == (6, 32)
    assert cost_of(rmsnorm, x, w, 1e-6) == rmsnorm_work(6, 32, 4)
    q = torch.empty(2, 5, 4, 8, device=m)
    k = torch.empty(2, 9, 2, 8, device=m)
    pos = torch.empty(5, dtype=torch.int32, device=m)
    kpos = torch.empty(9, dtype=torch.int32, device=m)
    assert flash_attention(q, k, k, pos, kpos, window=3).shape == q.shape
    kp = torch.arange(9, dtype=torch.int32)
    live = live_mask(kp[4:], kp, True, 3)
    assert cost_of(lambda: flash_attention(q, k, k, pos, kpos, window=3)) \
        == attention_work(2, 5, 4, 2, 8, 9, 4, int(live.sum()),
                          needed_keys(live))
    r = torch.empty(2, 3, 4, 8, device=m)
    u, S = torch.empty(4, 8, device=m), torch.empty(2, 4, 8, 8, device=m)
    assert wkv6(r, r, r, r, u, S).shape == r.shape
    assert cost_of(wkv6, r, r, r, r, u, S) == wkv6_work(2, 3, 4, 8, 4)
    pts, sq = torch.empty(7, 3, device=m), torch.empty(7, device=m)
    idx = torch.empty(2, dtype=torch.int32, device=m)
    assert multi_seed_rows(pts, sq, idx).shape == (2, 7)
    assert cost_of(multi_seed_rows, pts, sq, idx) == seed_rows_work(7, 3, 2)


_TRIAGE = r"""
from repro_torch.examples import dryrun_triage
dryrun_triage.main(["--device", "cpu"])
"""


def test_roofline_report_render_and_triage(tmp_path):
    """``bench.run --only roofline`` and ``cli.render_experiments`` read
    the port's dry-run JSONs; ``examples.dryrun_triage`` prints the
    disparity triage of a (2, 4) cell."""
    import contextlib
    import io
    from repro_torch.bench import roofline_report, run
    from repro_torch.cli import render_experiments
    cell = {"arch": "gemma-7b", "shape": "train_4k", "mesh": "16x16",
            "ok": True, "count_s": 1.5, "model_flops": 1e18,
            "memory": {"argument_size_in_bytes": 2e9,
                       "temp_size_in_bytes": 3e9},
            "production_cost_raw": {"coll_counts": {"all-gather": 3}},
            "roofline": {"compute_s": 1.0, "memory_s": 2.0,
                         "collective_s": 0.5, "dominant": "memory",
                         "useful_ratio": 0.4, "roofline_fraction": 0.5,
                         "bound_s": 2.0}}
    path = tmp_path / "single_pod.json"
    path.write_text(json.dumps([cell, {"arch": "x", "shape": "y",
                                       "ok": False, "error": "E: boom"}]))
    rows = roofline_report.all_rows(str(tmp_path / "*.json"))
    assert rows == [("roofline_gemma-7b_train_4k", 2e6,
                     "mesh=16x16;dominant=memory;compute_s=1.000e+00;"
                     "memory_s=2.000e+00;collective_s=5.000e-01;"
                     "useful=0.400;roofline=50.0%")]
    assert roofline_report.all_rows(str(tmp_path / "none*.json"))[0][0] \
        == "roofline_summary"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run.main(["--only", "roofline", "--results",
                         str(tmp_path / "*.json")]) == 0
    assert buf.getvalue().splitlines()[1].startswith(
        "roofline_gemma-7b_train_4k,2000000.0,")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        render_experiments.main(["--single", str(path), "--multi",
                                 str(tmp_path / "missing.json")])
    text = buf.getvalue()
    assert "| gemma-7b | train_4k | 16x16 | yes | 1.5 | 2.0 | 3.0 | " \
           "gat:3 |" in text
    assert "**FAIL**" in text and "**memory**" in text
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([*NICE, sys.executable, "-c", _TRIAGE],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "AutoAnalyzer disparity triage — chatglm3-smoke" in p.stdout
    assert "CCR:" in p.stdout


def test_cell_report_and_table():
    """``analyze_cell`` turns a cell's per-rank cost into the reference's
    report fields on the H100 spec, ``format_table`` prints it, and
    ``model_flops_for`` is the reference's."""
    import types
    from repro.configs import SHAPES as REF_SHAPES
    from repro.launch import roofline as ref_rl
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.core.hlo import H100_SXM
    from repro_torch.launch import roofline as rl
    mesh = types.SimpleNamespace(shape=(16, 16), size=lambda: 256)
    cost = {"flops": 989e12, "bytes": 3.35e12 / 2, "collective_bytes": 4.5e9,
            "coll_by_op": {"all-gather": 4.5e9},
            "coll_counts": {"all-gather": 7}}
    r = rl.analyze_cell("gemma-7b", "train_4k", mesh, cost,
                        {"argument_size_in_bytes": 1.0}, 256 * 494.5e12,
                        count_s=2.0)
    assert r.mesh == "16x16" and r.chips == 256
    assert r.terms == {"compute_s": 1.0, "memory_s": 0.5,
                       "collective_s": 0.01}
    assert r.dominant == "compute" and r.useful_ratio == 0.5
    assert r.to_json()["collective_counts"] == {"all-gather": 7}
    table = rl.format_table([r])
    assert "gemma-7b" in table and "compute" in table and "100.0%" in table
    assert H100_SXM.peak_flops == 989e12
    cfg = get_arch("gemma-7b").full
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        assert rl.model_flops_for(cfg, SHAPES[name], 10, 7) == \
            ref_rl.model_flops_for(None, REF_SHAPES[name], 10, 7)
