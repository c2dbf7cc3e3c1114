"""Fault 7's pin: the port's static analyzer
(``repro_torch.launch.static_analyzer.analyze_train_cell``) names the
reference's CCRs and root causes on the reference test's cell.

Each arch's smoke config in float32, ``InputShape("t", 256, 8, "train")``
on a (2, 4) ``("data", "model")`` mesh: the reference in a subprocess on 8
forced XLA host devices, the port in another on a fake 8-rank world with
the reference's hardware numbers (``HardwareSpec(**asdict(TPU_V5E))``),
so hardware is not what differs.  Both children start together, below the
test process's priority.  The two packages count the regions' costs their
own ways (XLA's compiled module against the port's counted dispatch); the
test holds the verdicts equal, and on chatglm3-6b each region's counts
near the reference's.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
NICE = ("nice", "-n", "10")
ARCHS = ("chatglm3-6b", "gemma-7b", "mixtral-8x22b", "deepseek-v2-lite-16b")

_COMMON = r"""
import json, sys
arch = sys.argv[1]
shape = base.InputShape("t", 256, 8, "train")
cfg = get_arch(arch).smoke.with_(dtype="float32", param_dtype="float32")
tree, rm, res = analyze_train_cell(cfg, shape, mesh, **kw)
regions = {}
for r in res.disparity.severities:
    regions[tree[r].name] = {m: float(rm.metric(m)[:, rm.col(r)].max())
                             for m in (FLOPS, BYTES, COMM_BYTES)}
print("RESULT" + json.dumps({
    "ccrs": sorted(tree[r].name for r in res.disparity.ccrs),
    "causes": sorted(set().union(*res.disparity_causes)),
    "severities": {tree[r].name: int(s)
                   for r, s in res.disparity.severities.items()},
    "regions": regions}))
"""

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.launch.mesh import make_mesh
from repro.launch.static_analyzer import analyze_train_cell
from repro.configs import get_arch
import repro.configs.base as base
from repro.core import BYTES, COMM_BYTES, FLOPS
mesh = make_mesh((2, 4), ("data", "model"))
kw = {}
""" + _COMMON

_PORT = r"""
import dataclasses, json, sys
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.static_analyzer import analyze_train_cell
from repro_torch.configs import get_arch
import repro_torch.configs.base as base
from repro_torch.core import BYTES, COMM_BYTES, FLOPS
from repro_torch.core.hlo import HardwareSpec
fake_world(8)
mesh = make_mesh((2, 4), ("data", "model"))
kw = {"hw": HardwareSpec(**json.loads(sys.argv[2])), "device": "cpu"}
""" + _COMMON


def _start(script, args, extra_env):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra_env)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([*NICE, sys.executable, "-c", script, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _result(proc):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    line = [l for l in out.splitlines() if l.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("arch", ARCHS)
def test_static_analyzer_gives_the_references_verdict(arch):
    """Equal CCR names and equal root-cause sets; on chatglm3-6b no
    region counts 0 FLOPs where the reference's counts more, and each
    region's ``COMM_BYTES`` is within a factor of 2 of the reference's
    (before: 0.18x to 10.8x)."""
    from repro.core.hlo import TPU_V5E
    hw = json.dumps(dataclasses.asdict(TPU_V5E))
    ref_p = _start(_REF, [arch], {"JAX_PLATFORMS": "cpu"})
    port_p = _start(_PORT, [arch, hw], {})
    ref, port = _result(ref_p), _result(port_p)
    assert port["ccrs"] == ref["ccrs"], (port, ref)
    assert port["causes"] == ref["causes"], (port, ref)
    assert set(port["regions"]) == set(ref["regions"])
    if arch != "chatglm3-6b":
        return
    for name, want in ref["regions"].items():
        got = port["regions"][name]
        assert got["flops"] > 0 or want["flops"] == 0, name
        ratio = got["comm_bytes"] / want["comm_bytes"]
        assert 0.5 <= ratio <= 2.0, (name, ratio)
