"""The paper's disparity analysis over a dry-run cell
(``repro_torch.launch.static_analyzer``), the twin of
``tests/test_static_analyzer.py``: chatglm3-6b smoke on a (2, 4) fake
mesh in a subprocess that joins a fake 8-rank world."""
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


# Children of these tests (reference compiles, gloo ranks) run below the
# test process's priority, so they take only the CPU that the
# timing-gated tests running beside them in a parallel run leave.
NICE = ("nice", "-n", "10")


def _background():
    os.nice(10)


SCRIPT = r"""
import json
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.static_analyzer import analyze_train_cell, report_cell
from repro_torch.configs import get_arch
import repro_torch.configs.base as base
fake_world(8)
mesh = make_mesh((2, 4), ("data", "model"))
shape = base.InputShape("t", 256, 8, "train")
cfg = get_arch("chatglm3-6b").smoke.with_(dtype="float32",
                                          param_dtype="float32")
tree, rm, res = analyze_train_cell(cfg, shape, mesh, device="cpu")
sev = {tree[r].name: s for r, s in res.disparity.severities.items()}
ccrs = [tree[r].name for r in res.disparity.ccrs]
causes = sorted(res.disparity_causes[0]) if res.disparity_causes else []
text = report_cell(cfg, shape, mesh, device="cpu")
from repro_torch.core import COMM_BYTES, FLOPS
comm = {tree[r].name: float(rm.metric(COMM_BYTES)[:, rm.col(r)].max())
        for r in res.disparity.severities}
print("RESULT" + json.dumps({"sev": sev, "ccrs": ccrs, "causes": causes,
                             "comm": comm, "report": text}))
"""


def test_disparity_triage_on_dryrun_cell():
    """(i) Every step phase is banded, at least one CCR is located with a
    named root cause, and collectives cross the mesh."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([*NICE, sys.executable, "-c", SCRIPT],
                       capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [l for l in p.stdout.splitlines() if l.startswith("RESULT")][-1]
    out = json.loads(line[len("RESULT"):])
    assert set(out["sev"]) == {"embed", "attention", "mlp", "head_loss",
                               "optimizer"}
    assert out["ccrs"], out
    assert out["causes"], out
    assert out["comm"]["attention"] > 0 and out["comm"]["mlp"] > 0
    assert "disparity" in out["report"].lower()


def test_multipliers_are_the_references():
    from repro.launch import static_analyzer as ref
    from repro_torch.launch import static_analyzer
    assert static_analyzer.TRAIN_MULTIPLIER == ref.TRAIN_MULTIPLIER
