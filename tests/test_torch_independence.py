"""The PyTorch port stands alone: every module of ``repro_torch`` (and
``chip_smoke.py``) imports with ``jax`` and the reference package ``repro``
blocked, and nothing builds or loads a kernel at import time."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None           # any "import jax" now raises
sys.modules["repro"] = None         # ... and so does "import repro.*"
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch."))
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
from repro_torch.kernels import build
assert not build._LOADED, "a kernel was loaded at import time"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print(" ".join(names))
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    # core (12), kernels (5), configs (12), scenarios (7), cli (3),
    # models (8), serve (3), launch (2), device (1), the package itself ...
    *_, names, count = out.stdout.strip().splitlines()
    assert int(count) >= 45
    for name in ("models.rglru", "models.encdec", "configs.phi3_vision_4_2b",
                 "configs.recurrentgemma_9b", "configs.seamless_m4t_medium",
                 "data.pipeline"):
        assert f"repro_torch.{name}" in names.split(), name


def test_no_source_mentions_jax_imports():
    """A cheaper, import-free guard: no port source file imports jax or
    the reference package (the subprocess probe above proves it at run
    time; this catches an import hidden in a function body)."""
    offenders = []
    for path in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
                 ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path}: {line.strip()}")
    assert not offenders, offenders


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA, chip_smoke exits non-zero and prints no result; run
    from a directory that holds only chip_smoke.py it fails too."""
    import torch
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                           capture_output=True, text=True, env=env,
                           timeout=120)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
            capture_output=True, text=True, env=env, timeout=120))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
