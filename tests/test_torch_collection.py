"""Fault 6's pin: the reference's CI tier-1 lane runs without torch
(``.github/workflows/ci.yml``: numpy, jax, pytest, hypothesis).  There
the port's test files must skip at collection and not stop it.  This file
needs no torch itself."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
NICE = ("nice", "-n", "10")


def _port_test_files():
    return sorted((ROOT / "tests").glob("test_torch_*.py"))


def test_collection_without_torch_exits_0(tmp_path):
    """``pytest --collect-only -q -m "not slow" tests`` in a child where
    ``import torch`` raises (a package named torch earlier on the path):
    rc 0, no collection error."""
    shadow = tmp_path / "torch"
    shadow.mkdir()
    (shadow / "__init__.py").write_text(
        'raise ModuleNotFoundError("No module named \'torch\'", '
        'name="torch")\n')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT / "src")]))
    p = subprocess.run([*NICE, sys.executable, "-m", "pytest",
                        "--collect-only", "-q", "-m", "not slow",
                        "-p", "no:cacheprovider", "tests"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    tail = p.stdout[-3000:] + p.stderr[-3000:]
    assert p.returncode == 0, tail
    assert "error" not in p.stdout.splitlines()[-1].lower(), tail
    assert "test_torch_" not in p.stdout.replace(
        "test_torch_collection.py", ""), tail


def test_every_port_file_skips_without_torch_before_importing_it():
    """Each ``tests/test_torch_*.py`` but this one calls
    ``pytest.importorskip("torch")`` at module level, before any
    module-level import of torch or ``repro_torch``, so that with torch
    present it collects the same items as before."""
    for path in _port_test_files():
        if path.name == pathlib.Path(__file__).name:
            continue
        body = ast.parse(path.read_text()).body
        skip = next((n.lineno for n in body if isinstance(n, ast.Expr)
                     and ast.unparse(n.value)
                     == "pytest.importorskip('torch')"), None)
        assert skip is not None, path.name
        for n in body:
            names = ([a.name for a in n.names] if isinstance(n, ast.Import)
                     else [n.module or ""] if isinstance(n, ast.ImportFrom)
                     else [])
            if any(m.split(".")[0] in ("torch", "repro_torch")
                   for m in names):
                assert n.lineno > skip, (path.name, n.lineno)
