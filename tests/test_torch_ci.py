"""The port's CI workflow (``.github/workflows/ci_torch.yml``) pinned
without running it: a ``torch-`` twin of every job of the reference's
``ci.yml``; every ``python -m repro_torch...`` command names a module
that exists, with flags its parser accepts, and passes ``--device cpu``
where its CLI takes ``--device``; only ``torch-tier1`` installs jax, and
torch comes from PyTorch's CPU wheel index."""
import importlib
import pathlib
import re
import shlex

import pytest
yaml = pytest.importorskip("yaml")
pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKFLOWS = ROOT / ".github" / "workflows"
CPU_INDEX = "https://download.pytorch.org/whl/cpu"


def _jobs(name):
    return yaml.safe_load((WORKFLOWS / name).read_text())["jobs"]


JOBS = _jobs("ci_torch.yml")


def _runs(job):
    return [s["run"] for s in JOBS[job]["steps"] if "run" in s]


def _lines(script):
    """The script's commands, one per logical line (continuations joined),
    each loop's body once for every value its ``for`` names."""
    lines = script.replace("\\\n", " ").splitlines()
    out, loop = [], None
    for line in (x.strip() for x in lines):
        m = re.match(r"for (\w+) in (.*); do$", line)
        if m:
            loop = (m.group(1), m.group(2).split())
        elif line == "done":
            loop = None
        elif line and loop:
            var, values = loop
            out += [line.replace(f'"${var}"', v) for v in values]
        elif line:
            out.append(line)
    return out


def _port_commands():
    """(job, module, argv) of every ``python -m repro_torch...`` command;
    a shell variable stands as its name, a pipe ends the command."""
    out = []
    for job in JOBS:
        for script in _runs(job):
            for line in _lines(script):
                words = shlex.split(line)
                if "-m" not in words:
                    continue
                module = words[words.index("-m") + 1]
                if not module.startswith("repro_torch."):
                    continue
                argv = words[words.index("-m") + 2:]
                if "|" in argv:
                    argv = argv[:argv.index("|")]
                out.append((job, module,
                            [re.sub(r"^\$(\w+)$", r"\1", a) for a in argv]))
    return out


COMMANDS = _port_commands()


def test_every_reference_job_has_a_torch_twin():
    ref = _jobs("ci.yml")
    assert set(JOBS) == {f"torch-{j}" for j in ref}
    for job, spec in JOBS.items():
        assert spec["runs-on"] == "ubuntu-latest", job
        assert 0 < spec["timeout-minutes"] <= 60, job
        python = [s["with"]["python-version"] for s in spec["steps"]
                  if s.get("uses", "").startswith("actions/setup-python")]
        assert python == ["3.12"], job


def test_the_gates_of_each_reference_job_are_there():
    """Each job drives the backends and lanes its reference twin does."""
    want = {
        "torch-tier1": {("run_corpus", "synthetic"), ("run_corpus", "train"),
                        ("run_corpus", "recovery"), ("snapshot_verdicts", None),
                        ("analyze_trace", None), ("watch_trace", None),
                        ("run_bench", None)},
        "torch-accelerated": {("snapshot_verdicts", "torch"),
                              ("snapshot_verdicts", "kernel"),
                              ("run_corpus", "synthetic")},
        "torch-chaos": {("run_corpus", "chaos")},
        "torch-fleet-chaos": {("run_corpus", "fleet")},
        "torch-serving": {("run_corpus", "serving")},
    }
    for job, gates in want.items():
        got = set()
        for j, module, argv in COMMANDS:
            if j != job:
                continue
            cli = module.rsplit(".", 1)[1]
            key = "--backend" if cli == "run_corpus" else \
                "--distance-backend"
            got.add((cli, argv[argv.index(key) + 1] if key in argv
                     else None))
        assert gates <= got, (job, sorted(gates - got))
    seeds = {j: sorted(int(a[a.index("--seed") + 1]) for _, _, a in
                       (c for c in COMMANDS if c[0] == j))
             for j in ("torch-chaos", "torch-fleet-chaos", "torch-serving")}
    assert all(s == [0, 1, 7] for s in seeds.values()), seeds
    bench = [a for j, m, a in COMMANDS if m.endswith("run_bench")]
    assert ["--factor", "3"] == bench[1][2:4], bench
    tier1 = " ".join(_runs("torch-tier1"))
    assert 'pytest -q' in tier1 and '-m "not slow" tests/test_torch_*.py' \
        in tier1
    assert "cmp spool-final.npz trace-artifacts/" \
        "train-fwdbwd-straggler-smoke.npz" in tier1


@pytest.mark.parametrize("job,module,argv", COMMANDS,
                         ids=[f"{j}:{m.rsplit('.', 1)[1]}:{i}"
                              for i, (j, m, _) in enumerate(COMMANDS)])
def test_each_command_parses_and_runs_on_the_cpu(job, module, argv):
    parser = importlib.import_module(module).build_parser()
    try:
        parser.parse_args(argv)
    except SystemExit as e:
        pytest.fail(f"{job}: python -m {module} {' '.join(argv)} "
                    f"does not parse (exit {e.code})")
    if "--device" in parser._option_string_actions:
        assert "--device" in argv and \
            argv[argv.index("--device") + 1] == "cpu", (job, module, argv)


def test_commands_name_files_that_exist():
    for job in JOBS:
        for script in _runs(job):
            for word in shlex.split(script.replace("\\\n", " ")):
                if word.startswith("tests/"):
                    assert list(ROOT.glob(word)), (job, word)
    assert (ROOT / "VERDICTS_synthetic.json").exists()


def test_only_torch_tier1_installs_jax():
    for job in JOBS:
        installs = [line for script in _runs(job)
                    for line in _lines(script) if "pip install" in line]
        assert any("--index-url \"$TORCH_INDEX\"" in line
                   and line.split()[2] == "torch" for line in installs), job
        jax = [line for line in installs if re.search(r"\bjax\b", line)]
        assert bool(jax) == (job == "torch-tier1"), (job, jax)
        xdist = any("pytest" in line and " -n " in line
                    for script in _runs(job) for line in _lines(script))
        assert xdist <= any("pytest-xdist" in line
                            for line in installs), job
    text = (WORKFLOWS / "ci_torch.yml").read_text()
    assert yaml.safe_load(text)["env"]["TORCH_INDEX"] == CPU_INDEX
