"""The port's framework-free core against the reference package: the
RegionTrace artifact crosses between ``repro`` and ``repro_torch`` byte for
byte, and the rough-set reducts are the reference's (including the port's
one change: clauses over distinct (row, decision) pairs).  Inputs are made
from seeded numpy; every comparison here is exact (no tolerance)."""
import itertools

import numpy as np
import pytest

from repro.core import roughset as ref_rs
from repro.core.trace import RegionTrace as RefTrace
from repro.scenarios import corpus as ref_corpus
pytest.importorskip("torch")
from repro_torch.core import roughset as port_rs
from repro_torch.core.trace import RegionTrace as PortTrace
from repro_torch.scenarios import corpus as port_corpus

ENTRIES = ["st/combined-straggler-io", "st/thermal-drift-onset",
           "moe/deepseek-expert-skew", "mpibzip2/comm-hotspot-cr7"]


def _same_metrics(a, b):
    assert a.region_ids == b.region_ids and a.n_processes == b.n_processes
    assert sorted(a.data) == sorted(b.data)
    for k in a.data:
        np.testing.assert_array_equal(a.data[k], b.data[k])


@pytest.mark.parametrize("name", ENTRIES)
def test_collected_traces_are_byte_identical(name, tmp_path):
    """Both packages collect the same samples from the same seed and save
    them to the same bytes."""
    _, ref_col = ref_corpus.CORPUS[name].build(3)
    _, port_col = port_corpus.CORPUS[name].build(3)
    ref_col.collect_trace().save(str(tmp_path / "ref.npz"))
    port_col.collect_trace().save(str(tmp_path / "port.npz"))
    assert (tmp_path / "ref.npz").read_bytes() == \
        (tmp_path / "port.npz").read_bytes()


@pytest.mark.parametrize("name", ENTRIES)
@pytest.mark.parametrize("direction", ["repro->port", "port->repro"])
def test_cross_package_save_load_reduce(name, direction, tmp_path):
    """A trace saved by one package loads in the other; reduce() (whole
    run and a window) is bitwise equal, and re-saving gives the same
    bytes."""
    writer, reader = ((RefTrace, PortTrace) if direction == "repro->port"
                      else (PortTrace, RefTrace))
    corpus = ref_corpus if writer is RefTrace else port_corpus
    _, col = corpus.CORPUS[name].build(0)
    src = col.collect_trace()
    path = str(tmp_path / "a.npz")
    src.save(path)
    back = reader.load(path)
    _same_metrics(src.reduce(), back.reduce())
    if src.n_steps > 1:
        _same_metrics(src.reduce(window=(1, None)),
                      back.reduce(window=(1, None)))
    assert back.schema == src.schema and back.meta == src.meta
    back.save(str(tmp_path / "b.npz"))
    assert (tmp_path / "a.npz").read_bytes() == \
        (tmp_path / "b.npz").read_bytes()


def test_damaged_artifact_raises_structured_error(tmp_path):
    from repro_torch.core import TraceFormatError
    path = tmp_path / "bad.npz"
    path.write_bytes(b"not a zip")
    with pytest.raises(TraceFormatError):
        PortTrace.load(str(path))
    with pytest.raises(FileNotFoundError):
        PortTrace.load(str(tmp_path / "absent.npz"))


@pytest.mark.parametrize("table", ["paper_table2", "paper_table3",
                                   "paper_table4"])
def test_paper_tables_match_reference(table):
    ref, port = getattr(ref_rs, table)(), getattr(port_rs, table)()
    assert port.reducts() == ref.reducts()
    assert port.core() == ref.core()
    assert port.discernibility_clauses() == ref.discernibility_clauses()
    for i in range(len(ref.rows)):
        assert set(port.object_clauses(i)) == set(ref.object_clauses(i))
        assert port.object_reducts(i) == ref.object_reducts(i)
    assert port_rs.format_matrix(port) == ref_rs.format_matrix(ref)


def test_paper_table_results():
    assert port_rs.paper_table2().reducts() == [
        frozenset({"a1", "a2"}), frozenset({"a1", "a3"})]
    assert port_rs.paper_table3().reducts() == [frozenset({"a5"})]
    assert port_rs.paper_table4().reducts() == [frozenset({"a2", "a3"})]


def _random_table(rng, n_objects, n_attrs, n_patterns, n_values):
    """Many objects drawn from few row patterns — the shape of the
    per-process dissimilarity table, where m shards fall into a handful of
    cluster-id patterns."""
    patterns = rng.integers(0, n_values, size=(n_patterns, n_attrs))
    pick = rng.integers(0, n_patterns, size=n_objects)
    rows = [tuple(int(v) for v in patterns[p]) for p in pick]
    # decisions mostly follow the pattern, with some inconsistent objects
    decisions = [int(p % 3) if rng.random() > 0.1 else int(rng.integers(3))
                 for p in pick]
    attrs = [f"a{i + 1}" for i in range(n_attrs)]
    return attrs, rows, decisions


@pytest.mark.parametrize("seed", range(8))
def test_deduplicated_clauses_equal_reference(seed):
    rng = np.random.default_rng(seed)
    attrs, rows, decisions = _random_table(
        rng, n_objects=int(rng.integers(20, 120)), n_attrs=5,
        n_patterns=int(rng.integers(2, 9)), n_values=3)
    ref = ref_rs.DecisionTable(attrs, rows, decisions)
    port = port_rs.DecisionTable(attrs, rows, decisions)
    assert port.discernibility_clauses() == ref.discernibility_clauses()
    assert port.reducts() == ref.reducts()
    for i in rng.choice(len(rows), size=10, replace=False):
        assert set(port.object_clauses(int(i))) == \
            set(ref.object_clauses(int(i)))
        assert port.object_reducts(int(i)) == ref.object_reducts(int(i))


def test_dedup_matches_brute_force_on_tiny_tables():
    """Exhaustive over every 4-object table of binary 2-attribute rows
    and binary decisions."""
    attrs = ["a1", "a2"]
    vals = list(itertools.product((0, 1), repeat=2))
    for rows in itertools.product(vals, repeat=4):
        for decisions in itertools.product((0, 1), repeat=4):
            ref = ref_rs.DecisionTable(attrs, list(rows), list(decisions))
            port = port_rs.DecisionTable(attrs, list(rows), list(decisions))
            assert port.discernibility_clauses() == \
                ref.discernibility_clauses()
            assert set(port.object_clauses(0)) == set(ref.object_clauses(0))
