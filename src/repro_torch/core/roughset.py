"""Rough-set root-cause analysis (paper §4.4).

Implements decision systems, the decision-relative discernibility matrix
(Eq. 3), the discernibility function (Eq. 4), and the extraction of core
attributes / reducts.  The paper's "core attributions" are the minimal
conjunctive attribute sets shared by the discernibility functions — i.e. the
*minimal reducts* (prime implicants of the CNF discernibility function); we
expose both those and the classical core (intersection of all reducts).

Worked examples from the paper are unit-tested:
  * Table 2  -> reducts {a1,a2} and {a1,a3}
  * Table 3  -> unique reduct {a5}     (ST dissimilarity)
  * Table 4  -> unique reduct {a2,a3}  (ST disparity)
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

# The reduct search enumerates attribute subsets by size — O(2^|A|) in the
# worst case.  The paper's decision tables have 5 attributes; anything past
# this bound is a modelling error, not a bigger search.
MAX_EXHAUSTIVE_ATTRIBUTES = 20


def _minimal_hitting_sets(
        clauses: Sequence[FrozenSet[str]]) -> List[FrozenSet[str]]:
    """All minimum-size hitting sets of ``clauses`` (the search stops at
    the first productive size: larger hitting sets are either supersets of
    a found one or outside the paper's 'core attributions' notion).

    Pruning that provably cannot change the result: any hitting set must
    contain every attribute that appears as a singleton clause
    (``forced``), so candidates missing one — and sizes below
    ``len(forced)`` — are skipped before the clause scan.
    """
    attrs = sorted({a for c in clauses for a in c})
    if len(attrs) > MAX_EXHAUSTIVE_ATTRIBUTES:
        raise ValueError(
            f"reduct search over {len(attrs)} attributes exceeds the "
            f"exhaustive-search bound ({MAX_EXHAUSTIVE_ATTRIBUTES}); "
            "decision tables are expected to stay near the paper's 5 "
            "attributes — reduce the attribute set or use a heuristic "
            "reducer")
    forced = frozenset(a for c in clauses if len(c) == 1 for a in c)
    hits: List[FrozenSet[str]] = []
    for size in range(max(1, len(forced)), len(attrs) + 1):
        for combo in itertools.combinations(attrs, size):
            s = frozenset(combo)
            if not forced <= s:
                continue  # misses a singleton clause
            if all(s & c for c in clauses):
                hits.append(s)
        if hits:
            break  # all minimum-size hitting sets found
    return hits


@dataclasses.dataclass
class DecisionTable:
    """A decision system Λ = (U, A ∪ {d}).

    ``rows[i]`` holds the conditional attribute values of object i;
    ``decisions[i]`` its decision value.  Values may be any hashable.
    """

    attributes: List[str]
    rows: List[Tuple]
    decisions: List
    object_ids: Optional[List] = None

    def __post_init__(self) -> None:
        if self.object_ids is None:
            self.object_ids = list(range(len(self.rows)))
        for r in self.rows:
            if len(r) != len(self.attributes):
                raise ValueError("row arity mismatch")
        if len(self.decisions) != len(self.rows):
            raise ValueError("decision arity mismatch")

    def _distinct_objects(self) -> List[Tuple[Tuple, object]]:
        """The distinct (row, decision) pairs, in first-occurrence order."""
        return list(dict.fromkeys(
            (tuple(r), d) for r, d in zip(self.rows, self.decisions)))

    def _diff(self, row_i: Tuple, row_j: Tuple) -> FrozenSet[str]:
        return frozenset(a for k, a in enumerate(self.attributes)
                         if row_i[k] != row_j[k])

    # -- Eq. 3 ----------------------------------------------------------
    def discernibility_matrix(self) -> List[List[FrozenSet[str]]]:
        """c_ij = {a in A : a(x_i) != a(x_j)}  if d(x_i) != d(x_j) else ∅."""
        n = len(self.rows)
        mat = [[frozenset() for _ in range(n)] for _ in range(n)]
        for i in range(n):
            for j in range(i + 1, n):
                if self.decisions[i] != self.decisions[j]:
                    diff = frozenset(
                        a for k, a in enumerate(self.attributes)
                        if self.rows[i][k] != self.rows[j][k])
                    mat[i][j] = mat[j][i] = diff
        return mat

    # -- Eq. 4 ----------------------------------------------------------
    def discernibility_clauses(self) -> List[FrozenSet[str]]:
        """The non-empty, absorption-minimal clauses of f_Λ (CNF).

        Empty entries for *differing* decisions (inconsistent objects, which
        do occur — e.g. paper Table 4 rows 5 vs 11) are skipped, the standard
        treatment for inconsistent decision systems.
        """
        # A clause depends only on the two objects' rows and decisions, so
        # the pairs of *distinct* (row, decision) keys yield exactly the
        # clause set of all object pairs (two objects with different
        # decisions always have different keys).  A per-process table at
        # fleet scale (m = 16384 rows falling into a handful of cluster-id
        # patterns) then costs O(keys²) instead of O(m²) pair visits.
        keys = self._distinct_objects()
        clauses = set()
        for i, (row_i, dec_i) in enumerate(keys):
            for row_j, dec_j in keys[i + 1:]:
                if dec_i != dec_j:
                    diff = self._diff(row_i, row_j)
                    if diff:
                        clauses.add(diff)
        # Absorption: drop any clause that is a superset of another.
        minimal = [c for c in clauses
                   if not any(o < c for o in clauses)]
        return sorted(minimal, key=lambda c: (len(c), sorted(c)))

    # -- reducts / core --------------------------------------------------
    def reducts(self) -> List[FrozenSet[str]]:
        """All minimal hitting sets of the discernibility clauses — the
        prime implicants of f_Λ, i.e. the paper's 'core attributions'."""
        clauses = self.discernibility_clauses()
        if not clauses:
            return []
        hits = _minimal_hitting_sets(clauses)
        return sorted(hits, key=lambda s: (len(s), sorted(s)))

    def object_clauses(self, index: int) -> List[FrozenSet[str]]:
        """Clauses of the per-object discernibility function f_i (the paper
        computes 'the discernibility functions of each object')."""
        # Distinct (row, decision) keys, as in discernibility_clauses: an
        # object with another decision than ``index`` never shares its key,
        # so skipping ``j == index`` needs no separate test.
        row_i, dec_i = self.rows[index], self.decisions[index]
        clauses = set()
        for row_j, dec_j in self._distinct_objects():
            if dec_j == dec_i:
                continue
            diff = self._diff(row_i, row_j)
            if diff:
                clauses.add(diff)
        return [c for c in clauses if not any(o < c for o in clauses)]

    def object_reducts(self, index: int) -> List[FrozenSet[str]]:
        """Minimal hitting sets of the per-object clauses: the attributes
        that explain why object i is classified apart (its root causes)."""
        clauses = self.object_clauses(index)
        if not clauses:
            return []
        hits = _minimal_hitting_sets(clauses)
        return sorted(hits, key=lambda s: sorted(s))

    def core(self) -> FrozenSet[str]:
        """Classical core = intersection of all reducts = union of singleton
        clauses."""
        reds = self.reducts()
        if not reds:
            return frozenset()
        out = reds[0]
        for r in reds[1:]:
            out = out & r
        return out

    # -- per-object explanation ------------------------------------------
    def explain(self, index: int,
                reduct: Optional[FrozenSet[str]] = None,
                positive=lambda v: bool(v)) -> List[str]:
        """Paper: 'we search the decision table and find the root cause of
        code region 8 is high disk I/O quantity' — for one object, the
        reduct attributes whose value is 'high' (positive)."""
        if reduct is None:
            reds = self.reducts()
            reduct = reds[0] if reds else frozenset()
        row = self.rows[index]
        return [a for k, a in enumerate(self.attributes)
                if a in reduct and positive(row[k])]


def format_matrix(table: DecisionTable) -> str:
    """Render the discernibility matrix (paper Fig. 3 / Fig. 10)."""
    mat = table.discernibility_matrix()
    n = len(table.rows)
    lines = []
    for i in range(n):
        cells = []
        for j in range(n):
            if j <= i:
                cells.append(".")
            else:
                cells.append(",".join(sorted(mat[i][j])) or "φ")
        lines.append(" | ".join(cells))
    return "\n".join(lines)


def paper_table2() -> DecisionTable:
    """The weather example (paper Table 2)."""
    return DecisionTable(
        attributes=["a1", "a2", "a3", "a4"],
        rows=[("sunny", "hot", "high", False),
              ("sunny", "hot", "high", True),
              ("overcast", "hot", "high", False),
              ("sunny", "cool", "low", False)],
        decisions=["N", "N", "P", "P"],
    )


def paper_table3() -> DecisionTable:
    """ST dissimilarity decision table (paper Table 3)."""
    rows = [(0, 0, 0, 0, 0), (0, 0, 0, 0, 1), (0, 0, 0, 0, 1),
            (1, 0, 0, 0, 2), (0, 1, 0, 0, 3), (1, 1, 0, 1, 4),
            (1, 2, 0, 1, 3), (1, 2, 0, 0, 4)]
    return DecisionTable(
        attributes=["a1", "a2", "a3", "a4", "a5"],
        rows=rows,
        decisions=[0, 1, 1, 2, 3, 4, 3, 4],
    )


def paper_table4() -> DecisionTable:
    """ST disparity decision table (paper Table 4).  Rows 5 and 11 are an
    inconsistent pair (same attributes, different decision)."""
    rows = {
        1: (0, 0, 0, 0, 0), 2: (1, 0, 0, 0, 0), 3: (0, 0, 0, 0, 0),
        4: (0, 0, 0, 0, 0), 5: (1, 1, 0, 0, 1), 6: (1, 0, 0, 0, 1),
        7: (0, 0, 0, 0, 0), 8: (0, 0, 1, 0, 1), 9: (1, 0, 0, 0, 0),
        10: (1, 0, 0, 0, 0), 11: (1, 1, 0, 0, 1), 12: (0, 0, 0, 0, 0),
        13: (0, 0, 0, 0, 0), 14: (1, 1, 0, 0, 1),
    }
    dec = {i: (1 if i in (8, 11, 14) else 0) for i in rows}
    ids = sorted(rows)
    return DecisionTable(
        attributes=["a1", "a2", "a3", "a4", "a5"],
        rows=[rows[i] for i in ids],
        decisions=[dec[i] for i in ids],
        object_ids=ids,
    )
