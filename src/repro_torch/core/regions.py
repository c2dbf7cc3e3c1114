"""Code-region tree (paper §2).

A *code region* is a section of code executed from start to finish with one
entry and one exit.  Regions of the same depth may not overlap; nesting is
encouraged (deep nesting narrows the scope when locating bottlenecks).

In this adaptation a region is a named node of the model/step graph
(embed, layer_3/attn, layer_3/mlp, optimizer, ...).  The tree mirrors module
nesting; the whole program (one train/serve step) is the root.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional


@dataclasses.dataclass
class CodeRegion:
    """A node in the code-region tree."""

    name: str
    region_id: int
    parent: Optional["CodeRegion"] = None
    children: List["CodeRegion"] = dataclasses.field(default_factory=list)
    # Optional callable executing this region in isolation (runtime collector).
    fn: Optional[Callable] = None
    # Regions in the master process responsible for management routines are
    # excluded from similarity analysis (paper §4.2.1).
    management: bool = False

    @property
    def depth(self) -> int:
        d, node = 0, self
        while node.parent is not None:
            d += 1
            node = node.parent
        return d

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def walk(self) -> Iterator["CodeRegion"]:
        yield self
        for c in self.children:
            yield from c.walk()

    @property
    def path(self) -> str:
        parts, node = [], self
        while node is not None:
            parts.append(node.name)
            node = node.parent
        return "/".join(reversed(parts))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CodeRegion({self.region_id}:{self.path})"


class RegionTree:
    """The code-region tree of one program (paper Fig. 1).

    Invariants enforced:
      * same-depth regions never overlap (tree structure guarantees this);
      * ids are unique and dense;
      * the root (id 0) is the whole program.
    """

    def __init__(self, root_name: str = "program"):
        self.root = CodeRegion(root_name, 0)
        self._by_id: Dict[int, CodeRegion] = {0: self.root}
        self._by_path: Dict[str, CodeRegion] = {root_name: self.root}

    def add(
        self,
        name: str,
        parent: Optional[CodeRegion] = None,
        fn: Optional[Callable] = None,
        management: bool = False,
        region_id: Optional[int] = None,
    ) -> CodeRegion:
        """Add a region.  ``region_id`` defaults to the next dense id;
        pass one explicitly to mirror external numbering (paper trees,
        trace schemas) — id 0 stays reserved for the root."""
        parent = parent if parent is not None else self.root
        rid = len(self._by_id) if region_id is None else region_id
        if rid in self._by_id:
            raise ValueError(f"duplicate region id {rid}")
        region = CodeRegion(name, rid, parent=parent, fn=fn,
                            management=management)
        parent.children.append(region)
        self._by_id[region.region_id] = region
        if region.path in self._by_path:
            raise ValueError(f"duplicate region path {region.path!r}")
        self._by_path[region.path] = region
        return region

    def __len__(self) -> int:
        return len(self._by_id)

    def __getitem__(self, region_id: int) -> CodeRegion:
        return self._by_id[region_id]

    def by_path(self, path: str) -> CodeRegion:
        return self._by_path[path]

    def regions(self, include_root: bool = False) -> List[CodeRegion]:
        out = [r for r in self.root.walk()]
        return out if include_root else out[1:]

    def l_regions(self, depth: int) -> List[CodeRegion]:
        """All L-code-regions of a given depth (paper §2)."""
        return [r for r in self.regions() if r.depth == depth]

    def analysis_regions(self) -> List[CodeRegion]:
        """Regions participating in similarity analysis (management excluded)."""
        return [r for r in self.regions() if not r.management]

    def render(self) -> str:
        lines: List[str] = []

        def rec(node: CodeRegion, indent: int) -> None:
            tag = " [mgmt]" if node.management else ""
            lines.append("  " * indent + f"{node.region_id}: {node.name}{tag}")
            for c in node.children:
                rec(c, indent + 1)

        rec(self.root, 0)
        return "\n".join(lines)


def st_region_tree() -> RegionTree:
    """The coarse-grain code-region tree of the paper's ST application
    (paper Fig. 8): 14 code regions; regions 11 and 12 are nested in
    region 14 (subroutine ramod3).  Used by tests and benchmarks.
    """
    t = RegionTree("ST")
    nodes: Dict[int, CodeRegion] = {}
    # 1..10, 13, 14 are 1-code regions; 11, 12 nested in 14.  Explicit
    # ids mirror the paper numbering.
    order = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 13, 14]
    for i in order:
        nodes[i] = t.add(f"cr{i}", region_id=i)
    for i in (11, 12):
        nodes[i] = t.add(f"cr{i}", parent=nodes[14], region_id=i)
    return t
