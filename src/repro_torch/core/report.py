"""Human-readable analysis reports (paper Fig. 9 / Fig. 12 output style),
plus the canonical cross-run verdict fingerprint."""
from __future__ import annotations

import hashlib
import json
from typing import List

from .analyzer import ATTRIBUTE_MEANING, AnalysisResult, Verdict
from .clustering import SEVERITY_NAMES
from .regions import RegionTree
from .search import severity_banding


def verdict_fingerprint(verdict: Verdict) -> str:
    """Stable cross-run dedup key for a verdict.

    The fingerprint digests the verdict's *canonical* form
    (:meth:`Verdict.doc` — bottleneck kind, located region paths, cluster
    shape of the located CCR/CCCR chain, and the severity-banded cause
    attributes, all sorted), so two analyses that located the same
    bottlenecks for the same reasons — in different runs, on different
    machines — fingerprint identically, and *any* difference in the
    canonical doc changes the key.  Equality of fingerprints is therefore
    the same predicate the bit-identity gates check with ``doc()``
    equality, in a form short enough to index: the reference's fleet
    verdict index deduplicates recurring bottleneck signatures into
    "seen in N runs" reports by this key, and its chaos/onset corpus
    comparisons match windows by the very same key, so the index and the
    gates can never disagree about what "the same verdict" means.  A
    verdict fingerprints identically in the JAX and PyTorch packages.

    Format: ``<kind>:<16 hex chars>`` where kind is ``none`` / ``dissim``
    / ``disp`` / ``both`` — human-skimmable in reports, unique by digest.
    """
    doc = verdict.doc()
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    digest = hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]
    dis = bool(doc["dissimilar"] or doc["dissimilarity_paths"])
    disp = bool(doc["disparity_paths"])
    kind = {(False, False): "none", (True, False): "dissim",
            (False, True): "disp", (True, True): "both"}[(dis, disp)]
    return f"{kind}:{digest}"


def render(tree: RegionTree, result: AnalysisResult) -> str:
    lines: List[str] = []
    dis = result.dissimilarity
    lines.append("=== Performance similarity ===")
    lines.append(f"there are {dis.baseline.n_clusters} clusters of "
                 f"processes")
    for c in range(dis.baseline.n_clusters):
        members = " ".join(str(i) for i in dis.baseline.members(c))
        lines.append(f"  cluster {c}: {members}")
    if dis.exists:
        lines.append(f"dissimilarity severity, {dis.baseline.n_clusters}: "
                     f"{dis.severity:.6f}")
        lines.append("CCR: " + ", ".join(
            f"code region {r}" for r in dis.ccrs))
        lines.append("CCCR: " + ", ".join(
            f"code region {r}" for r in dis.cccrs))
        if result.dissimilarity_causes:
            cores = " or ".join(
                "{" + ", ".join(sorted(c)) + "}"
                for c in result.dissimilarity_causes)
            lines.append(f"root-cause core attributes: {cores}")
            meanings = sorted({ATTRIBUTE_MEANING.get(a, a)
                               for c in result.dissimilarity_causes
                               for a in c})
            for m in meanings:
                lines.append(f"  -> {m}")
    else:
        lines.append("no dissimilarity bottlenecks "
                     "(all processes in one cluster)")

    lines.append("")
    lines.append("=== Code-region disparity (k-means severity) ===")
    banding = severity_banding(result.disparity)
    for name in SEVERITY_NAMES[::-1]:
        rids = banding[name]
        if rids:
            lines.append(f"  {name}: code regions: "
                         + ",".join(str(r) for r in rids))
    if result.disparity.ccrs:
        lines.append("CCR: " + ", ".join(
            f"code region {r}" for r in result.disparity.ccrs))
        lines.append("CCCR: " + ", ".join(
            f"code region {r}" for r in result.disparity.cccrs))
        if result.disparity_causes:
            cores = " or ".join(
                "{" + ", ".join(sorted(c)) + "}"
                for c in result.disparity_causes)
            lines.append(f"root-cause core attributes: {cores}")
        for rid, causes in sorted(result.per_region_causes.items()):
            if causes:
                lines.append(f"  code region {rid}: " + "; ".join(causes))
    else:
        lines.append("no disparity bottlenecks")
    return "\n".join(lines)
