"""One benchmark per paper table/figure (§6).

The port's twin of the reference's ``benchmarks/paper_tables.py`` over
``repro_torch.core`` and ``repro_torch.scenarios``: each function returns
(name, us_per_call, derived) rows, ``us_per_call`` timing the analysis
itself and ``derived`` carrying the reproduced result, the same string
the reference builds.  ``lane`` picks the analyzers' distance backend
(``"kernel"``, the default, on the card; ``"torch"``; ``"numpy"``, the
exact host lane) and ``device`` where the device lanes run (None: the
card, which raises without one); every lane must give the same
``derived``."""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import (AutoAnalyzer, COMM_BYTES, FLOPS, WALL_TIME,
                              get_distance_backend, optics_cluster,
                              paper_table2, paper_table3, paper_table4)
from repro_torch.scenarios import (mpibzip2_scenario, npar1way_scenario,
                                   st_fine_scenario, st_scenario,
                                   st_total_time)

Row = Tuple[str, float, str]


def _timed(fn, n=5):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    dt = (time.perf_counter() - t0) / n
    return out, dt * 1e6


def _analyzer(tree, lane: str, device: Optional[str], **kw) -> AutoAnalyzer:
    return AutoAnalyzer(tree, distance_backend=lane, device=device, **kw)


def fig9_st_dissimilarity(lane: str = "kernel",
                          device: Optional[str] = None) -> Row:
    tree, rm = st_scenario()
    az = _analyzer(tree, lane, device)
    res, us = _timed(lambda: az.analyze(rm))
    d = res.dissimilarity
    derived = (f"clusters={d.baseline.n_clusters};CCCR={d.cccrs};"
               f"severity={d.severity:.4f}")
    return ("fig9_st_dissimilarity", us, derived)


def fig11_instruction_variance(lane: str = "kernel",
                               device: Optional[str] = None) -> Row:
    tree, rm = st_scenario()
    flops, us = _timed(lambda: rm.vectors(FLOPS, [11]))
    ratio = float(flops.max() / flops.min())
    return ("fig11_region11_instruction_variance", us,
            f"max/min={ratio:.2f}")


def fig12_13_st_disparity(lane: str = "kernel",
                          device: Optional[str] = None) -> Row:
    tree, rm = st_scenario()
    az = _analyzer(tree, lane, device)
    res, us = _timed(lambda: az.analyze(rm))
    sev = res.disparity.severities
    vh = sorted(r for r, s in sev.items() if s == 4)
    crnm11 = res.disparity.values[11]
    return ("fig12_13_st_disparity", us,
            f"very_high={vh};CCCR={res.disparity.cccrs};"
            f"crnm11={crnm11:.3f}")


def table2_weather_example(lane: str = "kernel",
                           device: Optional[str] = None) -> Row:
    t = paper_table2()
    reds, us = _timed(lambda: t.reducts())
    return ("table2_rough_set_example", us,
            "reducts=" + "|".join(",".join(sorted(r)) for r in reds))


def table3_dissimilarity_roots(lane: str = "kernel",
                               device: Optional[str] = None) -> Row:
    t = paper_table3()
    reds, us = _timed(lambda: t.reducts())
    return ("table3_dissimilarity_core", us,
            "core=" + ",".join(sorted(reds[0])))


def table4_disparity_roots(lane: str = "kernel",
                           device: Optional[str] = None) -> Row:
    t = paper_table4()
    reds, us = _timed(lambda: t.reducts())
    return ("table4_disparity_core", us,
            "core=" + ",".join(sorted(reds[0])))


def fig14_st_optimization(lane: str = "kernel",
                          device: Optional[str] = None) -> Row:
    def run():
        base = st_total_time(st_scenario()[1])
        disp = st_total_time(st_scenario(optimize_disparity=True)[1])
        dis = st_total_time(st_scenario(optimize_dissimilarity=True)[1])
        both = st_total_time(st_scenario(optimize_dissimilarity=True,
                                         optimize_disparity=True)[1])
        return base, disp, dis, both

    (base, disp, dis, both), us = _timed(run, n=2)
    return ("fig14_st_before_after", us,
            f"disparity=+{100*(base/disp-1):.0f}%;"
            f"dissimilarity=+{100*(base/dis-1):.0f}%;"
            f"both=+{100*(base/both-1):.0f}% (paper:+90/+40/+170)")


def fig15_16_two_round(lane: str = "kernel",
                       device: Optional[str] = None) -> Row:
    """§6.1.2: coarse -> fine two-round analysis."""
    def run():
        tree, rm = st_fine_scenario()
        return _analyzer(tree, lane, device).analyze(rm)

    res, us = _timed(run, n=2)
    return ("fig15_16_two_round_refinement", us,
            f"dissim_CCCR={res.dissimilarity.cccrs};"
            f"disparity_CCCR={res.disparity.cccrs} (paper: 21; 19,21)")


def npar1way_analysis(lane: str = "kernel",
                      device: Optional[str] = None) -> Row:
    tree, rm = npar1way_scenario()
    az = _analyzer(tree, lane, device)
    res, us = _timed(lambda: az.analyze(rm))
    causes = sorted(res.disparity_causes[0]) if res.disparity_causes else []
    return ("sec6_2_npar1way", us,
            f"dissim={res.dissimilarity.exists};"
            f"CCR={res.disparity.ccrs};causes={causes}")


def npar1way_optimization(lane: str = "kernel",
                          device: Optional[str] = None) -> Row:
    def run():
        _, rm = npar1way_scenario()
        _, rm2 = npar1way_scenario(optimize=True)
        d3 = 1 - rm2.region_mean(FLOPS, 3) / rm.region_mean(FLOPS, 3)
        d12 = 1 - rm2.region_mean(FLOPS, 12) / rm.region_mean(FLOPS, 12)
        t = 1 - (sum(rm2.region_mean(WALL_TIME, r) for r in rm2.region_ids)
                 / sum(rm.region_mean(WALL_TIME, r) for r in rm.region_ids))
        return d3, d12, t

    (d3, d12, t), us = _timed(run, n=2)
    return ("sec6_2_npar1way_optimized", us,
            f"instr3=-{100*d3:.1f}%;instr12=-{100*d12:.1f}%;"
            f"time=-{100*t:.1f}% (paper:-36.32/-16.93/~20)")


def mpibzip2_analysis(lane: str = "kernel",
                      device: Optional[str] = None) -> Row:
    tree, rm = mpibzip2_scenario()
    az = _analyzer(tree, lane, device)
    res, us = _timed(lambda: az.analyze(rm))
    total_f = sum(rm.region_mean(FLOPS, r) for r in rm.region_ids)
    f6 = rm.region_mean(FLOPS, 6) / total_f
    total_c = sum(rm.region_mean(COMM_BYTES, r) for r in rm.region_ids)
    c7 = rm.region_mean(COMM_BYTES, 7) / total_c
    return ("sec6_3_mpibzip2", us,
            f"CCR={res.disparity.ccrs};instr6={100*f6:.0f}%;"
            f"net7={100*c7:.0f}% (paper:96/50)")


def sec64_metric_comparison(lane: str = "kernel",
                            device: Optional[str] = None) -> Row:
    tree, rm = st_scenario()
    truth = {8, 11, 14}

    def run():
        out = {}
        for metric in ("crnm", "cpi", WALL_TIME):
            res = _analyzer(tree, lane, device,
                            disparity_metric=metric).analyze(rm)
            got = set(res.disparity.ccrs)
            out[metric] = (len(got - truth), len(truth - got))
        return out

    out, us = _timed(run, n=2)
    derived = ";".join(f"{m}:fp={v[0]},fn={v[1]}" for m, v in out.items())
    return ("sec6_4_metric_comparison", us, derived)


def analyzer_scaling(lane: str = "kernel",
                     device: Optional[str] = None) -> List[Row]:
    """Throughput of the lightweight analyses (the paper's 'lightweight in
    terms of the size of performance data' claim), on ``lane``."""
    rows = []
    rng = np.random.default_rng(0)
    be = get_distance_backend(lane, device)
    for m, n in ((64, 64), (256, 128), (1024, 256)):
        v = rng.random((m, n))
        _, us = _timed(lambda: optics_cluster(v, backend=be), n=3)
        rows.append((f"optics_{m}x{n}", us, f"points={m};dims={n}"))
    return rows


TABLES = (fig9_st_dissimilarity, fig11_instruction_variance,
          fig12_13_st_disparity, table2_weather_example,
          table3_dissimilarity_roots, table4_disparity_roots,
          fig14_st_optimization, fig15_16_two_round, npar1way_analysis,
          npar1way_optimization, mpibzip2_analysis, sec64_metric_comparison)


def all_rows(lane: str = "kernel",
             device: Optional[str] = None) -> List[Row]:
    """Every table's row, in the reference's order, then the scaling
    rows."""
    return [fn(lane, device) for fn in TABLES] + \
        analyzer_scaling(lane, device)
