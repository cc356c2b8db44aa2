"""Latency / rate plot rendering, and the search and bench panels.

The port of `jepsen_tpu/checker/plots.py` (jepsen.checker.perf,
`jepsen/src/jepsen/checker/perf.clj`): raw latency scatter
(`latency-raw.png`, perf.clj:484-511), latency quantiles over time
(`latency-quantiles.png`, :513-556), completion-rate plot (`rate.png`,
:559-599), with nemesis activity rendered as shaded regions + event
lines (:240-340); the WGL search's progress panel
(`search-progress.png`), the frontier-fill heatmap
(`occupancy-heatmap.png`) and the bench's round trajectory
(`bench-trajectory.png`). Latencies are attached by pairing invocations
with completions; buckets are 30 s (quantiles) and 10 s (rate) as in the
reference.

The data half (`latency_points`, `quantile_series`, `_nemesis_spans`) is
the reference's, exactly. The drawing half renders with matplotlib (Agg
backend), imported lazily by `_plt`: where matplotlib is not installed
(as on the card's machine) `_plt` returns None, every drawer returns
None and no file is written. Nothing else is skipped on the way to a
plot.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

from .. import store, util
from ..history import History

log = logging.getLogger("jepsen_tpu_torch.checker.plots")

TYPES = ("ok", "info", "fail")
TYPE_COLORS = {"ok": "#3b82d0", "info": "#f0a030", "fail": "#e0509a"}
QUANTILES = (0.5, 0.95, 0.99, 1.0)
Q_COLORS = {0.5: "#7fbf6f", 0.95: "#4070c0", 0.99: "#9060c0",
            1.0: "#d05050"}
MARKERS = "ovs^Dpx+*"
NEMESIS_COLOR = "#cccccc"
NEMESIS_ALPHA = 0.35

DT_QUANTILES = 30.0  # seconds per bucket (perf.clj:519)
DT_RATE = 10.0       # perf.clj:563


def _plt():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib
    is not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def latency_points(history) -> list:
    """[(f, completion_type, t_secs, latency_ms)] for every completed
    client op (util/history->latencies + latency-point,
    perf.clj:144-149)."""
    out = []
    for inv, comp in History(history).pairs():
        if comp is None or not inv.is_invoke:
            continue
        if inv.process == "nemesis":
            continue
        if inv.time is None or comp.time is None or inv.time < 0:
            continue
        out.append((inv.f, comp.type, inv.time / 1e9,
                    (comp.time - inv.time) / 1e6))
    return out


def quantile_series(points, dt: float, qs=QUANTILES) -> dict:
    """{q: (times, values)} per-bucket latency quantiles
    (latencies->quantiles, perf.clj:64-88)."""
    if not points:
        return {}
    t = np.asarray([p[0] for p in points])
    lat = np.asarray([p[1] for p in points])
    buckets = np.floor(t / dt).astype(np.int64)
    out = {q: ([], []) for q in qs}
    for b in np.unique(buckets):
        sel = np.sort(lat[buckets == b])
        mid = b * dt + dt / 2
        for q in qs:
            out[q][0].append(mid)
            # floor-index quantile, exactly the reference's extract fn
            idx = min(len(sel) - 1, int(np.floor(len(sel) * q)))
            out[q][1].append(float(sel[idx]))
    return out


def _nemesis_spans(history):
    """[(t_start, t_stop_or_None)] in seconds, from nemesis
    start/stop-style intervals (util/nemesis-intervals)."""
    spans = []
    try:
        for start, stop in util.nemesis_intervals(history):
            if start is None or start.time is None or start.time < 0:
                continue
            t0 = start.time / 1e9
            t1 = stop.time / 1e9 if stop is not None and stop.time \
                is not None and stop.time >= 0 else None
            spans.append((t0, t1))
    except Exception:  # malformed nemesis histories never kill a plot
        log.debug("nemesis interval extraction failed", exc_info=True)
    return spans


def _shade_nemeses(ax, history, t_max: float):
    for t0, t1 in _nemesis_spans(history):
        ax.axvspan(t0, t1 if t1 is not None else t_max,
                   color=NEMESIS_COLOR, alpha=NEMESIS_ALPHA, lw=0)


def _save(fig, test, opts, filename) -> Optional[str]:
    if not test.get("name"):
        return None
    subdir = list((opts or {}).get("subdirectory", []))
    path = store.path_bang(test, *subdir, filename)
    fig.savefig(path, dpi=90, bbox_inches="tight")
    return path


def _fmarker(fs):
    order = sorted({str(f) for f in fs})
    return {f: MARKERS[i % len(MARKERS)] for i, f in enumerate(order)}


def point_graph(test, history, opts=None, pts=None) -> Optional[str]:
    """Raw latency scatter, log-y, one marker per f, one color per
    completion type (perf.clj:484-511). Pass precomputed pts to avoid
    re-pairing the history."""
    plt = _plt()
    if plt is None:
        return None
    if pts is None:
        pts = latency_points(history)
    if not pts:
        return None
    fig, ax = plt.subplots(figsize=(10, 4.5))
    t_max = max(p[2] for p in pts)
    _shade_nemeses(ax, history, t_max)
    markers = _fmarker(p[0] for p in pts)
    for f in sorted({str(p[0]) for p in pts}):
        for typ in TYPES:
            sel = [(p[2], p[3]) for p in pts
                   if str(p[0]) == f and p[1] == typ]
            if not sel:
                continue
            xs, ys = zip(*sel)
            ax.scatter(xs, ys, s=12, marker=markers[f],
                       color=TYPE_COLORS[typ], label=f"{f} {typ}",
                       alpha=0.7, linewidths=0)
    ax.set_yscale("log")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Latency (ms)")
    ax.set_title(f"{test.get('name', '')} latency (raw)")
    ax.legend(loc="upper right", fontsize=7)
    out = _save(fig, test, opts, "latency-raw.png")
    plt.close(fig)
    return out


def quantiles_graph(test, history, opts=None, pts=None) -> Optional[str]:
    """Latency quantiles by f over time (perf.clj:513-556)."""
    plt = _plt()
    if plt is None:
        return None
    if pts is None:
        pts = latency_points(history)
    if not pts:
        return None
    fig, ax = plt.subplots(figsize=(10, 4.5))
    t_max = max(p[2] for p in pts)
    _shade_nemeses(ax, history, t_max)
    markers = _fmarker(p[0] for p in pts)
    for f in sorted({str(p[0]) for p in pts}):
        fpts = [p for p in pts if str(p[0]) == f]
        for q, (xs, ys) in quantile_series(
                [(p[2], p[3]) for p in fpts], DT_QUANTILES).items():
            ax.plot(xs, ys, marker=markers[f], markersize=4,
                    color=Q_COLORS.get(q, "#666666"), lw=1,
                    label=f"{f} q={q}")
    ax.set_yscale("log")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Latency (ms)")
    ax.set_title(f"{test.get('name', '')} latency quantiles")
    ax.legend(loc="upper right", fontsize=7)
    out = _save(fig, test, opts, "latency-quantiles.png")
    plt.close(fig)
    return out


def search_progress_graph(test, chunks, opts=None,
                          rounds=None) -> Optional[str]:
    """search-progress.png: the WGL device search's own trajectory
    from the per-chunk telemetry timeseries (metrics.py `wgl_chunks`
    points / a result's `telemetry.chunks`): frontier + backlog
    occupancy, cumulative configs explored with the per-poll
    exploration rate, and the memo-table hit rate, all over search
    wall clock. `rounds` (a result's `occupancy.rounds` — per-round
    drained counters) overlays per-round frontier FILL on the
    hit-rate panel, so the progress graph shows occupancy alongside
    configs_explored. Never raises — a malformed point list must not
    mask the verdict it rides along with."""
    try:
        pts = [p for p in (chunks or []) if "wall_s" in p]
        if not pts:
            return None
        plt = _plt()
        if plt is None:
            return None
        t = [p["wall_s"] for p in pts]
        fig, axes = plt.subplots(3, 1, figsize=(10, 7), sharex=True)
        ax = axes[0]
        ax.plot(t, [p.get("frontier", 0) for p in pts], marker="o",
                markersize=3, lw=1, color=Q_COLORS[0.95],
                label="frontier")
        ax.plot(t, [p.get("backlog", 0) for p in pts], marker="s",
                markersize=3, lw=1, color=Q_COLORS[1.0],
                label="backlog")
        if any(p.get("K") for p in pts):
            ax.plot(t, [p.get("K", 0) for p in pts], lw=1, ls="--",
                    color="#888888", label="K (beam)")
        ax.set_yscale("symlog")
        ax.set_ylabel("configs")
        ax.legend(loc="upper right", fontsize=7)
        ax.set_title(f"{test.get('name', '')} search progress")

        ax = axes[1]
        ax.plot(t, [p.get("explored", 0) for p in pts], marker="o",
                markersize=3, lw=1, color=TYPE_COLORS["ok"],
                label="explored (cumulative)")
        rate = [p.get("explored_delta", 0) / max(p.get("poll_s", 0),
                                                 1e-9) for p in pts]
        ax2 = ax.twinx()
        ax2.plot(t, rate, marker="^", markersize=3, lw=1,
                 color=TYPE_COLORS["info"], label="configs/s")
        ax.set_ylabel("explored")
        ax2.set_ylabel("configs/s")
        h1, l1 = ax.get_legend_handles_labels()
        h2, l2 = ax2.get_legend_handles_labels()
        ax.legend(h1 + h2, l1 + l2, loc="upper left", fontsize=7)

        ax = axes[2]
        ax.plot(t, [p.get("memo_hit_rate", 0) for p in pts],
                marker="o", markersize=3, lw=1, color=Q_COLORS[0.99],
                label="memo hit rate")
        rpts = [r for r in (rounds or [])
                if r.get("wall_s") is not None
                and r.get("fill") is not None]
        if rpts:
            # per-round frontier fill (occupancy plane) on the same
            # 0..1 axis, with the fill target line
            from .. import occupancy as occupancy_mod
            target = occupancy_mod.TARGET_FILL
            ax.plot([r["wall_s"] for r in rpts],
                    [r["fill"] for r in rpts], lw=1,
                    color=TYPE_COLORS["fail"], alpha=0.7,
                    label="frontier fill (per round)")
            ax.axhline(target, lw=0.8, ls=":", color="#888888",
                       label=f"fill target {target}")
        ax.set_ylim(0, 1)
        ax.set_ylabel("hit rate / fill")
        ax.set_xlabel("Search wall clock (s)")
        ax.legend(loc="upper right", fontsize=7)

        out = _save(fig, test, opts, "search-progress.png")
        plt.close(fig)
        return out
    except Exception:  # noqa: BLE001
        log.warning("search-progress rendering failed", exc_info=True)
        return None


def occupancy_heatmap(test, points, opts=None,
                      filename="occupancy-heatmap.png",
                      out_path: Optional[str] = None,
                      events=None) -> Optional[str]:
    """occupancy-heatmap.png: frontier fill as a (lane x round) grid
    from occupancy points [{"round", "lane", "fill"}] — the
    single-search view is a 1-lane strip (occupancy.heatmap_points),
    the mesh-batched fan-out one lane per key (`wgl_batched_rounds`
    series), where stragglers show up as long hot rows and empty
    lanes as cold ones. Points carrying a `device` field (the mesh
    fan-out's lane->device attribution, parallel/batched.py) render
    an extra per-device column strip beside the lane axis, so the
    mesh layout is readable off the heatmap itself. `out_path`
    renders to an explicit file (the bench's artifact tree) instead
    of the test's store dir. Never raises — occupancy rendering must
    not mask a verdict. `events` (mesh scheduler actions from the
    `mesh_sched` series, each with a `round` coordinate) render as
    dashed vertical markers — steals grey, rebuckets labeled
    K->K' — so a scheduling decision is readable against the fill
    pattern that triggered it."""
    try:
        pts = [p for p in (points or [])
               if isinstance(p, dict)
               and isinstance(p.get("round"), int) and p["round"] >= 0
               and isinstance(p.get("lane"), int) and p["lane"] >= 0
               and isinstance(p.get("fill"), (int, float))]
        if not pts:
            return None
        plt = _plt()
        if plt is None:
            return None
        rounds = sorted({p["round"] for p in pts})
        lanes = sorted({p["lane"] for p in pts})
        ridx = {r: i for i, r in enumerate(rounds)}
        lidx = {la: i for i, la in enumerate(lanes)}
        grid = np.full((len(lanes), len(rounds)), np.nan)
        lane_dev: dict = {}
        for p in pts:
            grid[lidx[p["lane"]], ridx[p["round"]]] = p["fill"]
            if isinstance(p.get("device"), int):
                lane_dev[lidx[p["lane"]]] = p["device"]
        figsize = (10, max(2.0, 0.25 * len(lanes) + 1.5))
        if lane_dev and len(lanes) > 1:
            fig, (ax, axd) = plt.subplots(
                1, 2, figsize=figsize, sharey=True,
                gridspec_kw={"width_ratios": [40, 1], "wspace": 0.02})
        else:
            fig, ax = plt.subplots(figsize=figsize)
            axd = None
        im = ax.imshow(grid, aspect="auto", origin="lower",
                       interpolation="nearest", vmin=0.0, vmax=1.0,
                       cmap="viridis",
                       extent=(rounds[0] - 0.5, rounds[-1] + 0.5,
                               -0.5, len(lanes) - 0.5))
        ax.set_xlabel("round")
        ax.set_ylabel("lane" if len(lanes) > 1 else "")
        if len(lanes) > 1:
            ax.set_yticks(range(len(lanes)))
            ax.set_yticklabels([str(la) for la in lanes], fontsize=6)
        else:
            ax.set_yticks([])
        ax.set_title(f"{(test or {}).get('name', '')} frontier fill "
                     f"(round x lane)")
        if axd is not None:
            # the per-device column strip: one colored cell per lane,
            # banded by mesh-device index — contiguous bands are the
            # lanes' layout over the devices, so a straggler row reads
            # straight to its device
            devcol = np.full((len(lanes), 1), np.nan)
            for li, d in lane_dev.items():
                # cycle the 10-color map past device 9 (clamping
                # would merge devices 9..N into one band); the text
                # label below keeps the true index readable
                devcol[li, 0] = d % 10
            axd.imshow(devcol, aspect="auto", origin="lower",
                       interpolation="nearest", cmap="tab10",
                       vmin=-0.5, vmax=9.5,
                       extent=(-0.5, 0.5, -0.5, len(lanes) - 0.5))
            axd.set_xticks([])
            axd.set_title("dev", fontsize=7)
            for li, d in sorted(lane_dev.items()):
                axd.text(0, li, str(int(d) % 100), fontsize=5,
                         ha="center", va="center", color="white")
        for ev in (events or []):
            if not isinstance(ev, dict) \
                    or not isinstance(ev.get("round"), int) \
                    or not (rounds[0] <= ev["round"] <= rounds[-1]):
                continue
            is_rebucket = ev.get("event") == "rebucket"
            ax.axvline(ev["round"], lw=0.9, ls="--",
                       color="#d62728" if is_rebucket else "#999999",
                       alpha=0.8)
            label = (f"K{ev.get('from_K')}→{ev.get('to_K')}"
                     if is_rebucket else "steal")
            ax.annotate(label, (ev["round"], len(lanes) - 0.5),
                        fontsize=5, ha="left", va="top",
                        color="#ffffff", rotation=90)
        fig.colorbar(im, ax=ax, label="fill")
        if out_path:
            parent = os.path.dirname(out_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            fig.savefig(out_path, dpi=90, bbox_inches="tight")
            plt.close(fig)
            return out_path
        out = _save(fig, test, opts, filename)
        plt.close(fig)
        return out
    except Exception:  # noqa: BLE001
        log.warning("occupancy-heatmap rendering failed", exc_info=True)
        return None


def bench_trajectory_graph(report: dict, out_path: str) -> Optional[str]:
    """bench-trajectory.png: wall-time trajectory across BENCH rounds
    from a `bench.compute_regressions` report — the headline number
    per round on top, per-config walls below, with flagged
    regressions marked red. Path-based (the bench has no test map);
    never raises — a malformed report must not mask the bench's JSON
    line."""
    try:
        rounds = list(report.get("rounds") or [])
        cur = report.get("current")
        if cur and cur.get("value") is not None:
            rounds = rounds + [cur]
        rounds = [r for r in rounds if r.get("value") is not None]
        if len(rounds) < 2:
            return None
        plt = _plt()
        if plt is None:
            return None
        xs = [r.get("round") for r in rounds]
        fig, axes = plt.subplots(2, 1, figsize=(10, 7), sharex=True)

        ax = axes[0]
        ax.plot(xs, [r["value"] for r in rounds], marker="o", lw=1.5,
                color=Q_COLORS[0.95], label="headline wall_s")
        if (report.get("headline") or {}).get("regressed"):
            ax.plot([xs[-1]], [rounds[-1]["value"]], marker="o",
                    markersize=10, color=Q_COLORS[1.0], ls="none",
                    label="REGRESSED")
        for x, r in zip(xs, rounds):
            ax.annotate(str(r.get("platform") or ""), (x, r["value"]),
                        fontsize=6, textcoords="offset points",
                        xytext=(0, 6))
        ax.set_yscale("log")
        ax.set_ylabel("headline wall (s)")
        ax.set_title("BENCH trajectory")
        ax.legend(loc="upper right", fontsize=7)

        ax = axes[1]
        names = sorted({n for r in rounds
                        for n in (r.get("configs") or {})})
        flagged = set(report.get("regressions") or [])
        # occupancy regressions ride the same flag list as
        # "<name>:fill" (bench.compute_regressions) — the config's
        # wall line marks them too, so an emptied-lanes regression is
        # as loud as a wall-time one
        fill_flagged = {f.rsplit(":", 1)[0] for f in flagged
                        if f.endswith(":fill")}
        for i, name in enumerate(names):
            pts = [(x, (r.get("configs") or {}).get(name))
                   for x, r in zip(xs, rounds)]
            pts = [(x, v) for x, v in pts if v is not None]
            if not pts:
                continue
            px, py = zip(*pts)
            hot = name in flagged or name in fill_flagged
            color = Q_COLORS[1.0] if hot else f"C{i % 10}"
            suffix = (" (REGRESSED)" if name in flagged
                      else " (FILL REGRESSED)" if name in fill_flagged
                      else "")
            ax.plot(px, py, marker=MARKERS[i % len(MARKERS)],
                    markersize=4, lw=1, color=color,
                    label=name + suffix)
        ax.set_yscale("log")
        ax.set_xlabel("BENCH round")
        ax.set_ylabel("config wall (s)")
        ax.legend(loc="upper left", fontsize=6, ncol=2)

        srcs = report.get("sources") or {}
        if srcs:
            # where the rounds came from: the run ledger is primary,
            # the BENCH_r*.json glob backfills pre-ledger rounds
            fig.text(0.01, 0.01,
                     "rounds: " + ", ".join(
                         f"{n} from {s}" for s, n in sorted(
                             srcs.items()) if n),
                     fontsize=6, color="#666666")

        parent = os.path.dirname(out_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        fig.savefig(out_path, dpi=90, bbox_inches="tight")
        plt.close(fig)
        return out_path
    except Exception:  # noqa: BLE001
        log.warning("bench-trajectory rendering failed", exc_info=True)
        return None


def rate_graph(test, history, opts=None) -> Optional[str]:
    """Completion rate (hz) in 10 s buckets by f and type
    (perf.clj:559-599)."""
    plt = _plt()
    if plt is None:
        return None
    comps = [op for op in History(history)
             if not op.is_invoke and isinstance(op.process, int)
             and op.time is not None and op.time >= 0]
    if not comps:
        return None
    fig, ax = plt.subplots(figsize=(10, 4.5))
    t_max = max(op.time for op in comps) / 1e9
    _shade_nemeses(ax, history, t_max)
    markers = _fmarker(op.f for op in comps)
    n_buckets = int(np.floor(t_max / DT_RATE)) + 1
    centers = np.arange(n_buckets) * DT_RATE + DT_RATE / 2
    for f in sorted({str(op.f) for op in comps}):
        for typ in TYPES:
            sel = [op.time / 1e9 for op in comps
                   if str(op.f) == f and op.type == typ]
            if not sel:
                continue
            counts = np.bincount(
                np.floor(np.asarray(sel) / DT_RATE).astype(np.int64),
                minlength=n_buckets)
            ax.plot(centers, counts / DT_RATE, marker=markers[f],
                    markersize=4, lw=1, color=TYPE_COLORS[typ],
                    label=f"{f} {typ}")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Throughput (hz)")
    ax.set_title(f"{test.get('name', '')} rate")
    ax.legend(loc="upper right", fontsize=7)
    out = _save(fig, test, opts, "rate.png")
    plt.close(fig)
    return out
