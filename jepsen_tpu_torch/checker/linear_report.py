"""linear.svg — render why a history is not linearizable.

A copy of `jepsen_tpu/checker/linear_report.py` (same bytes out for
the same history and analysis). Capability parity with
`knossos.linear.report/render-analysis!`, which the reference invokes
whenever a linearizability analysis comes back invalid
(jepsen/src/jepsen/checker.clj:205-212): a per-process swimlane
of operation intervals with the furthest-reaching witnessed
linearization drawn as a path through the ops it managed to apply, and
the operation nobody could linearize highlighted.

Raw SVG strings — no plotting dependency; the store's web UI serves
image/svg+xml natively. Large histories are windowed around the
failure (the reference's renderer likewise falls over on huge
histories, hence knossos truncates analysis output)."""

from __future__ import annotations

import html
import logging
from typing import Optional

from .. import store
from ..history import History

log = logging.getLogger(__name__)

MAX_OPS = 120         # ops rendered around the failure
BAR_H = 18
ROW_GAP = 8
X_SCALE = 26          # px per event index
LEFT = 90
TOP = 40

TYPE_FILL = {"ok": "#79c7f7", "info": "#f7c36b", "fail": "#f7a8c8"}


def _esc(s) -> str:
    return html.escape(str(s), quote=True)


def render(history: History, analysis: dict) -> Optional[str]:
    """The SVG document, or None when there is nothing to draw."""
    pairs = [(inv, comp) for inv, comp in History(history).pairs()
             if inv.is_invoke]
    if not pairs:
        return None

    # event-index timeline: x = position in the history
    n_events = max((c.index if c is not None else inv.index)
                   for inv, c in pairs) + 1

    # window around the failing op if the history is large: keep pairs
    # whose [invoke, complete] interval intersects it (the failing op's
    # return may trail its invoke by many events)
    bad = analysis.get("op") or {}
    bad_idx = bad.get("index")
    if len(pairs) > MAX_OPS:
        center = bad_idx if bad_idx is not None else n_events
        lo, hi = max(0, center - MAX_OPS), center + 8
        pairs = [p for p in pairs
                 if p[0].index <= hi
                 and (p[1].index if p[1] is not None
                      else n_events) >= lo]
        pairs = pairs[-MAX_OPS:]
    if not pairs:
        return None

    procs = []
    for inv, _ in pairs:
        if inv.process not in procs:
            procs.append(inv.process)
    rows = {p: i for i, p in enumerate(procs)}

    x0 = min(inv.index for inv, _ in pairs)

    def x_of(idx):
        return LEFT + (idx - x0) * X_SCALE

    def y_of(proc):
        return TOP + rows[proc] * (BAR_H + ROW_GAP)

    width = max(x_of(inv.index if c is None else c.index) + 160
                for inv, c in pairs)
    height = TOP + len(procs) * (BAR_H + ROW_GAP) + 60

    parts = [f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
             f"height='{height}' font-family='sans-serif' "
             f"font-size='11'>",
             f"<text x='{LEFT}' y='18' font-size='14'>"
             f"History is not linearizable — "
             f"{_esc(analysis.get('algorithm', ''))}</text>"]

    # search telemetry footer: how hard the kernel worked for this
    # verdict (the util block every device result carries)
    util = analysis.get("util") or {}
    if util or analysis.get("configs_explored") is not None:
        bits = []
        if analysis.get("configs_explored") is not None:
            bits.append(f"{analysis['configs_explored']} configs")
        if util.get("rounds") is not None:
            bits.append(f"{util['rounds']} rounds")
        if util.get("memo_hit_rate") is not None:
            bits.append(f"memo hit rate {util['memo_hit_rate']}")
        if analysis.get("wall_s") is not None:
            bits.append(f"{analysis['wall_s']} s")
        if bits:
            parts.append(
                f"<text x='{LEFT}' y='32' font-size='10' "
                f"fill='#666'>device search: "
                f"{_esc(', '.join(bits))}</text>")

    for p in procs:
        parts.append(f"<text x='8' y='{y_of(p) + 13}'>"
                     f"process {_esc(p)}</text>")

    # op bars
    centers = {}
    for inv, comp in pairs:
        end_idx = comp.index if comp is not None else inv.index + 1
        typ = comp.type if comp is not None else "info"
        x1, x2 = x_of(inv.index), x_of(end_idx) + X_SCALE - 6
        y = y_of(inv.process)
        is_bad = bad_idx is not None and (
            inv.index == bad_idx
            or (comp is not None and comp.index == bad_idx))
        stroke = "stroke='#d03030' stroke-width='2.5'" if is_bad \
            else "stroke='#888' stroke-width='0.5'"
        fill = TYPE_FILL.get(typ, "#dddddd")
        label = f"{inv.f} {comp.value if comp is not None else inv.value!r}"
        parts.append(
            f"<rect x='{x1}' y='{y}' width='{max(8, x2 - x1)}' "
            f"height='{BAR_H}' rx='3' fill='{fill}' {stroke}>"
            f"<title>{_esc(inv.to_dict())}</title></rect>")
        parts.append(
            f"<text x='{x1 + 3}' y='{y + 13}'>{_esc(label)}</text>")
        centers[inv.index] = (x1 + min(40, (x2 - x1) / 2), y + BAR_H / 2)

    # the furthest witnessed linearization as a numbered path
    paths = analysis.get("final_paths") or []
    best = max(paths, key=len) if paths else []
    pts = []
    for step, op in enumerate(best):
        idx = op.get("index") if isinstance(op, dict) else None
        if idx in centers:
            cx, cy = centers[idx]
            pts.append((cx, cy))
            parts.append(
                f"<circle cx='{cx}' cy='{cy}' r='8' fill='#205080' "
                f"opacity='0.85'/>"
                f"<text x='{cx - 3}' y='{cy + 4}' fill='#fff'>"
                f"{step + 1}</text>")
    if len(pts) > 1:
        d = "M " + " L ".join(f"{x:.0f} {y:.0f}" for x, y in pts)
        parts.append(f"<path d='{d}' fill='none' stroke='#205080' "
                     f"stroke-width='1.5' opacity='0.6'/>")

    if bad:
        parts.append(
            f"<text x='{LEFT}' y='{height - 20}' fill='#d03030'>"
            f"No configuration could linearize: "
            f"{_esc(bad.get('f'))} {_esc(bad.get('value'))} "
            f"(process {_esc(bad.get('process'))}, "
            f"index {_esc(bad_idx)})</text>")
    parts.append("</svg>")
    return "".join(parts)


def render_analysis(test: dict, history: History, analysis: dict,
                    opts: Optional[dict] = None) -> Optional[str]:
    """Write linear.svg into the test's store directory
    (checker.clj:205-212); returns the path, or None. Never raises —
    rendering failures must not mask the verdict."""
    try:
        doc = render(history, analysis)
        if doc is None or not test.get("name"):
            return None
        subdir = list((opts or {}).get("subdirectory", []))
        path = store.path_bang(test, *subdir, "linear.svg")
        with open(path, "w") as fh:
            fh.write(doc)
        return path
    except Exception:  # noqa: BLE001
        log.warning("linear.svg rendering failed", exc_info=True)
        return None
