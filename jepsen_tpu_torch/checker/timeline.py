"""HTML swimlane timeline of operations per process.

A copy of `jepsen_tpu/checker/timeline.py` (same page for the same
history). Capability parity with jepsen.checker.timeline
(`jepsen/src/jepsen/checker/timeline.clj`): one column per process,
one box per invoke/completion pair, colored by completion type, with
hover titles carrying the full op, duration, and error; capped at
10,000 ops so massive histories stay renderable (timeline.clj:12-14).
Pairing rides `History.pairs()` (the timeline.clj:38-57 algorithm).
Writes `timeline.html` into the test's store directory (or the per-key
subdirectory when run under `independent.checker`).
"""

from __future__ import annotations

import html as _html
from typing import Optional

from .. import store
from ..history import History
from . import Checker

OP_LIMIT = 10_000  # timeline.clj:12-14

COL_WIDTH = 100     # px
GUTTER_WIDTH = 106  # px
HEIGHT = 16         # px

STYLESHEET = """\
body        { font-family: sans-serif; }
.ops        { position: absolute; }
.op         { position: absolute; padding: 2px; border-radius: 2px;
              box-shadow: 0 1px 3px rgba(0,0,0,0.2); overflow: hidden;
              font-size: 11px; }
.op.invoke  { background: #eeeeee; }
.op.ok      { background: #79c7f7; }
.op.info    { background: #f7c36b; }
.op.fail    { background: #f7a8c8; }
.op:target  { box-shadow: 0 10px 20px rgba(0,0,0,0.3); }
.truncation-warning { background: #f7c36b; border: 1px solid #c08020;
              border-radius: 3px; padding: 8px 12px; margin: 8px 0;
              font-weight: bold; }
.nemesis-band { position: absolute; left: 0; z-index: -1;
              background: rgba(247, 195, 107, 0.30);
              border-left: 3px solid #c08020;
              border-top: 1px dashed #c08020;
              border-bottom: 1px dashed #c08020; }
"""


def _esc(x) -> str:
    return _html.escape(str(x), quote=True)


def _render_op(op) -> str:
    d = op.to_dict() if hasattr(op, "to_dict") else dict(op)
    core = {k: d.pop(k, None)
            for k in ("process", "type", "f", "index", "value")}
    lines = [f"process {core['process']}", f"type {core['type']}",
             f"f {core['f']}", f"index {core['index']}"]
    lines += [f"{k} {v!r}" for k, v in d.items()
              if k not in ("time",) and v is not None]
    lines.append(f"value {core['value']!r}")
    return "Op:\n" + "\n".join(" " + ln for ln in lines)


def _title(start, stop) -> str:
    parts = []
    if stop is not None and stop.time is not None \
            and start.time is not None:
        parts.append(f"Dur: {(stop.time - start.time) // 1_000_000} ms")
    err = getattr(stop or start, "error", None)
    if err is not None:
        parts.append(f"Err: {err!r}")
    parts.append("")
    parts.append(_render_op(stop or start))
    return "\n".join(parts)


def _body(start, stop) -> str:
    op = stop or start
    s = _esc(f"{op.process} {op.f}")
    if op.process != "nemesis":
        s += f" {_esc(repr(start.value))}"
    if stop is not None and stop.value != start.value:
        s += f"<br />{_esc(repr(stop.value))}"
    return s


def process_index(history) -> dict:
    """Map processes to columns: numeric processes sorted first, then
    named ones like "nemesis" (timeline.clj:161-167)."""
    procs = {op.process for op in history}
    nums = sorted(p for p in procs if isinstance(p, int))
    names = sorted((p for p in procs if not isinstance(p, int)), key=str)
    return {p: i for i, p in enumerate(nums + names)}


def nemesis_bands(history, pairs) -> list:
    """Fault windows in ROW coordinates: [(row_open, row_close, f)],
    using the same start/stop pairing the latency plots shade with
    (util.nemesis_intervals) so both renderings agree on what counts
    as a window. Ops truncated off the page clamp to the last row; a
    window still open at the end extends there too."""
    from ..util import nemesis_intervals
    row_of = {}
    for row, (start, stop) in enumerate(pairs):
        if start.index is not None:
            row_of[start.index] = row
        if stop is not None and stop.index is not None:
            row_of[stop.index] = row
    bands = set()
    for s, e in nemesis_intervals(history):
        r0 = row_of.get(s.index)
        if r0 is None:
            continue  # the opening op fell past the truncation cap
        r1 = (row_of.get(e.index, len(pairs))
              if e is not None else len(pairs))
        bands.add((r0, max(r1, r0 + 1), str(s.f)))
    return sorted(bands)


def render(test: dict, history: History, history_key=None) -> str:
    """The timeline page as an HTML string."""
    all_pairs = History(history).pairs()
    # row = order of invocation (timeline.clj:169-174)
    truncated = len(all_pairs) > OP_LIMIT
    pairs = all_pairs[:OP_LIMIT]
    pindex = process_index([s for s, _ in pairs])

    divs = []
    # nemesis fault windows as shaded bands BEHIND the op boxes, so
    # fault injection and the anomalies it provoked line up visually
    band_width = GUTTER_WIDTH * max(len(pindex), 1)
    for r0, r1, f in nemesis_bands(history, pairs):
        top = HEIGHT * (r0 + 1)
        height = HEIGHT * max(r1 - r0, 1)
        divs.append(
            f"<div class='nemesis-band' style='top:{top}px;"
            f"height:{height}px;width:{band_width}px' "
            f"title='nemesis window: {_esc(f)} "
            f"(rows {r0}&#8211;{r1})'></div>")
    for row, (start, stop) in enumerate(pairs):
        op = stop or start
        typ = op.type
        left = GUTTER_WIDTH * pindex.get(start.process, 0)
        top = HEIGHT * (row + 1)
        style = (f"width:{COL_WIDTH}px;left:{left}px;top:{top}px;"
                 f"height:{HEIGHT}px")
        idx = op.index if op.index is not None else row
        divs.append(
            f"<a href='#i{idx}'><div class='op {_esc(typ)}' id='i{idx}' "
            f"style='{style}' title='{_esc(_title(start, stop))}'>"
            f"{_body(start, stop)}</div></a>")

    head = f"<h1>{_esc(test.get('name'))}"
    if history_key is not None:
        head += f" key {_esc(history_key)}"
    head += "</h1>"
    warn = ""
    if truncated:
        # a VISIBLE banner (styled above): silently dropping the tail
        # made huge histories look complete
        warn = (f"<div class='truncation-warning'>&#9888; truncated: "
                f"showing {OP_LIMIT:,} of {len(all_pairs):,} ops "
                f"(the remaining {len(all_pairs) - OP_LIMIT:,} are in "
                f"history.txt)</div>")
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<style>{STYLESHEET}</style></head><body>{head}{warn}"
            f"<div class='ops'>{''.join(divs)}</div></body></html>")


class TimelineHtml(Checker):
    """Writes timeline.html (timeline.clj:176-209)."""

    def check(self, test, history, opts=None):
        opts = opts or {}
        subdir = list(opts.get("subdirectory", []))
        doc = render(test, history, opts.get("history_key"))
        if test.get("name"):
            p = store.path_bang(test, *subdir, "timeline.html")
            with open(p, "w") as fh:
                fh.write(doc)
        return {"valid?": True}


def html() -> Checker:
    return TimelineHtml()
