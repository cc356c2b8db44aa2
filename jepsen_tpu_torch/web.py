"""The port's web frontend: the run browser, the live panels and the
checker service's HTTP front door, a copy of `jepsen_tpu/web.py`.

A standard-library `ThreadingHTTPServer` over a store root (default the
port's own, `store/torch`) and an optional `service.Service`, with
direct HTML strings and no external dependencies. Validity comes from
`JepsenFile.read_valid()`, which reads just the results block, never
the history; results are memoized except for the most recent few runs,
which may still be mid-write.

    GET  /                       every stored run, colored by validity
    GET  /status                 the live run panel (auto-refreshing),
                                 from the snapshot /status.json serves
    GET  /occupancy, /devices,   the occupancy, device-memory, doctor,
         /doctor, /slo,          SLO and autopilot panels of the same
         /autopilot              snapshot
    GET  /fleet, /fleet.json     the federated view of the replicas'
                                 stores (`observatory.py`; roots from
                                 JEPSEN_TPU_FLEET_ROOTS, else discovery
                                 around this store)
    GET  /runs, /runs/<id>       the run ledger, and one record with its
                                 artifact links and doctor findings
    GET  /files/<path>           a file with its content type, a
                                 directory's browse page, `<dir>.zip`
                                 the whole directory; 403 outside the
                                 store root
    POST /check                  submit a request (202; 400 on a body
                                 the service refuses; 503 with
                                 Retry-After while the service sheds;
                                 503 without a service)
    GET  /events                 the service's global feed, as
                                 Server-Sent Events
    GET  /runs/<id>/events       one request's lifecycle as SSE
                                 (snapshot, queued, serving, done, end)
    GET  /status.json            the live status: the service, SLO and
                                 autopilot blocks, the preflight, device,
                                 mesh and doctor blocks, and the last
                                 ledger runs
    GET  /runs.json              the run ledger, newest first
    GET  /runs/<id>.json         one ledger record, with the doctor's
                                 compact diagnosis of it
    GET  /runs/<id>/perfetto.json  a record's exported trace as a
                                 Perfetto document

The pages are the reference's byte for byte over the same store, but
for the package named in their command hints.
"""

from __future__ import annotations

import html
import io
import json
import logging
import os
import re
import threading
import time
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import fleet, store
from . import ledger as ledger_mod

log = logging.getLogger("jepsen_tpu_torch.web")

# Ledger entries surfaced on /status.json's last_runs block.
LAST_RUNS = 8

# POST /check bodies larger than this are refused outright (a 10k-op
# history is ~1 MB of JSON; this bound is generous, not a quota).
MAX_POST_BYTES = 64 << 20

# SSE defaults: a stream with no explicit ?wait= cap closes itself
# after this long so abandoned clients can't pin handler threads
# forever; ?limit= bounds the event count (the tests use both).
SSE_MAX_WAIT_S = 300.0

VALID_COLORS = {
    True: "#79c77a",       # ok: green
    "unknown": "#f2b75c",  # indeterminate: amber
    False: "#ee7785",      # invalid: red
    None: "#e3e3e3",       # no results yet
}

CONTENT_TYPES = {
    ".txt": "text/plain; charset=utf-8",
    ".log": "text/plain; charset=utf-8",
    ".json": "text/plain; charset=utf-8",
    ".jsonl": "text/plain; charset=utf-8",
    ".edn": "text/plain; charset=utf-8",
    ".html": "text/html; charset=utf-8",
    ".svg": "image/svg+xml",
    ".png": "image/png",
    ".jpg": "image/jpeg",
    ".jpeg": "image/jpeg",
    ".gif": "image/gif",
    ".zip": "application/zip",
}

_IMG_RE = re.compile(r"\.(png|jpe?g|gif|svg)$", re.I)
_TEXT_RE = re.compile(r"\.(txt|edn|json|jsonl|ya?ml|log|stdout|stderr)$",
                      re.I)

# How many of the most recent runs to re-read on every page load — they
# may still be running (web.clj:57-61).
MUTABLE_WINDOW = 2


class _ValidityCache:
    """Memoized {(name, time): valid?} over the store (web.clj:48-92)."""

    def __init__(self, store_root: str):
        self.store_root = store_root
        self.cache: dict = {}
        self.lock = threading.Lock()
        # whole-table cache keyed on the store walk's (mtime, size)
        # identity — see runs()
        self._runs_key: Optional[tuple] = None
        self._runs_out: Optional[list] = None

    def read_valid(self, run_dir: str):
        jf_path = os.path.join(run_dir, "test.jepsen")
        try:
            jf = store.JepsenFile(jf_path, "r")
            try:
                return jf.read_valid()
            finally:
                jf.close()
        except FileNotFoundError:
            return None
        except Exception:  # torn mid-write file etc.
            log.warning("Unable to parse %s", jf_path, exc_info=True)
            return "incomplete"

    def runs(self) -> list:
        """[(name, time, path, valid?)] sorted newest-first.

        The whole table is cached on the store walk's (mtime_ns,
        size) identity — every run's test.jepsen stat, pure stats, no
        file reads — so the SSE/status polling the service plane
        added never turns the home page into a per-request disk scan
        (the `_last_runs`/`doctor_for_record` keying, applied here).
        A mid-write run's file changes its stat, which invalidates
        the table and re-reads it through the MUTABLE_WINDOW rule."""
        entries = []
        sig = []
        for name, by_time in store.tests(self.store_root).items():
            for t, path in by_time.items():
                entries.append((t, name, path))
                try:
                    st = os.stat(os.path.join(path, "test.jepsen"))
                    sig.append((name, t, st.st_mtime_ns, st.st_size))
                except OSError:
                    sig.append((name, t, None, None))
        entries.sort(reverse=True)
        key = tuple(sorted(sig))
        with self.lock:
            if key == self._runs_key and self._runs_out is not None:
                return list(self._runs_out)
            out = []
            for i, (t, name, path) in enumerate(entries):
                ck = (name, t)
                if i >= MUTABLE_WINDOW and ck in self.cache:
                    v = self.cache[ck]
                else:
                    v = self.read_valid(path)
                    self.cache[ck] = v
                out.append((name, t, path, v))
            self._runs_key = key
            self._runs_out = out
        return list(out)


def _esc(s) -> str:
    return html.escape(str(s), quote=True)


def _file_href(store_root: str, path: str) -> str:
    rel = os.path.relpath(path, store_root)
    return "/files/" + "/".join(
        urllib.parse.quote(c) for c in rel.split(os.sep))


def _page(title: str, body: str) -> bytes:
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_esc(title)}</title>"
            f"<style>body{{font-family:sans-serif;margin:1.5em}}"
            f"table{{border-collapse:collapse}}"
            f"td,th{{padding:4px 10px;text-align:left}}"
            f"a{{color:#205080}}</style></head>"
            f"<body>{body}</body></html>").encode()


_RUN_ID = r"([A-Za-z0-9][\w.-]*)"


def _idle_status() -> dict:
    """The documented live-status schema with no run in progress."""
    return {"schema": 1, "active": False, "test": None, "phase": None,
            "started": None, "updated": None, "elapsed_s": None,
            "eta_s": None,
            "keys": {"total": 0, "decided": 0, "live": 0, "failures": 0},
            "devices": {}, "search": {},
            "nemesis": {"active": False, "f": None, "since_s": None},
            "ops": {"invoked": 0, "completed": 0}, "faults": [],
            "watchdog": {"stalls": 0, "last_source": None},
            "occupancy": {"active": False}}


def status_snapshot(store_root: str) -> dict:
    """The live status served at /status.json: the ambient
    `fleet.RunStatus` when one is installed (a run in this process),
    else the throttled `current-status.json` mirror that a run in
    another process writes under `store_root`, else the idle schema;
    the admission (`preflight`), device (`hbm`), mesh, doctor, service,
    SLO and autopilot blocks of this process, each of which leaves a
    mirror's own block in place while this process's is idle; and the
    last ledger runs under `store_root`. Always returns the documented
    schema."""
    st = fleet.get_default()
    if st.enabled:
        snap = st.snapshot()
    else:
        snap = fleet.read_status_file(store_root)
    if snap is None:
        snap = _idle_status()
    # pre-occupancy mirrors (an older run's current-status.json) still
    # answer the documented schema
    snap.setdefault("occupancy", {"active": False})
    try:
        from .analysis import preflight
        pf = preflight.snapshot()
        if pf["checked"] or "preflight" not in snap:
            snap["preflight"] = pf
    except Exception:  # noqa: BLE001 — the status answer must not
        snap.setdefault("preflight",  # depend on the analysis plane
                        {"checked": 0, "verdicts": {}, "recent": []})
    # device observatory (devices.py): a monitor that has polled wins;
    # where the run's device labels match the monitor's, the devices
    # table carries the memory column too
    try:
        from . import devices as devices_mod
        hb = devices_mod.snapshot()
        if hb["polls"] or "hbm" not in snap:
            snap["hbm"] = hb
        for label, mem in (snap.get("hbm") or {}).get(
                "devices", {}).items():
            d = (snap.get("devices") or {}).get(label)
            if isinstance(d, dict) and mem.get("stats"):
                d["hbm"] = {k: mem.get(k) for k in
                            ("bytes_in_use", "peak_bytes_in_use",
                             "bytes_limit", "utilization")
                            if mem.get(k) is not None}
    except Exception:  # noqa: BLE001 — the status answer must not
        snap.setdefault("hbm", {"active": False})  # need the monitor
    try:
        from .parallel import mesh as mesh_mod
        ms = mesh_mod.snapshot()
        if ms["runs"] or "mesh" not in snap:
            snap["mesh"] = ms
    except Exception:  # noqa: BLE001 — the status answer must not
        snap.setdefault("mesh",        # depend on the mesh plane
                        {"active": False, "runs": 0, "steals": 0,
                         "rebuckets": 0, "last": None})
    # diagnosis plane (doctor.py): diagnoses run in this process win;
    # a mirror from another process keeps its own block, and the idle
    # stub keeps the documented schema answerable
    try:
        from . import doctor as doctor_mod
        dc = doctor_mod.snapshot()
        if dc["checked"] or "doctor" not in snap:
            snap["doctor"] = dc
    except Exception:  # noqa: BLE001 — the status answer must not
        snap.setdefault("doctor",      # depend on the doctor plane
                        {"checked": 0, "findings": {},
                         "healthy_last": None, "recent": []})
    try:
        from . import service as service_mod
        sv = service_mod.snapshot()
        if sv.get("active") or sv.get("submitted") \
                or "service" not in snap:
            snap["service"] = sv
    except Exception:  # noqa: BLE001 — the status answer must not
        snap.setdefault("service",  # depend on the service plane
                        {"active": False, "queued": 0,
                         "submitted": 0, "served": 0})
    try:
        from . import slo as slo_mod
        sl = slo_mod.snapshot()
        if sl.get("checked") or "slo" not in snap:
            snap["slo"] = sl
    except Exception:  # noqa: BLE001 — the status answer must not
        snap.setdefault("slo",       # depend on the SLO plane
                        {"checked": 0, "alerts_total": 0,
                         "burning": [], "last": None})
    # autopilot plane (autopilot.py): the serving process's supervisor
    # wins; a mirror from another process keeps its own block, and the
    # idle stub keeps the documented schema answerable
    try:
        from . import autopilot as autopilot_mod
        apt = autopilot_mod.snapshot()
        if apt.get("active") or apt.get("steps") \
                or "autopilot" not in snap:
            snap["autopilot"] = apt
    except Exception:  # noqa: BLE001 — the status answer must not
        snap.setdefault("autopilot",  # depend on the autopilot plane
                        {"active": False})
    try:
        snap["last_runs"] = _last_runs(store_root)
    except Exception:  # noqa: BLE001 — a torn ledger never breaks
        snap["last_runs"] = []  # the live answer
    return snap


# last_runs cache: re-parsing a long-lived index.jsonl per request would
# scale with total records; the index signature invalidates on any
# append.
_LAST_RUNS_CACHE: dict = {}


def _last_runs(store_root: str) -> list:
    led = ledger_mod.Ledger(store_root)
    key = led.index_signature()
    if key is None:
        return []
    cached = _LAST_RUNS_CACHE.get(store_root)
    if cached is not None and cached[0] == key:
        return cached[1]
    rows = ledger_mod.compact(led.query(limit=LAST_RUNS, newest_first=True))
    _LAST_RUNS_CACHE[store_root] = (key, rows)
    return rows


_DEV_STATE_COLORS = {"searching": "#79c7f7", "fallback": "#f2b75c",
                     "fault": "#ee7785", "idle": "#e3e3e3"}


def render_status(store_root: str) -> bytes:
    """The auto-refreshing /status panel: frontier/backlog, per-device
    state, decided-rate ETA, and the active nemesis window — all from
    the same snapshot /status.json serves."""
    s = status_snapshot(store_root)
    k = s.get("keys") or {}
    sr = s.get("search") or {}
    n = s.get("nemesis") or {}
    parts = ["<meta http-equiv='refresh' content='2'>",
             "<a href='/'>jepsen_tpu</a> / status",
             f"<h1>{_esc(s.get('test') or 'no active run')}</h1>"]
    state = "RUNNING" if s.get("active") else "idle / finished"
    parts.append(f"<p>state <b>{_esc(state)}</b>"
                 f" &middot; phase <b>{_esc(s.get('phase'))}</b>"
                 f" &middot; elapsed {_esc(s.get('elapsed_s', '?'))}s"
                 + (f" &middot; ETA ~{_esc(s['eta_s'])}s"
                    if s.get("eta_s") is not None else "")
                 + "</p>")
    if n.get("active"):
        parts.append(
            f"<p style='background:{VALID_COLORS['unknown']};"
            f"padding:6px'>nemesis window OPEN: "
            f"<b>{_esc(n.get('f'))}</b> since t+{_esc(n.get('since_s'))}s"
            f"</p>")
    if k.get("total"):
        parts.append(
            f"<p>keys decided {k.get('decided', 0)}/{k['total']}"
            f" &middot; live {k.get('live', 0)}"
            f" &middot; failures {k.get('failures', 0)}</p>")
    if sr:
        cells = "".join(
            f"<tr><td>{_esc(f)}</td><td>{_esc(v)}</td></tr>"
            for f, v in sorted(sr.items()))
        parts.append("<h2>search</h2><table><tbody>"
                     + cells + "</tbody></table>")
    devs = s.get("devices") or {}
    if devs:
        rows = []
        for name, d in sorted(devs.items()):
            color = _DEV_STATE_COLORS.get(d.get("state"),
                                          VALID_COLORS[None])
            rows.append(
                f"<tr><td>{_esc(name)}</td>"
                f"<td style='background:{color}'>"
                f"{_esc(d.get('state'))}</td>"
                f"<td>{_esc(d.get('keys_done'))}</td>"
                f"<td>{_esc(d.get('last_key'))}</td>"
                f"<td>{_esc(d.get('busy_s'))}</td>"
                f"<td>{_esc(d.get('faults'))}</td></tr>")
        parts.append(
            "<h2>devices</h2><table><thead><tr><th>device</th>"
            "<th>state</th><th>keys</th><th>last key</th>"
            "<th>busy s</th><th>faults</th></tr></thead><tbody>"
            + "".join(rows) + "</tbody></table>")
    ops = s.get("ops") or {}
    if ops.get("invoked"):
        parts.append(f"<p>ops invoked {ops['invoked']} / completed "
                     f"{ops.get('completed', 0)}</p>")
    faults = s.get("faults") or []
    if faults:
        items = "".join(
            f"<li><b>{_esc(f.get('type'))}</b> on "
            f"{_esc(f.get('device'))} key {_esc(f.get('key_index'))}: "
            f"{_esc(f.get('error'))}</li>" for f in faults[-8:])
        parts.append("<h2>faults</h2><ul>" + items + "</ul>")
    w = s.get("watchdog") or {}
    if w.get("stalls"):
        parts.append(
            f"<p style='background:{VALID_COLORS[False]};padding:6px'>"
            f"watchdog: <b>{_esc(w['stalls'])}</b> stall(s), last "
            f"source {_esc(w.get('last_source'))}</p>")
    last = s.get("last_runs") or []
    if last:
        rows = "".join(
            f"<tr><td><a href='/runs/{_esc(r.get('id'))}'>"
            f"{_esc(r.get('id'))}</a></td>"
            f"<td>{_esc(r.get('kind'))}</td><td>{_esc(r.get('name'))}"
            f"</td><td style='background:"
            f"{VALID_COLORS.get(r.get('verdict'), VALID_COLORS[None])}'>"
            f"{_esc(r.get('verdict'))}</td>"
            f"<td>{_esc(r.get('wall_s'))}</td></tr>" for r in last)
        parts.append("<h2>recent runs</h2><table><thead><tr>"
                     "<th>id</th><th>kind</th><th>name</th>"
                     "<th>verdict</th><th>wall s</th></tr></thead>"
                     f"<tbody>{rows}</tbody></table>")
    occ = s.get("occupancy") or {}
    if occ.get("active"):
        parts.append(
            f"<p>occupancy: fill last <b>{_esc(occ.get('fill_last'))}"
            f"</b> &middot; mean {_esc(occ.get('fill_mean'))} &middot; "
            f"<a href='/occupancy'>occupancy panel</a></p>")
    hbm = s.get("hbm") or {}
    if hbm.get("active"):
        peak = hbm.get("peak_seen_bytes")
        parts.append(
            f"<p>devices: {_esc(hbm.get('stats_available'))}/"
            f"{_esc(hbm.get('n_devices'))} reporting memory stats"
            + (f" &middot; peak seen {_esc(_fmt_bytes(peak))}"
               if peak is not None else "")
            + " &middot; <a href='/devices'>devices panel</a></p>")
    ms = s.get("mesh") or {}
    if ms.get("runs"):
        last = ms.get("last") or {}
        parts.append(
            f"<p>mesh fan-out: {_esc(ms.get('runs'))} run(s) &middot; "
            f"steals {_esc(ms.get('steals'))} &middot; rebuckets "
            f"{_esc(ms.get('rebuckets'))}"
            + (f" &middot; last skew "
               f"{_esc(last.get('work_skew_after'))} over "
               f"{_esc(last.get('n_devices'))} shards"
               if last else "") + "</p>")
    dc = s.get("doctor") or {}
    top = dc.get("top")
    if dc.get("checked") and top:
        color = _SEVERITY_COLORS.get(top.get("severity"),
                                     VALID_COLORS[None])
        parts.append(
            f"<p>doctor: <b style='background:{color};"
            f"padding:1px 6px'>{_esc(top.get('rule'))}</b> "
            f"{_esc(top.get('summary'))} &middot; "
            f"<a href='/doctor'>doctor panel</a></p>")
    sv = s.get("service") or {}
    if sv.get("active") or sv.get("submitted"):
        parts.append(
            f"<p>service: {_esc(sv.get('served'))} served / "
            f"{_esc(sv.get('queued'))} queued &middot; warm rate "
            f"{_esc(sv.get('warm_rate'))} &middot; rejected "
            f"{_esc(sv.get('rejected'))} &middot; "
            f"<a href='/slo'>slo panel</a> &middot; "
            f"<a href='/events'>event stream</a></p>")
    sl = s.get("slo") or {}
    if sl.get("burning"):
        parts.append(
            f"<p style='background:{VALID_COLORS[False]};padding:6px'>"
            f"SLO burn alert: <b>{_esc(sl['burning'])}</b> &middot; "
            f"<a href='/slo'>slo panel</a></p>")
    parts.append("<p><a href='/status.json'>status.json</a> &middot; "
                 "<a href='/occupancy'>occupancy</a> &middot; "
                 "<a href='/devices'>devices</a> &middot; "
                 "<a href='/doctor'>doctor</a> &middot; "
                 "<a href='/slo'>slo</a> &middot; "
                 "<a href='/autopilot'>autopilot</a> &middot; "
                 "<a href='/runs'>run ledger</a></p>")
    return _page("status", "".join(parts))


def _fill_color(fill) -> str:
    """Green past the ROADMAP fill target (occupancy.TARGET_FILL —
    the one policy number plots/bench/web share), amber midway, red
    when the lanes are mostly empty."""
    from . import occupancy as occupancy_mod
    try:
        f = float(fill)
    except (TypeError, ValueError):
        return VALID_COLORS[None]
    if f >= occupancy_mod.TARGET_FILL:
        return VALID_COLORS[True]
    if f >= occupancy_mod.TARGET_FILL / 2:
        return VALID_COLORS["unknown"]
    return VALID_COLORS[False]


def render_occupancy(store_root: str) -> bytes:
    """The auto-refreshing /occupancy panel: the kernel-occupancy
    block from the same snapshot /status.json serves — last/mean
    frontier fill against the 0.8 target, per-lane stats for the
    batched fan-out, and a bar strip of the most recent per-round
    fills (doc/OBSERVABILITY.md "Occupancy & roofline")."""
    s = status_snapshot(store_root)
    occ = s.get("occupancy") or {}
    parts = ["<meta http-equiv='refresh' content='2'>",
             "<a href='/'>jepsen_tpu</a> / "
             "<a href='/status'>status</a> / occupancy",
             f"<h1>kernel occupancy"
             f" &middot; {_esc(s.get('test') or 'no active run')}</h1>"]
    if not occ.get("active"):
        parts.append("<p>no occupancy data yet — runs record it when "
                     "metrics or a RunStatus are enabled "
                     "(doc/OBSERVABILITY.md)</p>")
        return _page("occupancy", "".join(parts))
    rows = "".join(
        f"<tr><td>{_esc(k)}</td><td>{_esc(occ.get(k))}</td></tr>"
        for k in ("mode", "kernel", "platform", "K", "rounds_seen",
                  "rounds_dropped"))
    fill_cells = "".join(
        f"<tr><td>{_esc(k)}</td><td style='background:"
        f"{_fill_color(occ.get(k))}'>{_esc(occ.get(k))}</td></tr>"
        for k in ("fill_last", "fill_mean"))
    from . import occupancy as occupancy_mod
    parts.append("<table><tbody>" + rows + fill_cells
                 + "</tbody></table>"
                 f"<p>target: mean fill &ge; "
                 f"{occupancy_mod.TARGET_FILL} (ROADMAP item 5)</p>")
    ad = occ.get("adapt") or {}
    if ad:
        parts.append(
            f"<p>adaptive ladder {_esc(ad.get('ladder'))} &middot; "
            f"{_esc(ad.get('switches'))} switch(es) this search — "
            f"K above is the live bucket</p>")
    lanes = occ.get("lanes") or {}
    if lanes:
        parts.append(
            f"<h2>lanes</h2><p>{_esc(lanes.get('n'))} lanes &middot; "
            f"fill min {_esc(lanes.get('fill_min'))} / max "
            f"{_esc(lanes.get('fill_max'))} &middot; "
            f"<b>{_esc(lanes.get('empty'))}</b> empty</p>")
    elle = occ.get("elle") or {}
    if elle:
        parts.append(
            f"<h2>elle closure</h2><p>kernel "
            f"<b>{_esc(elle.get('kernel'))}</b> &middot; n "
            f"{_esc(elle.get('n'))} / {_esc(elle.get('edges'))} edges"
            f" &middot; {_esc(elle.get('iters_run'))} iters in "
            f"{_esc(elle.get('kernel_s'))}s &middot; reach density "
            f"{_esc(elle.get('reach_density'))} "
            f"(doc/OBSERVABILITY.md \"Elle device plane\")</p>")
    recent = occ.get("recent") or []
    if recent:
        bars = "".join(
            f"<div title='round {_esc(r.get('round'))}: "
            f"{_esc(r.get('fill'))}' style='display:inline-block;"
            f"width:6px;margin:0 1px;vertical-align:bottom;"
            f"height:{max(2, int(float(r.get('fill') or 0) * 80))}px;"
            f"background:{_fill_color(r.get('fill'))}'></div>"
            for r in recent[-80:])
        parts.append("<h2>recent rounds (fill)</h2>"
                     "<div style='height:84px;border-bottom:1px solid "
                     "#ccc'>" + bars + "</div>")
    parts.append("<p><a href='/status.json'>status.json</a> (the "
                 "`occupancy` block)</p>")
    return _page("occupancy", "".join(parts))


def _fmt_bytes(v) -> str:
    try:
        v = float(v)
    except (TypeError, ValueError):
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return f"{v:.2f} {unit}" if unit != "B" else f"{int(v)} B"
        v /= 1024
    return f"{v:.2f} GiB"


def render_devices(store_root: str) -> bytes:
    """The auto-refreshing /devices panel (doc/OBSERVABILITY.md
    "Device & memory plane"): live HBM accounting per device —
    bytes in use vs the chip's own limit, the run's sampled peak —
    joined with the fleet's per-device shard state from the same
    snapshot /status.json serves. Backends without allocator stats
    (cpu tier-1) show the explicit no-stats marker, never zeros."""
    s = status_snapshot(store_root)
    hbm = s.get("hbm") or {}
    devs_mem = hbm.get("devices") or {}
    devs_fleet = s.get("devices") or {}
    parts = ["<meta http-equiv='refresh' content='2'>",
             "<a href='/'>jepsen_tpu</a> / "
             "<a href='/status'>status</a> / devices",
             f"<h1>device observatory"
             f" &middot; {_esc(s.get('test') or 'no active run')}</h1>"]
    if not hbm.get("active"):
        parts.append(
            "<p>no device samples yet — the monitor records when a "
            "bench/run installs one or JEPSEN_TPU_DEVICES=1 "
            "(doc/OBSERVABILITY.md \"Device &amp; memory plane\")</p>")
    else:
        parts.append(
            f"<p>{_esc(hbm.get('n_devices'))} device(s), "
            f"{_esc(hbm.get('stats_available'))} reporting memory "
            f"stats &middot; {_esc(hbm.get('polls'))} poll(s)"
            + (f" &middot; peak seen "
               f"<b>{_esc(_fmt_bytes(hbm.get('peak_seen_bytes')))}</b>"
               if hbm.get("peak_seen_bytes") is not None else "")
            + "</p>")
        rows = []
        for label in sorted(devs_mem):
            m = devs_mem[label] or {}
            fl = devs_fleet.get(label) or {}
            if m.get("stats"):
                util = m.get("utilization")
                bar = ""
                if util is not None:
                    pct = max(0, min(100, int(float(util) * 100)))
                    color = (VALID_COLORS[False] if pct > 85 else
                             VALID_COLORS["unknown"] if pct > 60
                             else VALID_COLORS[True])
                    bar = (f"<div style='background:#eee;width:120px'>"
                           f"<div style='background:{color};width:"
                           f"{max(pct, 2)}%;height:10px'></div></div>"
                           f"{pct}%")
                limit = (_esc(_fmt_bytes(m.get("bytes_limit")))
                         if m.get("bytes_limit") is not None
                         else "n/a")
                mem_cells = (
                    f"<td>{_esc(_fmt_bytes(m.get('bytes_in_use')))}"
                    f"</td><td>"
                    f"{_esc(_fmt_bytes(m.get('peak_seen')))}</td>"
                    f"<td>{limit}</td><td>{bar}</td>")
            else:
                mem_cells = ("<td colspan='4' style='color:#888'>"
                             "no allocator stats (backend reports "
                             "none)</td>")
            rows.append(
                f"<tr><td>{_esc(label)}</td>"
                f"<td>{_esc(m.get('kind') or '?')}</td>" + mem_cells
                + f"<td>{_esc(fl.get('state') or '-')}</td>"
                  f"<td>{_esc(fl.get('keys_done', '-'))}</td></tr>")
        parts.append(
            "<table><thead><tr><th>device</th><th>kind</th>"
            "<th>in use</th><th>peak seen</th><th>limit</th>"
            "<th>util</th><th>state</th><th>keys</th></tr></thead>"
            "<tbody>" + "".join(rows) + "</tbody></table>")
    parts.append("<p><a href='/status.json'>status.json</a> (the "
                 "`hbm` block) &middot; "
                 "<a href='/occupancy'>occupancy</a></p>")
    return _page("devices", "".join(parts))


# /doctor diagnoses the newest ledger record on demand; the (mtime,
# size) key means a 2 s auto-refresh re-diagnoses only when the
# ledger actually grew.
_DOCTOR_CACHE: dict = {}

_SEVERITY_COLORS = {"critical": VALID_COLORS[False],
                    "warn": VALID_COLORS["unknown"],
                    "info": VALID_COLORS[None]}


def _doctor_latest(store_root: str):
    """The report the /doctor panel renders: the last IN-PROCESS
    diagnosis when one ran (the bench / serve-during-run path), else
    a fresh diagnosis of the newest ledger record (cached on the
    index file's identity)."""
    from . import doctor as doctor_mod
    rep = doctor_mod.last_report()
    if rep is not None:
        return rep
    led = ledger_mod.Ledger(store_root)
    try:
        st = os.stat(led.index_path)
        key = (st.st_mtime_ns, st.st_size)
    except OSError:
        return None
    cached = _DOCTOR_CACHE.get(store_root)
    if cached is not None and cached[0] == key:
        return cached[1]
    try:
        view = doctor_mod.run_view(store_root, "latest")
        rep = doctor_mod.diagnose(view)
    except KeyError:
        rep = None
    _DOCTOR_CACHE[store_root] = (key, rep)
    return rep


# record diagnoses cached per RECORD-FILE identity — a polled
# /runs/<id>.json must not re-scan the whole ledger index (twice:
# query + the D008 prior sweep) plus the trace artifact per request.
# Keying on the record's own (mtime, size) keeps the cache hot while
# unrelated runs append to the index; the D008 baseline inside a
# cached diagnosis may lag new doctor records, which is fine for a
# finished record's page.
_DOCTOR_REC_CACHE: dict = {}


def doctor_for_record(store_root: str, run_id: str):
    """The compact `doctor` block attached to /runs/<id>(.json):
    diagnose that one record's telemetry, or None when the doctor
    can't (a missing record 404s before this runs; a failing rule
    never breaks the record page)."""
    try:
        from . import doctor as doctor_mod
        led = ledger_mod.Ledger(store_root)
        try:
            st = os.stat(led.record_path(str(run_id)))
            key = (store_root, run_id, st.st_mtime_ns, st.st_size)
        except (OSError, TypeError):
            key = None
        if key is not None and key in _DOCTOR_REC_CACHE:
            return _DOCTOR_REC_CACHE[key]
        rep = doctor_mod.diagnose(doctor_mod.run_view(store_root,
                                                      run_id))
        out = doctor_mod.compact_report(rep)
        if key is not None:
            _DOCTOR_REC_CACHE[key] = out
            while len(_DOCTOR_REC_CACHE) > 256:  # bounded
                _DOCTOR_REC_CACHE.pop(next(iter(_DOCTOR_REC_CACHE)))
        return out
    except Exception:  # noqa: BLE001
        return None


def render_doctor(store_root: str) -> bytes:
    """The auto-refreshing /doctor panel (doc/OBSERVABILITY.md
    "Diagnosis plane"): the ranked findings of the most recent
    diagnosis — rule id, severity, subject, evidence pointers, and
    the suggested action — over the same ledger /runs serves."""
    s = status_snapshot(store_root)
    rep = _doctor_latest(store_root)
    parts = ["<meta http-equiv='refresh' content='2'>",
             "<a href='/'>jepsen_tpu</a> / "
             "<a href='/status'>status</a> / doctor",
             "<h1>run doctor"
             f" &middot; {_esc(s.get('test') or 'no active run')}</h1>"]
    if rep is None:
        parts.append(
            "<p>nothing to diagnose yet — the doctor reads ledger "
            "records and telemetry artifacts "
            "(doc/OBSERVABILITY.md \"Diagnosis plane\"; "
            "<code>python -m jepsen_tpu_torch doctor</code>)</p>")
        return _page("doctor", "".join(parts))
    verdict_color = (VALID_COLORS[True] if rep.get("healthy")
                     else VALID_COLORS[False])
    verdict = ("HEALTHY — no findings" if rep.get("healthy") else
               f"{len(rep.get('findings') or [])} finding(s): "
               f"{', '.join(rep.get('rules_fired') or [])}")
    parts.append(
        f"<p>target <b>{_esc(rep.get('target'))}</b> &middot; "
        f"platform {_esc(rep.get('platform'))} &middot; "
        f"<b style='background:{verdict_color};padding:2px 8px'>"
        f"{_esc(verdict)}</b></p>")
    rows = []
    for f in rep.get("findings") or []:
        color = _SEVERITY_COLORS.get(f.get("severity"),
                                     VALID_COLORS[None])
        ev = "; ".join(
            f"{_esc(e.get('series'))}.{_esc(e.get('field'))}"
            f"={_esc(e.get('values'))}"
            for e in (f.get("evidence") or [])[:2])
        rows.append(
            f"<tr><td>{_esc(f.get('rule'))}</td>"
            f"<td>{_esc(f.get('name'))}</td>"
            f"<td style='background:{color}'>"
            f"{_esc(f.get('severity'))}</td>"
            f"<td>{_esc(f.get('subject') or '-')}</td>"
            f"<td>{_esc(f.get('summary'))}<br>"
            f"<span style='color:#555'>{ev}</span></td>"
            f"<td>{_esc(f.get('action') or '-')}"
            + (f"<br><span style='color:#555'>remedy: "
               f"{_esc(f.get('remedy'))}</span>"
               if f.get("remedy") else "") + "</td></tr>")
    if rows:
        parts.append(
            "<table><thead><tr><th>rule</th><th>name</th>"
            "<th>severity</th><th>subject</th><th>finding</th>"
            "<th>suggested action</th></tr></thead><tbody>"
            + "".join(rows) + "</tbody></table>")
    ph = rep.get("phases") or {}
    if ph.get("dominant"):
        parts.append(
            f"<p>dominant trace phase <b>{_esc(ph['dominant'])}</b> "
            f"({_esc(ph.get('dominant_share'))} of traced wall)</p>")
    parts.append("<p><a href='/status.json'>status.json</a> (the "
                 "`doctor` block) &middot; "
                 "<a href='/autopilot'>autopilot</a> &middot; "
                 "<a href='/runs'>run ledger</a></p>")
    return _page("doctor", "".join(parts))


# /slo out-of-process fallback: evaluating a store's ledger per
# request would re-scan the index; the (mtime, size) key re-evaluates
# only when the ledger actually grew — PLUS a short TTL, because an
# SLO evaluation is time-dependent (rolling windows anchored at now):
# an unchanged ledger must still drain out of its windows rather than
# serve a frozen burn alert forever.
_SLO_CACHE: dict = {}
_SLO_CACHE_TTL_S = 5.0
# the serving process's own last evaluation is preferred only while
# fresh: evaluations happen after served batches, so once traffic
# stops the last report ages — and its windows must be allowed to
# drain (a burn alert is not forever) via the read-only fallback
_SLO_STALE_S = 60.0


def _slo_latest(store_root: str):
    """The compact evaluation the /slo panel renders: the serving
    process's own last evaluation when one ran recently, else a
    read-only evaluation of the store's ledger (cached on the index
    file's identity + a TTL)."""
    from . import slo as slo_mod
    last = slo_mod.last_report()
    if last is not None and \
            time.time() - float(last.get("t") or 0) < _SLO_STALE_S:
        return slo_mod.compact_report(last)
    led = ledger_mod.Ledger(store_root)
    try:
        st = os.stat(led.index_path)
        key = (st.st_mtime_ns, st.st_size)
    except OSError:
        return None
    cached = _SLO_CACHE.get(store_root)
    if cached is not None and cached[0] == key \
            and time.monotonic() - cached[2] < _SLO_CACHE_TTL_S:
        return cached[1]
    try:
        rep = slo_mod.compact_report(
            slo_mod.evaluate_store(store_root))
    except Exception:  # noqa: BLE001
        rep = None
    _SLO_CACHE[store_root] = (key, rep, time.monotonic())
    return rep


def render_slo(store_root: str) -> bytes:
    """The auto-refreshing /slo panel (doc/OBSERVABILITY.md "Service
    & SLO plane"): every objective's rolling-window value against its
    target, the error budget remaining, burn-rate alerts, and the
    service plane's live queue/warm stats."""
    s = status_snapshot(store_root)
    rep = _slo_latest(store_root)
    parts = ["<meta http-equiv='refresh' content='2'>",
             "<a href='/'>jepsen_tpu</a> / "
             "<a href='/status'>status</a> / slo",
             "<h1>service objectives"
             f" &middot; {_esc(s.get('test') or 'no active run')}"
             "</h1>"]
    sv = s.get("service") or {}
    if sv.get("active") or sv.get("submitted"):
        parts.append(
            f"<p>service: {_esc(sv.get('served'))} served &middot; "
            f"{_esc(sv.get('queued'))} queued &middot; "
            f"{_esc(sv.get('rejected'))} rejected &middot; warm rate "
            f"{_esc(sv.get('warm_rate'))} &middot; "
            f"{_esc(sv.get('warm_buckets'))} warm bucket(s)</p>")
    if rep is None:
        parts.append(
            "<p>no SLO evaluations yet — the engine reads "
            "<code>kind=\"service-request\"</code> ledger records "
            "(POST /check some work, or run the service smoke)</p>")
        return _page("slo", "".join(parts))
    alerts = rep.get("alerts") or []
    if alerts:
        names = [a.get("objective") for a in alerts]
        parts.append(
            f"<p style='background:{VALID_COLORS[False]};padding:6px'>"
            f"BURN ALERT: <b>{_esc(names)}</b> — the error budget is "
            f"burning across every window</p>")
    rows = []
    for o in rep.get("objectives") or []:
        met = o.get("met")
        color = (VALID_COLORS[True] if met is True else
                 VALID_COLORS[False] if met is False else
                 VALID_COLORS[None])
        budget = o.get("budget_remaining")
        bar = ""
        if budget is not None:
            pct = max(0, min(100, int(float(budget) * 100)))
            bcolor = (VALID_COLORS[True] if pct > 50 else
                      VALID_COLORS["unknown"] if pct > 20
                      else VALID_COLORS[False])
            bar = (f"<div style='background:#eee;width:120px'>"
                   f"<div style='background:{bcolor};width:"
                   f"{max(pct, 2)}%;height:10px'></div></div>{pct}%")
        rows.append(
            f"<tr><td>{_esc(o.get('name'))}</td>"
            f"<td>{_esc(o.get('window_s'))}s / n={_esc(o.get('n'))}"
            f"</td>"
            f"<td>{_esc(o.get('good_frac'))} vs "
            f"{_esc(o.get('target_frac'))}</td>"
            f"<td>{_esc(o.get('observed'))}"
            + (f" (target {_esc(o.get('threshold_s'))}s)"
               if o.get("threshold_s") is not None else "")
            + f"</td><td style='background:{color}'>{_esc(met)}</td>"
            f"<td>{_esc(o.get('burn_rate'))}x</td><td>{bar}</td>"
            f"</tr>")
    parts.append(
        "<table><thead><tr><th>objective</th><th>window</th>"
        "<th>good frac</th><th>observed</th><th>met</th>"
        "<th>burn</th><th>budget left</th></tr></thead><tbody>"
        + "".join(rows) + "</tbody></table>")
    parts.append("<p><a href='/status.json'>status.json</a> (the "
                 "`slo` block) &middot; <a href='/events'>event "
                 "stream</a> &middot; <a href='/runs'>run ledger</a>"
                 "</p>")
    return _page("slo", "".join(parts))


# /fleet federates sibling stores (observatory.py). Cached on the
# federation set + a short TTL rather than the index signatures alone:
# heartbeat ages (and so D013) are time-dependent even when no replica
# appends, so an unchanged fleet must still re-evaluate — the
# FederatedLedger underneath reuses its per-root record caches, so a
# re-evaluation of an idle fleet is stat()s + arithmetic.
_FLEET_CACHE: dict = {}
_FLEET_CACHE_TTL_S = 1.0
_FLEET_LOCK = threading.Lock()


def _fleet_snapshot(store_root: str) -> Optional[dict]:
    """The federated snapshot /fleet renders: roots from
    JEPSEN_TPU_FLEET_ROOTS when set, else discovery around this
    store (the serving replica sees its siblings). None when nothing
    federates."""
    from . import observatory as obs_mod
    roots = obs_mod.roots_from_env(store_root)
    if not roots:
        return None
    key = tuple(roots)
    with _FLEET_LOCK:
        cached = _FLEET_CACHE.get(store_root)
        if cached is not None and cached[0] == key \
                and time.monotonic() - cached[2] < _FLEET_CACHE_TTL_S:
            return cached[1]
        fed = cached[3] if cached is not None and cached[0] == key \
            else obs_mod.FederatedLedger(roots)
    snap = obs_mod.fleet_snapshot(fed)
    with _FLEET_LOCK:
        _FLEET_CACHE[store_root] = (key, snap, time.monotonic(), fed)
    return snap


def render_fleet(store_root: str) -> bytes:
    """The auto-refreshing /fleet panel (doc/OBSERVABILITY.md "Fleet
    plane"): every federated replica's liveness + warm inventory, the
    merged fleet SLO beside the per-replica verdicts, and the
    D013-D015 findings."""
    snap = _fleet_snapshot(store_root)
    parts = ["<meta http-equiv='refresh' content='2'>",
             "<a href='/'>jepsen_tpu</a> / "
             "<a href='/status'>status</a> / fleet",
             "<h1>fleet observatory</h1>"]
    if snap is None:
        parts.append(
            "<p>nothing to federate — no sibling store roots found. "
            "Set <code>JEPSEN_TPU_FLEET_ROOTS</code> (path-separated "
            "store roots) or run replicas whose stores share this "
            "store's parent directory.</p>")
        return _page("fleet", "".join(parts))
    parts.append(
        f"<p>{len(snap['replicas'])} replica(s) &middot; "
        f"{_esc(snap['live'])} live &middot; "
        f"{len(snap['down'])} down &middot; "
        f"{_esc(snap['requests'])} request(s) in window</p>")
    rows = []
    for rid, info in sorted((snap.get("replicas") or {}).items()):
        down = info.get("down")
        state = ("down" if down is True else
                 "live" if down is False else "unknown")
        color = (VALID_COLORS[False] if down is True else
                 VALID_COLORS[True] if down is False else
                 VALID_COLORS[None])
        rows.append(
            f"<tr><td>{_esc(rid)}</td>"
            f"<td style='background:{color}'>{state}</td>"
            f"<td>{_esc(info.get('age_s'))}s</td>"
            f"<td>{_esc(info.get('queued'))}</td>"
            f"<td>{_esc(info.get('served'))}</td>"
            f"<td>{_esc(info.get('warm_rate'))}</td>"
            f"<td>{len(info.get('warm_buckets') or [])}</td>"
            f"<td>{_esc(info.get('devices'))}</td></tr>")
    parts.append(
        "<table><thead><tr><th>replica</th><th>state</th>"
        "<th>age</th><th>queued</th><th>served</th><th>warm rate</th>"
        "<th>warm buckets</th><th>devices</th></tr></thead><tbody>"
        + "".join(rows) + "</tbody></table>")
    findings = snap.get("findings") or []
    if findings:
        items = "".join(
            f"<li><b>{_esc(f.get('rule'))}</b> "
            f"[{_esc(f.get('severity'))}] {_esc(f.get('summary'))}"
            "</li>" for f in findings)
        parts.append(f"<h2>fleet findings</h2><ul>{items}</ul>")
    else:
        parts.append("<p>no fleet findings</p>")
    fc = (snap.get("slo") or {}).get("fleet")
    if fc and fc.get("objectives"):
        srows = []
        for o in fc["objectives"]:
            met = o.get("met")
            color = (VALID_COLORS[True] if met is True else
                     VALID_COLORS[False] if met is False else
                     VALID_COLORS[None])
            srows.append(
                f"<tr><td>{_esc(o.get('name'))}</td>"
                f"<td>n={_esc(o.get('n'))}</td>"
                f"<td>{_esc(o.get('good_frac'))} vs "
                f"{_esc(o.get('target_frac'))}</td>"
                f"<td style='background:{color}'>{_esc(met)}</td>"
                f"<td>{_esc(o.get('burn_rate'))}x</td></tr>")
        parts.append(
            "<h2>fleet SLO (request-weighted, merged ledgers)</h2>"
            "<table><thead><tr><th>objective</th><th>n</th>"
            "<th>good frac</th><th>met</th><th>burn</th></tr>"
            "</thead><tbody>" + "".join(srows) + "</tbody></table>")
        per = (snap.get("slo") or {}).get("per_replica") or {}
        prow = []
        for rid, rep in sorted(per.items()):
            if not rep:
                continue
            met = rep.get("met")
            color = (VALID_COLORS[True] if met is True else
                     VALID_COLORS[False] if met is False else
                     VALID_COLORS[None])
            alerts = [a.get("objective")
                      for a in (rep.get("alerts") or [])]
            prow.append(
                f"<tr><td>{_esc(rid)}</td>"
                f"<td style='background:{color}'>{_esc(met)}</td>"
                f"<td>{_esc(alerts)}</td></tr>")
        if prow:
            parts.append(
                "<h3>per replica</h3><table><thead><tr>"
                "<th>replica</th><th>met</th><th>alerts</th></tr>"
                "</thead><tbody>" + "".join(prow) + "</tbody></table>")
    parts.append("<p><a href='/fleet.json'>fleet.json</a> &middot; "
                 "<a href='/slo'>this replica's slo</a> &middot; "
                 "<a href='/status'>status</a></p>")
    return _page("fleet", "".join(parts))


# autopilot action-history verdict colors ride the shared palette
_AP_VERDICT_COLORS = {"verified": VALID_COLORS[True],
                      "reverted": VALID_COLORS[False]}


def render_autopilot(store_root: str) -> bytes:
    """The auto-refreshing /autopilot panel (doc/OBSERVABILITY.md
    "Autopilot plane"): the frozen policy table, live quarantines,
    in-flight actions awaiting their verify deadline, and the action
    history with verdicts. Falls back to the store's banked
    `kind="autopilot-action"` records when no supervisor is live in
    this process — the panel answers for finished runs too."""
    s = status_snapshot(store_root)
    apt = s.get("autopilot") or {}
    parts = ["<meta http-equiv='refresh' content='2'>",
             "<a href='/'>jepsen_tpu</a> / "
             "<a href='/status'>status</a> / autopilot",
             "<h1>autopilot"
             f" &middot; {'live' if apt.get('active') else 'idle'}"
             "</h1>"]
    counts = apt.get("counts") or {}
    if counts:
        parts.append(
            "<p>" + " &middot; ".join(
                f"{_esc(k)}: {_esc(counts.get(k, 0))}"
                for k in ("decision", "apply", "verify", "revert",
                          "suppress")) + "</p>")
    quarantined = apt.get("quarantined") or {}
    if quarantined:
        qrows = "".join(
            f"<tr><td>{_esc(rule)}</td><td>{_esc(q.get('action'))}"
            f"</td><td>{_esc(q.get('reason'))}</td>"
            f"<td>{_esc(_fmt_epoch(q.get('t')))}</td></tr>"
            for rule, q in sorted(quarantined.items()))
        parts.append(
            f"<p style='background:{VALID_COLORS[False]};padding:6px'>"
            f"QUARANTINED: <b>{_esc(sorted(quarantined))}</b> — "
            "reverted this run; further firings are suppressed, "
            "never silently retried</p>"
            "<table><thead><tr><th>rule</th><th>action</th>"
            "<th>reason</th><th>since</th></tr></thead><tbody>"
            + qrows + "</tbody></table>")
    pending = apt.get("pending") or []
    if pending:
        parts.append(
            "<p>in flight: " + ", ".join(
                f"{_esc(p.get('rule'))} {_esc(p.get('action'))} "
                f"(verify in {_esc(p.get('deadline_in_s'))}s)"
                for p in pending) + "</p>")
    # policy table — the frozen rule->action contract
    policy = apt.get("policy")
    if not policy:
        from . import autopilot as autopilot_mod
        policy = autopilot_mod.policy_rows()
    prow = "".join(
        f"<tr><td>{_esc(p.get('rule'))}</td>"
        f"<td>{_esc(p.get('action'))}</td>"
        f"<td>{_esc(p.get('metric'))} ({_esc(p.get('direction'))}, "
        f"x{_esc(p.get('improve_x'))}"
        + (f", abs {_esc(p.get('abs_ok'))}"
           if p.get("abs_ok") is not None else "")
        + f")</td><td>{_esc(p.get('description'))}</td></tr>"
        for p in policy)
    parts.append(
        "<h2>policy table</h2>"
        "<table><thead><tr><th>trigger</th><th>action</th>"
        "<th>verify</th><th>what</th></tr></thead><tbody>"
        + prow + "</tbody></table>")
    # action history: the live supervisor's window, else the store's
    # banked records (finished runs answer too)
    actions = apt.get("actions") or []
    source = "live"
    if not actions:
        source = "ledger"
        try:
            led = ledger_mod.Ledger(store_root)
            for rec in led.query(kind="autopilot-action",
                                 newest_first=True, limit=32):
                actions.append(
                    {"t": rec.get("t"), "event": rec.get("event"),
                     "rule": rec.get("rule"),
                     "action": rec.get("action"),
                     "subject": (rec.get("finding") or {}).get(
                         "subject"),
                     "before": (rec.get("baseline") or {}).get(
                         "value"),
                     "after": rec.get("metric_after"),
                     "verdict": rec.get("verdict"),
                     "reason": rec.get("reason")})
        except Exception:  # noqa: BLE001 — a torn ledger never
            pass           # breaks the live panel
    if actions:
        arows = []
        shown = (list(reversed(list(actions)[-32:]))
                 if source == "live" else list(actions))
        for a in shown:  # newest first either way
            color = _AP_VERDICT_COLORS.get(a.get("verdict"),
                                           VALID_COLORS[None])
            arows.append(
                f"<tr><td>{_esc(_fmt_epoch(a.get('t')))}</td>"
                f"<td>{_esc(a.get('event'))}</td>"
                f"<td>{_esc(a.get('rule'))}</td>"
                f"<td>{_esc(a.get('action'))}</td>"
                f"<td>{_esc(a.get('subject') or '')}</td>"
                f"<td>{_esc(a.get('before'))} &rarr; "
                f"{_esc(a.get('after'))}</td>"
                f"<td style='background:{color}'>"
                f"{_esc(a.get('verdict') or '')}"
                + (f" ({_esc(a.get('reason'))})"
                   if a.get("reason") else "") + "</td></tr>")
        parts.append(
            f"<h2>action history ({source})</h2>"
            "<table><thead><tr><th>t</th><th>event</th><th>rule</th>"
            "<th>action</th><th>subject</th><th>metric</th>"
            "<th>verdict</th></tr></thead><tbody>"
            + "".join(arows) + "</tbody></table>")
    else:
        parts.append(
            "<p>no actions yet — the supervisor banks every "
            "decision/apply/verify/revert/suppress as "
            "<code>kind=\"autopilot-action\"</code> records (start "
            "the service with <code>--autopilot</code>, or replay a "
            "banked run: <code>python -m jepsen_tpu_torch autopilot "
            "latest</code>)</p>")
    parts.append("<p><a href='/status.json'>status.json</a> (the "
                 "`autopilot` block) &middot; "
                 "<a href='/doctor'>doctor</a> &middot; "
                 "<a href='/slo'>slo</a> &middot; "
                 "<a href='/runs'>run ledger</a></p>")
    return _page("autopilot", "".join(parts))


def _fmt_epoch(t) -> str:
    import time as _time
    try:
        return _time.strftime("%Y-%m-%d %H:%M:%S",
                              _time.localtime(float(t)))
    except (TypeError, ValueError):
        return "?"


def render_runs(store_root: str) -> bytes:
    """/runs: the ledger as a table, newest first, with cross-run
    aggregates (device-seconds per model, verdict mix) on top."""
    led = ledger_mod.Ledger(store_root)
    recs = led.query(newest_first=True)
    agg = led.aggregate(records=recs)
    parts = ["<a href='/'>jepsen_tpu</a> / runs",
             f"<h1>run ledger ({len(recs)} records)</h1>"]
    dev = agg.get("device_s") or {}
    wall = agg.get("wall_s") or {}
    parts.append(
        "<p>"
        f"verdicts {_esc(agg.get('verdicts'))} &middot; "
        f"device-seconds {_esc(dev.get('total'))} "
        f"(by model {_esc(dev.get('by_model'))}) &middot; "
        f"wall p50 {_esc(wall.get('p50'))}s / p95 "
        f"{_esc(wall.get('p95'))}s &middot; "
        f"stalls {_esc(agg.get('stalls'))}</p>")
    rows = []
    for r in recs:
        color = VALID_COLORS.get(r.get("verdict"), VALID_COLORS[None])
        rows.append(
            f"<tr><td><a href='/runs/{_esc(r.get('id'))}'>"
            f"{_esc(r.get('id'))}</a></td>"
            f"<td>{_esc(r.get('kind'))}</td>"
            f"<td>{_esc(r.get('name'))}</td>"
            f"<td>{_esc(r.get('model') or '')}</td>"
            f"<td>{_esc(r.get('engine') or '')}</td>"
            f"<td style='background:{color}'>"
            f"{_esc(r.get('verdict'))}</td>"
            f"<td>{_esc(r.get('wall_s'))}</td>"
            f"<td>{_esc(r.get('device_s') or '')}</td>"
            f"<td>{_esc(_fmt_epoch(r.get('t')))}</td></tr>")
    parts.append(
        "<table><thead><tr><th>id</th><th>kind</th><th>name</th>"
        "<th>model</th><th>engine</th><th>verdict</th><th>wall s</th>"
        "<th>device s</th><th>when</th></tr></thead><tbody>"
        + "".join(rows) + "</tbody></table>"
        "<p><a href='/runs.json'>runs.json</a></p>")
    return _page("runs", "".join(parts))


def render_run(store_root: str, run_id: str) -> Optional[bytes]:
    """/runs/<id>: one full ledger record, with artifact links and —
    when the run exported a trace — the one-click Perfetto handoff."""
    rec = ledger_mod.Ledger(store_root).get(run_id)
    if rec is None:
        return None
    parts = ["<a href='/'>jepsen_tpu</a> / "
             "<a href='/runs'>runs</a> / " + _esc(run_id),
             f"<h1>{_esc(rec.get('kind'))} · {_esc(rec.get('name'))}"
             f"</h1>"]
    color = VALID_COLORS.get(rec.get("verdict"), VALID_COLORS[None])
    parts.append(f"<p>verdict <b style='background:{color};"
                 f"padding:2px 8px'>{_esc(rec.get('verdict'))}</b>"
                 f" &middot; wall {_esc(rec.get('wall_s'))}s"
                 f" &middot; {_esc(_fmt_epoch(rec.get('t')))}</p>")
    arts = rec.get("artifacts") or {}
    links = [f"<a href='/runs/{_esc(run_id)}.json'>record.json</a>"]
    for label, rel in sorted(arts.items()):
        links.append(f"<a href='/files/"
                     f"{_esc(str(rel).replace(os.sep, '/'))}'>"
                     f"{_esc(label)}</a>")
    if arts.get("trace"):
        links.append(f"<a href='/runs/{_esc(run_id)}/perfetto.json'>"
                     "perfetto.json</a> (open in ui.perfetto.dev)")
    parts.append("<p>" + " &middot; ".join(links) + "</p>")
    dc = doctor_for_record(store_root, run_id)
    if dc is not None and dc.get("findings"):
        items = "".join(
            f"<li><b style='background:"
            f"{_SEVERITY_COLORS.get(f.get('severity'), VALID_COLORS[None])}"
            f";padding:1px 6px'>{_esc(f.get('rule'))}</b> "
            f"{_esc(f.get('name'))}: {_esc(f.get('summary'))}</li>"
            for f in dc["findings"][:6])
        parts.append("<h2>doctor findings</h2><ul>" + items
                     + "</ul><p><a href='/doctor'>doctor panel</a></p>")
    parts.append("<pre style='background:#f4f4f4;padding:10px'>"
                 + _esc(json.dumps(rec, indent=2, default=str))
                 + "</pre>")
    return _page(f"run {run_id}", "".join(parts))


def render_home(cache: _ValidityCache) -> bytes:
    """The test table (web.clj:146-159)."""
    rows = []
    for name, t, path, valid in cache.runs():
        href = _file_href(cache.store_root, path)
        color = VALID_COLORS.get(valid, VALID_COLORS[None])
        rows.append(
            f"<tr><td><a href='{href}'>{_esc(name)}</a></td>"
            f"<td><a href='{href}'>{_esc(t)}</a></td>"
            f"<td style='background:{color}'>{_esc(valid)}</td>"
            f"<td><a href='{href}/results.json'>results.json</a></td>"
            f"<td><a href='{href}/history.txt'>history.txt</a></td>"
            f"<td><a href='{href}/jepsen.log'>jepsen.log</a></td>"
            f"<td><a href='{href}.zip'>zip</a></td></tr>")
    body = ("<h1>jepsen_tpu</h1>"
            "<p><a href='/status'>live run status</a> &middot; "
            "<a href='/occupancy'>occupancy</a> &middot; "
            "<a href='/devices'>devices</a> &middot; "
            "<a href='/doctor'>doctor</a> &middot; "
            "<a href='/slo'>slo</a> &middot; "
            "<a href='/autopilot'>autopilot</a> &middot; "
            "<a href='/runs'>run ledger</a></p>"
            "<table><thead><tr><th>Name</th>"
            "<th>Time</th><th>Valid?</th><th>Results</th><th>History</th>"
            "<th>Log</th><th>Zip</th></tr></thead><tbody>"
            + "".join(rows) + "</tbody></table>")
    return _page("jepsen_tpu", body)


def _dir_sort(names: list) -> list:
    """Numeric sort when every name is an integer (web.clj:223-229)."""
    if names and all(re.fullmatch(r"\d+", n) for n in names):
        return sorted(names, key=int)
    return sorted(names)


def render_dir(cache: _ValidityCache, path: str) -> bytes:
    """Directory browse page: breadcrumbs, colored subdir cells, file
    previews (web.clj:235-284)."""
    root = cache.store_root
    crumbs = ["<a href='/'>jepsen_tpu</a>"]
    rel = os.path.relpath(path, root)
    acc = root
    if rel != ".":
        for comp in rel.split(os.sep):
            acc = os.path.join(acc, comp)
            crumbs.append(
                f"<a href='{_file_href(root, acc)}'>{_esc(comp)}</a>")
    parts = [" / ".join(crumbs),
             f"<h1>{_esc(os.path.basename(path))} "
             f"<a style='font-size:60%' "
             f"href='{_file_href(root, path)}.zip'>.zip</a></h1>"]

    entries = sorted(os.listdir(path))
    dirs = [e for e in entries
            if os.path.isdir(os.path.join(path, e))]
    files = [e for e in entries
             if not os.path.isdir(os.path.join(path, e))]

    cells = []
    for d in _dir_sort(dirs):
        sub = os.path.join(path, d)
        valid = None
        if os.path.exists(os.path.join(sub, "test.jepsen")):
            valid = cache.read_valid(sub)
        color = VALID_COLORS.get(valid, VALID_COLORS[None])
        cells.append(
            f"<a href='{_file_href(root, sub)}' "
            f"style='text-decoration:none;color:#000'>"
            f"<div style='background:{color};display:inline-block;"
            f"margin:8px;padding:10px;width:280px;overflow:hidden'>"
            f"{_esc(d)}</div></a>")
    parts.append("<div>" + "".join(cells) + "</div>")

    # results first, then history, then the rest (web.clj:279-283)
    files.sort(key=lambda f: (f != "results.json", f != "history.txt", f))
    fcells = []
    for f in files:
        fp = os.path.join(path, f)
        href = _file_href(root, fp)
        if _IMG_RE.search(f):
            preview = (f"<img src='{href}' title='{_esc(f)}' "
                       f"style='width:auto;height:200px'>")
        elif _TEXT_RE.search(f):
            try:
                with open(fp, errors="replace") as fh:
                    head = fh.read(4096)
            except OSError:
                head = ""
            preview = f"<pre style='font-size:11px'>{_esc(head)}</pre>"
        else:
            preview = ("<div style='background:#f4f4f4;width:100%;"
                       "height:100%'></div>")
        fcells.append(
            f"<div style='display:inline-block;margin:8px;vertical-align:"
            f"top'><div style='height:200px;width:300px;overflow:hidden'>"
            f"<a href='{href}' style='text-decoration:none;color:#555'>"
            f"{preview}</a></div><a href='{href}'>{_esc(f)}</a></div>")
    parts.append("<div>" + "".join(fcells) + "</div>")
    return _page(os.path.basename(path), "".join(parts))


def zip_dir_bytes(path: str) -> io.BytesIO:
    """A whole run directory as an in-memory zip (web.clj:287-327;
    run dirs are small — logs + results, never model weights)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for dirpath, _dirs, files in os.walk(path):
            for f in files:
                fp = os.path.join(dirpath, f)
                if os.path.isfile(fp):
                    z.write(fp, os.path.relpath(fp, path))
    buf.seek(0)
    return buf



def in_scope(store_root: str, path: str) -> bool:
    """Reject paths outside the store dir."""
    real = os.path.realpath(path)
    rootp = os.path.realpath(store_root)
    return real == rootp or real.startswith(rootp + os.sep)


class Handler(BaseHTTPRequestHandler):
    cache: _ValidityCache  # injected by serve()
    service = None  # optional jepsen_tpu_torch.service.Service

    @property
    def store_root(self) -> str:
        return self.cache.store_root

    def log_message(self, fmt, *args):  # route through logging
        log.debug("%s " + fmt, self.address_string(), *args)

    def _send(self, code: int, ctype: str, body: bytes,
              headers: Optional[dict] = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj,
                   headers: Optional[dict] = None) -> None:
        self._send(code, "application/json",
                   json.dumps(obj, default=str).encode(), headers=headers)

    def _404(self):
        self._send(404, "text/plain", b"404 not found")

    # -- the service front door (POST /check) -------------------------
    def do_POST(self):  # noqa: N802 (http.server API)
        try:
            uri = urllib.parse.unquote(urllib.parse.urlparse(self.path).path)
            if uri != "/check":
                self._404()
                return
            svc = self.service
            if svc is None:
                self._send_json(503, {
                    "error": "no service attached — start with "
                             "`python -m jepsen_tpu_torch serve --service`"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            if length <= 0 or length > MAX_POST_BYTES:
                self._send_json(400, {"error": "body required "
                                      f"(<= {MAX_POST_BYTES} bytes)"})
                return
            try:
                payload = json.loads(self.rfile.read(length))
            except ValueError as e:
                self._send_json(400, {"error": f"not JSON: {e}"})
                return
            try:
                out = svc.submit(payload)
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            out = dict(out)
            out["watch"] = f"/runs/{out['id']}/events"
            if out.get("cause") == "shed":
                # burn-driven backpressure: a structured 503 with the
                # service's retry hint, so that the client backs off
                retry = max(1, int(round(float(
                    out.get("retry_after_s") or 1.0))))
                self._send_json(503, out, headers={"Retry-After": retry})
                return
            self._send_json(202, out)
        except BrokenPipeError:
            pass
        except Exception:  # noqa: BLE001
            log.warning("error serving %s", self.path, exc_info=True)
            try:
                self._send_json(500, {"error": "internal error"})
            except OSError:
                pass

    # -- Server-Sent-Events streams -----------------------------------
    def _sse_params(self) -> tuple:
        q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)

        def _num(name, default):
            try:
                return float(q[name][0])
            except (KeyError, IndexError, ValueError):
                return default
        return (_num("limit", float("inf")),
                min(_num("wait", SSE_MAX_WAIT_S), SSE_MAX_WAIT_S))

    def _sse_start(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-store")
        self.end_headers()

    def _sse_write(self, event: str, data) -> None:
        self.wfile.write((f"event: {event}\n"
                          f"data: {json.dumps(data, default=str)}\n\n"
                          ).encode())
        self.wfile.flush()

    def _serve_run_events(self, run_id: str) -> None:
        """/runs/<id>/events: the one run's lifecycle as SSE — queued
        (with position), serving (queue wait, warm hit), done (verdict)
        — then the stream closes."""
        svc = self.service
        if svc is None or svc.get(run_id) is None:
            self._404()
            return
        limit, wait = self._sse_params()
        self._sse_start()
        self._sse_write("snapshot", svc.get(run_id))
        sent = 0
        last_seq = 0
        deadline = time.monotonic() + wait
        while sent < limit:
            evs, done = svc.run_events(run_id, after=last_seq, timeout=1.0)
            for e in evs:
                last_seq = max(last_seq, e["seq"])
                self._sse_write(str(e.get("event")), e)
                sent += 1
                if sent >= limit:
                    break
            if (done and not evs) or (not evs and svc.closed):
                # a closed service's waiters return at once: end the
                # stream rather than spin to the deadline
                self._sse_write("end", {"run_id": run_id})
                break
            if time.monotonic() > deadline:
                break

    def _serve_events(self) -> None:
        """/events: the global service feed as SSE, with a `status`
        event (the /status.json snapshot's live slice) whenever the feed
        idles."""
        svc = self.service
        limit, wait = self._sse_params()
        self._sse_start()
        sent = 0
        last_seq = 0
        deadline = time.monotonic() + wait
        while sent < limit and time.monotonic() < deadline:
            evs = (svc.events_since(after=last_seq, timeout=1.0)
                   if svc is not None else [])
            if evs:
                for e in evs:
                    last_seq = max(last_seq, e["seq"])
                    self._sse_write(str(e.get("event")), e)
                    sent += 1
                    if sent >= limit:
                        break
                continue
            if svc is not None and svc.closed:
                break
            s = status_snapshot(self.store_root)
            self._sse_write("status", {
                "active": s.get("active"), "phase": s.get("phase"),
                "keys": s.get("keys"), "eta_s": s.get("eta_s"),
                "service": {k: (s.get("service") or {}).get(k)
                            for k in ("queued", "served", "warm_rate")}})
            sent += 1
            if svc is None:
                time.sleep(min(1.0, max(0.0, deadline - time.monotonic())))

    def _serve_perfetto(self, run_id: str):
        """A ledger record's exported trace.jsonl as the Chrome/Perfetto
        trace_event document, converted on the fly."""
        root = self.store_root
        rec = ledger_mod.Ledger(root).get(run_id)
        rel = (rec or {}).get("artifacts", {}).get("trace")
        if not rel:
            self._404()
            return
        path = os.path.join(root, *str(rel).split("/"))
        if not in_scope(root, path) or not os.path.isfile(path):
            self._404()
            return
        from . import trace as trace_mod
        self._send(200, "application/json",
                   json.dumps(trace_mod.perfetto_from_jsonl(path)).encode())

    def _send_html(self, body: bytes) -> None:
        self._send(200, "text/html; charset=utf-8", body)

    def _serve_file(self, rel: str) -> None:
        """/files/<rel>: a file with its content type, `<dir>.zip` a
        whole directory, a directory's browse page; 403 outside the
        store root."""
        root = self.store_root
        path = os.path.join(root, *rel.split("/"))
        if not in_scope(root, path):
            self._send(403, "text/plain", b"File out of scope.")
            return
        if os.path.isfile(path):
            ext = os.path.splitext(path)[1].lower()
            with open(path, "rb") as fh:
                self._send(200, CONTENT_TYPES.get(
                    ext, "application/octet-stream"), fh.read())
        elif path.endswith(".zip") and os.path.isdir(path[:-4]):
            self._send(200, "application/zip",
                       zip_dir_bytes(path[:-4]).getvalue())
        elif os.path.isdir(path):
            self._send_html(render_dir(self.cache, path))
        else:
            self._404()

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            uri = urllib.parse.unquote(urllib.parse.urlparse(self.path).path)
            root = self.store_root
            page = _PAGES.get(uri)
            if page is not None:
                self._send_html(page(root))
                return
            if uri == "/":
                self._send_html(render_home(self.cache))
                return
            if uri == "/status.json":
                self._send(200, "application/json",
                           json.dumps(status_snapshot(root),
                                      default=str).encode(),
                           headers={"Cache-Control": "no-store"})
                return
            if uri == "/fleet.json":
                snap = _fleet_snapshot(root)
                if snap is None:
                    snap = {"schema": 1, "roots": [], "replicas": {},
                            "live": 0, "down": [], "requests": 0,
                            "findings": []}
                self._send(200, "application/json",
                           json.dumps(snap, default=str).encode())
                return
            if uri == "/events":
                self._serve_events()
                return
            m = re.match(rf"^/runs/{_RUN_ID}/events$", uri)
            if m:
                self._serve_run_events(m.group(1))
                return
            if uri in ("/runs", "/runs/"):
                self._send_html(render_runs(root))
                return
            if uri == "/runs.json":
                led = ledger_mod.Ledger(root)
                self._send(200, "application/json", json.dumps(
                    led.query(newest_first=True), default=str).encode())
                return
            m = re.match(rf"^/runs/{_RUN_ID}/perfetto\.json$", uri)
            if m:
                self._serve_perfetto(m.group(1))
                return
            m = re.match(r"^/runs/([A-Za-z0-9][\w.-]*?)(\.json)?$", uri)
            if m:
                rid, as_json = m.group(1), bool(m.group(2))
                rec = ledger_mod.Ledger(root).get(rid)
                if rec is None:
                    self._404()
                elif as_json:
                    # the diagnosis plane rides every record answer
                    dc = doctor_for_record(root, rid)
                    if dc is not None and "doctor" not in rec:
                        rec = {**rec, "doctor": dc}
                    self._send(200, "application/json",
                               json.dumps(rec, default=str).encode())
                else:
                    self._send_html(render_run(root, rid))
                return
            m = re.match(r"^/files/(.+)$", uri)
            if m:
                self._serve_file(m.group(1))
                return
            self._404()
        except BrokenPipeError:
            pass
        except Exception:  # noqa: BLE001
            log.warning("error serving %s", self.path, exc_info=True)
            try:
                self._send(500, "text/plain", b"500 internal error")
            except OSError:
                pass


# The panels that render from the store root alone.
_PAGES = {"/status": render_status, "/occupancy": render_occupancy,
          "/devices": render_devices, "/doctor": render_doctor,
          "/slo": render_slo, "/autopilot": render_autopilot,
          "/fleet": render_fleet}


def serve(host: str = "0.0.0.0", port: int = 8080,
          store_root: str = ledger_mod.BASE_DIR,
          service=None) -> ThreadingHTTPServer:
    """Build the server (web.clj:385-390); the caller runs
    `serve_forever()` (and `shutdown()`). Port 0 picks a free port.
    `service` (a `service.Service`) enables POST /check and the SSE
    streams; it is started here, after the bind, so that a failed bind
    leaves no worker running."""
    handler = type("BoundHandler", (Handler,),
                   {"cache": _ValidityCache(store_root),
                    "service": service})
    server = ThreadingHTTPServer((host, port), handler)
    if service is not None:
        try:
            service.start()
        except Exception:
            server.server_close()
            raise
    return server
