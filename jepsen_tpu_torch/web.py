"""The checker service's HTTP front door.

The port of the service's routes of `jepsen_tpu/web.py`, and nothing
else: a standard-library `ThreadingHTTPServer` over a store root and an
optional `service.Service`.

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

The reference's HTML pages (`/`, `/status`, `/occupancy`, `/devices`,
`/doctor`, `/slo`, `/autopilot`, `/fleet`, `/files`) are not ported
yet: they answer 404.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import fleet
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
    SLO and autopilot blocks of this process; and the last ledger runs
    under `store_root`. Always returns the documented schema."""
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
        snap["preflight"] = preflight.snapshot()
    except Exception:  # noqa: BLE001 — the status answer must not
        snap["preflight"] = {"checked": 0, "verdicts": {},  # depend on
                             "recent": []}                   # the plane
    try:
        from . import devices as devices_mod
        snap["hbm"] = devices_mod.snapshot()
    except Exception:  # noqa: BLE001
        snap["hbm"] = {"active": False}
    try:
        from .parallel import mesh as mesh_mod
        snap["mesh"] = mesh_mod.snapshot()
    except Exception:  # noqa: BLE001
        snap["mesh"] = {"active": False, "runs": 0, "steals": 0,
                        "rebuckets": 0, "last": None}
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
        snap["service"] = service_mod.snapshot()
    except Exception:  # noqa: BLE001
        snap["service"] = {"active": False, "queued": 0, "submitted": 0,
                           "served": 0}
    try:
        from . import slo as slo_mod
        snap["slo"] = slo_mod.snapshot()
    except Exception:  # noqa: BLE001
        snap["slo"] = {"checked": 0, "alerts_total": 0, "burning": [],
                       "last": None}
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


# record diagnoses cached per record-file identity: a polled
# /runs/<id>.json must not re-scan the whole ledger index per request
_DOCTOR_REC_CACHE: dict = {}


def doctor_for_record(store_root: str, run_id: str):
    """The compact `doctor` block attached to /runs/<id>.json: the
    diagnosis of that one record's telemetry, or None when the doctor
    can't (a failing rule never breaks the record answer)."""
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


def in_scope(store_root: str, path: str) -> bool:
    """Reject paths outside the store dir."""
    real = os.path.realpath(path)
    rootp = os.path.realpath(store_root)
    return real == rootp or real.startswith(rootp + os.sep)


class Handler(BaseHTTPRequestHandler):
    store_root: str = ledger_mod.BASE_DIR  # injected by serve()
    service = None  # optional jepsen_tpu_torch.service.Service

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

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            uri = urllib.parse.unquote(urllib.parse.urlparse(self.path).path)
            root = self.store_root
            if uri == "/status.json":
                self._send(200, "application/json",
                           json.dumps(status_snapshot(root),
                                      default=str).encode(),
                           headers={"Cache-Control": "no-store"})
                return
            if uri == "/events":
                self._serve_events()
                return
            m = re.match(rf"^/runs/{_RUN_ID}/events$", uri)
            if m:
                self._serve_run_events(m.group(1))
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
            m = re.match(r"^/runs/([A-Za-z0-9][\w.-]*?)\.json$", uri)
            if m:
                rec = ledger_mod.Ledger(root).get(m.group(1))
                if rec is None:
                    self._404()
                else:
                    # the diagnosis plane rides every record answer
                    dc = doctor_for_record(root, m.group(1))
                    if dc is not None and "doctor" not in rec:
                        rec = {**rec, "doctor": dc}
                    self._send(200, "application/json",
                               json.dumps(rec, default=str).encode())
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


def serve(host: str = "0.0.0.0", port: int = 8080,
          store_root: str = ledger_mod.BASE_DIR,
          service=None) -> ThreadingHTTPServer:
    """Build the server; the caller runs `serve_forever()` (and
    `shutdown()`). Port 0 picks a free port. `service` (a
    `service.Service`) enables POST /check and the SSE streams; it is
    started here, after the bind, so that a failed bind leaves no
    worker running."""
    handler = type("BoundHandler", (Handler,),
                   {"store_root": store_root, "service": service})
    server = ThreadingHTTPServer((host, port), handler)
    if service is not None:
        try:
            service.start()
        except Exception:
            server.server_close()
            raise
    return server
