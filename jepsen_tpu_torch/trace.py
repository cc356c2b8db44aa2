"""Distributed-tracing spans: the checker service's request traces and
the device search's phase spans.

A jax-free copy of `jepsen_tpu/trace.py`: spans carry trace/span/parent
ids and wall-clock bounds, nest through a thread-local context, and
export as OTLP-flavored JSON lines (a file Jaeger/otel tooling can
ingest) or as a Chrome/Perfetto `trace_event` document.

    tracer = trace.Tracer(sampled=True)
    with tracer.span("admit", attrs={"run_id": rid}):
        ctx = tracer.context()
    wgl.check(model, history, tracer=tracer)   # encode / compile /
                                               # device-round / host-poll
    tracer.export(os.path.join(root, "trace.jsonl"))

A disabled tracer (`sampled=False`, `NULL_TRACER`) makes every call a
no-op, so the instrumented search costs nothing. `TracedClient` wraps a
test's `client.Client` so that every op of a run gets its own span.
"""

from __future__ import annotations

import contextlib
import json
import os
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_s: float
    end_s: Optional[float] = None
    attrs: dict = field(default_factory=dict)
    annotations: list = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentSpanId": self.parent_id,
            "startTimeUnixNano": int(self.start_s * 1e9),
            "endTimeUnixNano": (int(self.end_s * 1e9)
                                if self.end_s else None),
            "attributes": dict(self.attrs),
            "events": list(self.annotations),
        }


class Tracer:
    """Thread-safe span collector with thread-local nesting."""

    def __init__(self, sampled: bool = True,
                 service: str = "jepsen_tpu_torch"):
        self.sampled = sampled
        self.service = service
        self._local = threading.local()
        self._lock = threading.Lock()
        self.spans: list[Span] = []
        self._listeners: list = []

    def add_listener(self, fn) -> None:
        """Register fn(event, span), called with event "start" when a
        span opens and "end" when it closes — the hook
        `fleet.RunStatus` uses to follow checker phase spans live.
        Listener failures never break the traced code."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def _notify(self, event: str, sp: "Span") -> None:
        for fn in self._listeners:
            try:
                fn(event, sp)
            except Exception:  # noqa: BLE001
                pass

    # -- current-span plumbing ----------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    @contextlib.contextmanager
    def span(self, name: str, attrs: Optional[dict] = None,
             parent: Optional[dict] = None):
        """Scoped span (with-trace, trace.clj:40-49): nested spans in
        the same thread share the trace id and chain parent ids.
        `parent` — a {"trace-id", "span-id"} context captured via
        `context()` — adopts an EXPLICIT parent when the thread-local
        stack is empty: the competition checker's engine threads use
        it so their spans nest under the caller's check() trace
        instead of starting disconnected roots."""
        if not self.sampled:
            yield None
            return
        cur = self.current()
        if cur is not None:
            trace_id, parent_id = cur.trace_id, cur.span_id
        elif parent:
            trace_id = parent.get("trace-id") or secrets.token_hex(16)
            parent_id = parent.get("span-id")
        else:
            trace_id, parent_id = secrets.token_hex(16), None
        sp = Span(name=name,
                  trace_id=trace_id,
                  span_id=secrets.token_hex(8),
                  parent_id=parent_id,
                  start_s=time.time(),
                  attrs=dict(attrs or {}))
        self._stack().append(sp)
        self._notify("start", sp)
        try:
            yield sp
        finally:
            sp.end_s = time.time()
            self._stack().pop()
            with self._lock:
                self.spans.append(sp)
            self._notify("end", sp)

    # -- the trace.clj surface ----------------------------------------
    def context(self) -> Optional[dict]:
        """{"trace-id", "span-id"} of the current span, for stamping
        into ops (trace.clj:51-58)."""
        sp = self.current()
        if sp is None:
            return None
        return {"trace-id": sp.trace_id, "span-id": sp.span_id}

    def annotate(self, message: str) -> None:
        """Timestamped event on the current span (trace.clj:60-64)."""
        sp = self.current()
        if sp is not None:
            sp.annotations.append({"time": time.time(),
                                   "message": str(message)})

    def attribute(self, k: str, v: Any) -> None:
        """Attribute on the current span (trace.clj:66-73 — string
        values there; anything JSON-serializable here)."""
        sp = self.current()
        if sp is not None:
            sp.attrs[str(k)] = v

    def trim(self, keep: int) -> int:
        """Drop all but the newest `keep` finished spans; returns how
        many were dropped. Long-lived processes (the service worker
        pool) rotate their tracer with this so request spans don't
        grow without bound — exports after a trim carry the recent
        window only."""
        with self._lock:
            dropped = max(0, len(self.spans) - max(0, int(keep)))
            if dropped:
                del self.spans[:dropped]
        return dropped

    # -- export --------------------------------------------------------
    def export(self, path: str) -> int:
        """Write collected spans as JSON lines; returns span count."""
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with self._lock:
            spans = list(self.spans)
        with open(path, "w") as fh:
            for sp in spans:
                fh.write(json.dumps(
                    {"resource": {"service.name": self.service},
                     **sp.to_json()}) + "\n")
        return len(spans)

    def export_perfetto(self, path: str,
                        counters: Optional[dict] = None,
                        instants: Optional[list] = None) -> int:
        """Write collected spans as a Chrome/Perfetto `trace_event`
        JSON file (see `to_perfetto`); returns span count.
        `counters` — {track: [(t_epoch_s, value), ...]} — renders as
        counter tracks under the spans (the occupancy plane's
        per-round fill / frontier / backlog graphs;
        `occupancy.perfetto_counter_tracks` builds them from a
        metrics registry). `instants` — [{"t": epoch_s, "name": ...}]
        — renders as instant-event annotations in their own lane
        (the doctor's offending-round markers;
        `doctor.perfetto_instants` builds them from a report)."""
        with self._lock:
            spans = list(self.spans)
        doc = to_perfetto([sp.to_json() for sp in spans],
                          service=self.service, counters=counters,
                          instants=instants)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return len(spans)


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace_event export
# ---------------------------------------------------------------------------
# The OTLP-flavored JSONL above is for Jaeger-shaped tooling; Perfetto
# (ui.perfetto.dev) and chrome://tracing want the trace_event format
# instead — and they render the checker's phase spans (encode /
# compile / device-round / host-poll, per-key fan-out, engine races)
# as a zoomable flame chart with zero extra tooling. Mapping: one
# process per service, one thread LANE per trace id (each analysis /
# engine thread gets its own row), spans as "X" complete events in
# microseconds, annotations as "i" instant events.

def perfetto_events(spans: list, service: str = "jepsen_tpu_torch",
                    pid: int = 1) -> list:
    """`trace_event` dicts from span dicts (the `Span.to_json` /
    exported-JSONL shape). Unfinished spans (no end time) are emitted
    with zero duration rather than dropped — a crashed run's last open
    span is exactly the interesting one. `pid` names the process
    track: the default single-process export owns pid 1; the fleet
    observatory's merged export gives each replica its own pid so N
    processes render as N labeled tracks (counters/instants keep
    pids 2/3)."""
    events: list = []
    lanes: dict = {}
    pid = int(pid)
    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "tid": 0, "args": {"name": str(service)}})
    for sp in spans:
        if not isinstance(sp, dict) or sp.get("startTimeUnixNano") \
                is None:
            continue
        trace_id = str(sp.get("traceId"))
        tid = lanes.get(trace_id)
        if tid is None:
            tid = lanes[trace_id] = len(lanes) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tid,
                           "args": {"name": f"trace {trace_id[:8]}"}})
        ts = int(sp["startTimeUnixNano"]) / 1e3  # ns -> us
        end = sp.get("endTimeUnixNano")
        dur = max(0.0, (int(end) / 1e3 - ts)) if end else 0.0
        args = {k: v for k, v in (sp.get("attributes") or {}).items()}
        for k in ("spanId", "parentSpanId"):
            if sp.get(k):
                args[k] = sp[k]
        events.append({"ph": "X", "name": str(sp.get("name")),
                       "cat": "span", "ts": ts, "dur": dur,
                       "pid": pid, "tid": tid, "args": args})
        for ann in sp.get("events") or []:
            if not isinstance(ann, dict) or ann.get("time") is None:
                continue
            events.append({"ph": "i", "s": "t",
                           "name": str(ann.get("message"))[:80],
                           "cat": "annotation",
                           "ts": float(ann["time"]) * 1e6,
                           "pid": pid, "tid": tid})
    return events


def counter_events(tracks: dict, pid: int = 2) -> list:
    """`trace_event` "C" (counter) events from
    {track_name: [(t_epoch_seconds, value), ...]} — Perfetto renders
    each named track as a step graph on its own row, time-aligned
    with the span lanes. Counters live in their OWN process lane
    (pid 2, named "counters" — `perfetto_events` owns pid 1's span
    thread lanes, and sharing tids there would let a counter
    thread_name meta rename a span row), and each track gets its own
    tid + thread_name so multi-track exports — e.g. the per-device
    `hbm bytes <dev>` lanes — sort as separate labeled rows instead
    of piling onto tid 0. Samples are emitted in timestamp order per
    track (counter graphs render wrongly from out-of-order samples);
    non-numeric values are skipped (a torn series point must not
    sink the whole export)."""
    events: list = []
    for lane, (name, pts) in enumerate(sorted((tracks or {}).items()),
                                       start=1):
        samples: list = []
        for p in pts:
            try:
                samples.append((float(p[0]), float(p[1])))
            except (TypeError, ValueError, IndexError):
                continue
        if not samples:
            continue
        if not events:
            events.append({"ph": "M", "name": "process_name",
                           "pid": pid, "tid": 0,
                           "args": {"name": "counters"}})
        samples.sort()
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": lane,
                       "args": {"name": f"counter {name}"}})
        for t, v in samples:
            events.append({"ph": "C", "name": str(name),
                           "cat": "counter", "ts": t * 1e6,
                           "pid": pid, "tid": lane,
                           "args": {"value": v}})
    return events


def instant_events(instants: list, pid: int = 3,
                   default_lane: str = "doctor findings") -> list:
    """`trace_event` "i" (instant) annotations from
    [{"t": epoch_seconds, "name": str, "lane": str?}, ...] — one
    labeled marker per point, in their own process lane (pid 3,
    "annotations") so they never rename a span or counter row. Each
    distinct `lane` value gets its own named thread row inside that
    process — the doctor's offending-round markers
    (`doctor.perfetto_instants`, the default lane) and the
    autopilot's action markers (`autopilot.perfetto_instants`, lane
    "autopilot actions") render as separate labeled strips instead of
    interleaving. Malformed entries are skipped, never a sunk
    export."""
    events: list = []
    lanes: dict = {}
    for inst in instants or []:
        try:
            ts = float(inst["t"]) * 1e6
            name = str(inst.get("name"))[:80]
        except (TypeError, KeyError, ValueError):
            continue
        if not events:
            events.append({"ph": "M", "name": "process_name",
                           "pid": pid, "tid": 0,
                           "args": {"name": "annotations"}})
        lane = str(inst.get("lane") or default_lane)
        tid = lanes.get(lane)
        if tid is None:
            tid = lanes[lane] = len(lanes) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tid,
                           "args": {"name": lane}})
        events.append({"ph": "i", "s": "g", "name": name,
                       "cat": "annotation", "ts": ts,
                       "pid": pid, "tid": tid})
    return events


def to_perfetto(spans: list, service: str = "jepsen_tpu_torch",
                counters: Optional[dict] = None,
                instants: Optional[list] = None) -> dict:
    """The loadable document: {"traceEvents": [...]} — the JSON object
    form both Perfetto and chrome://tracing ingest directly.
    `counters` adds counter tracks (see `counter_events`); `instants`
    adds instant-event annotations (see `instant_events`)."""
    events = perfetto_events(spans, service=service)
    if counters:
        events += counter_events(counters)
    if instants:
        events += instant_events(instants)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def perfetto_from_jsonl(jsonl_path: str,
                        service: str = "jepsen_tpu_torch") -> dict:
    """Convert an exported OTLP-flavored trace.jsonl (Tracer.export)
    into the Perfetto document — the on-the-fly converter behind
    web.py's /runs/<id>/perfetto.json. Unparseable lines are skipped
    (a live run's file may end mid-line)."""
    spans = []
    with open(jsonl_path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict):
                svc = (obj.get("resource") or {}).get("service.name")
                if svc:
                    service = svc
                spans.append(obj)
    return to_perfetto(spans, service=service)


# Shared disabled tracer: the default for instrumented hot paths
# (checker kernels, phase spans) — every span() is a two-line no-op.
NULL_TRACER = Tracer(sampled=False)


def tracing(endpoint: Optional[str] = None,
            service: str = "jepsen_tpu_torch") -> Tracer:
    """Tracer enabled iff an export target is configured — the
    sampler-by-endpoint semantics of trace.clj:9-14,34-38. `endpoint`
    here is the artifact path (or any truthy value for in-memory)."""
    return Tracer(sampled=bool(endpoint), service=service)


from .client import Client as _Client  # noqa: E402


class TracedClient(_Client):
    """Client wrapper spanning every op (the dgraph suites wrap their
    client bodies in with-trace; this does it generically): each
    invoke gets an "invoke <f>" span, and the completed op carries
    {"span": {"trace-id", "span-id"}}."""

    def __init__(self, client, tracer: Tracer):
        self.client = client
        self.tracer = tracer

    def open(self, test, node):
        return TracedClient(self.client.open(test, node), self.tracer)

    def setup(self, test):
        with self.tracer.span("setup"):
            return self.client.setup(test)

    def invoke(self, test, op):
        with self.tracer.span(f"invoke {op.get('f')}",
                              attrs={"process": op.get("process")}):
            ctx = self.tracer.context()
            res = self.client.invoke(test, op)
            if ctx is not None and isinstance(res, dict):
                res = {**res, "span": ctx}
            return res

    def teardown(self, test):
        with self.tracer.span("teardown"):
            return self.client.teardown(test)

    def close(self, test):
        return self.client.close(test)
