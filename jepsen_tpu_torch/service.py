"""The checker service: admission queue, warm worker pool, and the
request-scoped observability plane.

The port of `jepsen_tpu/service.py`. A request's lifecycle (one
`trace.Tracer` trace id threaded through):

    POST /check ──> admit ──> preflight ──> [bucket queue] ──>
      queue-wait ──> warm-dispatch ──> search ──> respond

  * **admit** — parse model + history + params, tenant quota check
    (device-seconds from the ledger's `kind="service-request"`
    records over a rolling window);
  * **preflight** — the static admission gate
    (`analysis/preflight.gate_wgl` / `gate_elle`): an infeasible
    request rejects with no kernel build and no device byte;
  * **bucket queue** — requests land in a per-shape-bucket queue
    keyed on a CANONICAL quantized bucket (`bucket_for`), so that
    same-bucket arrivals coalesce into one batch over kernels the warm
    plane already built, loaded and launched;
  * **warm-dispatch** — a bucket's first batch pays
    `aot.precompile_service_plan` once (the serial ladder and the mesh
    lane-group plan over the service's device list, ONE fs_cache entry
    under ("service-plan", ...), so that `rewarm()` restores the warm
    set, WGL and Elle, after a process restart); every later
    same-bucket request is a warm hit;
  * **search / respond** — a coalesced batch routes through the mesh
    lane scheduler (`parallel/mesh.check_mesh` over the service's
    device list at the canonical bucket: one lane group, per-request
    {shard, slot} coordinates on the results; fewer than 2 devices or
    a declined plan records a degrade and falls back to the serial
    `ops/wgl.check` loop), then a `kind="service-request"` ledger record
    (verdict, phase walls, device-seconds, warm hit, batch) and one
    `service_batch` series point per batch with the routing decision.

The service's devices: `device=None` is the CUDA card (it raises
without one), `device="cpu"` the plain PyTorch path; `devices=[...]`
names a list that may repeat a card (shards on streams of one card, as
`check_mesh(devices=)` takes them). The list's length is the device
count the mesh route and the warm plan see; the reference asks jax for
its local device count.

Backpressure closes the SLO loop: when slo.py's multi-window burn alert
fires, `submit` sheds new arrivals (cause "shed", a 503 with
Retry-After through web.py) for `shed_hold_s`. Surfaces: the `service`
and `service_batch` metrics series and counters, Server-Sent-Events
feeds (`events_since` / `run_events`, streamed by web.py at `/events`
and `/runs/<id>/events`), a `service` block on `/status.json`, and the
periodic `kind="replica-heartbeat"` ledger record.

`autopilot=True` runs the verify-or-revert supervisor (`autopilot.py`)
over the service from `start` to `close`: doctor and SLO findings
execute their remedies through the service's own controls (the bucket
warm, the ladder pin, the pool resize, the shed window), every action
banked and verified. The service lock is `lockwatch.rlock("service")`
(`analysis/lockwatch.py`): a plain `threading.RLock` unless
JEPSEN_TPU_LOCKWATCH is set when the service is built, then the
lock-order witness, whose report is the snapshot's `lockwatch` block and
whose `kind="lockwatch"` record `close()` banks.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from typing import Optional

from . import fleet
from . import ledger as ledger_mod
from . import metrics as metrics_mod
from . import slo as slo_mod
from . import trace as trace_mod
from .analysis import lockwatch
from .util import resolve_device, resolve_devices

SCHEMA = 1

# Shape-bucket quanta: requests quantize into canonical buckets so
# "the same workload again" lands in the SAME bucket (and therefore
# warm kernels), while _apply_bucket padding keeps verdicts exact.
# Coarse on purpose — a serving pool trades padded lanes for warm-hit
# rate (narrow windows always run at W_eff 32, the branch maximum:
# per-request concurrency jitter must not fragment the warm set).
BUCKET_N_QUANTUM = 256
BUCKET_IC_QUANTUM = 32
NARROW_W_EFF = 32
# model-table quanta: the observed op alphabet (and so the (S, O)
# transition table) varies per history — pad both axes so alphabet
# jitter can't fragment the warm set (_apply_bucket pads tables with
# -1, the same mechanism shared_shape_bucket relies on)
BUCKET_S_QUANTUM = 16
BUCKET_O_QUANTUM = 32

# Elle requests bucket on quantized txn count (the closure shapes
# scale with it); no array padding is involved, the bucket only keys
# the queue + warm registry.
ELLE_TXN_QUANTUM = 1024

# Bounded in-memory state: finished requests kept addressable, the
# global SSE event feed, and the rotating telemetry window (spans +
# series points) — a serving process must not grow linearly with
# request count (TRIM_EVERY completions trigger one rotation).
RUNS_CAP = 512
EVENTS_CAP = 1024
# resize_workers ceiling: a pool-grow request past this is rejected
POOL_MAX = 16
SPANS_CAP = 4096
SERIES_CAP = 4096
TRIM_EVERY = 256

_CHECKERS = ("wgl", "elle-append", "elle-wr")

# Replica heartbeat cadence (seconds). Every serving process banks a
# periodic `kind="replica-heartbeat"` ledger record (its liveness and
# inventory). Overridable per-process via JEPSEN_TPU_HEARTBEAT_S;
# <= 0 disables the writer entirely.
HEARTBEAT_EVERY_S = 2.0


def heartbeat_interval() -> float:
    """Default heartbeat cadence (env JEPSEN_TPU_HEARTBEAT_S wins)."""
    raw = os.environ.get("JEPSEN_TPU_HEARTBEAT_S")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return HEARTBEAT_EVERY_S


def default_replica_id() -> str:
    """This process's fleet identity: env JEPSEN_TPU_REPLICA_ID when
    set (the smoke harness and any orchestrator pin stable names),
    else host-pid — unique per process, stable for its lifetime."""
    rid = os.environ.get("JEPSEN_TPU_REPLICA_ID")
    if rid:
        return str(rid)
    return f"{socket.gethostname()}-{os.getpid()}"


class _Request:
    """One admitted request's lifecycle state (internal)."""

    __slots__ = ("id", "tenant", "checker", "model_name", "model",
                 "history", "params", "t_epoch", "t_mono", "state",
                 "bucket_key", "bucket", "enc", "result", "events",
                 "phases", "wait_s", "serve_s", "total_s", "warm_hit",
                 "batch_n", "position")

    def __init__(self, rid: str, tenant: str, checker: str):
        self.id = rid
        self.tenant = tenant
        self.checker = checker
        self.model_name: Optional[str] = None
        self.model = None
        self.history = None
        self.params: dict = {}
        self.t_epoch = time.time()
        self.t_mono = time.monotonic()
        self.state = "queued"
        self.bucket_key: Optional[tuple] = None
        self.bucket: Optional[dict] = None
        self.enc = None
        self.result: Optional[dict] = None
        self.events: list = []
        self.phases: dict = {}
        self.wait_s: Optional[float] = None
        self.serve_s: Optional[float] = None
        self.total_s: Optional[float] = None
        self.warm_hit = False
        self.batch_n = 0
        self.position: Optional[int] = None


def _models() -> dict:
    from . import models
    return {"register": models.register,
            "cas-register": models.cas_register,
            "cas_register": models.cas_register,
            "mutex": models.mutex,
            "fifo-queue": models.fifo_queue,
            "fifo_queue": models.fifo_queue}


def _parse_history(raw):
    """A History from either an Op list (in-process callers) or the
    POST body's op dicts."""
    from . import history as h
    if isinstance(raw, h.History):
        return raw
    if not isinstance(raw, (list, tuple)):
        raise ValueError("history must be a list of op objects")
    ops = []
    for d in raw:
        if isinstance(d, h.Op):
            ops.append(d)
        elif isinstance(d, dict) and "type" in d:
            ops.append(h.Op.from_dict(d))
        else:
            raise ValueError(f"history op needs a 'type': {d!r}")
    return h.History(ops)


def _quantize(n: int, q: int) -> int:
    return max(q, ((int(n) + q - 1) // q) * q)


def bucket_for(enc) -> tuple:
    """(key, bucket) for one encoding: the CANONICAL quantized shape
    bucket the request serves under. Deterministic from the encoding
    alone (unlike `shared_shape_bucket`, which derives from whatever
    batch happens to be in flight) so identical workloads always key
    the same warm kernels: the second same-bucket POST builds, loads
    and binds nothing (`analysis/guards.CompileGuard`).
    `ic_eff` pins to `ic_pad` so `wgl.derive_plan` resolves the same
    effective widths for every member of the bucket."""
    from .ops.encode import _pad_to
    from .ops.wgl import _packable
    wide = enc.window_raw > 32
    if wide:
        w_eff = _pad_to(enc.window_raw, 32)
    else:
        w_eff = NARROW_W_EFF
    n_pad = _quantize(len(enc.inv), BUCKET_N_QUANTUM)
    ic_pad = _quantize(max(len(enc.inv_info), 1), BUCKET_IC_QUANTUM)
    S = _quantize(int(enc.table.shape[0]), BUCKET_S_QUANTUM)
    O = _quantize(int(enc.table.shape[1]), BUCKET_O_QUANTUM)
    pack = bool(_packable(enc))
    bucket = {"n_pad": n_pad, "ic_pad": ic_pad, "S": S, "O": O,
              "w_eff": int(w_eff), "ic_eff": ic_pad, "n_cap": n_pad,
              "pack": pack}
    key = ("wgl", "wide" if wide else "narrow", n_pad, ic_pad, S, O,
           int(w_eff), pack)
    return key, bucket


def _key_str(key: Optional[tuple]) -> str:
    return "/".join(str(k) for k in key) if key else "?"


class Service:
    """The admission queue + resident worker pool. Construct one per
    store root; `web.serve(service=...)` fronts it with POST /check
    and the SSE endpoints. Thread-safe throughout; all device work
    happens on the worker threads."""

    def __init__(self, store_root: str, *, workers: int = 1,
                 warm_ladder: bool = True, rewarm: bool = False,
                 registry: Optional[metrics_mod.Registry] = None,
                 tracer: Optional[trace_mod.Tracer] = None,
                 quota_device_s: Optional[float] = None,
                 quota_window_s: float = 3600.0,
                 max_queue: int = 256, max_batch: int = 8,
                 slo_engine: Optional[slo_mod.Engine] = None,
                 slo_every_s: float = 30.0,
                 default_time_limit: float = 60.0,
                 mesh_serving: bool = True,
                 mesh_min_batch: int = 2,
                 shed_hold_s: float = 30.0,
                 autopilot: bool = False,
                 autopilot_every_s: float = 5.0,
                 replica_id: Optional[str] = None,
                 heartbeat_every_s: Optional[float] = None,
                 device=None, devices=None):
        # the device list first: no card and no device="cpu" raises
        # before any thread or file exists
        self.devices = (resolve_devices(devices) if devices is not None
                        else [resolve_device(device)])
        self.device = self.devices[0]
        self.store_root = store_root
        self.ledger = ledger_mod.Ledger(store_root)
        # the service owns an ENABLED registry by default: a request
        # plane that records nothing cannot be billed or SLO'd
        self.mx = registry if registry is not None \
            else metrics_mod.Registry()
        self.tracer = tracer if tracer is not None \
            else trace_mod.Tracer(sampled=True, service="service")
        self.workers = max(1, int(workers))
        self.warm_ladder = bool(warm_ladder)
        self.quota_device_s = quota_device_s
        self.quota_window_s = float(quota_window_s)
        self.max_queue = int(max_queue)
        self.max_batch = max(1, int(max_batch))
        self.default_time_limit = float(default_time_limit)
        # mesh routing: a coalesced same-bucket batch of >=
        # mesh_min_batch WGL requests serves as ONE check_mesh lane
        # group instead of N serial searches (mode on the
        # service_batch series; kill switch for A/B and repro)
        self.mesh_serving = bool(mesh_serving)
        self.mesh_min_batch = max(2, int(mesh_min_batch))
        # backpressure: while an SLO burn alert is live, new arrivals
        # shed (structured 503 + retry-after) for shed_hold_s instead
        # of queueing into a burning p95
        self.shed_hold_s = float(shed_hold_s)
        self._shed_until = 0.0
        self._shed_info: Optional[dict] = None
        # autopilot: the verify-or-revert control loop (autopilot.py)
        # — opt-in; start() spawns the supervisor thread
        self.autopilot_enabled = bool(autopilot)
        self.autopilot_every_s = float(autopilot_every_s)
        self._autopilot = None
        # fleet identity + heartbeat: periodic kind="replica-heartbeat"
        # ledger records are the replica's liveness/inventory feed
        self.replica_id = str(replica_id) if replica_id \
            else default_replica_id()
        self.heartbeat_every_s = float(heartbeat_every_s) \
            if heartbeat_every_s is not None else heartbeat_interval()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_count = 0
        self.slo = slo_engine if slo_engine is not None \
            else slo_mod.Engine(ledger=self.ledger)
        self.slo_every_s = float(slo_every_s)
        self._last_slo = 0.0
        # lockwatch.rlock is a plain threading.RLock unless
        # JEPSEN_TPU_LOCKWATCH is set; then it is the lock-order witness
        # (both Conditions below share it, so they are one lock to it)
        self._lock = lockwatch.rlock("service")
        self._cv = threading.Condition(self._lock)     # workers
        self._ev_cv = threading.Condition(self._lock)  # SSE readers
        self._queues: dict = {}   # bucket key -> deque[_Request]
        self._runs: dict = {}     # run id -> _Request (bounded)
        self._warm: dict = {}     # bucket key -> warm info
        self._warming: dict = {}  # bucket key -> in-flight Event
        self._usage: dict = {}    # tenant -> [(t, device_s)] window
        self._usage_seeded: set = set()
        self._events: deque = deque(maxlen=EVENTS_CAP)
        self._seq = 0
        self._hold = False
        self._stop = False
        self._threads: list = []
        self._retire = 0  # workers resize_workers asked to exit
        self._stats = {"submitted": 0, "served": 0, "rejected": 0,
                       "warm_hits": 0, "batches": 0, "errors": 0,
                       "shed": 0, "mesh_batches": 0, "degrades": 0}
        if rewarm:
            self.rewarm()

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "Service":
        # the worker spawn AND the supervisor/heartbeat claims happen in
        # ONE locked section: two concurrent start() calls must not both
        # spawn a pool, a supervisor or a heartbeat thread. The claim is
        # atomic; the (slow) Supervisor construction runs after, outside
        # the lock.
        with self._lock:
            if self._threads:
                return self
            self._stop = False
            for i in range(self.workers):
                t = threading.Thread(target=self._worker_loop,
                                     name=f"service-worker-{i}",
                                     daemon=True)
                t.start()
                self._threads.append(t)
            start_ap = self.autopilot_enabled \
                and self._autopilot is None
            start_hb = self.heartbeat_every_s > 0 \
                and self._hb_thread is None
        if start_ap:
            from . import autopilot as autopilot_mod
            sup = autopilot_mod.Supervisor(
                autopilot_mod.ServiceHost(self),
                every_s=self.autopilot_every_s, where="service",
                mx=self.mx, ledger=self.ledger).start()
            with self._lock:
                self._autopilot = sup
            autopilot_mod.set_default(sup)
        if start_hb:
            self._hb_stop.clear()
            hb = threading.Thread(target=self._heartbeat_loop,
                                  name="service-heartbeat",
                                  daemon=True)
            hb.start()
            with self._lock:
                self._hb_thread = hb
        set_default(self)
        return self

    def close(self, timeout: float = 5.0) -> None:
        # detach under the lock, join OUTSIDE it: the supervisor and
        # heartbeat threads take the service lock on their way out, so
        # joining them while holding the lock would deadlock, and two
        # concurrent close() calls must not both join
        with self._lock:
            sup, self._autopilot = self._autopilot, None
            hb, self._hb_thread = self._hb_thread, None
        if sup is not None:
            sup.close(timeout=timeout)
        if hb is not None:
            self._hb_stop.set()
            hb.join(timeout=timeout)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            self._ev_cv.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        with self._lock:
            self._threads = []
        if lockwatch.enabled():
            lockwatch.bank(self.ledger)

    @property
    def closed(self) -> bool:
        """True once close() ran — SSE streamers check this and end
        their streams instead of spinning on a drained feed (the
        event waiters return immediately when stopped)."""
        return self._stop

    def hold(self, flag: bool) -> None:
        """Pause (True) / resume (False) dequeueing — the
        deterministic coalescing control: hold, submit N same-bucket
        requests, release, and they serve as ONE batch."""
        with self._cv:
            self._hold = bool(flag)
            if not flag:
                self._cv.notify_all()

    def resize_workers(self, n: int) -> dict:
        """Resize the resident worker pool. Growing spawns
        threads immediately; shrinking retires surplus workers at
        their next dequeue tick — in-flight batches always finish.
        Raises ValueError when the request leaves [1, POOL_MAX]; a
        rejected resize is the caller's structured fault."""
        n = int(n)
        if not 1 <= n <= POOL_MAX:
            raise ValueError(f"pool resize rejected: workers {n} "
                             f"outside [1, {POOL_MAX}]")
        with self._cv:
            prev = self.workers
            self.workers = n
            if self._threads:
                self._threads = [t for t in self._threads
                                 if t.is_alive()]
                live = len(self._threads) - self._retire
                if n > live:
                    for _ in range(n - live):
                        t = threading.Thread(
                            target=self._worker_loop,
                            name=f"service-worker-"
                                 f"{len(self._threads)}",
                            daemon=True)
                        t.start()
                        self._threads.append(t)
                elif n < live:
                    self._retire += live - n
                self._cv.notify_all()
        self._emit(None, "pool-resize", workers_from=prev,
                   workers_to=n)
        return {"from": prev, "to": n}

    def open_shed(self, burning: list, hold_s: Optional[float] = None,
                  source: str = "operator") -> dict:
        """Open the admission shed window explicitly: brake BEFORE
        `_note_slo`'s multi-window alert would force the same brake
        harder and later (the autopilot's pre-shed actuator calls this)."""
        hold = float(hold_s if hold_s is not None
                     else self.shed_hold_s)
        names = [str(b) for b in burning]
        with self._lock:
            self._shed_until = time.monotonic() + hold
            self._shed_info = {"burning": names, "hold_s": hold,
                               "source": source}
        self._emit(None, "shedding", burning=names, hold_s=hold,
                   source=source)
        return {"burning": names, "hold_s": hold}

    def close_shed(self) -> None:
        """Close the shed window (an open_shed rollback; `_note_slo`
        also closes it on the next clean evaluation)."""
        with self._lock:
            self._shed_info = None

    # -- events -------------------------------------------------------
    def _emit(self, req: Optional[_Request], event: str,
              **data) -> None:
        with self._lock:
            self._seq += 1
            entry = {"seq": self._seq, "t": round(time.time(), 3),
                     "event": event}
            if req is not None:
                entry["run_id"] = req.id
            entry.update(data)
            self._events.append(entry)
            if req is not None:
                req.events.append(entry)
                del req.events[:-64]
            self._ev_cv.notify_all()

    def events_since(self, after: int = 0,
                     timeout: float = 0.0) -> list:
        """Global feed entries with seq > `after`; blocks up to
        `timeout` for the first new one (the /events SSE source)."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._ev_cv:
            while True:
                out = [e for e in self._events if e["seq"] > after]
                if out or self._stop:
                    return out
                left = deadline - time.monotonic()
                if left <= 0:
                    return []
                self._ev_cv.wait(timeout=min(left, 0.5))

    def run_events(self, run_id: str, after: int = 0,
                   timeout: float = 0.0) -> tuple:
        """(new events, done?) for one run — the /runs/<id>/events
        SSE source. Unknown ids return ([], True)."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._ev_cv:
            while True:
                req = self._runs.get(run_id)
                if req is None:
                    return [], True
                out = [e for e in req.events if e["seq"] > after]
                done = req.state in ("done", "rejected")
                if out or done or self._stop:
                    return out, done
                left = deadline - time.monotonic()
                if left <= 0:
                    return [], False
                self._ev_cv.wait(timeout=min(left, 0.5))

    def get(self, run_id: str) -> Optional[dict]:
        """Compact view of one request (None when unknown)."""
        with self._lock:
            req = self._runs.get(run_id)
            if req is None:
                return None
            out = {"id": req.id, "state": req.state,
                   "tenant": req.tenant, "checker": req.checker,
                   "model": req.model_name,
                   "bucket": _key_str(req.bucket_key),
                   "warm_hit": req.warm_hit,
                   "wait_s": req.wait_s, "serve_s": req.serve_s,
                   "wall_s": req.total_s, "phases": dict(req.phases),
                   "events": list(req.events)}
            if req.result is not None:
                out["verdict"] = req.result.get("valid?")
                if req.result.get("cause") is not None:
                    out["cause"] = req.result.get("cause")
            return out

    # -- backpressure -------------------------------------------------
    def shedding(self) -> Optional[dict]:
        """The active shed window, None when admitting normally.
        Opened by `_note_slo` when the SLO engine's multi-window burn
        trips (env JEPSEN_TPU_SLO_BURN_X), closed when a later
        evaluation comes back clean or the hold expires. While open,
        `submit` rejects new arrivals with cause "shed" and a
        retry-after — load must drain the burning budget, not deepen
        it (the 503 path in web.py; sheds are excluded from the SLO
        objectives like the other admission rejections)."""
        with self._lock:
            if self._shed_info is None:
                return None
            left = self._shed_until - time.monotonic()
            if left <= 0:
                self._shed_info = None
                return None
            return dict(self._shed_info,
                        retry_after_s=round(left, 3))

    def _note_slo(self, report) -> None:
        """Couple admission to the error budget: a report with live
        burn alerts opens (or extends) the shed window; a clean one
        closes it immediately rather than waiting out the hold."""
        if not isinstance(report, dict):
            return
        burning = [str(a.get("objective")) for a in
                   (report.get("alerts") or [])]
        with self._lock:
            if burning:
                fresh = self._shed_info is None
                self._shed_until = (time.monotonic()
                                    + self.shed_hold_s)
                self._shed_info = {"burning": burning,
                                   "hold_s": self.shed_hold_s}
            else:
                fresh = False
                self._shed_info = None
        if fresh:
            self._emit(None, "shedding", burning=burning,
                       hold_s=self.shed_hold_s)

    # -- admission ----------------------------------------------------
    def tenant_usage(self, tenant: str,
                     window_s: Optional[float] = None) -> float:
        """Device-seconds this tenant consumed inside the rolling
        quota window (the per-tenant billing unit). The ledger is
        scanned ONCE per tenant per process to seed the window (prior
        traffic, possibly another process's); after that the window is
        an in-memory list `_record` appends to — an admission-path
        check must never scale with total ledger history."""
        tenant = str(tenant)
        window = (window_s if window_s is not None
                  else self.quota_window_s)
        now = time.time()
        with self._lock:
            seeded = tenant in self._usage_seeded
        if not seeded:
            try:
                recs = self.ledger.query(kind="service-request",
                                         since=now - window)
            except Exception:  # noqa: BLE001 — a torn ledger
                recs = []      # seeds an empty window
            rows = [(float(r.get("t") or 0),
                     float(r.get("device_s") or 0.0))
                    for r in recs if r.get("tenant") == tenant]
            with self._lock:
                if tenant not in self._usage_seeded:
                    self._usage[tenant] = rows + \
                        self._usage.get(tenant, [])
                    self._usage_seeded.add(tenant)
        with self._lock:
            rows = self._usage.setdefault(tenant, [])
            rows[:] = [(t, d) for t, d in rows
                       if t >= now - window]
            return round(sum(d for _, d in rows), 6)

    def submit(self, payload: dict) -> dict:
        """The POST /check entry: admit + preflight + enqueue.
        Returns {"id", "state", ...} — admission rejections (quota,
        preflight, malformed history) come back as an already-decided
        run with verdict "unknown" and a cause, so the client always
        gets a ledger-addressable run id. Raises ValueError only for
        requests too malformed to account (no model, no history)."""
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        checker = str(payload.get("checker") or "wgl")
        if checker not in _CHECKERS:
            raise ValueError(f"unknown checker {checker!r} "
                             f"(known: {_CHECKERS})")
        tenant = str(payload.get("tenant") or "default")
        rid = ledger_mod.new_id()
        req = _Request(rid, tenant, checker)
        req.params = dict(payload.get("params") or {})
        t0 = time.monotonic()
        ctx = None  # the request trace id: every later span adopts it
        with self.tracer.span("admit", attrs={"run_id": rid,
                                              "tenant": tenant}):
            ctx = self.tracer.context()
            if checker == "wgl":
                name = str(payload.get("model") or "")
                factory = _models().get(name)
                if factory is None:
                    raise ValueError(
                        f"unknown model {name!r} "
                        f"(known: {sorted(_models())})")
                req.model_name = name
                req.model = factory()
            req.history = _parse_history(payload.get("history"))
            if len(req.history) == 0:
                raise ValueError("history is empty")
        req.phases["admit_s"] = round(time.monotonic() - t0, 6)
        with self._lock:
            self._stats["submitted"] += 1
        # burn-driven shed: checked FIRST (cheapest) — while the SLO
        # budget burns, new load is the problem, not the work
        shed = self.shedding()
        if shed is not None:
            with self._lock:
                self._stats["shed"] += 1
            out = self._reject(req, ctx, "shed", detail=shed)
            out["retry_after_s"] = shed["retry_after_s"]
            return out
        # tenant quota: billed from the ledger aggregates, enforced
        # BEFORE any encode/preflight work
        if self.quota_device_s is not None:
            used = self.tenant_usage(tenant)
            if used >= self.quota_device_s:
                return self._reject(
                    req, ctx, "quota",
                    detail={"tenant": tenant,
                            "device_s_used": used,
                            "device_s_quota": self.quota_device_s})
        t1 = time.monotonic()
        with self.tracer.span("preflight", parent=ctx,
                              attrs={"run_id": rid}):
            gate = self._preflight(req)
        req.phases["preflight_s"] = round(time.monotonic() - t1, 6)
        if gate is not None:
            return self._reject(req, ctx, "preflight", result=gate)
        with self._cv:
            depth = sum(len(q) for q in self._queues.values())
            if depth >= self.max_queue:
                return self._reject(
                    req, ctx, "queue-full",
                    detail={"depth": depth,
                            "max_queue": self.max_queue})
            q = self._queues.setdefault(req.bucket_key, deque())
            q.append(req)
            req.position = len(q)
            req.state = "queued"
            self._runs[req.id] = req
            self._trim_runs_locked()
            # the trace context rides the request into the workers
            req.params["_ctx"] = ctx
            self.mx.gauge("service_queue_depth",
                          "requests waiting in the admission queue"
                          ).set(depth + 1)
            self._cv.notify()
        self._emit(req, "queued", position=req.position,
                   depth=depth + 1, bucket=_key_str(req.bucket_key))
        self.start()
        return {"id": req.id, "state": "queued",
                "position": req.position, "depth": depth + 1,
                "bucket": _key_str(req.bucket_key)}

    def _preflight(self, req: _Request) -> Optional[dict]:
        """Static admission (analysis/preflight) + bucket derivation.
        Returns the reject result when infeasible, else None with
        `req.enc`/`req.bucket_key`/`req.bucket` populated."""
        from .analysis import preflight
        if req.checker == "wgl":
            from .ops.encode import EncodingUnsupported, encode
            try:
                req.enc = encode(req.model, req.history)
                req.bucket_key, req.bucket = bucket_for(req.enc)
            except EncodingUnsupported:
                # the engine will fast-fail it with the structured
                # encoding block; bucket on the model alone
                req.enc = None
                req.bucket_key = ("wgl-unencodable", req.model_name)
            with ledger_mod.use(self.ledger):
                return preflight.gate_wgl(
                    req.model, req.history, enc=req.enc,
                    where="service", devices=[self.device],
                    ledger_name=f"service:{req.model_name}")
        n_txns = sum(1 for op in req.history if op.is_ok)
        req.bucket_key = (req.checker,
                          _quantize(max(n_txns, 1), ELLE_TXN_QUANTUM))
        backend = str(req.params.get("cycle_backend") or "auto")
        with ledger_mod.use(self.ledger):
            return preflight.gate_elle(
                n_txns, backend=backend, where="service",
                devices=self.devices,
                ledger_name=f"service:{req.checker}")

    def _reject(self, req: _Request, ctx, cause: str,
                result: Optional[dict] = None,
                detail: Optional[dict] = None) -> dict:
        req.result = result if result is not None else {
            "valid?": "unknown", "cause": cause, **(detail or {})}
        req.result.setdefault("cause", cause)
        req.wait_s = req.serve_s = 0.0
        req.total_s = round(time.monotonic() - req.t_mono, 6)
        with self._lock:
            self._runs[req.id] = req
            self._trim_runs_locked()
        with self.tracer.span("respond", parent=ctx,
                              attrs={"run_id": req.id,
                                     "cause": req.result["cause"]}):
            self._record(req)
        # terminal flip + counter only after banking — the same
        # heartbeat-visibility rule the finish paths follow
        with self._lock:
            self._stats["rejected"] += 1
        req.state = "rejected"
        self._emit(req, "rejected", cause=req.result["cause"])
        return {"id": req.id, "state": "rejected",
                "verdict": "unknown", "cause": req.result["cause"]}

    def _trim_runs_locked(self) -> None:
        while len(self._runs) > RUNS_CAP:
            self._runs.pop(next(iter(self._runs)))

    # -- the worker pool ----------------------------------------------
    def _accel(self) -> bool:
        return self.device.type == "cuda"

    def _pick_key_locked(self):
        best = None
        best_t = None
        for key, q in self._queues.items():
            if not q:
                continue
            if best_t is None or q[0].t_mono < best_t:
                best, best_t = key, q[0].t_mono
        return best

    def _next_batch(self) -> Optional[list]:
        with self._cv:
            while not self._stop:
                if self._retire > 0:
                    # resize_workers shrank the pool: this worker
                    # takes the retirement (empty batch = exit)
                    self._retire -= 1
                    return []
                if not self._hold:
                    key = self._pick_key_locked()
                    if key is not None:
                        q = self._queues[key]
                        batch = []
                        while q and len(batch) < self.max_batch:
                            batch.append(q.popleft())
                        if not q:
                            del self._queues[key]
                        depth = sum(len(qq) for qq
                                    in self._queues.values())
                        self.mx.gauge(
                            "service_queue_depth",
                            "requests waiting in the admission "
                            "queue").set(depth)
                        for r in batch:
                            r.state = "serving"
                        return batch
                self._cv.wait(timeout=0.2)
        return None

    def _worker_loop(self) -> None:
        while not self._stop:
            batch = self._next_batch()
            if batch == []:  # retired by resize_workers
                break
            if not batch:
                continue
            try:
                self._serve_batch(batch)
            except Exception as e:  # noqa: BLE001 — a worker crash
                # must fail the batch's requests, never the pool
                for req in batch:
                    if req.state != "done":
                        self._finish(
                            req,
                            {"valid?": "unknown",
                             "cause": f"service-error: {e}"[:200]},
                            warm_hit=False, batch_n=len(batch),
                            t_serve0=time.monotonic())
                fleet.record_fault(fleet.fault_event(
                    e, stage="service-worker"), mx=self.mx)
                with self._lock:
                    self._stats["errors"] += 1
            self._maybe_evaluate_slo()
            self._maybe_trim_telemetry()

    def _serve_batch(self, batch: list) -> None:
        key = batch[0].bucket_key
        with self._lock:
            self._stats["batches"] += 1
        self.mx.counter("service_batches_total",
                        "coalesced service batches").inc(
            bucket=_key_str(key))
        ctx0 = batch[0].params.get("_ctx")
        t_dispatch = time.monotonic()
        warm_s = 0.0
        # one warm per bucket even across workers: the first worker
        # to claim the key compiles; a sibling worker serving a
        # same-bucket batch mid-warm WAITS on the claim instead of
        # paying a duplicate ladder compile in its serve path
        with self._lock:
            warm_hit = key in self._warm
            pending = self._warming.get(key)
            claim = None
            if not warm_hit and pending is None:
                claim = self._warming[key] = threading.Event()
        if claim is not None:
            try:
                with self.tracer.span(
                        "warm-dispatch", parent=ctx0,
                        attrs={"bucket": _key_str(key),
                               "batch_n": len(batch),
                               "run_ids": [r.id for r in batch]}):
                    warmed = self._warm_bucket(batch[0])
                warm_s = round(time.monotonic() - t_dispatch, 6)
                if warmed:
                    # only a SUCCESSFUL warm-up marks the bucket warm
                    # — a failed precompile must retry on the next
                    # cold batch, not report warm_hit=True while
                    # paying compiles in-band (that would judge cold
                    # requests against the warm SLO target)
                    with self._lock:
                        self._warm[key] = {"t": time.time(),
                                           "warm_s": warm_s}
            finally:
                with self._lock:
                    self._warming.pop(key, None)
                claim.set()
        elif not warm_hit and pending is not None:
            pending.wait(timeout=600.0)
            warm_s = round(time.monotonic() - t_dispatch, 6)
        for req in batch:
            if warm_s:
                req.phases["warm_s"] = warm_s
        # routing: a coalesced same-bucket batch is ONE mesh lane
        # group (the canonical bucket IS the lane-group key) — N
        # requests, one round set. mode "serial" = never eligible
        # (policy/shape); "degrade" = should have meshed but the mesh
        # declined (<2 devices, infeasible plan): a recorded decision
        mode, detail = self._mesh_route(batch)
        if mode == "mesh":
            if not self._serve_batch_mesh(batch, warm_hit):
                mode, detail = "degrade", {"cause": "mesh-declined"}
        if mode != "mesh":
            for req in batch:
                self._serve_one(req, warm_hit, len(batch))
        self._record_batch(key, batch, mode, detail)

    # -- mesh routing -------------------------------------------------
    def _device_count(self) -> int:
        """The service's device list's length: the mesh the coalesced
        batches run on (a list may repeat a card)."""
        return len(self.devices)

    def _mesh_devices(self, layout: dict) -> list:
        """The devices of a mesh layout: the first `n_devices` of the
        service's list."""
        return self.devices[:int(layout["n_devices"])]

    def _mesh_layout(self) -> Optional[dict]:
        """The PINNED lane layout mesh-routed batches run — and warm
        — at: lanes sized for a FULL batch (`max_batch`) regardless
        of any one batch's n, so every batch of a bucket reuses ONE
        executable set; an under-full batch leaves slots inert
        (slot_key -1), which costs padded FLOPs, never a recompile.
        None when mesh serving is off, killed by env, or <2
        devices in the service's list."""
        if not self.mesh_serving:
            return None
        try:
            from .parallel import mesh as mesh_mod
            if not mesh_mod.enabled():
                return None
            nd = self._device_count()
            if nd < 2:
                return None
            # never more shards than the batch has lanes: a surplus
            # shard's inert lane still computes every lockstep round,
            # so width beyond max_batch costs serve time for nothing
            nd = min(nd, max(2, self.max_batch))
            return {"n_devices": nd,
                    "lanes_per_device": mesh_mod.lanes_for(
                        self.max_batch, nd),
                    "chunk": 1024}
        except Exception:  # noqa: BLE001
            return None

    def _mesh_route(self, batch: list) -> tuple:
        """(mode, detail) for one coalesced batch: "mesh" when it can
        run as one lane group, "serial" when it never could (too
        small, non-WGL, unencodable, mixed models, mesh disabled),
        "degrade" when it SHOULD have meshed but cannot right now
        (<2 devices) — degrades are recorded routing decisions, not
        defaults."""
        if not self.mesh_serving or len(batch) < self.mesh_min_batch:
            return "serial", {"cause": "policy"}
        if any(r.checker != "wgl" or r.enc is None
               or r.bucket is None for r in batch):
            return "serial", {"cause": "not-meshable"}
        if len({r.model_name for r in batch}) != 1:
            return "serial", {"cause": "mixed-models"}
        try:
            from .parallel import mesh as mesh_mod
            if not mesh_mod.enabled():
                return "serial", {"cause": "mesh-disabled"}
        except Exception:  # noqa: BLE001
            return "serial", {"cause": "mesh-unavailable"}
        nd = self._device_count()
        if nd < 2:
            return "degrade", {"cause": "single-device",
                               "n_devices": nd}
        return "mesh", {"n_devices": nd}

    def _serve_batch_mesh(self, batch: list, warm_hit: bool) -> bool:
        """Serve the whole coalesced batch as ONE `check_mesh` lane-
        packed round set at the CANONICAL bucket (the warmed
        executables ARE the scheduled ones — `shape_bucket=` pins the
        kernel the warm path compiled, `lanes_per_device` pins the
        batch width). False when the mesh declined (backend init
        timeout, infeasible preflight plan, canonical bucket not
        covering): the caller serves serially and records the
        degrade. The mesh's devices are the service's list."""
        req0 = batch[0]
        layout = self._mesh_layout()
        if layout is None:
            return False
        tl = max(float(r.params.get("time_limit")
                       or self.default_time_limit) for r in batch)
        t_serve0 = time.monotonic()
        try:
            from .parallel import mesh as mesh_mod
            with self.tracer.span(
                    "mesh-batch", parent=req0.params.get("_ctx"),
                    attrs={"bucket": _key_str(req0.bucket_key),
                           "batch_n": len(batch),
                           "run_ids": [r.id for r in batch]}):
                results = mesh_mod.check_mesh(
                    req0.model, [r.history for r in batch],
                    encs=[r.enc for r in batch],
                    time_limit=tl,
                    lanes_per_device=layout["lanes_per_device"],
                    chunk=layout["chunk"],
                    shape_bucket=req0.bucket,
                    devices=self._mesh_devices(layout))
        except Exception as e:  # noqa: BLE001 — a mesh crash
            # degrades the batch, never fails it
            fleet.record_fault(fleet.fault_event(
                e, stage="service-mesh"), mx=self.mx)
            return False
        if results is None or any(r is None for r in results):
            return False
        for req, res in zip(batch, results):
            self._finish_mesh_member(req, res, warm_hit,
                                     len(batch), t_serve0)
        return True

    def _finish_mesh_member(self, req: _Request, res: dict,
                            warm_hit: bool, batch_n: int,
                            t_serve0: float) -> None:
        """Per-member bookkeeping for a mesh-served batch with the
        lane's OWN walls: serve_s is the shard's wall (slot load ->
        retire), so a lane retired at round r never bills rounds
        r+1..R as serve time; everything before the lane started —
        including sibling rounds the member waited out — lands in
        queue_wait_s, the same attribution the serial path uses for
        in-batch waits."""
        ctx = req.params.get("_ctx")
        shard = res.get("shard") or {}
        lane_t0 = float(shard.get("t0") or t_serve0)
        now_m = time.monotonic()
        lane_wall = shard.get("wall_s")
        req.warm_hit = warm_hit
        req.batch_n = batch_n
        req.wait_s = round(
            max(lane_t0 - req.t_mono
                - (req.phases.get("warm_s") or 0.0), 0.0), 6)
        req.phases["queue_wait_s"] = req.wait_s
        req.serve_s = round(float(
            lane_wall if lane_wall is not None
            else now_m - t_serve0), 6)
        req.phases["search_s"] = req.serve_s
        # spans backdated to the lane's real window (the serial path
        # backdates queue-wait the same way): epoch = now - (mono_now
        # - mono_stamp)
        lane_epoch = time.time() - (now_m - lane_t0)
        with self.tracer.span("queue-wait", parent=ctx,
                              attrs={"run_id": req.id}) as sp:
            if sp is not None:
                sp.start_s = req.t_epoch
        if sp is not None:
            sp.end_s = lane_epoch
        with self.tracer.span(
                "search", parent=ctx,
                attrs={"run_id": req.id, "checker": req.checker,
                       "warm_hit": warm_hit, "mode": "mesh"}) as sp:
            pass
        if sp is not None:
            sp.start_s = lane_epoch
            sp.end_s = lane_epoch + req.serve_s
        self._emit(req, "serving", wait_s=req.wait_s,
                   warm_hit=warm_hit, batch_n=batch_n, mode="mesh",
                   mesh=res.get("mesh"))
        t_done = time.monotonic()
        req.total_s = round(t_done - req.t_mono, 6)
        req.result = res
        with self.tracer.span("respond", parent=ctx,
                              attrs={"run_id": req.id}):
            req.phases["respond_s"] = round(
                time.monotonic() - t_done, 6)
            self._record(req)
        # "done" AND the served/warm counters only after banking —
        # same visibility rule as _finish: a heartbeat snapshotting
        # served=N must never precede the N-th request's record in
        # the ledger index
        with self._lock:
            self._stats["served"] += 1
            if warm_hit:
                self._stats["warm_hits"] += 1
        req.state = "done"
        self._emit(req, "done",
                   verdict=_verdict_str(res.get("valid?")),
                   cause=res.get("cause"), wall_s=req.total_s,
                   warm_hit=warm_hit)

    def _record_batch(self, key, batch: list, mode: str,
                      detail: Optional[dict]) -> None:
        """One `service_batch` series point per coalesced batch: the
        routing decision (mode mesh|serial|degrade), the round count,
        and the mesh shard map — the batch-level complement of the
        per-request `service` series."""
        rounds = 0
        shards: dict = {}
        for req in batch:
            res = req.result or {}
            rounds = max(rounds, int(
                (res.get("util") or {}).get("rounds") or 0))
            dev = (res.get("shard") or {}).get("device")
            if mode == "mesh" and dev:
                shards[str(dev)] = shards.get(str(dev), 0) + 1
        with self._lock:
            if mode == "mesh":
                self._stats["mesh_batches"] += 1
            elif mode == "degrade":
                self._stats["degrades"] += 1
        try:
            if self.mx.enabled:
                self.mx.series(
                    "service_batch",
                    "per-batch routing telemetry of the checker "
                    "service (doc/OBSERVABILITY.md \"Service & SLO "
                    "plane\")").append({
                        "bucket": _key_str(key),
                        "batch_n": len(batch),
                        "mode": mode,
                        "rounds": int(rounds),
                        "shards": shards,
                        "run_ids": [r.id for r in batch],
                        "cause": (detail or {}).get("cause")})
                self.mx.counter(
                    "service_batch_modes_total",
                    "coalesced batches by routing mode").inc(
                    mode=mode)
        except Exception:  # noqa: BLE001
            pass
        self._emit(None, "batch", bucket=_key_str(key),
                   batch_n=len(batch), mode=mode, rounds=rounds)

    def _warm_bucket(self, req: _Request) -> bool:
        """Pay the bucket's kernel builds, loads, binds and first
        launches ONCE, ahead of its first search, and register the
        plan in fs_cache so a restarted process re-warms before
        traffic (`rewarm`). First-touch accounting (return True
        without warming) when ladder warming is off or the bucket has
        no canonical shape (unencodable: what the process has loaded
        is the warm set there; Elle warms through `_warm_elle_bucket`);
        False only when the precompile itself failed, so the caller
        retries instead of mislabeling the bucket warm."""
        if not self.warm_ladder:
            return True
        if req.bucket is None:
            if req.checker in ("elle-append", "elle-wr"):
                return self._warm_elle_bucket(req)
            return True
        try:
            from .ops import aot
            # ONE registry entry per canonical bucket covers BOTH
            # serving paths: the serial ladder and — at the pinned
            # lane layout — the mesh lane-group plan, so whichever
            # way _serve_batch routes, the executables it schedules
            # are the ones this warm compiled
            layout = self._mesh_layout()
            compile_s = aot.precompile_service_plan(
                req.bucket, bucket_key=req.bucket_key,
                model_name=req.model_name, mesh_layout=layout,
                save=True, device=self.device,
                devices=(self._mesh_devices(layout) if layout
                         else None))
        except Exception as e:  # noqa: BLE001 — a failed warm-up
            # degrades to in-band compiles, never a failed request
            fleet.record_fault(fleet.fault_event(
                e, stage="service-warm"), mx=self.mx)
            return False
        self._emit(req, "warmed", bucket=_key_str(req.bucket_key),
                   compile_s=compile_s)
        return True

    def _warm_elle_bucket(self, req: _Request) -> bool:
        """Elle's warm path: derive the closure shape bucket the same
        way the checker will (build the first request's tensors),
        warm the kernels, and register the bucket under the SAME
        ("service-plan", ...) namespace — so `rewarm()` restores
        Elle warmth across restarts too, not just WGL. A history the
        builder cannot shape (BuildUnsupported) marks the bucket warm
        with nothing compiled: the per-request path degrades the
        same way, so there is nothing to warm."""
        try:
            from .elle import build as build_mod
            from .elle import tpu as elle_tpu
            hist = req.history
            oks = [op for op in hist
                   if op.is_ok and op.f in ("txn", None)
                   and op.value]
            infos = [op for op in hist
                     if op.is_info and op.f in ("txn", None)
                     and op.value]
            if req.checker == "elle-append":
                bt = build_mod.build_append(hist, oks, infos)
            else:
                bt = build_mod.build_wr(hist, oks, infos)
            eb = elle_tpu.shape_bucket_for(bt.tensors)
        except Exception:  # noqa: BLE001 — unshapeable history:
            return True    # nothing to warm, not a warm failure
        try:
            from .ops import aot
            compile_s = aot.precompile_elle_closure(
                eb, device=self.device, devices=self.devices)
        except Exception as e:  # noqa: BLE001
            fleet.record_fault(fleet.fault_event(
                e, stage="service-warm"), mx=self.mx)
            return False
        self._emit(req, "warmed", bucket=_key_str(req.bucket_key),
                   compile_s=compile_s)
        try:
            from . import fs_cache
            keystr = "-".join(str(k) for k in req.bucket_key)
            fs_cache.save_data(
                ("service-plan", str(req.checker), keystr),
                {"elle_bucket": {"n": eb.get("n"),
                                 "trim": list(eb["trim"]),
                                 "dense": eb.get("dense"),
                                 # shard count resolved at rewarm
                                 # from THAT replica's fleet
                                 "sharded": eb.get("sharded")},
                 "key": list(req.bucket_key),
                 "checker": req.checker,
                 "t": round(time.time(), 3)})
        except Exception:  # noqa: BLE001 — the plan registry is an
            pass           # optimization, not a correctness need
        return True

    def rewarm(self) -> list:
        """The restart warm path: re-compile every bucket plan earlier
        traffic registered in fs_cache (("service-plan", ...)), so a
        fresh process answers its first same-bucket request warm.
        WGL entries replay BOTH halves of the unified plan (serial
        ladder + mesh lane group, when the recorded mesh layout still
        matches the service's device count, over the service's own
        list); Elle entries replay the closure kernels. Stale or
        unreadable entries, and a plan whose warm fails, skip."""
        from . import fs_cache
        try:
            plans = fs_cache.list_data(("service-plan",))
        except Exception:  # noqa: BLE001
            return []
        out = []
        layout = self._mesh_layout() if self.mesh_serving else None
        for plan in plans:
            if not isinstance(plan, dict):
                continue
            key = tuple(plan.get("key") or ())
            try:
                from .ops import aot
                if "elle_bucket" in plan:
                    compile_s = aot.precompile_elle_closure(
                        plan["elle_bucket"], device=self.device,
                        devices=self.devices)
                elif "bucket" in plan:
                    want = plan.get("mesh")
                    mesh_layout = None
                    if (isinstance(want, dict) and layout
                            and int(want.get("n_devices") or 0)
                            == int(layout["n_devices"])):
                        # the recorded layout only warms executables
                        # the live mesh will actually schedule
                        mesh_layout = {
                            "n_devices": int(layout["n_devices"]),
                            "lanes_per_device": int(
                                want.get("lanes_per_device")
                                or layout["lanes_per_device"]),
                            "chunk": int(want.get("chunk") or 1024)}
                    compile_s = aot.precompile_service_plan(
                        plan["bucket"], bucket_key=key or ("?",),
                        model_name=plan.get("model"),
                        mesh_layout=mesh_layout, save=False,
                        device=self.device,
                        devices=(self._mesh_devices(mesh_layout)
                                 if mesh_layout else None))
                else:
                    continue
            except Exception:  # noqa: BLE001 — one stale plan must
                continue       # not block the others' warm-up
            if key:
                with self._lock:
                    self._warm[key] = {"t": time.time(),
                                       "rewarmed": True}
            out.append({"key": key, "compile_s": compile_s})
        return out

    def _serve_one(self, req: _Request, warm_hit: bool,
                   batch_n: int) -> None:
        ctx = req.params.get("_ctx")
        # queue wait ends when THIS request's search is about to run:
        # a batch serves serially, so members after the first spend
        # real wall waiting on their siblings — that wait must land
        # in queue_wait_s (it is what the queue-wait SLO objective
        # measures), not vanish
        # between phases. The bucket warm is attributed to its own
        # warm_s phase, so it is subtracted here.
        req.wait_s = round(time.monotonic() - req.t_mono
                           - (req.phases.get("warm_s") or 0.0), 6)
        req.warm_hit = warm_hit
        req.batch_n = batch_n
        # the queue-wait span covers submit-to-dispatch, backdated to
        # the submit stamp so the flame chart shows the real wait
        with self.tracer.span("queue-wait", parent=ctx,
                              attrs={"run_id": req.id}) as sp:
            if sp is not None:
                sp.start_s = req.t_epoch
        req.phases["queue_wait_s"] = req.wait_s
        self._emit(req, "serving", wait_s=req.wait_s,
                   warm_hit=warm_hit, batch_n=batch_n)
        t_serve0 = time.monotonic()
        with self.tracer.span(
                "search", parent=ctx,
                attrs={"run_id": req.id, "checker": req.checker,
                       "warm_hit": warm_hit}):
            try:
                res = self._run_check(req)
            except Exception as e:  # noqa: BLE001
                res = {"valid?": "unknown",
                       "cause": f"service-error: {e}"[:200]}
                fleet.record_fault(fleet.fault_event(
                    e, stage="service-search"), mx=self.mx)
        req.phases["search_s"] = round(time.monotonic() - t_serve0, 6)
        self._finish(req, res, warm_hit=warm_hit, batch_n=batch_n,
                     t_serve0=t_serve0, ctx=ctx)

    def _run_check(self, req: _Request) -> dict:
        p = req.params
        tl = float(p.get("time_limit") or self.default_time_limit)
        if req.checker == "wgl":
            from .ops import wgl
            return wgl.check(req.model, req.history, time_limit=tl,
                             enc=req.enc, shape_bucket=req.bucket,
                             metrics=self.mx, tracer=self.tracer,
                             device=self.device)
        backend = str(p.get("cycle_backend") or "auto")
        with metrics_mod.use(self.mx):
            if req.checker == "elle-append":
                from .elle import append
                return append.check(req.history,
                                    cycle_backend=backend,
                                    device=self.device,
                                    devices=self.devices)
            from .elle import wr
            return wr.check(req.history, cycle_backend=backend,
                            device=self.device, devices=self.devices)

    def _finish(self, req: _Request, res: dict, *, warm_hit: bool,
                batch_n: int, t_serve0: float, ctx=None) -> None:
        t_done = time.monotonic()
        req.serve_s = round(t_done - t_serve0, 6)
        req.total_s = round(t_done - req.t_mono, 6)
        req.result = res
        with self.tracer.span("respond", parent=ctx,
                              attrs={"run_id": req.id}):
            # respond covers everything after the search returned:
            # verdict bookkeeping up to (and estimated through) the
            # ledger write — stamped BEFORE _record so the recorded
            # phases block carries it
            req.phases["respond_s"] = round(
                time.monotonic() - t_done, 6)
            self._record(req)
        # "done" AND the served/warm counters only after banking: a
        # poller that sees the terminal state must also see the
        # service point and ledger record, and a replica-heartbeat
        # snapshotting served=N must never be banked ahead of the
        # N-th request's record in the index
        with self._lock:
            self._stats["served"] += 1
            if warm_hit:
                self._stats["warm_hits"] += 1
        req.state = "done"
        self._emit(req, "done",
                   verdict=_verdict_str(res.get("valid?")),
                   cause=res.get("cause"), wall_s=req.total_s,
                   warm_hit=warm_hit)

    # -- accounting ---------------------------------------------------
    def _record(self, req: _Request) -> None:
        """One `kind="service-request"` ledger record + one `service`
        series point per request — the billing/SLO substrate. Never
        raises."""
        res = req.result or {}
        verdict = _verdict_str(res.get("valid?"))
        shed = res.get("cause") == "shed"
        with self._lock:
            depth = sum(len(q) for q in self._queues.values())
        try:
            base = ledger_mod.summarize_result(res)
            rec = {"kind": "service-request", "id": req.id,
                   "name": f"service:{req.model_name or req.checker}",
                   "model": req.model_name, **base,
                   "tenant": req.tenant,
                   "checker": req.checker,
                   "warm_hit": bool(req.warm_hit),
                   "batch_n": int(req.batch_n),
                   "shed": shed,
                   "bucket": _key_str(req.bucket_key),
                   "wall_s": round(req.total_s or 0.0, 4),
                   "phases": {k: round(float(v), 6)
                              for k, v in req.phases.items()}}
            rec.setdefault("op_count",
                           len(req.history) if req.history else 0)
            rec.setdefault("device_s", 0.0)
            self.ledger.record(rec)
            # rolling quota window: seeded tenants accumulate
            # in-memory (unseeded ones pick this record up from the
            # ledger scan their first quota check runs)
            if self.quota_device_s is not None:
                with self._lock:
                    if req.tenant in self._usage_seeded:
                        self._usage.setdefault(
                            req.tenant, []).append(
                            (time.time(),
                             float(rec.get("device_s") or 0.0)))
        except Exception:  # noqa: BLE001
            pass
        try:
            if self.mx.enabled:
                self.mx.series(
                    "service",
                    "per-request lifecycle telemetry of the "
                    "checker service (doc/OBSERVABILITY.md "
                    "\"Service & SLO plane\")").append({
                        "run_id": req.id, "tenant": req.tenant,
                        "bucket": _key_str(req.bucket_key),
                        "verdict": verdict,
                        "cause": res.get("cause"),
                        "wait_s": float(req.wait_s or 0.0),
                        "serve_s": float(req.serve_s or 0.0),
                        "total_s": float(req.total_s or 0.0),
                        "warm_hit": bool(req.warm_hit),
                        "batch_n": int(req.batch_n),
                        "shed": shed,
                        "queue_depth": int(depth)})
                self.mx.counter(
                    "service_requests_total",
                    "service requests by verdict").inc(
                    verdict=verdict, tenant=req.tenant)
                if req.warm_hit:
                    self.mx.counter(
                        "service_warm_hits_total",
                        "requests served from a warm bucket").inc()
        except Exception:  # noqa: BLE001
            pass

    def _maybe_trim_telemetry(self) -> None:
        """Rotate the resident telemetry every TRIM_EVERY
        completions: spans and series keep a bounded recent window
        (a serving process otherwise grows without bound — the
        per-run ledger/artifacts remain the durable history)."""
        with self._lock:
            total = self._stats["served"] + self._stats["rejected"]
        if total % TRIM_EVERY:
            return
        try:
            self.tracer.trim(SPANS_CAP)
            for inst in self.mx.instruments():
                if inst.kind == "series":
                    inst.trim(SERIES_CAP)
        except Exception:  # noqa: BLE001
            pass

    def _maybe_evaluate_slo(self) -> None:
        if self.slo is None:
            return
        now = time.monotonic()
        if now - self._last_slo < self.slo_every_s:
            return
        self._last_slo = now
        try:
            rep = self.slo.evaluate_and_publish(mx=self.mx,
                                                led=self.ledger)
            self._note_slo(rep)
        except Exception:  # noqa: BLE001 — the objectives outrank
            pass           # their scheduler

    # -- replica heartbeat --------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.is_set():
            self._heartbeat_once()
            self._hb_stop.wait(self.heartbeat_every_s)

    def _heartbeat_once(self) -> Optional[str]:
        """Bank ONE `kind="replica-heartbeat"` ledger record (identity,
        liveness cadence, queue/served counters, warm-bucket inventory,
        autopilot state) and mirror the in-memory span/series windows under
        `<root>/service/`, so that another process can read this
        replica without touching it.

        Ordering contract: everything reported here is snapshotted under the
        service lock, and the finish/reject paths advance their
        counters and terminal states only AFTER the request's own
        record hits the index — so a heartbeat claiming served=N can
        never be banked ahead of the N-th service-request record.
        Never raises; returns the banked record id (None on failure
        or a disabled ledger)."""
        now = time.time()
        with self._lock:
            depth = sum(len(q) for q in self._queues.values())
            stats = dict(self._stats)
            warm = sorted(_key_str(k) for k in self._warm)
            workers = self.workers
            shedding = now < self._shed_until
        apt = None
        sup = self._autopilot
        if sup is not None:
            try:
                apt = {"active": True,
                       "quarantined": sorted(sup.quarantined())}
            except Exception:  # noqa: BLE001
                apt = {"active": True, "quarantined": []}
        served = stats["served"]
        rec = {"kind": "replica-heartbeat", "t": round(now, 3),
               "name": f"replica:{self.replica_id}",
               "replica": self.replica_id,
               "host": socket.gethostname(),
               "pid": int(os.getpid()),
               "devices": int(self._device_count()),
               "every_s": float(self.heartbeat_every_s),
               "workers": int(workers),
               "queued": int(depth),
               "submitted": int(stats["submitted"]),
               "served": int(served),
               "rejected": int(stats["rejected"]),
               "shed": int(stats["shed"]),
               "warm_rate": (round(stats["warm_hits"] / served, 4)
                             if served else None),
               "warm_buckets": warm,
               "shedding": bool(shedding)}
        if apt is not None:
            rec["autopilot"] = apt
        rid = None
        try:
            rid = self.ledger.record(rec)
        except Exception:  # noqa: BLE001 — liveness reporting must
            pass           # never hurt serving
        with self._lock:
            self._hb_count += 1
        self._export_telemetry()
        return rid

    def _export_telemetry(self) -> None:
        """Mirror the rotating span/series windows to
        `<store_root>/service/{trace,metrics}.jsonl` (tmp + atomic
        replace, so a reader in another process never sees a torn
        file). Never raises."""
        if not self.store_root:
            return
        d = os.path.join(self.store_root, "service")
        try:
            os.makedirs(d, exist_ok=True)
            for fname, export in (
                    ("trace.jsonl", self.tracer.export),
                    ("metrics.jsonl", self.mx.export_jsonl)):
                path = os.path.join(d, fname)
                tmp = f"{path}.tmp"
                export(tmp)
                os.replace(tmp, path)
        except Exception:  # noqa: BLE001
            pass

    # -- status -------------------------------------------------------
    def snapshot(self) -> dict:
        """The `/status.json` `service` block."""
        with self._lock:
            depth = sum(len(q) for q in self._queues.values())
            buckets = {_key_str(k): len(q)
                       for k, q in self._queues.items() if q}
            stats = dict(self._stats)
            warm = len(self._warm)
            recent = []
            for req in list(self._runs.values())[-8:]:
                recent.append({
                    "id": req.id, "state": req.state,
                    "tenant": req.tenant,
                    "verdict": (_verdict_str(
                        req.result.get("valid?"))
                        if req.result else None),
                    "wall_s": req.total_s,
                    "warm_hit": req.warm_hit})
            active = bool(self._threads) and not self._stop
        served = stats["served"]
        snap = {"active": active, "workers": self.workers,
                "replica": self.replica_id,
                "heartbeats": self._hb_count,
                "queued": depth, "buckets": buckets,
                "warm_buckets": warm, **stats,
                "warm_rate": (round(stats["warm_hits"] / served, 4)
                              if served else None),
                "shedding": self.shedding() is not None,
                "recent": recent}
        if lockwatch.enabled():
            snap["lockwatch"] = lockwatch.report()
        return snap


def _verdict_str(v) -> str:
    if v is True:
        return "true"
    if v is False:
        return "false"
    return str(v if v is not None else "unknown")


# -- ambient default ---------------------------------------------------------
# The serve process's service answers /status.json's `service` block
# (the preflight snapshot pattern); web.serve(service=...) and
# Service.start() both install it.
_default: Optional[Service] = None


def get_default() -> Optional[Service]:
    return _default


def set_default(svc: Optional[Service]) -> Optional[Service]:
    global _default
    prev = _default
    _default = svc
    return prev


def snapshot() -> dict:
    """The module-level `/status.json` `service` block: the default
    instance's snapshot, or the explicit inactive stub."""
    svc = _default
    if svc is None:
        return {"active": False, "workers": 0, "replica": None,
                "heartbeats": 0, "queued": 0,
                "buckets": {}, "warm_buckets": 0, "submitted": 0,
                "served": 0, "rejected": 0, "warm_hits": 0,
                "batches": 0, "errors": 0, "shed": 0,
                "mesh_batches": 0, "degrades": 0, "warm_rate": None,
                "shedding": False, "recent": []}
    return svc.snapshot()
