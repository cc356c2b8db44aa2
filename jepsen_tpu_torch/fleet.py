"""Fleet observability of the per-key fan-out: the host arithmetic that
per-key results carry, and the live run status.

A jax-free copy of `jepsen_tpu/fleet.py`: `device_label`,
`fault_event`, `rebucket_hint`, `steal_plan`, `compact_hint`,
`record_sched_event` and `summarize`, which `parallel.batched`,
`parallel.mesh` and `independent` stamp onto their results (`shard`
blocks, `util.fleet`, the mesh summary) and call between polls (the
steal plans); `record_shard` and `record_fault`, which put a per-key
shard block or a fault event into the ambient metrics registry
(`fleet_shards`, `fleet_faults`) and the ambient `RunStatus`, the
thread-safe live status of a run (phase, keys decided, per-device
state, search progress, faults, watchdog stalls, occupancy).

Zero-cost contract (as in `metrics`): the ambient default is a disabled
`RunStatus` whose recording methods return at once; JEPSEN_TPU_STATUS=1
(the reference's switch) or `set_default` / `use` install a real one.
The reference's status lock comes from its lock-order instrumentation;
the port's is a plain `threading.Lock`. `record_sched_event` also keeps
the scheduler's actions in a bounded list in memory (`sched_events`),
whether or not metrics are on.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Iterator, Optional

from . import metrics as _metrics

# Bound on a fault event's traceback text.
FAULT_TB_LIMIT = 4000

# Faults kept on the live status object (results/metrics keep them all).
STATUS_FAULT_CAP = 32

# Scheduler events kept in memory (`sched_events`), newest last.
SCHED_EVENT_CAP = 1024


def device_label(dev) -> str:
    """A stable short label for a device (`torch.device` or any
    stand-in)."""
    try:
        return str(dev)
    except Exception:  # noqa: BLE001 — a label must never raise
        return "device-?"


def device_labels(devices) -> list:
    """`device_label` of each entry of a device list, with a repeated
    entry made distinct by its occurrence (`cuda:0`, `cuda:0#1`,
    `cuda:0#2`, ...), so that shards sharing one device keep their
    per-shard stats and steal plans apart."""
    seen: dict = {}
    out = []
    for d in devices:
        label = device_label(d)
        k = seen.get(label, 0)
        seen[label] = k + 1
        out.append(label if k == 0 else f"{label}#{k}")
    return out


_SCHED_LOCK = threading.Lock()
_SCHED: deque = deque(maxlen=SCHED_EVENT_CAP)


def record_sched_event(series: str, point: dict, mx=None) -> None:
    """One scheduler action (a steal or rebucket of the mesh scheduler,
    series "mesh_sched", or a rebalance of the streamed worker pool,
    series "fleet_sched"), kept in memory with its series name, and,
    when metrics are on, appended to that series of the ambient
    registry with a `<series>_total{event}` count."""
    with _SCHED_LOCK:
        _SCHED.append(dict(point, series=series))
    mx = mx if mx is not None else _metrics.get_default()
    if not mx.enabled:
        return
    desc = ("scheduler events of the mesh-sharded fan-out"
            if series == "mesh_sched" else
            "rebucket actions applied by the streamed fan-out pool")
    mx.series(series, desc).append(dict(point))
    mx.counter(f"{series}_total",
               f"{series} scheduler actions").inc(
        event=str(point.get("event", "unknown")))


def sched_events(series: Optional[str] = None) -> list:
    """The scheduler events recorded so far (at most SCHED_EVENT_CAP,
    oldest dropped first), of one series or all."""
    with _SCHED_LOCK:
        return [dict(p) for p in _SCHED
                if series is None or p["series"] == series]


def fault_event(exc: BaseException, *, device: Optional[str] = None,
                key_index: Optional[int] = None,
                stage: str = "device-worker",
                context: Optional[dict] = None) -> dict:
    """A device fault as a structured fleet event: type, message, the
    worker traceback (bounded), and where it happened — instead of the
    old `f"error: {e}"` string that threw the stack away. `context`
    merges extra attribution keys into the event; the envelope keys
    always win."""
    out = dict(context or {})
    out.update({"type": type(exc).__name__,
                "error": str(exc)[:300],
                "stage": stage,
                "device": device,
                "key_index": key_index,
                "traceback": traceback.format_exc()[-FAULT_TB_LIMIT:]})
    return out


def _fault_point(event: dict) -> dict:
    """A fault event as a `fleet_faults` series point: the event's
    own "type" key moves to "fault_type" — the JSONL exporter stamps
    every series line with {"type": "sample"}, and a point key named
    "type" would clobber that envelope (the fleet_shards series
    already uses fault_type for the same reason)."""
    p = {k: v for k, v in event.items() if k != "type"}
    p["fault_type"] = str(event.get("type"))
    return p


def record_fault(event: dict, mx=None, status=None) -> None:
    """Record one structured fault event (usually `fault_event(exc)`)
    that is NOT attached to a per-key shard — checker-level engine
    failures, profiler declines, watchdog stalls. Lands in the
    `fleet_faults` series + `fleet_faults_total` counter and on the
    live RunStatus fault list. No-op when both planes are disabled."""
    mx = mx if mx is not None else _metrics.get_default()
    st = status if status is not None else get_default()
    if mx.enabled:
        mx.counter("fleet_faults_total",
                   "device faults captured by fleet workers").inc(
            device=str(event.get("device") or "host"))
        mx.series("fleet_faults",
                  "structured device fault events").append(
            _fault_point(event))
    if st.enabled:
        st.fault(event)


def record_shard(shard: dict, mx=None, status=None) -> None:
    """Record one per-key shard block into the ambient metrics
    registry (`fleet_shards` series + counters/histogram) and the
    ambient RunStatus. No-op when both are disabled."""
    mx = mx if mx is not None else _metrics.get_default()
    st = status if status is not None else get_default()
    if mx.enabled:
        fault = shard.get("fault")
        point = {k: v for k, v in shard.items() if k != "fault"}
        if fault:
            point["fault_type"] = fault.get("type")
        mx.series("fleet_shards",
                  "per-key shard telemetry of the independent "
                  "fan-out (device, engine, wall, faults)"
                  ).append(point)
        lbl = {"device": shard.get("device", "host"),
               "engine": shard.get("engine", "unknown")}
        mx.counter("fleet_keys_total",
                   "per-key checks completed by the fleet").inc(**lbl)
        mx.histogram("fleet_shard_seconds",
                     "wall seconds per per-key shard check").observe(
            float(shard.get("wall_s") or 0.0), **lbl)
        if fault:
            mx.counter("fleet_faults_total",
                       "device faults captured by fleet workers").inc(
                device=lbl["device"])
            mx.series("fleet_faults",
                      "structured device fault events").append(
                _fault_point(fault))
        if shard.get("engine") == "oracle-fallback":
            mx.counter("fleet_fallbacks_total",
                       "keys re-decided by the host oracle after a "
                       "device decline").inc(device=lbl["device"])
    if st.enabled:
        st.key_done(shard)


# Work-skew past this ratio (busiest vs laziest device wall) makes
# summarize() emit a rebucket_hint — below it, moving keys would churn
# the shape buckets for noise-level gains.
REBUCKET_SKEW_X = 1.2


def rebucket_hint(shards: list) -> Optional[dict]:
    """The scheduling signal a multi-device fan-out consumes: which keys to move from the busiest device to the
    laziest one to flatten the work skew. Greedy smallest-keys-first
    from the busiest device until the two walls would cross; None
    when the fleet is <2 devices or already balanced. NB the gate is
    busiest-vs-LAZIEST wall (the pair a move actually rebalances) at
    REBUCKET_SKEW_X — intentionally sharper than summarize()'s
    `work_skew` (busiest vs MEAN), so a hint can appear while
    work_skew still reads under 1.2. Pure host arithmetic over the
    shard blocks the fan-out already stamps."""
    by_dev: dict = {}
    for s in shards:
        if not isinstance(s, dict):
            continue
        dev = str(s.get("device", "host"))
        by_dev.setdefault(dev, []).append(
            (float(s.get("wall_s") or 0.0), s.get("key_index")))
    if len(by_dev) < 2:
        return None
    walls = {d: sum(w for w, _ in ks) for d, ks in by_dev.items()}
    busiest = max(walls, key=lambda d: walls[d])
    laziest = min(walls, key=lambda d: walls[d])
    w_hi, w_lo = walls[busiest], walls[laziest]
    if w_lo <= 0 and w_hi <= 0:
        return None
    skew_before = round(w_hi / max(w_lo, 1e-9), 3)
    if w_hi <= REBUCKET_SKEW_X * max(w_lo, 1e-9):
        return None
    gap = (w_hi - w_lo) / 2
    moved_keys: list = []
    moved_wall = 0.0
    # smallest keys first: moving a straggler key would just relocate
    # the imbalance; small keys pack the gap tightly. Sort by wall
    # ONLY — ties would otherwise compare key_index, which may be
    # None (summarize tolerates missing fields; so must this)
    for w, ki in sorted(by_dev[busiest], key=lambda t: t[0]):
        if moved_wall + w > gap or ki is None:
            continue
        moved_keys.append(ki)
        moved_wall += w
    if not moved_keys or moved_wall <= 0:
        # nothing movable, or only zero-wall keys fit the gap — a
        # hint that rebalances nothing is noise, not a signal
        return None
    hi_after = w_hi - moved_wall
    lo_after = w_lo + moved_wall
    return {"from": busiest, "to": laziest,
            "keys": moved_keys,
            "wall_s_moved": round(moved_wall, 4),
            "skew_before": skew_before,
            "skew_after_est": round(
                max(hi_after, lo_after) / max(min(hi_after, lo_after),
                                              1e-9), 3)}


def steal_plan(pending: dict, walls: dict,
               skew_x: float = REBUCKET_SKEW_X) -> Optional[dict]:
    """The EXECUTABLE half of `rebucket_hint`: given per-shard PENDING
    work (`{shard: [(est, key), ...]}` — est in whatever work currency
    the caller has, e.g. encoded op counts) and per-shard completed
    walls, decide which not-yet-started keys to move off the busiest
    shard onto the laziest. `rebucket_hint` names completed keys (a
    post-hoc diagnosis); this names movable ones (the live scheduler's
    input — the mesh fan-out and the streamed pool both call it
    between polls).

    Gate: busiest-vs-laziest completed wall past `skew_x`, the same
    trigger `rebucket_hint` uses. Moves the SMALLEST pending keys
    first (moving a straggler key just relocates the imbalance) until
    half the pending-work gap is packed. None when the fleet is <2
    shards, balanced, or the busiest shard has nothing left to give.
    Pure host arithmetic — unit-testable with fabricated queues."""
    if len(walls) < 2:
        return None
    busiest = max(walls, key=lambda d: walls[d])
    laziest = min(walls, key=lambda d: walls[d])
    if busiest == laziest:
        return None
    w_hi, w_lo = float(walls[busiest]), float(walls[laziest])
    if w_lo <= 0:
        # a shard with no completed wall yet is unknown, not lazy —
        # it may be grinding its first (heavy) key, and "rebalancing"
        # onto it would pile work on the actual straggler. Wait for a
        # completion on every shard before trusting the ratio (the
        # mesh scheduler's idle-pull trigger covers genuinely idle
        # shards without wall evidence).
        return None
    if w_hi <= skew_x * w_lo:
        return None
    donor = list(pending.get(busiest) or [])
    if not donor:
        return None
    have = sum(float(e) for e, _ in donor)
    lazy_have = sum(float(e) for e, _ in (pending.get(laziest) or []))
    gap = (have - lazy_have) / 2
    if gap <= 0:
        return None
    moved: list = []
    acc = 0.0
    for est, key in sorted(donor, key=lambda t: float(t[0])):
        if acc >= gap:
            break
        if moved and acc + float(est) > gap:
            # ascending order: every later key overshoots harder —
            # moving past the gap would just relocate the imbalance.
            # (The FIRST key always moves, so a queue of only-big
            # keys still sheds one.)
            break
        moved.append(key)
        acc += float(est)
    if not moved:
        return None
    return {"from": busiest, "to": laziest, "keys": moved,
            "est_moved": round(acc, 4),
            "skew_before": round(w_hi / max(w_lo, 1e-9), 3)}


# Bound on rebucket-hint key lists riding compact surfaces (records,
# findings, status blocks); the full hint stays on the in-memory
# summary.
HINT_MAX_KEYS = 16


def compact_hint(hint, max_keys: int = HINT_MAX_KEYS):
    """A rebucket hint bounded for compact surfaces: long `keys`
    lists truncate-and-count (`keys_omitted`) instead of ballooning
    a record."""
    if not isinstance(hint, dict):
        return None
    out = dict(hint)
    keys = out.get("keys")
    if isinstance(keys, list) and len(keys) > max_keys:
        out["keys"] = keys[:max_keys]
        out["keys_omitted"] = len(keys) - max_keys
    return out


def summarize(shards: list) -> dict:
    """Fleet aggregates over per-key shard blocks: per-device shard
    counts / wall / busy fraction, straggler ratio (max vs median
    shard wall), the work-skew index (busiest vs mean device wall),
    engine mix, fault and fallback counts, and — when the skew says
    keys are worth moving — a `rebucket_hint` block naming which
    keys to move where (the mesh fan-out's scheduling input).
    Tolerates None entries (skipped keys) and missing fields."""
    shards = [s for s in shards if isinstance(s, dict)]
    if not shards:
        return {"keys": 0, "devices": {}, "engines": {},
                "faults": 0, "fallbacks": 0}
    per_dev: dict = {}
    engines: dict = {}
    faults = 0
    fallbacks = 0
    for s in shards:
        dev = str(s.get("device", "host"))
        d = per_dev.setdefault(dev, {"keys": 0, "wall_s": 0.0,
                                     "faults": 0, "fallbacks": 0})
        d["keys"] += 1
        d["wall_s"] += float(s.get("wall_s") or 0.0)
        eng = str(s.get("engine", "unknown"))
        engines[eng] = engines.get(eng, 0) + 1
        if s.get("fault"):
            d["faults"] += 1
            faults += 1
        if eng == "oracle-fallback":
            d["fallbacks"] += 1
            fallbacks += 1
    walls = sorted(float(s.get("wall_s") or 0.0) for s in shards)
    w_median = walls[len(walls) // 2]
    w_max = walls[-1]
    # busy fraction: each device's summed shard wall over the fleet
    # span (first shard start -> last shard end); needs t0 stamps
    t0s = [s["t0"] for s in shards if s.get("t0") is not None]
    span = None
    if t0s:
        ends = [s["t0"] + float(s.get("wall_s") or 0.0)
                for s in shards if s.get("t0") is not None]
        span = max(ends) - min(t0s)
        for d in per_dev.values():
            d["busy_frac"] = (round(min(1.0, d["wall_s"] / span), 4)
                              if span > 0 else 1.0)
    for d in per_dev.values():
        d["wall_s"] = round(d["wall_s"], 4)
    keys_per_dev = [d["keys"] for d in per_dev.values()]
    # work-skew index: busiest device's summed wall over the mean —
    # 1.0 is perfectly balanced; a lockstep mesh pays the busiest
    # device's wall, so (work_skew - 1) is the reclaimable fraction
    dev_walls = [d["wall_s"] for d in per_dev.values()]
    mean_wall = sum(dev_walls) / len(dev_walls)
    work_skew = round(max(dev_walls) / max(mean_wall, 1e-9), 3)
    return {
        "keys": len(shards),
        "device_count": len(per_dev),
        "devices": per_dev,
        "engines": engines,
        "faults": faults,
        "fallbacks": fallbacks,
        "wall_s": {"max": round(w_max, 4),
                   "median": round(w_median, 4),
                   "total": round(sum(walls), 4)},
        # lockstep/batched fleets pay max while a balanced one pays
        # ~median — this ratio IS the straggler cost
        "straggler_ratio": round(w_max / max(w_median, 1e-9), 3),
        "work_skew": work_skew,
        "imbalance": {"max_keys": max(keys_per_dev),
                      "min_keys": min(keys_per_dev),
                      "mean_keys": round(len(shards) / len(per_dev), 2)},
        "rebucket_hint": rebucket_hint(shards),
        "span_s": round(span, 4) if span is not None else None,
    }


class RunStatus:
    """Thread-safe live status of a run: phase, per-device state, key
    frontier/backlog, search progress, faults, stalls, occupancy, ETA.

    Writers call the small record methods (each takes the lock once);
    readers call `snapshot()` for a JSON-safe copy with derived
    fields (elapsed, ETA, rates). All record methods return
    immediately on a disabled instance."""

    def __init__(self, enabled: bool = True, test: Optional[str] = None,
                 progress: Optional[bool] = None):
        self.enabled = enabled
        self.progress = (progress if progress is not None else
                         os.environ.get("JEPSEN_TPU_PROGRESS", "")
                         not in ("", "0"))
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._last_tick = 0.0
        self._d: dict = {
            "schema": 1,
            "active": bool(enabled),
            "test": test,
            "phase": None,
            "started": time.time(),
            "updated": time.time(),
            "keys": {"total": 0, "decided": 0, "live": 0,
                     "failures": 0},
            "devices": {},
            "search": {},
            "faults": [],
            "watchdog": {"stalls": 0, "last_source": None},
            "occupancy": {"active": False, "mode": None,
                          "kernel": None, "platform": None, "K": None,
                          "fill_last": None, "fill_mean": None,
                          "rounds_seen": 0, "rounds_dropped": 0,
                          "lanes": None, "recent": []},
        }

    # -- writers ------------------------------------------------------
    def _touch_locked(self) -> None:
        self._d["updated"] = time.time()

    def _after(self) -> None:
        """The console progress line (outside the lock), throttled."""
        now = time.monotonic()
        if self.progress and now - self._last_tick > 0.5:
            self._last_tick = now
            self._print_progress()

    def phase(self, name: Optional[str]) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._d["phase"] = name
            self._touch_locked()
        self._after()

    def on_span(self, event: str, span) -> None:
        """`trace.Tracer` listener: the phase follows the innermost
        checker phase span (encode / compile / device-round / enrich
        ...)."""
        if not self.enabled:
            return
        if event == "start":
            self.phase(span.name)
        elif event == "end" and span.parent_id is None:
            self.phase(None)

    def begin_keys(self, total: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            k = self._d["keys"]
            k["total"] = int(total)
            k["decided"] = 0
            k["live"] = 0
            k["failures"] = 0
            self._d["keys_started"] = time.time()
            self._keys_t0 = time.monotonic()
            self._touch_locked()
        self._after()

    def device_state(self, device: str, state: str,
                     key_index: Optional[int] = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            d = self._d["devices"].setdefault(
                str(device), {"state": "idle", "keys_done": 0,
                              "last_key": None, "busy_s": 0.0,
                              "faults": 0})
            d["state"] = state
            if key_index is not None:
                d["last_key"] = key_index
            self._touch_locked()
        self._after()

    def key_done(self, shard: dict) -> None:
        """One per-key shard finished (called via record_shard)."""
        if not self.enabled:
            return
        with self._lock:
            k = self._d["keys"]
            # cap at total: the batched vmap path reports decided
            # counts per poll AND per-key shards at assembly
            k["decided"] = (min(k["decided"] + 1, k["total"])
                            if k["total"] else k["decided"] + 1)
            if shard.get("valid?") is False:
                k["failures"] += 1
            d = self._d["devices"].setdefault(
                str(shard.get("device", "host")),
                {"state": "idle", "keys_done": 0, "last_key": None,
                 "busy_s": 0.0, "faults": 0})
            d["keys_done"] += 1
            d["last_key"] = shard.get("key_index")
            d["busy_s"] = round(d["busy_s"]
                                + float(shard.get("wall_s") or 0.0), 4)
            d["state"] = "idle"
            if shard.get("fault"):
                d["faults"] += 1
            self._touch_locked()
        self._after()

    def fault(self, event: dict) -> None:
        if not self.enabled:
            return
        with self._lock:
            faults = self._d["faults"]
            faults.append({k: event.get(k) for k in
                           ("type", "error", "stage", "device",
                            "key_index")})
            del faults[:-STATUS_FAULT_CAP]
            self._touch_locked()
        self._after()

    def stall(self, event: dict) -> None:
        """One watchdog stall detection (watchdog.py feeds this on top
        of the fault it records): the /status panel shows a stalled run
        as stalled, not merely quiet."""
        if not self.enabled:
            return
        with self._lock:
            w = self._d.setdefault("watchdog",
                                   {"stalls": 0, "last_source": None})
            w["stalls"] += 1
            w["last_source"] = event.get("source")
            w["last_age_s"] = event.get("age_s")
            self._touch_locked()
        self._after()

    def search_poll(self, point: dict, search_id=None) -> None:
        """One `wgl_chunks`-shaped poll from the single-search loop:
        frontier/backlog/explored plus the per-poll rate. `search_id`
        identifies WHICH search polled — concurrent searches (streamed
        multi-device workers, raced competition lanes) each diff their
        own cumulative `explored`, never each other's; the displayed
        `search` block is simply the last poll."""
        if not self.enabled:
            return
        with self._lock:
            prev_map = getattr(self, "_search_prev", None)
            if prev_map is None:
                prev_map = self._search_prev = {}
            prev = prev_map.get(search_id)
            p = dict(point)
            if prev is not None and prev.get("explored") is not None \
                    and p.get("explored") is not None:
                delta = p["explored"] - prev["explored"]
                dt = max(float(p.get("poll_s") or 0.0), 1e-9)
                if delta >= 0:
                    p["configs_per_s"] = int(delta / dt)
            prev_map[search_id] = {"explored": p.get("explored")}
            if len(prev_map) > 64:  # bounded: drop the oldest search
                prev_map.pop(next(iter(prev_map)))
            self._d["search"] = p
            self._touch_locked()
        self._after()

    def occupancy_poll(self, block: dict, search_id=None) -> None:
        """One kernel-occupancy update (doc/OBSERVABILITY.md
        "Occupancy & roofline"): the WGL poll loop reports last/mean
        frontier fill plus a window of recent per-round points
        (`recent_rounds`, folded into a bounded `recent` window the
        /occupancy panel renders); the batched fan-out reports a
        per-poll `lanes` summary instead. `search_id` keys the
        recent-rounds bookkeeping, same contract as `search_poll`:
        concurrent searches (streamed workers, raced lanes) each
        accumulate their OWN window — the scalar fields show the
        last poller (as the `search` block does), but its `recent`
        strip is never interleaved with another search's rounds."""
        if not self.enabled:
            return
        with self._lock:
            o = self._d["occupancy"]
            pts = block.pop("recent_rounds", None)
            buf_map = getattr(self, "_occ_recent", None)
            if buf_map is None:
                buf_map = self._occ_recent = {}
            buf = buf_map.setdefault(search_id, [])
            if pts:
                buf.extend(pts)
                del buf[:-120]
            if len(buf_map) > 64:  # bounded: drop the oldest search
                buf_map.pop(next(iter(buf_map)))
            o.update(block)
            o["active"] = True
            o["recent"] = list(buf)
            self._touch_locked()
        self._after()

    def batched_poll(self, *, live: int, decided: int, total: int,
                     frontier_total: int, backlog_total: int,
                     explored_total: int) -> None:
        """One poll of the mesh-batched lockstep search."""
        if not self.enabled:
            return
        with self._lock:
            k = self._d["keys"]
            k["total"] = max(k["total"], int(total))
            k["decided"] = min(int(decided), k["total"])
            k["live"] = int(live)
            if not hasattr(self, "_keys_t0"):
                self._keys_t0 = time.monotonic()
            self._d["search"] = {
                "mode": "batched-vmap",
                "frontier": int(frontier_total),
                "backlog": int(backlog_total),
                "explored": int(explored_total)}
            self._touch_locked()
        self._after()

    def finish(self, valid=None) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._d["phase"] = "done"
            self._d["active"] = False
            if valid is not None:
                self._d["valid?"] = valid
            self._touch_locked()
        if self.progress:
            self._print_progress(final=True)

    # -- readers ------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe copy plus derived fields: elapsed_s, decided-rate
        ETA (extrapolated from the per-key completion rate the
        `wgl_chunks`/`fleet_shards` stream feeds)."""
        with self._lock:
            d = json.loads(json.dumps(self._d, default=str))
            keys_t0 = getattr(self, "_keys_t0", None)
        d["elapsed_s"] = round(time.monotonic() - self._t0, 3)
        k = d["keys"]
        d["eta_s"] = None
        if keys_t0 is not None and k["total"] and k["decided"]:
            spent = max(time.monotonic() - keys_t0, 1e-9)
            rate = k["decided"] / spent
            remaining = max(k["total"] - k["decided"], 0)
            if rate > 0:
                d["eta_s"] = round(remaining / rate, 1)
        return d

    # -- side channels ------------------------------------------------
    def _print_progress(self, final: bool = False) -> None:
        try:
            s = self.snapshot()
            k = s["keys"]
            parts = [f"phase={s.get('phase') or '-'}"]
            if k["total"]:
                parts.append(f"keys {k['decided']}/{k['total']}")
                if k["failures"]:
                    parts.append(f"bad={k['failures']}")
            sr = s.get("search") or {}
            if sr.get("frontier") is not None:
                parts.append(f"frontier={sr['frontier']}")
            if sr.get("backlog"):
                parts.append(f"backlog={sr['backlog']}")
            if sr.get("configs_per_s"):
                parts.append(f"{sr['configs_per_s']} cfg/s")
            if s.get("eta_s") is not None:
                parts.append(f"eta={s['eta_s']}s")
            line = "[jepsen_tpu_torch] " + " ".join(parts)
            end = "\n" if final else ""
            sys.stderr.write("\r" + line.ljust(78)[:120] + end)
            sys.stderr.flush()
        except Exception:  # noqa: BLE001 — progress never kills a run
            pass


NULL_STATUS = RunStatus(enabled=False, progress=False)


# -- ambient default ---------------------------------------------------------
# A plain module global (NOT thread-local), like metrics._default: the
# batched workers / engine threads must see the status the run installed.
_default: RunStatus = (
    RunStatus() if os.environ.get("JEPSEN_TPU_STATUS", "")
    not in ("", "0") else NULL_STATUS)


def get_default() -> RunStatus:
    """The ambient RunStatus — NULL_STATUS unless JEPSEN_TPU_STATUS=1
    was set at import or a caller installed one."""
    return _default


def set_default(status: Optional[RunStatus]) -> RunStatus:
    global _default
    prev = _default
    _default = status if status is not None else NULL_STATUS
    return prev


@contextlib.contextmanager
def use(status: RunStatus) -> Iterator[RunStatus]:
    """Scoped ambient status (restores the previous on exit)."""
    prev = set_default(status)
    try:
        yield status
    finally:
        set_default(prev)
