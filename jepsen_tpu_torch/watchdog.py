"""Stall watchdog: heartbeat monitoring of the port's device loops.

A copy of `jepsen_tpu/watchdog.py`. Every engine deadlines gracefully
*between* device chunks, but a hang *inside* a chunk (a kernel that
never returns, a wedged driver call) is invisible to those checks: the
poll loop never comes back to look at the clock. Instrumented loops
register a `Source` and `beat()` at their poll boundaries (`ops/wgl.py`
per chunk, `parallel/mesh.py` per poll, `elle/tpu.py` around the closure
call); a monitor thread declares any source whose last beat is older
than `stall_s` **stalled**:

  * the stall is recorded as a structured `fleet` fault
    (stage="watchdog") plus a `watchdog_stalls` metrics series point
    and counter, and surfaces on the live RunStatus;
  * with `escalation="cancel"`, the run is soft-cancelled: cooperating
    loops observe `cancelled()` at their next boundary and return
    `{"valid?": "unknown", "cause": "stalled"}` with their partial
    progress, and `guarded()` stops waiting on the hung thread.

Knobs: `stall_s` (default 30 s, env JEPSEN_TPU_WATCHDOG_STALL_S),
`poll_s` (monitor scan interval, default stall_s/4), `escalation`
("record", the default, or "cancel", env JEPSEN_TPU_WATCHDOG_ESCALATION).
The reference's lock comes from its lock-order instrumentation
(`analysis/lockwatch.py`); the port's is a plain `threading.Lock`.

Zero-cost contract: the module default is a disabled `NULL_WATCHDOG`;
`register()` hands back an inert source and `beat()` returns at once.
JEPSEN_TPU_WATCHDOG=1 enables a real one ambiently (the reference's
switch). `stop()` ends the monitor thread; a caller that installs a
watchdog stops it when done.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Optional

DEFAULT_STALL_S = 30.0

# Heartbeat series sampling floor: beats can arrive at kHz on small
# searches; the watchdog_heartbeats series keeps ~1 Hz per source.
_HEARTBEAT_RECORD_S = 1.0


class Source:
    """One heartbeat stream (a device-round loop, a fleet worker, a
    kernel call). `beat()` goes through the owning Watchdog; consumers
    read `stalled` / `progress` / `stall_event`."""

    __slots__ = ("name", "meta", "t0", "last", "beats", "progress",
                 "stalled", "cancel", "stall_event", "_last_rec",
                 "live", "stall_s", "grace_s")

    def __init__(self, name: str, meta: dict,
                 stall_s: Optional[float] = None,
                 grace_s: float = 0.0):
        self.name = name
        self.meta = meta
        self.t0 = self.last = time.monotonic()
        self.beats = 0
        self.progress: dict = {}
        self.stalled = False
        self.cancel = False
        self.stall_event: Optional[dict] = None
        self._last_rec = 0.0
        self.live = True
        # per-source threshold override (a known-slow healthy call,
        # e.g. the Elle closure at capacity) and a first-beat grace
        # (the first WGL chunk folds in the kernels' nvcc build, which
        # can dwarf a steady-state poll) — both prevent false stalls on
        # healthy slow paths while keeping steady-state detection tight
        self.stall_s = stall_s
        self.grace_s = float(grace_s)


_NULL_SOURCE = Source("null", {})
_NULL_SOURCE.live = False


class Watchdog:
    """Heartbeat registry + monitor thread (see module docstring).
    All recording methods return immediately on a disabled instance."""

    def __init__(self, enabled: bool = True,
                 stall_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 escalation: Optional[str] = None):
        self.enabled = enabled
        self.stall_s = float(
            stall_s if stall_s is not None else os.environ.get(
                "JEPSEN_TPU_WATCHDOG_STALL_S", DEFAULT_STALL_S))
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(0.05, self.stall_s / 4)
        esc = (escalation if escalation is not None else
               os.environ.get("JEPSEN_TPU_WATCHDOG_ESCALATION",
                              "record"))
        if esc not in ("record", "cancel"):
            raise ValueError(f"unknown escalation {esc!r} "
                             "(want 'record' or 'cancel')")
        self.escalation = esc
        self.stalls: list = []
        self._sources: list = []
        self._lock = threading.Lock()
        self._cancel_all = False
        self._cancel_reason: Optional[str] = None
        self._seq = 0
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- source lifecycle ---------------------------------------------
    def register(self, name: str, stall_s: Optional[float] = None,
                 grace_s: float = 0.0, **meta) -> Source:
        """Register a heartbeat source (an inert shared stub when
        disabled). `stall_s` overrides this watchdog's threshold for
        the source; `grace_s` is ADDED to the threshold until the
        first beat (compile headroom). Callers pair with `unregister`
        (or use `watch`)."""
        if not self.enabled:
            return _NULL_SOURCE
        with self._lock:
            self._seq += 1
            src = Source(f"{name}#{self._seq}", meta,
                         stall_s=stall_s, grace_s=grace_s)
            self._sources.append(src)
        self._ensure_monitor()
        return src

    def unregister(self, src: Source) -> None:
        if not self.enabled or src is _NULL_SOURCE:
            return
        src.live = False
        with self._lock:
            if src in self._sources:
                self._sources.remove(src)

    @contextlib.contextmanager
    def watch(self, name: str, **meta) -> Iterator[Source]:
        """Scoped register/unregister."""
        src = self.register(name, **meta)
        try:
            yield src
        finally:
            self.unregister(src)

    # -- the hot path -------------------------------------------------
    def beat(self, src: Source, **progress) -> None:
        """One heartbeat: refreshes the stall clock and merges progress
        counters (what a stalled partial verdict will report). Called
        at poll boundaries — ~Hz, never inside device rounds."""
        if not self.enabled or src is _NULL_SOURCE:
            return
        now = time.monotonic()
        src.last = now
        src.beats += 1
        if src.stalled and not src.cancel:
            # the source recovered (a transient slow poll, not a
            # hang): re-arm detection so a LATER genuine hang is
            # still declared — scan() is idempotent only until the
            # next beat. Cancel-escalated sources stay latched; the
            # run is already winding down.
            src.stalled = False
            src.stall_event = None
        if progress:
            src.progress.update(progress)
        if now - src._last_rec >= _HEARTBEAT_RECORD_S:
            src._last_rec = now
            from . import metrics as _metrics
            mx = _metrics.get_default()
            if mx.enabled:
                mx.series("watchdog_heartbeats",
                          "throttled per-source heartbeat samples"
                          ).append({"source": src.name,
                                    "beats": src.beats,
                                    **{k: v for k, v in
                                       src.progress.items()
                                       if isinstance(v, (int, float))}})

    def cancelled(self, src: Optional[Source] = None) -> bool:
        """Should this loop wind down? True after a run-wide
        soft-cancel or a per-source cancel (escalation='cancel' sets
        it on the stalled source so a woken zombie stops promptly)."""
        if not self.enabled:
            return False
        if self._cancel_all:
            return True
        return bool(src is not None and src is not _NULL_SOURCE
                    and src.cancel)

    def soft_cancel(self, reason: str = "stalled") -> None:
        """Run-wide soft-cancel: every cooperating loop returns a
        partial `{"valid?": "unknown", "cause": "stalled"}` at its
        next boundary."""
        if not self.enabled:
            return
        with self._lock:
            self._cancel_all = True
            self._cancel_reason = reason

    # -- stall detection ----------------------------------------------
    def scan(self, now: Optional[float] = None) -> list:
        """One detection pass over live sources; returns the NEW stall
        events. Idempotent per source until its next beat (a source is
        declared stalled once, not once per scan). The monitor thread
        calls this every `poll_s`; tests call it directly."""
        if not self.enabled:
            return []
        now = time.monotonic() if now is None else now
        with self._lock:
            sources = list(self._sources)
        events = []
        for src in sources:
            age = now - src.last
            limit = (src.stall_s if src.stall_s is not None
                     else self.stall_s)
            if src.beats == 0:
                limit += src.grace_s
            if src.stalled or age <= limit:
                continue
            ev = {"type": "StallDetected",
                  "error": (f"no heartbeat from {src.name} for "
                            f"{age:.1f}s (threshold {limit}s)"),
                  "stage": "watchdog",
                  "device": src.meta.get("device"),
                  "key_index": src.meta.get("key_index"),
                  "source": src.name,
                  "age_s": round(age, 3),
                  "beats": src.beats,
                  "progress": dict(src.progress),
                  "escalation": self.escalation}
            with self._lock:
                # check-and-set under the lock: the monitor thread and
                # a caller's manual scan() must not both declare (and
                # double-record) the same stall — and the cancel flags
                # + stall log mutate under the SAME critical section,
                # so a concurrent soft_cancel()/scan() can neither
                # tear the reason nor double-append the event
                if src.stalled:
                    continue
                src.stalled = True
                if self.escalation == "cancel":
                    # run-wide soft-cancel: healthy loops wind down
                    # with partial verdicts at their next boundary;
                    # only the genuinely hung thread gets abandoned
                    # by its waiter
                    src.cancel = True
                    self._cancel_all = True
                    if self._cancel_reason is None:
                        self._cancel_reason = f"stalled: {src.name}"
                self.stalls.append(ev)
            src.stall_event = ev
            events.append(ev)
            self._publish(ev)
        return events

    def _publish(self, ev: dict) -> None:
        """Fan a stall event out to the observability planes; never
        raises (a broken sink must not break detection)."""
        try:
            from . import fleet as _fleet
            _fleet.record_fault(ev)
            st = _fleet.get_default()
            if st.enabled:
                st.stall(ev)
        except Exception:  # noqa: BLE001
            pass
        try:
            from . import metrics as _metrics
            mx = _metrics.get_default()
            if mx.enabled:
                mx.series("watchdog_stalls",
                          "stalled-source detections").append(
                    {"source": ev["source"], "age_s": ev["age_s"],
                     "beats": ev["beats"],
                     "escalation": ev["escalation"]})
                mx.counter("watchdog_stalls_total",
                           "sources declared stalled").inc(
                    device=str(ev.get("device") or "host"))
        except Exception:  # noqa: BLE001
            pass

    # -- monitor thread -----------------------------------------------
    def _ensure_monitor(self) -> None:
        if self._monitor is not None and self._monitor.is_alive():
            return
        with self._lock:
            if self._monitor is not None and self._monitor.is_alive():
                return
            self._stop.clear()
            t = threading.Thread(target=self._run_monitor,
                                 name="jepsen-tpu-torch-watchdog",
                                 daemon=True)
            self._monitor = t
            t.start()

    def _run_monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.scan()
            except Exception:  # noqa: BLE001 — detection must survive
                pass

    def stop(self) -> None:
        """Stop the monitor thread (sources stay registered; scan()
        still works synchronously)."""
        self._stop.set()
        t = self._monitor
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=self.poll_s + 1.0)


def stall_result(src: Source, op_count: Optional[int] = None,
                 partial: Optional[dict] = None,
                 stall_s: Optional[float] = None) -> dict:
    """The soft-cancel verdict: "unknown" with cause "stalled" and the
    partial progress the source last reported — the anti-"times out
    with nothing to show" contract."""
    out: dict = {"valid?": "unknown", "cause": "stalled",
                 "partial": dict(partial if partial is not None
                                 else src.progress)}
    if op_count is not None:
        out["op_count"] = op_count
    ev = src.stall_event
    out["stall"] = ({k: ev.get(k) for k in
                     ("source", "age_s", "beats", "escalation")}
                    if ev else {"source": src.name, "beats": src.beats})
    if stall_s is not None:
        out["stall"]["stall_s"] = stall_s
    return out


def guarded(fn, *, name: str = "guarded", wd: Optional["Watchdog"] = None,
            join_s: float = 0.05, op_count: Optional[int] = None,
            **meta):
    """Run `fn(source)` under surveillance: fn executes on a daemon
    thread, beating through the handed `Source`; if the watchdog
    declares it stalled and escalation is "cancel", return
    `stall_result` (partial progress included) instead of blocking
    forever on the hung thread. With the NULL watchdog (or
    escalation="record") this degrades to a plain call/join."""
    wd = wd if wd is not None else get_default()
    if not wd.enabled:
        return fn(_NULL_SOURCE)
    with wd.watch(name, **meta) as src:
        box: dict = {}

        def run():
            try:
                box["result"] = fn(src)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["error"] = e

        th = threading.Thread(target=run, daemon=True,
                              name=f"watchdog-{name}")
        th.start()
        while th.is_alive():
            th.join(join_s)
            if not th.is_alive():
                break
            wd.scan()
            if src.stalled and wd.escalation == "cancel":
                # abandon the hung daemon thread; it observes
                # src.cancel if it ever wakes
                return stall_result(src, op_count=op_count,
                                    stall_s=wd.stall_s)
        if "error" in box:
            raise box["error"]
        return box.get("result")


NULL_WATCHDOG = Watchdog(enabled=False)


# Ambient default — a plain module global (NOT thread-local), like
# metrics and fleet: engine threads and fleet workers must see the
# watchdog the run installed.
_default: Watchdog = (
    Watchdog() if os.environ.get("JEPSEN_TPU_WATCHDOG", "")
    not in ("", "0") else NULL_WATCHDOG)


def get_default() -> Watchdog:
    """The ambient Watchdog — NULL_WATCHDOG unless JEPSEN_TPU_WATCHDOG
    was set at import or a caller installed one."""
    return _default


def set_default(wd: Optional[Watchdog]) -> Watchdog:
    global _default
    prev = _default
    _default = wd if wd is not None else NULL_WATCHDOG
    return prev


@contextlib.contextmanager
def use(wd: Watchdog) -> Iterator[Watchdog]:
    """Scoped ambient watchdog (restores the previous on exit)."""
    prev = set_default(wd)
    try:
        yield wd
    finally:
        set_default(prev)
