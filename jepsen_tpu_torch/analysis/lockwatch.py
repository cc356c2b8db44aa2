"""Runtime lock-order witness and contention profiler (opt-in).

The port of `jepsen_tpu/analysis/lockwatch.py`, with the same names and
the same zero-cost contract; it writes the `lockwatch` series into the
port's `metrics.get_default()` and its record into the port's `ledger`.

`threadlint` is the static half of the concurrency plane: it reasons
about the lock-acquisition order it can SEE in nested `with` blocks.
This module is the runtime half — the FreeBSD witness(4) idea: observe
the order locks are ACTUALLY taken in, process-wide, and fail the run
the first time two locks are ever taken in both orders (a potential
deadlock that static analysis across call boundaries can miss), while
profiling per-lock hold times and contention for the doctor's D016
lock-contention rule.

Zero-cost contract: with `JEPSEN_TPU_LOCKWATCH` unset, the factories
return **plain** `threading.Lock()` / `threading.RLock()` objects —
there is no wrapper in the lock path at all, not even a truthiness
check. The disabled-mode test proves this by type identity plus the
module event counter staying zero. The variable is read when a lock is
built, so set it before the service (or any other owner) makes its
locks. Enabled (`JEPSEN_TPU_LOCKWATCH=1`), they return a `WatchedLock`
that:

  * times every acquire (wait_s = contention) and hold (hold_s);
  * maintains a per-thread held-lock stack and a process-wide
    acquisition-order graph: acquiring B while holding A adds edge
    A->B; if B->...->A already exists, that is an observed
    **lock-order cycle** — recorded, emitted as a `lockwatch` series
    `event="cycle"` point, and (by default) raised as
    `LockOrderViolation`, an AssertionError, at the acquire site
    (`JEPSEN_TPU_LOCKWATCH_STRICT=0` downgrades to record-only);
  * samples `lockwatch` series points (lock label, event
    acquire/release/cycle, hold_s, wait_s — schema enforced by
    scripts/telemetry_lint.py), throttled per lock so a hot service
    lock does not flood the registry;
  * speaks the `Condition` protocol (`_release_save` /
    `_acquire_restore` / `_is_owned`), so
    `threading.Condition(lockwatch.rlock("service"))` works and
    `Condition.wait` correctly unwinds the witness hold.

`report()` returns the graph + per-lock stats; `bank(ledger)` writes
one `kind="lockwatch"` ledger record (edge list, cycle bool, per-lock
hold/wait p95) that `/status.json` and the doctor read. Reentrant
re-acquires of one RLock add no edges (not a cycle).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

ENV = "JEPSEN_TPU_LOCKWATCH"
STRICT_ENV = "JEPSEN_TPU_LOCKWATCH_STRICT"

# per-lock series sampling floor: a hot lock's acquire/release would
# otherwise emit kHz points; the lockwatch series keeps ~4 Hz per lock
# (cycle events are never throttled)
_SAMPLE_EVERY_S = 0.25
# wait above this counts the acquire as contended (and samples it)
_CONTENDED_S = 0.001
# bounded reservoir per lock for the p95s
_RESERVOIR = 512

# the witness event counter: the disabled-mode test proves zero
# overhead by this staying 0 (no wrapper ever constructed or hit)
_EVENTS = 0

_STATE_LOCK = threading.Lock()
_EDGES: dict = {}       # (outer, inner) -> count
_CYCLES: list = []      # [{"locks": [...], "thread": name}]
_STATS: dict = {}       # label -> _LockStats
_TLS = threading.local()


class LockOrderViolation(AssertionError):
    """Two locks were observed taken in both orders — a potential
    deadlock. Raised at the acquire completing the cycle (strict
    mode, the default when the witness is on)."""


class _LockStats:
    __slots__ = ("acquires", "contended", "waits", "holds",
                 "hold_max", "wait_max", "last_sample")

    def __init__(self):
        self.acquires = 0
        self.contended = 0
        self.waits = deque(maxlen=_RESERVOIR)
        self.holds = deque(maxlen=_RESERVOIR)
        self.hold_max = 0.0
        self.wait_max = 0.0
        self.last_sample = 0.0


def enabled() -> bool:
    return os.environ.get(ENV, "") not in ("", "0")


def strict() -> bool:
    return os.environ.get(STRICT_ENV, "") not in ("0",)


def lock(label: str):
    """A mutex for `label`: plain `threading.Lock()` when the witness
    is off (zero overhead — no wrapper in the path), watched when on."""
    if not enabled():
        return threading.Lock()
    return WatchedLock(threading.Lock(), label)


def rlock(label: str):
    """Reentrant variant of `lock()` (see there)."""
    if not enabled():
        return threading.RLock()
    return WatchedLock(threading.RLock(), label)


# ---------------------------------------------------------------------------
# witness core
# ---------------------------------------------------------------------------

def _held() -> list:
    h = getattr(_TLS, "held", None)
    if h is None:
        h = _TLS.held = []
    return h


def _emit(label: str, event: str, hold_s: float, wait_s: float) -> None:
    try:
        from .. import metrics as _metrics
        mx = _metrics.get_default()
        if mx.enabled:
            mx.series("lockwatch",
                      "witnessed lock acquire/release/cycle samples"
                      ).append({"lock": label, "event": event,
                                "hold_s": round(hold_s, 6),
                                "wait_s": round(wait_s, 6)})
    except Exception:  # noqa: BLE001 — profiling never breaks locking
        pass


def _reachable(graph_from: str, graph_to: str) -> bool:
    """Path graph_from -> ... -> graph_to in _EDGES (caller holds
    _STATE_LOCK)."""
    seen: set = set()
    stack = [graph_from]
    while stack:
        n = stack.pop()
        if n == graph_to:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(b for (a, b) in _EDGES if a == n)
    return False


def _note_acquire(label: str, wait_s: float) -> Optional[dict]:
    """Record one (non-reentrant) acquisition. Returns the cycle dict
    when this acquire closed an order cycle, else None."""
    global _EVENTS
    held = _held()
    for entry in held:
        if entry[0] == label:         # reentrant re-acquire: no edge
            entry[2] += 1
            return None
    cycle = None
    now = time.monotonic()
    with _STATE_LOCK:
        _EVENTS += 1
        st = _STATS.get(label)
        if st is None:
            st = _STATS[label] = _LockStats()
        st.acquires += 1
        st.waits.append(wait_s)
        st.wait_max = max(st.wait_max, wait_s)
        contended = wait_s >= _CONTENDED_S
        if contended:
            st.contended += 1
        for entry in held:
            edge = (entry[0], label)
            if edge not in _EDGES and entry[0] != label \
                    and _reachable(label, entry[0]):
                cycle = {"locks": [label, entry[0]],
                         "edge": list(edge),
                         "thread": threading.current_thread().name}
                _CYCLES.append(cycle)
            _EDGES[edge] = _EDGES.get(edge, 0) + 1
        sample = contended and now - st.last_sample >= _SAMPLE_EVERY_S
        if sample:
            st.last_sample = now
    held.append([label, now, 1])
    if cycle is not None:
        _emit(label, "cycle", 0.0, wait_s)
    elif sample:
        _emit(label, "acquire", 0.0, wait_s)
    return cycle


def _note_release(label: str, full: bool = False) -> None:
    """Record one release (`full` pops every recursion level — the
    Condition `_release_save` path)."""
    global _EVENTS
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] != label:
            continue
        held[i][2] -= 1
        if full:
            held[i][2] = 0
        if held[i][2] > 0:
            return
        _, t0, _n = held.pop(i)
        now = time.monotonic()
        hold_s = now - t0
        with _STATE_LOCK:
            _EVENTS += 1
            st = _STATS.get(label)
            if st is None:
                st = _STATS[label] = _LockStats()
            st.holds.append(hold_s)
            st.hold_max = max(st.hold_max, hold_s)
            sample = now - st.last_sample >= _SAMPLE_EVERY_S
            if sample:
                st.last_sample = now
        if sample:
            _emit(label, "release", hold_s, 0.0)
        return


class WatchedLock:
    """An instrumented Lock/RLock (see module docstring). Only exists
    on the lock path when JEPSEN_TPU_LOCKWATCH is set."""

    __slots__ = ("_inner", "label")

    def __init__(self, inner, label: str):
        self._inner = inner
        self.label = str(label)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = time.monotonic()
        got = self._inner.acquire(blocking, timeout)
        if not got:
            return got
        cycle = _note_acquire(self.label, time.monotonic() - t0)
        if cycle is not None and strict():
            _note_release(self.label)
            self._inner.release()
            raise LockOrderViolation(
                f"lock-order cycle: acquiring {self.label!r} while "
                f"holding {cycle['edge'][0]!r}, but the witness has "
                f"already seen {self.label!r} held before "
                f"{cycle['edge'][0]!r} — two threads on opposite "
                "orders deadlock (set JEPSEN_TPU_LOCKWATCH_STRICT=0 "
                "to record without raising)")
        return got

    def release(self) -> None:
        _note_release(self.label)
        self._inner.release()

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def locked(self) -> bool:
        inner = self._inner
        if hasattr(inner, "locked"):
            return inner.locked()
        return bool(inner._is_owned())

    # -- Condition protocol (threading.Condition(lock) support) -------
    def _release_save(self):
        _note_release(self.label, full=True)
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return inner._release_save()
        inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        t0 = time.monotonic()
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        _note_acquire(self.label, time.monotonic() - t0)

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        # plain Lock: mirror Condition's own probe
        if inner.acquire(False):
            inner.release()
            return False
        return True


# ---------------------------------------------------------------------------
# reporting / banking
# ---------------------------------------------------------------------------

def _p95(samples) -> Optional[float]:
    vals = sorted(samples)
    if not vals:
        return None
    return round(vals[min(len(vals) - 1,
                          int(0.95 * (len(vals) - 1) + 0.5))], 6)


def report() -> dict:
    """The witness state: per-lock stats, the acquisition-order edge
    list, and every observed cycle."""
    with _STATE_LOCK:
        locks = {}
        for label, st in sorted(_STATS.items()):
            locks[label] = {
                "acquires": st.acquires,
                "contended": st.contended,
                "wait_p95_s": _p95(st.waits),
                "wait_max_s": round(st.wait_max, 6),
                "hold_p95_s": _p95(st.holds),
                "hold_max_s": round(st.hold_max, 6),
            }
        return {"enabled": enabled(),
                "locks": locks,
                "edges": sorted([list(e) for e in _EDGES]),
                "cycles": [dict(c) for c in _CYCLES],
                "cycle": bool(_CYCLES)}


def bank(led=None) -> Optional[str]:
    """One `kind="lockwatch"` ledger record of the current witness
    state (schema checked by scripts/telemetry_lint.py). Returns the
    record id (None when the witness is off or the ledger declines)."""
    if not enabled():
        return None
    if led is None:
        from .. import ledger as ledger_mod
        led = ledger_mod.get_default()
    rep = report()
    if not rep["locks"]:
        return None
    try:
        return led.record({
            "kind": "lockwatch",
            "name": f"lockwatch:{os.getpid()}",
            "edges": rep["edges"],
            "cycle": rep["cycle"],
            "cycles": rep["cycles"],
            "locks": rep["locks"]})
    except Exception:  # noqa: BLE001 — witness banking never fails
        return None   # the run


def reset() -> None:
    """Clear the process-wide witness state (tests)."""
    global _EVENTS
    with _STATE_LOCK:
        _EDGES.clear()
        _CYCLES.clear()
        _STATS.clear()
        _EVENTS = 0
    _TLS.held = []


def events() -> int:
    """Witness events recorded so far (the disabled-mode zero-overhead
    proof reads this)."""
    return _EVENTS
