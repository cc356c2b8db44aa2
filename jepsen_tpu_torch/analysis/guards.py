"""Runtime compile and transfer guards for checker runs.

The port of `jepsen_tpu/analysis/guards.py`. A `CompileGuard` wraps any
block of checker work and counts what only the runtime reveals: a
"same-shape" re-check that still builds or loads a kernel, a poll loop
that starts copying per round.

There is no XLA here, so a **compile** is what the port pays the first
time it needs a kernel (`ops/_native.py` reports each through
`note_compile`):

  * a **build**: one `nvcc` run of one kernel source (`build_all`);
  * a **load**: one `ctypes` load of a kernel library (`_load`);
  * a **bind**: an entry point's first binding in the process (`_lib`).

`compiles` is their sum; `builds`, `loads` and `binds` count each.
The lazy load of a kernel's function onto the card at its first launch
(CUDA's lazy module loading) is not counted: it has no host hook, and
shows only as the first launch's wall.

Host<->device transfers are cooperative, as in the reference: the
port's own transfer points (`ops/wgl.py`'s const upload and per-chunk
poll, `elle/tpu.py`'s kernel inputs and outputs) report through
`note_transfer()`.

Budgets are asserted on exit:

    with guards.CompileGuard(max_compiles=0):
        wgl.check(model, history)       # the shape was warmed before
        wgl.check(model, history2)      # nothing built, loaded, bound

raises `BudgetExceeded` (an AssertionError) naming the counts. Zero cost
when no guard is active: the module keeps a plain list of active guards,
and both hooks return at once when it is empty.

Counts are process-global while a guard is active: a `competition`
race's losing thread counts inside whichever guard is active.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# the kinds of compile `note_compile` takes
COMPILE_KINDS = ("build", "load", "bind")

# Active guards (a stack: guards may nest). Plain list: appends and
# removals take the module lock; the hot-path emptiness check doesn't.
_ACTIVE: list = []
_LOCK = threading.Lock()


class BudgetExceeded(AssertionError):
    """A guard's compile/transfer budget was exceeded."""


def note_compile(kind: str, secs: float = 0.0, what: str = "") -> None:
    """Report one build, load or bind (`kind`, one of COMPILE_KINDS)
    that took `secs`. No-op (one truthiness check) when no guard is
    active."""
    if not _ACTIVE:
        return
    for g in list(_ACTIVE):
        g._record_compile(kind, secs, what)


def note_transfer(direction: str, nbytes: int = 0,
                  what: str = "") -> None:
    """Report one host<->device transfer from an instrumented transfer
    point. `direction` is "h2d" or "d2h". No-op (one truthiness check)
    when no guard is active."""
    if not _ACTIVE:
        return
    for g in list(_ACTIVE):
        g._record_transfer(direction, nbytes, what)


class CompileGuard:
    """Context manager counting compiles and transfers, with budget
    asserts on exit (see the module docstring).

    `report()` returns the counts as a plain dict; on exit with budgets
    exceeded (and no in-flight exception) raises BudgetExceeded.
    `transfers` counts the transfers by their reported `what`."""

    def __init__(self, max_compiles: Optional[int] = None,
                 max_d2h: Optional[int] = None,
                 max_h2d: Optional[int] = None,
                 name: str = "compile-guard"):
        self.name = name
        self.max_compiles = max_compiles
        self.max_d2h = max_d2h
        self.max_h2d = max_h2d
        self.compiles = 0
        self.compile_s = 0.0
        self.builds = self.loads = self.binds = 0
        self.d2h = 0
        self.h2d = 0
        self.d2h_bytes = 0
        self.h2d_bytes = 0
        self.transfers: dict = {}
        self.active = False
        self._t0: Optional[float] = None
        self._lock = threading.Lock()

    # -- recording (called from the module hooks) ---------------------
    def _record_compile(self, kind: str, secs: float, _what: str) -> None:
        if kind not in COMPILE_KINDS:
            raise ValueError(f"unknown compile kind {kind!r}")
        with self._lock:
            self.compiles += 1
            self.compile_s += float(secs)
            setattr(self, kind + "s", getattr(self, kind + "s") + 1)

    def _record_transfer(self, direction: str, nbytes: int,
                         what: str) -> None:
        with self._lock:
            if direction == "d2h":
                self.d2h += 1
                self.d2h_bytes += int(nbytes)
            else:
                self.h2d += 1
                self.h2d_bytes += int(nbytes)
            key = f"{direction}:{what}"
            self.transfers[key] = self.transfers.get(key, 0) + 1

    # -- context protocol ---------------------------------------------
    def __enter__(self) -> "CompileGuard":
        self._t0 = time.monotonic()
        self.active = True
        with _LOCK:
            _ACTIVE.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        with _LOCK:
            try:
                _ACTIVE.remove(self)
            except ValueError:
                pass
        self.active = False
        if exc_type is not None:
            return  # don't mask the in-flight exception
        over = self.over_budget()
        if over:
            raise BudgetExceeded(
                f"{self.name}: {'; '.join(over)} — report: "
                f"{self.report()}")

    def over_budget(self) -> list:
        """The list of violated budgets (empty when within budget)."""
        over = []
        if self.max_compiles is not None \
                and self.compiles > self.max_compiles:
            over.append(f"{self.compiles} compiles > budget "
                        f"{self.max_compiles}")
        if self.max_d2h is not None and self.d2h > self.max_d2h:
            over.append(f"{self.d2h} device->host transfers > budget "
                        f"{self.max_d2h}")
        if self.max_h2d is not None and self.h2d > self.max_h2d:
            over.append(f"{self.h2d} host->device transfers > budget "
                        f"{self.max_h2d}")
        return over

    def report(self) -> dict:
        return {
            "name": self.name,
            "compiles": self.compiles,
            "compile_s": round(self.compile_s, 4),
            "builds": self.builds, "loads": self.loads,
            "binds": self.binds,
            "d2h": self.d2h, "d2h_bytes": self.d2h_bytes,
            "h2d": self.h2d, "h2d_bytes": self.h2d_bytes,
            "wall_s": (round(time.monotonic() - self._t0, 4)
                       if self._t0 is not None else None),
            "budgets": {"compiles": self.max_compiles,
                        "d2h": self.max_d2h, "h2d": self.max_h2d},
        }


def assert_no_recompile(name: str = "no-recompile") -> CompileGuard:
    """Sugar for the common budget: a block that must build, load and
    bind nothing (e.g. re-checking a same-shape history)."""
    return CompileGuard(max_compiles=0, name=name)
