"""Linearizability checker over the port's device search.

The port of `jepsen_tpu.checker.Linearizable` (reference:
`jepsen/src/jepsen/checker.clj:185-216`, which gates knossos behind
:algorithm). `check(test, history, opts)` strips nemesis ops, runs the
well-formedness gate, dispatches to the chosen engine and truncates the
counterexample diagnostics to 10 entries.

The default algorithm is the reference's `"competition"`: FIFO-queue
models go to the polynomial queue checker first; everything else races
the device search against the host oracle, and the first definitive
verdict wins. Two departures from the reference, both so that a broken
device path cannot hide behind the oracle's verdict:

  * the device is resolved in the caller's thread before the race
    starts, so asking for the card where there is none raises;
  * an exception in either lane stops the race and is raised by
    `check` once both lanes have ended (the reference turns it into an
    "engine-error" lane result).
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Any, Iterable, Optional

from . import fleet, models
from .analysis import history_lint, preflight
from .history import History, strip_nemesis
from .ops import jitlin, queuecheck, wgl, wgl_ref
from .util import resolve_device

ALGORITHMS = ("competition", "cuda-wgl", "wgl", "linear", "queue-poly")
UNKNOWN = "unknown"


def valid_priority(v) -> int:
    """false > unknown > true (checker.clj:29-35)."""
    if v is False:
        return 0
    if v == UNKNOWN or v is None:
        return 1
    return 2


def merge_valid(valids: Iterable) -> Any:
    """Merge a collection of :valid? values, preferring the worst
    (checker.clj:36-50). Empty collection -> True."""
    out = True
    for v in valids:
        if valid_priority(v) < valid_priority(out):
            out = v
    return out


def check_safe(checker, test: dict, history: History,
               opts: Optional[dict] = None) -> dict:
    """Like `checker.check`, but an exception becomes {"valid?":
    "unknown"} with its traceback and a structured fault event
    (checker.clj:74-85)."""
    try:
        return checker.check(test, history, opts or {})
    except Exception as e:  # noqa: BLE001
        ev = fleet.fault_event(e, stage=f"checker/{type(checker).__name__}")
        return {"valid?": UNKNOWN, "error": traceback.format_exc(),
                "fault": {k: ev[k] for k in ("type", "error", "stage")}}


class Linearizable:
    """Linearizability via WGL search.

    algorithm:
      "competition" — race "cuda-wgl" (without diagnostics) and "wgl"
                   on two threads; the first definitive verdict wins
                   and cancels the loser (the result carries "engine");
                   FIFOQueue models go to queue-poly first
      "cuda-wgl" — the lockstep-frontier search with the hand-written
                   CUDA chunk kernels (on `device`, default the card),
                   plus counterexample diagnostics from the oracle on a
                   False verdict
      "wgl"      — the pure-Python DFS with memoization (the oracle)
      "linear"   — JIT linearization with a memoized config cache
      "queue-poly" — polynomial FIFO-queue constraint peeling
    """

    def __init__(self, model: models.Model, algorithm: str = "competition",
                 time_limit: Optional[float] = None, device=None):
        if algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown linearizability algorithm {algorithm!r}")
        self.model = model
        self.algorithm = algorithm
        self.time_limit = time_limit
        self.device = device

    def check(self, test: dict, history: History,
              opts: Optional[dict] = None) -> dict:
        h = strip_nemesis(history)
        algo = self.algorithm
        # a malformed history (double invoke, unmatched completion, clock
        # regression, ...) would silently corrupt the encoded tensors
        bad = history_lint.gate(h, where="checker.linearizable")
        if bad is not None:
            bad["algorithm"] = algo
            return bad
        if algo in ("competition", "queue-poly") and isinstance(
                self.model, models.FIFOQueue):
            # FIFO queues defeat state-space search; the polynomial
            # checker decides 100k-op histories in milliseconds when the
            # history qualifies (distinct values, known dequeue returns)
            try:
                res = queuecheck.check(h)
                res["algorithm"] = algo
                return res
            except queuecheck.QueueUnsupported as e:
                if algo == "queue-poly":
                    return {"valid?": UNKNOWN, "algorithm": algo,
                            "cause": f"queue-poly: {e}"}
        elif algo == "queue-poly":
            return {"valid?": UNKNOWN, "algorithm": algo,
                    "cause": "queue-poly requires a FIFOQueue model, "
                             f"got {type(self.model).__name__}"}
        pf_bad = None
        if algo in ("cuda-wgl", "competition"):
            # Admission preflight (analysis/preflight): plan the device
            # search statically and reject a request it could only find
            # infeasible by running out of memory, before any encode
            # table, kernel build or device byte; after the queue fast
            # path, so a FIFO history the polynomial checker decides
            # never pays the probe. Only "cuda-wgl" (device-only)
            # rejects: in "competition" an infeasible plan scratches the
            # device racer and the host oracle decides alone.
            pf_bad = _preflight(self.model, h, self.device)
            if pf_bad is not None and algo != "competition":
                pf_bad["algorithm"] = algo
                return pf_bad
        if algo == "wgl":
            res = wgl_ref.check(self.model, h, time_limit=self.time_limit)
        elif algo == "linear":
            res = jitlin.check(self.model, h, time_limit=self.time_limit)
        elif algo == "cuda-wgl":
            res = wgl.check_with_diagnostics(
                self.model, h, time_limit=self.time_limit,
                device=self.device)
        elif pf_bad is not None:
            res = wgl_ref.check(self.model, h, time_limit=self.time_limit)
            res["device_cause"] = "preflight"
            res["preflight"] = pf_bad.get("preflight")
        else:
            res = _race_competition(self.model, h, self.time_limit,
                                    device=self.device)
        # Truncate expensive diagnostics (checker.clj:213-216).
        for k in ("final_paths", "configs"):
            if k in res and isinstance(res[k], list):
                res[k] = res[k][:10]
        res["algorithm"] = algo
        return res


def _preflight(model, h: History, device) -> Optional[dict]:
    """`preflight.gate_wgl` on the device the check would run on. A
    device that cannot be resolved (no card) is the engines' error to
    raise, so the gate admits."""
    try:
        dev = resolve_device(device)
    except RuntimeError:
        return None
    return preflight.gate_wgl(model, h, where="checker.linearizable",
                              devices=[dev])


def _race_competition(model, h: History, time_limit: Optional[float],
                      device=None, max_configs: int = 200_000_000,
                      enc=None) -> dict:
    """knossos.competition semantics (the reference's
    `_race_competition`): run the device search and the host oracle
    concurrently; the first definitive verdict wins and cancels the
    loser at its next stop poll. On the CPU with a time limit the two
    would contend for the same cores, so the reference's serial ladder
    runs instead: the oracle on a short slice, the device on most of
    the rest, then the oracle on what is left.

    The device is resolved here, in the caller's thread, so a missing
    card raises before any lane starts; a lane's exception stops the
    other lane and is raised once both have ended. `max_configs` and
    `enc` pass through to the device search."""
    dev = resolve_device(device)

    def run_device(budget, stop=None):
        return wgl.check(model, h, time_limit=budget, stop=stop, device=dev,
                         max_configs=max_configs, enc=enc)

    def enrich_spare(r, t_start):
        """Counterexample enrichment on the budget that is left."""
        spare = (time_limit - (time.monotonic() - t_start)
                 if time_limit is not None else 10.0)
        if spare > 0.1:
            r = wgl.enrich_diagnostics(model, h, r,
                                       time_limit=min(10.0, spare))
        return r

    if dev.type == "cpu" and time_limit is not None:
        t0 = time.monotonic()
        r = wgl_ref.check(model, h, time_limit=min(5.0, time_limit / 6))
        if r.get("valid?") != UNKNOWN:
            r["engine"] = "oracle"
            return r
        left = max(1.0, time_limit - (time.monotonic() - t0))
        r = run_device(left * 0.75)
        if r.get("valid?") != UNKNOWN:
            r["engine"] = "device"
            return enrich_spare(r, t0)
        left = max(1.0, time_limit - (time.monotonic() - t0))
        r = wgl_ref.check(model, h, time_limit=left)
        if r.get("valid?") != UNKNOWN:
            r["engine"] = "oracle"
        return r

    done = threading.Event()       # a verdict or an error: lanes stop
    outcomes: queue.Queue = queue.Queue()
    errors: dict = {}

    def arm(name, fn):
        def run():
            try:
                r = fn()
            except BaseException as e:  # raised by check after the race
                errors[name] = e
                r = {"valid?": UNKNOWN, "cause": "engine-error"}
                done.set()
            outcomes.put((name, r))
            if r.get("valid?") != UNKNOWN:
                done.set()
        # non-daemon: the loser stops at its next stop poll (one device
        # chunk or `wgl_ref.STOP_POLL` oracle configs) and is joined below
        return threading.Thread(target=run, name=f"wgl-{name}")

    t_race0 = time.monotonic()
    threads = [
        arm("device", lambda: run_device(time_limit, stop=done.is_set)),
        arm("oracle", lambda: wgl_ref.check(model, h, time_limit=time_limit,
                                            stop=done.is_set)),
    ]
    for t in threads:
        t.start()
    res: dict = {}
    unknowns: dict = {}
    for _ in threads:              # take the first definitive verdict
        name, r = outcomes.get()
        if r.get("valid?") != UNKNOWN:
            r["engine"] = name
            res = r
            break
        unknowns[name] = r
    else:
        # all unknown: prefer the oracle's cause (it has diagnostics)
        res = unknowns.get("oracle") or unknowns["device"]
    for t in threads:
        t.join()
    for name in ("device", "oracle"):
        if name in errors:
            raise errors[name]
    if res.get("engine") == "device":
        res = enrich_spare(res, t_race0)
    return res


def linearizable(model=None, algorithm: str = "competition",
                 time_limit: Optional[float] = None,
                 device=None) -> Linearizable:
    """A linearizability checker for `model` (default: cas-register)."""
    return Linearizable(model if model is not None
                        else models.cas_register(),
                        algorithm=algorithm, time_limit=time_limit,
                        device=device)
