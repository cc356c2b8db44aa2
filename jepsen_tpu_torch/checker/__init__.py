"""Checkers: history -> results map analysis.

The port of `jepsen_tpu.checker` (reference:
`jepsen/src/jepsen/checker.clj`): the `Checker` protocol
(`check(test, history, opts) -> {"valid?": ...}`, checker.clj:52-67),
`check_safe` (:74-85), `compose` (:87-99) with `merge_valid` priority
false > unknown > true (:29-50), the built-in checkers (stats :166,
linearizable :185, queue :218, set :240, total-queue :628, unique-ids
:689, counter :737, set-full :294, unhandled-exceptions :124,
log-file-pattern :839), the counterexample SVG (`linear_report`) and
the HTML timeline (`timeline`).

`Linearizable` is where the card plugs in. Its default algorithm is the
reference's `"competition"`: FIFO-queue models go to the polynomial
queue checker first; everything else races the device search against
the host oracle, and the first definitive verdict wins. Two departures
from the reference, both so that a broken device path cannot hide
behind the oracle's verdict:

  * the device is resolved in the caller's thread before the race
    starts, so asking for the card where there is none raises;
  * an exception in either lane stops the race and is raised by
    `check` once both lanes have ended (the reference turns it into an
    "engine-error" lane result).

The plot checkers (`latency_graph`, `rate_graph`, `perf`, `clock_plot`)
and the search-progress and occupancy PNGs are not ported: they need
matplotlib.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
import traceback
from typing import Any, Callable, Iterable, Optional

from .. import fleet, models
from .. import ledger as _ledger
from ..analysis import history_lint, preflight
from ..history import History, strip_nemesis
from ..ops import jitlin, queuecheck, wgl, wgl_ref
from ..trace import NULL_TRACER
from ..util import (Multiset, bounded_pmap, integer_interval_set_str,
                    polysort_key, resolve_device)

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


class Checker:
    """Base checker protocol. Subclasses implement check()."""

    def check(self, test: dict, history: History,
              opts: Optional[dict] = None) -> dict:
        raise NotImplementedError

    def __call__(self, test, history, opts=None):
        return self.check(test, history, opts or {})


class FnChecker(Checker):
    def __init__(self, fn: Callable, name: str = "fn-checker"):
        self.fn = fn
        self.name = name

    def check(self, test, history, opts=None):
        return self.fn(test, history, opts or {})


def check_safe(checker: Checker, test: dict, history: History,
               opts: Optional[dict] = None) -> dict:
    """Like `checker.check`, but an exception becomes {"valid?":
    "unknown"} with its traceback, and is recorded as a structured fault
    event (the fleet_faults series and the live status) (checker.clj:
    74-85)."""
    try:
        return checker.check(test, history, opts or {})
    except Exception as e:  # noqa: BLE001
        ev = fleet.fault_event(e, stage=f"checker/{type(checker).__name__}")
        fleet.record_fault(ev)
        return {"valid?": UNKNOWN, "error": traceback.format_exc(),
                "fault": {k: ev[k] for k in ("type", "error", "stage")}}


class Compose(Checker):
    """Map of name -> checker, evaluated in parallel; valid? is the merge
    (checker.clj:87-99)."""

    def __init__(self, checker_map: dict):
        self.checker_map = dict(checker_map)

    def check(self, test, history, opts=None):
        names = list(self.checker_map)
        results = bounded_pmap(
            lambda n: check_safe(self.checker_map[n], test, history, opts),
            names)
        out = dict(zip(names, results))
        return {"valid?": merge_valid(r.get("valid?") for r in results),
                **out}


def compose(checker_map: dict) -> Checker:
    return Compose(checker_map)


class ConcurrencyLimit(Checker):
    """Bound concurrent executions of a memory-hungry checker
    (checker.clj:101-116)."""

    def __init__(self, limit: int, checker: Checker):
        self.sem = threading.Semaphore(limit)
        self.checker = checker

    def check(self, test, history, opts=None):
        with self.sem:
            return self.checker.check(test, history, opts)


def concurrency_limit(limit: int, checker: Checker) -> Checker:
    return ConcurrencyLimit(limit, checker)


class UnbridledOptimism(Checker):
    """Everything is awesoooommmmme! (checker.clj:118-122)"""

    def check(self, test, history, opts=None):
        return {"valid?": True}


def unbridled_optimism() -> Checker:
    return UnbridledOptimism()


noop = unbridled_optimism


class UnhandledExceptions(Checker):
    """Aggregate crashed ops by exception class (checker.clj:124-151)."""

    def check(self, test, history, opts=None):
        groups: dict = {}
        for op in history:
            if op.is_info and (op.error is not None
                               or op.extra.get("exception") is not None):
                cls = op.extra.get("exception") or op.error
                key = cls if isinstance(cls, str) else str(
                    type(cls).__name__
                    if not isinstance(cls, (list, tuple, dict)) else cls)
                groups.setdefault(key, []).append(op)
        if not groups:
            return {"valid?": True}
        exes = sorted(
            ({"class": k, "count": len(v), "example": v[0].to_dict()}
             for k, v in groups.items()),
            key=lambda e: -e["count"])
        return {"valid?": True, "exceptions": exes}


def unhandled_exceptions() -> Checker:
    return UnhandledExceptions()


def _stats_for(ops: list) -> dict:
    ok = sum(1 for o in ops if o.is_ok)
    fail = sum(1 for o in ops if o.is_fail)
    info = sum(1 for o in ops if o.is_info)
    return {"valid?": ok > 0, "count": ok + fail + info,
            "ok-count": ok, "fail-count": fail, "info-count": info}


class Stats(Checker):
    """ok/fail/info counts overall and by :f; valid only if every :f saw an
    ok op (checker.clj:153-183)."""

    def check(self, test, history, opts=None):
        ops = [o for o in history
               if not o.is_invoke and o.process != "nemesis"]
        by_f: dict = {}
        for o in ops:
            by_f.setdefault(o.f, []).append(o)
        groups = {f: _stats_for(v) for f, v in sorted(
            by_f.items(), key=lambda kv: str(kv[0]))}
        out = _stats_for(ops)
        out["by-f"] = groups
        out["valid?"] = merge_valid(g["valid?"] for g in groups.values())
        return out


def stats() -> Checker:
    return Stats()


class Linearizable(Checker):
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

    A False verdict renders `linear.svg` into the test's store directory
    (`linear_report`) and names it in "counterexample-svg".
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
        # a test-map tracer nests the whole analysis under one trace: the
        # root span here parents the engine phase spans (history-lint /
        # preflight / encode / compile / device-round / host-poll /
        # oracle-race / enrich)
        tracer = (test or {}).get("tracer") or NULL_TRACER
        status = fleet.get_default()
        if status.enabled and tracer.sampled:
            tracer.add_listener(status.on_span)
        status.phase(f"check linearizable ({self.algorithm})")
        t0 = time.monotonic()
        res = None
        try:
            with tracer.span("check linearizable",
                             attrs={"algorithm": self.algorithm}):
                res = self._check(test, history, opts, tracer)
            return res
        finally:
            status.phase("analyze")
            if res is not None and (test or {}).get("name") \
                    and "history_key" not in (opts or {}):
                # one run-ledger record per top-level named analysis (a
                # no-op without a ledger); per-key sub-checks (opts
                # carries history_key under a fan-out) would
                # double-count device seconds
                _ledger.record_result(
                    "checker", test["name"], res,
                    wall_s=time.monotonic() - t0,
                    model=type(self.model).__name__,
                    extra={"algorithm": self.algorithm})

    def _check(self, test, history, opts, tracer) -> dict:
        h = strip_nemesis(history)
        algo = self.algorithm
        # a malformed history (double invoke, unmatched completion, clock
        # regression, ...) would silently corrupt the encoded tensors
        with tracer.span("history-lint", attrs={"ops": len(h)}):
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
            with tracer.span("preflight", attrs={"ops": len(h)}):
                pf_bad = _preflight(
                    self.model, h, self.device,
                    ledger_name=((test or {}).get("name")
                                 if "history_key" not in (opts or {})
                                 else None))
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
                device=self.device, tracer=tracer)
        elif pf_bad is not None:
            res = wgl_ref.check(self.model, h, time_limit=self.time_limit)
            res["device_cause"] = "preflight"
            res["preflight"] = pf_bad.get("preflight")
        else:
            res = _race_competition(self.model, h, self.time_limit,
                                    device=self.device, tracer=tracer)
        # Truncate expensive diagnostics (checker.clj:213-216).
        for k in ("final_paths", "configs"):
            if k in res and isinstance(res[k], list):
                res[k] = res[k][:10]
        res["algorithm"] = algo
        if res.get("valid?") is False:
            # render the counterexample (checker.clj:205-212)
            from . import linear_report
            p = linear_report.render_analysis(test, h, res, opts)
            if p:
                res["counterexample-svg"] = p
        return res


def _preflight(model, h: History, device,
               ledger_name: Optional[str] = None) -> Optional[dict]:
    """`preflight.gate_wgl` on the device the check would run on. A
    device that cannot be resolved (no card) is the engines' error to
    raise, so the gate admits."""
    try:
        dev = resolve_device(device)
    except RuntimeError:
        return None
    return preflight.gate_wgl(model, h, where="checker.linearizable",
                              devices=[dev], ledger_name=ledger_name)


def _race_competition(model, h: History, time_limit: Optional[float],
                      device=None, max_configs: int = 200_000_000,
                      enc=None, tracer=None) -> dict:
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
    `enc` pass through to the device search. `tracer` opens an
    "oracle-race" span around the race, and each lane's "engine <name>"
    span adopts it as an explicit parent (span nesting is
    thread-local)."""
    dev = resolve_device(device)
    tracer = tracer if tracer is not None else NULL_TRACER

    def run_device(budget, stop=None):
        return wgl.check(model, h, time_limit=budget, stop=stop, device=dev,
                         max_configs=max_configs, enc=enc, tracer=tracer)

    def enrich_spare(r, t_start):
        """Counterexample enrichment on the budget that is left."""
        spare = (time_limit - (time.monotonic() - t_start)
                 if time_limit is not None else 10.0)
        if spare > 0.1:
            r = wgl.enrich_diagnostics(model, h, r,
                                       time_limit=min(10.0, spare),
                                       tracer=tracer)
        return r

    if dev.type == "cpu" and time_limit is not None:
        with tracer.span("oracle-race", attrs={"mode": "serial-ladder"}):
            t0 = time.monotonic()
            r = wgl_ref.check(model, h,
                              time_limit=min(5.0, time_limit / 6))
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
    outcomes: _queue.Queue = _queue.Queue()
    errors: dict = {}
    race_ctx: dict = {}            # the oracle-race span's context

    def arm(name, fn):
        def run():
            try:
                with tracer.span(f"engine {name}",
                                 parent=race_ctx.get("ctx")):
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
    with tracer.span("oracle-race",
                     attrs={"engines": [t.name for t in threads]}):
        race_ctx["ctx"] = tracer.context()
        for t in threads:
            t.start()
        res: dict = {}
        unknowns: dict = {}
        for _ in threads:          # take the first definitive verdict
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


class QueueChecker(Checker):
    """Every dequeue must come from somewhere: assume every non-failing
    enqueue succeeded and only OK dequeues happened, then fold the model
    over that sequence (checker.clj:218-238). Use with an unordered queue
    model."""

    def __init__(self, model: models.Model):
        self.model = model

    def check(self, test, history, opts=None):
        m = self.model
        for op in history:
            take = (op.is_invoke if op.f == "enqueue"
                    else op.is_ok if op.f == "dequeue" else False)
            if take:
                m = m.step(op)
                if models.is_inconsistent(m):
                    return {"valid?": False, "error": m.msg}
        return {"valid?": True, "final-queue": m}


def queue(model=None) -> Checker:
    if model is None:
        model = models.unordered_queue()
    return QueueChecker(model)


class SetChecker(Checker):
    """Adds followed by a final read: every acknowledged add must be
    present; nothing unexpected may appear (checker.clj:240-291)."""

    def check(self, test, history, opts=None):
        attempts = {o.value for o in history if o.is_invoke and o.f == "add"}
        adds = {o.value for o in history if o.is_ok and o.f == "add"}
        final_read = None
        for o in history:
            if o.is_ok and o.f == "read":
                final_read = o.value
        if final_read is None:
            return {"valid?": UNKNOWN, "error": "set was never read"}
        final = set(final_read)
        ok = final & attempts
        unexpected = final - attempts
        lost = adds - final
        recovered = ok - adds
        return {
            "valid?": not lost and not unexpected,
            "attempt-count": len(attempts),
            "acknowledged-count": len(adds),
            "ok-count": len(ok),
            "lost-count": len(lost),
            "recovered-count": len(recovered),
            "unexpected-count": len(unexpected),
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
        }


def set_checker() -> Checker:
    return SetChecker()


def expand_queue_drain_ops(history: History) -> History:
    """Expand :drain ops (value = list of drained elements) into dequeue
    invoke/ok pairs (checker.clj:594-627). An incomplete drain (:info
    carrying the elements drained before the failure) expands the same
    way, but taints any "lost" verdict (TotalQueue downgrades lost to
    unknown). A crashed drain with no element list raises."""
    out = History()
    for op in history:
        if op.f != "drain":
            out.append(op)
        elif op.is_invoke or op.is_fail:
            continue
        elif op.is_ok or (op.is_info and isinstance(op.value, list)):
            for el in (op.value or []):
                out.append(op.with_(type="invoke", f="dequeue", value=None))
                out.append(op.with_(type="ok", f="dequeue", value=el))
        else:
            raise ValueError(f"can't handle crashed drain op {op!r}")
    return out


class TotalQueue(Checker):
    """What goes in must come out (multiset accounting over
    enqueues/dequeues, checker.clj:628-687)."""

    def check(self, test, history, opts=None):
        # an info drain means the queue was never provably emptied:
        # leftovers are indistinguishable from losses
        incomplete_drain = any(o.f == "drain" and o.is_info
                               and isinstance(o.value, list)
                               for o in history)
        history = expand_queue_drain_ops(history)
        attempts = Multiset(o.value for o in history
                            if o.is_invoke and o.f == "enqueue")
        enqueues = Multiset(o.value for o in history
                            if o.is_ok and o.f == "enqueue")
        dequeues = Multiset(o.value for o in history
                            if o.is_ok and o.f == "dequeue")
        ok = dequeues.intersect(attempts)
        unexpected = Multiset(x for x in dequeues if x not in attempts)
        duplicated = dequeues.minus(attempts).minus(unexpected)
        lost = enqueues.minus(dequeues)
        recovered = ok.minus(enqueues)
        if len(unexpected):
            valid: Any = False
        elif len(lost):
            valid = UNKNOWN if incomplete_drain else False
        else:
            valid = True
        return {
            "valid?": valid,
            "incomplete-drain": incomplete_drain,
            "attempt-count": len(attempts),
            "acknowledged-count": len(enqueues),
            "ok-count": len(ok),
            "unexpected-count": len(unexpected),
            "duplicated-count": len(duplicated),
            "lost-count": len(lost),
            "recovered-count": len(recovered),
            "lost": lost.to_sorted_list(),
            "unexpected": unexpected.to_sorted_list(),
            "duplicated": duplicated.to_sorted_list(),
            "recovered": recovered.to_sorted_list(),
        }


def total_queue() -> Checker:
    return TotalQueue()


class UniqueIds(Checker):
    """A unique-id generator must emit unique ids (checker.clj:689-734)."""

    def check(self, test, history, opts=None):
        attempted = sum(1 for o in history
                        if o.is_invoke and o.f == "generate")
        acks = [o.value for o in history if o.is_ok and o.f == "generate"]
        counts: dict = {}
        for v in acks:
            counts[v] = counts.get(v, 0) + 1
        dups = {k: c for k, c in counts.items() if c > 1}
        rng = [min(acks), max(acks)] if acks else [None, None]
        dup_sample = dict(sorted(dups.items(), key=lambda kv: -kv[1])[:48])
        return {
            "valid?": not dups,
            "attempted-count": attempted,
            "acknowledged-count": len(acks),
            "duplicated-count": len(dups),
            "duplicated": dup_sample,
            "range": rng,
        }


def unique_ids() -> Checker:
    return UniqueIds()


class Counter(Checker):
    """A monotonically increasing counter: each read must land between the
    sum of acknowledged adds (lower) and the sum of attempted adds (upper)
    at that moment (checker.clj:737-795)."""

    def check(self, test, history, opts=None):
        # invocations of ops that completed :fail never happened: both
        # halves are dropped (checker.clj:747-751)
        failed = set()
        for inv, c in history.pairs():
            if c is not None and c.is_fail:
                failed.add(id(inv))
                failed.add(id(c))
        lower = 0
        upper = 0
        pending: dict = {}  # process -> lower bound captured at invoke
        reads: list = []
        for op in history:
            if id(op) in failed or op.process == "nemesis":
                continue
            if op.f == "read":
                if op.is_invoke:
                    pending[op.process] = lower
                elif op.is_ok:
                    lo = pending.pop(op.process, None)
                    if lo is not None:
                        reads.append([lo, op.value, upper])
            elif op.f == "add":
                if op.is_invoke:
                    if not isinstance(op.value, (int, float)) or op.value < 0:
                        raise ValueError(
                            "counter checker assumes non-negative numeric "
                            f"adds, got {op.value!r}")
                    upper += op.value
                elif op.is_ok:
                    lower += op.value
        errors = [r for r in reads if not (r[0] <= r[1] <= r[2])]
        return {"valid?": not errors, "reads": reads, "errors": errors}


def counter() -> Checker:
    return Counter()


# -- set-full (checker.clj:294-592) -----------------------------------------

class _SetFullElement:
    """Per-element timeline state (checker.clj:295-338): when the
    element became known (add completion or first observing read,
    whichever first), the latest read invocation that observed it, and
    the latest read invocation that missed it."""

    __slots__ = ("element", "known", "last_present", "last_absent")

    def __init__(self, element):
        self.element = element
        self.known = None         # completion op that proved existence
        self.last_present = None  # latest read invocation observing it
        self.last_absent = None   # latest read invocation missing it

    def add_ok(self, op):
        if self.known is None:
            self.known = op

    def read_present(self, inv, op):
        if self.known is None:
            self.known = op
        if self.last_present is None or \
                self.last_present.index < inv.index:
            self.last_present = inv

    def read_absent(self, inv, op):
        if self.last_absent is None or \
                self.last_absent.index < inv.index:
            self.last_absent = inv

    def results(self) -> dict:
        """Outcome classification (checker.clj:345-404). stable = some
        read invoked after the last absence observed the element; lost =
        known, then a read invoked after both the add and the last
        presence missed it (an absent read concurrent with the add is
        never-read, not lost)."""
        absent_idx = self.last_absent.index if self.last_absent else -1
        present_idx = self.last_present.index if self.last_present else -1
        stable = self.last_present is not None and \
            absent_idx < present_idx
        lost = bool(self.known is not None and self.last_absent is not None
                    and present_idx < absent_idx
                    and self.known.index < absent_idx)
        known_time = self.known.time if self.known else None
        stable_latency = lost_latency = None
        if stable:
            t = self.last_absent.time + 1 if self.last_absent else 0
            stable_latency = max(0, t - known_time) // 1_000_000
        if lost:
            t = self.last_present.time + 1 if self.last_present else 0
            lost_latency = max(0, t - known_time) // 1_000_000
        return {
            "element": self.element,
            "outcome": ("stable" if stable
                        else "lost" if lost else "never-read"),
            "stable-latency": stable_latency,
            "lost-latency": lost_latency,
            "known": self.known,
            "last-absent": self.last_absent,
        }


def frequency_distribution(points, values) -> Optional[dict]:
    """{quantile: value} at the given 0-1 points (checker.clj:406-420)."""
    s = sorted(values)
    if not s:
        return None
    n = len(s)
    return {p: s[min(n - 1, int(n * p))] for p in points}


class SetFull(Checker):
    """Per-element stable/lost/never-read analysis with latency
    quantiles (checker.clj:462-592). With linearizable=True, stale
    elements (observed only after a delay) are failures too."""

    def __init__(self, linearizable: bool = False):
        self.linearizable = linearizable

    def check(self, test, history, opts=None):
        elements: dict = {}
        reads: dict = {}  # process -> read invocation
        dups: dict = {}   # element -> max multiplicity > 1 in one read
        for op in history:
            # only numeric client processes (checker.clj:545)
            if not isinstance(op.process, int) or \
                    isinstance(op.process, bool):
                continue
            if op.f == "add":
                if op.is_invoke:
                    elements.setdefault(op.value,
                                        _SetFullElement(op.value))
                elif op.is_ok and op.value in elements:
                    elements[op.value].add_ok(op)
            elif op.f == "read":
                if op.is_invoke:
                    reads[op.process] = op
                elif op.is_fail:
                    reads.pop(op.process, None)
                elif op.is_ok:
                    inv = reads.pop(op.process, op)
                    seen: dict = {}
                    for v in (op.value or []):
                        seen[v] = seen.get(v, 0) + 1
                    for v, n in seen.items():
                        if n > 1:
                            dups[v] = max(dups.get(v, 0), n)
                    vs = set(seen)
                    for el, state in elements.items():
                        if el in vs:
                            state.read_present(inv, op)
                        else:
                            state.read_absent(inv, op)
        rs = [elements[k].results() for k in sorted(elements,
                                                    key=polysort_key)]
        outcomes: dict = {}
        for r in rs:
            outcomes.setdefault(r["outcome"], []).append(r)
        stable = outcomes.get("stable", [])
        lost = outcomes.get("lost", [])
        never_read = outcomes.get("never-read", [])
        stale = [r for r in stable if r["stable-latency"] > 0]
        worst_stale = sorted(stale, key=lambda r: -r["stable-latency"])[:8]
        if lost:
            valid = False
        elif not stable:
            valid = UNKNOWN
        elif self.linearizable and stale:
            valid = False
        else:
            valid = True
        out = {
            "valid?": (valid if not dups else False),
            "attempt-count": len(rs),
            "stable-count": len(stable),
            "lost-count": len(lost),
            "lost": sorted((r["element"] for r in lost), key=polysort_key),
            "never-read-count": len(never_read),
            "never-read": sorted((r["element"] for r in never_read),
                                 key=polysort_key),
            "stale-count": len(stale),
            "stale": sorted((r["element"] for r in stale), key=polysort_key),
            "worst-stale": worst_stale,
            "duplicated-count": len(dups),
            "duplicated": dups,
        }
        points = (0, 0.5, 0.95, 0.99, 1)
        sl = frequency_distribution(
            points, [r["stable-latency"] for r in rs
                     if r["stable-latency"] is not None])
        if sl is not None:
            out["stable-latencies"] = sl
        ll = frequency_distribution(
            points, [r["lost-latency"] for r in rs
                     if r["lost-latency"] is not None])
        if ll is not None:
            out["lost-latencies"] = ll
        return out


def set_full(linearizable: bool = False) -> Checker:
    return SetFull(linearizable)


# -- log-file-pattern (checker.clj:839-881) ---------------------------------

class LogFilePattern(Checker):
    """Greps each node's downloaded log file in the store directory for
    a pattern; matches mean invalid."""

    def __init__(self, pattern: str, filename: str):
        import re
        self.pattern = re.compile(pattern)
        self.filename = filename

    def check(self, test, history, opts=None):
        import os

        from .. import store
        matches = []
        for node in (test.get("nodes") or []):
            p = store.path(test, node, self.filename)
            if not os.path.exists(p):
                continue
            try:
                with open(p, errors="replace") as fh:
                    for line in fh:
                        if self.pattern.search(line):
                            matches.append({"node": node,
                                            "line": line.rstrip("\n")})
            except OSError as e:
                return {"valid?": UNKNOWN,
                        "error": f"{type(e).__name__}: {e}"}
        return {"valid?": not matches,
                "count": len(matches),
                "matches": matches}


def log_file_pattern(pattern: str, filename: str) -> Checker:
    return LogFilePattern(pattern, filename)
