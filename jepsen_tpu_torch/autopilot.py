"""Autopilot: a verify-or-revert control loop over the doctor's remedies.

The port of `jepsen_tpu/autopilot.py`. A supervisor thread polls the
doctor and SLO snapshots at the existing cadences and maps findings to
actuators through a frozen rule->action **policy table**:

  D001 compile-storm   -> warm-bucket   aot.precompile_service_bucket
                                        the offending canonical bucket
                                        (one `wgl32_chunk`, or
                                        `wgln_chunk` for a wide bucket,
                                        at every ladder K on the
                                        service's device)
  D002 fill-collapse   -> pin-ladder    force a ladder rebucket via
  D003 ladder-thrash   -> pin-ladder    ops/adapt.pin_ladder (the
                                        recorded adapt hint)
  D005 straggler-skew  -> apply-steal   apply the finding's attached
                                        steal/rebucket plan
  D012 queue-backlog   -> resize-pool   grow the worker pool (warm
                                        backlog) or tighten admission
                                        (cold backlog)
  burn (SLO budget)    -> pre-shed      open the shed window BEFORE
                                        the error budget empties

Every action runs under a **verify-or-revert contract**: the decision
and the application are banked as `kind="autopilot-action"` ledger
records (rule, compact finding evidence, action, params, the baseline
metric window), a verify deadline is armed, and the next pass must
show the targeted metric improved past the rule's threshold — else
the action is rolled back (the rollback is banked too) and the rule
is **quarantined for the run**: quarantine state rides `/status.json`,
and further firings are recorded as `suppressed`, never silently
retried. Failed actuator applications (a precompile raises, the steal
target vanished, a pool resize is rejected) land as structured
`fleet.record_fault(stage="autopilot")` events — the doctor can
diagnose its own supervisor.

Surfacing:

  * an `autopilot` metrics series — one point per lifecycle event
    (decision / apply / verify / revert / suppress) with the metric
    value before/after — plus `autopilot_events_total` counters and
    one `kind="autopilot-action"` ledger record per event;
  * an `autopilot` block on `/status.json` (idle stub
    `{"active": false}`);
  * Perfetto instant markers in their own "autopilot actions" lane
    (`perfetto_instants` -> `trace.to_perfetto`'s `instants=`);
  * `python -m jepsen_tpu_torch autopilot <run_id|latest|bench>` —
    offline replay of what the policy WOULD have done against any
    recorded run (pure decide step, no actuators, read-only).

Architecture: the `Supervisor` talks to a `Host` adapter — diagnose /
slo_report / probe(metric) / actuate(rule, finding) — so the policy
lifecycle is unit-testable against fabricated hosts, while
`ServiceHost` binds it to a live `service.Service`. The supervisor's
lock is `lockwatch.lock("autopilot")`: a plain `threading.Lock` unless
JEPSEN_TPU_LOCKWATCH is set, then the lock-order witness
(`analysis/lockwatch.py`), as the service's is.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from . import fleet
from . import ledger as ledger_mod
from . import metrics as metrics_mod
from .analysis import lockwatch

SCHEMA = 1

# Lifecycle events, in order. `decision` = a policy rule matched a
# finding; `apply` = the actuator ran (baseline banked, deadline
# armed); `verify` = the metric improved past the threshold;
# `revert` = it did not (or the actuator failed) — rolled back and
# quarantined; `suppress` = a quarantined rule fired again.
EVENTS = ("decision", "apply", "verify", "revert", "suppress")

# The Perfetto lane autopilot markers render in (trace.instant_events
# groups instants by their `lane` key).
PERFETTO_LANE = "autopilot actions"

# Quarantine persistence: every quarantine/clear banks a
# `kind="autopilot-quarantine"` ledger record, and a fresh Supervisor
# replays them so a rule that failed verification stays quarantined
# across service restarts (a restart must not silently re-arm an
# actuator the last run proved harmful). The escape hatch: set this
# env truthy (or `serve --clear-quarantine`) to start clean — the
# clear itself is banked, never silent.
CLEAR_QUARANTINE_ENV = "JEPSEN_TPU_AUTOPILOT_CLEAR_QUARANTINE"

# Pre-shed trigger: an objective whose error budget has burned down
# to this remaining fraction (or is already burn-alerting) opens the
# shed window before the budget empties.
PRE_SHED_BUDGET_FRAC = 0.5

# ServiceHost probe window: the "before" baseline for windowed
# metrics (recent compiles) looks back this far.
PROBE_WINDOW_S = 60.0

# Bounded in-process history (the snapshot and the Perfetto lane).
HISTORY_CAP = 64


@dataclass(frozen=True)
class PolicyRule:
    """One frozen policy-table row: which finding triggers it, which
    actuator runs, which metric must improve, and by how much.

    `direction` "down" verifies when the probed metric fell to
    `improve_x` of the baseline (or under `abs_ok` absolutely);
    "up" when it rose past `improve_x` times the baseline (or over
    `abs_ok`). An unprobeable after-value NEVER verifies — the
    contract is "show the improvement", not "assume it"."""

    rule: str            # doctor rule id, or "burn" for the SLO gate
    action: str
    metric: str
    direction: str = "down"
    improve_x: float = 0.5
    abs_ok: Optional[float] = None
    description: str = ""

    def improved(self, before, after) -> bool:
        if not isinstance(after, (int, float)):
            return False
        after = float(after)
        if self.direction == "down":
            if self.abs_ok is not None and after <= self.abs_ok:
                return True
            if not isinstance(before, (int, float)):
                return False
            return after <= self.improve_x * float(before)
        if self.abs_ok is not None and after >= self.abs_ok:
            return True
        if not isinstance(before, (int, float)):
            return False
        return after >= self.improve_x * float(before)


# The frozen policy table (the reference's, row for row). Thresholds reference the planes that own them: D005's abs_ok is
# fleet.REBUCKET_SKEW_X (skew back under the steal gate), burn's is
# 1.0 (burning at or under budget). Adding a row is additive;
# changing a row's semantics is a policy change the replay CLI makes
# regression-testable.
POLICY: tuple = (
    PolicyRule(
        rule="D001", action="warm-bucket", metric="recent_compiles",
        direction="down", improve_x=0.5, abs_ok=0.0,
        description="AOT-warm the offending canonical bucket "
                    "(aot.precompile_service_bucket); verified when "
                    "compiles since the action drop to zero"),
    PolicyRule(
        rule="D002", action="pin-ladder", metric="frontier_fill",
        direction="up", improve_x=1.2, abs_ok=0.8,
        description="pin the adaptive ladder to the bucket the "
                    "recorded adapt hint names (ops/adapt.pin_ladder)"
                    "; verified when frontier fill recovers"),
    PolicyRule(
        rule="D003", action="pin-ladder", metric="ladder_switches",
        direction="down", improve_x=0.5, abs_ok=0.0,
        description="pin the thrashing ladder to its widest revisited "
                    "bucket; verified when switches stop"),
    PolicyRule(
        rule="D005", action="apply-steal", metric="work_skew",
        direction="down", improve_x=0.9,
        abs_ok=fleet.REBUCKET_SKEW_X,
        description="apply the finding's attached steal plan; "
                    "verified when work skew falls back under the "
                    "steal gate"),
    PolicyRule(
        rule="D012", action="resize-pool", metric="queue_depth",
        direction="down", improve_x=0.5, abs_ok=0.0,
        description="grow the worker pool (warm backlog) or tighten "
                    "admission (cold backlog); verified when the "
                    "queue drains"),
    PolicyRule(
        rule="burn", action="pre-shed", metric="burn_rate",
        direction="down", improve_x=0.9, abs_ok=1.0,
        description="open the admission shed window before the SLO "
                    "error budget empties; verified when the burn "
                    "rate falls back to budget"),
)


def policy_rows(policy: tuple = POLICY) -> list:
    """The policy table as plain dicts (the snapshot's `policy` key and
    the replay CLI's JSON)."""
    return [{"rule": e.rule, "action": e.action, "metric": e.metric,
             "direction": e.direction, "improve_x": e.improve_x,
             "abs_ok": e.abs_ok, "description": e.description}
            for e in policy]


def burn_finding(slo_report) -> Optional[dict]:
    """The synthetic "burn" trigger from an SLO evaluation: fires
    when any objective is burn-alerting OR its error budget has
    drained to PRE_SHED_BUDGET_FRAC — the pre-shed acts before the
    multi-window alert would force the service's own shed."""
    if not isinstance(slo_report, dict):
        return None
    hot: list = []
    rates: list = []
    for row in slo_report.get("objectives") or []:
        budget = row.get("budget") or {}
        rem = budget.get("remaining_frac")
        draining = (isinstance(rem, (int, float))
                    and rem <= PRE_SHED_BUDGET_FRAC)
        if row.get("burn_alert") or draining:
            hot.append(str(row.get("name")))
            longest = (row.get("windows") or [{}])[-1]
            if isinstance(longest.get("burn_rate"), (int, float)):
                rates.append(longest["burn_rate"])
    if not hot:
        return None
    return {"rule": "burn", "name": "error-budget-burn",
            "severity": "warn",
            "summary": f"error budget draining on {', '.join(hot)} "
                       f"— shed before it empties",
            "subject": ",".join(hot),
            "evidence": [{"series": "slo", "field": "burn_rate",
                          "indices": list(range(len(rates))),
                          "values": rates}],
            "action": "open the admission shed window",
            "objectives": hot}


def replay(report, slo_report=None, policy: tuple = POLICY) -> list:
    """What the policy WOULD do against a banked diagnosis: the pure
    decide step — no actuators run, nothing is banked. One decision
    per matched rule (the report's top-ranked finding for that rule),
    in policy-table order. The offline replay CLI and the
    replay-parity tests are built on this."""
    findings: dict = {}
    for f in (report or {}).get("findings") or []:
        findings.setdefault(f.get("rule"), f)
    bf = burn_finding(slo_report)
    if bf is not None:
        findings["burn"] = bf
    out: list = []
    for entry in policy:
        f = findings.get(entry.rule)
        if f is None:
            continue
        out.append({"rule": entry.rule, "action": entry.action,
                    "metric": entry.metric,
                    "severity": f.get("severity"),
                    "subject": f.get("subject"),
                    "summary": f.get("summary"),
                    "description": entry.description})
    return out


# ---------------------------------------------------------------------------
# Host adapters — what the supervisor senses and actuates through
# ---------------------------------------------------------------------------

class Host:
    """The supervisor's world interface. Fabricated hosts make the
    verify-or-revert lifecycle unit-testable; `ServiceHost` binds a
    live Service."""

    name = "host"

    def diagnose(self) -> Optional[dict]:
        """A doctor report (or None when there is nothing to read)."""
        return None

    def slo_report(self) -> Optional[dict]:
        """The latest SLO evaluation (or None)."""
        return None

    def probe(self, metric: str,
              since: Optional[float] = None) -> Optional[float]:
        """The current value of a policy metric. `since` anchors
        windowed metrics (compiles/switches SINCE the action was
        applied); instantaneous metrics ignore it. None = cannot be
        measured right now (which never verifies an action)."""
        return None

    def actuate(self, entry: PolicyRule, finding: dict) -> tuple:
        """Execute one policy action. Returns `(params, rollback)` —
        `params` is the banked parameter dict, `rollback` a no-arg
        callable that undoes the action (None when the action has no
        meaningful inverse). Raises on failure; the supervisor turns
        the raise into a structured autopilot fault + quarantine."""
        raise NotImplementedError


class ServiceHost(Host):
    """Bind the supervisor to a live `service.Service`: diagnoses the
    service's own registry + recent ledger records, reads the SLO
    engine's last evaluation, and actuates through the service's
    warm/pool/shed controls and the ops/adapt ladder pin."""

    name = "service"

    def __init__(self, service, *,
                 probe_window_s: float = PROBE_WINDOW_S):
        self.svc = service
        self.probe_window_s = float(probe_window_s)

    # -- sensing ------------------------------------------------------
    def diagnose(self) -> Optional[dict]:
        from . import doctor
        try:
            recs = self.svc.ledger.query(
                since=time.time() - max(self.probe_window_s, 300.0),
                limit=256)
            view = doctor.view_from_registry(
                self.svc.mx, target="service", records=recs)
            return doctor.diagnose(view)
        except Exception:  # noqa: BLE001 — a torn read is "nothing
            return None    # to act on", never a dead supervisor

    def slo_report(self) -> Optional[dict]:
        from . import slo as slo_mod
        return slo_mod.last_report()

    def probe(self, metric: str,
              since: Optional[float] = None) -> Optional[float]:
        svc = self.svc
        now = time.time()
        if metric == "recent_compiles":
            t0 = since if since is not None \
                else now - self.probe_window_s
            total = 0
            try:
                for rec in svc.ledger.query(since=t0):
                    c = rec.get("compiles")
                    if isinstance(c, int) and not isinstance(c, bool):
                        total += c
            except Exception:  # noqa: BLE001
                return None
            return float(total)
        if metric == "frontier_fill":
            pts = self._series_since("wgl_rounds", since)
            fills = [float(p["fill"]) for p in pts
                     if isinstance(p.get("fill"), (int, float))]
            return (round(sum(fills) / len(fills), 4)
                    if fills else None)
        if metric == "ladder_switches":
            return float(len(self._series_since("wgl_adapt", since)))
        if metric == "work_skew":
            skew = None
            try:
                t0 = since if since is not None \
                    else now - self.probe_window_s
                for rec in svc.ledger.query(since=t0):
                    s = ((rec.get("util") or {}).get("fleet")
                         or {}).get("work_skew")
                    if isinstance(s, (int, float)):
                        skew = float(s)
            except Exception:  # noqa: BLE001
                return None
            return skew
        if metric == "queue_depth":
            with svc._lock:
                return float(sum(len(q)
                                 for q in svc._queues.values()))
        if metric == "burn_rate":
            rep = self.slo_report()
            if not isinstance(rep, dict):
                return None
            rates = []
            for row in rep.get("objectives") or []:
                longest = (row.get("windows") or [{}])[-1]
                if isinstance(longest.get("burn_rate"), (int, float)):
                    rates.append(float(longest["burn_rate"]))
            return max(rates) if rates else None
        return None

    def _series_since(self, name: str, since: Optional[float]) -> list:
        try:
            pts = self.svc.mx.series(name).points
        except Exception:  # noqa: BLE001
            return []
        if since is None:
            return list(pts)
        return [p for p in pts
                if isinstance(p.get("t"), (int, float))
                and p["t"] >= since]

    # -- actuators ----------------------------------------------------
    def actuate(self, entry: PolicyRule, finding: dict) -> tuple:
        if entry.action == "warm-bucket":
            return self._warm_bucket(finding)
        if entry.action == "pin-ladder":
            return self._pin_ladder(entry, finding)
        if entry.action == "apply-steal":
            return self._apply_steal(finding)
        if entry.action == "resize-pool":
            return self._resize_pool(finding)
        if entry.action == "pre-shed":
            return self._pre_shed(finding)
        raise RuntimeError(f"no actuator for {entry.action!r}")

    def _warm_bucket(self, finding: dict) -> tuple:
        """D001: warm the offending canonical bucket through the
        service's own warm path (aot.precompile_service_plan wraps
        precompile_service_bucket: the chunk kernel at every ladder K
        on the service's device) and mark it warm, so every later
        same-bucket request is a warm hit. The revert is honest:
        un-mark the bucket (the service re-warms on its next cold
        batch) — built and loaded kernels stay loaded."""
        svc = self.svc
        subject = str(finding.get("subject") or "")
        with svc._lock:
            runs = list(svc._runs.values())
        req = None
        for r in reversed(runs):  # newest first
            if getattr(r, "bucket", None) is None \
                    or getattr(r, "bucket_key", None) is None:
                continue
            from .service import _key_str
            if subject and subject in (_key_str(r.bucket_key),
                                       str(r.bucket)):
                req = r
                break
            if req is None:
                with svc._lock:
                    cold = r.bucket_key not in svc._warm
                if cold:
                    req = r
        if req is None:
            raise RuntimeError(
                "no live request carries the offending bucket "
                f"(subject {subject!r}) — nothing to precompile")
        if not svc._warm_bucket(req):
            raise RuntimeError(
                f"precompile failed for bucket {req.bucket_key!r}")
        key = req.bucket_key
        with svc._lock:
            svc._warm[key] = {"t": time.time(), "warm_s": 0.0,
                              "autopilot": True}

        def rollback() -> None:
            with svc._lock:
                svc._warm.pop(key, None)

        from .service import _key_str
        return {"bucket": _key_str(key)}, rollback

    def _pin_ladder(self, entry: PolicyRule, finding: dict) -> tuple:
        """D002/D003: force a ladder rebucket via ops/adapt's pin —
        every live Policy switches to the pinned bucket on its next
        poll and holds. The pin target is the recorded adapt hint:
        for thrash, the widest bucket the wgl_adapt evidence visited
        (settle wide, stop the ping-pong); for fill collapse, the
        recommend() bucket for the observed frontier (narrow to the
        wavefront). Rollback = unpin (hysteresis resumes)."""
        from .ops import adapt
        ks: list = []
        for ev in finding.get("evidence") or []:
            for v in ev.get("values") or []:
                if isinstance(v, (int, float)) and not isinstance(
                        v, bool) and v >= 1:
                    ks.append(int(v))
        if finding.get("rule") == "D003":
            k = max(ks) if ks else adapt.LADDER32[-1]
        else:
            pts = self._series_since("wgl_rounds", None)
            fronts = [float(p["frontier"]) for p in pts[-32:]
                      if isinstance(p.get("frontier"), (int, float))]
            occ = (sum(fronts) / len(fronts)) if fronts else 1.0
            k = adapt.recommend(adapt.LADDER32, occ)
        pin = adapt.pin_ladder(
            k, reason=f"autopilot-{finding.get('rule')}")
        return {"k": pin["k"],
                "reason": pin["reason"]}, adapt.unpin_ladder

    def _apply_steal(self, finding: dict) -> tuple:
        """D005: the finding's remedy IS the executable steal plan —
        but a service process has no standing mesh group to hand it
        to (mesh lane groups live inside one check_mesh call, which
        applies fleet.steal_plan itself between polls). Until a fleet
        gives the plan a standing router to land on, this actuator
        reports the vanished target as a structured failure rather
        than pretending."""
        remedy = finding.get("remedy")
        if not isinstance(remedy, dict):
            raise RuntimeError("steal target vanished: the finding "
                               "carries no steal plan")
        raise RuntimeError(
            "steal target vanished: no live mesh group accepts "
            f"a steal plan (plan moved {len(remedy.get('keys') or [])}"
            " key(s))")

    def _resize_pool(self, finding: dict) -> tuple:
        """D012: a WARM backlog (warm-hit rate >= the doctor's split)
        is a capacity problem — grow the worker pool; a COLD one is a
        compile storm arriving through the front door — tighten
        admission (halve max_queue) so preflight/D001 can catch up
        instead of queueing more cold work. Both are reversible."""
        svc = self.svc
        snap = svc.snapshot()
        warm_rate = snap.get("warm_rate")
        from . import doctor
        warm = (warm_rate is None
                or float(warm_rate) >= doctor.QUEUE_WARM_SPLIT)
        if warm:
            from .service import POOL_MAX
            change = svc.resize_workers(min(svc.workers * 2,
                                            POOL_MAX))

            def rollback() -> None:
                svc.resize_workers(change["from"])

            return {"resize": change, "mode": "capacity"}, rollback
        prev_q = svc.max_queue
        svc.max_queue = max(8, prev_q // 2)

        def rollback_q() -> None:
            svc.max_queue = prev_q

        return {"max_queue": {"from": prev_q, "to": svc.max_queue},
                "mode": "tighten-admission"}, rollback_q

    def _pre_shed(self, finding: dict) -> tuple:
        """burn: open the shed window NOW — new arrivals 503 with a
        retry-after while the budget drains, before the multi-window
        alert would have forced the same brake harder and later."""
        svc = self.svc
        burning = finding.get("objectives") or [
            finding.get("subject") or "error-budget"]
        info = svc.open_shed(burning, source="autopilot")
        return {"shed": info}, svc.close_shed


# ---------------------------------------------------------------------------
# Supervisor — the verify-or-revert lifecycle
# ---------------------------------------------------------------------------

class Supervisor:
    """Poll the host, decide from the policy table, apply actuators,
    and hold every action to the verify-or-revert contract. One
    in-flight action per rule; a reverted rule is quarantined for the
    run. Thread-safe; `start()` runs `step()` on a daemon thread at
    `every_s`, or call `step()` directly (the tests do)."""

    def __init__(self, host: Host, *, every_s: float = 5.0,
                 verify_after_s: Optional[float] = None,
                 policy: tuple = POLICY, where: str = "service",
                 mx: Optional[metrics_mod.Registry] = None,
                 ledger: Optional[ledger_mod.Ledger] = None):
        self.host = host
        self.every_s = float(every_s)
        self.verify_after_s = (float(verify_after_s)
                               if verify_after_s is not None
                               else self.every_s)
        self.policy = tuple(policy)
        self.where = str(where)
        self._mx = mx
        self._ledger = ledger
        self._lock = lockwatch.lock("autopilot")
        self._pending: dict = {}      # rule -> in-flight action
        self._quarantine: dict = {}   # rule -> {t, reason, action_id}
        self._history: deque = deque(maxlen=HISTORY_CAP)
        self._counts = {e: 0 for e in EVENTS}
        self._steps = 0
        self._seq = 0
        self._qseq = 0
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._rehydrate_quarantine()

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "Supervisor":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_ev.clear()
            self._thread = threading.Thread(
                target=self._loop, name="autopilot", daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        with self._lock:
            self._thread = None

    @property
    def active(self) -> bool:
        t = self._thread
        return (t is not None and t.is_alive()
                and not self._stop_ev.is_set())

    def _loop(self) -> None:
        while not self._stop_ev.wait(self.every_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — the supervisor
                # crashing silently would be the exact failure mode
                # this plane exists to remove
                try:
                    fleet.record_fault(fleet.fault_event(
                        e, stage="autopilot",
                        context={"rule": None, "action": "step"}),
                        mx=self._registry())
                except Exception:  # noqa: BLE001
                    pass

    # -- one control cycle --------------------------------------------
    def step(self, now: Optional[float] = None) -> dict:
        """One poll cycle: verify/revert every action past its
        deadline, then decide + apply against the fresh doctor/SLO
        findings. Returns a summary (the tests drive this directly)."""
        now = float(now if now is not None else time.time())
        out = {"verified": [], "reverted": [], "applied": [],
               "suppressed": [], "decisions": []}
        self._verify_pending(now, out)
        report = self._safe(self.host.diagnose)
        slo_rep = self._safe(self.host.slo_report)
        findings: dict = {}
        for f in (report or {}).get("findings") or []:
            findings.setdefault(f.get("rule"), f)
        bf = burn_finding(slo_rep)
        if bf is not None:
            findings["burn"] = bf
        for entry in self.policy:
            f = findings.get(entry.rule)
            if f is None:
                continue
            with self._lock:
                quarantined = entry.rule in self._quarantine
                in_flight = entry.rule in self._pending
            if quarantined:
                self._bank("suppress", entry, now, finding=f,
                           reason="quarantined")
                out["suppressed"].append(entry.rule)
                continue
            if in_flight:
                continue  # one action per rule until its verdict
            out["decisions"].append(entry.rule)
            self._decide_and_apply(entry, f, now, out)
        with self._lock:
            self._steps += 1
        return out

    def _verify_pending(self, now: float, out: dict) -> None:
        with self._lock:
            due = [(rule, act) for rule, act in self._pending.items()
                   if now >= act["deadline"]]
        for rule, act in due:
            entry: PolicyRule = act["entry"]
            before = act["baseline"]["value"]
            after = self._safe(self.host.probe, entry.metric,
                               act["t_applied"])
            with self._lock:
                self._pending.pop(rule, None)
            if entry.improved(before, after):
                self._bank("verify", entry, now, finding=act["finding"],
                           params=act["params"], before=before,
                           after=after, verdict="verified",
                           action_id=act["id"])
                out["verified"].append(rule)
                continue
            rolled = "none"
            rb = act.get("rollback")
            if rb is not None:
                try:
                    rb()
                    rolled = "applied"
                except Exception as e:  # noqa: BLE001 — a failed
                    rolled = "failed"   # rollback is itself a fault
                    self._record_actuator_fault(e, entry,
                                                phase="rollback")
            self._quarantine_rule(entry, now, act["id"],
                                  reason="verify-failed")
            self._bank("revert", entry, now, finding=act["finding"],
                       params=act["params"], before=before,
                       after=after, verdict="reverted",
                       reason="verify-failed", rollback=rolled,
                       action_id=act["id"], quarantined=True)
            out["reverted"].append(rule)

    def _decide_and_apply(self, entry: PolicyRule, finding: dict,
                          now: float, out: dict) -> None:
        action_id = self._next_id()
        baseline = self._safe(self.host.probe, entry.metric, None)
        self._bank("decision", entry, now, finding=finding,
                   before=baseline, action_id=action_id)
        try:
            params, rollback = self.host.actuate(entry, finding)
        except Exception as e:  # noqa: BLE001 — a failed actuator is
            # a structured fault + quarantine, never a dead loop
            self._record_actuator_fault(e, entry, phase="apply")
            self._quarantine_rule(entry, now, action_id,
                                  reason=f"apply-failed: "
                                         f"{type(e).__name__}: "
                                         f"{e}"[:200])
            self._bank("revert", entry, now, finding=finding,
                       before=baseline, verdict="reverted",
                       reason=f"apply-failed: {e}"[:200],
                       rollback="none", action_id=action_id,
                       quarantined=True)
            out["reverted"].append(entry.rule)
            return
        act = {"id": action_id, "entry": entry,
               "finding": finding, "params": params or {},
               "rollback": rollback, "t_applied": now,
               "baseline": {"metric": entry.metric,
                            "value": baseline,
                            "window_s": self.verify_after_s},
               "deadline": now + self.verify_after_s}
        with self._lock:
            self._pending[entry.rule] = act
        self._bank("apply", entry, now, finding=finding,
                   params=params or {}, before=baseline,
                   action_id=action_id)
        out["applied"].append(entry.rule)

    # -- plumbing -----------------------------------------------------
    def _safe(self, fn: Callable, *args):
        try:
            return fn(*args)
        except Exception:  # noqa: BLE001 — sensing failures read as
            return None    # "no data"; actuator failures are handled

    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"ap-{self._seq:04d}"

    def _registry(self):
        return (self._mx if self._mx is not None
                else metrics_mod.get_default())

    def _record_actuator_fault(self, exc: BaseException,
                               entry: PolicyRule,
                               phase: str) -> None:
        """Satellite contract: failed applications land as structured
        fleet faults (stage="autopilot") with rule/action attribution
        — the doctor can diagnose its own supervisor."""
        try:
            fleet.record_fault(fleet.fault_event(
                exc, stage="autopilot",
                context={"rule": entry.rule, "action": entry.action,
                         "phase": phase}), mx=self._registry())
        except Exception:  # noqa: BLE001
            pass

    def _quarantine_rule(self, entry: PolicyRule, now: float,
                         action_id: str, reason: str) -> None:
        info = {"t": round(now, 3), "reason": str(reason),
                "action": entry.action, "action_id": action_id}
        with self._lock:
            self._quarantine[entry.rule] = info
        self._bank_quarantine("quarantine", entry.rule, info)

    def _ledger_for_bank(self):
        return (self._ledger if self._ledger is not None
                else ledger_mod.get_default())

    def _bank_quarantine(self, event: str, rule: str,
                         info: Optional[dict] = None) -> None:
        """One `kind="autopilot-quarantine"` ledger record per
        quarantine transition — the durable half of the quarantine
        set. `event` is "quarantine" or "clear"; rehydration replays
        these in time order, the per-process `n` sequence breaking
        same-millisecond ties (record `t` rounds to 1 ms — a
        quarantine and its clear can land inside one tick, and the
        random id suffix must not decide which one "wins" the
        replay). Never raises."""
        try:
            with self._lock:
                self._qseq += 1
                n = self._qseq
            rec = {"kind": "autopilot-quarantine",
                   "name": f"autopilot-{rule}",
                   "event": event, "rule": str(rule),
                   "n": n, "where": self.where}
            if info:
                rec.update({"reason": info.get("reason"),
                            "action": info.get("action"),
                            "action_id": info.get("action_id")})
            self._ledger_for_bank().record(rec)
        except Exception:  # noqa: BLE001 — persistence must never
            pass           # hurt the control loop

    def clear_quarantine(self, rules=None) -> list:
        """Release quarantined rules (all, or the given subset) and
        bank each release — the explicit escape hatch (`serve
        --clear-quarantine` routes here via CLEAR_QUARANTINE_ENV).
        Returns the released rule ids."""
        with self._lock:
            targets = [r for r in (rules if rules is not None
                                   else list(self._quarantine))
                       if r in self._quarantine]
            for r in targets:
                self._quarantine.pop(r, None)
        for r in targets:
            self._bank_quarantine("clear", r)
        return targets

    def _rehydrate_quarantine(self) -> None:
        """Replay the store's `kind="autopilot-quarantine"` records
        (time-ordered: quarantine sets, clear releases) so a restart
        resumes with the quarantine the last run banked. With
        CLEAR_QUARANTINE_ENV truthy the replayed set is discarded AND
        the discard is banked, so the next restart starts clean too.
        Never raises."""
        try:
            led = self._ledger_for_bank()
            recs = led.query(kind="autopilot-quarantine")
        except Exception:  # noqa: BLE001
            return
        # query order is (t, id) — id suffixes are random, so break
        # same-millisecond ties with the banked sequence instead
        # (stable: equal keys keep the query order)
        recs = sorted(recs, key=lambda r: (r.get("t") or 0,
                                           r.get("n") or 0))
        # resume the sequence past everything replayed, so records
        # this process banks (the env-clear discards included) sort
        # after the replayed ones even inside the same millisecond
        with self._lock:
            self._qseq = max([self._qseq]
                             + [r["n"] for r in recs
                                if isinstance(r.get("n"), int)])
        restored: dict = {}
        for rec in recs:
            rule = rec.get("rule")
            if not rule:
                continue
            if rec.get("event") == "clear":
                restored.pop(str(rule), None)
            elif rec.get("event") == "quarantine":
                restored[str(rule)] = {
                    "t": rec.get("t"),
                    "reason": rec.get("reason"),
                    "action": rec.get("action"),
                    "action_id": rec.get("action_id"),
                    "restored": True}
        if not restored:
            return
        if os.environ.get(CLEAR_QUARANTINE_ENV, "").strip() \
                not in ("", "0", "false"):
            for rule in sorted(restored):
                self._bank_quarantine("clear", rule)
            return
        with self._lock:
            for rule, info in restored.items():
                self._quarantine.setdefault(rule, info)

    def _bank(self, event: str, entry: PolicyRule, now: float, *,
              finding: Optional[dict] = None,
              params: Optional[dict] = None,
              before=None, after=None,
              verdict: Optional[str] = None,
              reason: Optional[str] = None,
              rollback: Optional[str] = None,
              action_id: Optional[str] = None,
              quarantined: bool = False) -> None:
        """One lifecycle event into every plane: the `autopilot`
        series + counters, a `kind="autopilot-action"` ledger record,
        the bounded in-process history (snapshot / Perfetto
        lane). Never raises — the control loop outranks its
        accounting."""
        with self._lock:
            self._counts[event] = self._counts.get(event, 0) + 1
            row = {"t": round(now, 3), "id": action_id,
                   "event": event, "rule": entry.rule,
                   "action": entry.action, "metric": entry.metric,
                   "verdict": verdict, "reason": reason,
                   "before": before, "after": after,
                   "subject": (finding or {}).get("subject")}
            self._history.append(row)
        try:
            mx = self._registry()
            if mx.enabled:
                pt = {"event": event, "rule": entry.rule,
                      "action": entry.action, "where": self.where,
                      "metric": entry.metric}
                if isinstance(before, (int, float)):
                    pt["metric_before"] = float(before)
                if isinstance(after, (int, float)):
                    pt["metric_after"] = float(after)
                if verdict:
                    pt["verdict"] = verdict
                if reason:
                    pt["reason"] = str(reason)
                mx.series(
                    "autopilot",
                    "autopilot control-loop lifecycle events "
                    "(decision/apply/verify/revert/suppress)"
                ).append(pt)
                mx.counter(
                    "autopilot_events_total",
                    "autopilot lifecycle events by rule").inc(
                    event=event, rule=entry.rule)
        except Exception:  # noqa: BLE001
            pass
        try:
            led = (self._ledger if self._ledger is not None
                   else ledger_mod.get_default())
            rec = {"kind": "autopilot-action",
                   "name": f"autopilot-{entry.rule}",
                   "event": event, "rule": entry.rule,
                   "action": entry.action, "where": self.where,
                   "metric": entry.metric,
                   "params": dict(params or {}),
                   "action_id": action_id}
            if finding is not None:
                from . import doctor
                rec["finding"] = (doctor.compact_finding(finding)
                                  if finding.get("rule") != "burn"
                                  else {k: finding.get(k) for k in
                                        ("rule", "name", "severity",
                                         "summary", "subject")})
            if event in ("apply", "verify", "revert"):
                rec["baseline"] = {"metric": entry.metric,
                                   "value": before,
                                   "window_s": self.verify_after_s}
            if after is not None:
                rec["metric_after"] = after
            if verdict:
                rec["verdict"] = verdict
            if reason:
                rec["reason"] = str(reason)
            if rollback:
                rec["rollback"] = rollback
            if quarantined:
                rec["quarantined"] = True
            led.record(rec)
        except Exception:  # noqa: BLE001
            pass

    # -- surfacing ----------------------------------------------------
    def history(self) -> list:
        with self._lock:
            return list(self._history)

    def quarantined(self) -> dict:
        with self._lock:
            return dict(self._quarantine)

    def snapshot(self) -> dict:
        """The `/status.json` `autopilot` block."""
        with self._lock:
            pending = [{"rule": r, "action": a["entry"].action,
                        "deadline_in_s": round(
                            a["deadline"] - time.time(), 3)}
                       for r, a in self._pending.items()]
            return {"active": self.active, "where": self.where,
                    "steps": self._steps,
                    "every_s": self.every_s,
                    "policy": policy_rows(self.policy),
                    "counts": dict(self._counts),
                    "quarantined": {r: dict(q) for r, q in
                                    self._quarantine.items()},
                    "pending": pending,
                    "actions": list(self._history)[-16:]}

    def perfetto_instants(self, cap: int = 64) -> list:
        """Instant markers for the "autopilot actions" Perfetto lane
        (trace.to_perfetto's `instants=`; trace.instant_events groups
        by the `lane` key)."""
        out: list = []
        for a in self.history():
            out.append({"t": float(a["t"]),
                        "name": f"{a['event']} {a['rule']} "
                                f"{a['action']}"[:80],
                        "lane": PERFETTO_LANE})
            if len(out) >= cap:
                break
        return out


# -- ambient default ---------------------------------------------------------
# The serving process's supervisor answers /status.json's `autopilot`
# block (the service/doctor snapshot pattern); Service.start installs
# it when constructed with autopilot=True.
_default: Optional[Supervisor] = None


def get_default() -> Optional[Supervisor]:
    return _default


def set_default(sup: Optional[Supervisor]) -> Optional[Supervisor]:
    global _default
    prev = _default
    _default = sup
    return prev


def snapshot() -> dict:
    """The module-level `/status.json` `autopilot` block: the default
    supervisor's snapshot, or the explicit idle stub."""
    sup = _default
    if sup is None:
        return {"active": False, "steps": 0, "counts": {},
                "quarantined": {}, "pending": [], "actions": []}
    return sup.snapshot()


def perfetto_instants(cap: int = 64) -> list:
    """The default supervisor's action markers ([] when idle)."""
    sup = _default
    return sup.perfetto_instants(cap=cap) if sup is not None else []


def _reset() -> None:
    """Test isolation: drop the ambient supervisor."""
    set_default(None)


# ---------------------------------------------------------------------------
# CLI — offline policy replay
# ---------------------------------------------------------------------------

def format_replay(decisions: list, report: dict) -> str:
    """The human rendering of one replay (the CLI's non-JSON path)."""
    head = (f"autopilot replay: target={report.get('target')} "
            f"platform={report.get('platform')} — ")
    if not decisions:
        return head + ("nothing to do (no policy rule matches the "
                       "diagnosis)")
    lines = [head + f"{len(decisions)} action(s) would fire"]
    for d in decisions:
        subj = f" @ {d['subject']}" if d.get("subject") else ""
        lines.append(f"  [{d['rule']}] {d['action']}{subj}: "
                     f"{d.get('summary')}")
        lines.append(f"{'':10s}-> verify via {d['metric']} — "
                     f"{d['description']}")
    return "\n".join(lines)


def cli_main(options: dict, arguments: Optional[list] = None) -> int:
    """`python -m jepsen_tpu_torch autopilot <run_id|latest|bench>` —
    replay the frozen policy table against a banked run's diagnosis:
    print what the supervisor WOULD have done (decide step only — no
    actuators, read-only, nothing banked). The store defaults to the
    port's, `<root>/store/torch`."""
    from . import doctor
    from . import slo as slo_mod
    from .bench import STORE_DIR
    target = None
    for a in arguments or []:
        target = a
        break
    target = target or options.get("target") or "latest"
    root = options.get("root") or os.getcwd()
    store_root = options.get("store") or os.path.join(root, STORE_DIR)
    try:
        if target == "bench":
            view = doctor.bench_view(root)
        else:
            view = doctor.run_view(store_root, target)
    except KeyError as e:
        print(f"autopilot: {e.args[0]}")
        return 254
    report = doctor.diagnose(view)
    try:
        slo_rep = slo_mod.evaluate_store(store_root)
    except Exception:  # noqa: BLE001 — no service traffic recorded
        slo_rep = None
    decisions = replay(report, slo_rep)
    if options.get("json"):
        print(json.dumps({"schema": SCHEMA,
                          "target": report.get("target"),
                          "rules_fired": report.get("rules_fired"),
                          "decisions": decisions,
                          "policy": policy_rows()},
                         indent=2, default=str))
    else:
        print(format_replay(decisions, report))
    return 0
