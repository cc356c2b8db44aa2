"""Service-level objectives over the checker service.

A jax-free copy of `jepsen_tpu/slo.py`. The service (service.py) stamps
every request's phase walls into `kind="service-request"` ledger
records; this module turns those records into evaluated objectives,
error budgets and multi-window burn-rate alerts.

Objectives are declarative (`Objective`): each one names a per-request
"good" predicate (latency under a threshold, or decided-at-all for
availability) and a target fraction (the SLO level — p50 < 1 s is
"50% of warm requests under 1 s", availability 0.99 is "99% of
requests decided"). Evaluation over ROLLING WINDOWS from the ledger:

  * `good_frac`   fraction of applicable requests that were good
  * `met`         good_frac >= target_frac (None when the window has
                  fewer than `min_events` applicable requests — an
                  empty window abstains, never alarms)
  * `burn_rate`   bad_frac / (1 - target_frac): 1.0 means the window
                  consumed exactly its error budget; >1 is burning
  * budget        over the LONGEST window: allowed bad fraction,
                  fraction of it spent, fraction remaining

A **burn alert** fires when every populated window burns past
`burn_x` (env JEPSEN_TPU_SLO_BURN_X, default 2.0) — the classic
multi-window gate: the short window catches the burn fast, the long
window confirms it is not a blip. Alerts are published as structured
fleet faults (`fleet.record_fault`, stage="slo"), plus an `slo` metrics
series point per objective and one `kind="slo"` ledger record per
evaluation; `/status.json` carries an `slo` block, and the service
sheds new arrivals while an alert burns.

Admission rejections (cause "preflight" / "quota" / "shed") are
excluded from every objective: they are client-shaped 4xx-class
outcomes, not service failures. Thresholds are env-tunable
(`JEPSEN_TPU_SLO_WARM_P50_S` etc., the reference's names).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

from . import fleet
from . import ledger as ledger_mod
from . import metrics as metrics_mod

SCHEMA = 1

# Rolling evaluation windows, seconds, short-to-long (env:
# comma-separated JEPSEN_TPU_SLO_WINDOWS). The defaults are CI-scale
# — a production deployment would run e.g. "300,3600".
DEFAULT_WINDOWS_S = (60.0, 600.0)

# A window with fewer applicable requests than this abstains (met =
# None, no burn contribution): two requests cannot represent a p95.
MIN_EVENTS = 4

# Burn-rate gate: every populated window must burn past this multiple
# of the error budget before the alert fires.
DEFAULT_BURN_X = 2.0

# Admission outcomes that never count against an objective. "shed" is
# the backpressure loop closing: a burn alert sheds new arrivals
# (service.Service), and counting those 503s against availability
# would make the shed itself deepen the burn that caused it.
_ADMISSION_CAUSES = ("preflight", "quota", "malformed-request", "shed")


def burn_threshold() -> float:
    """The multi-window burn gate (env JEPSEN_TPU_SLO_BURN_X) — one
    definition."""
    try:
        return float(os.environ.get("JEPSEN_TPU_SLO_BURN_X",
                                    DEFAULT_BURN_X))
    except ValueError:
        return DEFAULT_BURN_X


def windows_from_env() -> tuple:
    val = os.environ.get("JEPSEN_TPU_SLO_WINDOWS", "")
    if not val:
        return DEFAULT_WINDOWS_S
    try:
        wins = tuple(sorted(float(w) for w in val.split(",") if w))
        return wins or DEFAULT_WINDOWS_S
    except ValueError:
        return DEFAULT_WINDOWS_S


@dataclass(frozen=True)
class Objective:
    """One declarative objective.

    `threshold_s` None makes it an availability objective (good =
    the request DECIDED: verdict True or False, not "unknown");
    otherwise good = the request's latency (`phase` key inside the
    record's `phases` block when set, else the top-level `field`)
    landed under the threshold. `warm_only` restricts the objective
    to warm-hit requests (the ROADMAP p50 target is a WARM target —
    cold compiles are the warm pool's business, not the SLO's).
    `target_frac` is the SLO level: the fraction of applicable
    requests that must be good."""

    name: str
    description: str
    target_frac: float
    threshold_s: Optional[float] = None
    field: str = "wall_s"
    phase: Optional[str] = None
    warm_only: bool = False

    def value(self, rec: dict) -> Optional[float]:
        """The measured latency this objective judges (None for
        availability objectives or records without the field)."""
        if self.threshold_s is None:
            return None
        if self.phase is not None:
            v = (rec.get("phases") or {}).get(self.phase)
        else:
            v = rec.get(self.field)
        return float(v) if isinstance(v, (int, float)) else None

    def good(self, rec: dict) -> Optional[bool]:
        """True/False when the record is applicable, None to exclude
        it from this objective entirely."""
        if rec.get("cause") in _ADMISSION_CAUSES:
            return None
        if self.warm_only and not rec.get("warm_hit"):
            return None
        if self.threshold_s is None:
            v = rec.get("verdict")
            return v is True or v is False
        val = self.value(rec)
        if val is None:
            return None
        return val <= self.threshold_s


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def default_objectives() -> tuple:
    """The ROADMAP item-1 objectives, thresholds env-scaled so the CI
    box can widen them (`JEPSEN_TPU_SLO_WARM_P50_S`,
    `JEPSEN_TPU_SLO_QUEUE_P95_S`, `JEPSEN_TPU_SLO_AVAILABILITY`)."""
    return (
        Objective(
            name="warm-p50",
            description="warm admission-to-verdict p50 under target",
            target_frac=0.5,
            threshold_s=_env_float("JEPSEN_TPU_SLO_WARM_P50_S", 1.0),
            field="wall_s", warm_only=True),
        Objective(
            name="queue-wait-p95",
            description="queue wait p95 under target",
            target_frac=0.95,
            threshold_s=_env_float("JEPSEN_TPU_SLO_QUEUE_P95_S", 0.5),
            phase="queue_wait_s"),
        Objective(
            name="availability",
            description="fraction of requests decided (not unknown)",
            target_frac=_env_float("JEPSEN_TPU_SLO_AVAILABILITY",
                                   0.99)),
    )


def _percentile(vals: list, p: float) -> Optional[float]:
    if not vals:
        return None
    vals = sorted(vals)
    return round(vals[min(len(vals) - 1,
                          int(p * (len(vals) - 1) + 0.5))], 6)


class Engine:
    """Evaluate objectives over rolling ledger windows and publish
    the results into the telemetry planes."""

    def __init__(self, ledger: Optional[ledger_mod.Ledger] = None,
                 objectives: Optional[tuple] = None,
                 windows_s: Optional[tuple] = None,
                 burn_x: Optional[float] = None,
                 min_events: int = MIN_EVENTS):
        self.ledger = ledger
        self.objectives = tuple(objectives if objectives is not None
                                else default_objectives())
        self.windows_s = tuple(sorted(windows_s if windows_s
                                      is not None
                                      else windows_from_env()))
        self.burn_x = burn_x if burn_x is not None else burn_threshold()
        self.min_events = int(min_events)

    def records(self, now: Optional[float] = None) -> list:
        """The service-request records inside the longest window."""
        led = self.ledger if self.ledger is not None \
            else ledger_mod.get_default()
        now = now if now is not None else time.time()
        try:
            return led.query(kind="service-request",
                             since=now - max(self.windows_s))
        except Exception:  # noqa: BLE001 — a torn ledger evaluates
            return []      # as "no data", never a crashed engine

    def evaluate(self, now: Optional[float] = None,
                 records: Optional[list] = None) -> dict:
        """One evaluation report over the rolling windows. Pure host
        arithmetic over already-recorded records — unit-testable with
        fabricated ones."""
        now = now if now is not None else time.time()
        recs = records if records is not None else self.records(now)
        long_w = max(self.windows_s)
        objectives: list = []
        alerts: list = []
        for obj in self.objectives:
            wins: list = []
            populated: list = []
            for w in self.windows_s:
                in_w = [r for r in recs
                        if isinstance(r.get("t"), (int, float))
                        and r["t"] >= now - w]
                goods: list = []
                vals: list = []
                for r in in_w:
                    g = obj.good(r)
                    if g is None:
                        continue
                    goods.append(g)
                    v = obj.value(r)
                    if v is not None:
                        vals.append(v)
                n = len(goods)
                bad = sum(1 for g in goods if not g)
                allowed = 1.0 - obj.target_frac
                entry: dict = {"window_s": w, "n": n, "bad": bad}
                if n >= self.min_events:
                    good_frac = round(1.0 - bad / n, 4)
                    entry["good_frac"] = good_frac
                    entry["met"] = good_frac >= obj.target_frac
                    entry["burn_rate"] = round(
                        (bad / n) / max(allowed, 1e-9), 3)
                    if obj.threshold_s is not None:
                        entry["observed"] = _percentile(
                            vals, obj.target_frac)
                    else:
                        entry["observed"] = good_frac
                    populated.append(entry)
                else:
                    entry["good_frac"] = None
                    entry["met"] = None
                    entry["burn_rate"] = None
                wins.append(entry)
            longest = wins[-1]
            allowed = 1.0 - obj.target_frac
            # the effective gate caps at the objective's maximum
            # possible burn (1/allowed): a p50 objective tops out at
            # 2x, and "everything is bad" must still alert
            gate = min(self.burn_x,
                       round(1.0 / max(allowed, 1e-9), 3))
            burn_alert = bool(populated) and all(
                e["burn_rate"] >= gate for e in populated)
            spent = (min(10.0, round(longest["burn_rate"], 3))
                     if longest.get("burn_rate") is not None else None)
            row = {
                "name": obj.name,
                "description": obj.description,
                "target_frac": obj.target_frac,
                "threshold_s": obj.threshold_s,
                "warm_only": obj.warm_only,
                "windows": wins,
                "met": longest["met"],
                "burn_alert": burn_alert,
                "budget": {
                    "allowed_frac": round(allowed, 4),
                    # spent/remaining are fractions OF THE BUDGET
                    # (burn_rate over the long window IS the spend
                    # rate; capped so a total outage reads 10x, not
                    # infinity)
                    "spent_frac": spent,
                    "remaining_frac": (max(0.0, round(1.0 - spent, 3))
                                       if spent is not None else None),
                },
            }
            objectives.append(row)
            if burn_alert:
                worst = max(e["burn_rate"] for e in populated)
                alerts.append({
                    "objective": obj.name,
                    "burn_rate": worst,
                    "windows_s": [e["window_s"] for e in populated],
                    "summary": f"{obj.name} burning at {worst}x the "
                               f"error budget across "
                               f"{len(populated)} window(s)"})
        met_vals = [o["met"] for o in objectives]
        return {"schema": SCHEMA, "t": round(now, 3),
                "windows_s": list(self.windows_s),
                "window_s": long_w,
                "burn_x": self.burn_x,
                "requests": len(recs),
                "objectives": objectives,
                "alerts": alerts,
                "met": (None if all(m is None for m in met_vals)
                        else all(m is not False for m in met_vals)
                        and not alerts)}

    def publish(self, report: dict, mx=None, led=None) -> None:
        """Land one evaluation in the telemetry planes: `slo` series
        points + counters, burn alerts as structured fleet faults,
        and one `kind="slo"` ledger record. Never raises — the
        objectives outrank their accounting."""
        global _CHECKED, _ALERTS, _LAST_REPORT
        with _LOCK:
            _CHECKED += 1
            _ALERTS += len(report.get("alerts") or [])
            _LAST_REPORT = report
        try:
            mx = mx if mx is not None else metrics_mod.get_default()
            if mx.enabled:
                series = mx.series(
                    "slo", "objective evaluations of the service "
                           "SLO engine (rolling-window burn rates)")
                for row in report.get("objectives") or []:
                    longest = (row.get("windows") or [{}])[-1]
                    if longest.get("good_frac") is None:
                        continue  # empty window: nothing to plot
                    series.append({
                        "objective": row["name"],
                        "window_s": longest["window_s"],
                        "good_frac": longest["good_frac"],
                        "target_frac": row["target_frac"],
                        "met": bool(longest["met"]),
                        "burn_rate": longest["burn_rate"],
                        "burn_alert": bool(row.get("burn_alert")),
                        "observed": longest.get("observed"),
                        "budget_remaining":
                            (row.get("budget") or {}).get(
                                "remaining_frac")})
                mx.counter("slo_evaluations_total",
                           "SLO engine evaluations").inc()
                for a in report.get("alerts") or []:
                    mx.counter("slo_burn_alerts_total",
                               "multi-window SLO burn alerts").inc(
                        objective=str(a.get("objective")))
        except Exception:  # noqa: BLE001
            pass
        for a in report.get("alerts") or []:
            try:
                fleet.record_fault({
                    "type": "slo-burn",
                    "error": str(a.get("summary")),
                    "stage": "slo", "device": None,
                    "key_index": None}, mx=mx)
            except Exception:  # noqa: BLE001
                pass
        try:
            led = led if led is not None else (
                self.ledger if self.ledger is not None
                else ledger_mod.get_default())
            compact_objs = []
            for row in report.get("objectives") or []:
                longest = (row.get("windows") or [{}])[-1]
                if longest.get("burn_rate") is None:
                    continue
                compact_objs.append({
                    "name": row["name"],
                    "met": bool(longest["met"]),
                    "good_frac": longest["good_frac"],
                    "burn_rate": longest["burn_rate"],
                    "budget_remaining":
                        (row.get("budget") or {}).get(
                            "remaining_frac")})
            alerts = [str(a.get("objective"))
                      for a in report.get("alerts") or []]
            led.record({
                "kind": "slo", "name": "slo-eval",
                "verdict": ("unknown" if report.get("met") is None
                            else bool(report["met"])),
                "windows_s": list(report.get("windows_s") or []),
                "burn_x": report.get("burn_x"),
                "requests": report.get("requests"),
                "objectives": compact_objs,
                "burn_alerts": alerts})
        except Exception:  # noqa: BLE001
            pass

    def evaluate_and_publish(self, now: Optional[float] = None,
                             records: Optional[list] = None,
                             mx=None, led=None) -> dict:
        report = self.evaluate(now=now, records=records)
        self.publish(report, mx=mx, led=led)
        return report


# -- in-process evaluation history for /status.json --------------------------
# (the preflight snapshot pattern: the serving process answers
# its own slo block; a mirror from another process keeps its own)
_LOCK = threading.Lock()
_CHECKED = 0
_ALERTS = 0
_LAST_REPORT: Optional[dict] = None


def compact_report(report: dict) -> Optional[dict]:
    """The bounded projection of one evaluation that rides
    /status.json."""
    if not isinstance(report, dict):
        return None
    objs = []
    for row in report.get("objectives") or []:
        longest = (row.get("windows") or [{}])[-1]
        objs.append({
            "name": row.get("name"),
            "target_frac": row.get("target_frac"),
            "threshold_s": row.get("threshold_s"),
            "window_s": longest.get("window_s"),
            "n": longest.get("n"),
            "good_frac": longest.get("good_frac"),
            "observed": longest.get("observed"),
            "met": longest.get("met"),
            "burn_rate": longest.get("burn_rate"),
            "burn_alert": bool(row.get("burn_alert")),
            "budget_remaining":
                (row.get("budget") or {}).get("remaining_frac")})
    return {"t": report.get("t"), "met": report.get("met"),
            "requests": report.get("requests"),
            "objectives": objs,
            "alerts": [{"objective": a.get("objective"),
                        "burn_rate": a.get("burn_rate")}
                       for a in report.get("alerts") or []]}


def snapshot() -> dict:
    """The `/status.json` `slo` block: evaluations run in this
    process, alert totals, and the last evaluation compactly."""
    with _LOCK:
        checked = _CHECKED
        alerts = _ALERTS
        last = _LAST_REPORT
    return {"checked": checked,
            "alerts_total": alerts,
            "burning": [a.get("objective")
                        for a in (last or {}).get("alerts") or []],
            "last": compact_report(last) if last else None}


def last_report() -> Optional[dict]:
    with _LOCK:
        return _LAST_REPORT


def _reset() -> None:
    """Test isolation: clear the in-process evaluation history."""
    global _CHECKED, _ALERTS, _LAST_REPORT
    with _LOCK:
        _CHECKED = 0
        _ALERTS = 0
        _LAST_REPORT = None


def evaluate_store(store_root: str, **kw) -> dict:
    """One-shot evaluation over a store's ledger (an
    out-of-process reader's path) — read-only: no series
    points, no fleet faults, no ledger record."""
    return Engine(ledger_mod.Ledger(store_root), **kw).evaluate()
