"""Doctor: cross-plane telemetry correlation and automated run diagnosis.

A copy of `jepsen_tpu/doctor.py`. The recording planes (metrics and
trace, `fleet.RunStatus`, the run ledger, occupancy, preflight
admission, the device monitor) say *that* a run got slower;
`bench.compute_regressions` flags it. The doctor says *why*:

  * a rule catalog over the recorded series and ledger records; each
    rule correlates planes (D001 joins CompileGuard counts against
    preflight's planned buckets; D005 joins `fleet_shards` walls into
    `fleet.summarize`'s rebucket hint) and emits ranked findings: rule
    id, severity, the evidence points (series name, indices, values)
    and a suggested action;
  * a `TelemetryView` that reads already-recorded artifacts only: an
    in-memory metrics registry, exported `*_metrics.jsonl` /
    `*_trace.jsonl` files, ledger records. Nothing runs on a device;
  * surfacing: `python -m jepsen_tpu_torch doctor <run_id|latest|bench>`
    (`--json`, `--strict`, `--watch`), a `doctor` block on
    `/status.json` and `/runs/<id>.json`, Perfetto instant events on the
    offending rounds (`perfetto_instants` -> `trace.to_perfetto`'s
    `instants=`), and a `doctor` metrics series and `kind="doctor"`
    ledger records;
  * `bench.py` runs the doctor over every round and prints the top
    finding on the compact line whenever `compute_regressions` flags
    the round.

Rule catalog (the reference's; the strings of every finding are its
own, so the two packages' reports compare equal, except D001's action,
which names the shared-bucket fix by what it does):

  D001 compile-storm           compiles >> planned shape buckets
  D002 fill-collapse           frontier fill far below
                               occupancy.TARGET_FILL
  D003 ladder-thrash           adaptive ladder oscillating between
                               buckets (`wgl_adapt` / util.adapt)
  D004 hbm-drift               measured device-memory peak outside
                               devices.HBM_DRIFT_X of the prediction
  D005 straggler-skew          device work skew past
                               fleet.REBUCKET_SKEW_X, rebucket_hint
                               attached as the remedy
  D006 stall                   watchdog declared a source stalled
  D007 route-mismatch          the routed engine measured slower than
                               the alternative it beat on paper
  D008 dominant-phase-shift    the run's dominant trace phase moved
                               against prior same-platform rounds
  D009 preflight-misprediction degraded admission that ran fine
  D010 oracle-fallback-burst   the host oracle deciding keys the
                               device engine declined
  D011 slo-burn                an SLO error budget burning past the
                               multi-window gate
  D012 queue-backlog           service admission-queue depth growing
  D013 replica-down            \
  D014 replica-skew             > fleet rules over N replicas' ledgers:
  D015 warm-divergence         /  registered here, evaluated by the
                                  fleet observatory (`observatory.py`)
  D016 lock-contention         a witnessed lock's acquire-wait p95
                               (the `lockwatch` series) past the gate;
                               silent when the series is absent

Thresholds are read from the planes that own them
(`occupancy.TARGET_FILL`, `devices.HBM_DRIFT_X` via `drift`,
`fleet.REBUCKET_SKEW_X`, `slo.burn_threshold`); the doctor-only knobs
live here as module constants.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from . import drift, fleet
from . import ledger as ledger_mod

RULES = {
    "D001": "compile-storm",
    "D002": "fill-collapse",
    "D003": "ladder-thrash",
    "D004": "hbm-drift",
    "D005": "straggler-skew",
    "D006": "stall",
    "D007": "route-mismatch",
    "D008": "dominant-phase-shift",
    "D009": "preflight-misprediction",
    "D010": "oracle-fallback-burst",
    "D011": "slo-burn",
    "D012": "queue-backlog",
    # fleet rules: evaluated by observatory.py over the FEDERATED view
    # (they need N replicas' ledgers, which a single-process
    # TelemetryView never has), registered here so findings, lint and
    # the autopilot share ONE rule catalog
    "D013": "replica-down",
    "D014": "replica-skew",
    "D015": "warm-divergence",
    "D016": "lock-contention",
}

# Rules `diagnose` itself evaluates (single-process planes); the
# fleet rules above are observatory.py's.
LOCAL_RULES = tuple(f"D{i:03d}" for i in range(1, 13)) + ("D016",)

SEVERITIES = ("critical", "warn", "info")
_SEVERITY_RANK = {"critical": 3, "warn": 2, "info": 1}

# D001: fire when total compiles exceed this multiple of the planned
# bucket count AND the absolute floor (a healthy cold run legitimately
# compiles one kernel per ladder bucket; a storm is per-KEY compiles).
COMPILE_STORM_X = 3.0
COMPILE_STORM_MIN = 8

# D002: "collapse" is fill below this fraction of the tracked target
# (below-target-but-working fills are the occupancy report's business;
# the doctor flags lanes running mostly EMPTY), over at least
# MIN_ROUNDS rounds so a 3-round search can't false-positive.
FILL_COLLAPSE_FRAC = 0.5
MIN_ROUNDS = 8

# D003: a bucket re-entered this many times is thrash (the policy's
# hysteresis burns an abandoned bucket once; repeated revisits mean
# the wavefront is defeating it).
THRASH_REVISITS = 2

# D007: the routed engine measured slower than the alternative by
# this factor before the router's call counts as a mismatch.
ROUTE_MISMATCH_X = 1.2

# D008: only a phase that actually dominates (this share of the total
# traced wall) can "shift" — minor phases reshuffle freely.
PHASE_SHIFT_SHARE = 0.35

# D010: oracle fallbacks below this count / fraction of keys are
# normal attrition, not a burst.
FALLBACK_BURST_MIN = 3
FALLBACK_BURST_FRAC = 0.25

# D011: how many of the slowest service requests anchor the
# dominant-phase evidence.
SLO_SLOW_REQUESTS = 3

# D012: queue depth must be observed over this many service points,
# grow by at least this much, and end at its window peak before a
# backlog is declared; the warm-hit rate above the split means the
# pool is warm (capacity problem), below it cold (compile storm).
QUEUE_BACKLOG_MIN_POINTS = 6
QUEUE_BACKLOG_GROWTH = 4
QUEUE_WARM_SPLIT = 0.6

# D016: a lock's acquire-wait p95 (from the lockwatch witness series)
# must clear both the absolute gate and the sample floor before it
# counts as contention — brief spikes on a handful of acquires are
# scheduling noise, not a hot lock.
LOCK_CONTENTION_MIN_POINTS = 8
LOCK_CONTENTION_WAIT_P95_S = 0.005

# Series the view pulls from a registry / metrics JSONL export.
SERIES_OF_INTEREST = (
    "wgl_rounds", "wgl_chunks", "wgl_adapt", "wgl_batched_lanes",
    "fleet_shards", "fleet_faults", "watchdog_stalls", "hbm",
    "preflight", "service", "slo", "lockwatch")

# Bounds on what rides a finding (the full series stay in their
# artifacts; evidence is for pointing, not re-exporting).
MAX_EVIDENCE_POINTS = 16
MAX_FINDINGS_LEDGER = 16


def _target_fill() -> float:
    """occupancy.TARGET_FILL without importing the kernel wrappers at
    doctor-import time (the doctor stays importable for pure artifact
    reads)."""
    try:
        from .occupancy import TARGET_FILL
        return TARGET_FILL
    except Exception:  # noqa: BLE001 — kernels unimportable: the
        return 0.8     # documented default stands in


def finding(rule: str, severity: str, summary: str, *,
            evidence: Optional[list] = None,
            action: Optional[str] = None,
            subject: Optional[str] = None,
            score: float = 1.0,
            remedy: Optional[dict] = None) -> dict:
    """One diagnosis finding. `evidence` entries are
    `{"series": <where>, "field": <what>, "indices": [...],
    "values": [...]}` (+ optional `t` stamps for the Perfetto
    annotations); `remedy` carries a structured fix (e.g. the
    fleet rebucket_hint) next to the human `action` string."""
    assert rule in RULES, f"unknown rule {rule!r}"
    assert severity in SEVERITIES, f"unknown severity {severity!r}"
    out = {"rule": rule, "name": RULES[rule], "severity": severity,
           "summary": str(summary),
           "score": round(float(score), 4),
           "evidence": list(evidence or [])}
    if subject is not None:
        out["subject"] = str(subject)
    if action:
        out["action"] = str(action)
    if remedy:
        out["remedy"] = remedy
    return out


def evidence(series: str, field: str, indices: list, values: list,
             t: Optional[list] = None, **extra) -> dict:
    """One evidence entry, bounded to MAX_EVIDENCE_POINTS."""
    out = {"series": str(series), "field": str(field),
           "indices": list(indices)[:MAX_EVIDENCE_POINTS],
           "values": list(values)[:MAX_EVIDENCE_POINTS]}
    if t:
        out["t"] = [float(x) for x in t[:MAX_EVIDENCE_POINTS]]
    out.update(extra)
    return out


# ---------------------------------------------------------------------------
# TelemetryView — uniform reads over already-recorded artifacts
# ---------------------------------------------------------------------------

class TelemetryView:
    """What one diagnosis looks at: metric series points, ledger
    records, trace spans, and named result/config dicts — all
    already-recorded host-side data (the doctor never executes
    anything on a device).

    `results` maps a subject name to a result-shaped dict (a bench
    config entry, an analysis result, or a ledger record — the rules
    read the overlapping fields: `util`, `preflight`, `hbm`,
    `compiles`, engine/route fields, paired engine rows).
    `prior_phases` carries `{"platform", "dominant"}` entries from
    prior diagnoses (kind="doctor" ledger records) for D008."""

    def __init__(self, *, target: str = "run",
                 platform: Optional[str] = None,
                 series: Optional[dict] = None,
                 records: Optional[list] = None,
                 spans: Optional[list] = None,
                 results: Optional[dict] = None,
                 prior_phases: Optional[list] = None):
        self.target = str(target)
        self.platform = platform
        self._series = {k: list(v) for k, v in (series or {}).items()}
        self.records = [r for r in (records or [])
                        if isinstance(r, dict)]
        self.spans = [s for s in (spans or []) if isinstance(s, dict)]
        self.results = {str(k): v for k, v in (results or {}).items()
                        if isinstance(v, dict)}
        self.prior_phases = [p for p in (prior_phases or [])
                             if isinstance(p, dict)]

    def series(self, name: str) -> list:
        return self._series.get(name, [])


def view_from_registry(reg, **kw) -> TelemetryView:
    """A view over a live metrics Registry (plus whatever records /
    results / spans the caller passes through)."""
    series = {}
    for name in SERIES_OF_INTEREST:
        pts = reg.series(name).points
        if pts:
            series[name] = pts
    kw.setdefault("series", series)
    return TelemetryView(**kw)


def load_series_jsonl(path: str) -> dict:
    """{series: [points]} from a metrics JSONL export (the
    `{"type": "sample", "series": ...}` lines; other line types are
    instrument snapshots, not series points)."""
    out: dict = {}
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict) and obj.get("type") == "sample":
                    name = str(obj.get("series"))
                    pt = {k: v for k, v in obj.items()
                          if k not in ("type", "series")}
                    out.setdefault(name, []).append(pt)
    except OSError:
        pass
    return out


def load_spans_jsonl(path: str) -> list:
    """Span dicts from an OTLP-flavored trace.jsonl export."""
    out: list = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict) \
                        and obj.get("startTimeUnixNano") is not None:
                    out.append(obj)
    except OSError:
        pass
    return out


def _prior_phase_records(led: ledger_mod.Ledger,
                         platform: Optional[str],
                         before: Optional[float] = None) -> list:
    """The D008 baseline: dominant-phase entries from prior
    same-platform kind="doctor" records."""
    out = []
    try:
        for rec in led.query(kind="doctor", until=before):
            if platform is not None and rec.get("platform") not in (
                    None, platform):
                continue
            ph = rec.get("phases")
            if isinstance(ph, dict) and ph.get("dominant"):
                out.append({"platform": rec.get("platform"),
                            "dominant": ph["dominant"],
                            "shares": ph.get("shares")})
    except Exception:  # noqa: BLE001 — a torn ledger yields no
        pass           # baseline, never a failed diagnosis
    return out


def bench_view(root: str, *, registry=None, tracer=None,
               details: Optional[dict] = None,
               since: Optional[float] = None) -> TelemetryView:
    """The view over a bench round under `root` (the paths are
    `bench.TELEMETRY_DIR`, `bench.DETAILS_FILE` and `bench.STORE_DIR`):
    the telemetry exports (or the live registry/tracer when diagnosing
    in-process), the details file's configs as subjects, and the store
    ledger's records from this round (`since`)."""
    # In-process mode (a live registry/tracer passed): NEVER fall
    # back to the artifact files — they are the PREVIOUS round's
    # exports until this round's emit() overwrites them, and a stale
    # stall/collapse must not be re-reported as this round's. The
    # file path is for the CLI diagnosing a finished round.
    from .bench import DETAILS_FILE, STORE_DIR, TELEMETRY_DIR
    art = os.path.join(root, TELEMETRY_DIR)
    in_process = registry is not None or tracer is not None
    if registry is not None:
        series = {}
        for name in SERIES_OF_INTEREST:
            pts = registry.series(name).points
            if pts:
                series[name] = pts
    elif in_process:
        series = {}
    else:
        series = load_series_jsonl(
            os.path.join(art, "bench_metrics.jsonl"))
    if tracer is not None:
        spans = [sp.to_json() for sp in tracer.spans]
    elif in_process:
        spans = []
    else:
        spans = load_spans_jsonl(os.path.join(art, "bench_trace.jsonl"))
    if details is None:
        try:
            with open(os.path.join(root, DETAILS_FILE)) as fh:
                details = json.load(fh)
        except (OSError, ValueError):
            details = {}
    results: dict = {}
    platform = details.get("platform")
    headline = {k: details.get(k) for k in
                ("util", "occupancy", "hbm", "preflight", "telemetry")
                if details.get(k) is not None}
    if headline or details.get("verdict") is not None:
        headline["valid?"] = details.get("verdict")
        cg = details.get("compile_guard")
        if isinstance(cg, dict) and isinstance(cg.get("compiles"), int):
            headline["compiles"] = cg["compiles"]
        results[details.get("metric") or "headline"] = headline
    for name, cfg in (details.get("configs") or {}).items():
        if isinstance(cfg, dict):
            results[name] = cfg
    led = ledger_mod.Ledger(os.path.join(root, STORE_DIR))
    if since is None:
        # no explicit round boundary (the CLI path): scope to the
        # LATEST round via the kind="bench-round" markers emit()
        # banks — records since the PREVIOUS round's marker belong
        # to the newest round. Pooling many rounds' records would
        # sum their healthy cold compiles into a false D001.
        marks = led.query(kind="bench-round", limit=2,
                          newest_first=True)
        if len(marks) == 2:
            since = marks[1].get("t")
    records = led.query(since=since) if since is not None \
        else led.query(limit=200)
    return TelemetryView(
        target="bench", platform=platform, series=series, spans=spans,
        results=results,
        records=[r for r in records if r.get("kind") != "doctor"],
        prior_phases=_prior_phase_records(led, platform, before=since))


def run_view(store_root: str, run_id: str = "latest") -> TelemetryView:
    """The view over one ledger record (`run_id`, or the newest when
    "latest"): the record as the single subject, plus its exported
    trace artifact when one was recorded."""
    led = ledger_mod.Ledger(store_root)
    if run_id == "latest":
        # newest record that is not itself a diagnosis — the doctor
        # must not end up diagnosing its own prior reports
        rec = next((r for r in led.query(newest_first=True)
                    if r.get("kind") != "doctor"), None)
    else:
        rec = led.get(run_id)
    if rec is None:
        raise KeyError(f"no ledger record {run_id!r} under "
                       f"{store_root!r}")
    spans: list = []
    rel = (rec.get("artifacts") or {}).get("trace")
    if rel:
        spans = load_spans_jsonl(
            os.path.join(store_root, *str(rel).split("/")))
    return TelemetryView(
        target=str(rec.get("id")), platform=rec.get("platform"),
        results={str(rec.get("name") or rec.get("id")): rec},
        records=[rec], spans=spans,
        prior_phases=_prior_phase_records(led, rec.get("platform"),
                                          before=rec.get("t")))


# ---------------------------------------------------------------------------
# shared readers
# ---------------------------------------------------------------------------

def _util(res: dict) -> dict:
    u = res.get("util")
    return u if isinstance(u, dict) else {}


def _pf(res: dict) -> dict:
    pf = res.get("preflight")
    return pf if isinstance(pf, dict) else {}


def phase_profile(spans: list) -> Optional[dict]:
    """{"phases": {name: seconds}, "shares": {name: frac},
    "dominant": name} over finished spans — the per-phase wall
    distribution D008 compares across rounds. None when the trace is
    empty/degenerate."""
    totals: dict = {}
    for sp in spans or []:
        t0, t1 = sp.get("startTimeUnixNano"), sp.get("endTimeUnixNano")
        if t0 is None or t1 is None:
            continue
        dur = (int(t1) - int(t0)) / 1e9
        if dur <= 0:
            continue
        name = str(sp.get("name"))
        totals[name] = totals.get(name, 0.0) + dur
    if not totals:
        return None
    total = sum(totals.values())
    shares = {n: round(v / total, 4) for n, v in totals.items()}
    dominant = max(shares, key=lambda n: shares[n])
    return {"phases": {n: round(v, 4) for n, v in totals.items()},
            "shares": shares, "dominant": dominant,
            "dominant_share": shares[dominant]}


def _bucket_label(shapes: dict) -> str:
    w = shapes.get("W_pad") or shapes.get("W")
    return f"W={w if w is not None else '?'}," \
           f"K={shapes.get('K') if shapes.get('K') is not None else '?'}"


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _d001(view: TelemetryView) -> list:
    """Compile-storm: compiles >> planned shape buckets — the
    `independent_100x2k` signature of per-key shape buckets each paying
    a compile inside the measured window (the fix is
    `parallel.shared_shape_bucket`)."""
    per_bucket: dict = {}
    idxs: list = []
    vals: list = []
    subjects: dict = {}
    planned = 0
    # ledger records: per-key/per-config CompileGuard counts, grouped
    # by shape bucket
    for i, rec in enumerate(view.records):
        c = rec.get("compiles")
        if not isinstance(c, int) or isinstance(c, bool) or c <= 0:
            continue
        bucket = _bucket_label(rec.get("shapes") or {})
        per_bucket[bucket] = per_bucket.get(bucket, 0) + c
        idxs.append(i)
        vals.append(c)
        name = str(rec.get("name") or "?")
        subjects[name] = subjects.get(name, 0) + c
        planned = max(planned,
                      len(_pf(rec).get("buckets") or ()))
    # result/config subjects carrying a compile count directly
    for name, res in view.results.items():
        c = res.get("compiles")
        if not isinstance(c, int) or isinstance(c, bool) or c <= 0:
            continue
        if name in subjects:  # the same run's ledger record
            continue
        bucket = _bucket_label(
            {"K": res.get("K"), "W_pad": res.get("W_pad"),
             "W": res.get("W")})
        per_bucket[bucket] = per_bucket.get(bucket, 0) + c
        subjects[name] = subjects.get(name, 0) + c
        planned = max(planned, len(_pf(res).get("buckets") or ()))
    total = sum(per_bucket.values())
    if not total:
        return []
    # planned compiles: the preflight bucket plan when one exists,
    # else one compile per distinct shape bucket actually seen
    planned = max(planned, len(per_bucket), 1)
    if total < COMPILE_STORM_MIN or total <= COMPILE_STORM_X * planned:
        return []
    top = max(subjects, key=lambda n: subjects[n])
    ev = [evidence("ledger", "compiles", idxs, vals,
                   per_bucket=per_bucket, planned_buckets=planned)]
    return [finding(
        "D001", "critical",
        f"{total} XLA compiles across {len(per_bucket)} shape "
        f"bucket(s) vs {planned} planned — compiles are being paid "
        f"per key/call, not per bucket",
        subject=top, evidence=ev, score=total / planned,
        action="warm every shape bucket before the measured window "
               "(ops/aot.precompile_wgl_ladder / "
               "precompile_elle_closure) or pad keys into one shared "
               "bucket (parallel.shared_shape_bucket — the shared-bucket fix)")]


def _d002(view: TelemetryView) -> list:
    """Fill-collapse: frontier fill far below occupancy.TARGET_FILL —
    the lanes run mostly empty and every round wastes the idle
    fraction of its gather bandwidth."""
    target = _target_fill()
    floor = target * FILL_COLLAPSE_FRAC
    out: list = []
    fired_subjects = False
    for name, res in view.results.items():
        util = _util(res)
        fill = util.get("frontier_fill")
        rounds = util.get("rounds")
        if not isinstance(fill, (int, float)) or fill >= floor:
            continue
        if isinstance(rounds, int) and rounds < MIN_ROUNDS:
            continue
        ev = [evidence(f"results:{name}", "util.frontier_fill",
                       [0], [fill], target=target)]
        out.append(finding(
            "D002", "warn",
            f"frontier fill {fill} vs target {target} "
            f"(< {FILL_COLLAPSE_FRAC:.0%} of target)",
            subject=name, evidence=ev,
            score=(target - fill) / max(target, 1e-9),
            action="let the adaptive ladder start lower / verify "
                   "compact-before-expand is on; a beam this sparse "
                   "pays full-K gathers for near-empty lanes "
                   "(ROADMAP item 5)"))
        fired_subjects = True
    pts = view.series("wgl_rounds")
    fills = [(i, p) for i, p in enumerate(pts)
             if isinstance(p.get("fill"), (int, float))]
    if len(fills) >= MIN_ROUNDS:
        mean = sum(p["fill"] for _, p in fills) / len(fills)
        if mean < floor:
            worst = sorted(fills, key=lambda ip: ip[1]["fill"])
            ev = [evidence(
                "wgl_rounds", "fill",
                [i for i, _ in worst], [p["fill"] for _, p in worst],
                t=[p["t"] for _, p in worst if p.get("t") is not None],
                mean_fill=round(mean, 4), target=target)]
            if not fired_subjects:
                out.append(finding(
                    "D002", "warn",
                    f"mean per-round fill {round(mean, 4)} over "
                    f"{len(fills)} recorded rounds vs target {target}",
                    evidence=ev,
                    score=(target - mean) / max(target, 1e-9),
                    action="let the adaptive ladder start lower / "
                           "verify compact-before-expand is on "
                           "(ROADMAP item 5)"))
            elif out:
                # subjects already named: attach the offending rounds
                # (with their wall stamps — the Perfetto annotations)
                out[-1]["evidence"].append(ev[0])
    return out


def _entered_buckets(path: list) -> list:
    """The sequence of buckets ENTERED by an adapt path
    (`[[from_K, to_K, reason], ...]`)."""
    out = []
    for step in path or []:
        if isinstance(step, (list, tuple)) and len(step) >= 2:
            out.append(step[1])
    return out


def _d003(view: TelemetryView) -> list:
    """Ladder-thrash: the adaptive scheduler oscillating between
    buckets — each switch pays a frontier migration and a warm-cache
    dispatch, so a wavefront that defeats the hysteresis shows up as
    re-entered buckets."""
    out: list = []
    for name, res in view.results.items():
        adapt = _util(res).get("adapt")
        if not isinstance(adapt, dict):
            continue
        entered = _entered_buckets(adapt.get("path"))
        revisits = len(entered) - len(set(entered))
        if revisits < THRASH_REVISITS:
            continue
        ev = [evidence(f"results:{name}", "util.adapt.path",
                       list(range(len(entered))), entered,
                       switches=adapt.get("switches"))]
        out.append(finding(
            "D003", "warn",
            f"{adapt.get('switches')} ladder switches with "
            f"{revisits} bucket revisit(s) ({entered})",
            subject=name, evidence=ev, score=revisits,
            action="pin frontier=K for this shape or widen the "
                   "policy hysteresis (ops/adapt.Policy); a thrashing "
                   "ladder pays migration + dispatch per switch"))
    if not out:
        # series fallback: wgl_adapt points carry no search id, and a
        # fan-out round interleaves MANY searches' switches — so
        # segment on the per-search `chunk` counter resetting (each
        # search's chunks increase monotonically; a new key restarts
        # low). Revisits only count WITHIN one segment: N keys each
        # escalating once to the same bucket is healthy, not thrash.
        pts = [p for p in view.series("wgl_adapt")
               if p.get("to_K") is not None]
        segments: list = []
        prev_chunk = None
        prev_to = None
        for p in pts:
            chunk = p.get("chunk")
            # one search's switches CHAIN: its next from_K is its
            # last to_K, and its chunk counter only grows. A break
            # in either is another search's point (three keys each
            # escalating 16->32 at chunks 2,3,4 produce three
            # one-point segments, not one fake-thrash segment).
            fresh = (chunk is None or prev_chunk is None
                     or chunk <= prev_chunk
                     or p.get("from_K") != prev_to)
            if fresh:
                segments.append([])
            segments[-1].append(p)
            prev_chunk = chunk
            prev_to = p.get("to_K")
        worst: list = []
        revisits = 0
        for seg in segments:
            entered = [p["to_K"] for p in seg]
            r = len(entered) - len(set(entered))
            if r > revisits:
                revisits, worst = r, seg
        if revisits >= THRASH_REVISITS:
            entered = [p["to_K"] for p in worst]
            ev = [evidence("wgl_adapt", "to_K",
                           [pts.index(p) for p in worst], entered,
                           t=[p["t"] for p in worst
                              if p.get("t") is not None])]
            out.append(finding(
                "D003", "warn",
                f"{len(entered)} ladder switches in one search with "
                f"{revisits} bucket revisit(s) ({entered})",
                evidence=ev, score=revisits,
                action="pin frontier=K for this shape or widen the "
                       "policy hysteresis (ops/adapt.Policy)"))
    return out


def _d004(view: TelemetryView) -> list:
    """HBM-drift: the measured device peak outside
    devices.HBM_DRIFT_X of preflight's analytic prediction — an
    under-prediction admits plans that OOM, an over-prediction wastes
    admission capacity."""
    out: list = []
    for name, res in view.results.items():
        pf = _pf(res)
        ratio = pf.get("hbm_drift_x")
        measured = pf.get("hbm_peak_measured")
        predicted = pf.get("hbm_peak_bytes")
        if not isinstance(ratio, (int, float)):
            hbm = res.get("hbm")
            if isinstance(hbm, dict):
                measured = hbm.get("peak_measured")
            ratio = drift.drift_x(measured, predicted)
        if ratio is None or not drift.drift_regressed(ratio):
            continue
        under = ratio > 1.0  # measured > predicted
        ev = [evidence(f"results:{name}", "preflight.hbm_drift_x",
                       [0], [ratio], measured=measured,
                       predicted=predicted,
                       threshold_x=drift.HBM_DRIFT_X)]
        out.append(finding(
            "D004", "warn" if under else "info",
            f"measured HBM peak is {ratio}x the admission "
            f"prediction (gate: {drift.HBM_DRIFT_X}x either way)",
            subject=name, evidence=ev,
            score=max(ratio, 1.0 / max(ratio, 1e-9)),
            action=("the analytic byte model under-predicts — an "
                    "admitted plan can OOM; recalibrate "
                    "analysis/preflight's peak model" if under else
                    "the analytic byte model over-predicts — "
                    "admission capacity is being left idle; "
                    "recalibrate analysis/preflight's peak model")))
    return out


def _d005(view: TelemetryView) -> list:
    """Straggler-skew: one device carrying the fan-out — a lockstep
    mesh pays the busiest device's wall, and fleet.rebucket_hint
    names exactly which keys to move (the remedy rides the
    finding)."""
    out: list = []
    for name, res in view.results.items():
        fl = _util(res).get("fleet")
        if not isinstance(fl, dict):
            continue
        skew = fl.get("work_skew")
        if not isinstance(skew, (int, float)) \
                or skew <= fleet.REBUCKET_SKEW_X:
            continue
        devs = fl.get("devices") or {}
        labels = sorted(devs)
        ev = [evidence(f"results:{name}", "util.fleet.work_skew",
                       [0], [skew],
                       per_device_wall={d: (devs[d] or {}).get("wall_s")
                                        for d in labels})]
        out.append(finding(
            "D005", "warn",
            f"work skew {skew}x across "
            f"{fl.get('device_count') or len(labels)} device(s) — "
            f"the mesh pays the busiest device's wall",
            subject=name, evidence=ev, score=skew,
            remedy=fl.get("rebucket_hint"),
            action="apply the rebucket hint (move the named keys to "
                   "the lazy device) or work-steal between polls "
                   "(fleet.summarize — ROADMAP item 2)"))
    if not out:
        shards = view.series("fleet_shards")
        if len(shards) >= 4:
            summ = fleet.summarize(shards)
            skew = summ.get("work_skew")
            if isinstance(skew, (int, float)) \
                    and skew > fleet.REBUCKET_SKEW_X \
                    and summ.get("device_count", 0) >= 2:
                devs = summ.get("devices") or {}
                ev = [evidence(
                    "fleet_shards", "wall_s",
                    list(range(min(len(shards),
                                   MAX_EVIDENCE_POINTS))),
                    [s.get("wall_s") for s in
                     shards[:MAX_EVIDENCE_POINTS]],
                    work_skew=skew,
                    per_device_wall={d: v.get("wall_s")
                                     for d, v in devs.items()})]
                out.append(finding(
                    "D005", "warn",
                    f"work skew {skew}x across "
                    f"{summ.get('device_count')} device(s)",
                    evidence=ev, score=skew,
                    remedy=summ.get("rebucket_hint"),
                    action="apply the rebucket hint or work-steal "
                           "between polls (ROADMAP item 2)"))
    return out


def _d006(view: TelemetryView) -> list:
    """Stall: the watchdog declared a source dead — the one failure
    the paper's reference checkers hide (a timeout with nothing to
    show)."""
    pts = view.series("watchdog_stalls")
    out: list = []
    if pts:
        ev = [evidence("watchdog_stalls", "age_s",
                       list(range(len(pts))),
                       [p.get("age_s") for p in pts],
                       t=[p["t"] for p in pts
                          if p.get("t") is not None],
                       sources=sorted({str(p.get("source"))
                                       for p in pts}))]
        out.append(finding(
            "D006", "critical",
            f"{len(pts)} watchdog stall(s): "
            f"{sorted({str(p.get('source')) for p in pts})}",
            evidence=ev, score=10 + len(pts),
            action="inspect the stalled source's last beat payload; "
                   "JEPSEN_TPU_WATCHDOG_ESCALATION=cancel reclaims "
                   "the budget with a partial verdict"))
        return out
    for name, res in view.results.items():
        stall = res.get("stall")
        stalls = res.get("stalls")
        if not isinstance(stall, dict) and not (
                isinstance(stalls, int) and stalls > 0):
            continue
        ev = [evidence(f"results:{name}", "stalls", [0],
                       [stalls if isinstance(stalls, int) else 1])]
        out.append(finding(
            "D006", "critical",
            "the run recorded a watchdog stall",
            subject=name, evidence=ev, score=10,
            action="inspect the stalled source's last beat payload "
                   "(doc/OBSERVABILITY.md \"Stall watchdog\")"))
    return out


_ROW_PAIRS = (
    # (routed row, alternative row, engines that mean "the routed
    #  row is the device-side choice")
    ("closure_row", "host_row"),
    ("device_row", "oracle_row"),
)


def _d007(view: TelemetryView) -> list:
    """Route-mismatch: the router's choice measured slower than the
    alternative it declined — the route REASON disagrees with the
    measured engine wall."""
    out: list = []
    for name, res in view.results.items():
        reason = res.get("cycle-route-reason") or res.get(
            "route_reason")
        for routed_key, alt_key in _ROW_PAIRS:
            routed = res.get(routed_key)
            alt = res.get(alt_key)
            if not isinstance(routed, dict) or not isinstance(
                    alt, dict):
                continue
            rw, aw = routed.get("wall_s"), alt.get("wall_s")
            if not isinstance(rw, (int, float)) or not isinstance(
                    aw, (int, float)) or aw <= 0:
                continue
            # only decided alternatives count: beating a DNF row is
            # exactly what the router is for
            if alt.get("verdict") in (None, "unknown"):
                continue
            if rw <= ROUTE_MISMATCH_X * aw:
                continue
            ev = [evidence(f"results:{name}", "wall_s", [0, 1],
                           [rw, aw], rows=[routed_key, alt_key],
                           route_reason=reason)]
            out.append(finding(
                "D007", "warn",
                f"routed engine ran {round(rw / aw, 2)}x slower than "
                f"the declined alternative ({routed_key} {rw}s vs "
                f"{alt_key} {aw}s; route reason: {reason})",
                subject=name, evidence=ev, score=rw / aw,
                action="re-derive the route cost model "
                       "(ops/route.py) against this shape — the "
                       "work model mispriced one engine"))
        pf = _pf(res)
        if pf.get("engine_match") is False:
            ev = [evidence(f"results:{name}", "preflight.engine_match",
                           [0], [False], planned=pf.get("engine"),
                           ran=res.get("engine")
                           or res.get("cycle-engine"))]
            out.append(finding(
                "D007", "info",
                f"preflight planned engine {pf.get('engine')!r} but "
                f"{res.get('engine') or res.get('cycle-engine')!r} "
                "ran",
                subject=name, evidence=ev, score=1,
                action="the static route mirror drifted from the "
                       "runtime router — re-align "
                       "analysis/preflight.plan_elle/plan_wgl"))
    return out


def _d008(view: TelemetryView) -> list:
    """Dominant-phase-shift: the run's cost center moved vs prior
    same-platform rounds (e.g. encode suddenly dominating a search
    that used to be device-round-bound)."""
    prof = phase_profile(view.spans)
    if not prof or len(prof["shares"]) < 2:
        return []
    priors = [p for p in view.prior_phases
              if view.platform is None or p.get("platform") in
              (None, view.platform)]
    doms = [p.get("dominant") for p in priors if p.get("dominant")]
    if not doms:
        return []
    # the modal prior dominant: one odd round must not become the
    # baseline the next round "shifts" from
    prior_dom = max(set(doms), key=doms.count)
    cur = prof["dominant"]
    if cur == prior_dom or prof["dominant_share"] < PHASE_SHIFT_SHARE:
        return []
    shares = prof["shares"]
    names = sorted(shares, key=lambda n: -shares[n])
    ev = [evidence("trace", "phase_share",
                   list(range(len(names))),
                   [shares[n] for n in names], phases=names,
                   prior_dominant=prior_dom,
                   prior_rounds=len(doms))]
    return [finding(
        "D008", "info",
        f"dominant trace phase shifted to {cur!r} "
        f"({prof['dominant_share']:.0%} of traced wall) from "
        f"{prior_dom!r} over {len(doms)} prior round(s)",
        evidence=ev, score=prof["dominant_share"],
        action="profile the new dominant phase — the run's cost "
               "center moved, so prior optimizations no longer "
               "target the bottleneck")]


def _d009(view: TelemetryView) -> list:
    """Preflight-misprediction: an admission the analyzer DEGRADED
    ran to a clean verdict anyway — the degrade rules are paying
    conservatism the hardware did not demand."""
    out: list = []
    for name, res in view.results.items():
        pf = _pf(res)
        verdict = res.get("valid?", res.get("verdict"))
        if pf.get("verdict") != "degrade":
            continue
        if verdict not in (True, False):
            continue
        if isinstance(res.get("stall"), dict) or res.get("stalls"):
            continue
        ev = [evidence(f"results:{name}", "preflight.verdict", [0],
                       ["degrade"], run_verdict=verdict,
                       rules=pf.get("rules"))]
        out.append(finding(
            "D009", "info",
            f"admission degraded this run ({pf.get('rules')}) but it "
            f"decided cleanly (verdict={verdict})",
            subject=name, evidence=ev, score=1,
            action="loosen the fired degrade rule's threshold in "
                   "analysis/preflight — this shape runs fine "
                   "undegraded"))
    return out


def _d010(view: TelemetryView) -> list:
    """Oracle-fallback-burst: the host oracle deciding keys the
    device engine declined — every fallback forfeits the device
    speedup, and a burst of them means the device path is broken for
    this shape, not unlucky."""
    out: list = []
    for name, res in view.results.items():
        fl = _util(res).get("fleet")
        if not isinstance(fl, dict):
            continue
        fallbacks, keys = fl.get("fallbacks"), fl.get("keys")
        if not isinstance(fallbacks, int) or not isinstance(keys, int):
            continue
        if fallbacks < FALLBACK_BURST_MIN or keys <= 0 \
                or fallbacks / keys < FALLBACK_BURST_FRAC:
            continue
        ev = [evidence(f"results:{name}", "util.fleet.fallbacks",
                       [0], [fallbacks], keys=keys,
                       frac=round(fallbacks / keys, 4))]
        out.append(finding(
            "D010", "warn",
            f"{fallbacks}/{keys} keys decided by the host oracle "
            "fallback",
            subject=name, evidence=ev, score=fallbacks / keys * 10,
            action="read the per-key device_cause fields on the "
                   "fallback shards — the device engine is declining "
                   "this shape, and the oracle's wall is the bound "
                   "now"))
    if not out:
        shards = view.series("fleet_shards")
        fb = [(i, s) for i, s in enumerate(shards)
              if s.get("engine") == "oracle-fallback"]
        if len(fb) >= FALLBACK_BURST_MIN and shards \
                and len(fb) / len(shards) >= FALLBACK_BURST_FRAC:
            ev = [evidence("fleet_shards", "engine",
                           [i for i, _ in fb],
                           ["oracle-fallback"] * len(fb),
                           keys=len(shards))]
            out.append(finding(
                "D010", "warn",
                f"{len(fb)}/{len(shards)} keys decided by the host "
                "oracle fallback",
                evidence=ev, score=len(fb) / len(shards) * 10,
                action="read the per-key device_cause fields on the "
                       "fallback shards"))
    return out


def _burn_x() -> float:
    """slo.burn_threshold without requiring the slo module at
    diagnosis time (the _target_fill pattern)."""
    try:
        from .slo import burn_threshold
        return burn_threshold()
    except Exception:  # noqa: BLE001
        return 2.0


_PHASE_REMEDY = {
    "queue_wait_s": "queue-wait dominates — add service workers / "
                    "devices, or raise the batch size so same-bucket "
                    "arrivals coalesce harder",
    "warm_s": "warm-dispatch dominates — pre-warm the shape buckets "
              "ahead of traffic (aot.precompile_service_bucket; "
              "Service.rewarm restores the fs_cache plan registry "
              "after a restart)",
    "search_s": "the search itself dominates — this is a kernel "
                "problem, not a serving one; read the occupancy/"
                "roofline planes for the offending shape",
    "preflight_s": "admission analysis dominates — cache the plan "
                   "per shape bucket (analysis/preflight)",
    "admit_s": "request parsing dominates — histories this large "
               "should stream, not POST",
    "respond_s": "response accounting dominates — the ledger write "
                 "path is in the request loop",
}


def _slowest_phases(view: TelemetryView) -> tuple:
    """(evidence entry, dominant phase) over the slowest
    service-request records' phase walls — the D011 anchor. (None,
    None) when no phased requests are recorded."""
    # indices are into view.records (the convention every
    # ledger-evidence rule shares, e.g. _d001) — NOT into the
    # filtered service-request subset, which would dereference
    # unrelated records on a real interleaved ledger
    svc = [(i, r) for i, r in enumerate(view.records)
           if r.get("kind") == "service-request"
           and isinstance(r.get("wall_s"), (int, float))
           and isinstance(r.get("phases"), dict)]
    if not svc:
        return None, None
    svc.sort(key=lambda ir: -float(ir[1]["wall_s"]))
    slow = svc[:SLO_SLOW_REQUESTS]
    totals: dict = {}
    per_req = {}
    for _i, rec in slow:
        per_req[str(rec.get("id"))] = rec["phases"]
        for ph, v in rec["phases"].items():
            if isinstance(v, (int, float)):
                totals[ph] = totals.get(ph, 0.0) + float(v)
    dominant = max(totals, key=lambda p: totals[p]) if totals else None
    ev = evidence("ledger", "wall_s", [i for i, _ in slow],
                  [rec["wall_s"] for _, rec in slow],
                  phases=per_req, dominant_phase=dominant)
    return ev, dominant


def _d011(view: TelemetryView) -> list:
    """SLO-burn: an error budget burning past the multi-window gate
    (slo.Engine's burn alert) — the serving plane's equivalent of a
    wall regression, with the evidence pointing at the slowest
    requests' phase walls and the remedy naming the dominant one."""
    burning: dict = {}
    idxs: list = []
    rates: list = []
    pts = view.series("slo")
    for i, p in enumerate(pts):
        br = p.get("burn_rate")
        if not isinstance(br, (int, float)):
            continue
        if p.get("burn_alert") is True or (
                p.get("met") is False and br > _burn_x()):
            name = str(p.get("objective"))
            if br >= burning.get(name, 0.0):
                burning[name] = br
            idxs.append(i)
            rates.append(br)
    for rec in view.records:
        if rec.get("kind") != "slo":
            continue
        alerted = {str(a) for a in rec.get("burn_alerts") or []}
        for row in rec.get("objectives") or []:
            name = str(row.get("name"))
            br = row.get("burn_rate")
            if name in alerted and isinstance(br, (int, float)):
                burning[name] = max(burning.get(name, 0.0), br)
    if not burning:
        return []
    worst = max(burning.values())
    ev = []
    if idxs:
        ev.append(evidence("slo", "burn_rate", idxs, rates,
                           objectives=sorted(burning)))
    slow_ev, dominant = _slowest_phases(view)
    if slow_ev is not None:
        ev.append(slow_ev)
    action = _PHASE_REMEDY.get(
        dominant,
        "inspect the phase walls on the slowest service-request "
        "records — the burning objective names which wall to cut")
    remedy = {"dominant_phase": dominant} if dominant else None
    return [finding(
        "D011", "warn",
        f"SLO error budget burning: {sorted(burning)} at up to "
        f"{round(worst, 2)}x budget (gate {_burn_x()}x, "
        f"multi-window)",
        subject=",".join(sorted(burning)), evidence=ev, score=worst,
        action=action, remedy=remedy)]


def _d012(view: TelemetryView) -> list:
    """Queue-backlog: the admission queue deepening across service
    completions. A warm pool falling behind is a capacity problem;
    a cold one is paying compiles inside the serve path — the D001
    compile-storm signature arriving through the front door."""
    pts = [p for p in view.series("service")
           if isinstance(p.get("queue_depth"), int)]
    if len(pts) < QUEUE_BACKLOG_MIN_POINTS:
        return []
    window = pts[-12:]
    depths = [p["queue_depth"] for p in window]
    growth = depths[-1] - depths[0]
    rising = sum(1 for a, b in zip(depths, depths[1:]) if b >= a)
    if growth < QUEUE_BACKLOG_GROWTH \
            or depths[-1] != max(depths) \
            or rising < 0.7 * (len(depths) - 1):
        return []
    warm = [bool(p.get("warm_hit")) for p in window]
    warm_rate = sum(warm) / len(warm)
    # backpressure vs backlog: sheds in the window mean the service
    # is ALREADY refusing load (burn-driven admission control) — a
    # deepening queue despite sheds is a capacity deficit, not a
    # missing brake
    sheds = sum(1 for p in window if p.get("shed"))
    base = max(0, len(pts) - len(window))
    idxs = [base + i for i in range(len(window))]
    ev = [evidence("service", "queue_depth", idxs, depths,
                   t=[p["t"] for p in window
                      if p.get("t") is not None],
                   warm_rate=round(warm_rate, 3),
                   shed_count=sheds)]
    if warm_rate >= QUEUE_WARM_SPLIT:
        action = ("the pool is warm but falling behind — add "
                  "service workers / devices, or raise max_batch so "
                  "coalescing amortizes harder (capacity)")
        if sheds:
            action += (f"; {sheds} shed(s) in the window: admission "
                       "is already braking, the deficit is capacity")
    else:
        action = ("cold buckets are paying compiles inside the "
                  "serve path — warm ahead of traffic "
                  "(aot.precompile_service_plan / Service.rewarm)"
                  "; see D001 compile-storm for the kernel-side "
                  "signature")
        ev.append(evidence("service", "warm_hit", idxs,
                           warm, related_rule="D001"))
    return [finding(
        "D012", "warn",
        f"admission queue depth grew {depths[0]} -> {depths[-1]} "
        f"over {len(window)} request(s) at warm-hit rate "
        f"{round(warm_rate, 2)}"
        + (f" with {sheds} shed(s)" if sheds else ""),
        evidence=ev, score=growth, action=action)]


def _d016(view: TelemetryView) -> list:
    """Lock-contention: a witnessed lock's acquire-wait p95 past the
    gate. The lockwatch series only exists under
    JEPSEN_TPU_LOCKWATCH=1, so this rule is silent on uninstrumented
    runs — and a hot lock usually means either too much work under it
    (split the guarded state) or a blocking call that threadlint T003
    should have flagged (hoist it outside the critical section)."""
    pts = [p for p in view.series("lockwatch")
           if p.get("event") == "acquire"
           and isinstance(p.get("wait_s"), (int, float))]
    if not pts:
        return []
    by_lock: dict = {}
    for i, p in enumerate(pts):
        by_lock.setdefault(str(p.get("lock")), []).append(
            (i, float(p["wait_s"])))
    out = []
    for label, rows in sorted(by_lock.items()):
        if len(rows) < LOCK_CONTENTION_MIN_POINTS:
            continue
        waits = sorted(w for _, w in rows)
        p95 = waits[min(len(waits) - 1,
                        int(0.95 * (len(waits) - 1)))]
        if p95 < LOCK_CONTENTION_WAIT_P95_S:
            continue
        hot = sorted(rows, key=lambda r: r[1],
                     reverse=True)[:MAX_EVIDENCE_POINTS]
        out.append(finding(
            "D016", "warn",
            f"lock {label!r} acquire-wait p95 "
            f"{round(p95 * 1e3, 2)}ms over {len(rows)} contended "
            f"acquire(s) (gate "
            f"{LOCK_CONTENTION_WAIT_P95_S * 1e3:g}ms)",
            evidence=[evidence(
                "lockwatch", "wait_s",
                [i for i, _ in hot],
                [round(w, 6) for _, w in hot],
                lock=label)],
            subject=label, score=p95,
            action=(f"split the state guarded by {label!r} (or "
                    "shorten its critical sections — a blocking "
                    "call held under it is a threadlint T003 "
                    "site); lockwatch's per-lock hold_p95_s says "
                    "whether holders or queuers dominate")))
    return out


_RULE_FNS: tuple = (_d001, _d002, _d003, _d004, _d005, _d006, _d007,
                    _d008, _d009, _d010, _d011, _d012, _d016)


# ---------------------------------------------------------------------------
# diagnosis + surfacing
# ---------------------------------------------------------------------------

def diagnose(view: TelemetryView) -> dict:
    """Run the full rule catalog over one view; returns the report
    with findings ranked most-severe first. A rule that throws is
    recorded in `errors` (never a lost diagnosis — the doctor's own
    failure mode must not be silence)."""
    findings: list = []
    errors: list = []
    for fn in _RULE_FNS:
        try:
            findings.extend(fn(view))
        except Exception as e:  # noqa: BLE001
            errors.append(f"{fn.__name__}: "
                          f"{type(e).__name__}: {e}"[:200])
    findings.sort(key=lambda f: (-_SEVERITY_RANK[f["severity"]],
                                 -f["score"], f["rule"]))
    report = {"schema": 1,
              "target": view.target,
              "platform": view.platform,
              "t": round(time.time(), 3),
              "healthy": not findings,
              "findings": findings,
              "rules_evaluated": sorted(LOCAL_RULES),
              "rules_fired": sorted({f["rule"] for f in findings}),
              "phases": phase_profile(view.spans)}
    if errors:
        report["errors"] = errors
    return report


def compact_finding(f: dict) -> dict:
    """The bounded projection of a finding that rides ledger records
    and /status.json (full evidence stays with the report). The
    structured `remedy` (D005's rebucket_hint — the scheduling input
    ROADMAP item 2 consumes) rides along, with long key lists
    truncated-and-counted rather than dropped."""
    out = {k: f.get(k) for k in
           ("rule", "name", "severity", "summary", "subject",
            "action", "score") if f.get(k) is not None}
    remedy = fleet.compact_hint(f.get("remedy"))
    if remedy is not None:
        out["remedy"] = remedy
    out["evidence"] = [
        {k: e.get(k) for k in ("series", "field", "indices", "values")
         if e.get(k) is not None}
        for e in (f.get("evidence") or [])[:4]]
    return out


def compact_report(report: dict) -> dict:
    """The `doctor` block /runs/<id>.json attaches."""
    return {"schema": 1, "target": report.get("target"),
            "healthy": bool(report.get("healthy")),
            "rules_fired": report.get("rules_fired") or [],
            "findings": [compact_finding(f) for f in
                         (report.get("findings") or [])
                         [:MAX_FINDINGS_LEDGER]]}


# in-process diagnosis history for /status.json (preflight.snapshot's
# sibling)
_LOCK = threading.Lock()
_RECENT: deque = deque(maxlen=32)
_CHECKED = 0
_LAST_REPORT: Optional[dict] = None


def record_report(report: dict, *, where: str,
                  ledger_name: Optional[str] = None) -> None:
    """Record one diagnosis into the observability planes it audits:
    a `doctor` metrics series point + counter per finding, a
    `kind="doctor"` ledger record (when `ledger_name` names the run),
    and the in-process recent window /status.json serves. Never
    raises — the diagnosis itself outranks its accounting."""
    global _CHECKED, _LAST_REPORT
    findings = report.get("findings") or []
    with _LOCK:
        _CHECKED += 1
        _LAST_REPORT = report
        for f in findings[:8]:
            _RECENT.append(compact_finding(f))
    try:
        from . import metrics as metrics_mod
        mx = metrics_mod.get_default()
        if mx.enabled:
            series = mx.series(
                "doctor", "diagnosis findings from the run doctor "
                          "(rule catalog D001-D016)")
            for f in findings:
                series.append({"rule": f["rule"],
                               "severity": f["severity"],
                               "target": str(report.get("target")),
                               "subject": f.get("subject"),
                               "summary": f["summary"],
                               "where": str(where)})
            mx.counter("doctor_runs_total",
                       "doctor diagnoses performed").inc(
                where=str(where))
            for f in findings:
                mx.counter("doctor_findings_total",
                           "doctor findings by rule").inc(
                    rule=f["rule"], severity=f["severity"])
    except Exception:  # noqa: BLE001
        pass
    if ledger_name:
        try:
            ledger_mod.record({
                "kind": "doctor", "name": str(ledger_name),
                "target": str(report.get("target")),
                "platform": report.get("platform"),
                "where": str(where),
                "healthy": bool(report.get("healthy")),
                "rules": report.get("rules_fired") or [],
                "findings_n": len(findings),
                "findings": [compact_finding(f) for f in
                             findings[:MAX_FINDINGS_LEDGER]],
                "phases": report.get("phases")})
        except Exception:  # noqa: BLE001
            pass


def snapshot() -> dict:
    """The `/status.json` `doctor` block: diagnoses run in this
    process, the severity mix of their findings, and a bounded
    recent-findings window."""
    with _LOCK:
        recent = list(_RECENT)[-8:]
        checked = _CHECKED
        last = _LAST_REPORT
    counts: dict = {}
    for f in recent:
        counts[f["severity"]] = counts.get(f["severity"], 0) + 1
    last_findings = (last.get("findings") or []) if last else []
    return {"checked": checked,
            "findings": counts,
            "healthy_last": (bool(last.get("healthy"))
                             if last else None),
            # the banner line /status renders: the LAST diagnosis's
            # top-ranked finding — None when it diagnosed healthy
            # (the recent window keeps history, but a stale finding
            # must never masquerade as the current verdict)
            "top": (compact_finding(last_findings[0])
                    if last_findings else None),
            "recent": recent}


def last_report() -> Optional[dict]:
    """The most recent in-process diagnosis (None before any)."""
    with _LOCK:
        return _LAST_REPORT


def _reset() -> None:
    """Clear the in-process diagnosis history (test isolation: the
    /doctor panel prefers the last in-process report, and one test's
    diagnosis must not become another's panel)."""
    global _CHECKED, _LAST_REPORT
    with _LOCK:
        _RECENT.clear()
        _CHECKED = 0
        _LAST_REPORT = None


def perfetto_instants(report: dict) -> list:
    """Instant-event annotations for trace.to_perfetto's `instants=`:
    one `{"t", "name"}` per evidence point that carries a wall stamp,
    so the offending rounds light up inside the span/counter view."""
    out: list = []
    for f in report.get("findings") or []:
        label = f"{f['rule']} {f['name']}"
        for ev in f.get("evidence") or []:
            for t in ev.get("t") or []:
                out.append({"t": float(t), "name": label})
                if len(out) >= 64:
                    return out
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def format_report(report: dict) -> str:
    """The human rendering of one report (the CLI's non-JSON path)."""
    lines = [f"doctor: target={report.get('target')} "
             f"platform={report.get('platform')} — "
             + ("HEALTHY (no findings)" if report.get("healthy") else
                f"{len(report.get('findings') or [])} finding(s), "
                f"rules {','.join(report.get('rules_fired') or [])}")]
    for f in report.get("findings") or []:
        subj = f" @ {f['subject']}" if f.get("subject") else ""
        lines.append(f"  [{f['severity']:8s}] {f['rule']} "
                     f"{f['name']}{subj}: {f['summary']}")
        if f.get("action"):
            lines.append(f"{'':14s}-> {f['action']}")
        for ev in (f.get("evidence") or [])[:2]:
            vals = ev.get("values")
            lines.append(f"{'':14s}evidence: {ev.get('series')}."
                         f"{ev.get('field')} idx={ev.get('indices')} "
                         f"values={vals}")
        if f.get("remedy"):
            lines.append(f"{'':14s}remedy: {f['remedy']}")
    ph = report.get("phases")
    if ph:
        lines.append(f"  phases: dominant {ph.get('dominant')!r} "
                     f"({ph.get('dominant_share'):.0%} of traced "
                     "wall)")
    for e in report.get("errors") or []:
        lines.append(f"  rule error: {e}")
    return "\n".join(lines)


def cli_main(options: dict, arguments: Optional[list] = None) -> int:
    """`python -m jepsen_tpu_torch doctor <run_id|latest|bench>` — diagnose
    a recorded run (ledger id or "latest") or the bench round's
    artifacts ("bench"), print (or --json) the ranked findings, and
    bank the diagnosis in the doctor planes. `--watch` re-diagnoses
    whenever the store's ledger index changes (TTL-throttled by
    `--interval`, default 2s); watch passes are read-only — they
    never bank, so their own output cannot re-trigger them — and
    run-id targets share the `/runs/<id>.json` per-record diagnosis
    cache with the web panel (an unchanged record is a dict lookup,
    not a re-read)."""
    target = None
    for a in arguments or []:
        target = a
        break
    target = target or options.get("target") or "bench"
    from .bench import STORE_DIR
    root = options.get("root") or os.getcwd()
    store_root = options.get("store") or os.path.join(root, STORE_DIR)
    if options.get("watch"):
        return _watch(dict(options, no_record=True), target, root,
                      store_root)
    return _cli_once(options, target, root, store_root)


def _cli_once(options: dict, target: str, root: str,
              store_root: str) -> int:
    try:
        if target == "bench":
            view = bench_view(root)
        else:
            view = run_view(store_root, target)
    except KeyError as e:
        print(f"doctor: {e.args[0]}")
        return 254
    report = diagnose(view)
    # bank the diagnosis in the STORE ledger it read from, so the
    # findings are queryable at /runs and the next round's D008 has a
    # phase baseline (--no-record for read-only inspection)
    with ledger_mod.use(ledger_mod.Ledger(store_root)):
        record_report(report, where="cli",
                      ledger_name=None if options.get("no_record")
                      else f"doctor-{target}")
    if options.get("json"):
        print(json.dumps(report, indent=2, default=str))
    else:
        print(format_report(report))
    if options.get("strict") and any(
            f["severity"] in ("critical", "warn")
            for f in report.get("findings") or []):
        return 1
    return 0


def _watch(options: dict, target: str, root: str,
           store_root: str) -> int:
    """The `doctor --watch` loop: poll the store ledger's index
    signature (Ledger.index_signature — the same (mtime_ns, size) key
    the web caches use) and re-diagnose only when it changed AND the
    TTL elapsed; a churning index costs one diagnosis per interval,
    an idle one costs a stat(2) per poll. Ctrl-C exits cleanly."""
    interval = max(0.5, float(options.get("interval") or 2.0))
    led = ledger_mod.Ledger(store_root)
    last_sig: object = ("never",)   # always diagnose the first pass
    last_t = 0.0
    try:
        while True:
            sig = led.index_signature()
            now = time.time()
            if sig != last_sig and (now - last_t) >= interval:
                last_sig, last_t = sig, now
                print(f"-- doctor watch {target} @ "
                      f"{time.strftime('%H:%M:%S')} --")
                if target not in ("bench", "latest") \
                        and not options.get("json"):
                    # an explicit run id rides the /runs/<id>.json
                    # per-record cache shared with the web panel
                    from . import web as web_mod
                    dc = web_mod.doctor_for_record(store_root,
                                                   target)
                    if dc is None:
                        print(f"doctor: no record {target!r} yet")
                    else:
                        print(f"healthy={dc.get('healthy')} "
                              f"rules_fired="
                              f"{dc.get('rules_fired')}")
                        for f in dc.get("findings") or []:
                            print(f"  [{f.get('severity')}] "
                                  f"{f.get('rule')} "
                                  f"{f.get('name')}: "
                                  f"{f.get('summary')}")
                else:
                    _cli_once(options, target, root, store_root)
            time.sleep(min(interval, 0.5))
    except KeyboardInterrupt:
        print("doctor: watch stopped")
        return 0
