"""Fleet observatory: the federated read path over N replicas' stores,
the port of `jepsen_tpu/observatory.py`.

Every observability plane — metrics, trace, ledger, SLO, doctor,
autopilot — sees exactly ONE process. This module federates any set of
store roots into one queryable view, with a hard contract: **zero
writes into any replica's store** — federation is a read path, never a
participant.

The planes, fleet-ified:

  * `FederatedLedger` — tails any set of `<root>/ledger/index.jsonl`
    files, using `Ledger.index_signature` (mtime_ns, size, tail CRC)
    as the per-root change key so an unchanged replica costs one stat
    + one bounded read, never a rescan. Merged records come back in
    the exact `(t, id)` order a single `Ledger.query` uses — a
    one-root federation is record-for-record identical to the local
    read, and `query_with_replica` threads per-replica provenance
    alongside without polluting the records themselves. The cache
    lock is `lockwatch.lock("observatory.cache")`, as in the service
    and the autopilot: a plain `threading.Lock` unless
    JEPSEN_TPU_LOCKWATCH is set, then the lock-order witness.
  * **heartbeats** — every serving process banks periodic
    `kind="replica-heartbeat"` records (`service.Service`: identity,
    cadence, queue depth, served/warm counters, warm-bucket
    inventory, autopilot state); `heartbeats()` reduces them to the
    newest-per-replica liveness map.
  * **fleet SLO** — `slo.Engine.evaluate` is pure over record lists,
    so the fleet report is the SAME engine evaluated over the merged
    `service-request` stream: availability and the latency
    percentiles weight by admitted requests, not by replicas, beside
    a per-replica compact breakdown.
  * **fleet doctor** — D013 replica-down (heartbeat silence past the
    replica's OWN advertised cadence), D014 cross-replica load /
    warm-rate skew, D015 warm-registry divergence (a bucket warm here,
    cold-missing there). Registered in `doctor.RULES`; built here
    because they need N ledgers, which a single-process
    `TelemetryView` never has.
  * **request journeys** — the run id minted at admission rides every
    hop (admit/preflight/queue-wait/search/respond spans and the
    `service` series via `run_id`, warm-dispatch/mesh-batch spans and
    the `service_batch` series via `run_ids`, the ledger record via
    `id`); `journey()` reassembles the cross-process path from the
    replicas' exported `service/{trace,metrics}.jsonl` mirrors, and
    `fleet_perfetto()` merges the spans into one trace with one
    process track per replica.

Surfaces: `/fleet` + `/fleet.json` (web.py), `python -m
jepsen_tpu_torch fleet <roots...|--discover DIR>` (whose default
discovery starts from the port's store root, `store/torch`), the
`fleet` series schema in scripts/telemetry_lint.py, and the
two-replica phase of chip_smoke.py (`fleet_phases`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

from . import doctor as doctor_mod
from . import ledger as ledger_mod
from . import slo as slo_mod
from . import trace as trace_mod
from .analysis import lockwatch

SCHEMA = 1

# D013: a replica is down once its heartbeat silence exceeds this
# multiple of its own advertised cadence (each record carries
# `every_s`, so a slow-beat replica is judged against ITS contract —
# 1.5x means "missed one beat plus slack", within one interval of the
# next expected beat).
DOWN_GAP_X = 1.5

# D014 gates: the fleet must have seen at least this many requests
# before load skew is judged (two requests "skew" infinitely), the
# busiest live replica must carry this multiple of the idlest, and a
# warm-rate verdict needs this many served on BOTH sides of the gap.
SKEW_MIN_REQUESTS = 8
SKEW_LOAD_X = 4.0
WARM_RATE_GAP = 0.5
WARM_RATE_MIN_SERVED = 4

# D015: cap the per-bucket divergence findings (a cold fleet diverges
# on every bucket at once; the first few name the signal).
MAX_DIVERGENCE_FINDINGS = 4

# journey: bound the reassembled hop list (spans + series points) the
# way doctor bounds evidence — journeys are for pointing, the full
# artifacts stay in the replica stores.
MAX_JOURNEY_HOPS = 64

# merged Perfetto export: replicas take process tracks pid 10+i —
# trace.py owns pid 1 (single-process spans), 2 (counters),
# 3 (instants); starting above keeps a merged export composable with
# the single-process lanes.
REPLICA_PID_BASE = 10

# where a serving replica mirrors its in-memory telemetry windows
# (service.Service._export_telemetry) — the observatory's only
# non-ledger reads
SERVICE_DIR = "service"
TRACE_FILE = "trace.jsonl"
METRICS_FILE = "metrics.jsonl"

# env override for the web + CLI surfaces: path-separated list of
# store roots /fleet and `python -m jepsen_tpu_torch fleet` federate
# (else discovery walks around the serving root / the port's store)
FLEET_ROOTS_ENV = "JEPSEN_TPU_FLEET_ROOTS"


def is_store_root(path: str) -> bool:
    """A store root, for federation purposes, is any directory with a
    ledger index under it."""
    return os.path.isfile(os.path.join(
        path, ledger_mod.LEDGER_DIR, ledger_mod.INDEX_FILE))


def discover(root: str) -> list:
    """Store roots under/around `root`: the path itself, its direct
    children, and — so one replica's surface can see its siblings —
    its parent's direct children. Sorted, deduplicated, read-only."""
    seen: dict = {}
    root = os.path.abspath(str(root))
    candidates = [root]
    for base in (root, os.path.dirname(root)):
        try:
            names = sorted(os.listdir(base))
        except OSError:
            continue
        candidates.extend(os.path.join(base, n) for n in names)
    for c in candidates:
        if c not in seen and os.path.isdir(c) and is_store_root(c):
            seen[c] = True
    return list(seen)


def roots_from_env(default_root: Optional[str] = None) -> list:
    """The federation set for the web/CLI surfaces:
    JEPSEN_TPU_FLEET_ROOTS
    (os.pathsep-separated) when set, else discovery around
    `default_root`."""
    raw = os.environ.get(FLEET_ROOTS_ENV)
    if raw:
        return [os.path.abspath(p) for p in raw.split(os.pathsep) if p]
    if default_root:
        return discover(default_root)
    return []


# ---------------------------------------------------------------------------
# FederatedLedger — N index tails, one time-ordered stream
# ---------------------------------------------------------------------------

class FederatedLedger:
    """Read-only merge of N replicas' ledgers.

    Each root's full record list is cached against its
    `index_signature` — the same change key every single-process
    ledger watcher uses — so polling an idle fleet costs one stat +
    one bounded tail read per replica. `query(**filters)` reproduces
    `Ledger.query` semantics (including the `(t, id)` sort and
    newest-N `limit`) over the merged stream; records are returned
    VERBATIM, so one root federates identically to its local read.
    Provenance lives in `query_with_replica`, which pairs each record
    with the replica it came from without mutating it."""

    def __init__(self, roots):
        self.roots: list = []
        for r in roots:
            r = os.path.abspath(str(r))
            if r not in self.roots:
                self.roots.append(r)
        self._ledgers = {r: ledger_mod.Ledger(r) for r in self.roots}
        self._cache: dict = {}  # root -> (signature, [records])
        # one FederatedLedger is shared by every web handler thread
        # (/fleet, /fleet.json, SSE pollers): the signature cache is
        # a plain dict, so its read-check-store must be serialized —
        # a torn (sig, records) pair would alias one root's stale
        # records under another's fresh signature
        self._cache_lock = lockwatch.lock("observatory.cache")

    def signature(self) -> tuple:
        """The fleet-wide change key: per-root index signatures in
        root order — any replica's append changes it."""
        return tuple(self._ledgers[r].index_signature()
                     for r in self.roots)

    def records_for(self, root: str, **filters) -> list:
        """One root's records (filtered, `Ledger.query` semantics),
        from cache when the root's index signature is unchanged."""
        led = self._ledgers[root]
        # signature BEFORE the read (threadlint T007): an append
        # landing between query() and a later signature would alias
        # the stale read under the fresh signature forever; this
        # order merely refreshes one extra time on the next poll
        sig = led.index_signature()
        with self._cache_lock:
            cached = self._cache.get(root)
        if cached is None or sig is None or cached[0] != sig:
            cached = (sig, led.query())
            with self._cache_lock:
                self._cache[root] = cached
        return _apply_filters(cached[1], **filters)

    def query(self, **filters) -> list:
        """Merged records across every root, `Ledger.query`-ordered."""
        return [rec for _, rec in self.query_with_replica(**filters)]

    def query_with_replica(self, **filters) -> list:
        """Merged `(replica_id, record)` pairs in `(t, id)` order —
        the provenance-carrying variant of `query` (records stay
        untouched; the pairing IS the provenance)."""
        limit = filters.pop("limit", None)
        newest_first = filters.pop("newest_first", False)
        out: list = []
        for root in self.roots:
            rep = self.replica_of(root)
            out.extend((rep, rec)
                       for rec in self.records_for(root, **filters))
        out.sort(key=lambda pair: (pair[1].get("t") or 0,
                                   str(pair[1].get("id"))))
        if limit is not None and limit >= 0:
            out = out[-limit:]
        if newest_first:
            out.reverse()
        return out

    def replica_of(self, root: str) -> str:
        """The replica id serving (or last seen serving) a root: its
        newest heartbeat's `replica` field, else the root's basename
        — a never-served store still federates, it just has no
        liveness."""
        hbs = self.records_for(root, kind="replica-heartbeat")
        for rec in reversed(hbs):
            rid = rec.get("replica")
            if rid:
                return str(rid)
        return os.path.basename(root.rstrip(os.sep)) or root

    def latest_heartbeats(self) -> dict:
        """{replica_id: (root, newest heartbeat record)} — roots that
        never beat are keyed by basename with record None."""
        out: dict = {}
        for root in self.roots:
            hbs = self.records_for(root, kind="replica-heartbeat")
            rec = hbs[-1] if hbs else None
            rid = (str(rec.get("replica")) if rec and rec.get("replica")
                   else os.path.basename(root.rstrip(os.sep)) or root)
            prev = out.get(rid)
            if prev is None or (rec or {}).get("t", 0) \
                    > (prev[1] or {}).get("t", 0):
                out[rid] = (root, rec)
        return out


def _apply_filters(records: list, *, kind: Optional[str] = None,
                   name: Optional[str] = None,
                   model: Optional[str] = None,
                   engine: Optional[str] = None,
                   platform: Optional[str] = None,
                   verdict: Any = "__any__",
                   since: Optional[float] = None,
                   until: Optional[float] = None,
                   limit: Optional[int] = None,
                   newest_first: bool = False) -> list:
    """`Ledger.query`'s filter/sort/limit semantics over an in-memory
    record list (the records arrive pre-sorted per root; re-sorting is
    cheap and keeps the contract exact)."""
    out = []
    for rec in records:
        if kind is not None and rec.get("kind") != kind:
            continue
        if name is not None and rec.get("name") != name:
            continue
        if model is not None and rec.get("model") != model:
            continue
        if engine is not None and rec.get("engine") != engine:
            continue
        if platform is not None and rec.get("platform") != platform:
            continue
        if verdict != "__any__" and rec.get("verdict") != verdict:
            continue
        t = rec.get("t")
        if since is not None and (t is None or t < since):
            continue
        if until is not None and (t is None or t > until):
            continue
        out.append(rec)
    out.sort(key=lambda r: (r.get("t") or 0, str(r.get("id"))))
    if limit is not None and limit >= 0:
        out = out[-limit:]
    if newest_first:
        out.reverse()
    return out


# ---------------------------------------------------------------------------
# heartbeats — the liveness map
# ---------------------------------------------------------------------------

def heartbeats(fed: FederatedLedger,
               now: Optional[float] = None) -> dict:
    """{replica_id: summary} from each replica's newest heartbeat:
    identity, age, down verdict (silence past DOWN_GAP_X x the
    replica's own cadence), queue/served counters, warm inventory,
    autopilot state. A root with no heartbeats yet reports
    `down: None` — unknown, not dead."""
    now = now if now is not None else time.time()
    out: dict = {}
    for rid, (root, rec) in fed.latest_heartbeats().items():
        if rec is None:
            out[rid] = {"root": root, "t": None, "age_s": None,
                        "down": None, "every_s": None}
            continue
        t = float(rec.get("t") or 0.0)
        try:
            every = float(rec.get("every_s") or 0.0)
        except (TypeError, ValueError):
            every = 0.0
        if every <= 0:
            every = 2.0
        age = max(0.0, now - t)
        info = {"root": root, "t": t, "age_s": round(age, 3),
                "every_s": every,
                "down": bool(age > DOWN_GAP_X * every),
                "host": rec.get("host"), "pid": rec.get("pid"),
                "devices": rec.get("devices"),
                "workers": rec.get("workers"),
                "queued": rec.get("queued"),
                "submitted": rec.get("submitted"),
                "served": rec.get("served"),
                "rejected": rec.get("rejected"),
                "shed": rec.get("shed"),
                "warm_rate": rec.get("warm_rate"),
                "warm_buckets": list(rec.get("warm_buckets") or []),
                "shedding": rec.get("shedding")}
        if rec.get("autopilot") is not None:
            info["autopilot"] = rec.get("autopilot")
        out[rid] = info
    return out


# ---------------------------------------------------------------------------
# fleet SLO — one engine, merged records
# ---------------------------------------------------------------------------

def fleet_slo(fed: FederatedLedger, now: Optional[float] = None,
              **engine_kw) -> dict:
    """Fleet-level SLO beside the per-replica breakdown. The fleet
    report is `slo.Engine.evaluate` over the MERGED service-request
    stream — each admitted request is one sample, so availability and
    the percentiles weight by traffic, not by replica count — and the
    per-replica reports are the same engine over each root's own
    slice (identical objectives/windows, so the rows compare)."""
    now = now if now is not None else time.time()
    eng = slo_mod.Engine(**engine_kw)
    since = now - max(eng.windows_s)
    merged: list = []
    per: dict = {}
    for root in fed.roots:
        recs = fed.records_for(root, kind="service-request",
                               since=since)
        merged.extend(recs)
        per[fed.replica_of(root)] = slo_mod.compact_report(
            eng.evaluate(now=now, records=recs))
    merged.sort(key=lambda r: (r.get("t") or 0, str(r.get("id"))))
    fleet_report = eng.evaluate(now=now, records=merged)
    return {"fleet": fleet_report,
            "fleet_compact": slo_mod.compact_report(fleet_report),
            "per_replica": per,
            "requests": len(merged)}


# ---------------------------------------------------------------------------
# fleet doctor — D013/D014/D015 over the federated view
# ---------------------------------------------------------------------------

def fleet_findings(hb: dict, now: Optional[float] = None) -> list:
    """Doctor findings over a `heartbeats()` map. Lives here (not in
    `doctor.diagnose`) because the inputs are N replicas' ledgers;
    the findings themselves are ordinary `doctor.finding` dicts, so
    every downstream surface (compact projections, Perfetto instants,
    severity sort) applies unchanged."""
    now = now if now is not None else time.time()
    findings: list = []
    live: dict = {}
    for rid, info in sorted(hb.items()):
        if info.get("down") is True:
            age = float(info.get("age_s") or 0.0)
            every = float(info.get("every_s") or 0.0)
            findings.append(doctor_mod.finding(
                "D013", "critical",
                f"replica {rid} heartbeat silent for {age:.1f}s "
                f"(cadence {every:g}s): down or partitioned",
                subject=rid,
                score=age / max(every, 0.001),
                evidence=[doctor_mod.evidence(
                    "replica-heartbeat", "age_s", [0], [age],
                    t=[info.get("t")] if info.get("t") else None,
                    replica=rid, every_s=every)],
                action=f"queued work on {rid} is stranded: restart "
                       f"the replica or re-route its buckets; its "
                       f"last inventory is the rewarm list"))
        elif info.get("down") is False:
            live[rid] = info
    if len(live) >= 2:
        findings.extend(_skew_findings(live))
        findings.extend(_divergence_findings(live))
    findings.sort(key=lambda f: (-doctor_mod._SEVERITY_RANK[
        f["severity"]], -f["score"], f["rule"]))
    return findings


def _skew_findings(live: dict) -> list:
    """D014: load and warm-rate skew across LIVE replicas (a down
    replica's stale counters are D013's business, not skew)."""
    findings: list = []
    served = {rid: int(info.get("served") or 0)
              for rid, info in live.items()}
    total = sum(served.values())
    if total >= SKEW_MIN_REQUESTS:
        hi = max(served, key=lambda r: served[r])
        lo = min(served, key=lambda r: served[r])
        if served[hi] >= SKEW_LOAD_X * max(served[lo], 1):
            findings.append(doctor_mod.finding(
                "D014", "warn",
                f"load skew: {hi} served {served[hi]} vs {lo} "
                f"{served[lo]} ({served[hi] / max(served[lo], 1):.1f}x"
                f" past the {SKEW_LOAD_X:g}x gate)",
                subject=f"{hi}/{lo}",
                score=served[hi] / max(served[lo], 1),
                evidence=[doctor_mod.evidence(
                    "replica-heartbeat", "served",
                    list(range(len(served))),
                    [served[r] for r in sorted(served)],
                    replicas=sorted(served))],
                action="router affinity is starving a replica: "
                       "rebalance bucket assignment (item 2's "
                       "consistent-hash ring) or retire the idle "
                       "replica"))
    rates = {rid: float(info["warm_rate"]) for rid, info in
             live.items()
             if isinstance(info.get("warm_rate"), (int, float))
             and int(info.get("served") or 0) >= WARM_RATE_MIN_SERVED}
    if len(rates) >= 2:
        hi = max(rates, key=lambda r: rates[r])
        lo = min(rates, key=lambda r: rates[r])
        gap = rates[hi] - rates[lo]
        if gap > WARM_RATE_GAP:
            findings.append(doctor_mod.finding(
                "D014", "warn",
                f"warm-rate skew: {hi} at {rates[hi]:.0%} vs {lo} at "
                f"{rates[lo]:.0%} — cold traffic is concentrating on "
                f"{lo}",
                subject=f"{hi}/{lo}",
                score=gap,
                evidence=[doctor_mod.evidence(
                    "replica-heartbeat", "warm_rate",
                    list(range(len(rates))),
                    [rates[r] for r in sorted(rates)],
                    replicas=sorted(rates))],
                action=f"rewarm {lo}'s buckets from the shared plan "
                       f"registry (aot service-plan entries) or give "
                       f"the router same-bucket affinity"))
    return findings


def _divergence_findings(live: dict) -> list:
    """D015: a bucket warm on some live replicas and missing from
    others — exactly the plan-steal / rewarm signal `fleet.steal_plan`
    generalizes to replicas in ROADMAP item 2."""
    findings: list = []
    inventory = {rid: set(info.get("warm_buckets") or [])
                 for rid, info in live.items()}
    union: set = set()
    for buckets in inventory.values():
        union |= buckets
    diverged = sorted(
        b for b in union
        if any(b not in inv for inv in inventory.values()))
    for bucket in diverged[:MAX_DIVERGENCE_FINDINGS]:
        have = sorted(r for r, inv in inventory.items() if bucket in inv)
        cold = sorted(r for r, inv in inventory.items()
                      if bucket not in inv)
        findings.append(doctor_mod.finding(
            "D015", "info",
            f"warm divergence: bucket {bucket} warm on "
            f"{', '.join(have)} but cold on {', '.join(cold)}",
            subject=bucket,
            score=len(cold) / max(len(inventory), 1),
            evidence=[doctor_mod.evidence(
                "replica-heartbeat", "warm_buckets",
                list(range(len(have) + len(cold))),
                [1] * len(have) + [0] * len(cold),
                replicas=have + cold, bucket=bucket)],
            action=f"rewarm {bucket} on {', '.join(cold)} from the "
                   f"shared service-plan registry before the router "
                   f"sends it cold traffic"))
    if len(diverged) > MAX_DIVERGENCE_FINDINGS:
        findings.append(doctor_mod.finding(
            "D015", "info",
            f"warm divergence on {len(diverged)} buckets total "
            f"(first {MAX_DIVERGENCE_FINDINGS} itemized)",
            subject="fleet", score=float(len(diverged))))
    return findings


# ---------------------------------------------------------------------------
# request journeys — one id across processes
# ---------------------------------------------------------------------------

def _service_file(root: str, fname: str) -> str:
    return os.path.join(root, SERVICE_DIR, fname)


def _span_run_ids(span: dict):
    attrs = span.get("attributes") or {}
    ids = []
    if attrs.get("run_id"):
        ids.append(str(attrs["run_id"]))
    for rid in attrs.get("run_ids") or []:
        ids.append(str(rid))
    return ids


def journey(fed: FederatedLedger, run_id: str,
            now: Optional[float] = None) -> dict:
    """Reassemble one request's cross-process journey: every span and
    series point carrying its id (the replicas' exported
    `service/{trace,metrics}.jsonl` mirrors) plus its ledger record,
    merged time-ordered with per-hop replica provenance. `complete`
    means the journey spans admission through the banked verdict —
    the property chip_smoke's fleet phase gates on."""
    run_id = str(run_id)
    hops: list = []
    record = None
    record_replica = None
    for root in fed.roots:
        rep = fed.replica_of(root)
        for rec in fed.records_for(root):
            if str(rec.get("id")) == run_id:
                record, record_replica = rec, rep
                hops.append({
                    "replica": rep, "type": "record",
                    "name": rec.get("kind"),
                    "t": float(rec.get("t") or 0.0),
                    "verdict": rec.get("verdict"),
                    "bucket": rec.get("bucket"),
                    "wall_s": rec.get("wall_s")})
        for sp in doctor_mod.load_spans_jsonl(
                _service_file(root, TRACE_FILE)):
            if run_id not in _span_run_ids(sp):
                continue
            t0 = float(sp.get("startTimeUnixNano") or 0) / 1e9
            end = sp.get("endTimeUnixNano")
            hops.append({
                "replica": rep, "type": "span",
                "name": str(sp.get("name")), "t": t0,
                "dur_s": (round(float(end) / 1e9 - t0, 6)
                          if end else None),
                "trace_id": sp.get("traceId")})
        series = doctor_mod.load_series_jsonl(
            _service_file(root, METRICS_FILE))
        for sname in ("service", "service_batch"):
            for pt in series.get(sname) or []:
                pt_ids = [str(pt["run_id"])] if pt.get("run_id") \
                    else [str(x) for x in pt.get("run_ids") or []]
                if run_id not in pt_ids:
                    continue
                hops.append({
                    "replica": rep, "type": "series",
                    "name": sname,
                    "t": float(pt.get("t") or 0.0),
                    "verdict": pt.get("verdict"),
                    "mode": pt.get("mode"),
                    "bucket": pt.get("bucket")})
    hops.sort(key=lambda h: (h.get("t") or 0.0, h["type"]))
    span_names = {h["name"] for h in hops if h["type"] == "span"}
    return {"run_id": run_id,
            "found": bool(hops),
            "replica": record_replica,
            "verdict": (record or {}).get("verdict"),
            "complete": bool(record is not None
                             and "admit" in span_names
                             and "respond" in span_names),
            "hops": hops[:MAX_JOURNEY_HOPS],
            "n_hops": len(hops)}


def fleet_perfetto(fed: FederatedLedger,
                   path: Optional[str] = None) -> dict:
    """One merged Perfetto document: each replica's exported spans on
    its own process track (pid REPLICA_PID_BASE+i, named
    "replica <id>"), so a cross-process journey renders as aligned
    lanes. Writing `path` is the CALLER's output — never a replica
    store."""
    events: list = []
    for i, root in enumerate(fed.roots):
        rep = fed.replica_of(root)
        spans = doctor_mod.load_spans_jsonl(
            _service_file(root, TRACE_FILE))
        if spans:
            events.extend(trace_mod.perfetto_events(
                spans, service=f"replica {rep}",
                pid=REPLICA_PID_BASE + i))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path:
        with open(path, "w") as fh:
            json.dump(doc, fh)
    return doc


# ---------------------------------------------------------------------------
# the fleet snapshot — /fleet.json and the CLI's one payload
# ---------------------------------------------------------------------------

def fleet_snapshot(roots, now: Optional[float] = None,
                   mx=None) -> dict:
    """The whole federated view as one JSON-able dict: liveness map,
    fleet + per-replica SLO, D013-D015 findings. Read-only over every
    root; the optional `mx` (an EXPLICITLY passed registry — never
    the ambient default, federation must not write into a serving
    process's planes by accident) gets one `fleet` series point per
    snapshot."""
    now = now if now is not None else time.time()
    fed = roots if isinstance(roots, FederatedLedger) \
        else FederatedLedger(roots)
    hb = heartbeats(fed, now=now)
    slo_block = fleet_slo(fed, now=now)
    findings = fleet_findings(hb, now=now)
    down = sorted(r for r, i in hb.items() if i.get("down") is True)
    snap = {"schema": SCHEMA, "t": round(now, 3),
            "roots": list(fed.roots),
            "replicas": hb,
            "live": sum(1 for i in hb.values()
                        if i.get("down") is False),
            "down": down,
            "requests": slo_block["requests"],
            "slo": {"fleet": slo_block["fleet_compact"],
                    "per_replica": slo_block["per_replica"]},
            "rules_evaluated": ["D013", "D014", "D015"],
            "rules_fired": sorted({f["rule"] for f in findings}),
            "findings": [doctor_mod.compact_finding(f)
                         for f in findings]}
    if mx is not None and getattr(mx, "enabled", False):
        try:
            mx.series(
                "fleet",
                "federated fleet snapshots from the observatory "
                "(doc/OBSERVABILITY.md \"Fleet plane\")").append({
                    "replicas": len(hb), "live": snap["live"],
                    "down": len(down),
                    "requests": int(snap["requests"]),
                    "findings": len(findings)})
        except Exception:  # noqa: BLE001
            pass
    return snap


# ---------------------------------------------------------------------------
# CLI — python -m jepsen_tpu_torch fleet <roots...|--discover root>
# ---------------------------------------------------------------------------

def _fmt_rate(v) -> str:
    return f"{float(v):.0%}" if isinstance(v, (int, float)) else "-"


def render_text(snap: dict) -> str:
    lines = [f"fleet: {len(snap['replicas'])} replica(s), "
             f"{snap['live']} live, {len(snap['down'])} down, "
             f"{snap['requests']} request(s) in window"]
    for rid, info in sorted(snap["replicas"].items()):
        state = ("DOWN" if info.get("down") is True
                 else "live" if info.get("down") is False else "?")
        lines.append(
            f"  {rid:24s} {state:4s} queued={info.get('queued', '-')} "
            f"served={info.get('served', '-')} "
            f"warm={_fmt_rate(info.get('warm_rate'))} "
            f"buckets={len(info.get('warm_buckets') or [])} "
            f"age={info.get('age_s', '-')}s")
    fleet_slo_c = (snap.get("slo") or {}).get("fleet")
    if fleet_slo_c:
        met = fleet_slo_c.get("met")
        lines.append(f"  slo: met={met} "
                     f"alerts={fleet_slo_c.get('alerts') or []}")
    for f in snap.get("findings") or []:
        lines.append(f"  [{f['rule']} {f['severity']}] {f['summary']}")
    if not snap.get("findings"):
        lines.append("  no fleet findings")
    return "\n".join(lines)


def cli_main(opts: dict, args: list) -> int:
    """`python -m jepsen_tpu_torch fleet` — federate the given roots
    (else --discover/--store-root discovery, else the same
    JEPSEN_TPU_FLEET_ROOTS-or-discovery resolution the web surface
    uses, around the port's store root `ledger.BASE_DIR` where the
    reference starts from `./store`) and print the snapshot; --journey
    reassembles one request, --perfetto writes the merged trace."""
    roots = [os.path.abspath(a) for a in args]
    if not roots:
        base = opts.get("discover") or opts.get("store_root")
        if base:
            roots = discover(base)
        else:
            roots = roots_from_env(os.path.join(os.getcwd(),
                                                ledger_mod.BASE_DIR))
    if not roots:
        print("fleet: no store roots found (pass roots or "
              "--discover <parent>)")
        return 2
    fed = FederatedLedger(roots)
    rid = opts.get("journey")
    if rid:
        doc = journey(fed, rid)
        print(json.dumps(doc, indent=1, default=str))
        return 0 if doc["found"] else 1
    snap = fleet_snapshot(fed)
    out = opts.get("perfetto")
    if out:
        doc = fleet_perfetto(fed, path=out)
        snap["perfetto"] = {"path": out,
                            "events": len(doc["traceEvents"])}
    if opts.get("json"):
        print(json.dumps(snap, indent=1, default=str))
    else:
        print(render_text(snap))
        if out:
            print(f"  perfetto: {out} "
                  f"({snap['perfetto']['events']} events)")
    return 0
