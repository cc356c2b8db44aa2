"""Run ledger: durable per-run accounting under the store root.

A jax-free copy of `jepsen_tpu/ledger.py`. Every analysis that banks a
record (the checker service's `kind="service-request"`, Elle's
`kind="elle"`, preflight's top-level `kind="preflight"`, the SLO
engine's `kind="slo"`) appends one compact, atomic record under
`<store_root>/ledger/`, and the records are queryable and aggregable
without touching any run directory.

Layout (all under `<root>/ledger/`):

  records/<id>.json   one pretty-printed record per run, written
                      atomically (tmp + rename) — the source of truth,
                      scannable even if the index is lost
  index.jsonl         one compact line per record, appended under an
                      exclusive flock (single write, O_APPEND) so
                      concurrent writers — service workers, a serve
                      daemon, another process — never tear a line

Record schema (the reference's; `scripts/telemetry_lint.py` reads both
packages' files):

  {"schema": 1, "id": "<utc-ts>-<hex>", "t": <epoch>,
   "kind": ..., "name": <test/config name>, "model": ..., "engine": ...,
   "algorithm": ..., "platform": ..., "verdict": true|false|"unknown",
   "cause": ..., "op_count": ..., "wall_s": ..., "device_s": ...,
   "compiles": ..., "shapes": {"W", "K", "configs_explored"},
   "util": {...}, "telemetry": {"chunks": n, ...}, "stalls": n,
   "artifacts": {"trace": <rel path>, ...}, ...extra}

Zero-cost contract (matching metrics.py / fleet.py): the module
default is a disabled `NULL_LEDGER` whose `record*` methods return
immediately. `service.Service` owns a real one rooted at its store
root; set `JEPSEN_TPU_LEDGER=1` (the port's own root, `BASE_DIR`) or a
path to enable one ambiently.

`web.py` serves the ledger at `/runs.json` (+ `/runs/<id>.json`, and a
`last_runs` block on `/status.json`); `regressions()` flags wall-time
regressions across every recorded run.
"""

from __future__ import annotations

import contextlib
import json
import os
import secrets
import threading
import time
import zlib
from typing import Any, Iterator, Optional

# The port's own store root (`JEPSEN_TPU_LEDGER=1`, and `serve`'s
# default): beside the reference's `store/`, never inside its ledger.
BASE_DIR = os.path.join("store", "torch")
LEDGER_DIR = "ledger"
RECORDS_DIR = "records"
INDEX_FILE = "index.jsonl"
SCHEMA = 1

# index_signature folds a CRC of this many trailing index bytes into
# its change key: an index line is ~100-300 bytes, so the window always
# covers (at least the tail of) the newest append while keeping the
# signature read O(1) regardless of index size.
_SIG_TAIL_BYTES = 256

# Fields promoted from a result dict's util block into the record's
# util summary (the full per-chunk timeseries stays in the run's own
# artifacts; the ledger keeps cross-run comparables only).
_UTIL_KEYS = ("configs_per_s", "rounds", "frontier_fill",
              "memo_hit_rate", "first_call_s", "chunks",
              "backlog_peak", "kernel_s", "compile_s",
              "achieved_tflops", "hbm_peak_measured")


def new_id(t: Optional[float] = None) -> str:
    """Sortable run id: UTC timestamp + random suffix (two records in
    the same second never collide)."""
    ts = time.strftime("%Y%m%dT%H%M%S",
                       time.gmtime(t if t is not None else time.time()))
    return f"{ts}-{secrets.token_hex(4)}"


def _json_safe(obj):
    """Recursively make a value json.dumps-able with default=str:
    stringify dict keys (default= does not apply to keys) and leave
    everything else for the default hook."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def device_seconds(result: dict) -> Optional[float]:
    """Device-seconds actually spent by a result's search: the summed
    per-chunk poll walls when telemetry is on (device compute + packed
    poll transfer — what a tenant would be billed), the Elle kernel
    wall for closure runs, else None (host engines spend no device
    time; an un-instrumented device run can't be attributed)."""
    if not isinstance(result, dict):
        return None
    chunks = (result.get("telemetry") or {}).get("chunks")
    if isinstance(chunks, list) and chunks:
        return round(sum(float(p.get("poll_s") or 0.0)
                         for p in chunks if isinstance(p, dict)), 6)
    util = result.get("util") or {}
    if isinstance(util, dict) and util.get("kernel_s") is not None:
        return round(float(util["kernel_s"]), 6)
    return None


def summarize_result(result: dict) -> dict:
    """The cross-run comparable slice of an analysis result: verdict +
    cause, op count, kernel shapes, a bounded util summary, and the
    telemetry footprint (counts, never the chunk stream itself)."""
    if not isinstance(result, dict):
        return {"verdict": None}
    out: dict = {"verdict": result.get("valid?")}
    for k in ("cause", "op_count", "engine", "platform", "algorithm"):
        if result.get(k) is not None:
            out[k] = result[k]
    shapes = {k: result[k] for k in ("W", "W_pad", "K",
                                     "configs_explored")
              if result.get(k) is not None}
    if shapes:
        out["shapes"] = shapes
    util = result.get("util")
    if isinstance(util, dict):
        u = {k: util[k] for k in _UTIL_KEYS if util.get(k) is not None}
        fleet = util.get("fleet")
        if isinstance(fleet, dict):
            u["fleet"] = {k: fleet.get(k) for k in
                          ("keys", "device_count", "faults",
                           "fallbacks", "straggler_ratio",
                           "work_skew")
                          if fleet.get(k) is not None}
            # the scheduling remedy rides the record (bounded): a
            # record-based diagnosis (doctor D005) must be able to
            # hand back WHICH keys to move, not just that skew exists
            from . import fleet as fleet_mod
            hint = fleet_mod.compact_hint(fleet.get("rebucket_hint"))
            if hint is not None:
                u["fleet"]["rebucket_hint"] = hint
        if u:
            out["util"] = u
    # device-observatory closure (devices.py): the measured HBM block
    # rides the record compactly so cross-run queries can track
    # measured-vs-predicted drift without re-opening run artifacts
    hbm = result.get("hbm")
    if not isinstance(hbm, dict) and isinstance(util, dict):
        hbm = util.get("hbm")
    if isinstance(hbm, dict):
        compact_hbm = {"stats_available":
                       bool(hbm.get("stats_available"))}
        if hbm.get("peak_measured") is not None:
            compact_hbm["peak_measured"] = hbm["peak_measured"]
            out["hbm_peak_measured"] = hbm["peak_measured"]
        if hbm.get("stats_unavailable"):
            compact_hbm["stats_unavailable"] = True
        out["hbm"] = compact_hbm
    chunks = (result.get("telemetry") or {}).get("chunks")
    if isinstance(chunks, list):
        out["telemetry"] = {"chunks": len(chunks)}
    dev_s = device_seconds(result)
    if dev_s is not None:
        out["device_s"] = dev_s
    stall = result.get("stall")
    if isinstance(stall, dict):
        out["stalls"] = 1
    return out


class Ledger:
    """Append/query interface over one `<root>/ledger/` directory.
    Thread- and process-safe for writers (atomic record files + a
    flocked single-write index append); readers tolerate torn or
    foreign lines by skipping them."""

    def __init__(self, root: Optional[str] = None, enabled: bool = True):
        self.enabled = bool(enabled and root)
        self.store_root = root
        self.root = os.path.join(root, LEDGER_DIR) if root else None
        self._lock = threading.Lock()

    # -- paths --------------------------------------------------------
    @property
    def index_path(self) -> Optional[str]:
        return os.path.join(self.root, INDEX_FILE) if self.root else None

    @property
    def records_dir(self) -> Optional[str]:
        return os.path.join(self.root, RECORDS_DIR) if self.root else None

    def record_path(self, run_id: str) -> str:
        return os.path.join(self.records_dir, f"{run_id}.json")

    def index_signature(self) -> Optional[tuple]:
        """The index file's (mtime_ns, size, tail_crc) identity: the
        change-detection key of a ledger-watching cache. None when the
        index does not exist yet — callers treat that as "nothing
        recorded". The tail CRC covers
        the final `_SIG_TAIL_BYTES` bytes: on filesystems with coarse
        mtime granularity two same-size rewrites inside one tick would
        alias under (mtime_ns, size) alone, and the whole point of the
        key is that aliasing means a stale cache. Still O(1): one stat
        plus one bounded read, never a scan of the index."""
        if not self.index_path:
            return None
        try:
            st = os.stat(self.index_path)
        except OSError:
            return None
        tail_crc = 0
        try:
            with open(self.index_path, "rb") as fh:
                if st.st_size > _SIG_TAIL_BYTES:
                    fh.seek(st.st_size - _SIG_TAIL_BYTES)
                tail_crc = zlib.crc32(fh.read(_SIG_TAIL_BYTES))
        except OSError:
            pass  # raced a rotation: (mtime, size) still discriminate
        return (st.st_mtime_ns, st.st_size, tail_crc)

    # -- writing ------------------------------------------------------
    def record(self, entry: dict) -> Optional[str]:
        """Append one run record; returns its id (None when disabled
        or the filesystem declines — accounting never fails a run)."""
        if not self.enabled:
            return None
        t = float(entry.get("t") or time.time())
        rec = {"schema": SCHEMA, "id": entry.get("id") or new_id(t),
               "t": round(t, 3),
               "kind": str(entry.get("kind") or "run"),
               "name": str(entry.get("name") or "unnamed")}
        rec.update({k: v for k, v in entry.items()
                    if k not in ("schema", "id", "t", "kind", "name")})
        try:
            line = json.dumps(rec, default=str)
        except (TypeError, ValueError):
            # default=str does not cover non-string DICT KEYS (json
            # raises regardless); sanitize recursively and retry
            try:
                rec = _json_safe(rec)
                line = json.dumps(rec, default=str)
            except Exception:  # noqa: BLE001 — accounting never
                return None  # fails a run
        try:
            os.makedirs(self.records_dir, exist_ok=True)
            path = self.record_path(rec["id"])
            tmp = f"{path}.tmp.{os.getpid()}.{secrets.token_hex(2)}"
            with open(tmp, "w") as fh:
                json.dump(rec, fh, indent=1, default=str)
            os.replace(tmp, path)
            self._append_index(line)
        except OSError:
            return None
        from . import metrics as _metrics
        mx = _metrics.get_default()
        if mx.enabled:
            mx.counter("ledger_records_total",
                       "run records appended to the ledger").inc(
                kind=rec["kind"])
        return rec["id"]

    def _append_index(self, line: str) -> None:
        """One line, one write(), O_APPEND, under an exclusive flock:
        concurrent writers in this process (the module lock) AND other
        processes (the flock) interleave whole lines only."""
        with self._lock:
            fd = os.open(self.index_path,
                         os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
            try:
                try:
                    import fcntl
                    fcntl.flock(fd, fcntl.LOCK_EX)
                except (ImportError, OSError):
                    pass  # O_APPEND alone still interleaves whole writes
                os.write(fd, (line + "\n").encode())
            finally:
                os.close(fd)

    def record_result(self, kind: str, name: str, result: dict,
                      wall_s: Optional[float] = None, *,
                      model: Optional[str] = None,
                      engine: Optional[str] = None,
                      platform: Optional[str] = None,
                      artifacts: Optional[dict] = None,
                      extra: Optional[dict] = None) -> Optional[str]:
        """Build + append a record from an analysis result dict (the
        `{"valid?": ..., "util": ...}` shape every engine returns)."""
        if not self.enabled:
            return None
        rec = {"kind": kind, "name": name, **summarize_result(result)}
        if wall_s is not None:
            rec["wall_s"] = round(float(wall_s), 4)
        if model is not None:
            rec["model"] = str(model)
        if engine is not None:
            rec.setdefault("engine", str(engine))
        if platform is not None:
            rec.setdefault("platform", str(platform))
        if artifacts:
            rec["artifacts"] = dict(artifacts)
        if extra:
            rec.update(extra)
        return self.record(rec)

    # -- reading ------------------------------------------------------
    def _iter_index(self) -> Iterator[dict]:
        path = self.index_path
        if path and os.path.isfile(path):
            try:
                with open(path) as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            obj = json.loads(line)
                        except ValueError:
                            continue  # torn/foreign line: skip
                        if isinstance(obj, dict):
                            yield obj
                return
            except OSError:
                pass
        # index missing/unreadable: rebuild the view from the record
        # files (the source of truth)
        rd = self.records_dir
        if not rd or not os.path.isdir(rd):
            return
        for fn in sorted(os.listdir(rd)):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(rd, fn)) as fh:
                    obj = json.load(fh)
            except (OSError, ValueError):
                continue
            if isinstance(obj, dict):
                yield obj

    def get(self, run_id: str) -> Optional[dict]:
        """The full record for one id, or None."""
        if not self.records_dir:
            return None
        try:
            with open(self.record_path(str(run_id))) as fh:
                obj = json.load(fh)
        except (OSError, ValueError):
            return None
        return obj if isinstance(obj, dict) else None

    def query(self, *, kind: Optional[str] = None,
              name: Optional[str] = None,
              model: Optional[str] = None,
              engine: Optional[str] = None,
              platform: Optional[str] = None,
              verdict: Any = "__any__",
              since: Optional[float] = None,
              until: Optional[float] = None,
              limit: Optional[int] = None,
              newest_first: bool = False) -> list:
        """Filtered records, time-ordered. `since`/`until` are epoch
        seconds; `verdict` matches exactly (True/False/"unknown");
        `limit` keeps the newest N regardless of sort direction."""
        out = []
        for rec in self._iter_index():
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

    # -- aggregates ---------------------------------------------------
    def aggregate(self, records: Optional[list] = None, **filters
                  ) -> dict:
        """Cross-run aggregates: run count, verdict mix, device-seconds
        per model and per engine, wall-latency quantiles, compile and
        stall totals — ROADMAP item 1's device-seconds accounting."""
        recs = self.query(**filters) if records is None else list(records)
        verdicts: dict = {}
        dev_by_model: dict = {}
        dev_by_engine: dict = {}
        walls: list = []
        compiles = 0
        stalls = 0
        dev_total = 0.0
        for r in recs:
            v = r.get("verdict")
            key = ("true" if v is True else "false" if v is False
                   else str(v))
            verdicts[key] = verdicts.get(key, 0) + 1
            w = r.get("wall_s")
            if isinstance(w, (int, float)):
                walls.append(float(w))
            d = r.get("device_s")
            if isinstance(d, (int, float)):
                dev_total += float(d)
                m = str(r.get("model") or "unknown")
                dev_by_model[m] = round(dev_by_model.get(m, 0.0) + d, 6)
                e = str(r.get("engine") or "unknown")
                dev_by_engine[e] = round(
                    dev_by_engine.get(e, 0.0) + d, 6)
            if isinstance(r.get("compiles"), int):
                compiles += r["compiles"]
            if isinstance(r.get("stalls"), int):
                stalls += r["stalls"]
        walls.sort()

        def q(p: float) -> Optional[float]:
            if not walls:
                return None
            return round(walls[min(len(walls) - 1,
                                   int(p * (len(walls) - 1) + 0.5))], 4)

        return {"runs": len(recs),
                "verdicts": verdicts,
                "device_s": {"total": round(dev_total, 6),
                             "by_model": dev_by_model,
                             "by_engine": dev_by_engine},
                "wall_s": {"total": round(sum(walls), 4),
                           "p50": q(0.50), "p95": q(0.95),
                           "max": walls[-1] if walls else None},
                "compiles": compiles,
                "stalls": stalls}

    def regressions(self, threshold: Optional[float] = None,
                    metric: str = "wall_s", **filters) -> dict:
        """Wall-time regression tracking over every recorded run: group
        by (name, platform), compare each group's latest `metric`
        against the best prior, flag slowdowns beyond `threshold`x
        (default: `regression_threshold()`, env
        JEPSEN_TPU_BENCH_REGRESSION_X). Same-platform only — a cpu run
        next to a cuda run is a hardware change, not a regression."""
        if threshold is None:
            threshold = regression_threshold()
        groups: dict = {}
        for r in self.query(**filters):
            v = r.get(metric)
            if not isinstance(v, (int, float)):
                continue
            groups.setdefault(
                (str(r.get("name")), str(r.get("platform"))),
                []).append((r.get("t") or 0, float(v), r.get("id")))
        out: dict = {"schema": 1, "threshold_x": threshold,
                     "metric": metric, "groups": {}, "regressions": []}
        for (name, plat), rows in sorted(groups.items()):
            rows.sort()
            latest = rows[-1][1]
            priors = [v for _, v, _ in rows[:-1]]
            row = {"platform": plat, "runs": len(rows),
                   "latest": round(latest, 4),
                   "latest_id": rows[-1][2]}
            if priors:
                best = min(priors)
                row["best_prior"] = round(best, 4)
                if best > 0:
                    row["ratio_vs_best"] = round(latest / best, 3)
                    row["regressed"] = wall_regressed(
                        latest, best, threshold)
                    if row["regressed"]:
                        out["regressions"].append(name)
            out["groups"][f"{name}@{plat}"] = row
        return out


# The wall-time regression gate, copied from `jepsen_tpu/drift.py`
# (`regression_threshold`, `wall_regressed`): latest > REGRESSION_X *
# best prior.
REGRESSION_X = 1.5


def regression_threshold(default: float = REGRESSION_X) -> float:
    """The wall-time threshold, env-overridable
    (JEPSEN_TPU_BENCH_REGRESSION_X)."""
    try:
        return float(os.environ.get("JEPSEN_TPU_BENCH_REGRESSION_X",
                                    str(default)))
    except ValueError:
        return default


def wall_regressed(latest: float, best_prior: Optional[float],
                   threshold: Optional[float] = None) -> bool:
    """Is `latest` a regression against the best prior wall?"""
    if best_prior is None or best_prior <= 0:
        return False
    t = regression_threshold() if threshold is None else threshold
    return latest > t * best_prior


def compact(records: list, fields=("id", "kind", "name", "model",
                                   "engine", "platform", "verdict",
                                   "cause", "wall_s", "device_s", "t")
            ) -> list:
    """The bounded projection of records that rides /status.json's
    `last_runs` block (full records stay behind /runs/<id>)."""
    return [{k: r.get(k) for k in fields if r.get(k) is not None}
            for r in records]


NULL_LEDGER = Ledger(root=None, enabled=False)


def _from_env() -> Ledger:
    val = os.environ.get("JEPSEN_TPU_LEDGER", "")
    if val in ("", "0"):
        return NULL_LEDGER
    if val == "1":
        return Ledger(BASE_DIR)
    return Ledger(val)


# Ambient default — a plain module global (NOT thread-local), like
# metrics/fleet: engine threads and fleet workers must see the ledger
# the run installed.
_default: Ledger = _from_env()


def get_default() -> Ledger:
    """The ambient Ledger — NULL_LEDGER unless JEPSEN_TPU_LEDGER was
    set at import or a caller installed one (the service
    owns its own)."""
    return _default


def set_default(led: Optional[Ledger]) -> Ledger:
    global _default
    prev = _default
    _default = led if led is not None else NULL_LEDGER
    return prev


@contextlib.contextmanager
def use(led: Ledger) -> Iterator[Ledger]:
    """Scoped ambient ledger (restores the previous on exit)."""
    prev = set_default(led)
    try:
        yield led
    finally:
        set_default(prev)


def record(entry: dict) -> Optional[str]:
    """Append to the ambient ledger (no-op when disabled)."""
    return _default.record(entry)


def record_result(kind: str, name: str, result: dict,
                  wall_s: Optional[float] = None, **kw) -> Optional[str]:
    """`Ledger.record_result` against the ambient ledger. Never raises
    — accounting must not void an analysis."""
    try:
        return _default.record_result(kind, name, result, wall_s, **kw)
    except Exception:  # noqa: BLE001
        return None
