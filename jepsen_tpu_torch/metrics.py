"""Search telemetry: the metrics registry of the port's checkers.

A jax-free copy of `jepsen_tpu/metrics.py`, the sink that the device
searches' numbers flow into (the packed poll summary of each WGL chunk,
the occupancy ring's rows, the mesh scheduler's actions, Elle's build and
closure, the admission plane's verdicts):

  * `Counter` / `Gauge` / `Histogram` — instruments with label support,
    thread-safe (the competition checker's engine threads record into
    one registry);
  * `Timeseries` — an append-only series of dict points; the WGL
    drivers append one point per device chunk;
  * exporters — JSONL (one line per instrument labelset / series point)
    and Prometheus text exposition. The JSONL line schemas are the
    reference's (`scripts/telemetry_lint.py` reads both packages'
    files).

Zero-cost when disabled: the module default is a `NullRegistry` whose
instruments are shared no-op singletons, and the drivers skip building
points entirely. Enable globally with JEPSEN_TPU_METRICS=1 (the switch
the reference reads, so one environment drives both packages), or
ambiently via `use()` / `set_default()`.

    reg = metrics.Registry()
    with metrics.use(reg):
        res = wgl.check(model, history)
    reg.export_jsonl(path)          # per-chunk timeseries + counters
    reg.prometheus_text()           # scrape-format snapshot
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator, Optional

# Histogram default buckets: poll/kernel latencies span ~100 µs (warm
# cpu fast-path chunks) to minutes (cold accelerator compiles).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                   10.0, 30.0, 60.0, 120.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonic counter, optionally labeled."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: dict = {}

    def inc(self, n: float = 1, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0) + n

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0)

    def samples(self) -> list:
        with self._lock:
            return [(k, v) for k, v in self._values.items()]


class Gauge(Counter):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = v


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound, +Inf implicit)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._states: dict = {}  # label key -> [bucket counts, sum, n]

    def observe(self, v: float, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            st = self._states.get(k)
            if st is None:
                st = self._states[k] = [[0] * len(self.buckets), 0.0, 0]
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    st[0][i] += 1
            st[1] += v
            st[2] += 1

    def count(self, **labels) -> int:
        st = self._states.get(_label_key(labels))
        return st[2] if st else 0

    def sum(self, **labels) -> float:
        st = self._states.get(_label_key(labels))
        return st[1] if st else 0.0

    def samples(self) -> list:
        with self._lock:
            return [(k, [list(st[0]), st[1], st[2]])
                    for k, st in self._states.items()]


class Timeseries:
    """Append-only series of dict points; each point gets a wall-clock
    `t` stamp unless the caller provides one. The WGL drivers append
    one point per device chunk."""

    kind = "series"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._points: list = []

    def append(self, point: dict) -> None:
        p = dict(point)
        p.setdefault("t", time.time())
        with self._lock:
            self._points.append(p)

    @property
    def points(self) -> list:
        with self._lock:
            return list(self._points)

    @property
    def last(self) -> Optional[dict]:
        """The most recent point (None when empty) — the live view a
        status panel or scraper wants without copying the series."""
        with self._lock:
            return dict(self._points[-1]) if self._points else None

    def __len__(self) -> int:
        return len(self._points)

    def trim(self, keep: int) -> int:
        """Drop all but the newest `keep` points; returns how many
        were dropped. Long-lived recorders (the service plane)
        rotate their series with this — bench/test runs never call
        it, so their exports stay complete."""
        with self._lock:
            dropped = max(0, len(self._points) - max(0, int(keep)))
            if dropped:
                del self._points[:dropped]
        return dropped


class _NullInstrument:
    """Shared no-op stand-in for every instrument kind: all recording
    methods swallow their arguments without taking a lock."""

    kind = "null"
    name = help = ""
    buckets = ()
    points: list = []
    last = None

    def inc(self, n: float = 1, **labels) -> None:
        pass

    def set(self, v: float, **labels) -> None:
        pass

    def observe(self, v: float, **labels) -> None:
        pass

    def append(self, point: dict) -> None:
        pass

    def value(self, **labels) -> float:
        return 0

    def count(self, **labels) -> int:
        return 0

    def sum(self, **labels) -> float:
        return 0.0

    def samples(self) -> list:
        return []

    def trim(self, keep: int) -> int:
        return 0

    def __len__(self) -> int:
        return 0


_NULL_INSTRUMENT = _NullInstrument()


class Registry:
    """Thread-safe instrument registry with get-or-create semantics.
    `enabled` is a plain attribute the hot paths read once per call —
    a disabled registry hands out the shared null instrument."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._instruments: dict = {}

    def _get(self, cls, name: str, help: str, **kw):
        if not self.enabled:
            return _NULL_INSTRUMENT
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help, **kw)
            elif type(inst) is not cls:
                # exact-type check: Gauge subclasses Counter, and a
                # counter() call must not silently hand back a gauge
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{inst.kind}, requested {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def series(self, name: str, help: str = "") -> Timeseries:
        return self._get(Timeseries, name, help)

    def instruments(self) -> list:
        with self._lock:
            return list(self._instruments.values())

    # -- exporters ----------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-data view of every instrument (for results/JSON)."""
        out: dict = {}
        for inst in self.instruments():
            if inst.kind in ("counter", "gauge"):
                out[inst.name] = {
                    "kind": inst.kind,
                    "values": {(_label_str(k) or "total"): v
                               for k, v in inst.samples()}}
            elif inst.kind == "histogram":
                out[inst.name] = {
                    "kind": inst.kind, "buckets": list(inst.buckets),
                    "values": {(_label_str(k) or "total"):
                               {"bucket_counts": st[0], "sum": st[1],
                                "count": st[2]}
                               for k, st in inst.samples()}}
            else:
                out[inst.name] = {"kind": "series",
                                  "points": inst.points}
        return out

    def export_jsonl(self, path: str) -> int:
        """One JSON line per counter/gauge/histogram labelset and per
        series point; returns the line count."""
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        n = 0
        with open(path, "w") as fh:
            for inst in self.instruments():
                if inst.kind == "series":
                    for p in inst.points:
                        fh.write(json.dumps(
                            {"type": "sample", "series": inst.name,
                             **p}) + "\n")
                        n += 1
                elif inst.kind == "histogram":
                    for k, st in inst.samples():
                        fh.write(json.dumps(
                            {"type": "histogram", "name": inst.name,
                             "labels": dict(k),
                             "buckets": list(inst.buckets),
                             "bucket_counts": st[0], "sum": st[1],
                             "count": st[2]}) + "\n")
                        n += 1
                else:
                    for k, v in inst.samples():
                        fh.write(json.dumps(
                            {"type": inst.kind, "name": inst.name,
                             "labels": dict(k), "value": v}) + "\n")
                        n += 1
        return n

    def prometheus_text(self) -> str:
        """Prometheus text exposition format. Series export their LAST
        point's numeric fields as `<series>_<field>` gauges — the live
        view a scraper wants; history rides the JSONL exporter."""
        lines: list = []

        def emit(name, kind, help):
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")

        for inst in self.instruments():
            name = _prom_name(inst.name)
            if inst.kind in ("counter", "gauge"):
                emit(name, inst.kind, inst.help)
                for k, v in inst.samples():
                    lines.append(f"{name}{_label_str(k)} {_prom_num(v)}")
            elif inst.kind == "histogram":
                emit(name, "histogram", inst.help)
                for k, st in inst.samples():
                    base = dict(k)
                    for ub, c in zip(inst.buckets, st[0]):
                        lbl = _label_str(_label_key(
                            {**base, "le": _prom_num(ub)}))
                        lines.append(f"{name}_bucket{lbl} {c}")
                    lbl = _label_str(_label_key({**base, "le": "+Inf"}))
                    lines.append(f"{name}_bucket{lbl} {st[2]}")
                    lines.append(f"{name}_sum{_label_str(k)} "
                                 f"{_prom_num(st[1])}")
                    lines.append(f"{name}_count{_label_str(k)} {st[2]}")
            else:
                last = inst.last
                if last is None:
                    continue
                for field, v in sorted(last.items()):
                    if isinstance(v, bool) or not isinstance(
                            v, (int, float)):
                        continue
                    # one TYPE-declared family per derived gauge: a
                    # strict exposition parser requires sample names
                    # to match their declared family
                    fname = f"{name}_{_prom_name(field)}"
                    emit(fname, "gauge",
                         inst.help or "last point of a run timeseries")
                    lines.append(f"{fname} {_prom_num(v)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_prometheus(self, path: str) -> str:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        text = self.prometheus_text()
        with open(path, "w") as fh:
            fh.write(text)
        return path


class NullRegistry(Registry):
    """The disabled registry: hands out the shared null instrument
    from every accessor, exports nothing."""

    def __init__(self):
        super().__init__(enabled=False)


NULL = NullRegistry()


def _prom_name(name: str) -> str:
    return "".join(c if (c.isalnum() or c in "_:") else "_"
                   for c in name)


def _prom_num(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


# -- ambient default registry ------------------------------------------------
# A plain module global (NOT thread-local): the competition checker's
# engine threads must all see the registry the caller installed.
_default: Registry = (
    Registry() if os.environ.get("JEPSEN_TPU_METRICS", "")
    not in ("", "0") else NULL)


def get_default() -> Registry:
    """The ambient registry — NULL unless JEPSEN_TPU_METRICS=1 was set
    at import or a caller installed one via set_default()/use()."""
    return _default


def set_default(reg: Optional[Registry]) -> Registry:
    """Install `reg` (None -> the shared NULL) as the ambient default;
    returns the previous one."""
    global _default
    prev = _default
    _default = reg if reg is not None else NULL
    return prev


@contextlib.contextmanager
def use(reg: Registry) -> Iterator[Registry]:
    """Scoped ambient registry (restores the previous on exit)."""
    prev = set_default(reg)
    try:
        yield reg
    finally:
        set_default(prev)
