"""Device observatory: live memory accounting of the port's cards.

A port of `jepsen_tpu/devices.py` onto PyTorch's CUDA caching allocator:

  * **`DeviceMonitor`** samples each card's allocator on the existing
    poll cadences (the WGL chunk poll, the mesh poll, the Elle closure
    call): `torch.cuda.memory_stats` (`allocated_bytes.all.current`
    as bytes_in_use, `allocated_bytes.all.peak` as peak_bytes_in_use)
    and the card's `total_memory` as bytes_limit. These are host-side
    allocator queries: nothing here synchronises the card or asks the
    driver for free memory. A CPU device has no allocator stats and
    gives the reference's explicit `stats_unavailable` marker, never a
    guess. A caller names the devices of its search (`devices=`, each
    card once however many shards it holds); by default the monitor
    reads every card once CUDA is initialised, else the CPU.
  * **measured against predicted** — `mark()` / `measured()` bracket
    a search (`mark` resets each card's allocator peak through
    `reset_peak`, which the admission CLI's measurement shares), so its
    result carries `hbm_peak_measured` beside preflight's analytic
    bill; `drift_x` / `drift_regressed` are the reference's gate.
  * **budget** — `measured_bytes_limit()` is the smallest card's
    memory.

Telemetry lands in the reference's two series: `hbm` (one point per
card per poll) and `device_poll` (one point per poll).

Zero-cost contract: the ambient default is a disabled `NULL_MONITOR`
whose `sample()` returns at once; JEPSEN_TPU_DEVICES=1 (the reference's
switch) enables one ambiently.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Optional

import torch

# Measured-vs-predicted drift gate: a search whose measured peak lands
# more than this factor away from preflight's analytic bill (either
# direction) is flagged.
HBM_DRIFT_X = 1.25

# Sampling throttle: small searches poll at a few hundred Hz; per-poll
# resolution of a *memory* series is noise. ~20 Hz keeps every real
# poll cadence fully sampled.
MIN_INTERVAL_S = 0.05

_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
_TOTAL: dict = {}


def _as_device(dev):
    """A `torch.device` for a device or its name; any other object (a
    stand-in with `memory_stats()`) as it is."""
    if isinstance(dev, str):
        return torch.device(dev)
    return dev


def reset_peak(dev) -> int:
    """Start a peak window on a CUDA device: reset its allocator's peak
    and return the bytes allocated now (the window's baseline). 0 for
    any other device."""
    dev = _as_device(dev)
    if not isinstance(dev, torch.device) or dev.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats(dev)
    return int(torch.cuda.memory_allocated(dev))


def bytes_limit(dev: torch.device) -> int:
    """A CUDA device's total memory, read once a card."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _TOTAL:
        _TOTAL[idx] = int(torch.cuda.get_device_properties(idx).total_memory)
    return _TOTAL[idx]


def read_memory_stats(dev) -> Optional[dict]:
    """{bytes_in_use, peak_bytes_in_use, bytes_limit} of one device, or
    None where there are no allocator stats. A CUDA `torch.device`:
    the caching allocator's `memory_stats` (current and peak allocated
    bytes) and the card's total memory. The CPU: None (the explicit
    no-stats path). Any other object is read as the reference reads a
    device, through its `memory_stats()` dict (the tests' stand-ins)."""
    dev = _as_device(dev)
    if isinstance(dev, torch.device):
        if dev.type != "cuda":
            return None
        ms = torch.cuda.memory_stats(dev)
        return {"bytes_in_use": int(ms.get("allocated_bytes.all.current",
                                           0)),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak",
                                                0)),
                "bytes_limit": bytes_limit(dev)}
    try:
        ms = dev.memory_stats()
    except Exception:  # noqa: BLE001 — a stand-in may raise instead
        return None
    if not isinstance(ms, dict):
        return None
    out = {}
    for k in _STAT_KEYS:
        v = ms.get(k)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = int(v)
    return out or None


def _kind(dev) -> Optional[str]:
    if isinstance(dev, torch.device):
        return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else dev.type)
    return getattr(dev, "device_kind", None)


def default_device_list() -> list:
    """Every card once CUDA is initialised in this process (a host-side
    check: the monitor never initialises CUDA), else the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def distinct(devices) -> list:
    """A device list with each device once, in order (shards that share
    a card are sampled once)."""
    out: list = []
    for d in devices:
        d = _as_device(d)
        if d not in out:
            out.append(d)
    return out


class DeviceMonitor:
    """Per-device memory sampler over the existing poll cadences.
    Thread-safe: streamed fan-out workers and the mesh poll loop share
    one ambient monitor, and concurrent searches each bracket their own
    `mark()`/`measured()` window.

    `devices` pins an explicit device list (tests use stand-ins with a
    `memory_stats()` dict); each call may name its own (`devices=`, the
    search's devices); the default is `default_device_list()`."""

    def __init__(self, enabled: bool = True, devices=None,
                 min_interval_s: float = MIN_INTERVAL_S):
        self.enabled = bool(enabled)
        self._devices = list(devices) if devices is not None else None
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._last: dict = {}       # label -> last per-device stat
        self._order: list = []      # stable label order
        self._peak_seen: dict = {}  # label -> max bytes_in_use sampled
        self._marks: list = []      # open measurement windows
        self._polls = 0
        self._last_t = 0.0

    # -- device list --------------------------------------------------
    def _device_list(self, devices=None) -> list:
        if devices is not None:
            return distinct(devices)
        if self._devices is not None:
            return self._devices
        return default_device_list()

    # -- sampling -----------------------------------------------------
    def sample(self, where: str = "poll", force: bool = False,
               mx=None, devices=None) -> list:
        """One poll over `devices` (each once; default the monitor's
        list: its pinned devices, else `default_device_list()`). Returns
        the per-device
        stat dicts ([] when disabled, deviceless, or throttled) and
        records them into the ambient metrics registry (`hbm` series
        per stats-reporting device + one `device_poll` point). The
        throttle keeps sub-`min_interval_s` poll loops from turning a
        memory series into noise; `force=True` (mark/measured
        boundaries) always samples."""
        if not self.enabled:
            return []
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_t < self.min_interval_s:
                return []
            self._last_t = now
        devs = self._device_list(devices)
        if not devs:
            return []
        from . import fleet as _fleet
        stats = []
        for i, d in enumerate(devs):
            label = _fleet.device_label(d)
            ms = read_memory_stats(d)
            stat = {"device": label, "index": i, "kind": _kind(d),
                    "stats": ms is not None}
            if ms:
                stat.update(ms)
            stats.append(stat)
        with self._lock:
            self._polls += 1
            for stat in stats:
                label = stat["device"]
                if label not in self._last:
                    self._order.append(label)
                self._last[label] = stat
                biu = stat.get("bytes_in_use")
                if biu is not None:
                    self._peak_seen[label] = max(
                        self._peak_seen.get(label, 0), biu)
                    for mk in self._marks:
                        w = mk["win_max"]
                        w[label] = max(w.get(label, 0), biu)
        self._record(stats, where, mx=mx)
        return stats

    def _record(self, stats: list, where: str, mx=None) -> None:
        from . import metrics as _metrics
        mx = mx if mx is not None else _metrics.get_default()
        if not mx.enabled:
            return
        avail = [s for s in stats if s["stats"]]
        series = mx.series(
            "hbm", "per-device memory accounting sampled at existing "
                   "poll boundaries (bytes_in_use / peak / limit)")
        for s in avail:
            # the linted point schema requires bytes_in_use — a
            # backend reporting only exotic stat keys stays in the
            # device_poll envelope, never a malformed series point
            if s.get("bytes_in_use") is not None:
                series.append(dict(s))
        mx.series(
            "device_poll",
            "one point per device-observatory poll: where it sampled "
            "and how many devices reported stats").append({
                "where": str(where),
                "n_devices": len(stats),
                "stats_available": len(avail),
                "bytes_in_use_total": sum(
                    s.get("bytes_in_use") or 0 for s in avail),
            })
        mx.counter("device_polls_total",
                   "device-observatory sampling polls").inc(
            where=str(where))

    # -- measurement windows ------------------------------------------
    def mark(self, where: str = "mark", devices=None) -> Optional[dict]:
        """Open a measurement window (each card's allocator peak reset
        through `reset_peak`, then one unthrottled sample): the returned
        token accumulates each device's max bytes_in_use over later
        samples until `measured()` closes it. None when disabled —
        callers keep a `None` token and skip `measured`. A window opened
        while another is open resets the peak the other reads; the
        other then falls back to its sampled high-water."""
        if not self.enabled:
            return None
        for d in self._device_list(devices):
            reset_peak(d)
        labels = [s["device"] for s in
                  self.sample(where=where, force=True, devices=devices)]
        with self._lock:
            token = {
                "t0": time.monotonic(),
                "polls0": self._polls,
                "peak0": {lb: (self._last[lb].get("peak_bytes_in_use"))
                          for lb in labels},
                "win_max": {lb: (self._last[lb].get("bytes_in_use")
                                 or 0)
                            for lb in labels
                            if self._last[lb]["stats"]},
            }
            self._marks.append(token)
            del self._marks[:-64]  # bounded: leaked windows expire
        return token

    def measured(self, token: Optional[dict], where: str = "measured",
                 devices=None) -> dict:
        """Close a window: one final sample, then the per-window HBM
        block. Per device, `peak_measured` is the allocator's own
        `peak_bytes_in_use` when it GREW inside the window (the new
        high belongs to this window), else the max `bytes_in_use`
        observed at the window's samples — a sampled lower bound,
        honest about being one. Without stats (a CPU search) the block
        is the explicit `stats_unavailable` marker."""
        if not self.enabled or token is None:
            return {"schema": 1, "stats_available": False,
                    "stats_unavailable": True, "peak_measured": None,
                    "devices": {}, "samples": 0}
        self.sample(where=where, force=True, devices=devices)
        with self._lock:
            with contextlib.suppress(ValueError):
                self._marks.remove(token)
            per_dev: dict = {}
            peaks: list = []
            for label in token["peak0"]:    # the window's own devices
                last = self._last.get(label) or {}
                if not last.get("stats"):
                    continue
                peak0 = token["peak0"].get(label)
                peak_now = last.get("peak_bytes_in_use")
                win = token["win_max"].get(
                    label, last.get("bytes_in_use") or 0)
                if peak_now is not None and (peak0 is None
                                             or peak_now > peak0):
                    pm = max(peak_now, win)
                else:
                    pm = win
                per_dev[label] = {
                    "bytes_in_use": last.get("bytes_in_use"),
                    "peak_bytes_in_use": peak_now,
                    "bytes_limit": last.get("bytes_limit"),
                    "peak_measured": int(pm),
                }
                peaks.append(int(pm))
            # samples taken INSIDE this window — the lifetime poll
            # count would overstate a short window's coverage by
            # whatever the monitor did before it
            samples = self._polls - int(token.get("polls0", 0))
        out = {"schema": 1,
               "stats_available": bool(per_dev),
               "peak_measured": max(peaks) if peaks else None,
               "devices": per_dev,
               "samples": samples}
        if not per_dev:
            out["stats_unavailable"] = True
        return out

    # -- readers ------------------------------------------------------
    def snapshot(self) -> dict:
        """The status `hbm` block: last per-device stats, the run-wide
        sampled peaks, and how much of the fleet reports stats."""
        with self._lock:
            devices = {}
            for label in self._order:
                last = dict(self._last.get(label) or {})
                last.pop("device", None)
                ps = self._peak_seen.get(label)
                if ps is not None:
                    last["peak_seen"] = ps
                    limit = last.get("bytes_limit")
                    if limit:
                        last["utilization"] = round(
                            (last.get("bytes_in_use") or 0) / limit, 4)
                devices[label] = last
            avail = sum(1 for d in devices.values() if d.get("stats"))
            peaks = [d["peak_seen"] for d in devices.values()
                     if d.get("peak_seen") is not None]
            return {"active": bool(self.enabled and self._polls),
                    "polls": self._polls,
                    "n_devices": len(devices),
                    "stats_available": avail,
                    "peak_seen_bytes": max(peaks) if peaks else None,
                    "devices": devices}


def drift_x(measured, predicted) -> Optional[float]:
    """measured / predicted, guarded — the ONE place the drift ratio is
    computed."""
    if not measured or not predicted:
        return None
    return round(float(measured) / float(predicted), 4)


def drift_regressed(ratio: Optional[float],
                    threshold: float = HBM_DRIFT_X) -> bool:
    """Is a measured-vs-predicted ratio outside the gate, either way?"""
    if ratio is None:
        return False
    return ratio > threshold or ratio < 1.0 / threshold


def measured_bytes_limit() -> Optional[int]:
    """The cards' own reported memory: min `bytes_limit` across
    stats-reporting devices (min — a plan must fit the SMALLEST card it
    may land on), or None when no device reports one (the CPU, or CUDA
    not initialised yet). Reads the ambient monitor's device list when
    one is installed (tests pin stand-ins through it), else
    `default_device_list()`."""
    mon = get_default()
    devs = mon._device_list() if mon.enabled else default_device_list()
    limits = []
    for d in devs:
        ms = read_memory_stats(d)
        if ms and ms.get("bytes_limit"):
            limits.append(int(ms["bytes_limit"]))
    return min(limits) if limits else None


NULL_MONITOR = DeviceMonitor(enabled=False)


def snapshot() -> dict:
    """The ambient monitor's status block (inactive stub when
    disabled)."""
    return get_default().snapshot()


# -- ambient default ---------------------------------------------------------
# A plain module global (NOT thread-local), like metrics and fleet:
# streamed workers and engine threads must see the monitor the run
# installed.
_default: DeviceMonitor = (
    DeviceMonitor() if os.environ.get("JEPSEN_TPU_DEVICES", "")
    not in ("", "0") else NULL_MONITOR)


def get_default() -> DeviceMonitor:
    """The ambient DeviceMonitor — NULL_MONITOR unless
    JEPSEN_TPU_DEVICES=1 was set at import or a caller installed one."""
    return _default


def set_default(mon: Optional[DeviceMonitor]) -> DeviceMonitor:
    global _default
    prev = _default
    _default = mon if mon is not None else NULL_MONITOR
    return prev


@contextlib.contextmanager
def use(mon: DeviceMonitor) -> Iterator[DeviceMonitor]:
    """Scoped ambient monitor (restores the previous on exit)."""
    prev = set_default(mon)
    try:
        yield mon
    finally:
        set_default(prev)
