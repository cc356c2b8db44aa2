"""Fleet helpers of the per-key fan-out: the pure host arithmetic that
per-key results carry.

A jax-free copy of `jepsen_tpu/fleet.py:83-418`: `device_label`,
`fault_event`, `rebucket_hint`, `steal_plan`, `compact_hint`,
`record_sched_event` and `summarize`, which `parallel.batched`,
`parallel.mesh` and `independent` stamp onto their results (`shard`
blocks, `util.fleet`, the mesh summary) and call between polls (the
steal plans). The reference's live `RunStatus`, metrics registry and
lock watch are its telemetry plane and are not part of the port yet:
`record_sched_event` keeps the scheduler's actions in a bounded list
in memory instead of a metrics series.
"""

from __future__ import annotations

import threading
import traceback
from collections import deque
from typing import Optional

# Bound on a fault event's traceback text.
FAULT_TB_LIMIT = 4000

# Scheduler events kept in memory (`sched_events`), newest last.
SCHED_EVENT_CAP = 1024


def device_label(dev) -> str:
    """A stable short label for a device (`torch.device` or any
    stand-in)."""
    try:
        return str(dev)
    except Exception:  # noqa: BLE001 — a label must never raise
        return "device-?"


def device_labels(devices) -> list:
    """`device_label` of each entry of a device list, with a repeated
    entry made distinct by its occurrence (`cuda:0`, `cuda:0#1`,
    `cuda:0#2`, ...), so that shards sharing one device keep their
    per-shard stats and steal plans apart."""
    seen: dict = {}
    out = []
    for d in devices:
        label = device_label(d)
        k = seen.get(label, 0)
        seen[label] = k + 1
        out.append(label if k == 0 else f"{label}#{k}")
    return out


_SCHED_LOCK = threading.Lock()
_SCHED: deque = deque(maxlen=SCHED_EVENT_CAP)


def record_sched_event(series: str, point: dict) -> None:
    """One scheduler action (a steal or rebucket of the mesh scheduler,
    series "mesh_sched", or a rebalance of the streamed worker pool,
    series "fleet_sched"), kept in memory with its series name."""
    with _SCHED_LOCK:
        _SCHED.append(dict(point, series=series))


def sched_events(series: Optional[str] = None) -> list:
    """The scheduler events recorded so far (at most SCHED_EVENT_CAP,
    oldest dropped first), of one series or all."""
    with _SCHED_LOCK:
        return [dict(p) for p in _SCHED
                if series is None or p["series"] == series]


def fault_event(exc: BaseException, *, device: Optional[str] = None,
                key_index: Optional[int] = None,
                stage: str = "device-worker",
                context: Optional[dict] = None) -> dict:
    """A device fault as a structured fleet event: type, message, the
    worker traceback (bounded), and where it happened — instead of the
    old `f"error: {e}"` string that threw the stack away. `context`
    merges extra attribution keys into the event; the envelope keys
    always win."""
    out = dict(context or {})
    out.update({"type": type(exc).__name__,
                "error": str(exc)[:300],
                "stage": stage,
                "device": device,
                "key_index": key_index,
                "traceback": traceback.format_exc()[-FAULT_TB_LIMIT:]})
    return out


# Work-skew past this ratio (busiest vs laziest device wall) makes
# summarize() emit a rebucket_hint — below it, moving keys would churn
# the shape buckets for noise-level gains.
REBUCKET_SKEW_X = 1.2


def rebucket_hint(shards: list) -> Optional[dict]:
    """The scheduling signal a multi-device fan-out consumes: which keys to move from the busiest device to the
    laziest one to flatten the work skew. Greedy smallest-keys-first
    from the busiest device until the two walls would cross; None
    when the fleet is <2 devices or already balanced. NB the gate is
    busiest-vs-LAZIEST wall (the pair a move actually rebalances) at
    REBUCKET_SKEW_X — intentionally sharper than summarize()'s
    `work_skew` (busiest vs MEAN), so a hint can appear while
    work_skew still reads under 1.2. Pure host arithmetic over the
    shard blocks the fan-out already stamps."""
    by_dev: dict = {}
    for s in shards:
        if not isinstance(s, dict):
            continue
        dev = str(s.get("device", "host"))
        by_dev.setdefault(dev, []).append(
            (float(s.get("wall_s") or 0.0), s.get("key_index")))
    if len(by_dev) < 2:
        return None
    walls = {d: sum(w for w, _ in ks) for d, ks in by_dev.items()}
    busiest = max(walls, key=lambda d: walls[d])
    laziest = min(walls, key=lambda d: walls[d])
    w_hi, w_lo = walls[busiest], walls[laziest]
    if w_lo <= 0 and w_hi <= 0:
        return None
    skew_before = round(w_hi / max(w_lo, 1e-9), 3)
    if w_hi <= REBUCKET_SKEW_X * max(w_lo, 1e-9):
        return None
    gap = (w_hi - w_lo) / 2
    moved_keys: list = []
    moved_wall = 0.0
    # smallest keys first: moving a straggler key would just relocate
    # the imbalance; small keys pack the gap tightly. Sort by wall
    # ONLY — ties would otherwise compare key_index, which may be
    # None (summarize tolerates missing fields; so must this)
    for w, ki in sorted(by_dev[busiest], key=lambda t: t[0]):
        if moved_wall + w > gap or ki is None:
            continue
        moved_keys.append(ki)
        moved_wall += w
    if not moved_keys or moved_wall <= 0:
        # nothing movable, or only zero-wall keys fit the gap — a
        # hint that rebalances nothing is noise, not a signal
        return None
    hi_after = w_hi - moved_wall
    lo_after = w_lo + moved_wall
    return {"from": busiest, "to": laziest,
            "keys": moved_keys,
            "wall_s_moved": round(moved_wall, 4),
            "skew_before": skew_before,
            "skew_after_est": round(
                max(hi_after, lo_after) / max(min(hi_after, lo_after),
                                              1e-9), 3)}


def steal_plan(pending: dict, walls: dict,
               skew_x: float = REBUCKET_SKEW_X) -> Optional[dict]:
    """The EXECUTABLE half of `rebucket_hint`: given per-shard PENDING
    work (`{shard: [(est, key), ...]}` — est in whatever work currency
    the caller has, e.g. encoded op counts) and per-shard completed
    walls, decide which not-yet-started keys to move off the busiest
    shard onto the laziest. `rebucket_hint` names completed keys (a
    post-hoc diagnosis); this names movable ones (the live scheduler's
    input — the mesh fan-out and the streamed pool both call it
    between polls).

    Gate: busiest-vs-laziest completed wall past `skew_x`, the same
    trigger `rebucket_hint` uses. Moves the SMALLEST pending keys
    first (moving a straggler key just relocates the imbalance) until
    half the pending-work gap is packed. None when the fleet is <2
    shards, balanced, or the busiest shard has nothing left to give.
    Pure host arithmetic — unit-testable with fabricated queues."""
    if len(walls) < 2:
        return None
    busiest = max(walls, key=lambda d: walls[d])
    laziest = min(walls, key=lambda d: walls[d])
    if busiest == laziest:
        return None
    w_hi, w_lo = float(walls[busiest]), float(walls[laziest])
    if w_lo <= 0:
        # a shard with no completed wall yet is unknown, not lazy —
        # it may be grinding its first (heavy) key, and "rebalancing"
        # onto it would pile work on the actual straggler. Wait for a
        # completion on every shard before trusting the ratio (the
        # mesh scheduler's idle-pull trigger covers genuinely idle
        # shards without wall evidence).
        return None
    if w_hi <= skew_x * w_lo:
        return None
    donor = list(pending.get(busiest) or [])
    if not donor:
        return None
    have = sum(float(e) for e, _ in donor)
    lazy_have = sum(float(e) for e, _ in (pending.get(laziest) or []))
    gap = (have - lazy_have) / 2
    if gap <= 0:
        return None
    moved: list = []
    acc = 0.0
    for est, key in sorted(donor, key=lambda t: float(t[0])):
        if acc >= gap:
            break
        if moved and acc + float(est) > gap:
            # ascending order: every later key overshoots harder —
            # moving past the gap would just relocate the imbalance.
            # (The FIRST key always moves, so a queue of only-big
            # keys still sheds one.)
            break
        moved.append(key)
        acc += float(est)
    if not moved:
        return None
    return {"from": busiest, "to": laziest, "keys": moved,
            "est_moved": round(acc, 4),
            "skew_before": round(w_hi / max(w_lo, 1e-9), 3)}


# Bound on rebucket-hint key lists riding compact surfaces (records,
# findings, status blocks); the full hint stays on the in-memory
# summary.
HINT_MAX_KEYS = 16


def compact_hint(hint, max_keys: int = HINT_MAX_KEYS):
    """A rebucket hint bounded for compact surfaces: long `keys`
    lists truncate-and-count (`keys_omitted`) instead of ballooning
    a record."""
    if not isinstance(hint, dict):
        return None
    out = dict(hint)
    keys = out.get("keys")
    if isinstance(keys, list) and len(keys) > max_keys:
        out["keys"] = keys[:max_keys]
        out["keys_omitted"] = len(keys) - max_keys
    return out


def summarize(shards: list) -> dict:
    """Fleet aggregates over per-key shard blocks: per-device shard
    counts / wall / busy fraction, straggler ratio (max vs median
    shard wall), the work-skew index (busiest vs mean device wall),
    engine mix, fault and fallback counts, and — when the skew says
    keys are worth moving — a `rebucket_hint` block naming which
    keys to move where (the mesh fan-out's scheduling input).
    Tolerates None entries (skipped keys) and missing fields."""
    shards = [s for s in shards if isinstance(s, dict)]
    if not shards:
        return {"keys": 0, "devices": {}, "engines": {},
                "faults": 0, "fallbacks": 0}
    per_dev: dict = {}
    engines: dict = {}
    faults = 0
    fallbacks = 0
    for s in shards:
        dev = str(s.get("device", "host"))
        d = per_dev.setdefault(dev, {"keys": 0, "wall_s": 0.0,
                                     "faults": 0, "fallbacks": 0})
        d["keys"] += 1
        d["wall_s"] += float(s.get("wall_s") or 0.0)
        eng = str(s.get("engine", "unknown"))
        engines[eng] = engines.get(eng, 0) + 1
        if s.get("fault"):
            d["faults"] += 1
            faults += 1
        if eng == "oracle-fallback":
            d["fallbacks"] += 1
            fallbacks += 1
    walls = sorted(float(s.get("wall_s") or 0.0) for s in shards)
    w_median = walls[len(walls) // 2]
    w_max = walls[-1]
    # busy fraction: each device's summed shard wall over the fleet
    # span (first shard start -> last shard end); needs t0 stamps
    t0s = [s["t0"] for s in shards if s.get("t0") is not None]
    span = None
    if t0s:
        ends = [s["t0"] + float(s.get("wall_s") or 0.0)
                for s in shards if s.get("t0") is not None]
        span = max(ends) - min(t0s)
        for d in per_dev.values():
            d["busy_frac"] = (round(min(1.0, d["wall_s"] / span), 4)
                              if span > 0 else 1.0)
    for d in per_dev.values():
        d["wall_s"] = round(d["wall_s"], 4)
    keys_per_dev = [d["keys"] for d in per_dev.values()]
    # work-skew index: busiest device's summed wall over the mean —
    # 1.0 is perfectly balanced; a lockstep mesh pays the busiest
    # device's wall, so (work_skew - 1) is the reclaimable fraction
    dev_walls = [d["wall_s"] for d in per_dev.values()]
    mean_wall = sum(dev_walls) / len(dev_walls)
    work_skew = round(max(dev_walls) / max(mean_wall, 1e-9), 3)
    return {
        "keys": len(shards),
        "device_count": len(per_dev),
        "devices": per_dev,
        "engines": engines,
        "faults": faults,
        "fallbacks": fallbacks,
        "wall_s": {"max": round(w_max, 4),
                   "median": round(w_median, 4),
                   "total": round(sum(walls), 4)},
        # lockstep/batched fleets pay max while a balanced one pays
        # ~median — this ratio IS the straggler cost
        "straggler_ratio": round(w_max / max(w_median, 1e-9), 3),
        "work_skew": work_skew,
        "imbalance": {"max_keys": max(keys_per_dev),
                      "min_keys": min(keys_per_dev),
                      "mean_keys": round(len(shards) / len(per_dev), 2)},
        "rebucket_hint": rebucket_hint(shards),
        "span_s": round(span, 4) if span is not None else None,
    }
