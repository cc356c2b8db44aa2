"""Batched WGL search over many independent histories.

The port of `jepsen_tpu/parallel/batched.py`. Every key's history is
encoded into one shared shape bucket; then either

  * **mesh**: the lane scheduler of `parallel.mesh.check_mesh` (a small
    window of lane slots per device, refilled from per-shard queues),
    the default for 4 or more keys when two or more devices are named;
  * **vmap**: the whole batch runs as lanes of one search, one lane per
    key, split over the devices in contiguous blocks. Each poll is ONE
    launch per device of the lane-batched chunk kernel
    (`wgl32.chunk_batched` for windows of at most 32 ops,
    `wgln.chunk_batched` past that: one CUDA block per lane, each to
    its own stop), each on its device's own stream, and ONE
    device-to-host copy per device of its (lanes, 11 + ring) summary.
    This is the reference's `jit(vmap(chunk_fn))` (`_compiled_batched`)
    over a `NamedSharding`;
  * **stream**: one `ops.wgl.check` per key, each padded into the
    shared bucket of its kernel branch, racing the host oracle on the
    card (`checker._race_competition`); with two or more devices one
    worker thread per device drains its own queue and steals from the
    heaviest (the reference's `check_streamed`).

A device list plays the reference's mesh: `devices=None` is every
visible card (`util.default_devices`), and a list may repeat a device, so
that several shards share one card (the tests name `["cpu"] * n`).
Keys whose history cannot be encoded, or that have no ok op, are
decided on the host; keys the device leaves "unknown" go to the host
oracle (competition semantics).

Departures from the reference, each so that the device is never hidden:
the devices are resolved up front and `devices=None` raises without a
card (no host fallback for a backend that does not come up); a
kernel's build or launch failure raises instead of becoming a per-key
fault that the oracle then decides. A named device list does not pin
the vmap path as the reference's explicit mesh does: the list is the
mesh, and "auto" takes the mesh scheduler over it. Both paths admit
through the preflight gate (`analysis/preflight.gate_fanout`). Not
ported yet: the telemetry planes (fleet status, metrics series,
watchdog, HBM block).
"""

from __future__ import annotations

import os
import threading
import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .. import devices as _devices
from .. import fleet as _fleet
from .. import metrics as _metrics
from .. import occupancy as _occ
from .. import watchdog as _watchdog
from ..analysis import preflight
from ..history import History
from ..models.core import Model
from ..ops import adapt as _adapt
from ..ops import wgl, wgl32, wgl_ref, wgln
from ..ops.encode import INF, Encoded, EncodingUnsupported, _pad_to, encode
from ..util import on_stream, resolve_devices, shard_streams

STRATEGIES = ("auto", "vmap", "stream", "mesh")


def shared_shape_bucket(encs: Sequence[Encoded]) -> Optional[dict]:
    """One (n_pad, ic, S, O, w_eff) shape bucket covering every key of
    a streamed fan-out: `wgl.check(shape_bucket=...)` pads each
    encoding into it, so every key runs the plan the reference runs
    for it (the reference shares one compiled kernel per bucket this
    way). Only meaningful when every key takes the same kernel branch:
    callers split keys at window_raw 32 and bucket each group apart.
    Returns None for empty input."""
    if not encs:
        return None
    wide = max(e.window_raw for e in encs) > 32
    w_eff = 0
    ic_eff = 8
    for e in encs:
        if wide:
            w_eff = max(w_eff, _pad_to(e.window_raw, 32))
        else:
            w_eff = max(w_eff, max(8, _pad_to(e.window_raw, 8)))
        ic_eff = max(ic_eff, _pad_to(max(e.n_info, 1), 8))
    return {
        "n_pad": max(len(e.inv) for e in encs),
        "ic_pad": max(len(e.inv_info) for e in encs),
        "S": max(e.table.shape[0] for e in encs),
        "O": max(e.table.shape[1] for e in encs),
        "w_eff": w_eff,
        "ic_eff": min(ic_eff, max(len(e.inv_info) for e in encs)),
        "n_cap": max(e.n_ok for e in encs),
        "pack": all(wgl._packable(e) for e in encs),
    }


@dataclass
class BatchEncoded:
    """A batch of per-key encodings padded into one shape bucket."""

    n_keys: int            # real keys (the batch may be padded past them)
    n_pad: int
    ic_pad: int
    window: int
    table_s: int
    table_o: int
    inv: np.ndarray        # (Bk, n_pad) i32
    ret: np.ndarray        # (Bk, n_pad) i32
    opcode: np.ndarray     # (Bk, n_pad) i32
    sufminret: np.ndarray  # (Bk, n_pad+1) i32
    inv_info: np.ndarray   # (Bk, ic_pad) i32
    opcode_info: np.ndarray  # (Bk, ic_pad) i32
    table: np.ndarray      # (Bk, S, O) i32
    n_ok: np.ndarray       # (Bk,) i32
    n_info: np.ndarray     # (Bk,) i32


def encode_batch(encs: Sequence[Encoded], batch_pad: int = 1) -> BatchEncoded:
    """Pad per-key encodings into a common bucket and stack them, one
    lane per key. `batch_pad` rounds the key axis up to a multiple (the
    device count) with dummy keys: n_ok 0, so their lanes stop after
    their first round and their verdicts are ignored."""
    nk = len(encs)
    bk = _pad_to(nk, batch_pad)
    n_pad = max(len(e.inv) for e in encs)
    ic_pad = max(len(e.inv_info) for e in encs)
    W = max(e.window for e in encs)
    S = max(e.table.shape[0] for e in encs)
    O = max(e.table.shape[1] for e in encs)

    inv = np.full((bk, n_pad), INF, dtype=np.int32)
    ret = np.full((bk, n_pad), INF, dtype=np.int32)
    opc = np.zeros((bk, n_pad), dtype=np.int32)
    suf = np.full((bk, n_pad + 1), INF, dtype=np.int32)
    iinv = np.full((bk, ic_pad), INF, dtype=np.int32)
    iopc = np.zeros((bk, ic_pad), dtype=np.int32)
    table = np.full((bk, S, O), -1, dtype=np.int32)
    n_ok = np.zeros(bk, dtype=np.int32)
    n_info = np.zeros(bk, dtype=np.int32)
    for i, e in enumerate(encs):
        inv[i, :len(e.inv)] = e.inv
        ret[i, :len(e.ret)] = e.ret
        opc[i, :len(e.opcode)] = e.opcode
        suf[i, :len(e.sufminret)] = e.sufminret
        iinv[i, :len(e.inv_info)] = e.inv_info
        iopc[i, :len(e.opcode_info)] = e.opcode_info
        s, o = e.table.shape
        table[i, :s, :o] = e.table
        n_ok[i] = e.n_ok
        n_info[i] = e.n_info
    return BatchEncoded(n_keys=nk, n_pad=n_pad, ic_pad=ic_pad, window=W,
                        table_s=S, table_o=O, inv=inv, ret=ret, opcode=opc,
                        sufminret=suf, inv_info=iinv, opcode_info=iopc,
                        table=table, n_ok=n_ok, n_info=n_info)


def _batch_capacities(bk: int, W: int, n_pad: int, L: int = 0):
    """Frontier K / memo H / backlog B *per key* (the reference's
    `_batch_capacities`, copied exactly so that every lane runs the
    reference's search). Narrow frontiers explore far fewer redundant
    configs on valid histories (K = 64, as lanes cannot escalate); the
    memo table stays under ~60% load; whole-batch caps keep the narrow
    (Bk, K, W, 2W) intermediate under 128M elements, the wide (Bk, K,
    W, L) uint32 successor tensor under 128 MB and the memo tables
    (16 B/slot) under ~2 GB across the batch."""
    if L:  # wide kernel: byte budget over the (Bk, K, W, L) successors,
        #    floored at the kernel minimum (16)
        budget_bytes = 128 * 1024 * 1024
        K = max(16, min(1024, budget_bytes // max(1, bk * W * L * 4 * 3)))
        cap = int(os.environ.get("JEPSEN_TPU_MAX_FRONTIER", "0"))
        if cap:
            K = max(16, min(K, cap))
    else:
        budget = 128 * 1024 * 1024  # bool elements across the batch
        cap = max(16, budget // max(1, bk * 2 * W * W))
        K = min(64, cap)
    K = 1 << (K.bit_length() - 1)
    H = 1 << 21 if n_pad > 2048 else 1 << 19
    cap = max(1 << 16, 2**31 // (16 * max(1, bk)))
    # the kernels mask probe indices with `& (H - 1)`: H stays a power
    # of two
    H = min(H, 1 << (cap.bit_length() - 1))
    # wide rows are (L + Il + 2) words and wide wavefronts spill hard
    B = 1 << 16 if L else 1 << 14
    return K, H, B


def _oracle_fallback(model: Model, history: History,
                     deadline: Optional[float], device_res: dict) -> dict:
    """Re-check a device-"unknown" history with the host oracle inside
    whatever time remains, annotating why the device declined
    (competition semantics). Always annotates `device_cause`, even when
    the deadline has passed and the device result is returned as it
    was."""
    remaining = (deadline - _time.monotonic()
                 if deadline is not None else None)
    cause = device_res.get("cause") or "undecided"
    if remaining is not None and remaining <= 0:
        out = dict(device_res)
        out.setdefault("device_cause", cause)
        out.setdefault("fallback", "skipped: deadline expired")
        return out
    ref = wgl_ref.check(model, history, time_limit=remaining)
    ref["device_cause"] = ref.get("device_cause", cause)
    ref.setdefault("engine", "oracle-fallback")
    return ref


def _annotate_shard(res: dict, *, key_index: int, device: str,
                    engine: str, t0: float, wall_s: float,
                    device_index: Optional[int] = None,
                    extra: Optional[dict] = None) -> dict:
    """Stamp a per-key `shard` block (the reference's keys) onto a
    result and record it into the ambient metrics registry and
    RunStatus (`fleet.record_shard`). Returns the result for
    chaining."""
    shard = {"key_index": key_index, "device": device,
             "engine": engine, "t0": round(t0, 4),
             "wall_s": round(wall_s, 4),
             "valid?": res.get("valid?"),
             "op_count": res.get("op_count")}
    if device_index is not None:
        shard["device_index"] = device_index
    if res.get("cause") is not None:
        shard["cause"] = res.get("cause")
    if res.get("device_cause") is not None:
        shard["device_cause"] = res.get("device_cause")
    if extra:
        shard.update(extra)
    res["shard"] = shard
    _fleet.record_shard(shard)
    return res


def check_streamed(model: Model, histories: Sequence[History],
                   time_limit: Optional[float] = None,
                   max_configs: int = 50_000_000,
                   oracle_fallback: bool = True,
                   encs: Optional[Sequence[Encoded]] = None,
                   key_indices: Optional[Sequence[int]] = None,
                   device=None, devices=None) -> list[dict]:
    """Per-key single-kernel checks over a device list
    (`util.resolve_devices`: `devices`, else `[device]`, else every
    card). On one device the keys
    run one after another; on several, one worker thread per device
    drains its own queue (keys assigned longest first by encoded op
    count), steals the smallest pending key off the heaviest queue when
    it runs dry, and between keys moves pending keys off the busiest
    device when the completed walls show work skew (`fleet.steal_plan`,
    recorded as a "fleet_sched" event). On the card with
    `oracle_fallback`, each key's device search races the host oracle
    (the host is otherwise idle); otherwise a device "unknown" goes to
    the oracle afterwards. With `encs`, each kernel branch's keys share
    one shape bucket (`shared_shape_bucket`). An exception of a worker
    is raised once every worker has ended."""
    devs = resolve_devices(devices, device)
    race = oracle_fallback and devs[0].type == "cuda"
    deadline = _time.monotonic() + time_limit if time_limit else None
    labels = _fleet.device_labels(devs)

    def ki_of(i: int) -> int:
        return key_indices[i] if key_indices is not None else i

    # Admission preflight: each kernel branch's shared shape bucket pads
    # every key of its group, so a key whose plan blows the device
    # budget is rejected before any kernel or device byte, with the
    # keys of admissible groups running on. A rejected key is annotated
    # like any other shard; with oracle_fallback the host oracle (no
    # device budget) still decides it.
    rejected = preflight.gate_fanout(model, histories, encs=encs,
                                     where="parallel.streamed",
                                     devices=devs) or {}

    def rejected_result(i: int) -> dict:
        return _annotate_shard(
            dict(rejected[i], op_count=len(histories[i])),
            key_index=ki_of(i), device="none", engine="preflight",
            t0=_time.monotonic(), wall_s=0.0)

    if not oracle_fallback and len(rejected) == len(histories):
        return [rejected_result(i) for i in range(len(histories))]
    bucket_n = bucket_w = None
    if encs is not None and len(histories) > 1:
        # rejected keys do not size the admitted groups' buckets
        admitted = [e for j, e in enumerate(encs) if j not in rejected]
        bucket_n = shared_shape_bucket(
            [e for e in admitted if e.window_raw <= 32])
        bucket_w = shared_shape_bucket(
            [e for e in admitted if e.window_raw > 32])

    def one(di: int, i: int) -> dict:
        dev, label, ki = devs[di], labels[di], ki_of(i)
        h = histories[i]
        enc = encs[i] if encs else None
        t0 = _time.monotonic()
        rej = rejected.get(i)
        if rej is not None:
            if not oracle_fallback:
                return rejected_result(i)
            res = _oracle_fallback(model, h, deadline,
                                   dict(rej, op_count=len(h)))
            res.setdefault("preflight", rej["preflight"])
            return _annotate_shard(
                res, key_index=ki, device=label, device_index=di,
                engine=str(res.get("engine") or "preflight"), t0=t0,
                wall_s=_time.monotonic() - t0)
        remaining = None
        if deadline is not None:
            remaining = deadline - t0
            if remaining <= 0:
                return _annotate_shard(
                    {"valid?": "unknown", "cause": "timeout",
                     "op_count": len(h)}, key_index=ki, device=label,
                    device_index=di, engine="none", t0=t0, wall_s=0.0)
        retries = 0
        if race:
            from ..checker import _race_competition
            res = _race_competition(model, h, remaining, device=dev,
                                    max_configs=max_configs, enc=enc)
            engine = str(res.get("engine") or "device")
        else:
            sb = None
            if enc is not None:
                sb = bucket_n if enc.window_raw <= 32 else bucket_w
            res = wgl.check(model, h, time_limit=remaining,
                            max_configs=max_configs, enc=enc,
                            shape_bucket=sb, device=dev)
            engine = "device"
            if res.get("valid?") == "unknown" and oracle_fallback:
                retries = 1
                res = _oracle_fallback(model, h, deadline, res)
                # a past-deadline skip sets no engine: the shard stays
                # "device" (the oracle never ran)
                engine = str(res.get("engine") or engine)
        return _annotate_shard(res, key_index=ki, device=label,
                               device_index=di, engine=engine, t0=t0,
                               wall_s=_time.monotonic() - t0,
                               extra={"retries": retries})

    if len(devs) == 1 or len(histories) == 1:
        return [one(0, i) for i in range(len(histories))]

    # one worker per device, each draining its own queue (longest keys
    # first, balanced by encoded op count)
    est = [float(encs[i].n_ok) if encs else float(len(histories[i]))
           for i in range(len(histories))]
    queues = [deque() for _ in devs]
    dev_wall = [0.0] * len(devs)
    load = [0.0] * len(devs)
    for i in sorted(range(len(histories)), key=lambda i: -est[i]):
        d = load.index(min(load))
        queues[d].append(i)
        load[d] += est[i]
    qlock = threading.Lock()
    results: list[Optional[dict]] = [None] * len(histories)
    errors: list = []

    def claim(di: int) -> Optional[int]:
        with qlock:
            if queues[di]:
                return queues[di].popleft()
            donor = max(range(len(devs)),
                        key=lambda d: sum(est[j] for j in queues[d]))
            if donor == di or not queues[donor]:
                return None
            # smallest-first off the heaviest queue: moving a straggler
            # key would just relocate the imbalance
            j = min(queues[donor], key=lambda j: est[j])
            queues[donor].remove(j)
            return j

    def rebalance() -> None:
        with qlock:
            walls = {labels[d]: dev_wall[d] for d in range(len(devs))}
            pending = {labels[d]: [(est[j], j) for j in queues[d]]
                       for d in range(len(devs))}
        plan = _fleet.steal_plan(pending, walls)
        if plan is None:
            return
        with qlock:
            fdi = labels.index(plan["from"])
            tdi = labels.index(plan["to"])
            # keys may have been claimed since the snapshot: move only
            # what is still pending
            moved = [j for j in plan["keys"] if j in queues[fdi]]
            for j in moved:
                queues[fdi].remove(j)
                queues[tdi].append(j)
        if moved:
            _fleet.record_sched_event("fleet_sched", {
                "event": "rebucket", "from": plan["from"],
                "to": plan["to"], "keys": [ki_of(j) for j in moved],
                "skew_before": plan["skew_before"],
                "est_moved": plan["est_moved"]})

    def worker(di: int) -> None:
        try:
            while not errors:
                i = claim(di)
                if i is None:
                    return
                results[i] = one(di, i)
                with qlock:
                    dev_wall[di] += float(results[i]["shard"]["wall_s"])
                rebalance()
        except BaseException as e:  # raised once every worker has ended
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(di,),
                                name=f"stream-{labels[di]}")
               for di in range(len(devs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results  # type: ignore[return-value]


def check_batched(model: Model, histories: Sequence[History],
                  time_limit: Optional[float] = None,
                  max_configs: int = 50_000_000,
                  oracle_fallback: bool = True,
                  chunk: int = 1024, strategy: str = "auto",
                  device=None, devices=None) -> list[dict]:
    """Check many independent histories against `model`. Returns one
    result dict per history, in order.

    The devices are `resolve_devices(devices, device)`: the named list (it may
    repeat a device), else the one named device, else every card.

    strategy: "mesh" — the lane scheduler (`parallel.mesh.check_mesh`:
    per-device lane slots refilled from per-shard queues, the ladder
    climbed by the live lanes' hints, work stealing), which needs two
    or more devices and otherwise degrades to the "auto" decision
    below, as in the reference; "vmap" — every key a lane of one
    lane-batched search, the lanes split over the devices (one kernel
    launch and one summary copy per device per poll; lanes run to their
    own stops); "stream" — one single-key search per key
    (`check_streamed`); "auto" — the mesh for 4 or more encodable keys
    (`mesh.MIN_MESH_KEYS`; `JEPSEN_TPU_MESH=0` turns it off), else on
    the card vmap for 4 or more keys and stream below; on the CPU,
    stream when the biggest history has more than 512 ok ops, else vmap.

    `max_configs` is a per-key exploration budget. With
    `oracle_fallback`, keys the device leaves "unknown" are re-checked by
    the host oracle; pass False to see raw device verdicts.
    `device="cpu"` or a list of CPU devices runs the kernels' plain
    versions."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    devs = resolve_devices(devices, device)
    # the live status counts the whole key set, host-decided keys too
    status = _fleet.get_default()
    if status.enabled and len(histories) > 1:
        status.begin_keys(len(histories))
    # device stats are int32: cap the budget so the explored counter
    # can reach it without wrapping (it grows by at most K per round)
    max_configs = min(max_configs, 2**30)
    results: list[Optional[dict]] = [None] * len(histories)
    encs: list[Encoded] = []
    keys: list[int] = []  # lane -> history index
    for i, h in enumerate(histories):
        t_enc = _time.monotonic()
        try:
            e = encode(model, h)
        except EncodingUnsupported as exc:
            if oracle_fallback:
                res = wgl_ref.check(model, h, time_limit=time_limit)
                res.setdefault("device_cause", f"encoding: {exc}")
            else:
                res = {"valid?": "unknown", "cause": f"encoding: {exc}",
                       "op_count": len(h)}
            results[i] = _annotate_shard(
                res, key_index=i, device="host", engine="host", t0=t_enc,
                wall_s=_time.monotonic() - t_enc)
            continue
        if e.n_ok == 0:
            results[i] = _annotate_shard(
                {"valid?": True, "op_count": e.n_info}, key_index=i,
                device="host", engine="host", t0=t_enc,
                wall_s=_time.monotonic() - t_enc)
            continue
        encs.append(e)
        keys.append(i)
    if not encs:
        return results  # type: ignore[return-value]

    kept = [histories[i] for i in keys]
    from . import mesh as _mesh
    if strategy == "auto" and _mesh.enabled() \
            and len(encs) >= _mesh.MIN_MESH_KEYS:
        strategy = "mesh"
    if strategy == "mesh":
        out = _mesh.check_mesh(
            model, kept, encs=encs, time_limit=time_limit,
            max_configs=max_configs, devices=devs,
            oracle_fallback=oracle_fallback, key_indices=keys, chunk=chunk)
        if out is None:
            # fewer than 2 devices: the decision below
            strategy = "auto"
    else:
        out = None
    if strategy == "auto":
        on_card = devs[0].type == "cuda"
        stream_wins = ((not on_card and max(e.n_ok for e in encs) > 512)
                       or (on_card and len(encs) < 4))
        strategy = "stream" if stream_wins else "vmap"
    if strategy == "stream":
        out = check_streamed(
            model, kept, time_limit=time_limit, max_configs=max_configs,
            oracle_fallback=oracle_fallback, encs=encs, key_indices=keys,
            devices=devs)
    elif strategy == "vmap":
        # Admission preflight of the lane-batched kernel: every lane is
        # padded to the batch maxima and ceil(lanes / devices) lanes sit
        # on a device. An infeasible batch degrades to the streamed
        # path (per-key kernels), whose own group gate rejects what no
        # single kernel fits.
        bad = preflight.gate_fanout(model, kept, encs=encs,
                                    where="parallel.batched", mode="batch",
                                    n_devices=len(devs), devices=devs,
                                    on_infeasible="degrade")
        if bad:
            out = check_streamed(
                model, kept, time_limit=time_limit,
                max_configs=max_configs, oracle_fallback=oracle_fallback,
                encs=encs, key_indices=keys, devices=devs)
        else:
            out = _check_vmap(model, kept, encs, keys,
                              time_limit=time_limit,
                              max_configs=max_configs,
                              oracle_fallback=oracle_fallback, chunk=chunk,
                              devs=devs)
    for i, res in zip(keys, out):
        results[i] = res
    return results  # type: ignore[return-value]


def vmap_plan(batch: BatchEncoded, w_raw: int, chunk: int = 1024) -> dict:
    """The lane-batched search's plan for a padded batch whose widest
    key needs a window of `w_raw` ok ops (the reference's vmap branch):
    {W, L, ic, K, H, B, chunk, probes}; L is 0 for the narrow kernel.
    Trimmed to what the batch needs, since the successor-row count
    R = K * (W + ic) drives the probe traffic."""
    ic = batch.ic_pad
    ic = min(ic, max(8, _pad_to(int(batch.n_info.max()), 8)))
    if w_raw <= 32:
        W, L = max(8, _pad_to(w_raw, 8)), 0
    else:
        # the window as L uint32 lanes; rounds are light, so poll often
        W = _pad_to(w_raw, 32)
        L = W // 32
        chunk = min(chunk, 128)
    K, H, B = _batch_capacities(batch.inv.shape[0], W, batch.n_pad, L)
    return {"W": W, "L": L, "ic": ic, "K": K, "H": H, "B": B,
            "chunk": chunk, "probes": 4}


def batch_consts(batch: BatchEncoded, plan: dict, max_configs: int,
                 dev, lanes: slice = slice(None)) -> wgl32.BatchConsts:
    """The consts of the batch's `lanes` on `dev`, info tables cut to
    the plan's ic."""
    ic, sl = plan["ic"], lanes
    return wgl32.batch_consts_from_numpy(
        batch.inv[sl], batch.ret[sl], batch.opcode[sl], batch.sufminret[sl],
        batch.inv_info[sl, :ic], batch.opcode_info[sl, :ic], batch.table[sl],
        batch.n_ok[sl], batch.n_info[sl], max_configs, dev)


# Per-round lane points a lane-batched run drains into the
# `wgl_batched_rounds` series at most (the reference's budget).
LANE_ROUNDS_BUDGET = 8192


def _record_lanes(mx, s, *, poll: int, wall_s: float, K: int, kern: str,
                  fill_lanes, drain_lanes, live, hints, prev_rounds,
                  budget: int, device_of, extra: Optional[dict] = None
                  ) -> int:
    """One poll's lane telemetry of a lane-batched search (metrics on),
    from the packed summaries `s` the poll already copied: the
    `wgl_batched_lanes` point (each of `fill_lanes`' frontier fill and
    adaptive hint) and the rounds of each of `drain_lanes` drained from
    its occupancy ring into `wgl_batched_rounds`, `device_of(lane)` its
    shard, at most `budget` points in all (exhaustion recorded once).
    Returns the budget left."""
    fr = s[fill_lanes, 0]
    mx.series("wgl_batched_lanes", "per-poll per-lane frontier fill of "
              "the mesh-batched search").append({
                  "poll": poll, "wall_s": round(wall_s, 4), "K": K,
                  "kernel": kern, "live": int(live.sum()),
                  "empty_lanes": int((fr == 0).sum()),
                  "fill": [float(f) for f in np.round(fr / max(K, 1), 4)],
                  "hints": [int(h) for h in hints], **(extra or {})})
    rounds = mx.series("wgl_batched_rounds", "per-round per-lane frontier "
                       "fill drained from the lane-batched kernel rings "
                       "(round x lane heatmap input)")
    if budget > 0:
        for lane in drain_lanes:
            rows, _ = _occ.drain_chunk(s[lane], int(prev_rounds[lane]), K)
            for r in rows[:max(0, budget)]:
                budget -= 1
                rounds.append({"round": r["round"], "lane": int(lane),
                               "fill": r["fill"], "frontier": r["frontier"],
                               "device": int(device_of(lane))})
        if budget <= 0:
            rounds.append({"round": -1, "lane": -1, "fill": 0.0,
                           "frontier": 0, "note": "point budget exhausted; "
                           "later rounds not drained"})
            budget = -1
    return budget


def _check_vmap(model: Model, histories: Sequence[History],
                encs: Sequence[Encoded], keys: Sequence[int], *,
                time_limit, max_configs: int, oracle_fallback: bool,
                chunk: int, devs: list) -> list[dict]:
    """The lockstep batch: every encodable key a lane, the lanes padded
    to a multiple of the device count and split into contiguous
    per-device blocks (the reference's `NamedSharding` of the key axis).
    Each poll launches one lane-batched chunk per device, each on its
    device's own stream, then copies each device's summary to the host,
    until no lane is live or the deadline passes."""
    nd = len(devs)
    batch = encode_batch(encs, batch_pad=nd)
    bk = batch.inv.shape[0]
    per_dev = bk // nd
    plan = vmap_plan(batch, max(e.window_raw for e in encs), chunk)
    W, L, ic, K, H, B = (plan[k] for k in ("W", "L", "ic", "K", "H", "B"))
    chunk, probes = plan["chunk"], plan["probes"]
    streams = shard_streams(devs)
    blocks = []
    for d, dev in enumerate(devs):
        with on_stream(streams[d]):
            consts = batch_consts(batch, plan, max_configs, dev,
                                  slice(d * per_dev, (d + 1) * per_dev))
            if L:
                carry = wgln.init_carry_batch(per_dev, K, L, ic, H, B, 0,
                                              dev)
            else:
                carry = wgl32.init_carry_batch(per_dev, K,
                                               wgl32.row_words(ic), H, B, 0,
                                               dev)
        blocks.append([consts, carry])
    if L:
        def step(consts, carry):
            return wgln.chunk_batched(consts, carry, K=K, L=L, ic=ic, H=H,
                                      B=B, chunk=chunk, probes=probes)
        hint_ladder = _adapt.ladder_for(K, k_min=max(32, K // 16), step=8)
    else:
        def step(consts, carry):
            return wgl32.chunk_batched(consts, carry, K=K, W=W, ic=ic, H=H,
                                       B=B, chunk=chunk, probes=probes)
        hint_ladder = _adapt.LADDER32

    t0 = _time.monotonic()
    deadline = t0 + time_limit if time_limit else None
    timed_out = stalled = False
    # the planes, as in the reference's vmap loop: one heartbeat a poll
    # for the whole lockstep batch, the allocator sampled a poll, the
    # lanes' series and the live status (each free when off)
    mx, status = _metrics.get_default(), _fleet.get_default()
    wd, dm = _watchdog.get_default(), _devices.get_default()
    hb = wd.register("wgl-batched", device=f"mesh[{nd}]", grace_s=300.0)
    dmark = dm.mark(where="batched", devices=devs) if dm.enabled else None
    decided_base = (status.snapshot()["keys"]["decided"]
                    if status.enabled else 0)
    kern = "wgln" if L else "wgl32"
    n = batch.n_keys
    prev_rounds = np.zeros(bk, dtype=np.int64)
    prev_expl = np.zeros(bk, dtype=np.int64)
    occ_budget = LANE_ROUNDS_BUDGET
    n_polls = 0
    s = None
    try:
        while True:
            if wd.cancelled(hb):
                stalled = True
                break
            t_poll = _time.monotonic()
            # every device's launch before any device's summary is read
            summaries = []
            for d, blk in enumerate(blocks):
                with on_stream(streams[d]):
                    blk[1], summary = step(*blk)
                summaries.append(summary)
            # the one device->host copy per device per poll: [fr_cnt,
            # flags x3, stats x6, bk_cnt, ring] per lane
            parts = []
            for d, summary in enumerate(summaries):
                with on_stream(streams[d]):
                    parts.append(summary.cpu().numpy())
            s = np.concatenate(parts)
            n_polls += 1
            if dmark is not None:
                dm.sample(where="batched", mx=mx, devices=devs)
            fr_cnt, flags, stats = s[:, 0], s[:, 1:4], s[:, 4:10]
            found = flags[:, 0] != 0
            empty = fr_cnt == 0
            budget = stats[:, 0] >= max_configs
            live = ~(found | empty | budget)
            live[n:] = False
            decided = int((found | empty)[:n].sum())
            wd.beat(hb, live_keys=int(live.sum()), decided_keys=decided,
                    configs_explored=int(stats[:n, 0].sum()))
            if mx.enabled:
                wall_s = _time.monotonic() - t0
                mx.series("wgl_batched_chunks", "per-poll state of the "
                          "mesh-sharded batched search").append({
                              "wall_s": round(wall_s, 4),
                              "poll_s": round(_time.monotonic() - t_poll,
                                              4),
                              "live_keys": int(live.sum()),
                              "decided_keys": decided,
                              "frontier_total": int(fr_cnt[:n].sum()),
                              "backlog_total": int(s[:n, 10].sum()),
                              "explored_total": int(stats[:n, 0].sum())})
                r_delta = np.maximum(stats[:, 5] - prev_rounds, 0)
                e_delta = np.maximum(stats[:, 0] - prev_expl, 0)
                occupied = np.where(r_delta > 0,
                                    e_delta / np.maximum(r_delta, 1), 0.0)
                occ_budget = _record_lanes(
                    mx, s, poll=n_polls - 1, wall_s=wall_s, K=K, kern=kern,
                    fill_lanes=np.arange(n), drain_lanes=range(n), live=live,
                    hints=[_adapt.recommend(hint_ladder, float(occupied[i]))
                           for i in range(n)],
                    prev_rounds=prev_rounds, budget=occ_budget,
                    device_of=lambda lane: lane // per_dev)
            prev_expl = stats[:, 0].astype(np.int64)
            prev_rounds = stats[:, 5].astype(np.int64)
            if status.enabled:
                fills = fr_cnt[:n] / max(K, 1)
                status.batched_poll(
                    live=int(live.sum()), decided=decided_base + decided,
                    total=n, frontier_total=int(fr_cnt[:n].sum()),
                    backlog_total=int(s[:n, 10].sum()),
                    explored_total=int(stats[:n, 0].sum()))
                status.occupancy_poll({
                    "mode": "batched", "kernel": kern,
                    "platform": f"mesh[{nd}]", "K": K,
                    "fill_last": round(float(fills.mean()), 4),
                    "fill_mean": round(float(fills.mean()), 4),
                    "lanes": {"n": n,
                              "fill_min": round(float(fills.min()), 4),
                              "fill_max": round(float(fills.max()), 4),
                              "empty": int((fr_cnt[:n] == 0).sum())}},
                    search_id="batched")
            if not live.any():
                break
            if deadline is not None and _time.monotonic() > deadline:
                timed_out = True
                break
    finally:
        wd.unregister(hb)
    wall = _time.monotonic() - t0
    hbm = (dm.measured(dmark, where="batched", devices=devs)
           if dmark is not None else None)
    if s is None:
        # soft-cancelled before the first poll: every lane undecided
        s = np.zeros((bk, wgl32.SUMMARY_HEAD), dtype=np.int32)
        fr_cnt, flags, stats = s[:, 0], s[:, 1:4], s[:, 4:10]
        found = empty = budget = np.zeros(bk, dtype=bool)

    overflow = flags[:, 1]
    labels = _fleet.device_labels(devs)
    out = []
    for lane, (hist, e) in enumerate(zip(histories, encs)):
        n_total = int(e.n_ok + e.n_info)
        explored = int(stats[lane, 0])
        hits, ins = int(stats[lane, 3]), int(stats[lane, 4])
        rounds = int(stats[lane, 5])
        # "W" is the lane's own window; "W_pad" the batch's kernel width
        detail = {"W": e.window_raw, "W_pad": W, "K": K,
                  "configs_explored": explored,
                  "batch_keys": batch.n_keys, "batch_wall_s": round(wall, 4),
                  "util": {
                      "rounds": rounds,
                      "frontier_fill": round(explored / max(rounds * K, 1),
                                             4),
                      "memo_hit_rate": _occ.memo_hit_rate(hits, ins)},
                  "occupancy": {
                      "lane": lane, "K": K,
                      "fill_last": round(int(fr_cnt[lane]) / max(K, 1), 4),
                      "rounds": rounds,
                      # the ladder bucket a solo search of this key would
                      # have settled at
                      "hint": _adapt.recommend(hint_ladder,
                                               explored / max(rounds, 1))}}
        engine = "device-vmap"
        if found[lane]:
            res = {"valid?": True, "op_count": n_total, **detail}
        elif empty[lane] and not overflow[lane]:
            res = {"valid?": False, "op_count": n_total,
                   "max_linearized": int(stats[lane, 2]), **detail}
        else:
            cause = ("stalled" if stalled
                     else "backlog-overflow" if overflow[lane]
                     else "config-limit" if budget[lane] else "timeout")
            res = {"valid?": "unknown", "cause": cause,
                   "op_count": n_total, **detail}
            if stalled:
                # what this lane had explored when the run was declared
                # stalled
                res["partial"] = {"configs_explored": explored,
                                  "rounds": rounds,
                                  "ops_linearized": int(stats[lane, 2])}
            elif oracle_fallback and not timed_out:
                res = _oracle_fallback(model, hist, deadline, res)
                engine = str(res.get("engine") or engine)
        di = lane // per_dev
        if hbm is not None:
            # the lane's card's slice of the measured window
            dev_hbm = (hbm.get("devices") or {}).get(
                _fleet.device_label(devs[di]))
            res["hbm"] = {"device": _fleet.device_label(devs[di]),
                          "stats_available": dev_hbm is not None,
                          "peak_measured": (dev_hbm or {}).get(
                              "peak_measured")}
            if dev_hbm is None:
                res["hbm"]["stats_unavailable"] = True
        out.append(_annotate_shard(
            res, key_index=keys[lane], device=labels[di],
            device_index=di, engine=engine, t0=t0,
            # lockstep lanes all pay the batch wall; per-lane rounds and
            # configs are the imbalance signal
            wall_s=wall, extra={"rounds": rounds,
                                "configs_explored": explored}))
    return out
