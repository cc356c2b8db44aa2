"""Wing–Gong–Lowe linearizability search on the H100 (the north star).

The port of `jepsen_tpu/ops/wgl.py`'s host driver. The search explores
many configurations in lockstep:

  * A configuration is (base, window, info-mask, model-state): `base`
    is the first unlinearized :ok op, `window` the linearized flags of
    ok ops [base, base+W), `info` a mask over crashed (:info) ops, and
    `state` an index into the host-enumerated model transition table.
  * Each round expands every frontier config by every legal candidate,
    hashes the successors, dedups them against a device memo table and
    compacts the survivors into the fixed-capacity frontier, spilling
    overflow to a device backlog (`wgl32`).
  * The round loop runs on the device in chunks; the host polls one
    packed summary per chunk, checks deadline and `stop`, and moves
    the beam along the adaptive bucket ladder (`adapt`).

Verdict soundness: "valid" requires a config with every ok op
linearized; "invalid" requires exhausting the reachable config space
with no overflow; anything cut short (deadline, config budget, backlog
overflow) is "unknown". Hash signatures are ~95 bits, so a false
"seen" (the only unsound event) is astronomically unlikely.

A window of at most 32 ok ops runs the narrow kernel (`wgl32`, one
uint32 window word); a wider one, up to 1024, the wide kernel (`wgln`,
the window as L uint32 lanes). `derive_plan` picks the kernel and its
capacities.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time as _time
from typing import Callable, Optional

import numpy as np
import torch

from ..history import History
from ..models.core import Model
from ..util import device_name, resolve_device
from . import adapt as _adapt
from . import wgl32, wgl_bool, wgl_ref, wgln
from .encode import Encoded, EncodingUnsupported, encode

INF = np.int32(2**31 - 1)


def _pad_to_mult(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def _pick_capacities(n: int, window_raw: int) -> int:
    """Memo-table size H scaled to the problem: the H of the JAX
    package's `_pick_capacities` (`derive_plan` sets K and B itself).
    The memo table must stay well under ~60% load or probe-based dedup
    degrades into re-exploration (each slot is 16 bytes, so even 2^23
    slots is only 128 MB). A wide window's reachable-config count
    scales with its branching power (2^concurrency), not its op count,
    so it takes the largest table."""
    if window_raw > 32 or n > 5000:
        return 1 << 23
    if n > 2000:
        return 1 << 22
    return 1 << 19


# Legacy one-shot beam escalation, used only when the adaptive ladder is
# disabled: past this many explored configs the search is likely
# exhaustive, where breadth amortizes overhead.
_ESCALATE_AT = 200_000
_K_BIG = 512


def _build_search(n_pad: int, ic_pad: int, W: int, S: int, O: int,
                  K: int, H: int, B: int, chunk: int, probes: int):
    """The bool-window search for one shape bucket (the JAX package's
    `_build_search`): (init_fn, chunk_fn) over torch tensors, chunk_fn
    the plain PyTorch chunk (`wgl_bool.chunk_ref`). `init_fn(mstate0,
    device=None)` makes the 13-leaf carry; `chunk_fn(consts, carry)`
    runs one chunk, updates the carry in place and returns it. The
    consts are `wgl_bool.consts_from_numpy`'s tuple over an encoding
    padded to (n_pad, ic_pad, S, O). No checker path routes here, as
    in the reference: `_search_loop` runs `wgl32` or `wgln`."""
    def init_fn(mstate0: int, device=None) -> tuple:
        return wgl_bool.init_carry(K, W, ic_pad, H, B, mstate0, device)

    def chunk_fn(consts, carry) -> tuple:
        return wgl_bool.chunk_ref(consts, carry, K=K, W=W, ic=ic_pad, H=H,
                                  B=B, chunk=chunk, probes=probes)

    return init_fn, chunk_fn


def _compiled_search(n_pad: int, ic_pad: int, W: int, S: int, O: int,
                     K: int, H: int, B: int, chunk: int, probes: int):
    """`_build_search` with the chunk on the card (the JAX package's
    jitted `_compiled_search`): CUDA tensors launch the `wgl_chunk`
    kernel (`wgl_bool.chunk`, counted in `wgl_bool.chunk.launches`),
    CPU tensors run the plain chunk."""
    init_fn, _ = _build_search(n_pad, ic_pad, W, S, O, K, H, B, chunk,
                               probes)

    def chunk_fn(consts, carry) -> tuple:
        return wgl_bool.chunk(consts, carry, K=K, W=W, ic=ic_pad, H=H, B=B,
                              chunk=chunk, probes=probes)

    return init_fn, chunk_fn


def derive_plan(*, window_raw: int, ic_pad: int, n: int,
                n_info: int, accel: bool,
                frontier: Optional[int] = None,
                adaptive: Optional[bool] = None,
                shape_bucket: Optional[dict] = None) -> dict:
    """The static kernel plan: variant, capacities, ladder, effective
    widths. Pure scalar math, copied from the JAX package's
    `derive_plan` with one change: `depth` stays 1 on the card (the
    JAX package's depth-fused narrow round is a TPU layout), so the
    narrow kernel runs 4096-round chunks on the card and 1024 on the
    CPU. A `shape_bucket` (`parallel.shared_shape_bucket`) widens
    W_eff and ic_eff to the bucket's and sizes H by its largest key.
    Returns {kern, K, H, B, W_eff, ic_eff, L, chunk, depth, probes,
    ladder, use_adapt, buckets}; L is 0 for the narrow kernel, and
    `buckets` is every frontier capacity the search may visit (the
    ladder, the legacy [K, 512] escalation, or a pinned frontier), the
    plan the admission plane (`analysis/preflight.py`) bills."""
    n_caps = (max(n, int(shape_bucket.get("n_cap", 0))) if shape_bucket
              else n)
    H = _pick_capacities(max(n_caps, 1), window_raw)
    use_adapt = (_adapt.enabled(True if adaptive is None else adaptive)
                 and not frontier and adaptive is not False)
    ladder: Optional[tuple] = None
    ic_eff = min(max(8, _pad_to_mult(n_info, 8)), ic_pad)
    if shape_bucket:
        ic_eff = min(ic_pad, max(ic_eff, int(shape_bucket.get("ic_eff", 0))))
    L = 0
    if window_raw <= 32:
        kern = "wgl32"
        ladder = _adapt.LADDER32 if use_adapt else None
        K = ladder[0] if ladder else 16
        W_eff = max(8, _pad_to_mult(window_raw, 8))
        if shape_bucket:
            W_eff = max(W_eff, int(shape_bucket.get("w_eff", 0)))
        B = 1 << 18
        chunk = 4096 if accel else 1024
    else:
        # the window as L uint32 lanes; K from a byte budget over the
        # (K, W, L) successor windows: 1 GiB on the card, 128 MiB on
        # the CPU
        kern = "wgln"
        W_eff = _pad_to_mult(window_raw, 32)
        if shape_bucket:
            W_eff = max(W_eff, int(shape_bucket.get("w_eff", 0)))
        L = W_eff // 32
        budget_bytes = (1024 if accel else 128) * 1024 * 1024
        K = max(64, min(4096 if accel else 1024,
                        budget_bytes // (W_eff * L * 4 * 3)))
        cap = int(os.environ.get("JEPSEN_TPU_MAX_FRONTIER", "0"))
        if cap:
            K = min(K, cap)
        K = 1 << (K.bit_length() - 1)
        B = min(1 << 20, max(1 << 18, (32 << 20) // (L * 4)))
        B = 1 << (B.bit_length() - 1)
        chunk = 512 if accel else 128
        if use_adapt:
            ladder = _adapt.ladder_for(K, k_min=max(32, K // 16), step=8)
            K = ladder[0]
    if frontier:
        K = frontier
    if ladder:
        buckets = list(ladder)
    elif kern == "wgl32" and not frontier and K < _K_BIG:
        buckets = [K, _K_BIG]  # the legacy one-shot escalation
    else:
        buckets = [K]
    return {"kern": kern, "K": K, "H": H, "B": B, "W_eff": W_eff,
            "ic_eff": ic_eff, "L": L, "chunk": chunk, "depth": 1,
            "probes": 4, "ladder": ladder, "use_adapt": use_adapt,
            "buckets": buckets}


def _widen_frontier(carry, k_new: int):
    """Pad the frontier (K, C) of a wgl32 carry to k_new rows (zeros
    beyond fr_cnt are inert); backlog/memo/flags ride along."""
    return _adapt.migrate_frontier(carry, k_new)


def _packable(enc: Encoded) -> bool:
    """May this encoding run the JAX package's int16/int8 packed
    lookup tables (`pack`, bit-exact when every real event time sits
    under PACK_MAX)? The port's kernel always reads int32 tables; the
    parity tests use this to check that their `pack=True` reference
    runs are legal."""
    m = 0
    for a in (enc.inv, enc.ret, enc.sufminret, enc.inv_info):
        finite = a[a < INF]
        if finite.size:
            m = max(m, int(finite.max()))
    return m < wgl32.PACK_MAX and enc.table.shape[0] <= 32000


def _apply_bucket(enc: Encoded, bucket: dict) -> Encoded:
    """Pad an encoding into a shared shape bucket (the JAX package's
    `_apply_bucket`): inv/ret/sufminret/inv_info pad with INF, opcodes
    with 0, the transition table with -1. Padding ok-slots sit past
    n_ok and padding info-slots past n_info, so the search never takes
    them as candidates and verdicts are unchanged; every key of a
    streamed fan-out then runs the plan the reference runs."""
    n_pad = max(int(bucket.get("n_pad", len(enc.inv))), len(enc.inv))
    ic_pad = max(int(bucket.get("ic_pad", len(enc.inv_info))),
                 len(enc.inv_info))
    S = max(int(bucket.get("S", enc.table.shape[0])), enc.table.shape[0])
    O = max(int(bucket.get("O", enc.table.shape[1])), enc.table.shape[1])

    def pad1(a, size, fill):
        if len(a) == size:
            return a
        out = np.full(size, fill, dtype=a.dtype)
        out[:len(a)] = a
        return out

    table = enc.table
    if table.shape != (S, O):
        table = np.full((S, O), -1, dtype=np.int32)
        table[:enc.table.shape[0], :enc.table.shape[1]] = enc.table
    return dataclasses.replace(
        enc, inv=pad1(enc.inv, n_pad, INF), ret=pad1(enc.ret, n_pad, INF),
        opcode=pad1(enc.opcode, n_pad, 0),
        sufminret=pad1(enc.sufminret, n_pad + 1, INF),
        inv_info=pad1(enc.inv_info, ic_pad, INF),
        opcode_info=pad1(enc.opcode_info, ic_pad, 0), table=table)


def check(model: Model, history: History, time_limit: Optional[float] = None,
          max_configs: int = 200_000_000, frontier: Optional[int] = None,
          enc: Optional[Encoded] = None,
          stop: Optional[Callable[[], bool]] = None,
          adaptive: Optional[bool] = None, device=None,
          shape_bucket: Optional[dict] = None, metrics=None,
          profile_dir: Optional[str] = None) -> dict:
    """Decide linearizability with the device search.

    Returns {"valid?": True/False/"unknown", ...}. "unknown" (deadline,
    config budget, capacity overflow, unsupported encoding, a watchdog
    stall) signals the caller to fall back to the host oracle. `enc`
    skips re-encoding; `stop` is polled between device chunks (True
    cancels with cause "cancelled"); `frontier` pins the beam width;
    `adaptive=False` turns the bucket ladder off. `shape_bucket` pads
    the encoding into a fan-out's shared shape bucket (`_apply_bucket`;
    built by `parallel.shared_shape_bucket`). `device=None` is the CUDA
    card (it raises when there is none); `device="cpu"` runs the plain
    PyTorch chunk with the host plan (1024-round chunks).

    The telemetry and device planes, as in the reference, each off
    unless enabled (and then free in the loop): `metrics` (default the
    ambient `metrics` registry) records each chunk's packed poll summary
    (`wgl_chunks`), the occupancy ring's rounds (`wgl_rounds`, drained
    from the summary the loop already copies) and ladder switches
    (`wgl_adapt`), and the result carries `telemetry.chunks` and an
    `occupancy` block; the ambient `watchdog` gets a heartbeat a chunk
    and may soft-cancel the search between chunks (cause "stalled",
    with the partial progress); the ambient `devices` monitor samples
    the card a poll and puts `hbm` (and `util.hbm_peak_measured`) on
    the result; the ambient `fleet.RunStatus` gets the live search and
    occupancy. `profile_dir` (or env JEPSEN_TPU_PROFILE_DIR) wraps the
    search in a `torch.profiler` capture (CPU and CUDA activities)
    exported as a Chrome trace there; `res["profile_dir"]` is set only
    when a trace was written, and a failure to capture never blocks the
    verdict."""
    from .. import fleet as _fleet
    from .. import metrics as _metrics

    dev = resolve_device(device)
    mx = metrics if metrics is not None else _metrics.get_default()
    t_enter = _time.monotonic()
    # Device stats are int32; cap the budget so the explored counter can
    # reach it without wrapping (it grows by at most K per round).
    max_configs = min(max_configs, 2**30)
    try:
        if enc is None:
            enc = encode(model, history)
    except EncodingUnsupported as e:
        return {"valid?": "unknown", "cause": f"encoding: {e}",
                "encoding": e.to_dict(), "op_count": len(history)}
    n = enc.n_ok
    if n == 0:
        # with no must-linearize ops, skipping every crashed op is a
        # valid linearization
        return {"valid?": True, "op_count": enc.n_info}
    accel = dev.type == "cuda"
    if shape_bucket:
        enc = _apply_bucket(enc, shape_bucket)
    plan = derive_plan(window_raw=enc.window_raw, ic_pad=len(enc.inv_info),
                       n=n, n_info=enc.n_info,
                       accel=accel, frontier=frontier, adaptive=adaptive,
                       shape_bucket=shape_bucket)
    profile_dir = profile_dir or os.environ.get("JEPSEN_TPU_PROFILE_DIR")
    prof = None
    if profile_dir:
        try:
            prof = _start_profile(dev)
        except Exception as e:  # noqa: BLE001 — profiling never blocks
            # the verdict, but a missing capture is recorded
            _fleet.record_fault(_fleet.fault_event(
                e, stage="wgl/profiler-start"))
    try:
        res = _run_search(enc, plan, n, max_configs, frontier, dev,
                          t_enter, time_limit, stop, mx)
    finally:
        if prof is not None:
            try:
                _stop_profile(prof, profile_dir)
            except Exception as e:  # noqa: BLE001 — capture lost;
                # recorded so that the missing trace is explicable
                _fleet.record_fault(_fleet.fault_event(
                    e, stage="wgl/profiler-stop"))
                prof = None
    if prof is not None:
        res["profile_dir"] = profile_dir
    res["platform"] = dev.type
    res["device"] = device_name(dev)
    return res


def _start_profile(dev):
    """A started `torch.profiler` capture of the CPU and, on a card,
    CUDA activities."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda" and ProfilerActivity.CUDA in supported_activities():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str) -> str:
    """Stop the capture and export it as a Chrome trace into
    `profile_dir`; returns the trace's path."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"wgl-{os.getpid()}-"
                                     f"{_time.time_ns()}.trace.json")
    prof.export_chrome_trace(path)
    return path


def _run_search(enc, plan, n, max_configs, frontier, dev, t_enter,
                time_limit, stop, mx) -> dict:
    """`_search_loop` under a watchdog source (the reference's
    `_run_search`): the loop beats once a chunk, so a chunk that hangs
    on the card stops the beats and the watchdog declares the source
    stalled; the grace covers the first chunk's kernel build."""
    from .. import watchdog as _watchdog

    wd = _watchdog.get_default()
    hb = wd.register(f"wgl/{dev.type}", device=str(dev), grace_s=300.0)
    try:
        return _search_loop(enc, plan, n, max_configs, frontier, dev,
                            t_enter, time_limit, stop, mx, wd, hb)
    finally:
        wd.unregister(hb)


def _search_loop(enc: Encoded, plan: dict, n: int, max_configs: int,
                 frontier, dev, t_enter: float, time_limit, stop, mx, wd,
                 hb) -> dict:
    from .. import devices as _devices
    from .. import fleet as _fleet
    from .. import occupancy as _occ
    from .. import watchdog as _watchdog
    from ..analysis import guards as _guards

    K, H, B = plan["K"], plan["H"], plan["B"]
    W_eff, ic_eff = plan["W_eff"], plan["ic_eff"]
    chunk, probes = plan["chunk"], plan["probes"]
    ladder = plan["ladder"]
    L = plan["L"]
    row_cols = W_eff + ic_eff
    kern, plat = plan["kern"], dev.type
    consts = wgl32.consts_from_numpy(
        enc.inv, enc.ret, enc.opcode, enc.sufminret,
        enc.inv_info[:ic_eff], enc.opcode_info[:ic_eff], enc.table,
        n, enc.n_info, min(max_configs, 2**31 - 1), dev)
    # the search's one const upload (a compile guard's budget point)
    _guards.note_transfer("h2d", sum(t.numel() * t.element_size() for t in (
        consts.meta, consts.tk, consts.iinv, consts.iopc)), what="wgl-consts")
    if kern == "wgl32":
        C = wgl32.row_words(ic_eff)
        carry = wgl32.init_carry(K, C, H, B, 0, dev)

        def next_chunk(carry, K):
            return wgl32.chunk(consts, carry, K=K, W=W_eff, ic=ic_eff, H=H,
                               B=B, chunk=chunk, probes=probes)
    else:
        C = wgln.row_words(L, ic_eff)
        carry = wgln.init_carry(K, L, ic_eff, H, B, 0, dev)

        def next_chunk(carry, K):
            return wgln.chunk(consts, carry, K=K, L=L, ic=ic_eff, H=H, B=B,
                              chunk=chunk, probes=probes)
    deadline = t_enter + time_limit if time_limit else None
    policy = None
    if ladder:
        policy = _adapt.Policy(ladder=ladder, n_ok=n, backlog_cap=B,
                               start_k=K)
    status = _fleet.get_default()
    # per-chunk telemetry: None when metrics are off, so the loop pays
    # nothing (the zero-cost contract)
    tl_points: Optional[list] = [] if mx.enabled else None
    # the per-round drain of the occupancy ring, paid only when metrics
    # or the live status consume it
    drain = tl_points is not None or status.enabled
    occ_rounds: list = []
    occ_dropped = occ_seen = rounds_before = 0
    # the device plane: the allocator sampled at the same poll boundaries
    # (host-side queries), a window around the search
    dm = _devices.get_default()
    dmark = dm.mark(where=f"wgl/{plat}", devices=[dev]) if dm.enabled \
        else None
    search_id = (threading.get_ident(), plat)
    t0 = _time.monotonic()
    first_call_s = None
    n_chunks = 0
    bk_peak = 0
    beam_area = 0
    prev_rounds_total = 0
    prev_explored_total = 0
    total_explored = 0
    max_lin = 0
    while True:
        if wd.cancelled(hb):
            # soft cancel between chunks (a stall declared elsewhere, or
            # an operator's cancel): the partial progress, not a verdict
            return {"valid?": "unknown", "cause": "stalled",
                    "op_count": n + enc.n_info,
                    "partial": {"configs_explored": total_explored,
                                "ops_linearized": max_lin,
                                "chunks": n_chunks},
                    "stall": _watchdog.stall_result(hb)["stall"]}
        t_call = _time.monotonic()
        carry, summary = next_chunk(carry, K)
        if tl_points is not None and dev.type == "cuda":
            # instrumented only: wait for the chunk, so that the copy
            # below is timed apart from the device's compute
            torch.cuda.current_stream(dev).synchronize()
        t_xfer = _time.monotonic()
        # the one device->host copy per chunk: the packed summary, its
        # occupancy ring included
        s = summary.cpu().numpy()
        xfer_s = _time.monotonic() - t_xfer
        _guards.note_transfer("d2h", s.nbytes, what="wgl-poll")
        poll_s = _time.monotonic() - t_call
        fr_cnt, flags, stats = int(s[0]), s[1:4], s[4:10]
        bk_cnt = int(s[10])
        n_chunks += 1
        bk_peak = max(bk_peak, bk_cnt)
        max_lin = max(max_lin, int(stats[2]))
        total_explored = int(stats[0])
        wd.beat(hb, configs_explored=total_explored, ops_linearized=max_lin,
                chunks=n_chunks, frontier=fr_cnt, backlog=bk_cnt)
        if first_call_s is None:
            first_call_s = _time.monotonic() - t0
        found, overflow = bool(flags[0]), bool(flags[1])
        if dmark is not None:
            dm.sample(where=f"wgl/{plat}", mx=mx, devices=[dev])
        occ_new: list = []
        if drain:
            occ_new, dropped = _occ.drain_chunk(s, rounds_before, K)
            occ_dropped += dropped
            occ_seen += len(occ_new)
            # rounds are not timed one by one: spread them over the
            # chunk's wall
            wall_now = _time.monotonic() - t0
            wall_prev = max(wall_now - poll_s, 0.0)
            for i, r in enumerate(occ_new):
                r["wall_s"] = round(wall_prev + (i + 1) / len(occ_new)
                                    * (wall_now - wall_prev), 6)
        rounds_before = int(stats[5])
        if status.enabled:
            status.search_poll({
                "kernel": kern, "platform": plat, "chunk": n_chunks - 1,
                "wall_s": round(_time.monotonic() - t0, 4),
                "poll_s": round(poll_s, 6), "frontier": fr_cnt,
                "backlog": bk_cnt, "explored": total_explored,
                "rounds": int(stats[5])}, search_id=search_id)
            fills = [r["fill"] for r in occ_new]
            status.occupancy_poll({
                "mode": "single", "kernel": kern, "platform": plat, "K": K,
                "adapt": ({"ladder": list(policy.ladder),
                           "switches": len(policy.switches)}
                          if policy is not None else None),
                "fill_last": (fills[-1] if fills
                              else round(fr_cnt / max(K, 1), 4)),
                "fill_mean": (round(sum(fills) / len(fills), 4)
                              if fills else None),
                "rounds_seen": occ_seen, "rounds_dropped": occ_dropped,
                "recent_rounds": [{"round": r["round"], "fill": r["fill"]}
                                  for r in occ_new[-32:]]},
                search_id=search_id)
        if tl_points is not None:
            _record_chunk(mx, tl_points, occ_rounds, occ_new, s, K=K,
                          kern=kern, plat=plat, t0=t0, poll_s=poll_s,
                          xfer_s=xfer_s)
        rounds_now = int(stats[5])
        rounds_delta = rounds_now - prev_rounds_total
        explored_delta = total_explored - prev_explored_total
        beam_area += rounds_delta * K
        if policy is not None and not found and fr_cnt > 0:
            d = policy.observe(explored=total_explored,
                               rounds_delta=rounds_delta,
                               explored_delta=explored_delta,
                               frontier=fr_cnt, backlog=bk_cnt)
            if d.switch:
                if tl_points is not None:
                    mx.series(
                        "wgl_adapt",
                        "bucket-ladder switch decisions of the "
                        "occupancy-adaptive WGL scheduler").append({
                            "chunk": n_chunks - 1, "from_K": K,
                            "to_K": d.to_k, "reason": d.reason,
                            "fill": round(explored_delta
                                          / max(rounds_delta * K, 1), 4),
                            "backlog": bk_cnt, "explored": total_explored,
                            "kernel": kern, "platform": plat})
                carry = _adapt.migrate_frontier(carry, d.to_k)
                K = d.to_k
        prev_rounds_total = rounds_now
        prev_explored_total = total_explored
        if (policy is None and not found and fr_cnt > 0
                and not frontier
                and enc.window_raw <= 32 and K < _K_BIG
                and total_explored >= _ESCALATE_AT):
            # exhaustion regime (non-adaptive path): widen the beam; the
            # memo table rides along, so nothing is re-explored
            carry = _widen_frontier(carry, _K_BIG)
            K = _K_BIG
        cancelled = stop is not None and stop()
        if not (found or fr_cnt == 0
                or total_explored >= max_configs or cancelled
                or (deadline is not None
                    and _time.monotonic() > deadline)):
            continue
        wall = _time.monotonic() - t0
        rounds_total = rounds_now
        memo_hits, inserted = int(stats[3]), int(stats[4])
        util = {
            "configs_per_s": int(total_explored / max(wall, 1e-9)),
            "rounds": rounds_total,
            # beam-area weighted: each round normalized by the K it ran at
            "frontier_fill": round(
                total_explored / max(beam_area or rounds_total * K, 1), 4),
            "memo_hit_rate": _occ.memo_hit_rate(memo_hits, inserted),
            "succ_rows_per_round": K * row_cols,
            "est_table_mb_per_round": round(
                K * row_cols * 16 * probes / 1e6, 3),
            "first_call_s": round(first_call_s, 3),
            "chunks": n_chunks,
            "backlog_peak": bk_peak,
            "packed_tables": False,
        }
        if policy is not None:
            util["adapt"] = policy.summary()
        detail = {"W": enc.window_raw, "W_pad": W_eff, "K": K,
                  "configs_explored": total_explored,
                  "wall_s": round(wall, 4), "util": util}
        if dmark is not None:
            # the measured peak of this search's window (the explicit
            # stats_unavailable marker on the CPU)
            hbm = dm.measured(dmark, where=f"wgl/{plat}", devices=[dev])
            detail["hbm"] = hbm
            if hbm.get("peak_measured") is not None:
                util["hbm_peak_measured"] = hbm["peak_measured"]
        if tl_points is not None:
            detail["telemetry"] = {"chunks": tl_points}
            detail["occupancy"] = _occ.build_block(
                occ_rounds, K=K, kernel=kern, platform=plat, wall_s=wall,
                rounds_total=rounds_total, configs_explored=total_explored,
                memo_hits=memo_hits, memo_inserts=inserted,
                bytes_total=_occ.search_bytes(s[:wgl32.SUMMARY_HEAD], C,
                                              n_chunks),
                rounds_dropped=occ_dropped, rounds_seen=occ_seen,
                device_kind=_occ.safe_device_kind())
        if found:
            return {"valid?": True, "op_count": n + enc.n_info, **detail}
        if fr_cnt == 0:
            if overflow:
                return {"valid?": "unknown", "cause": "backlog-overflow",
                        "op_count": n + enc.n_info, **detail}
            return {"valid?": False, "op_count": n + enc.n_info,
                    "max_linearized": int(stats[2]), **detail}
        if total_explored >= max_configs:
            return {"valid?": "unknown", "cause": "config-limit",
                    "op_count": n + enc.n_info, **detail}
        if deadline is not None and _time.monotonic() > deadline:
            return {"valid?": "unknown", "cause": "timeout",
                    "op_count": n + enc.n_info, **detail}
        return {"valid?": "unknown", "cause": "cancelled",
                "op_count": n + enc.n_info, **detail}


def _record_chunk(mx, tl_points: list, occ_rounds: list, occ_new: list, s,
                  *, K: int, kern: str, plat: str, t0: float, poll_s: float,
                  xfer_s: float) -> None:
    """One chunk's telemetry (metrics on): its `wgl_chunks` point (kept
    in `tl_points` for the result too), its drained rounds into
    `wgl_rounds` (the first MAX_RESULT_ROUNDS kept in `occ_rounds` for
    the occupancy block), and the `wgl_*` counters, gauges and poll
    histogram, under the reference's names."""
    from .. import occupancy as _occ

    stats = s[4:10]
    fr_cnt, bk_cnt = int(s[0]), int(s[10])
    explored, rounds = int(stats[0]), int(stats[5])
    hits, inserts = int(stats[3]), int(stats[4])
    prev = tl_points[-1] if tl_points else {}
    point = {
        "chunk": len(tl_points), "cold": not tl_points,
        "wall_s": round(_time.monotonic() - t0, 6),
        "poll_s": round(poll_s, 6), "transfer_s": round(xfer_s, 6),
        "frontier": fr_cnt, "fill": round(fr_cnt / max(K, 1), 4),
        "backlog": bk_cnt, "K": K, "rounds": rounds, "explored": explored,
        "memo_hits": hits, "memo_inserts": inserts,
        "memo_hit_rate": _occ.memo_hit_rate(hits, inserts),
        "rounds_delta": rounds - prev.get("rounds", 0),
        "explored_delta": explored - prev.get("explored", 0),
        "kernel": kern, "platform": plat}
    tl_points.append(point)
    mx.series("wgl_chunks", "per-chunk packed poll summaries of the WGL "
              "device search").append(point)
    rounds_series = mx.series(
        "wgl_rounds", "per-round device occupancy counters drained from "
        "the kernel ring buffer")
    # epoch stamps from the interpolated walls: a chunk's rounds land in
    # one burst, and the append-time `t` would stack them
    epoch_now = _time.time()
    wall_ref = _time.monotonic() - t0
    for r in occ_new:
        r.update(kernel=kern, platform=plat, K=K, chunk=point["chunk"],
                 t=round(epoch_now - (wall_ref - r["wall_s"]), 6))
        rounds_series.append(r)
    occ_rounds.extend(occ_new[:max(0, _occ.MAX_RESULT_ROUNDS
                                   - len(occ_rounds))])
    lbl = {"kernel": kern, "platform": plat}
    mx.counter("wgl_chunks_total", "device chunk calls").inc(**lbl)
    mx.counter("wgl_rounds_total", "search rounds executed on device").inc(
        point["rounds_delta"], **lbl)
    mx.counter("wgl_configs_explored_total", "configurations expanded").inc(
        point["explored_delta"], **lbl)
    mx.counter("wgl_memo_hits_total", "memo-table dedup hits").inc(
        hits - prev.get("memo_hits", 0), **lbl)
    mx.counter("wgl_memo_inserts_total", "memo-table inserts").inc(
        inserts - prev.get("memo_inserts", 0), **lbl)
    mx.gauge("wgl_frontier_size", "beam occupancy at last poll").set(
        fr_cnt, **lbl)
    mx.gauge("wgl_backlog_size", "backlog depth at last poll").set(
        bk_cnt, **lbl)
    mx.histogram("wgl_poll_seconds", "host<->device chunk latency (device "
                 "compute + packed-summary transfer)").observe(poll_s, **lbl)


def enrich_diagnostics(model: Model, history: History, res: dict,
                       time_limit: float = 30.0,
                       stop: Optional[Callable[[], bool]] = None) -> dict:
    """On a device False verdict, re-run the host oracle briefly to
    extract counterexample diagnostics (final_paths / configs),
    matching the reference's expectation that invalid results explain
    themselves (checker.clj:205-212)."""
    if res.get("valid?") is False and "final_paths" not in res \
            and not (stop is not None and stop()):
        ref = wgl_ref.check(model, history, time_limit=time_limit,
                            stop=stop)
        if ref.get("valid?") is False:
            for k in ("final_paths", "configs", "max_linearized"):
                if k in ref:
                    res[k] = ref[k]
    return res


def check_with_diagnostics(model: Model, history: History,
                           time_limit: Optional[float] = None,
                           stop: Optional[Callable[[], bool]] = None,
                           device=None, metrics=None) -> dict:
    """Device verdict + counterexample enrichment (enrich_diagnostics)."""
    res = check(model, history, time_limit=time_limit, stop=stop,
                device=device, metrics=metrics)
    return enrich_diagnostics(model, history, res, stop=stop)
