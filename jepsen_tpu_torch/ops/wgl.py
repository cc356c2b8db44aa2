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

import os
import time as _time
from typing import Callable, Optional

import numpy as np

from ..history import History
from ..models.core import Model
from ..util import device_name, resolve_device
from . import adapt as _adapt
from . import wgl32, wgl_ref, wgln
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


def derive_plan(*, window_raw: int, ic_pad: int, n: int,
                n_info: int, accel: bool,
                frontier: Optional[int] = None,
                adaptive: Optional[bool] = None) -> dict:
    """The static kernel plan: variant, capacities, ladder, effective
    widths. Pure scalar math, copied from the JAX package's
    `derive_plan` with one change: `depth` stays 1 on the card (the
    JAX package's depth-fused narrow round is a TPU layout), so the
    narrow kernel runs 4096-round chunks on the card and 1024 on the
    CPU. Returns {kern, K, H, B, W_eff, ic_eff, L, chunk, probes,
    ladder}; L is 0 for the narrow kernel."""
    H = _pick_capacities(n, window_raw)
    use_adapt = (_adapt.enabled(True if adaptive is None else adaptive)
                 and not frontier and adaptive is not False)
    ladder: Optional[tuple] = None
    ic_eff = min(max(8, _pad_to_mult(n_info, 8)), ic_pad)
    L = 0
    if window_raw <= 32:
        kern = "wgl32"
        ladder = _adapt.LADDER32 if use_adapt else None
        K = ladder[0] if ladder else 16
        W_eff = max(8, _pad_to_mult(window_raw, 8))
        B = 1 << 18
        chunk = 4096 if accel else 1024
    else:
        # the window as L uint32 lanes; K from a byte budget over the
        # (K, W, L) successor windows: 1 GiB on the card, 128 MiB on
        # the CPU
        kern = "wgln"
        W_eff = _pad_to_mult(window_raw, 32)
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
    return {"kern": kern, "K": K, "H": H, "B": B, "W_eff": W_eff,
            "ic_eff": ic_eff, "L": L, "chunk": chunk, "probes": 4,
            "ladder": ladder}


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


def memo_hit_rate(hits, inserts) -> float:
    """hits / (hits + inserts), guarded (the JAX package's
    `occupancy.memo_hit_rate`)."""
    hits, inserts = int(hits), int(inserts)
    return round(hits / max(hits + inserts, 1), 4)


def check(model: Model, history: History, time_limit: Optional[float] = None,
          max_configs: int = 200_000_000, frontier: Optional[int] = None,
          enc: Optional[Encoded] = None,
          stop: Optional[Callable[[], bool]] = None,
          adaptive: Optional[bool] = None, device=None) -> dict:
    """Decide linearizability with the device search.

    Returns {"valid?": True/False/"unknown", ...}. "unknown" (deadline,
    config budget, capacity overflow, unsupported encoding) signals the
    caller to fall back to the host oracle. `enc` skips re-encoding;
    `stop` is polled between device chunks (True cancels with cause
    "cancelled"); `frontier` pins the beam width; `adaptive=False`
    turns the bucket ladder off. `device=None` is the CUDA card (it
    raises when there is none); `device="cpu"` runs the plain PyTorch
    chunk with the host plan (1024-round chunks)."""
    dev = resolve_device(device)
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
    plan = derive_plan(window_raw=enc.window_raw, ic_pad=len(enc.inv_info),
                       n=n, n_info=enc.n_info,
                       accel=accel, frontier=frontier, adaptive=adaptive)
    res = _search_loop(enc, plan, n, max_configs, frontier, dev, t_enter,
                       time_limit, stop)
    res["platform"] = dev.type
    res["device"] = device_name(dev)
    return res


def _search_loop(enc: Encoded, plan: dict, n: int, max_configs: int,
                 frontier, dev, t_enter: float, time_limit, stop) -> dict:
    K, H, B = plan["K"], plan["H"], plan["B"]
    W_eff, ic_eff = plan["W_eff"], plan["ic_eff"]
    chunk, probes = plan["chunk"], plan["probes"]
    ladder = plan["ladder"]
    L = plan["L"]
    row_cols = W_eff + ic_eff
    consts = wgl32.consts_from_numpy(
        enc.inv, enc.ret, enc.opcode, enc.sufminret,
        enc.inv_info[:ic_eff], enc.opcode_info[:ic_eff], enc.table,
        n, enc.n_info, min(max_configs, 2**31 - 1), dev)
    if plan["kern"] == "wgl32":
        carry = wgl32.init_carry(K, wgl32.row_words(ic_eff), H, B, 0, dev)

        def next_chunk(carry, K):
            return wgl32.chunk(consts, carry, K=K, W=W_eff, ic=ic_eff, H=H,
                               B=B, chunk=chunk, probes=probes)
    else:
        carry = wgln.init_carry(K, L, ic_eff, H, B, 0, dev)

        def next_chunk(carry, K):
            return wgln.chunk(consts, carry, K=K, L=L, ic=ic_eff, H=H, B=B,
                              chunk=chunk, probes=probes)
    deadline = t_enter + time_limit if time_limit else None
    policy = None
    if ladder:
        policy = _adapt.Policy(ladder=ladder, n_ok=n, backlog_cap=B,
                               start_k=K)
    t0 = _time.monotonic()
    first_call_s = None
    n_chunks = 0
    bk_peak = 0
    beam_area = 0
    prev_rounds_total = 0
    prev_explored_total = 0
    max_lin = 0
    while True:
        carry, summary = next_chunk(carry, K)
        # the one device->host copy per chunk: the packed summary
        s = summary.cpu().numpy()
        fr_cnt, flags, stats = int(s[0]), s[1:4], s[4:10]
        bk_cnt = int(s[10])
        n_chunks += 1
        bk_peak = max(bk_peak, bk_cnt)
        max_lin = max(max_lin, int(stats[2]))
        if first_call_s is None:
            first_call_s = _time.monotonic() - t0
        found, overflow = bool(flags[0]), bool(flags[1])
        total_explored = int(stats[0])
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
            "memo_hit_rate": memo_hit_rate(memo_hits, inserted),
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
                           device=None) -> dict:
    """Device verdict + counterexample enrichment (enrich_diagnostics)."""
    res = check(model, history, time_limit=time_limit, stop=stop,
                device=device)
    return enrich_diagnostics(model, history, res, stop=stop)
