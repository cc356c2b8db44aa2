"""Preflight: the static kernel-plan and capacity analyzer that admits a
check before anything runs on the card.

The port of `jepsen_tpu/analysis/preflight.py`. Given a history's
shapes (or its encoding) and a backend, it enumerates, without running
any of it, the plan a check would take:

  * the frontier buckets `ops/wgl.derive_plan` would climb and the
    kernel (`wgl32` / `wgln`) it would launch,
  * the Elle route (host / bf16 / packed / sharded / trim) that
    `ops/route.elle_cycle_route` and `elle/tpu._squaring_select` would
    take,

and bills each plan node with the bytes it keeps on the card (the
reference's byte model, and never less than the port's own analytic
count of its buffers from `occupancy`: a WGL search's carry, scratch
and consts, an Elle closure's reach buffers) into a report with a
verdict:

    feasible     admit as planned
    degrade      admit; `suggestion` names a cheaper or safer shape
    infeasible   reject before any encode table, kernel build or device
                 byte

Rules (the reference's catalog):

  P001 plan-exceeds-hbm              a node's bytes exceed the budget
  P002 closure-over-capacity         an Elle closure past its kernel cap
  P003 compile-budget-blown          the kernel modules the plan would
                                     build with nvcc exceed the caller's
                                     compile budget
  P004 encoding-overflow-predicted   the WGL encoding would trip an
                                     encode cap (window, info ops)
  P005 padded-waste                  predicted frontier fill under the
                                     occupancy target
  P006 route-cost-disagreement       the router picked the device but
                                     the cost model blows the budget

P001/P002 reject; P003-P006 degrade. The gates are wired into
`checker.Linearizable` ("cuda-wgl" rejects, "competition" loses its
device racer), the Elle checkers, both `parallel/batched.py` fan-out
paths and `parallel/mesh.check_mesh`; a rejection is the reference's
`{"valid?": "unknown", "cause": "preflight", ...}`. The CLI is
`python -m jepsen_tpu_torch preflight`.

The budget is per card: `JEPSEN_TPU_PREFLIGHT_MEM_BUDGET` when set, else
the smallest total memory of the CUDA devices planned for, else
`HOST_PLAN_BUDGET_BYTES` for a plan on the CPU. Where several shards of
a device list share one card, that card is billed for all of them.
"""

from __future__ import annotations

import os
import threading
import time
from collections import Counter, deque
from typing import Optional

import numpy as np

RULES = {
    "P001": "plan-exceeds-hbm",
    "P002": "closure-over-capacity",
    "P003": "compile-budget-blown",
    "P004": "encoding-overflow-predicted",
    "P005": "padded-waste",
    "P006": "route-cost-disagreement",
}

# Rules that reject (verdict "infeasible"); the rest only degrade.
INFEASIBLE_RULES = ("P001", "P002")

# The budget of a plan for the CPU (the plain versions run in host
# memory): a conservative planning figure, since the dense-closure
# blowups P001 exists for are 6-100 GB.
HOST_PLAN_BUDGET_BYTES = 16 * 2 ** 30

# Live copies of the dense closure's reach planes during a squaring:
# the reach, the product and the re-binarized result.
CLOSURE_LIVE_FACTOR = 3


def _resolve(platform: Optional[str], devices) -> tuple:
    """(platform, device list or None) of a plan. `devices` (a list of
    devices or names) decides the platform when given; else `platform`;
    else the card when there is one, the CPU otherwise. Never raises:
    planning runs before, and without, a card."""
    import torch

    devs = None
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if platform is None:
            platform = ("cuda" if any(d.type == "cuda" for d in devs)
                        else "cpu")
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    return platform, devs


def device_memory_budget(platform: Optional[str] = None,
                         devices=None) -> int:
    """The byte budget a plan node must fit. Precedence:

      1. JEPSEN_TPU_PREFLIGHT_MEM_BUDGET (the operator always wins);
      2. on the card: the smallest total memory of the CUDA devices
         planned for (`devices.bytes_limit`; every card when none is
         named). The total, not the free bytes, so that a verdict does
         not drift with the caching allocator;
      3. `HOST_PLAN_BUDGET_BYTES` for a plan on the CPU.
    """
    env = os.environ.get("JEPSEN_TPU_PREFLIGHT_MEM_BUDGET")
    if env:
        return int(float(env))
    plat, devs = _resolve(platform, devices)
    if plat == "cuda":
        try:
            import torch
            if torch.cuda.is_available():
                cards = ([d for d in devs if d.type == "cuda"] if devs
                         else [torch.device("cuda", i) for i in
                               range(torch.cuda.device_count())])
                from .. import devices as devices_mod
                totals = [devices_mod.bytes_limit(d) for d in cards]
                if totals:
                    return int(min(totals))
        except Exception:  # noqa: BLE001 — the budget must never raise
            pass
    return HOST_PLAN_BUDGET_BYTES


def _compile_budget(explicit: Optional[int]) -> Optional[int]:
    if explicit is not None:
        return int(explicit)
    env = os.environ.get("JEPSEN_TPU_PREFLIGHT_COMPILE_BUDGET")
    return int(env) if env not in (None, "") else None


def _rule(rule: str, message: str, suggestion: Optional[str] = None,
          severity: Optional[str] = None) -> dict:
    return {"rule": rule, "name": RULES[rule],
            "severity": severity or ("infeasible"
                                     if rule in INFEASIBLE_RULES
                                     else "degrade"),
            "message": message, "suggestion": suggestion}


def _verdict(rules: list) -> tuple:
    """(verdict, suggestion) from the fired rules."""
    infeasible = [r for r in rules if r["severity"] == "infeasible"]
    if infeasible:
        return "infeasible", (infeasible[0].get("suggestion")
                              or infeasible[0]["message"])
    degrade = [r for r in rules if r["severity"] == "degrade"]
    if degrade:
        return "degrade", (degrade[0].get("suggestion")
                           or degrade[0]["message"])
    return "feasible", None


def _shards_per_card(devices, n_shards: int) -> int:
    """How many of the first `n_shards` entries of a device list share
    the busiest CUDA card (1 without a repeated card). CPU entries play
    the reference's virtual devices and are never summed."""
    if not devices:
        return 1
    cards = Counter(d.index or 0 for d in list(devices)[:max(1, n_shards)]
                    if getattr(d, "type", None) == "cuda")
    return max(cards.values(), default=1)


# ---------------------------------------------------------------------------
# WGL: shape probe + plan enumeration
# ---------------------------------------------------------------------------

def _probe_shapes(history) -> dict:
    """The encoding-relevant shapes of a history without enumerating the
    model's state space (`encode.build_table` is the expensive half of
    `encode`): window requirement, op and info counts and the depth
    come from the prepared op intervals alone, with encode's own window
    math and pad buckets."""
    from ..ops.encode import _pad_to, window_requirement
    from ..ops.linprep import prepare

    ops = prepare(history)
    ok = [o for o in ops if o.ok]
    info = [o for o in ops if not o.ok]
    n, ni = len(ok), len(info)
    inv = np.asarray([o.inv for o in ok], dtype=np.int64)
    ret = np.asarray([min(o.ret, 2 ** 31 - 1) for o in ok], dtype=np.int64)
    w_needed, W = window_requirement(inv, ret)
    return {"n_ok": n, "n_info": ni, "W_raw": w_needed, "W": W,
            "n_pad": _pad_to(n, 64), "ic_pad": _pad_to(ni, 32),
            "S": None, "O": None,
            "times_max": int(max(inv.max() if n else 0,
                                 ret.max() if n else 0,
                                 max((o.inv for o in info), default=0))),
            "inv": inv, "ret": ret}


def _shapes_from_enc(enc) -> dict:
    from ..ops.wgl import INF

    n = int(enc.n_ok)
    m = 0
    for a in (enc.inv, enc.ret, enc.sufminret, enc.inv_info):
        finite = a[a < INF]
        if finite.size:
            m = max(m, int(finite.max()))
    return {"n_ok": n, "n_info": int(enc.n_info),
            "W_raw": int(enc.window_raw), "W": int(enc.window),
            "n_pad": len(enc.inv), "ic_pad": len(enc.inv_info),
            "S": int(enc.table.shape[0]), "O": int(enc.table.shape[1]),
            "times_max": m, "inv": enc.inv[:n].astype(np.int64),
            "ret": enc.ret[:n].astype(np.int64)}


def _depth_stats(shapes: dict) -> dict:
    """Mean and p95 pending-op depth: the static wavefront predictor
    behind P005's predicted fill."""
    inv, ret = shapes.get("inv"), shapes.get("ret")
    if inv is None or not len(inv):
        return {"mean_depth": 0.0, "p95_depth": 0}
    order_i = np.sort(inv)
    order_r = np.sort(ret)
    depth = (np.searchsorted(order_i, inv, side="right")
             - np.searchsorted(order_r, inv, side="right"))
    return {"mean_depth": round(float(depth.mean()), 2),
            "p95_depth": int(np.percentile(depth, 95))}


def _node_bytes(K, W_eff, ic_eff, window_lanes, H, B, n_pad) -> int:
    """The reference's peak-bytes model of one kernel bucket: memo table
    (16 B a slot) + packed backlog rows + the per-round successor
    intermediates (R rows x packed lanes x ~3 temporaries) + consts."""
    lanes = window_lanes + max(1, ic_eff // 32) + 4
    rows = K * (W_eff + ic_eff)
    return int(H * 16 + B * lanes * 4
               + 3 * rows * lanes * 4 + 6 * n_pad * 4)


def _lower_wgl_node(enc, kern: str, *, K, H, B, probes, W_eff, ic_eff, L,
                    lanes: int = 1) -> dict:
    """The analytic cost of one plan node, in the place of the
    reference's trace-and-lower: the bytes the port's carry, scratch and
    consts hold at (K, H, B, W_eff, ic_eff) (`occupancy.wgl_state_bytes`,
    nothing allocated), and the per-round memo-stream traffic and int
    operations under the reference's cost keys (`flops`,
    `bytes_accessed`), which the CLI's parity block prints."""
    from .. import occupancy as occ

    S, O = enc.table.shape if enc is not None else (0, 0)
    n_pad = len(enc.inv) if enc is not None else 0
    rows = K * (W_eff + ic_eff)
    return {"flops": float(rows * 64),
            "bytes_accessed": float(rows * probes * 16),
            "state_bytes": occ.wgl_state_bytes(
                kern, K=K, W_eff=W_eff, ic_eff=ic_eff, L=L, H=H, B=B,
                n_pad=n_pad, S=int(S), O=int(O), lanes=lanes)}


def _cold_modules(kernels, platform: str) -> list:
    """The kernel sources a plan would build with nvcc that this process
    has neither loaded nor found built on disk (`ops/_native`). A plan
    for the CPU builds no nvcc module: it runs the host kernels (the WGL
    chunk's, Elle's trim), whose one build each with the host compiler
    P003 does not bill (the reference bills no `device@cpu` lane
    either)."""
    if platform != "cuda":
        return []
    from ..ops import _native
    return _native.cold_sources(kernels)


def plan_wgl(model=None, history=None, *, enc=None,
             platform: Optional[str] = None, devices=None,
             frontier: Optional[int] = None,
             adaptive: Optional[bool] = None,
             shape_bucket: Optional[dict] = None,
             lower: bool = False,
             lanes: int = 1,
             compile_budget: Optional[int] = None) -> dict:
    """Enumerate the plan `ops/wgl.check` would run for this history
    (kernel, buckets, capacities) without running it, and attach the
    rules that fire. `lower=True` gives each bucket its analytic cost
    (`_lower_wgl_node`, cached by `occupancy.cost_for`; encodes the
    history when no `enc` is given); `lower="warm"` attaches only costs
    already cached. `lanes` > 1 bills each bucket for a lane-batched
    carry of that many lanes. `platform` ("cuda" / "cpu") or `devices`
    say where the plan runs (default: the card when there is one).
    Returns the plan report dict."""
    from ..ops import wgl as wgl_mod

    plat, devs = _resolve(platform, devices)
    accel = plat == "cuda"
    rules: list = []

    # -- shapes ---------------------------------------------------------
    if enc is None and lower is True and model is not None \
            and history is not None:
        from ..ops.encode import EncodingUnsupported, encode
        try:
            enc = encode(model, history)
        except EncodingUnsupported as e:
            rules.append(_rule(
                "P004", f"encoding unsupported: {e}",
                suggestion="route to the host oracle (wgl_ref)"))
            verdict, suggestion = _verdict(rules)
            return {"schema": 1, "kind": "wgl", "platform": plat,
                    "engine": "oracle", "shapes": {},
                    "encoding": e.to_dict(), "plan": [], "rules": rules,
                    "verdict": verdict, "suggestion": suggestion}
    if enc is not None:
        shapes = _shapes_from_enc(enc)
    elif history is not None:
        shapes = _probe_shapes(history)
    else:
        raise ValueError("plan_wgl needs enc or history")
    shapes.update(_depth_stats(shapes))
    if shape_bucket:
        # the bucket maxima are the shape that runs: a smaller
        # representative must not shrink the bill
        shapes["n_pad"] = max(shapes["n_pad"],
                              int(shape_bucket.get("n_pad", 0)))
        shapes["ic_pad"] = max(shapes["ic_pad"],
                               int(shape_bucket.get("ic_pad", 0)))
    n, ni = shapes["n_ok"], shapes["n_info"]
    w_raw, W = shapes["W_raw"], shapes["W"]
    ic_pad = shapes["ic_pad"]

    # -- predictive encoding limits (P004): encode.py's own caps -------
    from ..ops.encode import MAX_INFO, MAX_WINDOW
    if W > MAX_WINDOW:
        rules.append(_rule(
            "P004", f"window {w_raw} would exceed the encode cap "
                    f"{MAX_WINDOW} (rule=window)",
            suggestion="route to the host oracle (wgl_ref)"))
    if ni > MAX_INFO:
        rules.append(_rule(
            "P004", f"{ni} crashed ops would exceed the encode cap "
                    f"{MAX_INFO} (rule=info-cap)",
            suggestion="route to the host oracle (wgl_ref)"))
    if any(r["rule"] == "P004" for r in rules):
        verdict, suggestion = _verdict(rules)
        shapes.pop("inv", None), shapes.pop("ret", None)
        return {"schema": 1, "kind": "wgl", "platform": plat,
                "engine": "oracle", "shapes": shapes, "plan": [],
                "rules": rules, "verdict": verdict,
                "suggestion": suggestion}

    # -- the derivation wgl.check runs (one source of truth) -----------
    plan_p = wgl_mod.derive_plan(
        window_raw=w_raw, ic_pad=ic_pad, n=n, n_info=ni, accel=accel,
        frontier=frontier, adaptive=adaptive, shape_bucket=shape_bucket)
    kern = plan_p["kern"]
    H, B = plan_p["H"], plan_p["B"]
    W_eff, ic_eff, L = plan_p["W_eff"], plan_p["ic_eff"], plan_p["L"]
    chunk, depth, probes = (plan_p["chunk"], plan_p["depth"],
                            plan_p["probes"])
    use_adapt, buckets = plan_p["use_adapt"], plan_p["buckets"]
    compact = depth > 1
    if enc is not None:
        pack = (bool(shape_bucket["pack"])
                if shape_bucket and "pack" in shape_bucket
                else wgl_mod._packable(enc))
        pack_estimated = False
    else:
        from ..ops.wgl32 import PACK_MAX
        pack = shapes["times_max"] < PACK_MAX
        pack_estimated = True

    # -- plan nodes -----------------------------------------------------
    from .. import occupancy as occ_mod

    budget = device_memory_budget(plat, devs)
    nodes: list = []
    for k in buckets:
        hbm = _node_bytes(k, W_eff, ic_eff, 1 if kern == "wgl32" else L,
                          H, B, shapes["n_pad"])
        if lanes > 1:
            # a lane-batched carry keeps every lane resident at once
            hbm *= lanes
        # never less than what the port's own buffers hold
        hbm = max(hbm, occ_mod.wgl_state_bytes(
            kern, K=k, W_eff=W_eff, ic_eff=ic_eff, L=L, H=H, B=B,
            n_pad=shapes["n_pad"], S=shapes["S"] or 0, O=shapes["O"] or 0,
            lanes=lanes))
        node = {"kernel": kern, "K": k, "H": H, "B": B,
                "W_eff": W_eff, "ic_eff": ic_eff, "chunk": chunk,
                "depth": depth, "pack": pack, "compact": compact,
                "succ_rows": k * (W_eff + ic_eff),
                "hbm_bytes": hbm}
        if lanes > 1:
            node["lanes"] = lanes
        if lower:
            key = (kern, shapes["n_pad"], ic_eff, W_eff, k, chunk, depth,
                   accel, pack, lanes)
            if lower is True and enc is not None:
                node["cost"] = occ_mod.cost_for(
                    key, lambda k_=k: _lower_wgl_node(
                        enc, kern, K=k_, H=H, B=B, probes=probes,
                        W_eff=W_eff, ic_eff=ic_eff, L=L, lanes=lanes))
            else:
                cost = occ_mod.cost_cached(key)
                if cost is not None:
                    node["cost"] = cost
        nodes.append(node)
    peak = max(nd["hbm_bytes"] for nd in nodes)
    if peak > budget:
        rules.append(_rule(
            "P001", f"plan peak {peak / 1e9:.2f} GB exceeds the "
                    f"{budget / 1e9:.2f} GB device budget",
            suggestion="shard the history (parallel/batched) or cap "
                       "the frontier"))

    # -- P003: kernel modules to build vs the caller's compile budget --
    cold = _cold_modules([kern + "_chunk"], plat)
    cbudget = _compile_budget(compile_budget)
    if cbudget is not None and len(cold) > cbudget:
        rules.append(_rule(
            "P003", f"{len(cold)} kernel module(s) to build with nvcc "
                    f"({', '.join(cold)}) exceed the compile budget "
                    f"{cbudget}",
            suggestion="warm the ladder first (it builds, loads and "
                       "binds its kernels): "
                       "aot.precompile_wgl_ladder(...)"))

    # -- P005: predicted fill at the starting bucket --------------------
    wavefront = max(shapes.get("mean_depth") or 0.0, 1.0)
    k_start = buckets[0]
    fill_pred = round(min(1.0, wavefront / max(k_start, 1)), 4)
    if fill_pred < occ_mod.TARGET_FILL:
        why = (f"predicted fill {fill_pred} at start bucket "
               f"K={k_start} (wavefront ~{wavefront}) under target "
               f"{occ_mod.TARGET_FILL}")
        sugg = ("enable the adaptive ladder (ops/adapt.py)"
                if not use_adapt else
                "near-serial shape: the host oracle decides it cheaper")
        if shape_bucket and shape_bucket.get("w_eff", 0) > 2 * W:
            sugg = ("shared bucket pads W to "
                    f"{shape_bucket['w_eff']} vs raw {w_raw}: split "
                    "the bucket")
        rules.append(_rule("P005", why, suggestion=sugg))

    verdict, suggestion = _verdict(rules)
    shapes.pop("inv", None), shapes.pop("ret", None)
    return {
        "schema": 1, "kind": "wgl", "platform": plat,
        "engine": "device", "shapes": shapes, "kernel": kern,
        "pack": pack, "pack_estimated": pack_estimated,
        "adaptive": bool(use_adapt), "buckets": buckets,
        "plan": nodes,
        "hbm": {"peak_bytes": peak, "budget_bytes": budget},
        "compiles": {"cold_max": len(cold), "cold": cold,
                     "budget": cbudget},
        "fill": {"predicted": fill_pred, "target": occ_mod.TARGET_FILL,
                 "start_K": k_start},
        "rules": rules, "verdict": verdict, "suggestion": suggestion,
    }


# ---------------------------------------------------------------------------
# Elle: route + closure capacity plan
# ---------------------------------------------------------------------------

def _fleet_shards(w: int, devices=None) -> tuple:
    """(n_shards, assumed?) of the sharded closure's word-column split,
    as the engine (`elle/tpu.py`) splits it: the caller's device list
    (`util.resolve_devices`), else every card, else the one host.
    Nothing is assumed: the count is the list's."""
    from ..parallel.mesh import word_shard_count

    if devices is not None:
        return word_shard_count(w, len(devices)), False
    try:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    except Exception:  # noqa: BLE001 — no torch CUDA: one host
        n = 1
    return word_shard_count(w, max(1, n)), False


def plan_elle_sharded(*, n_txns: int, n_shards: Optional[int] = None,
                      platform: Optional[str] = None,
                      devices=None, rw_edges: Optional[int] = None) -> dict:
    """The sharded closure's plan node for `n_txns`: shard count (from
    the caller's device list), per-shard bytes (the reference's
    model: one gathered row-set copy plus 2/n_shards writable column
    blocks), the gather bytes each squaring moves, and `hbm_bytes`, the
    bytes of the busiest card: every shard it holds, billed by the
    port's own buffers (`occupancy.elle_closure_bytes`: the input block
    and two spares a shard beside its gather, the label pass's outputs)
    and never under the reference's model."""
    import math

    from .. import occupancy
    from ..elle import tpu as elle_tpu

    n = int(n_txns)
    n_sub = len(elle_tpu.SUBSETS)
    n_pad = elle_tpu._round_up(
        max(elle_tpu._bucket(max(n, 2)), n + 2), 128)
    iters = max(1, math.ceil(math.log2(max(n_pad, 2))))
    assumed = False
    if n_shards is None:
        n_shards, assumed = _fleet_shards(n_pad // 32, devices)
    ns = max(1, int(n_shards))
    bitset = n_sub * n_pad * (n_pad // 32) * 4
    per_shard = int(bitset * (1.0 + 2.0 / ns))
    per_card = _shards_per_card(devices, ns)
    card = max(per_shard * per_card, occupancy.elle_closure_bytes(
        "sharded", S=n_sub, n_pad=n_pad, e=0,
        q=int(rw_edges) if rw_edges is not None else n, n_shards=ns,
        shards_per_card=per_card))
    return {"kernel": "sharded", "n_pad": n_pad, "iters": iters,
            "n_shards": ns, "shards_assumed": assumed,
            "shard_words": (n_pad // 32) // ns,
            "per_shard_bytes": per_shard,
            "shards_per_card": per_card,
            "gather_bytes_per_iter": int(bitset),
            "hbm_bytes": card,
            "capacity": elle_tpu.SHARDED_MAX_N}


def plan_elle(*, n_txns: int, edges: Optional[int] = None,
              rw_edges: Optional[int] = None, backend: str = "auto",
              platform: Optional[str] = None, devices=None,
              lower: bool = False) -> dict:
    """Enumerate the cycle-engine plan an Elle check over `n_txns` graph
    nodes would take: the `ops/route.elle_cycle_route` decision (for
    `backend="auto"`), the kernel the shape selector would pick (trim on
    the CPU, bf16 vs packed vs sharded on the card; `lower=True` asks
    `elle/tpu._squaring_select` itself), the closure's padded shapes and
    bytes, and the capacity rules that fire. Past a one-card cap the plan
    carries a `plan_elle_sharded` node: when the devices and the
    per-card bill allow, P002 degrades onto the sharded closure instead
    of rejecting. Edge counts default to the append builder's typical
    density (~4 edges and ~1 rw edge per txn), labeled as estimates.
    Backend names are the port's: "cuda" is the reference's "tpu"."""
    import math

    from .. import occupancy
    from ..ops.route import elle_cycle_route

    plat, devs = _resolve(platform, devices)
    accel = plat == "cuda"
    n = int(n_txns)
    e = int(edges) if edges is not None else 4 * n
    rw = int(rw_edges) if rw_edges is not None else n
    estimated = edges is None or rw_edges is None
    rules: list = []

    from ..elle import tpu as elle_tpu
    packed_cap = elle_tpu.PACKED_MAX_N
    bf16_cap = elle_tpu.DEFAULT_MAX_N
    sharded_cap = elle_tpu.SHARDED_MAX_N
    n_pad = elle_tpu._round_up(
        max(elle_tpu._bucket(max(n, 2)), n + 2), 128)
    n_shards, shards_assumed = _fleet_shards(n_pad // 32, devs)

    engine = backend
    route_reason = None
    if backend == "auto":
        engine, route_reason = elle_cycle_route(
            n=n, e=e, rw_edges=rw, accel=accel, device_ok=True,
            packed_cap=packed_cap, sharded_cap=sharded_cap,
            n_shards=n_shards)

    if engine in ("host", "host-fallback"):
        verdict, suggestion = _verdict(rules)
        return {"schema": 1, "kind": "elle", "platform": plat,
                "engine": "host", "backend": backend,
                "route": {"engine": "host", "reason": route_reason},
                "shapes": {"n": n, "e": e, "rw": rw,
                           "estimated": estimated},
                "plan": [{"kernel": "host-tarjan",
                          "host_work": rw * max(e, 1)}],
                "rules": rules, "verdict": verdict,
                "suggestion": suggestion}

    # -- kernel selection (device_cycle_search's) -----------------------
    forced = backend in ("cuda", "packed", "trim", "sharded")
    if forced:
        kernel = "bf16" if backend == "cuda" else backend
        sel = {"why": f"forced {kernel}"}
    elif engine == "sharded":
        kernel, sel = "sharded", {"why": route_reason}
    elif accel:
        if lower and _has_card():
            kernel, sel = elle_tpu._squaring_select(
                n, _first_card(devs), devs)
        elif n > packed_cap:
            if n <= sharded_cap and n_shards >= 2:
                kernel, sel = "sharded", {
                    "why": f"n {n} > packed cap {packed_cap}; "
                           f"{n_shards}-shard word columns (static)"}
            else:
                kernel, sel = "packed", {
                    "why": f"n {n} > packed cap {packed_cap} and no "
                           f"shardable device list ({n_shards} shards)"}
        elif n > bf16_cap:
            kernel, sel = "packed", {
                "why": f"n {n} > bf16 cap {bf16_cap}"}
        else:
            kernel, sel = "bf16", {"why": "bf16 under cap (static)"}
    else:
        kernel, sel = "trim", {
            "why": "cpu device: dense squaring is compute-prohibitive; "
                   "trim kernel"}

    # -- padded shapes + capacity + bytes -------------------------------
    n_sub = len(elle_tpu.SUBSETS)
    iters = max(1, math.ceil(math.log2(max(n_pad, 2))))
    cap = {"bf16": bf16_cap, "sharded": sharded_cap}.get(kernel,
                                                         packed_cap)
    budget = device_memory_budget(plat, devs)
    orig_kernel, orig_cap = kernel, cap
    sharded_node = None
    if kernel == "sharded" or n > cap:
        sharded_node = plan_elle_sharded(n_txns=n, n_shards=n_shards,
                                         platform=plat, devices=devs,
                                         rw_edges=rw)
        sharded_node["shards_assumed"] = shards_assumed
    if n > cap:
        # past a one-card cap the sharded layout is the one dense
        # remedy: only kernels whose run falls through to it (packed,
        # trim) degrade onto it; a forced bf16 request does not
        fits = (kernel in ("packed", "trim") and n <= sharded_cap
                and n_shards >= 2 and sharded_node["hbm_bytes"] <= budget)
        if fits:
            rules.append(_rule(
                "P002",
                f"n {n} over the {kernel} closure capacity {cap}: "
                f"degrading to the sharded closure ({n_shards} "
                f"word-column shards, "
                f"{sharded_node['per_shard_bytes'] / 1e9:.2f} GB per "
                f"shard)",
                suggestion="sharded closure selected "
                           "(backend=\"sharded\" pins it); a longer "
                           "device list makes smaller shards",
                severity="degrade"))
            kernel = "sharded"
            cap = sharded_cap
            sel = {"why": f"degrade(sharded): {sel.get('why')}",
                   "n_shards": n_shards}
        elif kernel == "sharded":
            rules.append(_rule(
                "P002",
                f"n {n} over the sharded closure capacity {cap}: "
                "past it the gathered row set alone blows a card",
                suggestion="host Tarjan/BFS"))
        else:
            why_not = (f"n {n} over the sharded cap {sharded_cap}"
                       if n > sharded_cap else
                       f"the devices yield only {n_shards} word shard(s)"
                       if n_shards < 2 else
                       f"{sharded_node['hbm_bytes'] / 1e9:.2f} GB on a "
                       f"card over the {budget / 1e9:.2f} GB budget")
            rules.append(_rule(
                "P002",
                f"n {n} over the {kernel} closure capacity {cap} "
                f"and the sharded remedy does not hold it ({why_not})",
                suggestion="host Tarjan/BFS, or a longer device list so "
                           "the sharded word columns fit "
                           "(backend=\"sharded\")"))
    if kernel == "bf16":
        cell = 2.0            # bf16
    elif kernel == "packed":
        cell = 1.0 / 8.0      # one bit per pair, uint32 words
    else:
        cell = 0.0            # trim / sharded: billed below
    if kernel == "sharded":
        hbm = sharded_node["hbm_bytes"]
    elif cell:
        # never under the port's own buffers (the seed, two squaring
        # buffers, the inputs and the label pass's outputs)
        hbm = max(int(CLOSURE_LIVE_FACTOR * n_sub * n_pad * n_pad * cell),
                  occupancy.elle_closure_bytes(kernel, S=n_sub,
                                               n_pad=n_pad, e=e, q=rw))
    else:
        # trim: the padded neighbor lists, then the wrapper's outputs
        # and scratch (the transposed lists: one entry an edge end, at
        # most 2 e masked slots)
        n_pad_t = elle_tpu._round_up(elle_tpu._bucket(max(n, 2)), 128)
        if accel:
            # on the card, the lists at the largest degree bucket a graph
            # of e edges can need and the trim takes (past
            # TRIM_MAX_DEGREE they go to the closures): the gate runs
            # before the build, and the mean degree 2 e / n says nothing
            # of the largest (wr 3k: mean 8, out-degree bucket 64)
            d = min(elle_tpu.TRIM_MAX_DEGREE, elle_tpu._bucket(max(4, e)))
            inputs = occupancy.trim_input_bytes(n_pad_t, d, d, n_sub)
        else:
            # on the CPU (the host trim, csrc/elle_trim_host.cpp) the
            # reference's estimate, padded neighbor gathers at the mean
            # degree
            d = elle_tpu._bucket(max(4, (2 * e) // max(n, 1)))
            inputs = int(3 * n_pad_t * d * n_sub * 4)
        hbm = inputs + occupancy.trim_alloc_bytes(n_pad_t, 2 * e, n_sub,
                                                  d_max=d)
    if hbm > budget:
        if backend == "auto":
            # auto still holds the host engine: degrade, not reject
            rules.append(_rule(
                "P006", "route picked the device closure but its "
                        f"cost model blows the budget ({hbm / 1e9:.2f} "
                        "GB): trust the cost side",
                suggestion="host Tarjan/BFS"))
        else:
            per = " on a card" if kernel == "sharded" else ""
            rules.append(_rule(
                "P001", f"{kernel} closure peak {hbm / 1e9:.2f} GB"
                        f"{per} exceeds the {budget / 1e9:.2f} GB "
                        "device budget",
                suggestion="host Tarjan/BFS, or a longer device list so "
                           "the sharded word columns fit "
                           "(backend=\"sharded\")"
                if kernel == "sharded" else
                "host Tarjan/BFS, or shard the bitset words over the "
                "devices (backend=\"sharded\")"))

    if kernel == "sharded":
        plan = ([{"kernel": orig_kernel, "n_pad": n_pad, "iters": iters,
                  "hbm_bytes": int(CLOSURE_LIVE_FACTOR * n_sub * n_pad
                                   * n_pad * (2.0 if orig_kernel == "bf16"
                                              else 0.125)),
                  "capacity": orig_cap}, sharded_node]
                if orig_kernel != "sharded" else [sharded_node])
    else:
        plan = [{"kernel": kernel, "n_pad": n_pad, "iters": iters,
                 "hbm_bytes": hbm, "capacity": cap}]

    verdict, suggestion = _verdict(rules)
    return {
        "schema": 1, "kind": "elle", "platform": plat,
        "engine": "device", "backend": backend,
        "route": {"engine": "device", "reason": route_reason},
        "shapes": {"n": n, "e": e, "rw": rw, "n_pad": n_pad,
                   "iters": iters, "estimated": estimated,
                   "n_shards": n_shards,
                   "shards_assumed": shards_assumed},
        "kernel": kernel, "select": sel,
        "plan": plan,
        "hbm": {"peak_bytes": hbm, "budget_bytes": budget},
        "rules": rules, "verdict": verdict, "suggestion": suggestion,
    }


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()


def _first_card(devs):
    import torch
    for d in devs or ():
        if d.type == "cuda":
            return d
    return torch.device("cuda", torch.cuda.current_device())


def elle_closure_feasible(n_txns: int, platform: Optional[str] = None,
                          devices=None) -> tuple:
    """(feasible?, report) for a dense device closure over `n_txns`."""
    rep = plan_elle(n_txns=n_txns, backend="device", platform=platform,
                    devices=devices)
    return rep["verdict"] != "infeasible", rep


# ---------------------------------------------------------------------------
# recording + gates
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_RECENT: deque = deque(maxlen=32)
_COUNTS: dict = {}


def compact(report: dict) -> dict:
    """The bounded projection of a plan report that rides gate results
    (the full plan nodes stay with the CLI/report path)."""
    out = {k: report.get(k) for k in
           ("schema", "kind", "platform", "engine", "kernel",
            "buckets", "verdict", "suggestion")
           if report.get(k) is not None}
    out["rules"] = [{"rule": r["rule"], "name": r["name"],
                     "severity": r["severity"],
                     "message": r["message"]}
                    for r in report.get("rules", [])]
    hbm = report.get("hbm") or {}
    if hbm.get("peak_bytes") is not None:
        out["hbm_peak_bytes"] = hbm["peak_bytes"]
        out["hbm_budget_bytes"] = hbm.get("budget_bytes")
    return out


def _register(report: dict, where: str,
              ledger_name: Optional[str] = None) -> None:
    """Record one verdict in the in-process recent window (`snapshot`),
    with metrics on as a `preflight` series point and a
    `preflight_checks_total{where, verdict}` count (the reference's
    names), and, when `ledger_name` names a top-level analysis, as a
    kind="preflight" record of the ambient run ledger (the reference's
    record). Accounting never voids an admission decision."""
    entry = {"where": where, "kind": report.get("kind"),
             "verdict": report.get("verdict"),
             "engine": report.get("engine"),
             "rules": [r["rule"] for r in report.get("rules", [])],
             "hbm_peak_bytes": (report.get("hbm") or {}).get("peak_bytes"),
             "t": round(time.time(), 3)}
    with _LOCK:
        _RECENT.append(entry)
        _COUNTS[entry["verdict"]] = _COUNTS.get(entry["verdict"], 0) + 1
    from .. import metrics as metrics_mod
    mx = metrics_mod.get_default()
    if mx.enabled:
        mx.series("preflight", "admission-control preflight verdicts"
                  ).append(dict(entry))
        mx.counter("preflight_checks_total",
                   "preflight admission decisions").inc(
            where=where, verdict=str(entry["verdict"]))
    if ledger_name:
        try:
            from .. import ledger as ledger_mod
            ledger_mod.record({
                "kind": "preflight", "name": ledger_name,
                "verdict": str(report.get("verdict")),
                "engine": report.get("engine"),
                "where": where,
                "rules": entry["rules"],
                "preflight": compact(report)})
        except Exception:  # noqa: BLE001
            pass


def snapshot() -> dict:
    """The status block: how many admission decisions this process made,
    their verdict mix, and a bounded recent window."""
    with _LOCK:
        recent = list(_RECENT)[-8:]
        counts = dict(_COUNTS)
    return {"checked": sum(counts.values()), "verdicts": counts,
            "recent": recent}


def _reject(report: dict, op_count: Optional[int] = None) -> dict:
    out = {"valid?": "unknown", "cause": "preflight",
           "preflight": compact(report),
           "rules": [r["rule"] for r in report.get("rules", [])
                     if r["severity"] == "infeasible"]}
    if op_count is not None:
        out["op_count"] = op_count
    return out


def gate_wgl(model, history, *, where: str, enc=None,
             platform: Optional[str] = None, devices=None,
             ledger_name: Optional[str] = None) -> Optional[dict]:
    """The WGL admission gate: None when the plan is admissible
    (feasible or degrade), else the reference's `{"valid?": "unknown",
    "cause": "preflight", ...}`. A shape probe plus integer plan math:
    no encode table, no kernel build, no device byte. `ledger_name`
    banks the analysis as a kind="preflight" ledger record."""
    try:
        rep = plan_wgl(model, history, enc=enc, platform=platform,
                       devices=devices)
    except Exception:  # noqa: BLE001 — an unplannable history is the
        return None    # search engines' problem, not the gate's
    _register(rep, where, ledger_name=ledger_name)
    if rep["verdict"] != "infeasible":
        return None
    return _reject(rep, op_count=len(history))


def gate_elle(n_txns: int, *, backend: str, where: str,
              edges: Optional[int] = None,
              rw_edges: Optional[int] = None,
              platform: Optional[str] = None,
              devices=None,
              ledger_name: Optional[str] = None) -> Optional[dict]:
    """The Elle admission gate: rejects a device cycle search whose
    closure can never fit (P001/P002) before any graph build, kernel
    build or device byte. None when admissible. `ledger_name` as in
    `gate_wgl`."""
    try:
        rep = plan_elle(n_txns=n_txns, edges=edges, rw_edges=rw_edges,
                        backend=backend, platform=platform,
                        devices=devices)
    except Exception:  # noqa: BLE001
        return None
    _register(rep, where, ledger_name=ledger_name)
    if rep["verdict"] != "infeasible":
        return None
    return _reject(rep)


def plan_batch(encs, *, n_devices: int = 1, platform: Optional[str] = None,
               devices=None) -> dict:
    """The plan of the lane-batched (vmap) fan-out: one kernel over the
    batch's shared shape bucket (wgln when any lane is wide), each card
    billed for its ceil(lanes / n_devices) lanes times the device entries
    that name it."""
    from ..parallel.batched import shared_shape_bucket

    bucket = shared_shape_bucket(list(encs))
    rep_enc = max(encs, key=lambda e: (e.window_raw > 32, len(e.inv)))
    per_dev = (-(-len(encs) // max(n_devices, 1))
               * _shards_per_card(_resolve(platform, devices)[1], n_devices))
    return plan_wgl(enc=rep_enc, platform=platform, devices=devices,
                    shape_bucket=bucket, lanes=per_dev)


def gate_fanout(model, histories, *, encs=None, where: str,
                platform: Optional[str] = None, devices=None,
                mode: str = "group", n_devices: int = 1,
                on_infeasible: str = "reject") -> Optional[dict]:
    """Admission gate for the fan-out paths, over the shared shape
    bucket each kernel branch runs (`parallel.shared_shape_bucket`, keys
    split at window_raw 32 as the runtime splits them).

    mode="group" (the streamed path): the narrow and wide groups run
    separate kernels and each lane runs alone, so an infeasible bucket
    rejects only within its group, and only the keys whose own plan is
    infeasible, the survivors' bucket re-planned; the whole group
    rejects only when every key fits alone but the maxima do not.
    mode="batch" (the vmap path): every lane is padded to the batch
    maxima and ceil(lanes / n_devices) lanes sit on each device; an
    infeasible plan rejects every key. `on_infeasible="degrade"`
    records the decision as a degrade, for callers that answer an
    infeasible batch by streaming per-key kernels.

    Returns {key index: rejection} for the rejected keys, or None when
    admissible. Without encs each key is gated on its own probe plan."""
    rejected: dict = {}
    try:
        if encs:
            from ..parallel.batched import shared_shape_bucket
            if mode == "batch":
                rep = plan_batch(encs, n_devices=n_devices,
                                 platform=platform, devices=devices)
                if rep["verdict"] == "infeasible" \
                        and on_infeasible == "degrade":
                    _register(dict(rep, verdict="degrade",
                                   suggestion="stream per-key kernels "
                                              "(check_streamed)"),
                              where)
                else:
                    _register(rep, where)
                if rep["verdict"] == "infeasible":
                    rej = _reject(rep)
                    rejected = {i: rej for i in range(len(encs))}
                return rejected or None

            def _bucket_plan(idxs):
                grp = [encs[i] for i in idxs]
                bucket = shared_shape_bucket(grp)
                rep_enc = max(grp, key=lambda e: (len(e.inv),
                                                  e.window_raw))
                rep = plan_wgl(enc=rep_enc, platform=platform,
                               devices=devices, shape_bucket=bucket)
                _register(rep, where)
                return rep

            idx_groups = (
                [i for i, e in enumerate(encs) if e.window_raw <= 32],
                [i for i, e in enumerate(encs) if e.window_raw > 32])
            for idxs in idx_groups:
                if not idxs:
                    continue
                rep = _bucket_plan(idxs)
                if rep["verdict"] != "infeasible":
                    continue
                survivors = []
                for i in idxs:
                    own = plan_wgl(enc=encs[i], platform=platform,
                                   devices=devices)
                    if own["verdict"] == "infeasible":
                        _register(own, where)
                        rejected[i] = _reject(own)
                    else:
                        survivors.append(i)
                if not survivors:
                    continue
                if len(survivors) == len(idxs):
                    rej = _reject(rep)
                    for i in survivors:
                        rejected[i] = rej
                    continue
                rep2 = _bucket_plan(survivors)
                if rep2["verdict"] == "infeasible":
                    rej = _reject(rep2)
                    for i in survivors:
                        rejected[i] = rej
        elif histories:
            for i, h in enumerate(histories):
                rep = plan_wgl(model, h, platform=platform,
                               devices=devices)
                _register(rep, where)
                if rep["verdict"] == "infeasible":
                    rejected[i] = _reject(rep)
    except Exception:  # noqa: BLE001 — an unplannable batch is the
        return None    # engines' problem, not the gate's
    return rejected or None


def plan_mesh(encs, *, n_devices: int,
              lanes_per_device: Optional[int] = None,
              platform: Optional[str] = None, devices=None,
              axes=("keys",),
              compile_budget: Optional[int] = None,
              shape_bucket: Optional[dict] = None) -> dict:
    """The mesh fan-out's plan report (`parallel/mesh.py`): one node per
    (lane group x ladder bucket), each billed for `lanes_per_device`
    resident lanes a shard, times the shards a card of `devices` holds.
    P001 fires when a card's lane groups blow the budget; the caller
    (`gate_mesh`) degrades an infeasible report to the streamed path."""
    from ..parallel import mesh as mesh_mod
    from ..parallel.batched import shared_shape_bucket

    plat, devs = _resolve(platform, devices)
    s_d = int(lanes_per_device or mesh_mod.MESH_LANES_PER_DEVICE)
    per_card = _shards_per_card(devs, n_devices)
    groups = [("narrow", [i for i, e in enumerate(encs)
                          if e.window_raw <= 32]),
              ("wide", [i for i, e in enumerate(encs)
                        if e.window_raw > 32])]
    nodes: list = []
    rules: list = []
    group_reports: list = []
    for gname, idxs in groups:
        if not idxs:
            continue
        grp = [encs[i] for i in idxs]
        bucket = (dict(shape_bucket) if shape_bucket is not None
                  else shared_shape_bucket(grp))
        g_sd = s_d * per_card
        rep_enc = max(grp, key=lambda e: (len(e.inv), e.window_raw))
        rep = plan_wgl(enc=rep_enc, platform=plat, devices=devs,
                       shape_bucket=bucket, lanes=g_sd,
                       compile_budget=compile_budget)
        mesh_note = {"group": gname, "keys": len(idxs),
                     "n_devices": int(n_devices),
                     "lanes_per_device": s_d, "shards_per_card": per_card,
                     "axes": [str(a) for a in axes]}
        for node in rep.get("plan", []):
            nodes.append(dict(node, mesh=dict(mesh_note)))
        for r in rep.get("rules", []):
            if r["rule"] == "P003":
                r = dict(r, suggestion="warm the mesh plan first: "
                                       "aot.precompile_mesh_plan("
                                       "shape_bucket, devices)")
            rules.append(r)
        group_reports.append({"group": gname, "keys": len(idxs),
                              "kernel": rep.get("kernel"),
                              "buckets": rep.get("buckets"),
                              "verdict": rep["verdict"]})
    verdict, suggestion = _verdict(rules)
    peak = max((nd["hbm_bytes"] for nd in nodes), default=0)
    cold = _cold_modules(sorted({nd["kernel"] + "_chunk_batched"
                                 for nd in nodes}), plat)
    return {
        "schema": 1, "kind": "mesh", "platform": plat,
        "engine": "device",
        "mesh": {"n_devices": int(n_devices), "lanes_per_device": s_d,
                 "shards_per_card": per_card,
                 "axes": [str(a) for a in axes]},
        "groups": group_reports, "plan": nodes,
        "hbm": {"peak_bytes": peak,
                "budget_bytes": device_memory_budget(plat, devs)},
        "compiles": {"cold_max": len(cold), "cold": cold,
                     "budget": _compile_budget(compile_budget)},
        "rules": rules, "verdict": verdict, "suggestion": suggestion,
    }


def gate_mesh(encs, *, n_devices: int,
              lanes_per_device: Optional[int] = None,
              where: str = "parallel.mesh",
              platform: Optional[str] = None, devices=None,
              axes=("keys",),
              shape_bucket: Optional[dict] = None) -> Optional[dict]:
    """Admission gate for the mesh fan-out: None when admissible, else
    the report. The caller answers by streaming per-key kernels, so the
    decision recorded is a degrade, never a rejection."""
    try:
        rep = plan_mesh(encs, n_devices=n_devices,
                        lanes_per_device=lanes_per_device,
                        platform=platform, devices=devices, axes=axes,
                        shape_bucket=shape_bucket)
    except Exception:  # noqa: BLE001 — an unplannable batch is the
        return None    # engines' problem, not the gate's
    if rep["verdict"] == "infeasible":
        _register(dict(rep, verdict="degrade",
                       suggestion="stream per-key kernels "
                                  "(check_streamed)"), where)
        return rep
    _register(rep, where)
    return None


# ---------------------------------------------------------------------------
# CLI (`python -m jepsen_tpu_torch preflight`)
# ---------------------------------------------------------------------------

CLI_CONFIGS = ("headline", "elle_append_8k", "dense_100k")


def _peak_of(fn, device) -> tuple:
    """(result, the bytes the call allocated at its peak on `device`
    over what was allocated before it; None on the CPU), through the
    device monitor's peak window (`devices.reset_peak`,
    `devices.read_memory_stats`)."""
    import torch

    from .. import devices

    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    before = devices.reset_peak(device)
    res = fn()
    torch.cuda.synchronize(device)
    return res, devices.read_memory_stats(device)["peak_bytes_in_use"] \
        - before


def _cli_headline(n_ops: int, execute: bool, device=None) -> dict:
    from .. import synth
    from ..models import cas_register
    from ..util import resolve_device

    dev = resolve_device(device)
    model = cas_register()
    hist = synth.cas_register_history(n_ops, n_procs=5, seed=42,
                                      crash_p=0.002)
    rep = plan_wgl(model, hist, lower=True, devices=[dev])
    _register(rep, "cli.headline", ledger_name="preflight-headline")
    out = {"report": rep}
    if execute:
        from .. import metrics as metrics_mod
        from ..ops import wgl
        # a registry of its own: the result's occupancy block carries
        # the measured bytes a round
        res, peak = _peak_of(lambda: wgl.check(
            model, hist, device=dev, metrics=metrics_mod.Registry()), dev)
        out["executed"] = _parity(rep, res, peak)
    return out


def _cli_elle(n_txns: int, execute: bool, device=None) -> dict:
    from .. import synth
    from ..elle import build as build_mod
    from ..elle import tpu as elle_tpu
    from ..elle.graph import RW
    from ..util import resolve_device

    dev = resolve_device(device)
    hist = synth.list_append_history(n_txns, n_procs=5, seed=7)
    oks = [op for op in hist
           if op.is_ok and op.f in ("txn", None) and op.value]
    infos = [op for op in hist
             if op.is_info and op.f in ("txn", None) and op.value]
    gt = build_mod.build_append(hist, oks, infos,
                                additional_graphs=("realtime",)).tensors
    edges = np.asarray(gt.edges)
    rw = int(np.sum(edges[:, 2] == RW)) if len(edges) else 0
    rep = plan_elle(n_txns=int(np.asarray(gt.nodes).shape[0]),
                    edges=int(len(edges)), rw_edges=rw, backend="auto",
                    devices=[dev], lower=True)
    _register(rep, "cli.elle_append_8k",
              ledger_name="preflight-elle-append-8k")
    out = {"report": rep}
    if execute:
        res, peak = _peak_of(lambda: elle_tpu.standard_cycle_search(
            gt, backend="auto", device=dev), dev)
        out["executed"] = {
            "engine": res.get("engine"),
            "kernel": (res.get("util") or {}).get("kernel"),
            "engine_match": _engines_match(rep, res),
            "peak_bytes_predicted": (rep.get("hbm") or {}).get(
                "peak_bytes"),
            "peak_bytes_measured": peak,
        }
    return out


def _cli_dense_100k(device=None) -> dict:
    """The oversized request: a 100k-txn packed closure, decided
    statically (no graph build, no kernel build, no device byte): it
    degrades onto the sharded closure when the device list yields >= 2
    word shards whose bill fits, else it is rejected."""
    devices = None if device is None else [device]
    rep = plan_elle(n_txns=100_000, backend="packed", devices=devices)
    _register(rep, "cli.dense_100k", ledger_name="preflight-dense-100k")
    return {"report": rep}


def _engines_match(rep: dict, res: dict) -> bool:
    planned = rep.get("engine")
    ran = res.get("engine")
    if planned == "host":
        return ran in ("host", "host-fallback")
    kernel = (res.get("util") or {}).get("kernel")
    return ran in ("device", "cuda", "trim", "packed", "sharded") \
        and (rep.get("kernel") in (None, kernel))


def _parity(rep: dict, res: dict, peak_measured: Optional[int] = None
            ) -> dict:
    """Planned against executed for the WGL path: did the check stay
    inside the planned buckets, on the planned kernel, how far is the
    measured per-round byte stream (the result's `occupancy.roofline`,
    present when metrics were on) from the plan's prediction for the
    bucket it ended on, and how do the plan's bytes compare with what
    the check allocated at its peak on the card."""
    util = res.get("util") or {}
    adapt = util.get("adapt") or {}
    visited = [b for b in (adapt.get("buckets_visited")
                           or [res.get("K")]) if b]
    planned = rep.get("buckets") or []
    pred = None
    for node in rep.get("plan", []):
        if node.get("K") == res.get("K") and node.get("cost"):
            pred = node["cost"].get("bytes_accessed")
    peak_pred = (rep.get("hbm") or {}).get("peak_bytes")
    measured = ((res.get("occupancy") or {}).get("roofline")
                or {}).get("bytes_per_round")
    out = {
        "verdict": res.get("valid?"),
        "kernel_match": ("wgl32" if res.get("W", 33) <= 32
                         else "wgln") == rep.get("kernel"),
        "buckets_planned": planned,
        "buckets_visited": visited,
        "buckets_subset": all(k in planned for k in visited),
        "bytes_per_round_predicted": pred,
        "bytes_per_round_measured": measured,
        "peak_bytes_predicted": peak_pred,
        "peak_bytes_measured": peak_measured,
    }
    if pred and measured:
        out["drift_x"] = round(measured / pred, 4)
    if peak_pred and peak_measured:
        out["peak_ratio"] = round(peak_pred / peak_measured, 4)
    return out


def cli_main(options: dict) -> int:
    """`python -m jepsen_tpu_torch preflight`: print the plan reports of
    the named config(s); `execute` also runs the check on the card and
    prints the planned-against-executed block."""
    import json as json_mod

    which = options.get("config") or "all"
    execute = bool(options.get("execute"))
    device = options.get("device")
    names = list(CLI_CONFIGS) if which == "all" else [which]
    out: dict = {}
    for name in names:
        if name == "headline":
            out[name] = _cli_headline(int(options.get("ops") or 10_000),
                                      execute, device)
        elif name == "elle_append_8k":
            out[name] = _cli_elle(int(options.get("txns") or 4_000),
                                  execute, device)
        elif name == "dense_100k":
            out[name] = _cli_dense_100k(device)
        else:
            print(f"unknown preflight config {name!r} "
                  f"(known: {', '.join(CLI_CONFIGS)} | all)")
            return 254
    if options.get("json"):
        print(json_mod.dumps(out, indent=2, default=str))
    else:
        for name, blk in out.items():
            rep = blk["report"]
            rules = ", ".join(r["rule"] for r in rep["rules"]) or "-"
            peak = ((rep.get("hbm") or {}).get("peak_bytes") or 0) / 1e9
            print(f"{name:18s} verdict={rep['verdict']:10s} "
                  f"engine={rep.get('engine')} "
                  f"kernel={rep.get('kernel', '-')} "
                  f"buckets={rep.get('buckets', '-')} "
                  f"hbm={peak:.3f}GB rules=[{rules}]")
            if rep.get("suggestion"):
                print(f"{'':18s} -> {rep['suggestion']}")
            if "executed" in blk:
                print(f"{'':18s} executed: {blk['executed']}")
    return 0
