"""`python -m jepsen_tpu_torch.bench [--device DEV] [--ops N] [--root DIR]`:
the port's bench round.

The reference's `bench.py` on the port. The headline: a cas-register
history of N invocations (default 10000, `JEPSEN_TPU_BENCH_OPS`; 5
processes, seed 42, crash probability 0.002) checked once cold by
`ops/wgl.check`, then re-checked warm inside `CompileGuard(name=
"bench-warm")`, on the card unless `--device cpu`. Then, unless
`JEPSEN_TPU_BENCH_EXTRAS=0`, the rest of the BASELINE matrix in the same
process (`run_extras`): register 500 and mutex 1k through
`ops/route.check_routed`, a 100k-op FIFO queue behind `competition`, the
16-wave adversarial history on the device and on the host oracle, the
900-op long tail, Elle append and rw-register 3k, append 4k with its
host row, append over word-column shards with its packed and host rows,
the independent fan-out, and the mesh fan-out against its streamed row.
Where the reference runs a device mesh, the port runs `[card] *
MESH_SHARDS`. Each config's entry in the details file also says which
kernels its measured window launched, and how many times (`launches`;
the headline's is the warm check's). A config that would start with less than its `need`
seconds left before `JEPSEN_TPU_BENCH_TOTAL_S` is skipped and recorded;
its warm-up and history are not made then.

The round installs one metrics registry, one tracer, a run ledger, a
watchdog and a device monitor; banks a `kind="bench"` record per config
and one `kind="bench-round"` and `kind="bench-occupancy"` record per
round; compares the round with the best prior round on the same platform
(`compute_regressions`, on `drift.py`); diagnoses it (`doctor.py`); and
writes the full result, the telemetry and the reports under the root
(default: the checkout holding this package):

    artifacts/torch/BENCH_DETAILS.json      the full result
    artifacts/torch/telemetry/              metrics JSONL and Prometheus,
                                            trace JSONL and Perfetto,
                                            regressions.json,
                                            occupancy.json, doctor.json,
                                            bench-trajectory.png and
                                            occupancy-heatmap.png (with
                                            matplotlib)
    artifacts/torch/bench-profile/          the profiled check
    store/torch/ledger/                     the run ledger

It never writes the JAX package's `BENCH_DETAILS.json`,
`artifacts/telemetry/` or `store/ledger`, and never reads its
`BENCH_r*.json` as priors. It prints one JSON line (the reference's
compact keys, with the port's headline keys `device_kind`, `compiles`,
`h2d`, `d2h` and `guard`):

    {"metric": "cas_register_10k_wgl_wall_s", "value": <warm wall s>,
     "unit": "s", "vs_baseline": 60 / value, "verdict": true,
     "platform": "gpu", "cold_s": ..., "regressions": {...},
     "occupancy_report": {...}, "preflight": {...}, "doctor": {...},
     "device_kind": ..., "compiles": 0, "h2d": 1, "d2h": ..., "guard":
     {...}, "configs": {name: {"verdict", "wall_s", "engine", ...}},
     "details": "artifacts/torch/BENCH_DETAILS.json"}

and exits 1 unless the headline's verdict is True (the history is
valid); without a card and without `--device cpu` the line says
`"verdict": "error"`. A SIGTERM prints the partial line.

Env knobs (the reference's): JEPSEN_TPU_BENCH_OPS (10000),
_BUDGET_S (120, per check), _EXTRAS (1), _TOTAL_S (930, the round's wall
budget), _KEYS / _PER_KEY (100 x 2000), _MESH_KEYS / _MESH_PER_KEY (24 x
600), _ELLE_TXNS (2000, the sharded config), _REGRESSION_X (1.5),
_FILL_TARGET (0.8), _COMPILE_BUDGET (unset), _TRACE_DIR (the profile;
"" skips it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Optional, Sequence

from .ledger import BASE_DIR

# Where the round writes, relative to its root. The one place the port
# names these paths; `doctor.bench_view` reads them back.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART_DIR = os.path.join("artifacts", "torch")
TELEMETRY_DIR = os.path.join(ART_DIR, "telemetry")
DETAILS_FILE = os.path.join(ART_DIR, "BENCH_DETAILS.json")
PROFILE_DIR = os.path.join(ART_DIR, "bench-profile")
STORE_DIR = BASE_DIR

# shards of the card that play the reference's device mesh
MESH_SHARDS = 2

# the keys of a check's result a config entry keeps (the reference's
# `_config_entry`)
CONFIG_KEYS = ("W", "W_pad", "K", "configs_explored", "cause", "engine",
               "route_reason", "shape", "util", "device_row", "oracle_row",
               "mesh", "streamed_row", "speedup_vs_streamed", "parity")

# the reference's compact-line keys (less `tpu_measured`), then the
# port's headline keys
COMPACT_KEYS = ("metric", "value", "unit", "vs_baseline", "verdict",
                "platform", "cold_s", "terminated", "error", "cause",
                "regressions", "occupancy_report",
                "compile_budget_exceeded", "preflight", "doctor",
                "device_kind", "compiles", "h2d", "d2h", "guard")


def _rel(*parts: str) -> str:
    """A path under the root as the line lists it."""
    return "/".join(p.replace(os.sep, "/") for p in parts)


def _timed(fn, *args, **kw):
    t0 = time.monotonic()
    res = fn(*args, **kw)
    return res, time.monotonic() - t0


def _config_entry(res: dict, wall: float) -> dict:
    """One configuration's entry: verdict, wall, op count and the result
    keys of CONFIG_KEYS it has, its occupancy block compacted and its
    measured device memory, as in the reference."""
    out = {"verdict": res.get("valid?"), "wall_s": round(wall, 3),
           "op_count": res.get("op_count")}
    for k in CONFIG_KEYS:
        if res.get(k) is not None:
            out[k] = res[k]
    occ = res.get("occupancy")
    if isinstance(occ, dict):
        out["occupancy"] = {k: occ.get(k) for k in
                            ("kernel", "K", "rounds_total",
                             "rounds_dropped", "fill", "memo", "roofline")}
    hbm = _measured_hbm(res)
    if hbm is not None:
        out["hbm"] = hbm
    return out


def _measured_hbm(res: dict) -> Optional[dict]:
    """The compact measured-memory block of a result: from the result's
    own `hbm` window (wgl / batched) or the util's (Elle closure)."""
    hbm = res.get("hbm")
    if not isinstance(hbm, dict):
        hbm = (res.get("util") or {}).get("hbm") \
            if isinstance(res.get("util"), dict) else None
    if not isinstance(hbm, dict):
        return None
    out = {"peak_measured": hbm.get("peak_measured"),
           "stats_available": bool(hbm.get("stats_available"))}
    if hbm.get("stats_unavailable") or not out["stats_available"]:
        out["stats_unavailable"] = True
    return out


def _preflight_block(model, hist, res, dev) -> Optional[dict]:
    """The compact-line `preflight` block: the plan the admission
    analyzer predicted for this config (on `dev`) beside what the check
    did. lower="warm" reads predicted costs from the cache the executed
    check filled: no re-encode, no kernel launch."""
    from .analysis import preflight
    try:
        rep = preflight.plan_wgl(model, hist, lower="warm", devices=[dev])
        blk = {"verdict": rep["verdict"],
               "kernel": rep.get("kernel"),
               "buckets": rep.get("buckets"),
               "hbm_peak_bytes": (rep.get("hbm") or {}).get("peak_bytes"),
               "rules": [r["rule"] for r in rep["rules"]]}
        par = preflight._parity(rep, res)
        for k in ("buckets_visited", "buckets_subset", "pack_match",
                  "bytes_per_round_predicted",
                  "bytes_per_round_measured", "drift_x"):
            if par.get(k) is not None:
                blk[k] = par[k]
        _attach_hbm_drift(blk, res)
        return blk
    except Exception:  # noqa: BLE001 — the admission model must
        return None    # never cost a measured number


def _attach_hbm_drift(blk: dict, res: dict) -> None:
    """The measured peak beside the predicted `hbm_peak_bytes`, with
    `hbm_drift_x` = measured / predicted (`drift.drift_x`, the ratio the
    regression gate shares); the explicit marker where the device keeps
    no memory statistics."""
    from . import drift
    hbm = _measured_hbm(res)
    if hbm is None:
        return
    measured = hbm.get("peak_measured")
    if measured is None:
        blk["hbm_stats_unavailable"] = True
        return
    blk["hbm_peak_measured"] = measured
    ratio = drift.drift_x(measured, blk.get("hbm_peak_bytes"))
    if ratio is not None:
        blk["hbm_drift_x"] = ratio


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name; each counts its
    launches on the card in `.launches`."""
    from .elle import tpu as elle_tpu
    from .ops import wgl32, wgl_bool, wgln
    from .parallel import mesh
    return {"wgl32_chunk": wgl32.chunk, "wgln_chunk": wgln.chunk,
            "wgl_chunk": wgl_bool.chunk,
            "wgl32_chunk_batched": wgl32.chunk_batched,
            "wgln_chunk_batched": wgln.chunk_batched,
            "elle_closure": elle_tpu.closure,
            "elle_packed_closure": elle_tpu.packed_closure,
            "elle_trim": elle_tpu.trim,
            "wgl_lane_reset": mesh.reset_lanes,
            "wgl_frontier_migrate": mesh.migrate_lanes,
            "elle_sharded_square": elle_tpu.sharded_square}


def _launch_counts() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def _launched(before: dict) -> dict:
    """The kernels launched since `before` (`_launch_counts`), with how
    many times: the port's record of which config reached which
    kernel."""
    return {k: n - before[k] for k, n in _launch_counts().items()
            if n > before[k]}


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def run_extras(budget: float, deadline: float, dev) -> dict:
    """The non-headline BASELINE configs on `dev`; each failure is
    contained. A config that would start with less than its `need`
    seconds left before `deadline` (monotonic) is skipped and recorded;
    `warm` runs only for a config that starts, outside its measured
    window."""
    from . import synth
    from .models import cas_register, fifo_queue, mutex, register
    from .ops import route, wgl

    configs: dict = {}
    _PARTIAL["configs"] = configs  # fills in live for the SIGTERM path
    shards = [dev] * MESH_SHARDS

    def run(name, model, hist, checker=None, need=10, warm=None):
        left = deadline - time.monotonic()
        if left < need:
            configs[name] = {"verdict": "skipped",
                             "cause": f"time budget ({left:.0f}s left)"}
            print(f"config {name}: skipped, {left:.0f}s left",
                  file=sys.stderr)
            return
        try:
            if hist is not None and callable(hist):
                hist = hist()
            if warm is not None:
                warm()
            before = _launch_counts()
            t0 = time.monotonic()
            if checker is None:
                # shape-aware routing: near-serial / model-pruned
                # shapes decide on the jitlin sweep, branchy ones on
                # the device search (ops/route.py)
                res = route.check_routed(model, hist, time_limit=budget,
                                         device=dev)
            else:
                res = checker()
            _sync(dev)
            wall = time.monotonic() - t0
            configs[name] = _config_entry(res, wall)
            configs[name]["launches"] = _launched(before)
            if model is not None and hist is not None:
                pf = _preflight_block(model, hist, res, dev)
                if pf:
                    configs[name]["preflight"] = pf
            _ledger_record_config(name, res, wall)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc(file=sys.stderr)
            configs[name] = {"verdict": "error",
                             "error": f"{type(e).__name__}: {e}"[:300]}
        print(f"config {name}: {configs.get(name)}", file=sys.stderr)

    run("register_500", register(),
        lambda: synth.cas_register_history(500, n_procs=5, seed=7,
                                           fs=("read", "write")))
    run("mutex_1k", mutex(),
        lambda: synth.mutex_history(1000, n_procs=4, seed=7))

    # FIFO queue: state-space search explodes on queue histories, so
    # this config rides the polynomial queue checker behind competition
    def fifo():
        from . import checker as tchecker
        hq = synth.fifo_queue_history(100_000, n_procs=4, seed=7)
        # time_limit bounds the WGL fallback if the fast path declines
        return tchecker.linearizable(
            fifo_queue(), algorithm="competition", time_limit=budget,
            device=dev).check({}, hq, {})

    run("fifo_queue_100k", None, None, checker=fifo)

    # The device-or-nothing config: ~2.08M reachable configs behind a
    # W=71 window. Both engines run with a 60 s cap and both rows are
    # recorded: the oracle's DNF beside the device verdict.
    def adversarial():
        from .ops import wgl_ref
        ha = synth.adversarial_wave_history(16, width=14, span=5, seed=7)
        t0 = time.monotonic()
        r_dev = wgl.check(cas_register(), ha, time_limit=60.0, device=dev)
        _sync(dev)
        dev_wall = time.monotonic() - t0
        t0 = time.monotonic()
        r_ora = wgl_ref.check(cas_register(), ha, time_limit=60.0)
        ora_wall = time.monotonic() - t0
        dev_ok = r_dev.get("valid?") != "unknown"
        ora_ok = r_ora.get("valid?") != "unknown"
        out = {"valid?": (r_dev["valid?"] if dev_ok
                          else r_ora["valid?"] if ora_ok
                          else "unknown"),
               "op_count": r_dev.get("op_count"),
               "W": r_dev.get("W"), "K": r_dev.get("K"),
               "engine": ("device" if dev_ok else
                          "oracle" if ora_ok else
                          "none (both DNF on this platform)"),
               "configs_explored": r_dev.get("configs_explored"),
               "util": r_dev.get("util"),
               "device_row": {"verdict": r_dev.get("valid?"),
                              "wall_s": round(dev_wall, 2),
                              "cause": r_dev.get("cause")},
               "oracle_row": {"verdict": r_ora.get("valid?"),
                              "wall_s": round(ora_wall, 2),
                              "cause": r_ora.get("cause"),
                              "configs_explored":
                                  r_ora.get("configs_explored")}}
        if not dev_ok and not ora_ok:
            out["cause"] = r_dev.get("cause")
        return out

    run("adversarial_wave_2M", None, None, checker=adversarial, need=150)

    # The long tail (window 657) through the default competition
    # checker: the device search and the host oracle race
    def long_tail():
        from . import checker as tchecker
        ht = synth.long_tail_history(900, seed=7)
        return tchecker.linearizable(
            cas_register(), algorithm="competition", time_limit=budget,
            device=dev).check({}, ht, {})

    run("long_tail_900", None, None, checker=long_tail)

    # Elle: each config warms its closure shape bucket through
    # aot.precompile_elle_closure before its measured window
    from .elle import build as elle_build
    from .elle import tpu as elle_tpu
    from .ops import aot

    def _warm_elle(hist, build_fn, kernels=None, devices=None,
                   **build_kw):
        # split ops the way the checkers do, build the tensors and warm
        # their shape bucket: one helper, so the warm bucket cannot
        # drift from the measured shape
        try:
            oks = [op for op in hist
                   if op.is_ok and op.f in ("txn", None) and op.value]
            infos = [op for op in hist
                     if op.is_info and op.f in ("txn", None) and op.value]
            tensors = build_fn(hist, oks, infos, **build_kw).tensors
            aot.precompile_elle_closure(
                elle_tpu.shape_bucket_for(tensors), kernels=kernels,
                device=dev, devices=devices)
        except Exception:  # noqa: BLE001 — warm-up is best-effort;
            pass           # the measured run still decides correctly

    def _elle_entry(res, hist):
        out = {"valid?": res["valid?"],
               "op_count": len(hist) // 2,
               "engine": res.get("cycle-engine"),
               "route_reason": res.get("cycle-route-reason"),
               "util": res.get("cycle-util"),
               "cause": ",".join(res["anomaly-types"]) or None}
        try:
            # the Elle preflight block: planned route against executed
            from .analysis import preflight
            n = len([op for op in hist
                     if op.type in ("ok", "info")
                     and op.f in ("txn", None) and op.value])
            rep = preflight.plan_elle(n_txns=n, backend="auto",
                                      devices=[dev])
            ran = res.get("cycle-engine")
            out["preflight"] = {
                "verdict": rep["verdict"],
                "engine": rep["engine"],
                "kernel": rep.get("kernel"),
                "hbm_peak_bytes": (rep.get("hbm") or {}).get(
                    "peak_bytes"),
                "rules": [r["rule"] for r in rep["rules"]],
                "engine_match": ((rep["engine"] == "host")
                                 == (ran in ("host", "host-fallback")))}
            _attach_hbm_drift(out["preflight"], out)
        except Exception:  # noqa: BLE001 — advisory block only
            pass
        return out

    def lazy(make):
        """A history made once, on first use (a skipped config makes
        none)."""
        cell: list = []

        def get():
            if not cell:
                cell.append(make())
            return cell[0]
        return get

    rt = ("realtime",)
    hist_a3 = lazy(lambda: synth.list_append_history(3000, n_procs=5,
                                                     seed=7))

    def elle_append():
        from .elle import append as elle_append_mod
        res = elle_append_mod.check(hist_a3(), additional_graphs=rt,
                                    cycle_backend="auto", device=dev)
        return _elle_entry(res, hist_a3())

    run("elle_append_3k", None, None, checker=elle_append, need=45,
        warm=lambda: _warm_elle(hist_a3(), elle_build.build_append,
                                additional_graphs=rt))

    hist_w3 = lazy(lambda: synth.wr_register_history(3000, n_procs=5,
                                                     seed=7))

    def elle_wr():
        from .elle import wr as elle_wr_mod
        res = elle_wr_mod.check(hist_w3(), linearizable_keys=True,
                                additional_graphs=rt,
                                cycle_backend="auto", device=dev)
        return _elle_entry(res, hist_w3())

    run("elle_wr_3k", None, None, checker=elle_wr, need=45,
        warm=lambda: _warm_elle(hist_w3(), elle_build.build_wr,
                                linearizable_keys=True,
                                additional_graphs=rt))

    # The capacity config: the auto route must pick the device engine;
    # the host row runs alongside for verdict parity and the speedup
    hist_a8 = lazy(lambda: synth.list_append_history(4000, n_procs=5,
                                                     seed=7))

    def elle_append_8k():
        from .elle import append as elle_append_mod
        h = hist_a8()
        t0 = time.monotonic()
        res = elle_append_mod.check(h, additional_graphs=rt,
                                    cycle_backend="auto", device=dev)
        _sync(dev)
        dev_wall = time.monotonic() - t0
        out = _elle_entry(res, h)
        out["closure_row"] = {"verdict": res["valid?"],
                              "wall_s": round(dev_wall, 2),
                              "engine": res.get("cycle-engine"),
                              "util": res.get("cycle-util")}
        t0 = time.monotonic()
        res_h = elle_append_mod.check(h, additional_graphs=rt,
                                      cycle_backend="host", device=dev)
        host_wall = time.monotonic() - t0
        out["host_row"] = {"verdict": res_h["valid?"],
                           "wall_s": round(host_wall, 2)}
        out["speedup_vs_host"] = round(host_wall / max(dev_wall, 1e-9), 1)
        if res["valid?"] != res_h["valid?"]:
            out["cause"] = (f"ENGINE DISAGREEMENT: device="
                            f"{res['valid?']} host={res_h['valid?']}")
        return out

    run("elle_append_8k", None, None, checker=elle_append_8k, need=60,
        warm=lambda: _warm_elle(hist_a8(), elle_build.build_append,
                                additional_graphs=rt))

    # The fleet config, sized by JEPSEN_TPU_BENCH_ELLE_TXNS: the sharded
    # engine forced over the card's shards, against the packed and host
    # rows on the same history
    n_elle = int(os.environ.get("JEPSEN_TPU_BENCH_ELLE_TXNS", "2000"))
    hist_sh = lazy(lambda: synth.list_append_history(n_elle, n_procs=5,
                                                     seed=7))

    def elle_append_sharded():
        from .elle import append as elle_append_mod
        h = hist_sh()
        t0 = time.monotonic()
        res = elle_append_mod.check(h, additional_graphs=rt,
                                    cycle_backend="sharded", device=dev,
                                    devices=shards)
        _sync(dev)
        dev_wall = time.monotonic() - t0
        out = _elle_entry(res, h)
        util = res.get("cycle-util") or {}
        out["closure_row"] = {"verdict": res["valid?"],
                              "wall_s": round(dev_wall, 2),
                              "engine": res.get("cycle-engine"),
                              "n_shards": util.get("n_shards"),
                              "util": util}
        t0 = time.monotonic()
        res_p = elle_append_mod.check(h, additional_graphs=rt,
                                      cycle_backend="packed", device=dev)
        _sync(dev)
        packed_wall = time.monotonic() - t0
        out["packed_row"] = {"verdict": res_p["valid?"],
                             "wall_s": round(packed_wall, 2),
                             "engine": res_p.get("cycle-engine")}
        out["speedup_vs_packed"] = round(
            packed_wall / max(dev_wall, 1e-9), 1)
        t0 = time.monotonic()
        res_h = elle_append_mod.check(h, additional_graphs=rt,
                                      cycle_backend="host", device=dev)
        host_wall = time.monotonic() - t0
        out["host_row"] = {"verdict": res_h["valid?"],
                           "wall_s": round(host_wall, 2)}
        out["speedup_vs_host"] = round(host_wall / max(dev_wall, 1e-9), 1)
        if (res["valid?"] != res_h["valid?"]
                or res["valid?"] != res_p["valid?"]):
            out["cause"] = (f"ENGINE DISAGREEMENT: sharded="
                            f"{res['valid?']} packed={res_p['valid?']}"
                            f" host={res_h['valid?']}")
        return out

    run(f"elle_append_sharded_{n_elle}", None, None,
        checker=elle_append_sharded, need=60,
        warm=lambda: _warm_elle(hist_sh(), elle_build.build_append,
                                kernels=("trim", "sharded"),
                                devices=shards, additional_graphs=rt))

    # independent keys on the card (the reference's 100 x 2k)
    n_keys = int(os.environ.get("JEPSEN_TPU_BENCH_KEYS", "100"))
    per_key = int(os.environ.get("JEPSEN_TPU_BENCH_PER_KEY", "2000"))

    def indep():
        from .parallel import check_batched
        # the headline's workload shape, crash rate included
        hists = [synth.cas_register_history(per_key, n_procs=5, seed=s,
                                            crash_p=0.002)
                 for s in range(n_keys)]
        # bounded by the remaining round budget: a slow platform yields
        # per-key "unknown"s, never a lost line
        left = max(30.0, deadline - time.monotonic() - 20)
        res = check_batched(cas_register(), hists, time_limit=left,
                            oracle_fallback=True, device=dev)
        bad = [i for i, r in enumerate(res) if r["valid?"] is not True]
        unknown = sum(1 for r in res if r["valid?"] == "unknown")
        invalid = [i for i in bad if res[i]["valid?"] is False]
        cause = "; ".join(
            ([f"bad keys: {invalid[:5]}"] if invalid else []) +
            ([f"{unknown} keys unknown"] if unknown else [])) or None
        return {"valid?": (True if not bad else
                           False if invalid else "unknown"),
                "op_count": sum(len(h) for h in hists),
                "K": len(hists), "cause": cause}

    per_key_label = f"{per_key // 1000}k" if per_key >= 1000 \
        else str(per_key)
    run(f"independent_{n_keys}x{per_key_label}", None, None,
        checker=indep, need=150)

    # The mesh fan-out over the card's shards against the streamed path
    # on the same keys in the same round: per-key verdict parity, the
    # speedup, and the scheduler's per-shard occupancy
    n_mkeys = int(os.environ.get("JEPSEN_TPU_BENCH_MESH_KEYS", "24"))
    per_mkey = int(os.environ.get("JEPSEN_TPU_BENCH_MESH_PER_KEY", "600"))

    def indep_mesh():
        from .ops.encode import encode
        from .parallel import check_batched
        from .parallel import mesh as mesh_mod
        from .parallel.batched import shared_shape_bucket

        model = cas_register()
        hists = [synth.cas_register_history(per_mkey, n_procs=5,
                                            seed=1000 + s, crash_p=0.002)
                 for s in range(n_mkeys)]
        encs = [encode(model, h) for h in hists]
        left = max(30.0, deadline - time.monotonic() - 20)
        # warm the plan outside the measured window
        try:
            aot.precompile_mesh_plan(
                shared_shape_bucket(encs), shards, n_keys=len(encs),
                model_name="cas_register")
        except Exception:  # noqa: BLE001 — warm-up is best-effort
            pass
        runs_before = mesh_mod.snapshot()["runs"]
        t0 = time.monotonic()
        res_m = check_batched(model, hists, strategy="mesh",
                              time_limit=left / 2, oracle_fallback=True,
                              devices=shards)
        _sync(dev)
        mesh_wall = time.monotonic() - t0
        # strategy="mesh" degrades to streaming on one device or an
        # infeasible plan: detect it, or the entry would report a
        # streamed-against-streamed "speedup"
        used_mesh = mesh_mod.snapshot()["runs"] > runs_before
        t0 = time.monotonic()
        res_s = check_batched(model, hists, strategy="stream",
                              time_limit=max(30.0, left - mesh_wall),
                              oracle_fallback=True, devices=shards)
        _sync(dev)
        stream_wall = time.monotonic() - t0
        parity = all(a["valid?"] == b["valid?"]
                     for a, b in zip(res_m, res_s))
        bad = [i for i, r in enumerate(res_m) if r["valid?"] is not True]
        invalid = [i for i in bad if res_m[i]["valid?"] is False]
        out = {
            "valid?": (True if not bad else
                       False if invalid else "unknown"),
            "op_count": sum(len(h) for h in hists),
            "K": n_mkeys,
            "engine": ("device-mesh" if used_mesh
                       else "degraded-streamed"),
            "parity": parity,
            "cause": (None if parity else
                      "MESH/STREAM VERDICT DISAGREEMENT"),
            "streamed_row": {"wall_s": round(stream_wall, 2)}}
        if not used_mesh:
            out["cause"] = out["cause"] or \
                "mesh degraded (single device or infeasible plan)"
            return out
        summ = mesh_mod.last_summary() or {}
        out["speedup_vs_streamed"] = round(
            stream_wall / max(mesh_wall, 1e-9), 2)
        out["mesh"] = {
            "wall_s": round(mesh_wall, 2),
            "n_devices": summ.get("n_devices"),
            "steals": summ.get("steals"),
            "rebuckets": summ.get("rebuckets"),
            "work_skew_before": summ.get("work_skew_before"),
            "work_skew_after": summ.get("work_skew_after"),
            "per_shard": summ.get("per_shard"),
            "groups": [{k: g.get(k) for k in
                        ("group", "keys", "lanes_per_device",
                         "K_final", "ladder", "steals", "rebuckets")}
                       for g in (summ.get("groups") or [])]}
        return out

    per_mkey_label = (f"{per_mkey // 1000}k" if per_mkey >= 1000
                      else str(per_mkey))
    run(f"independent_mesh_{n_mkeys}x{per_mkey_label}", None, None,
        checker=indep_mesh, need=150)
    return configs


def _platform(dev) -> str:
    return "gpu" if dev.type == "cuda" else "cpu"


def run_bench(n_ops: int, device=None) -> tuple:
    """The round on `device` (None: the card, which raises without
    one): the planes installed, the headline cold and warm, the profile
    pass, the extras. Returns (the full result, exit code)."""
    global _T0_EPOCH, _REGISTRY, _TRACER, _LEDGER, _PLATFORM
    from .util import device_name, resolve_device

    dev = resolve_device(device)  # no card: raises before any plane
    _T0_EPOCH = time.time()       # the doctor scopes ledger reads to it
    budget = float(os.environ.get("JEPSEN_TPU_BENCH_BUDGET_S", "120"))
    extras = os.environ.get("JEPSEN_TPU_BENCH_EXTRAS", "1") != "0"
    total_s = float(os.environ.get("JEPSEN_TPU_BENCH_TOTAL_S", "930"))
    deadline = time.monotonic() + total_s
    _PLATFORM = plat = _platform(dev)

    # one registry, one tracer, the run ledger, the stall watchdog and
    # the device monitor for the whole round (main restores the
    # previous ones)
    from . import devices as devices_mod
    from . import ledger as ledger_mod
    from . import metrics as metrics_mod
    from . import trace as trace_mod
    from . import watchdog as watchdog_mod
    _REGISTRY = metrics_mod.Registry()
    _TRACER = trace_mod.Tracer(sampled=True,
                               service="jepsen_tpu_torch.bench")
    _LEDGER = ledger_mod.Ledger(os.path.join(_ROOT, STORE_DIR))
    _PREV_PLANES.update(
        metrics=metrics_mod.set_default(_REGISTRY),
        ledger=ledger_mod.set_default(_LEDGER),
        watchdog=watchdog_mod.set_default(watchdog_mod.Watchdog()),
        devices=devices_mod.set_default(devices_mod.DeviceMonitor()))

    from .analysis import guards
    from .models import cas_register
    from .ops import wgl
    from .synth import cas_register_history

    metric = f"cas_register_{n_ops // 1000}k_wgl_wall_s"
    name = f"cas_register_{n_ops // 1000}k"
    print(f"platform: {plat} -> {dev} ({device_name(dev)})",
          file=sys.stderr)
    hist = cas_register_history(n_ops, n_procs=5, seed=42, crash_p=0.002)
    print(f"history: {len(hist)} events ({n_ops} invocations)",
          file=sys.stderr)
    model = cas_register()

    def check(**kw):
        res = wgl.check(model, hist, time_limit=budget, device=dev, **kw)
        _sync(dev)
        return res

    res_cold, cold_s = _timed(check, tracer=_TRACER)
    print(f"cold: {cold_s:.3f}s -> {_drop_telemetry(res_cold)}",
          file=sys.stderr)
    _PARTIAL.update({"metric": metric, "platform": plat,
                     "cold_s": round(cold_s, 3), "value": None})
    guard = None
    res, warm_s = res_cold, None
    if res_cold.get("valid?") != "unknown":
        # the warm run re-checks the same history inside the compile
        # guard: a warm build, load or bind is a regression it counts
        guard = guards.CompileGuard(name="bench-warm")
        before = _launch_counts()
        with guard:
            res, warm_s = _timed(check, tracer=_TRACER)
        launched = _launched(before)
        print(f"warm: {warm_s:.3f}s -> {_drop_telemetry(res)} "
              f"[{guard.compiles} compiles, {guard.d2h} polls]",
              file=sys.stderr)
        _PARTIAL["value"] = round(warm_s, 3)

    headline_extra = {"cold_s": round(cold_s, 3)}
    if guard is not None:
        headline_extra["compiles"] = guard.compiles
    _ledger_record_config(metric, res,
                          warm_s if warm_s is not None else cold_s,
                          model="CASRegister", extra=headline_extra)
    kind = {"device_kind": device_name(dev)}
    if warm_s is None:
        # no verdict within budget: the cold attempt is the value, so
        # the regression shows
        out = {"metric": metric, "value": round(cold_s, 3), "unit": "s",
               "vs_baseline": round(60.0 / cold_s, 3),
               "verdict": "unknown", "platform": plat,
               "cause": res.get("cause"), **kind}
        _PARTIAL.update(out)
        return out, 1

    # a separate, untimed profiled check (budget permitting): the
    # device's own trace of the headline
    trace_dir = os.environ.get("JEPSEN_TPU_BENCH_TRACE_DIR",
                               os.path.join(_ROOT, PROFILE_DIR))
    if trace_dir and deadline - time.monotonic() > budget + 30:
        try:
            check(profile_dir=trace_dir)
        except Exception:  # noqa: BLE001 — profiling never kills
            pass           # the round

    g = guard.report()
    out = {"metric": metric, "value": round(warm_s, 3), "unit": "s",
           "vs_baseline": round(60.0 / warm_s, 3),
           "verdict": res.get("valid?"), "platform": plat,
           "cold_s": round(cold_s, 3),
           "configs_explored": res.get("configs_explored"),
           "util": res.get("util"),
           "occupancy": res.get("occupancy"),
           "hbm": _measured_hbm(res),
           "telemetry": res.get("telemetry"),
           **kind, "compiles": g["compiles"], "h2d": g["h2d"],
           "d2h": g["d2h"], "guard": g, "compile_guard": g,
           "configs": {name: {**_config_entry(res, warm_s),
                              "launches": launched}}}
    pf = _preflight_block(model, hist, res, dev)
    if pf:
        out["preflight"] = pf
    cb = os.environ.get("JEPSEN_TPU_BENCH_COMPILE_BUDGET")
    if cb is not None and g["compiles"] > int(cb):
        out["compile_budget_exceeded"] = True
        print(f"COMPILE BUDGET EXCEEDED: {g['compiles']} > {cb}",
              file=sys.stderr)
    if extras:
        _PARTIAL.update(out)  # a SIGTERM during the extras emits this
        out["configs"].update(run_extras(budget, deadline, dev))
    return out, 0 if out["verdict"] is True else 1


# The partial result a SIGTERM prints; run_bench fills it in as
# milestones land.
_PARTIAL: dict = {}

# The round's root and sinks (main and run_bench set them; emit reads)
_ROOT = REPO_ROOT
_REGISTRY = None
_TRACER = None
_LEDGER = None
_PLATFORM: Optional[str] = None
_T0_EPOCH: Optional[float] = None
_DOCTOR_REPORT = None
# the ambient planes the round replaced, restored when it ends
_PREV_PLANES: dict = {}


def _ledger_record_config(name: str, res: dict, wall: float,
                          model: Optional[str] = None,
                          extra: Optional[dict] = None) -> None:
    """One ledger record per bench config run (kind="bench"); never
    raises and no-ops before run_bench installs the ledger."""
    if _LEDGER is None or not _LEDGER.enabled:
        return
    try:
        _LEDGER.record_result("bench", name, res, wall_s=wall,
                              platform=_PLATFORM or "cpu",
                              model=model, extra=extra)
    except Exception:  # noqa: BLE001
        traceback.print_exc(file=sys.stderr)


def _drop_telemetry(res: dict) -> dict:
    """The per-chunk timeseries is artifact material, not log
    material."""
    return {k: v for k, v in res.items() if k != "telemetry"}


def _export_telemetry(out: dict) -> None:
    """Write the round's metrics registry (JSONL and Prometheus text)
    and spans (JSONL, and a Perfetto document with the occupancy
    counter tracks and the doctor's instants) under TELEMETRY_DIR,
    listing them in out["telemetry_files"]."""
    art = os.path.join(_ROOT, TELEMETRY_DIR)
    files = []
    try:
        if _REGISTRY is not None and _REGISTRY.instruments():
            _REGISTRY.export_jsonl(os.path.join(art, "bench_metrics.jsonl"))
            _REGISTRY.export_prometheus(
                os.path.join(art, "bench_metrics.prom"))
            files += [_rel(TELEMETRY_DIR, "bench_metrics.jsonl"),
                      _rel(TELEMETRY_DIR, "bench_metrics.prom")]
        if _TRACER is not None and _TRACER.spans:
            _TRACER.export(os.path.join(art, "bench_trace.jsonl"))
            files.append(_rel(TELEMETRY_DIR, "bench_trace.jsonl"))
            from . import occupancy
            counters = (occupancy.perfetto_counter_tracks(_REGISTRY)
                        if _REGISTRY is not None else None)
            instants = None
            if _DOCTOR_REPORT is not None:
                from . import doctor
                instants = doctor.perfetto_instants(_DOCTOR_REPORT) or None
            _TRACER.export_perfetto(
                os.path.join(art, "bench_trace.perfetto.json"),
                counters=counters, instants=instants)
            files.append(_rel(TELEMETRY_DIR, "bench_trace.perfetto.json"))
    except OSError:
        return  # a read-only checkout: the compact line still prints
    if files:
        out["telemetry_files"] = files


# -- regression tracking ------------------------------------------------------
# Each round banks a kind="bench-round" record; these functions compare
# the round with its priors and write regressions.json under
# TELEMETRY_DIR.

def load_bench_rounds(root: str = REPO_ROOT) -> list:
    """Prior rounds under `root`: [{"round", "file", "value",
    "platform", "verdict", "configs": {name: wall_s}, "fills",
    "hbm_drift", "source"}], round-ordered.

    The run ledger (`STORE_DIR`, kind="bench-round", one record per
    emit()) is the primary source; `BENCH_r*.json` round snapshots in
    `ART_DIR` fill in rounds the ledger lacks (on a round collision the
    ledger record wins). Rounds that never banked a number are skipped.
    The JAX package's rounds (`BENCH_r*.json` at the root, its
    `store/ledger`) are never read."""
    import glob
    import re

    rounds = []
    for path in sorted(glob.glob(os.path.join(root, ART_DIR,
                                              "BENCH_r*.json"))):
        m = re.search(r"BENCH_r(\d+)\.json$", path)
        if not m:
            continue
        try:
            with open(path) as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            continue
        parsed = data.get("parsed")
        if not isinstance(parsed, dict) or parsed.get("value") is None:
            continue
        configs = {}
        fills = {}
        hbm_drift = {}
        for name, c in (parsed.get("configs") or {}).items():
            if isinstance(c, dict) and isinstance(
                    c.get("wall_s"), (int, float)):
                configs[name] = c["wall_s"]
            if isinstance(c, dict) and isinstance(
                    c.get("frontier_fill"), (int, float)):
                fills[name] = c["frontier_fill"]
            pf = c.get("preflight") if isinstance(c, dict) else None
            if isinstance(pf, dict) and isinstance(
                    pf.get("hbm_drift_x"), (int, float)):
                hbm_drift[name] = pf["hbm_drift_x"]
        rounds.append({"round": int(m.group(1)),
                       "file": os.path.basename(path),
                       "value": parsed.get("value"),
                       "platform": parsed.get("platform"),
                       "verdict": parsed.get("verdict"),
                       "configs": configs,
                       "fills": fills,
                       "hbm_drift": hbm_drift,
                       "source": "glob"})
    by_round = {r["round"]: r for r in rounds}
    try:
        from . import ledger as ledger_mod
        led = ledger_mod.Ledger(os.path.join(root, STORE_DIR))
        for rec in led.query(kind="bench-round"):
            if rec.get("value") is None or rec.get("round") is None:
                continue
            by_round[int(rec["round"])] = {
                "round": int(rec["round"]),
                "file": rec.get("id"),
                "value": rec.get("value"),
                "platform": rec.get("platform"),
                "verdict": rec.get("verdict"),
                "configs": {k: v for k, v in
                            (rec.get("configs") or {}).items()
                            if isinstance(v, (int, float))},
                "fills": {k: v for k, v in
                          (rec.get("fills") or {}).items()
                          if isinstance(v, (int, float))},
                "hbm_drift": {k: v for k, v in
                              (rec.get("hbm_drift") or {}).items()
                              if isinstance(v, (int, float))},
                "source": "ledger"}
    except Exception:  # noqa: BLE001 — a torn ledger never hides
        pass  # the glob rounds
    return sorted(by_round.values(), key=lambda r: r["round"])


def _collect_hbm_drift(out: dict) -> dict:
    """{config: hbm_drift_x} off the preflight blocks this run attached
    (the headline's under its metric name): the drift gate's input."""
    drift: dict = {}
    pf = out.get("preflight")
    if isinstance(pf, dict) and isinstance(
            pf.get("hbm_drift_x"), (int, float)):
        drift[out.get("metric") or "headline"] = pf["hbm_drift_x"]
    for name, c in (out.get("configs") or {}).items():
        cpf = c.get("preflight") if isinstance(c, dict) else None
        if isinstance(cpf, dict) and isinstance(
                cpf.get("hbm_drift_x"), (int, float)):
            drift[name] = cpf["hbm_drift_x"]
    return drift


def compute_regressions(rounds: list, current=None,
                        threshold: float = 1.5) -> dict:
    """Per-config wall-time deltas of `current` (or the last round)
    against prior rounds; slowdowns beyond `threshold`x the best prior
    wall are flagged. Only same-platform rounds compare (a cpu round
    next to a gpu round is a hardware change, not a regression); with no
    same-platform prior the comparison is skipped and recorded so."""
    from . import drift
    rounds = list(rounds)
    if current is None:
        if not rounds:
            return {"schema": 1, "threshold_x": threshold,
                    "rounds": [], "current": None, "headline": {},
                    "configs": {}, "hbm": {}, "regressions": [],
                    "note": "no parseable rounds"}
        current = rounds[-1]
        rounds = rounds[:-1]
    plat = current.get("platform")
    prior = [r for r in rounds if r.get("platform") == plat]
    out: dict = {"schema": 1, "threshold_x": threshold,
                 "platform": plat,
                 "compared_rounds": [r["round"] for r in prior],
                 "rounds": rounds, "current": current,
                 "headline": {}, "configs": {}, "regressions": []}
    # measured-against-predicted memory: needs no priors (the
    # prediction is the baseline), so it runs before the early return
    out["hbm"] = {}
    for name, ratio in sorted((current.get("hbm_drift") or {}).items()):
        if not isinstance(ratio, (int, float)):
            continue
        row = {"drift_x": round(float(ratio), 4),
               "threshold_x": drift.HBM_DRIFT_X,
               "regressed": drift.drift_regressed(ratio)}
        out["hbm"][name] = row
        if row["regressed"]:
            out["regressions"].append(f"{name}:hbm")
    if not prior:
        out["note"] = (f"no prior rounds on platform {plat!r}; "
                       "nothing comparable")
        return out
    if current.get("value") is not None:
        out["headline"] = drift.delta_row(
            current["value"],
            [r["value"] for r in prior if r.get("value") is not None],
            threshold)
        if out["headline"].get("regressed"):
            out["regressions"].append("headline")
    for name in sorted({n for r in prior + [current]
                        for n in (r.get("configs") or {})}):
        latest = (current.get("configs") or {}).get(name)
        priors = [r["configs"][name] for r in prior
                  if name in (r.get("configs") or {})]
        if latest is None or not priors:
            continue
        row = drift.delta_row(latest, priors, threshold)
        out["configs"][name] = row
        if row.get("regressed"):
            out["regressions"].append(name)
    # a config whose frontier fill drops below 0.9x its best
    # same-platform prior is flagged "<name>:fill"
    out["occupancy"] = {}
    for name in sorted({n for r in prior + [current]
                        for n in (r.get("fills") or {})}):
        latest = (current.get("fills") or {}).get(name)
        priors = [r["fills"][name] for r in prior
                  if name in (r.get("fills") or {})]
        if latest is None or not priors:
            continue
        row = drift.fill_row(latest, priors)
        out["occupancy"][name] = row
        if row["regressed"]:
            out["regressions"].append(f"{name}:fill")
    return out


def _export_regressions(out: dict) -> None:
    """Compare this round with the banked rounds, bank it as a
    `bench-round` record, write regressions.json (and, with matplotlib
    and two rounds or more, bench-trajectory.png) and put the flagged
    names on the line. Never raises: the line outranks the report."""
    try:
        rounds = load_bench_rounds(_ROOT)
        if out.get("value") is None:
            return
        current = {
            "round": (rounds[-1]["round"] + 1) if rounds else 1,
            "file": None, "value": out.get("value"),
            "platform": out.get("platform"),
            "verdict": out.get("verdict"),
            "configs": {
                name: c["wall_s"]
                for name, c in (out.get("configs") or {}).items()
                if isinstance(c, dict) and isinstance(
                    c.get("wall_s"), (int, float))},
            "fills": {
                name: c["util"]["frontier_fill"]
                for name, c in (out.get("configs") or {}).items()
                if isinstance(c, dict)
                and isinstance(c.get("util"), dict)
                and isinstance(c["util"].get("frontier_fill"),
                               (int, float))},
            "hbm_drift": _collect_hbm_drift(out)}
        from . import drift
        threshold = drift.regression_threshold()
        report = compute_regressions(rounds, current, threshold=threshold)
        report["sources"] = {
            src: sum(1 for r in rounds if r.get("source") == src)
            for src in ("ledger", "glob")}
        # bank this round so the next one reads it back
        if _LEDGER is not None and _LEDGER.enabled:
            _LEDGER.record({"kind": "bench-round",
                            "name": out.get("metric") or "bench",
                            "round": current["round"],
                            "value": current["value"],
                            "platform": current["platform"],
                            "verdict": current["verdict"],
                            "wall_s": current["value"],
                            "configs": current["configs"],
                            "fills": current["fills"],
                            "hbm_drift": current["hbm_drift"]})
        art = os.path.join(_ROOT, TELEMETRY_DIR)
        os.makedirs(art, exist_ok=True)
        with open(os.path.join(art, "regressions.json"), "w") as fh:
            json.dump(report, fh, indent=1)
        files = [_rel(TELEMETRY_DIR, "regressions.json")]
        from .checker import plots
        if plots.bench_trajectory_graph(
                report, os.path.join(art, "bench-trajectory.png")):
            files.append(_rel(TELEMETRY_DIR, "bench-trajectory.png"))
        out["regressions"] = {"flagged": report.get("regressions"),
                              "threshold_x": threshold,
                              "compared_rounds":
                                  report.get("compared_rounds"),
                              "files": files}
        if report.get("regressions"):
            print(f"REGRESSION flagged (> {threshold}x best prior "
                  f"wall): {report['regressions']}", file=sys.stderr)
    except Exception:  # noqa: BLE001
        traceback.print_exc(file=sys.stderr)


def _export_occupancy(out: dict) -> None:
    """The per-config utilization report: frontier fill, memo hit rate
    and roofline per config into occupancy.json, fill regressions
    flagged against the best same-platform prior read back from the
    ledger (kind="bench-occupancy"; this round banks one), and with
    matplotlib the batched fan-out's round x lane fill heatmap
    (occupancy-heatmap.png). Never raises."""
    try:
        from . import drift, occupancy
        target = float(os.environ.get("JEPSEN_TPU_BENCH_FILL_TARGET",
                                      str(occupancy.TARGET_FILL)))
        plat = out.get("platform")
        configs: dict = {}

        def row(name, util, occ=None):
            if not isinstance(util, dict):
                return
            r = {k: util[k] for k in
                 ("frontier_fill", "memo_hit_rate", "configs_per_s",
                  "rounds") if util.get(k) is not None}
            if isinstance(occ, dict):
                for k in ("fill", "roofline", "rounds_dropped", "K",
                          "kernel"):
                    if occ.get(k) is not None:
                        r[k] = occ[k]
            if r.get("frontier_fill") is None:
                return
            r["meets_target"] = bool(r["frontier_fill"] >= target)
            configs[name] = r

        row(out.get("metric") or "headline", out.get("util"),
            out.get("occupancy"))
        for name, c in (out.get("configs") or {}).items():
            if isinstance(c, dict):
                row(name, c.get("util"), c.get("occupancy"))
        if not configs:
            return
        report = {"schema": 1, "target_fill": target,
                  "platform": plat, "configs": configs,
                  "below_target": sorted(
                      n for n, r in configs.items()
                      if not r["meets_target"]),
                  "fill_regressions": []}
        try:
            if _LEDGER is not None and _LEDGER.enabled:
                best: dict = {}
                for rec in _LEDGER.query(kind="bench-occupancy"):
                    if rec.get("platform") != plat:
                        continue
                    for name, fill in (rec.get("configs") or {}).items():
                        if isinstance(fill, (int, float)):
                            best[name] = max(best.get(name, 0.0), fill)
                for name, r in configs.items():
                    prior = best.get(name)
                    if prior and drift.fill_regressed(
                            r["frontier_fill"], prior):
                        r["best_prior_fill"] = prior
                        report["fill_regressions"].append(name)
                _LEDGER.record({
                    "kind": "bench-occupancy",
                    "name": out.get("metric") or "bench",
                    "platform": plat,
                    "configs": {n: r["frontier_fill"]
                                for n, r in configs.items()}})
        except Exception:  # noqa: BLE001 — a torn ledger never hides
            traceback.print_exc(file=sys.stderr)  # the report itself
        art = os.path.join(_ROOT, TELEMETRY_DIR)
        os.makedirs(art, exist_ok=True)
        with open(os.path.join(art, "occupancy.json"), "w") as fh:
            json.dump(report, fh, indent=1)
        files = [_rel(TELEMETRY_DIR, "occupancy.json")]
        # round x lane heatmap of the batched fan-out, when the round
        # recorded one (the independent config's straggler view)
        if _REGISTRY is not None:
            pts = _REGISTRY.series("wgl_batched_rounds").points
            if pts:
                from .checker import plots
                if plots.occupancy_heatmap(
                        {"name": "bench batched"}, pts,
                        out_path=os.path.join(art,
                                              "occupancy-heatmap.png")):
                    files.append(_rel(TELEMETRY_DIR,
                                      "occupancy-heatmap.png"))
        out["occupancy_report"] = {
            "target_fill": target,
            "below_target": report["below_target"],
            "fill_regressions": report["fill_regressions"],
            "files": files}
        if report["fill_regressions"]:
            print(f"FILL REGRESSION flagged (< 0.9x best prior): "
                  f"{report['fill_regressions']}", file=sys.stderr)
    except Exception:  # noqa: BLE001
        traceback.print_exc(file=sys.stderr)


def _export_doctor(out: dict) -> None:
    """Diagnose this round (`doctor.py`): the report goes to
    doctor.json, a kind="doctor" ledger record and a compact `doctor`
    block on the line; when the round was flagged, the top finding is
    printed as the suggested why. Host reads of what the round recorded
    only. Never raises."""
    global _DOCTOR_REPORT
    if _REGISTRY is None:
        # the round died before installing its sinks: there is nothing
        # of this round to diagnose, and the files on disk are the
        # previous round's
        return
    try:
        from . import doctor
        view = doctor.bench_view(
            _ROOT, registry=_REGISTRY, tracer=_TRACER, details=out,
            since=_T0_EPOCH)
        report = doctor.diagnose(view)
        _DOCTOR_REPORT = report
        doctor.record_report(report, where="bench",
                             ledger_name=out.get("metric") or "bench")
        files = []
        try:
            art = os.path.join(_ROOT, TELEMETRY_DIR)
            os.makedirs(art, exist_ok=True)
            with open(os.path.join(art, "doctor.json"), "w") as fh:
                json.dump(report, fh, indent=1, default=str)
            files.append(_rel(TELEMETRY_DIR, "doctor.json"))
        except OSError:
            pass  # a read-only checkout: the compact block still rides
        blk = {"healthy": report["healthy"],
               "rules": report["rules_fired"],
               "findings_n": len(report["findings"]),
               "files": files}
        flagged = (out.get("regressions") or {}).get("flagged") or []
        if report["findings"]:
            top = report["findings"][0]
            blk["top"] = {k: top.get(k) for k in
                          ("rule", "name", "severity", "subject",
                           "summary") if top.get(k) is not None}
            if flagged:
                print(f"DOCTOR: top finding for flagged round: "
                      f"{blk['top']}", file=sys.stderr)
        out["doctor"] = blk
    except Exception:  # noqa: BLE001
        traceback.print_exc(file=sys.stderr)


def compact_line(out: dict) -> dict:
    """The one line the round prints: COMPACT_KEYS, and per config its
    verdict, wall, engine, K (the port's), preflight block, fill and
    memo hit rate and the mesh block."""
    compact = {k: out.get(k) for k in COMPACT_KEYS
               if out.get(k) is not None}
    cfgs = out.get("configs")
    if isinstance(cfgs, dict):
        compact["configs"] = {}
        for name, v in cfgs.items():
            if not isinstance(v, dict):
                continue
            row = {k: v.get(k) for k in ("verdict", "wall_s", "engine",
                                         "K", "preflight")
                   if v.get(k) is not None}
            util = v.get("util")
            if isinstance(util, dict):
                for k in ("frontier_fill", "memo_hit_rate"):
                    if util.get(k) is not None:
                        row[k] = util[k]
            mesh_blk = v.get("mesh")
            if isinstance(mesh_blk, dict):
                row["mesh"] = {k: mesh_blk.get(k) for k in
                               ("wall_s", "n_devices", "steals",
                                "rebuckets", "work_skew_before",
                                "work_skew_after", "per_shard")
                               if mesh_blk.get(k) is not None}
                if v.get("speedup_vs_streamed") is not None:
                    row["speedup_vs_streamed"] = v["speedup_vs_streamed"]
            compact["configs"][name] = row
    compact["details"] = _rel(DETAILS_FILE)
    return compact


def emit(out: dict) -> None:
    """The stdout contract is one parseable JSON line: the full result
    goes to DETAILS_FILE, stdout gets `compact_line`. The doctor runs
    after the regression and occupancy reports (it reads what they
    flagged) and before the telemetry export (its findings annotate the
    Perfetto document)."""
    _export_regressions(out)
    _export_occupancy(out)
    _export_doctor(out)
    _export_telemetry(out)
    try:
        path = os.path.join(_ROOT, DETAILS_FILE)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1, default=str)
    except OSError:
        pass  # a read-only checkout still gets the compact line
    print(json.dumps(compact_line(out), default=str), flush=True)


def _metric_of(n_ops: int) -> str:
    return f"cas_register_{n_ops // 1000}k_wgl_wall_s"


def _sigterm(_signo, _frame):
    out = dict(_PARTIAL) or {"metric": _metric_of(_N_OPS), "value": None,
                             "unit": "s", "vs_baseline": None}
    out.setdefault("verdict", "terminated")
    out["terminated"] = True
    emit(out)
    os._exit(1)


_N_OPS = 10000


def _restore_planes() -> None:
    """Put back the ambient planes the round replaced, and stop its
    watchdog's monitor thread."""
    from . import devices as devices_mod
    from . import ledger as ledger_mod
    from . import metrics as metrics_mod
    from . import watchdog as watchdog_mod
    if not _PREV_PLANES:
        return
    wd = watchdog_mod.set_default(_PREV_PLANES["watchdog"])
    wd.stop()
    metrics_mod.set_default(_PREV_PLANES["metrics"])
    ledger_mod.set_default(_PREV_PLANES["ledger"])
    devices_mod.set_default(_PREV_PLANES["devices"])
    _PREV_PLANES.clear()


def main(argv: Optional[Sequence[str]] = None) -> int:
    global _ROOT, _N_OPS, _REGISTRY, _TRACER, _LEDGER, _DOCTOR_REPORT
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.bench",
        description="the port's bench round: the headline (a cold check "
                    "of the cas-register history, then a guarded warm "
                    "re-check) and the BASELINE configs")
    ap.add_argument("--device", default=None,
                    help="where the checks run (default: the card)")
    ap.add_argument("--ops", type=int,
                    default=int(os.environ.get("JEPSEN_TPU_BENCH_OPS",
                                               "10000")),
                    help="invocations in the headline history (default "
                         "JEPSEN_TPU_BENCH_OPS or 10000)")
    ap.add_argument("--root", default=REPO_ROOT,
                    help="where the round writes and reads its priors "
                         "(default: the checkout)")
    args = ap.parse_args(argv)
    _ROOT, _N_OPS = args.root, args.ops
    _REGISTRY = _TRACER = _LEDGER = _DOCTOR_REPORT = None
    _PARTIAL.clear()
    import signal
    import threading
    prev_sigterm = None
    if threading.current_thread() is threading.main_thread():
        prev_sigterm = signal.signal(signal.SIGTERM, _sigterm)
    try:
        try:
            out, rc = run_bench(args.ops, device=args.device)
        except BaseException as e:  # always print the line
            traceback.print_exc(file=sys.stderr)
            out = {"metric": _metric_of(args.ops), "value": None,
                   "unit": "s", "vs_baseline": None, "verdict": "error",
                   "error": f"{type(e).__name__}: {e}"[:500]}
            emit(out)
            if isinstance(e, KeyboardInterrupt):
                raise
            return 1
        emit(out)
        return rc
    finally:
        _restore_planes()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)


if __name__ == "__main__":
    sys.exit(main())
