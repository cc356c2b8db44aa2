"""The telemetry and device planes of the PyTorch/CUDA port against the
JAX package's.

The port's `metrics`, `watchdog` and `devices` modules and the extended
`fleet` and `occupancy` copy the reference's planes, and the port's
search paths record into them at the reference's call sites. Held here,
on the CPU (the JAX side under the conftest's CPU pin):

  * the reference's own unit cases of `metrics`, `watchdog`, `devices`
    and the occupancy drain (tests/test_metrics.py, test_watchdog.py,
    test_devices.py, test_occupancy.py), each run with its module's
    plane swapped for the port's copy;
  * `ops/wgl.check` under an enabled registry and device monitor in
    both packages, on the same seeded history: the same result keys
    (`telemetry`, `occupancy`, `hbm` with its `stats_unavailable`
    marker, `util["adapt"]`), the same instruments and point keys, and
    the same drained occupancy rounds (both run 1024-round chunks on
    the CPU); with every plane off, the port's result keys as before;
  * a watchdog soft cancel in both packages (`cause: "stalled"`, the
    same `partial` keys), for a single search, the vmap fan-out and the
    mesh scheduler;
  * a `torch.profiler` capture on the CPU that writes a Chrome trace and
    sets `profile_dir`, and a capture that fails to start, which is a
    recorded fault and no `profile_dir`;
  * the lane-batched paths' series (`wgl_batched_*`, `mesh_sched`,
    `fleet_shards`) against the reference's, point for point where the
    two schedulers are exact (`steal=False`, as tests/test_torch_mesh.py
    holds them);
  * Elle's (`elle_build`, `elle_closure`) and preflight's (`preflight`,
    `preflight_checks_total`) names against the reference's.

Wall times, rates and byte counts differ between the packages: only
keys and deterministic counts are compared.
"""

import importlib
import inspect
import json
import threading
import time

import pytest
import torch

from jepsen_tpu import devices as jdevices
from jepsen_tpu import ledger as jledger
from jepsen_tpu import metrics as jmetrics
from jepsen_tpu import synth as jsynth
from jepsen_tpu import watchdog as jwatchdog
from jepsen_tpu.analysis import preflight as jpreflight
from jepsen_tpu.elle import append as jappend
from jepsen_tpu.elle import wr as jwr
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.parallel import check_batched as jcheck_batched
from jepsen_tpu.parallel import default_mesh
from jepsen_tpu.parallel import mesh as jmesh
from jepsen_tpu_torch import devices as tdevices
from jepsen_tpu_torch import fleet as tfleet
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import ledger as tledger
from jepsen_tpu_torch import metrics as tmetrics
from jepsen_tpu_torch import occupancy as toccupancy
from jepsen_tpu_torch import watchdog as twatchdog
from jepsen_tpu_torch.analysis import preflight as tpreflight
from jepsen_tpu_torch.elle import append as tappend
from jepsen_tpu_torch.elle import wr as twr
from jepsen_tpu_torch.models import core as tmodels
from jepsen_tpu_torch.ops import encode as tencode
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.parallel import check_batched as tcheck_batched
from jepsen_tpu_torch.parallel import mesh as tmesh

# intra-op threads only contend with the other test workers
torch.set_num_threads(1)

MONITOR_THREAD = "jepsen-tpu-torch-watchdog"


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


def _no_port_monitor_thread():
    """The port's watchdog monitor threads have all stopped (a stop
    joins with a timeout, so wait a moment for a slow one)."""
    for _ in range(50):
        if not any(t.name == MONITOR_THREAD and t.is_alive()
                   for t in threading.enumerate()):
            return True
        time.sleep(0.02)
    return False


def _bare(points):
    """Series points without their clocks."""
    return [{k: v for k, v in p.items() if k not in ("t", "wall_s")}
            for p in points]


def _names(reg):
    return sorted(i.name for i in reg.instruments())


# --- the reference's own unit cases, on the port's copies --------------------

PORT = {"metrics": tmetrics, "watchdog": twatchdog, "fleet": tfleet,
        "devices": tdevices, "occupancy": toccupancy}

# test module -> (the module globals its cases read that the port
# replaces, the classes whose cases run here: "Class" for all its
# cases, "Class.case" for one)
REF_SUITES = {
    "test_metrics": (("metrics",),
                     ("TestInstruments", "TestThreadSafety",
                      "TestExporters", "TestDisabled", "TestAmbient")),
    "test_watchdog": (("watchdog", "metrics", "fleet"),
                      ("TestDetection", "TestObservabilityPlanes",
                       "TestGuarded", "TestConcurrentScan")),
    "test_devices": (("devices", "metrics", "fleet"),
                     ("TestMonitorSampling", "TestMeasurementWindow",
                      "TestSeriesRecording", "TestDriftGate")),
    "test_occupancy": (("occupancy",),
                       ("TestRingDrain.test_drain_chunk_synthetic",
                        "TestRingDrain.test_drain_chunk_depth_fused_spans",
                        "TestRingDrain."
                        "test_drain_chunk_ringless_summary_is_empty",
                        "TestRingDrain.test_memo_hit_rate_single_definition")),
}
# cases of those classes that read no plane (the linter alone)
REF_SKIP = {("test_devices", "TestSeriesRecording",
             "test_drifted_series_caught")}


def _ref_cases():
    out = []
    for suite, (_, classes) in REF_SUITES.items():
        mod = importlib.import_module(suite)
        for spec in classes:
            cls, _, one = spec.partition(".")
            for name in ([one] if one else sorted(vars(getattr(mod, cls)))):
                if name.startswith("test_") \
                        and (suite, cls, name) not in REF_SKIP:
                    out.append((suite, cls, name))
    return out


@pytest.mark.parametrize("suite,cls,name", _ref_cases(),
                         ids=lambda x: x)
def test_reference_case_on_the_port(suite, cls, name, tmp_path,
                                    monkeypatch):
    mod = importlib.import_module(suite)
    for g in REF_SUITES[suite][0]:
        monkeypatch.setattr(mod, g, PORT[g])
    case = getattr(getattr(mod, cls)(), name)
    params = inspect.signature(case).parameters
    kw = {k: v for k, v in (("tmp_path", tmp_path),
                            ("monkeypatch", monkeypatch)) if k in params}
    wd = None
    if "wd" in params:
        # the reference's `wd` fixture, on the port's Watchdog
        wd = kw["wd"] = twatchdog.Watchdog(stall_s=0.15, poll_s=0.05,
                                           escalation="cancel")
    try:
        case(**kw)
    finally:
        if wd is not None:
            wd.stop()
    assert _no_port_monitor_thread()


# --- ops/wgl.check -----------------------------------------------------------

def _wgl_pair(hist, **kw):
    """(reference result, port result, reference registry, port
    registry): the same history through both `wgl.check`s, each under
    its package's enabled registry and device monitor."""
    rj, rt = jmetrics.Registry(), tmetrics.Registry()
    with jmetrics.use(rj), jdevices.use(jdevices.DeviceMonitor()):
        a = jwgl.check(jmodels.cas_register(), hist, **kw)
    with tmetrics.use(rt), tdevices.use(tdevices.DeviceMonitor()):
        b = twgl.check(tmodels.cas_register(), to_port(hist), device="cpu",
                       **kw)
    return a, b, rj, rt


@pytest.mark.parametrize("what,hist", [
    ("narrow", lambda: jsynth.cas_register_history(120, n_procs=3, seed=3)),
    ("narrow, invalid", lambda: jsynth.cas_register_history(
        120, n_procs=4, seed=8, crash_p=0.05, lie_p=0.03)),
    ("wide", lambda: jsynth.long_tail_history(120, seed=3))])
def test_wgl_planes_match_reference(what, hist):
    a, b, rj, rt = _wgl_pair(hist())
    assert a["valid?"] == b["valid?"]
    # the planes' keys on the result, the adapt path, the CPU's marker
    assert {"telemetry", "occupancy", "hbm"} <= set(a) & set(b)
    assert set(a) - {"platform"} <= set(b)
    assert a["util"].get("adapt") == b["util"].get("adapt")
    assert b["hbm"]["stats_unavailable"] is True
    assert {k: v for k, v in a["hbm"].items() if k != "samples"} == \
        {k: v for k, v in b["hbm"].items() if k != "samples"}
    assert "hbm_peak_measured" not in b["util"]
    # the same instruments, the same point keys in every series (the
    # device monitor's series sample on a wall-clock throttle: their
    # point counts are not compared)
    assert _names(rj) == _names(rt)
    for inst in rj.instruments():
        if inst.kind == "series":
            pa, pb = inst.points, rt.series(inst.name).points
            if inst.name not in ("hbm", "device_poll"):
                assert len(pa) == len(pb), inst.name
            assert {tuple(sorted(p)) for p in pa} == \
                {tuple(sorted(p)) for p in pb}, inst.name
    # the occupancy block: its keys, and the rounds drained from the
    # ring, equal round for round (both sides run 1024-round chunks on
    # the CPU, so the rings hold the same rows)
    oa, ob = a["occupancy"], b["occupancy"]
    assert sorted(oa) == sorted(ob)
    assert sorted(oa["roofline"]) == sorted(ob["roofline"])
    assert _bare(oa["rounds"]) == _bare(ob["rounds"])
    assert len(ob["rounds"]) > 0
    for k in ("K", "rounds_total", "rounds_seen", "rounds_dropped",
              "rounds_truncated", "memo", "expansion", "kernel"):
        assert oa[k] == ob[k], k
    assert [sorted(c) for c in a["telemetry"]["chunks"]] == \
        [sorted(c) for c in b["telemetry"]["chunks"]]
    for key in ("explored", "rounds", "frontier", "backlog", "memo_hits",
                "memo_inserts", "K"):
        assert [c[key] for c in a["telemetry"]["chunks"]] == \
            [c[key] for c in b["telemetry"]["chunks"]], key
    # the roofline reads the port's own byte count of the search
    roof = ob["roofline"]
    assert roof["source"] == "port-byte-count"
    assert roof["bytes_per_round"] > 0 and roof["flops_per_round"] is None


def test_planes_off_keep_todays_result_keys():
    # every plane off (the ambient defaults): the port's results carry
    # exactly the keys they carried before the planes existed
    assert not tmetrics.get_default().enabled
    assert not tdevices.get_default().enabled
    assert not twatchdog.get_default().enabled
    h = to_port(jsynth.cas_register_history(120, n_procs=3, seed=3))
    res = twgl.check(tmodels.cas_register(), h, device="cpu")
    assert sorted(res) == ["K", "W", "W_pad", "configs_explored", "device",
                           "op_count", "platform", "util", "valid?",
                           "wall_s"]
    assert sorted(res["util"]) == [
        "adapt", "backlog_peak", "chunks", "configs_per_s",
        "est_table_mb_per_round", "first_call_s", "frontier_fill",
        "memo_hit_rate", "packed_tables", "rounds", "succ_rows_per_round"]
    hists = [to_port(jsynth.cas_register_history(40, n_procs=3, seed=s))
             for s in range(4)]
    encs = [tencode.encode(tmodels.cas_register(), x) for x in hists]
    for r in tmesh.check_mesh(tmodels.cas_register(), hists, encs=encs,
                              devices=["cpu"] * 2, steal=False,
                              oracle_fallback=False):
        assert "hbm" not in r and "partial" not in r
        assert sorted(r) == ["K", "W", "W_pad", "configs_explored", "mesh",
                             "occupancy", "op_count", "shard", "util",
                             "valid?"]


def test_watchdog_soft_cancel_matches_reference():
    h = jsynth.cas_register_history(60, n_procs=3, seed=1)
    out = []
    for wmod, check, hist, kw in (
            (jwatchdog, jwgl.check, h, {}),
            (twatchdog, twgl.check, to_port(h), {"device": "cpu"})):
        w = wmod.Watchdog(stall_s=30.0, escalation="cancel")
        try:
            w.soft_cancel("test")
            with wmod.use(w):
                out.append(check(jmodels.cas_register()
                                 if wmod is jwatchdog
                                 else tmodels.cas_register(), hist, **kw))
        finally:
            w.stop()
    a, b = out
    assert a["valid?"] == b["valid?"] == "unknown"
    assert a["cause"] == b["cause"] == "stalled"
    assert set(a["partial"]) == set(b["partial"]) == {
        "configs_explored", "ops_linearized", "chunks"}
    assert sorted(a["stall"]) == sorted(b["stall"])
    assert _no_port_monitor_thread()


def test_fanout_soft_cancel_matches_reference():
    hists = [jsynth.cas_register_history(30, n_procs=3, seed=s)
             for s in range(4)]
    ports = [to_port(x) for x in hists]
    encs = [tencode.encode(tmodels.cas_register(), x) for x in ports]
    jw = jwatchdog.Watchdog(stall_s=30.0, escalation="cancel")
    tw = twatchdog.Watchdog(stall_s=30.0, escalation="cancel")
    try:
        jw.soft_cancel("test")
        tw.soft_cancel("test")
        with jwatchdog.use(jw):
            jr = jcheck_batched(jmodels.cas_register(), hists,
                                strategy="vmap",
                                mesh=default_mesh(n_devices=1))
        with twatchdog.use(tw):
            tr = tcheck_batched(tmodels.cas_register(), ports,
                                strategy="vmap", device="cpu")
            tm = tmesh.check_mesh(tmodels.cas_register(), ports, encs=encs,
                                  devices=["cpu"] * 2, steal=False)
    finally:
        jw.stop()
        tw.stop()
    for a, b, c in zip(jr, tr, tm):
        assert a["cause"] == b["cause"] == c["cause"] == "stalled"
        assert set(a["partial"]) == set(b["partial"])
    # a mesh key cancelled before its first poll has no partial: it
    # never ran
    assert all(r["valid?"] == "unknown" for r in tm)
    assert _no_port_monitor_thread()


def test_profile_capture_on_cpu(tmp_path, monkeypatch):
    h = to_port(jsynth.cas_register_history(60, n_procs=3, seed=1))
    d = tmp_path / "prof"
    res = twgl.check(tmodels.cas_register(), h, device="cpu",
                     profile_dir=str(d))
    assert res["valid?"] is True and res["profile_dir"] == str(d)
    traces = list(d.glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    # a capture that cannot start is a recorded fault, never the
    # verdict's: no profile_dir, the reference's stage name
    reg = tmetrics.Registry()

    def refuse(dev):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(twgl, "_start_profile", refuse)
    monkeypatch.setenv("JEPSEN_TPU_PROFILE_DIR", str(tmp_path / "env"))
    with tmetrics.use(reg):
        res = twgl.check(tmodels.cas_register(), h, device="cpu")
    assert res["valid?"] is True and "profile_dir" not in res
    faults = reg.series("fleet_faults").points
    assert [f["stage"] for f in faults] == ["wgl/profiler-start"]
    assert faults[0]["fault_type"] == "RuntimeError"


# --- the lane-batched paths ------------------------------------------------------

def test_vmap_series_match_reference():
    hists = [jsynth.cas_register_history(40 + 10 * s, n_procs=3, seed=s)
             for s in range(4)]
    rj, rt = jmetrics.Registry(), tmetrics.Registry()
    with jmetrics.use(rj):
        jr = jcheck_batched(jmodels.cas_register(), hists, strategy="vmap",
                            oracle_fallback=False,
                            mesh=default_mesh(n_devices=1))
    with tmetrics.use(rt):
        tr = tcheck_batched(tmodels.cas_register(),
                            [to_port(x) for x in hists], strategy="vmap",
                            oracle_fallback=False, device="cpu")
    assert [r["valid?"] for r in jr] == [r["valid?"] for r in tr]
    for name in ("wgl_batched_chunks", "wgl_batched_lanes",
                 "wgl_batched_rounds", "fleet_shards"):
        pa, pb = rj.series(name).points, rt.series(name).points
        assert pa and [sorted(p) for p in pa] == [sorted(p) for p in pb], \
            name
    for name in ("wgl_batched_lanes", "wgl_batched_rounds"):
        assert _bare(rj.series(name).points) == \
            _bare(rt.series(name).points), name
    assert {"fleet_keys_total", "fleet_shard_seconds"} <= set(_names(rt))


def test_mesh_series_match_reference():
    hists = [jsynth.cas_register_history(40 + 10 * s, n_procs=3, seed=s,
                                         crash_p=0.03) for s in range(4)]
    ports = [to_port(x) for x in hists]
    kw = dict(steal=False, lanes_per_device=1, chunk=32,
              oracle_fallback=False)
    rj, rt = jmetrics.Registry(), tmetrics.Registry()
    with jmetrics.use(rj):
        jr = jmesh.check_mesh(
            jmodels.cas_register(), hists,
            encs=[jencode.encode(jmodels.cas_register(), x) for x in hists],
            mesh=default_mesh(n_devices=2), **kw)
    status = tfleet.RunStatus(test="mesh", progress=False)
    with tmetrics.use(rt), tfleet.use(status), \
            tdevices.use(tdevices.DeviceMonitor()):
        tr = tmesh.check_mesh(
            tmodels.cas_register(), ports,
            encs=[tencode.encode(tmodels.cas_register(), x) for x in ports],
            devices=["cpu"] * 2, **kw)
    assert [r["valid?"] for r in jr] == [r["valid?"] for r in tr]
    for name in ("wgl_batched_lanes", "wgl_batched_rounds", "mesh_sched",
                 "fleet_shards"):
        pa, pb = rj.series(name).points, rt.series(name).points
        assert pa and [sorted(p) for p in pa] == [sorted(p) for p in pb], \
            name
    for name in ("wgl_batched_lanes", "wgl_batched_rounds"):
        assert _bare(rj.series(name).points) == \
            _bare(rt.series(name).points), name
    assert [p["event"] for p in rj.series("mesh_sched").points] == \
        [p["event"] for p in rt.series("mesh_sched").points]
    assert set(_names(rj)) <= set(_names(rt))
    # the device monitor sampled the one CPU device the two shards share
    polls = rt.series("device_poll").points
    assert polls and all(p["n_devices"] == 1 for p in polls)
    snap = status.snapshot()
    assert snap["search"]["mode"] == "mesh-sched"
    assert snap["occupancy"]["mode"] == "mesh"
    assert snap["keys"]["decided"] == len(hists)


# --- Elle and preflight -------------------------------------------------------------

@pytest.mark.parametrize("which", ["append", "wr"])
def test_elle_series_match_reference(which, tmp_path):
    if which == "append":
        h = jsynth.list_append_history(120, n_procs=3, seed=5)
        jmod, tmod = jappend, tappend
    else:
        h = jsynth.wr_register_history(120, n_procs=3, seed=5)
        jmod, tmod = jwr, twr
    rj, rt = jmetrics.Registry(), tmetrics.Registry()
    lj, lt = jledger.Ledger(str(tmp_path / "j")), \
        tledger.Ledger(str(tmp_path / "t"))
    with jmetrics.use(rj), jledger.use(lj):
        a = jmod.check(h, cycle_backend="trim")
    with tmetrics.use(rt), tdevices.use(tdevices.DeviceMonitor()), \
            tledger.use(lt):
        b = tmod.check(to_port(h), cycle_backend="trim", device="cpu")
    assert a["valid?"] == b["valid?"]
    names_j = set(_names(rj)) - {"ledger_records_total"}
    assert names_j == {"elle_build", "elle_closure",
                       "elle_closure_calls_total", "elle_closure_seconds",
                       "history_lint_checks_total", "preflight",
                       "preflight_checks_total"}
    assert names_j <= set(_names(rt))
    assert rj.counter("history_lint_checks_total").samples() == \
        rt.counter("history_lint_checks_total").samples()
    assert sorted(rj.series("elle_build").points[0]) == \
        sorted(rt.series("elle_build").points[0])
    ca, cb = rj.series("elle_closure").points, rt.series("elle_closure").points
    assert len(ca) == len(cb) == 1
    assert set(ca[0]) - {"compile_s"} <= set(cb[0])
    for k in ("edges", "n", "n_pad", "iters_run", "iter_reach",
              "core_sizes", "kernel"):
        assert ca[0][k] == cb[0][k], k
    # the run record both packages bank in their run ledgers
    ra, = lj.query(kind="elle")
    rb, = lt.query(kind="elle")
    # timed fields, and the device window the port's monitor adds
    timed = {"id", "t", "wall_s", "device_s", "util", "hbm"}
    assert {k: v for k, v in rb.items() if k not in timed} == \
        {k: v for k, v in ra.items() if k not in timed}
    assert rb["name"] == f"elle.{which}" and rb["verdict"] == b["valid?"]
    assert rb["platform"] == "cpu" and rb["hbm"]["stats_unavailable"]
    assert sorted(set(rb) - {"hbm"}) == sorted(ra)
    # the port has no XLA compile inside the closure's wall
    assert set(rb["util"]) == set(ra["util"]) - {"compile_s"}
    assert rb["device_s"] == rb["util"]["kernel_s"]
    # the metrics plane keeps no run record of its own
    assert "elle" not in _names(rt)
    # the closure's device window: the CPU's explicit marker
    assert b["cycle-util"]["hbm"]["stats_unavailable"] is True


def test_preflight_ledger_record_matches_reference(tmp_path):
    h = jsynth.cas_register_history(60, n_procs=3, seed=2)
    lj, lt = jledger.Ledger(str(tmp_path / "j")), \
        tledger.Ledger(str(tmp_path / "t"))
    with jledger.use(lj):
        jpreflight.gate_wgl(jmodels.cas_register(), h, where="t",
                            ledger_name="pf")
        jpreflight.gate_wgl(jmodels.cas_register(), h, where="t")
        jpreflight.gate_elle(500, backend="trim", where="e",
                             ledger_name="pf-elle")
    with tledger.use(lt):
        tpreflight.gate_wgl(tmodels.cas_register(), to_port(h), where="t",
                            devices=["cpu"], ledger_name="pf")
        tpreflight.gate_wgl(tmodels.cas_register(), to_port(h), where="t",
                            devices=["cpu"])
        tpreflight.gate_elle(500, backend="trim", where="e",
                             devices=["cpu"], ledger_name="pf-elle")
    # two gates in one millisecond come back in either order (the query
    # sorts by time, then by an id with a random suffix): order by name
    ra, rb = (sorted(led.query(kind="preflight"), key=lambda r: r["name"])
              for led in (lj, lt))
    # a gate without a ledger name banks nothing (the reference's rule)
    assert [r["name"] for r in rb] == [r["name"] for r in ra] == \
        ["pf", "pf-elle"]
    for x, y in zip(ra, rb):
        assert sorted(y) == sorted(x)
        for k in ("kind", "verdict", "engine", "where", "rules"):
            assert y[k] == x[k], k
        # the compact report: the reference's keys (the port's byte
        # bill is its own)
        assert set(x["preflight"]) <= set(y["preflight"])
        for k in ("kind", "engine", "verdict", "rules"):
            assert y["preflight"].get(k) == x["preflight"].get(k), k


def test_preflight_series_match_reference():
    h = jsynth.cas_register_history(60, n_procs=3, seed=2)
    rj, rt = jmetrics.Registry(), tmetrics.Registry()
    with jmetrics.use(rj):
        jpreflight.gate_wgl(jmodels.cas_register(), h, where="t")
    with tmetrics.use(rt):
        tpreflight.gate_wgl(tmodels.cas_register(), to_port(h), where="t",
                            devices=["cpu"])
    assert _names(rj) == _names(rt) == ["preflight",
                                        "preflight_checks_total"]
    pa, pb = rj.series("preflight").points, rt.series("preflight").points
    assert len(pa) == len(pb) == 1 and set(pa[0]) <= set(pb[0])
    assert pa[0]["verdict"] == pb[0]["verdict"]
    (la, va), = rj.counter("preflight_checks_total").samples()
    (lb, vb), = rt.counter("preflight_checks_total").samples()
    assert la == lb and va == vb == 1
    # metrics off: the recent window only
    before = tpreflight.snapshot()["checked"]
    tpreflight.gate_wgl(tmodels.cas_register(), to_port(h), where="t",
                        devices=["cpu"])
    assert tpreflight.snapshot()["checked"] == before + 1


def test_cuda_memory_stats_map_to_the_reference_keys(monkeypatch):
    # a CUDA device's allocator figures under the reference's names
    # (the card's calls stood in for here: this machine has none)
    stats = {"allocated_bytes.all.current": 3 << 20,
             "allocated_bytes.all.peak": 7 << 20}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: type("P", (), {"total_memory": 80 << 30}))
    monkeypatch.setattr(tdevices, "_TOTAL", {})
    got = tdevices.read_memory_stats(torch.device("cuda", 0))
    assert got == {"bytes_in_use": 3 << 20, "peak_bytes_in_use": 7 << 20,
                   "bytes_limit": 80 << 30}
    assert tdevices.read_memory_stats(torch.device("cpu")) is None
    assert tdevices.reset_peak(torch.device("cpu")) == 0
    # the monitor samples each device of a shard list once
    assert tdevices.distinct(["cpu", "cpu", torch.device("cpu")]) == \
        [torch.device("cpu")]
