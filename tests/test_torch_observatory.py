"""The port's fleet observatory (`jepsen_tpu_torch/observatory.py`) and
`devices.multichip_record` against the JAX package's.

  * every case of `tests/test_observatory.py` runs on the port's modules
    (`observatory`, `ledger`, `service` on the CPU, `slo`, `autopilot`,
    `fs_cache`, `synth`); its three cases that import a plane inside
    their body (the doctor's catalog, the `fleet` series, the `/fleet`
    panel) are written out here against the port's;
  * over the same ledgers, banked in `tmp_path` and read by both
    packages with `now` pinned, `fleet_snapshot`, `fleet_findings`
    (D013 down, D014 load and warm-rate skew, D015 divergence, past its
    cap too), `heartbeats`, `render_text` and `cli_main`'s exit codes
    and output equal the reference's exactly;
  * over a store a CPU `Service` of either package served and exported
    (`service/{trace,metrics}.jsonl`), `journey` and `fleet_perfetto`
    equal the reference's;
  * `multichip_record` equals the reference's on the same result dicts;
  * the port's snapshot, its `fleet` series point and the records its
    service banks lint clean under scripts/telemetry_lint.py, which
    imports neither package.

Pure host code; the two-replica run on the card is `chip_smoke.py`'s
`fleet_phases`.
"""

import importlib
import inspect
import json
import os
import sys
import time
import types

import pytest

from jepsen_tpu import devices as jdevices
from jepsen_tpu import fs_cache as jfs_cache
from jepsen_tpu import observatory as jobs
from jepsen_tpu import service as jservice
from jepsen_tpu import slo as jslo
from jepsen_tpu import synth as jsynth
from jepsen_tpu_torch import autopilot as tautopilot
from jepsen_tpu_torch import devices as tdevices
from jepsen_tpu_torch import doctor as tdoctor
from jepsen_tpu_torch import fs_cache as tfs_cache
from jepsen_tpu_torch import ledger as tledger
from jepsen_tpu_torch import metrics as tmetrics
from jepsen_tpu_torch import observatory as tobs
from jepsen_tpu_torch import service as tservice
from jepsen_tpu_torch import slo as tslo
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch import web as tweb

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scripts"))
import telemetry_lint  # noqa: E402

NOW = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _isolate(monkeypatch, tmp_path):
    for mod in (jfs_cache, tfs_cache):
        monkeypatch.setattr(mod, "DIR", str(tmp_path / "fs-cache-iso"))
    monkeypatch.delenv(tobs.FLEET_ROOTS_ENV, raising=False)
    monkeypatch.delenv(tautopilot.CLEAR_QUARANTINE_ENV, raising=False)
    prev = (jservice.set_default(None), tservice.set_default(None))
    jslo._reset()
    tslo._reset()
    yield
    jservice.set_default(prev[0])
    tservice.set_default(prev[1])
    jslo._reset()
    tslo._reset()


# --- the reference's own cases, on the port's modules ------------------------

def _port_service(root, **kw):
    return tservice.Service(root, device="cpu", **kw)


# the module globals of tests/test_observatory.py its cases read, and
# the port's stand-ins
PORT = {"obs": tobs, "ledger_mod": tledger, "slo_mod": tslo,
        "autopilot_mod": tautopilot, "fs_cache": tfs_cache,
        "synth": tsynth,
        "service_mod": types.SimpleNamespace(
            Service=_port_service, set_default=tservice.set_default),
        "_RULE": tautopilot.PolicyRule(
            rule="D001", action="warm_bucket", metric="recent_compiles",
            description="test row")}
# cases that import a plane of the reference inside their body: written
# out below against the port's
REF_LOCAL = {"test_rules_are_in_doctor_catalog",
             "test_fleet_series_point_lints", "test_web_fleet_json"}


def _ref_cases():
    mod = importlib.import_module("test_observatory")
    out = []
    for cls_name, cls in sorted(vars(mod).items()):
        if not (isinstance(cls, type) and cls_name.startswith("Test")):
            continue
        out += [(cls_name, n) for n in sorted(vars(cls))
                if n.startswith("test_") and n not in REF_LOCAL]
    return out


@pytest.mark.parametrize("cls,name", _ref_cases(), ids=lambda x: x)
def test_reference_case_on_the_port(cls, name, tmp_path, monkeypatch,
                                    capsys):
    mod = importlib.import_module("test_observatory")
    for g, v in PORT.items():
        monkeypatch.setattr(mod, g, v)
    case = getattr(getattr(mod, cls)(), name)
    params = inspect.signature(case).parameters
    kw = {k: v for k, v in (("tmp_path", tmp_path),
                            ("monkeypatch", monkeypatch),
                            ("capsys", capsys)) if k in params}
    case(**kw)


def test_rules_are_in_doctor_catalog():
    for r in ("D013", "D014", "D015"):
        assert r in tdoctor.RULES
        assert r not in tdoctor.LOCAL_RULES


def test_fleet_series_point_lints(tmp_path):
    led = tledger.Ledger(str(tmp_path / "a"))
    _heartbeat(led, time.time(), "r1")
    mx = tmetrics.Registry(enabled=True)
    tobs.fleet_snapshot([led.store_root], mx=mx)
    path = str(tmp_path / "m.jsonl")
    mx.export_jsonl(path)
    assert telemetry_lint.lint_jsonl_file(path) == []
    pts = list(mx.series("fleet").points)
    assert pts and pts[-1]["replicas"] == 1


def test_web_fleet_json(tmp_path, monkeypatch):
    led = tledger.Ledger(str(tmp_path / "a"))
    _heartbeat(led, time.time(), "r1")
    monkeypatch.setenv(tobs.FLEET_ROOTS_ENV, led.store_root)
    tweb._FLEET_CACHE.clear()
    snap = tweb._fleet_snapshot(led.store_root)
    assert snap and "r1" in snap["replicas"]
    body = tweb.render_fleet(led.store_root)
    assert b"r1" in body and b"/fleet.json" in body


# --- parity over the same ledgers, `now` pinned -------------------------------

def _heartbeat(led, t, rid, *, served=5, warm_rate=0.8,
               warm_buckets=("b0",), every_s=2.0, **extra):
    rec = {"kind": "replica-heartbeat", "t": t,
           "name": f"replica:{rid}", "replica": rid, "host": "h",
           "pid": 123, "devices": 1, "every_s": every_s,
           "workers": 1, "queued": 0, "submitted": served,
           "served": served, "rejected": 0, "shed": 0,
           "warm_rate": warm_rate,
           "warm_buckets": list(warm_buckets), "shedding": False}
    rec.update(extra)
    return led.record(rec)


def _request(led, t, *, verdict=True, wall=0.05, cause=None):
    return led.record({
        "kind": "service-request", "t": t, "name": "service:x",
        "verdict": verdict, "tenant": "a", "checker": "wgl",
        "warm_hit": False, "batch_n": 1, "shed": False, "bucket": "b0",
        "wall_s": wall, "cause": cause, "phases": {"serve_s": wall},
        "op_count": 10, "device_s": 0.0})


# scenario -> {replica: its heartbeat's kwargs (with the beat's "age" in
# s, 0.5 by default), or None: it never beat}
SCENARIOS = {
    "balanced": {"r1": {}, "r2": {}},
    "one down": {"r1": {}, "r2": {"age": 10.0}},
    "just past the silence gap": {"r1": {"age": 2.9}, "r2": {"age": 3.1}},
    "slow cadence": {"r1": {"age": 10.0, "every_s": 30.0}, "r2": {}},
    "never beat": {"r1": {}, "quiet": None},
    "load skew": {"r1": {"served": 20}, "r2": {"served": 2}},
    "warm-rate skew": {"r1": {"served": 20, "warm_rate": 0.9},
                       "r2": {"served": 20, "warm_rate": 0.1}},
    "divergence": {"r1": {"warm_buckets": ("b0",)},
                   "r2": {"warm_buckets": ("b1",)}},
    "divergence past the cap": {
        "r1": {"warm_buckets": tuple(f"b{i}" for i in range(7))},
        "r2": {"warm_buckets": ()},
        "r3": {"warm_buckets": ("b9",)}},
    "everything": {"r1": {"served": 40, "warm_rate": 0.95,
                          "warm_buckets": ("b0", "b1")},
                   "r2": {"served": 3, "warm_rate": 0.2,
                          "warm_buckets": ("b2",)},
                   "r3": {"age": 30.0, "every_s": 1.0},
                   "r4": None},
}


def _bank_scenario(root, name):
    """Each replica's store under `root`: its heartbeat (age 0.5 s unless
    given) and a few requests, some slow, some undecided."""
    roots = []
    for i, (rid, hb) in enumerate(SCENARIOS[name].items()):
        led = tledger.Ledger(os.path.join(str(root), rid))
        for j in range(3 + i):
            _request(led, NOW - 5 - j, verdict=True if j % 3 else "unknown",
                     wall=0.05 + 0.7 * (j % 2), cause=None)
        if hb is None:
            led.record({"kind": "run", "t": NOW - 50, "name": "quiet"})
        else:
            hb = dict(hb)
            age = hb.pop("age", 0.5)
            _heartbeat(led, NOW - age, rid, **hb)
        roots.append(led.store_root)
    return roots


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_snapshot_findings_and_text_match_the_reference(scenario, tmp_path):
    roots = _bank_scenario(tmp_path, scenario)
    want = jobs.fleet_snapshot(roots, now=NOW)
    got = tobs.fleet_snapshot(roots, now=NOW)
    assert got == want
    assert tobs.render_text(got) == jobs.render_text(want)
    hb_j = jobs.heartbeats(jobs.FederatedLedger(roots), now=NOW)
    hb_t = tobs.heartbeats(tobs.FederatedLedger(roots), now=NOW)
    assert hb_t == hb_j
    assert tobs.fleet_findings(hb_t, now=NOW) == \
        jobs.fleet_findings(hb_j, now=NOW)
    assert tobs.fleet_slo(tobs.FederatedLedger(roots), now=NOW) == \
        jobs.fleet_slo(jobs.FederatedLedger(roots), now=NOW)
    assert json.loads(json.dumps(got, default=str))["rules_evaluated"] == \
        ["D013", "D014", "D015"]


def test_the_scenarios_fire_every_fleet_rule(tmp_path):
    fired = set()
    for name in SCENARIOS:
        snap = tobs.fleet_snapshot(
            _bank_scenario(tmp_path / name.replace(" ", "-"), name), now=NOW)
        fired |= set(snap["rules_fired"])
    assert fired == {"D013", "D014", "D015"}


@pytest.mark.parametrize("scenario", ["balanced", "everything"])
def test_cli_main_matches_the_reference(scenario, tmp_path, capsys,
                                        monkeypatch):
    """`cli_main`'s exit codes and output over the same stores, the clock
    pinned: the snapshot (text and JSON), --journey (found and not),
    --perfetto, --discover, and nothing found."""
    roots = _bank_scenario(tmp_path / "s", scenario)
    rid = tledger.Ledger(roots[0]).query(kind="service-request")[0]["id"]
    out = str(tmp_path / "pf.json")
    monkeypatch.setattr(time, "time", lambda: NOW)
    empty = tmp_path / "none" / "empty"
    empty.mkdir(parents=True)
    for opts, args in (({}, roots), ({"json": True}, roots),
                       ({"journey": rid}, roots),
                       ({"journey": "nope"}, roots),
                       ({"perfetto": out, "json": True}, roots),
                       ({"discover": roots[0]}, []),
                       ({"discover": str(empty)}, [])):
        codes, outs = [], []
        for mod in (jobs, tobs):
            codes.append(mod.cli_main(dict(opts), list(args)))
            outs.append(capsys.readouterr().out)
        assert codes[0] == codes[1], (opts, codes)
        assert outs[0] == outs[1], opts
    assert codes == [2, 2]


def test_default_discovery_starts_from_the_ports_store(tmp_path, capsys,
                                                        monkeypatch):
    """With no roots and no --discover the port federates around
    `store/torch` under the working directory, where the reference looks
    around `./store` and finds nothing; JEPSEN_TPU_FLEET_ROOTS wins."""
    monkeypatch.chdir(tmp_path)
    assert tobs.cli_main({}, []) == 2
    _heartbeat(tledger.Ledger(os.path.join(tledger.BASE_DIR, "r1")),
               time.time(), "r1")
    capsys.readouterr()
    assert tobs.cli_main({"json": True}, []) == 0
    snap = json.loads(capsys.readouterr().out)
    assert set(snap["replicas"]) == {"r1"}
    assert jobs.cli_main({"json": True}, []) == 2
    capsys.readouterr()
    monkeypatch.setenv(tobs.FLEET_ROOTS_ENV, str(tmp_path / "elsewhere"))
    assert tobs.cli_main({"json": True}, []) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["roots"] == [str(tmp_path / "elsewhere")]


# --- journeys and the merged trace over a served store -------------------------

def _served_store(root, pkg):
    """A store that one CPU `Service` of `pkg` ("ref" or "port") served:
    two requests (one invalid), an Elle append request, then one
    heartbeat, which exports the trace and series mirrors. Returns the
    request ids."""
    kw = dict(workers=1, warm_ladder=False, slo_every_s=3600.0,
              mesh_serving=False, heartbeat_every_s=0.0,
              replica_id=f"rep-{pkg}")
    svc = (jservice.Service(str(root), **kw) if pkg == "ref"
           else tservice.Service(str(root), device="cpu", **kw)).start()
    try:
        bodies = [{"model": "cas-register", "history": [
            op.to_dict() for op in jsynth.cas_register_history(
                80, n_procs=4, seed=s, lie_p=lie)]}
            for s, lie in ((3, 0.0), (8, 0.05))]
        bodies.append({"checker": "elle-append", "history": [
            op.to_dict() for op in jsynth.list_append_history(
                40, n_procs=3, seed=5)]})
        rids = []
        for b in bodies:
            rid = svc.submit(b)["id"]
            deadline = time.monotonic() + 120
            while svc.get(rid)["state"] not in ("done", "rejected"):
                assert time.monotonic() < deadline
                time.sleep(0.02)
            rids.append(rid)
        assert svc._heartbeat_once() is not None
    finally:
        svc.close()
    return rids


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_journey_and_perfetto_match_the_reference(pkg, tmp_path):
    roots = [str(tmp_path / "a"), str(tmp_path / "b")]
    rids = _served_store(roots[0], pkg)
    _heartbeat(tledger.Ledger(roots[1]), NOW, "idle")
    fj, ft = jobs.FederatedLedger(roots), tobs.FederatedLedger(roots)
    for rid in rids + ["no-such-run"]:
        got, want = tobs.journey(ft, rid, now=NOW), \
            jobs.journey(fj, rid, now=NOW)
        assert got == want
    assert tobs.journey(ft, rids[0])["complete"] is True
    assert tobs.journey(ft, rids[0])["replica"] == f"rep-{pkg}"
    got = tobs.fleet_perfetto(ft, path=str(tmp_path / "t.json"))
    want = jobs.fleet_perfetto(fj, path=str(tmp_path / "j.json"))
    assert got == want
    assert {e["pid"] for e in got["traceEvents"]} == {tobs.REPLICA_PID_BASE}
    with open(tmp_path / "t.json") as fh:
        assert json.load(fh) == want
    assert tobs.fleet_snapshot(ft, now=NOW) == \
        jobs.fleet_snapshot(fj, now=NOW)


def test_served_records_lint_clean(tmp_path):
    _served_store(tmp_path / "s", "port")
    led = tledger.Ledger(str(tmp_path / "s"))
    kinds = {r["kind"] for r in led.query()}
    assert {"service-request", "replica-heartbeat"} <= kinds
    assert telemetry_lint.lint_ledger_file(led.index_path) == []
    snap = tobs.fleet_snapshot([led.store_root])
    assert snap["live"] == 1 and snap["requests"] == 3


# --- devices.multichip_record ---------------------------------------------------

def _shard(dev, wall):
    return {"device": dev, "wall_s": wall, "engine": "device-mesh"}


MULTICHIP = {
    "all true": [{"valid?": True, "shard": _shard("cuda:0", 0.1234)},
                 {"valid?": True, "shard": _shard("cuda:0#1", 0.25)},
                 {"valid?": True, "shard": _shard("cuda:0", 0.00005)}],
    "one false": [{"valid?": True, "shard": _shard("cuda:0", 0.1)},
                  {"valid?": False, "shard": _shard("cuda:0#1", 0.2)},
                  {"valid?": "unknown", "shard": _shard("cuda:0#1", 0.3)}],
    "unknown": [{"valid?": "unknown"}, {"valid?": True, "shard": {}}],
    "empty": [],
    "junk": [None, "x", {"valid?": True,
                         "shard": {"device": 3, "wall_s": None}}],
}


@pytest.mark.parametrize("case", sorted(MULTICHIP))
@pytest.mark.parametrize("extra", [{}, {"hbm": {
    "peak_measured": 123, "stats_available": 2, "devices": {"x": 1},
    "stats_unavailable": None, "other": 9}, "platform": "gpu",
    "extra": {"keys": 3}}], ids=["plain", "hbm"])
def test_multichip_record_matches_the_reference(case, extra):
    got = tdevices.multichip_record("mesh-dryrun", 2, MULTICHIP[case], 1.23456,
                                    **extra)
    want = jdevices.multichip_record("mesh-dryrun", 2, MULTICHIP[case],
                                     1.23456, **extra)
    assert got == want


def test_multichip_record_banks_and_browses(tmp_path):
    led = tledger.Ledger(str(tmp_path))
    rid = led.record(tdevices.multichip_record(
        "mesh", 2, MULTICHIP["one false"], 0.5, platform="cpu"))
    assert telemetry_lint.lint_ledger_file(led.index_path) == []
    rec = led.get(rid)
    assert rec["verdict"] is False and rec["verdicts"] == {
        "true": 1, "false": 1, "unknown": 1}
    page = tweb.render_run(str(tmp_path), rid)
    assert b"multichip" in page and b"mesh" in page
