"""The port's checker service (`jepsen_tpu_torch/service.py`, `web.py`)
against the JAX package's.

The port's `Service(device="cpu")` and the reference's `Service` get the
same payloads, and agree on: bucket keys and verdicts; every rejection
cause (malformed, unknown model, queue-full, quota, preflight, shed with
its `retry_after_s`); coalescing (`batch_n`); the sequence of event
kinds; the keys of the `kind="service-request"` ledger record and of the
`service` and `service_batch` series points; `rewarm` from an isolated
`fs_cache` root; the mesh route (the port's `devices=["cpu"] * 2`
against the reference on its 8 JAX CPU devices, both on mode `mesh`,
verdicts equal); the `single-device` and `mesh-declined` degrades. Over
HTTP (`web.serve(port=0)`): POST /check 202, the SSE framing of
/runs/<id>/events and /events, /status.json's service and SLO blocks, a
shed's 503 with Retry-After, /runs.json and /runs/<id>.json, and 404 on
the pages not ported. `Service()` with no device raises where there is
no card. Histories are small and ladder warming is off
(`warm_ladder=False`) except where the warm is the subject.

On the card (`-m gpu`): the headline bucket served cold then warm, the
warm request under `CompileGuard(max_compiles=0)`.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from jepsen_tpu import fs_cache as jfs_cache
from jepsen_tpu import service as jservice
from jepsen_tpu import slo as jslo
from jepsen_tpu import synth as jsynth
from jepsen_tpu import web as jweb
from jepsen_tpu_torch import fs_cache as tfs_cache
from jepsen_tpu_torch import service as tservice
from jepsen_tpu_torch import slo as tslo
from jepsen_tpu_torch import web as tweb
from jepsen_tpu_torch.ops import encode as tencode
from jepsen_tpu_torch.parallel import mesh as tmesh

WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _isolate(monkeypatch, tmp_path):
    monkeypatch.setattr(jfs_cache, "DIR", str(tmp_path / "j-cache"))
    monkeypatch.setattr(tfs_cache, "DIR", str(tmp_path / "t-cache"))
    prev = (jservice.set_default(None), tservice.set_default(None))
    jslo._reset()
    tslo._reset()
    yield
    jservice.set_default(prev[0])
    tservice.set_default(prev[1])
    jslo._reset()
    tslo._reset()


def _kw(kw):
    kw.setdefault("workers", 1)
    kw.setdefault("warm_ladder", False)
    kw.setdefault("slo_every_s", 3600.0)
    kw.setdefault("mesh_serving", False)
    kw.setdefault("heartbeat_every_s", 0)
    return kw


def _ref(root, **kw):
    return jservice.Service(str(root), **_kw(kw))


def _port(root, **kw):
    kw = _kw(kw)
    if "devices" not in kw:
        kw.setdefault("device", "cpu")
    return tservice.Service(str(root), **kw)


def _pair(tmp_path, **kw):
    return _ref(tmp_path / "j", **kw), _port(tmp_path / "t", **kw)


def _hist(n=120, seed=1, lie_p=0.0):
    return jsynth.cas_register_history(n, n_procs=4, seed=seed, lie_p=lie_p)


def _body(h, **kw):
    """A POST body: the ops as dicts, as a client sends them."""
    return {"model": "cas-register", "history": [op.to_dict() for op in h],
            **kw}


def _wait(svc, rid, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        info = svc.get(rid)
        if info and info["state"] in ("done", "rejected"):
            return info
        time.sleep(0.02)
    raise AssertionError(f"run {rid} never finished")


def _held(svc, bodies):
    svc.hold(True)
    outs = [svc.submit(b) for b in bodies]
    svc.hold(False)
    return outs, [_wait(svc, o["id"]) for o in outs]


def _events(info):
    return [e["event"] for e in info["events"]]


def _close(*svcs):
    for s in svcs:
        s.close(timeout=10)


# --- admission ----------------------------------------------------------------

BAD = [
    ({"model": "nope", "history": []}, "unknown model"),
    ({"model": "cas-register", "history": []}, "empty"),
    ({"checker": "zap", "history": []}, "unknown checker"),
    ({"model": "cas-register", "history": [{"f": "read"}]}, "'type'"),
    ({"model": "cas-register", "history": "x"}, "list of op"),
    ("not a dict", "JSON object"),
]


@pytest.mark.parametrize("body,match", BAD, ids=[m for _, m in BAD])
def test_malformed_requests_raise_as_the_reference(tmp_path, body, match):
    j, t = _pair(tmp_path)
    for svc in (j, t):
        with pytest.raises(ValueError, match=match):
            svc.submit(body)
    _close(j, t)


def test_queue_positions_and_queue_full(tmp_path):
    j, t = _pair(tmp_path, max_queue=2)
    outs = {}
    for name, svc in (("j", j), ("t", t)):
        svc.hold(True)
        outs[name] = [svc.submit(_body(_hist(seed=s))) for s in (1, 2, 3)]
        assert svc.get("no-such-run") is None
    for a, b in zip(outs["j"], outs["t"]):
        assert {k: v for k, v in a.items() if k != "id"} == \
            {k: v for k, v in b.items() if k != "id"}
    assert outs["t"][2]["cause"] == "queue-full"
    assert _events(t.get(outs["t"][0]["id"])) == ["queued"]
    assert _events(t.get(outs["t"][2]["id"])) == ["rejected"]
    with t._cv:
        t._queues.clear()
    with j._cv:
        j._queues.clear()
    _close(j, t)


def test_quota_rejects_per_tenant_as_the_reference(tmp_path):
    j, t = _pair(tmp_path, quota_device_s=1.0)
    for svc in (j, t):
        svc.ledger.record({"kind": "service-request", "name": "s",
                           "verdict": True, "tenant": "greedy",
                           "device_s": 2.0, "wall_s": 2.0})
    outs = {}
    for name, svc in (("j", j), ("t", t)):
        svc.hold(True)
        assert svc.tenant_usage("greedy") == 2.0
        outs[name] = (svc.submit(_body(_hist(seed=1), tenant="greedy")),
                      svc.submit(_body(_hist(seed=2), tenant="frugal")))
    (ja, jb), (ta, tb) = outs["j"], outs["t"]
    assert ta["cause"] == ja["cause"] == "quota"
    assert tb["state"] == jb["state"] == "queued"
    rt, rj = t.ledger.get(ta["id"]), j.ledger.get(ja["id"])
    assert set(rt) == set(rj)
    assert rt["tenant"] == "greedy" and rt["cause"] == "quota"
    for obj in tslo.default_objectives():
        assert obj.good(rt) is None
    for svc in (j, t):
        with svc._cv:
            svc._queues.clear()
    _close(j, t)


def test_preflight_rejects_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_PREFLIGHT_MEM_BUDGET", "1000")
    j, t = _pair(tmp_path)
    a = j.submit(_body(_hist(seed=3)))
    b = t.submit(_body(_hist(seed=3)))
    assert b["state"] == a["state"] == "rejected"
    assert b["cause"] == a["cause"] == "preflight"
    rt, rj = t.ledger.get(b["id"]), j.ledger.get(a["id"])
    assert set(rt) == set(rj) and rt["cause"] == "preflight"
    # the gate banked its top-level analysis in the service's ledger
    pj, = j.ledger.query(kind="preflight")
    pt, = t.ledger.query(kind="preflight")
    assert set(pt) == set(pj) and pt["name"] == pj["name"]
    assert pt["verdict"] == pj["verdict"] == "infeasible"
    assert _events(t.get(b["id"])) == _events(j.get(a["id"])) == \
        ["rejected"]
    _close(j, t)


def test_shed_as_the_reference(tmp_path):
    j, t = _pair(tmp_path, shed_hold_s=30.0)
    outs = []
    for svc in (j, t):
        svc._note_slo({"alerts": [{"objective": "warm-p50"}]})
        assert svc.shedding()["burning"] == ["warm-p50"]
        outs.append(svc.submit(_body(_hist(seed=41), tenant="t")))
    a, b = outs
    assert b["cause"] == a["cause"] == "shed"
    assert 0 < b["retry_after_s"] <= 30.0 and set(a) == set(b)
    rt = t.ledger.get(b["id"])
    assert rt["shed"] is True and set(rt) == set(j.ledger.get(a["id"]))
    for svc in (j, t):
        svc._note_slo({"alerts": []})
        assert svc.shedding() is None
    opened = t.open_shed(["availability"], hold_s=5.0)
    assert opened == j.open_shed(["availability"], hold_s=5.0)
    t.close_shed()
    assert t.shedding() is None
    assert t.snapshot()["shed"] == 1
    _close(j, t)


# --- serving ------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both services, two sequential same-bucket requests each (the
    second a first-touch warm hit), then two held ones (one batch)."""
    root = tmp_path_factory.mktemp("served")
    prev = (jfs_cache.DIR, tfs_cache.DIR)
    jfs_cache.DIR, tfs_cache.DIR = str(root / "jc"), str(root / "tc")
    out = {}
    for name, make in (("j", _ref), ("t", _port)):
        svc = make(root / name)
        infos = []
        for seed in (1, 2):
            o = svc.submit(_body(_hist(seed=seed), tenant="tester"))
            infos.append(_wait(svc, o["id"]))
        _, held = _held(svc, [_body(_hist(seed=s)) for s in (3, 4)])
        out[name] = (svc, infos, held)
    yield out
    for svc, _, _ in out.values():
        svc.close(timeout=10)
    jfs_cache.DIR, tfs_cache.DIR = prev
    jservice.set_default(None)
    tservice.set_default(None)


def test_verdicts_buckets_and_warm_hits_match(served):
    (_, ij, hj), (_, it, ht) = served["j"], served["t"]
    for a, b in zip(ij + hj, it + ht):
        assert b["verdict"] == a["verdict"] is True
        assert b["bucket"] == a["bucket"]
        assert b["warm_hit"] == a["warm_hit"]
    assert [i["warm_hit"] for i in it] == [False, True]


def test_event_kinds_match(served):
    (_, ij, hj), (_, it, ht) = served["j"], served["t"]
    assert [_events(i) for i in it + ht] == [_events(i) for i in ij + hj]
    assert _events(it[0]) == ["queued", "serving", "done"]
    assert set(it[0]["phases"]) == set(ij[0]["phases"]) >= {
        "admit_s", "preflight_s", "queue_wait_s", "search_s", "respond_s"}


def test_coalesced_batch_matches(served):
    (sj, _, hj), (st, _, ht) = served["j"], served["t"]
    pj = {p["run_id"]: p for p in sj.mx.series("service").points}
    pt = {p["run_id"]: p for p in st.mx.series("service").points}
    assert [pt[i["id"]]["batch_n"] for i in ht] == \
        [pj[i["id"]]["batch_n"] for i in hj] == [2, 2]
    assert st.snapshot()["batches"] == sj.snapshot()["batches"] == 3


def test_record_and_series_keys_match(served):
    (sj, ij, _), (st, it, _) = served["j"], served["t"]
    rj = sj.ledger.query(kind="service-request")
    rt = st.ledger.query(kind="service-request")
    assert len(rt) == len(rj) == 4
    assert [sorted(r) for r in rt] == [sorted(r) for r in rj]
    assert [sorted(r["phases"]) for r in rt] == \
        [sorted(r["phases"]) for r in rj]
    for r in rt:
        assert r["verdict"] is True and isinstance(r["device_s"], float)
    for name in ("service", "service_batch"):
        a, b = sj.mx.series(name).points, st.mx.series(name).points
        assert len(a) == len(b) and [sorted(p) for p in b] == \
            [sorted(p) for p in a]
    assert [p["mode"] for p in st.mx.series("service_batch").points] == \
        [p["mode"] for p in sj.mx.series("service_batch").points]
    # one trace per request through admit .. respond
    spans = [sp for sp in st.tracer.spans
             if sp.attrs.get("run_id") == it[0]["id"]]
    assert {sp.name for sp in spans} >= {"admit", "preflight",
                                         "queue-wait", "search", "respond"}
    assert len({sp.trace_id for sp in spans}) == 1
    # the search's phase spans land in the service's tracer (the
    # request arrives encoded: no encode span)
    names = {sp.name for sp in st.tracer.spans}
    assert {"compile", "host-poll"} <= names and "encode" not in names


def test_snapshot_and_status_block_match(served):
    (sj, _, _), (st, _, _) = served["j"], served["t"]
    a, b = sj.snapshot(), st.snapshot()
    assert set(b) == set(a)
    for k in ("served", "rejected", "warm_hits", "batches", "warm_rate",
              "warm_buckets", "active", "queued"):
        assert b[k] == a[k], k
    tservice.set_default(st)
    jservice.set_default(sj)
    s = tweb.status_snapshot(st.store_root)
    r = jweb.status_snapshot(sj.store_root)
    assert set(s["service"]) == set(r["service"])
    assert set(s["slo"]) == set(r["slo"])
    assert s["service"]["served"] == 4
    assert len(s["last_runs"]) == len(r["last_runs"])
    assert tservice.snapshot()["served"] == 4


def test_elle_append_request_matches(tmp_path):
    j, t = _pair(tmp_path)
    h = jsynth.list_append_history(60, n_procs=4, seed=1)
    body = {"checker": "elle-append", "tenant": "e",
            "history": [op.to_dict() for op in h]}
    a, b = j.submit(dict(body)), t.submit(dict(body))
    assert b["bucket"] == a["bucket"] == "elle-append/1024"
    ia, ib = _wait(j, a["id"]), _wait(t, b["id"])
    assert ib["verdict"] == ia["verdict"] is True
    assert _events(ib) == _events(ia)
    rt, rj = t.ledger.get(b["id"]), j.ledger.get(a["id"])
    assert rt["checker"] == "elle-append" and set(rt) == set(rj)
    _close(j, t)


def test_rewarm_from_an_isolated_cache(tmp_path, monkeypatch):
    """A warmed bucket's plan lands in the port's own fs_cache; a new
    service re-warms it (for real, on the CPU) and answers its first
    same-bucket request warm. The reference's precompile is stubbed (as
    in its own test); the two registry entries are compared."""
    import jepsen_tpu.ops.aot as jaot
    monkeypatch.setattr(jaot, "precompile_service_bucket",
                        lambda bucket, accel=False: {2: 0.0})
    plans = {}
    for name, make, fs in (("j", _ref, jfs_cache), ("t", _port, tfs_cache)):
        svc = make(tmp_path / f"{name}a", warm_ladder=True)
        info = _wait(svc, svc.submit(_body(_hist(seed=5)))["id"])
        assert info["warm_hit"] is False
        assert "warmed" in _events(info)
        svc.close(timeout=10)
        plans[name] = fs.list_data(("service-plan",))
        svc2 = make(tmp_path / f"{name}b", warm_ladder=True, rewarm=True)
        info = _wait(svc2, svc2.submit(_body(_hist(seed=6)))["id"])
        assert info["warm_hit"] is True and info["verdict"] is True
        svc2.close(timeout=10)
    (pj,), (pt,) = plans["j"], plans["t"]
    assert {k: v for k, v in pt.items() if k != "t"} == \
        {k: v for k, v in pj.items() if k != "t"}
    # nothing of the reference's registry is read by the port
    assert tfs_cache.DIR != jfs_cache.DIR


# --- the mesh route -----------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_served(tmp_path_factory):
    """The same four same-bucket histories, the last one invalid (lying
    reads), held and released on both: the port over ["cpu"] * 2, the
    reference on its JAX CPU devices."""
    root = tmp_path_factory.mktemp("mesh")
    prev = (jfs_cache.DIR, tfs_cache.DIR)
    jfs_cache.DIR, tfs_cache.DIR = str(root / "jc"), str(root / "tc")
    bodies = [_body(_hist(seed=s)) for s in (31, 32, 33)] + [
        _body(_hist(seed=35, lie_p=0.05))]
    j = _ref(root / "j", max_batch=4, mesh_serving=True)
    t = _port(root / "t", max_batch=4, mesh_serving=True,
              devices=["cpu"] * 2)
    out = {"j": (j,) + _held(j, bodies), "t": (t,) + _held(t, bodies)}
    yield out
    _close(j, t)
    tmesh.pool_settle()
    tmesh.pool_clear()
    jfs_cache.DIR, tfs_cache.DIR = prev
    jservice.set_default(None)
    tservice.set_default(None)


def test_mesh_route_matches(mesh_served):
    (sj, oj, ij), (st, ot, it) = mesh_served["j"], mesh_served["t"]
    assert [i["verdict"] for i in it] == [i["verdict"] for i in ij]
    assert [i["verdict"] for i in it] == [True, True, True, False]
    pj, pt = (s.mx.series("service_batch").points for s in (sj, st))
    assert [p["mode"] for p in pt] == [p["mode"] for p in pj] == ["mesh"]
    assert pt[0]["batch_n"] == pj[0]["batch_n"] == 4
    assert sorted(pt[0]) == sorted(pj[0]) and pt[0]["rounds"] >= 1
    assert sum(pt[0]["shards"].values()) == 4
    assert set(pt[0]["shards"]) == {"cpu", "cpu#1"}
    assert st.snapshot()["mesh_batches"] == 1
    assert [_events(i) for i in it] == [_events(i) for i in ij]
    with st._lock:
        results = [st._runs[o["id"]].result for o in ot]
    for r in results:
        assert {"shard", "slot"} <= set(r["mesh"])
    assert [sorted(r) for r in st.ledger.query(kind="service-request")] == \
        [sorted(r) for r in sj.ledger.query(kind="service-request")]


def test_mesh_layout_is_the_device_list(tmp_path):
    t = _port(tmp_path, devices=["cpu"] * 3, max_batch=8, mesh_serving=True)
    assert t._device_count() == 3 and not t._accel()
    lay = t._mesh_layout()
    assert lay == {"n_devices": 3,
                   "lanes_per_device": tmesh.lanes_for(8, 3), "chunk": 1024}
    assert [str(d) for d in t._mesh_devices(lay)] == ["cpu"] * 3
    one = _port(tmp_path / "one", mesh_serving=True)
    assert one._device_count() == 1 and one._mesh_layout() is None
    _close(t, one)


def test_single_device_degrade_matches(tmp_path, monkeypatch):
    j, t = _pair(tmp_path, mesh_serving=True, max_batch=4)
    # the port's one-device service is the degrade; the reference's
    # eight CPU devices are patched to one
    monkeypatch.setattr(j, "_device_count", lambda: 1)
    bodies = [_body(_hist(seed=s)) for s in (35, 36)]
    _, ij = _held(j, bodies)
    _, it = _held(t, bodies)
    assert [i["verdict"] for i in it] == [i["verdict"] for i in ij]
    pj, pt = (s.mx.series("service_batch").points[-1] for s in (j, t))
    assert pt["mode"] == pj["mode"] == "degrade"
    assert pt["cause"] == pj["cause"] == "single-device"
    assert t.snapshot()["degrades"] == 1
    _close(j, t)


def test_mesh_declined_degrade_matches(tmp_path, monkeypatch):
    from jepsen_tpu.parallel import mesh as jmesh
    j = _ref(tmp_path / "j", mesh_serving=True, max_batch=4)
    t = _port(tmp_path / "t", mesh_serving=True, max_batch=4,
              devices=["cpu"] * 2)
    monkeypatch.setattr(jmesh, "check_mesh", lambda *a, **k: None)
    monkeypatch.setattr(tmesh, "check_mesh", lambda *a, **k: None)
    bodies = [_body(_hist(seed=s)) for s in (37, 38)]
    _, ij = _held(j, bodies)
    _, it = _held(t, bodies)
    assert [i["verdict"] for i in it] == [i["verdict"] for i in ij]
    pj, pt = (s.mx.series("service_batch").points[-1] for s in (j, t))
    assert pt["mode"] == pj["mode"] == "degrade"
    assert pt["cause"] == pj["cause"] == "mesh-declined"
    _close(j, t)


def test_mesh_member_bills_its_own_wall(tmp_path):
    t = _port(tmp_path)
    t.hold(True)
    outs = [t.submit(_body(_hist(seed=s))) for s in (51, 52)]
    with t._lock:
        reqs = [t._runs[o["id"]] for o in outs]
    t0 = time.monotonic()
    for sl, (req, w) in enumerate(zip(reqs, (0.05, 0.4))):
        t._finish_mesh_member(req, {"valid?": True,
                                    "shard": {"t0": t0 + 0.01, "wall_s": w,
                                              "device": "cpu"},
                                    "mesh": {"shard": 0, "slot": sl}},
                              True, 2, t0)
        assert req.serve_s == pytest.approx(w)
        assert req.phases["search_s"] == req.serve_s
        assert req.phases["queue_wait_s"] >= 0.0 and req.state == "done"
    with t._cv:
        t._queues.clear()
    t.hold(False)
    _close(t)


# --- lifecycle ----------------------------------------------------------------

def test_service_without_a_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        svc = tservice.Service(str(tmp_path), heartbeat_every_s=0)
        assert svc.device.type == "cuda" and svc._accel()
        svc.close(timeout=10)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tservice.Service(str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            tservice.Service(str(tmp_path), devices=["cuda"] * 2)


def test_concurrent_start_and_close(tmp_path):
    svc = _port(tmp_path, workers=2, heartbeat_every_s=3600.0)
    barrier = threading.Barrier(2)

    def go(fn):
        barrier.wait(timeout=5)
        fn()
    ts = [threading.Thread(target=go, args=(svc.start,)) for _ in range(2)]
    for x in ts:
        x.start()
    for x in ts:
        x.join(timeout=10)
    assert len(svc._threads) == 2 and svc._hb_thread.is_alive()
    hb = svc._hb_thread
    deadline = time.monotonic() + WAIT_S
    while svc.snapshot()["heartbeats"] < 1:
        assert time.monotonic() < deadline, "no heartbeat"
        time.sleep(0.02)
    barrier.reset()
    done = []
    ts = [threading.Thread(target=go, args=(
        lambda: done.append(svc.close(timeout=10)),)) for _ in range(2)]
    for x in ts:
        x.start()
    for x in ts:
        x.join(timeout=30)
    assert len(done) == 2 and svc._hb_thread is None
    assert not hb.is_alive() and svc._threads == []
    # the heartbeat banked the reference's record shape
    rec = svc.ledger.query(kind="replica-heartbeat")[-1]
    assert rec["devices"] == 1 and rec["workers"] == 2
    svc.start()
    info = _wait(svc, svc.submit(_body(_hist(40, seed=3)))["id"])
    assert info["state"] == "done"
    assert svc.resize_workers(1) == {"from": 2, "to": 1}
    with pytest.raises(ValueError):
        svc.resize_workers(0)
    svc.close(timeout=10)


# --- the web front door -------------------------------------------------------

@pytest.fixture(scope="module")
def http_service(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("http"))
    prev = tfs_cache.DIR
    tfs_cache.DIR = str(tmp_path_factory.mktemp("http-cache"))
    svc = _port(root)
    server = tweb.serve(host="127.0.0.1", port=0, store_root=root,
                        service=svc)
    th_ = threading.Thread(target=server.serve_forever, daemon=True)
    th_.start()
    yield f"http://127.0.0.1:{server.server_port}", svc
    server.shutdown()
    server.server_close()
    th_.join(timeout=10)
    svc.close(timeout=10)
    tfs_cache.DIR = prev
    tservice.set_default(None)


def _http(base, path, obj=None, expect=200, raw=None):
    data = raw if raw is not None else (
        None if obj is None else json.dumps(obj, default=str).encode())
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(req, timeout=WAIT_S)
        code, headers, body = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        code, headers, body = e.code, e.headers, e.read()
    assert code == expect, (code, body[:300])
    return headers, body


def _sse(raw: str):
    """[(event, data)] of an SSE body; every frame is `event:` then
    `data:` then a blank line."""
    out = []
    for frame in raw.split("\n\n"):
        if not frame.strip():
            continue
        ev, data = frame.split("\n")
        assert ev.startswith("event: ") and data.startswith("data: ")
        out.append((ev[7:], json.loads(data[6:])))
    return out


def test_post_check_and_the_run_stream(http_service):
    base, svc = http_service
    _, body = _http(base, "/check", _body(_hist(seed=7), tenant="http"),
                    expect=202)
    out = json.loads(body)
    assert out["state"] == "queued" and out["watch"] == \
        f"/runs/{out['id']}/events"
    _wait(svc, out["id"])
    _, raw = _http(base, out["watch"] + "?wait=30")
    events = _sse(raw.decode())
    names = [e for e, _ in events]
    assert names == ["snapshot", "queued", "serving", "done", "end"]
    done = dict(events)["done"]
    assert done["verdict"] == "true" and done["run_id"] == out["id"]
    # the ledger routes
    _, body = _http(base, "/runs.json")
    runs = json.loads(body)
    assert out["id"] in [r["id"] for r in runs]
    _, body = _http(base, f"/runs/{out['id']}.json")
    assert json.loads(body)["kind"] == "service-request"
    _http(base, "/runs/nope.json", expect=404)
    _http(base, f"/runs/{out['id']}/perfetto.json", expect=404)
    _http(base, "/runs/nope/events", expect=404)


def test_global_events_and_status(http_service):
    base, svc = http_service
    _, raw = _http(base, "/events?limit=2&wait=5")
    events = _sse(raw.decode())
    assert events
    for e, d in events:
        if e == "status":
            assert {"keys", "service"} <= set(d)
    tservice.set_default(svc)
    _, body = _http(base, "/status.json")
    s = json.loads(body)
    assert s["service"]["active"] is True
    assert set(s["service"]) >= {"queued", "served", "rejected",
                                 "warm_rate", "recent"}
    assert set(s["slo"]) >= {"checked", "alerts_total", "burning", "last"}
    assert {"preflight", "hbm", "mesh", "last_runs"} <= set(s)


def test_shed_is_a_503_with_retry_after(http_service):
    base, svc = http_service
    svc._note_slo({"alerts": [{"objective": "warm-p50"}]})
    try:
        headers, body = _http(base, "/check", _body(_hist(seed=8)),
                              expect=503)
    finally:
        svc._note_slo({"alerts": []})
    out = json.loads(body)
    assert out["cause"] == "shed" and int(headers["Retry-After"]) >= 1


def test_bad_bodies_and_unported_pages(http_service, tmp_path):
    base, _svc = http_service
    _, body = _http(base, "/check", {"model": "nope", "history": [1]},
                    expect=400)
    assert "error" in json.loads(body)
    _http(base, "/check", raw=b"not json", expect=400)
    _http(base, "/elsewhere", {"x": 1}, expect=404)
    for page in ("/", "/status", "/doctor", "/slo", "/devices", "/fleet",
                 "/files/x"):
        _http(base, page, expect=404)
    server = tweb.serve(host="127.0.0.1", port=0, store_root=str(tmp_path))
    th_ = threading.Thread(target=server.serve_forever, daemon=True)
    th_.start()
    try:
        _, body = _http(f"http://127.0.0.1:{server.server_port}", "/check",
                        _body(_hist(seed=9)), expect=503)
        assert "no service" in json.loads(body)["error"]
    finally:
        server.shutdown()
        server.server_close()
        th_.join(timeout=10)


def test_serve_command_on_the_cpu(tmp_path):
    """`python -m jepsen_tpu_torch serve --service --device cpu --devices
    2 -p 0`: it binds, prints its address, answers POST /check over two
    CPU shards, and stops when terminated."""
    env = dict(os.environ, HOME=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch", "serve", "--service",
         "--device", "cpu", "--devices", "2", "-b", "127.0.0.1", "-p", "0",
         "--store-root", str(tmp_path / "store")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        lines = []
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            if line.startswith("Checker service:"):
                break
            assert line, "".join(lines)
        base = next(x for x in lines
                    if x.startswith("Listening")).split()[2].rstrip("/")
        assert "['cpu', 'cpu']" in lines[-1]
        _, body = _http(base, "/check", _body(_hist(seed=11)), expect=202)
        rid = json.loads(body)["id"]
        _, raw = _http(base, f"/runs/{rid}/events?wait=30")
        done = dict(_sse(raw.decode()))["done"]
        assert done["verdict"] == "true"
        _, body = _http(base, f"/runs/{rid}.json")
        assert json.loads(body)["kind"] == "service-request"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_headline_bucket_cold_then_warm_on_card(cuda_device, tmp_path):
    from jepsen_tpu_torch import synth
    from jepsen_tpu_torch.analysis import guards
    from jepsen_tpu_torch.models import cas_register

    svc = tservice.Service(str(tmp_path), workers=1, slo_every_s=3600.0,
                           heartbeat_every_s=0)
    hs = [synth.cas_register_history(10000, n_procs=5, seed=s,
                                     crash_p=0.002) for s in (42, 43)]
    keys = {tservice.bucket_for(tencode.encode(cas_register(), h))[0]
            for h in hs}
    assert len(keys) == 1
    cold = _wait(svc, svc.submit(_body(hs[0]))["id"], timeout=600)
    assert cold["verdict"] is True and cold["warm_hit"] is False
    with guards.CompileGuard(max_compiles=0, name="service-warm") as g:
        warm = _wait(svc, svc.submit(_body(hs[1]))["id"], timeout=600)
    assert warm["verdict"] is True and warm["warm_hit"] is True
    rep = g.report()
    assert rep["builds"] == rep["loads"] == rep["binds"] == 0
    svc.close(timeout=10)
