"""The port's web pages (`jepsen_tpu_torch/web.py`) against the JAX
package's.

  * every case of `tests/test_web.py` on the port: a real dummy-remote
    run stored by the port's `core.run`, served on an ephemeral port:
    the home table with validity, the directory browser, file serving
    with content types, the `.zip` of a run, 403 out of the store, 404
    for a missing file, and `/status.json` idle, mid-run and from
    another process's mirror (with the `/status` panel);
  * the reference's page cases of `test_autopilot.py` (quarantine and
    history, the banked-records fallback), `test_devices.py` (the
    devices panel with fake devices, idle, without allocator stats),
    `test_doctor.py` (findings, no data, the record block and page, the
    in-process report, the status banner), `test_occupancy.py` (the
    occupancy panel and its no-data page), `test_slo.py` (objectives and
    the burn alert, a stale report's fallback, an empty store) and
    `test_service.py` (the `/slo` page of a serving process);
  * byte parity: every `render_*`, and `zip_dir_bytes`, of the two
    packages over one store, each package's planes in the same state
    (idle; a run's status mirror; a fake-device monitor; an in-process
    doctor report; an SLO report; an autopilot supervisor), the clock
    pinned where a page reads it. MASKS lists the one difference.
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
import zipfile

import pytest

from jepsen_tpu import autopilot as jap
from jepsen_tpu import devices as jdevices
from jepsen_tpu import doctor as jdoctor
from jepsen_tpu import fleet as jfleet
from jepsen_tpu import metrics as jmetrics
from jepsen_tpu import service as jservice
from jepsen_tpu import slo as jslo
from jepsen_tpu import web as jweb
from jepsen_tpu_torch import autopilot as tap
from jepsen_tpu_torch import checker, core, fakes
from jepsen_tpu_torch import devices as tdevices
from jepsen_tpu_torch import doctor as tdoctor
from jepsen_tpu_torch import fleet as tfleet
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import ledger as tledger
from jepsen_tpu_torch import metrics as tmetrics
from jepsen_tpu_torch import observatory as tobs
from jepsen_tpu_torch import service as tservice
from jepsen_tpu_torch import slo as tslo
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import web as tweb

# The one difference between the two packages' pages over one store: the
# package named in a command hint (`/doctor` with nothing to diagnose,
# `/autopilot` with no actions). The store root needs no mask, as both
# packages render the same store.
MASKS = ((b"python -m jepsen_tpu_torch ", b"python -m jepsen_tpu "),)

NOW = 1_700_000_000.0
PAIRS = ((jdoctor, tdoctor), (jslo, tslo), (jap, tap))


def _masked(page: bytes) -> bytes:
    for port, ref in MASKS:
        page = page.replace(port, ref)
    return page


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv(tobs.FLEET_ROOTS_ENV, raising=False)
    for pair in PAIRS:
        for mod in pair:
            mod._reset()
    prev = (jservice.set_default(None), tservice.set_default(None))
    for w in (jweb, tweb):
        for cache in ("_DOCTOR_CACHE", "_SLO_CACHE", "_FLEET_CACHE",
                      "_LAST_RUNS_CACHE", "_DOCTOR_REC_CACHE"):
            getattr(w, cache).clear()
    yield
    jservice.set_default(prev[0])
    tservice.set_default(prev[1])
    for pair in PAIRS:
        for mod in pair:
            mod._reset()


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """One real (dummy-remote) run in a fresh store, by the port."""
    root = str(tmp_path_factory.mktemp("webstore"))
    core.run({
        "name": "web-demo",
        "store_root": root,
        "nodes": ["n1", "n2"],
        "concurrency": 2,
        "ssh": {"dummy?": True},
        "client": fakes.AtomClient(fakes.SharedRegister()),
        "checker": checker.stats(),
        "generator": gen.limit(10, gen.clients(
            gen.repeat(lambda: {"f": "read"}))),
    })
    return root


def _serve(root):
    server = tweb.serve(host="127.0.0.1", port=0, store_root=root)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_port}"


@pytest.fixture(scope="module")
def base_url(store_root):
    server, base = _serve(store_root)
    yield base
    server.shutdown()
    server.server_close()


def get(url, expect=200):
    try:
        resp = urllib.request.urlopen(url, timeout=10)
        assert resp.status == expect
        return resp.read()
    except urllib.error.HTTPError as e:
        assert e.code == expect
        return e.read()


# --- tests/test_web.py on the port -----------------------------------------------

def test_home_lists_run_with_validity(base_url):
    body = get(base_url + "/").decode()
    assert "web-demo" in body
    assert "True" in body  # validity cell
    assert "/files/web-demo" in body


def test_dir_browse(base_url):
    body = get(base_url + "/files/web-demo").decode()
    assert "web-demo" in body
    # the run-timestamp subdir is rendered as a colored cell
    assert "latest" in body or "<div" in body


def test_file_serving(base_url, store_root):
    latest = tstore.latest(store_root)
    rel = latest.split(store_root)[-1].strip("/")
    body = get(f"{base_url}/files/{rel}/results.json").decode()
    assert '"valid?"' in body


def test_zip_download(base_url, store_root):
    latest = tstore.latest(store_root)
    rel = latest.split(store_root)[-1].strip("/")
    raw = get(f"{base_url}/files/{rel}.zip")
    names = zipfile.ZipFile(io.BytesIO(raw)).namelist()
    assert "results.json" in names
    assert "test.jepsen" in names


def test_path_traversal_rejected(base_url):
    get(base_url + "/files/../../../etc/passwd", expect=403)


def test_missing_file_404(base_url):
    get(base_url + "/files/nope/nothing.txt", expect=404)


STATUS_KEYS = {"schema", "active", "test", "phase", "started",
               "updated", "elapsed_s", "eta_s", "keys", "devices",
               "search", "nemesis", "ops", "faults"}


def test_status_json_idle_schema(base_url):
    assert not tfleet.get_default().enabled  # no ambient run status
    snap = json.loads(get(base_url + "/status.json"))
    assert STATUS_KEYS <= set(snap)
    assert snap["active"] is False
    assert snap["keys"] == {"total": 0, "decided": 0, "live": 0,
                            "failures": 0}


def test_status_json_mid_run(base_url):
    st = tfleet.RunStatus(test="live-run", progress=False)
    with tfleet.use(st):
        st.phase("independent-check")
        st.begin_keys(10)
        st.device_state("cuda:0", "searching", key_index=3)
        st.key_done({"key_index": 0, "device": "cuda:0",
                     "engine": "device", "wall_s": 0.2, "valid?": True})
        st.nemesis_event("start-partition", True)
        st.search_poll({"frontier": 12, "backlog": 3, "explored": 500,
                        "poll_s": 0.1})
        snap = json.loads(get(base_url + "/status.json"))
    assert STATUS_KEYS <= set(snap)
    assert snap["active"] is True
    assert snap["test"] == "live-run"
    assert snap["phase"] == "independent-check"
    assert snap["keys"]["total"] == 10
    assert snap["keys"]["decided"] == 1
    assert snap["devices"]["cuda:0"]["keys_done"] == 1
    assert snap["search"]["frontier"] == 12
    assert snap["nemesis"] == {"active": True, "f": "start-partition",
                               "since_s": snap["nemesis"]["since_s"]}
    assert snap["eta_s"] is not None
    # the HTML panel renders the same source and auto-refreshes
    with tfleet.use(st):
        body = get(base_url + "/status").decode()
    assert "http-equiv='refresh'" in body
    assert "live-run" in body
    assert "cuda:0" in body
    assert "nemesis window OPEN" in body


def test_status_json_file_fallback(tmp_path):
    root = str(tmp_path)
    st = tfleet.RunStatus(
        test="other-proc",
        status_file=f"{root}/{tfleet.STATUS_FILENAME}", progress=False)
    st.begin_keys(3)
    st.finish(valid=True)
    server, base = _serve(root)
    try:
        snap = json.loads(get(base + "/status.json"))
    finally:
        server.shutdown()
        server.server_close()
    assert snap["test"] == "other-proc"
    assert snap["phase"] == "done"


# --- the reference's page cases of the plane test files, on the port -------------

def _host_classes(mod=tap):
    """OneRuleHost / StuckHost (as in tests/test_autopilot.py) over one
    package's `Host`."""

    class OneRuleHost(mod.Host):
        """Fires one rule; the metric improves once `actuate` ran."""

        def __init__(self, rule="D001", before=50.0, after=0.0):
            self.rule, self.before, self.after = rule, before, after
            self.applied = 0

        def diagnose(self):
            return {"findings": [{
                "rule": self.rule, "name": "compile-storm",
                "severity": "warn", "summary": f"seeded {self.rule}",
                "subject": "W=7,K=16", "score": 9.0, "evidence": []}]}

        def probe(self, metric, since=None):
            return self.after if self.applied else self.before

        def actuate(self, entry, finding):
            self.applied += 1
            return {"subject": finding.get("subject")}, lambda: None

    class StuckHost(OneRuleHost):
        """The actuator runs but the metric never improves."""

        def probe(self, metric, since=None):
            return self.before

    return OneRuleHost, StuckHost


def test_autopilot_panel_renders_quarantine_and_history(tmp_path):
    _, stuck = _host_classes()
    sup = tap.Supervisor(stuck(), verify_after_s=0.0)
    tap.set_default(sup)
    sup.step(now=100.0)
    sup.step(now=101.0)
    html = tweb.render_autopilot(str(tmp_path / "store")).decode()
    assert "QUARANTINED" in html
    assert "policy table" in html
    assert "reverted" in html


def test_autopilot_panel_falls_back_to_banked_records(tmp_path):
    one, _ = _host_classes()
    led = tledger.Ledger(str(tmp_path))
    sup = tap.Supervisor(one(), verify_after_s=0.0, ledger=led)
    sup.step(now=100.0)
    sup.step(now=101.0)
    # no live supervisor installed: the panel reads the store
    html = tweb.render_autopilot(str(tmp_path)).decode()
    assert "ledger" in html and "warm-bucket" in html


def _fake_devices():
    from test_devices import FakeDev, two_fakes
    return FakeDev, two_fakes


def test_devices_panel_renders(base_url):
    _, two_fakes = _fake_devices()
    mon = tdevices.DeviceMonitor(devices=two_fakes())
    mon.sample(force=True)
    with tdevices.use(mon):
        body = get(base_url + "/devices").decode()
    assert "device observatory" in body
    assert "FAKE_0" in body and "FAKE_1" in body
    assert "GiB" in body  # formatted byte columns


def test_devices_panel_idle(base_url):
    assert "no device samples yet" in get(base_url + "/devices").decode()


def test_devices_panel_no_stats_marker(base_url):
    fake_dev, _ = _fake_devices()
    mon = tdevices.DeviceMonitor(devices=[fake_dev("CPU_0", stats=False)])
    mon.sample(force=True)
    with tdevices.use(mon):
        body = get(base_url + "/devices").decode()
    assert "no allocator stats" in body


def _doctor_store(root):
    tledger.Ledger(str(root)).record({
        "kind": "independent", "name": "key-0", "t": 1.0, "compiles": 10,
        "platform": "cpu", "shapes": {"K": 16, "W_pad": 7},
        "verdict": True})
    return str(root)


@pytest.fixture()
def doctor_base_url(tmp_path):
    root = _doctor_store(tmp_path)
    server, base = _serve(root)
    yield base, root
    server.shutdown()
    server.server_close()


def test_doctor_panel_renders_findings(doctor_base_url):
    base, _ = doctor_base_url
    body = get(base + "/doctor").decode()
    assert "D001" in body
    assert "compile-storm" in body


def test_doctor_panel_no_data(tmp_path):
    body = tweb.render_doctor(str(tmp_path)).decode()
    assert "nothing to diagnose" in body
    assert "python -m jepsen_tpu_torch doctor" in body


def test_run_json_carries_doctor_block(doctor_base_url):
    base, root = doctor_base_url
    rid = tledger.Ledger(root).query()[0]["id"]
    rec = json.loads(get(f"{base}/runs/{rid}.json"))
    assert rec["doctor"]["rules_fired"] == ["D001"]


def test_run_page_shows_findings(doctor_base_url):
    base, root = doctor_base_url
    rid = tledger.Ledger(root).query()[0]["id"]
    assert "doctor findings" in get(f"{base}/runs/{rid}").decode()


def test_in_process_report_wins_panel(tmp_path):
    root = _doctor_store(tmp_path)
    rep = tdoctor.diagnose(tdoctor.TelemetryView(
        target="in-proc", results={"r": {"stalls": 1}}))
    tdoctor.record_report(rep, where="test")
    body = tweb.render_doctor(root).decode()
    assert "in-proc" in body
    assert "D006" in body


def test_status_banner_shows_top_finding(tmp_path):
    root = _doctor_store(tmp_path)
    rep = tdoctor.diagnose(tdoctor.TelemetryView(
        target="test", results={"r": {"stalls": 1}}))
    tdoctor.record_report(rep, where="test")
    body = tweb.render_status(root).decode()
    assert "doctor panel" in body and "D006" in body


def test_occupancy_panel_renders(tmp_path):
    st = tfleet.RunStatus(enabled=True, test="occ-panel")
    st.occupancy_poll({"mode": "single", "kernel": "wgl32",
                       "platform": "cpu", "K": 16,
                       "fill_last": 0.9, "fill_mean": 0.5,
                       "rounds_seen": 4,
                       "recent_rounds": [{"round": i, "fill": i / 4}
                                         for i in range(1, 5)]})
    with tfleet.use(st):
        doc = tweb.render_occupancy(str(tmp_path)).decode()
    assert "kernel occupancy" in doc
    assert "0.9" in doc
    assert "target" in doc
    # and the no-data page never errors
    prev = tfleet.set_default(tfleet.RunStatus(enabled=False))
    try:
        doc2 = tweb.render_occupancy(str(tmp_path)).decode()
    finally:
        tfleet.set_default(prev)
    assert "no occupancy data" in doc2


def _req(t, *, wall=0.1, warm=True, verdict=True, queue_wait=0.01):
    return {"kind": "service-request", "t": t, "verdict": verdict,
            "wall_s": wall, "warm_hit": warm, "tenant": "t",
            "batch_n": 1, "device_s": 0.01,
            "phases": {"queue_wait_s": queue_wait,
                       "search_s": max(wall - queue_wait, 0.0)}}


def test_slo_panel_renders_objectives_and_alert(tmp_path):
    now = time.time()
    eng = tslo.Engine(windows_s=(60.0, 600.0),
                      ledger=tledger.Ledger(str(tmp_path)))
    eng.evaluate_and_publish(
        now=now, records=[_req(now - 40 * i, wall=9.0) for i in range(10)],
        mx=tmetrics.NULL)
    body = tweb.render_slo(str(tmp_path)).decode()
    assert "warm-p50" in body
    assert "BURN ALERT" in body


def test_slo_panel_stale_report_falls_back(tmp_path):
    eng = tslo.Engine(windows_s=(60.0, 600.0),
                      ledger=tledger.Ledger(str(tmp_path)))
    eng.evaluate_and_publish(   # ancient evaluation: stale
        now=NOW, records=[_req(NOW - 40 * i, wall=9.0) for i in range(10)],
        mx=tmetrics.NULL)
    assert "BURN ALERT" not in tweb.render_slo(str(tmp_path)).decode()


def test_slo_panel_empty_store(tmp_path):
    body = tweb.render_slo(str(tmp_path)).decode()
    assert "no SLO evaluations yet" in body


def test_slo_panel_served_by_a_service(tmp_path):
    svc = tservice.Service(str(tmp_path), device="cpu", workers=1,
                           warm_ladder=False, slo_every_s=3600.0,
                           mesh_serving=False, heartbeat_every_s=0)
    server = tweb.serve(host="127.0.0.1", port=0, store_root=str(tmp_path),
                        service=svc)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{server.server_port}/slo", timeout=10)
        assert resp.status == 200
        assert b"service objectives" in resp.read()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


# --- byte parity with the reference ------------------------------------------------

RENDERS = ("render_status", "render_occupancy", "render_devices",
           "render_doctor", "render_slo", "render_autopilot",
           "render_fleet", "render_runs")


def _pages(root, monkeypatch):
    """{(page, package): bytes} for every store-root page, the run pages
    of every ledger record and the browse pages of every directory, the
    clock pinned."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    out = {}
    recs = tledger.Ledger(root).query()
    dirs = [d for d, _, _ in os.walk(root)]
    for pkg, w in (("ref", jweb), ("port", tweb)):
        for name in RENDERS:
            out[name, pkg] = getattr(w, name)(root)
        for r in recs:
            out["render_run " + r["id"], pkg] = w.render_run(root, r["id"])
        out["render_run nope", pkg] = w.render_run(root, "nope")
        cache = w._ValidityCache(root)
        out["render_home", pkg] = w.render_home(cache)
        for d in dirs:
            out["render_dir " + os.path.relpath(d, root), pkg] = \
                w.render_dir(cache, d)
    return out


def _assert_parity(out):
    names = sorted({k[0] for k in out})
    for name in names:
        ref, port = out[name, "ref"], out[name, "port"]
        if ref is None:
            assert port is None, name
            continue
        assert _masked(port) == ref, name
    return names


def _status_mirror(root, *, service=False):
    """A `current-status.json` a run in another process left: the same
    bytes for both packages."""
    snap = {**tweb._idle_status(), "active": True, "test": "mirror-run",
            "phase": "independent-check", "started": NOW - 30,
            "updated": NOW - 1, "elapsed_s": 29.0, "eta_s": 12.5,
            "keys": {"total": 10, "decided": 4, "live": 2, "failures": 1},
            "devices": {"cuda:0": {"state": "searching", "keys_done": 3,
                                   "last_key": 7, "busy_s": 1.5,
                                   "faults": 0}},
            "search": {"frontier": 12, "backlog": 3},
            "nemesis": {"active": True, "f": "start-partition",
                        "since_s": 4.2},
            "ops": {"invoked": 55, "completed": 50},
            "faults": [{"type": "oom", "device": "cuda:0",
                        "key_index": 2, "error": "x<y>"}],
            "watchdog": {"stalls": 2, "last_source": "chunk"},
            "occupancy": {"active": True, "mode": "batched",
                          "kernel": "wgl32", "platform": "gpu", "K": 64,
                          "rounds_seen": 9, "rounds_dropped": 0,
                          "fill_last": 0.85, "fill_mean": 0.3,
                          "adapt": {"ladder": [2, 16, 64],
                                    "switches": 2},
                          "lanes": {"n": 4, "fill_min": 0.1,
                                    "fill_max": 0.9, "empty": 1},
                          "elle": {"kernel": "bf16", "n": 4096,
                                   "edges": 100, "iters_run": 10,
                                   "kernel_s": 0.01,
                                   "reach_density": 0.2},
                          "recent": [{"round": i, "fill": i / 10}
                                     for i in range(10)]}}
    if service:
        snap["service"] = {"active": True, "queued": 2, "submitted": 9,
                           "served": 7, "warm_rate": 0.5, "rejected": 1,
                           "warm_buckets": 3}
        snap["slo"] = {"checked": 3, "alerts_total": 1,
                       "burning": ["warm-p50"], "last": None}
        snap["mesh"] = {"active": True, "runs": 2, "steals": 1,
                        "rebuckets": 0,
                        "last": {"work_skew_after": 1.2, "n_devices": 2}}
    with open(os.path.join(root, tfleet.STATUS_FILENAME), "w") as fh:
        json.dump(snap, fh)


def _fleet_stores(parent):
    """The store and two sibling replica stores beside it, with
    heartbeats (one silent) and requests."""
    for rid, age, served in (("r1", 0.5, 20), ("r2", 30.0, 2)):
        led = tledger.Ledger(os.path.join(parent, rid))
        for j in range(6):
            led.record({"kind": "service-request", "t": NOW - 5 - j,
                        "name": "service:x", "verdict": True if j % 3
                        else "unknown", "wall_s": 0.05 + 0.7 * (j % 2),
                        "warm_hit": bool(j % 2), "tenant": "a",
                        "batch_n": 1, "phases": {"queue_wait_s": 0.01}})
        led.record({"kind": "replica-heartbeat", "t": NOW - age,
                    "name": f"replica:{rid}", "replica": rid,
                    "every_s": 2.0, "served": served, "queued": 0,
                    "warm_rate": 0.9 if rid == "r1" else 0.1,
                    "warm_buckets": ["b0", "b1"] if rid == "r1" else
                    ["b2"], "devices": 2})


STATES = ("idle", "mirror", "mirror with service", "live planes", "fleet")


@pytest.mark.parametrize("state", STATES)
def test_every_page_is_the_references(state, store_root, tmp_path,
                                      monkeypatch):
    """Each `render_*` of the port over one store equals the reference's
    byte for byte but for MASKS, in each state of the planes."""
    import shutil
    root = str(tmp_path / "store")
    shutil.copytree(store_root, root, symlinks=True)
    if state in ("mirror", "mirror with service"):
        _status_mirror(root, service=state == "mirror with service")
    elif state == "live planes":
        _, two_fakes = _fake_devices()
        for dev_mod, doc_mod, slo_mod, ap_mod, mx_mod in (
                (jdevices, jdoctor, jslo, jap, jmetrics),
                (tdevices, tdoctor, tslo, tap, tmetrics)):
            host = _host_classes(ap_mod)[1]
            mon = dev_mod.DeviceMonitor(devices=two_fakes())
            mon.sample(force=True)
            monkeypatch.setattr(dev_mod, "_default", mon)
            doc_mod.record_report(doc_mod.diagnose(doc_mod.TelemetryView(
                target="in-proc", results={"r": {"stalls": 1}})),
                where="test")
            slo_mod.Engine(windows_s=(60.0, 600.0)).evaluate_and_publish(
                now=NOW, records=[_req(NOW - 40 * i, wall=9.0)
                                  for i in range(10)], mx=mx_mod.NULL)
            sup = ap_mod.Supervisor(host(), verify_after_s=0.0)
            ap_mod.set_default(sup)
            sup.step(now=NOW - 2)
            sup.step(now=NOW - 1)
    elif state == "fleet":
        _fleet_stores(str(tmp_path))
    out = _pages(root, monkeypatch)
    names = _assert_parity(out)
    assert {"render_home", "render_dir ."} <= set(names)
    assert any(n.startswith("render_run ") for n in names)
    # each state shows on the pages it feeds
    marks = {"idle": ("render_home", b"web-demo"),
             "mirror": ("render_occupancy", b"elle closure"),
             "mirror with service": ("render_status", b"SLO burn alert"),
             "live planes": ("render_autopilot", b"QUARANTINED"),
             "fleet": ("render_fleet", b"D013")}
    page, mark = marks[state]
    assert mark in out[page, "port"]
    if state == "live planes":
        assert b"in-proc" in out["render_doctor", "port"]
        assert b"FAKE_1" in out["render_devices", "port"]
        assert b"BURN ALERT" in out["render_slo", "port"]


def test_the_masks_are_needed_and_enough(tmp_path, monkeypatch):
    """An empty store: `/doctor` and `/autopilot` name their package in
    a command hint, and nothing else differs."""
    out = _pages(str(tmp_path), monkeypatch)
    differ = sorted(n for n, p in out if p == "ref"
                    and out[n, "ref"] != out[n, "port"])
    assert differ == ["render_autopilot", "render_doctor"]
    _assert_parity(out)


def test_zip_is_the_references(store_root):
    run = tstore.latest(store_root)
    got, want = tweb.zip_dir_bytes(run).getvalue(), \
        jweb.zip_dir_bytes(run).getvalue()
    assert got == want
    names = zipfile.ZipFile(io.BytesIO(got)).namelist()
    assert {"results.json", "test.jepsen", "history.txt"} <= set(names)


@pytest.mark.parametrize("path,want", [
    ("/", 200), ("/status", 200), ("/occupancy", 200), ("/devices", 200),
    ("/doctor", 200), ("/slo", 200), ("/autopilot", 200), ("/fleet", 200),
    ("/fleet.json", 200), ("/runs", 200), ("/runs/", 200),
    ("/runs.json", 200), ("/status.json", 200), ("/runs/nope", 404),
    ("/runs/nope.json", 404), ("/files/web-demo", 200),
    ("/files/web-demo/latest/results.json", 200),
    ("/files/web-demo/latest.zip", 200), ("/files/../x", 403),
    ("/files/nope", 404), ("/nope", 404)])
def test_routes_answer_the_references_codes(path, want, store_root,
                                            base_url, monkeypatch):
    """Every GET route of the reference, against the reference's own
    server over the same store, the clock pinned."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    server = jweb.serve(host="127.0.0.1", port=0, store_root=store_root)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        ref_base = f"http://127.0.0.1:{server.server_port}"
        got = get(base_url + path, expect=want)
        ref = get(ref_base + path, expect=want)
    finally:
        server.shutdown()
        server.server_close()
    if path.endswith(".zip"):
        assert got == ref
    if path in ("/runs.json", "/fleet.json"):
        assert json.loads(got) == json.loads(ref)
