"""The port's lock-order witness (`analysis/lockwatch.py`) and its six sites.

The same scripted acquires drive the port's witness and the reference's
(`jepsen_tpu/analysis/lockwatch.py`): a seeded inversion (strict and
record-only), a three-lock cycle, clean nesting, a reentrant RLock, a
`Condition` wait and a contended acquire. Both `report()`s have the same
edges, cycles and lock labels, and both `bank()` records lint under
`scripts/telemetry_lint.py`. With JEPSEN_TPU_LOCKWATCH unset each of
the six lock sites (service, watchdog, autopilot, observatory, fleet
status, the streamed fan-out's queue) holds exactly a `threading.Lock`
or `RLock` and the witness counts no event over a CPU check; set, each
is witnessed under the reference's label, the service's snapshot has
the reference's `lockwatch` block and `close()` banks one record; and
a real contended series from the witness fires the doctor's D016 in
both packages.
"""

import ast
import os
import sys
import threading
import time

import pytest

from jepsen_tpu import doctor as jdoctor
from jepsen_tpu.analysis import lockwatch as jlw
from jepsen_tpu_torch import autopilot as tautopilot
from jepsen_tpu_torch import doctor as tdoctor
from jepsen_tpu_torch import fleet as tfleet
from jepsen_tpu_torch import fs_cache as tfs_cache
from jepsen_tpu_torch import ledger as tledger
from jepsen_tpu_torch import metrics as tmetrics
from jepsen_tpu_torch import observatory as tobservatory
from jepsen_tpu_torch import service as tservice
from jepsen_tpu_torch import slo as tslo
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch import watchdog as twatchdog
from jepsen_tpu_torch.analysis import lockwatch as tlw
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.parallel import batched as tbatched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import telemetry_lint  # noqa: E402

PLAIN_LOCK = type(threading.Lock())
PLAIN_RLOCK = type(threading.RLock())
SITES = {  # label -> (port file, reentrant)
    "service": ("service.py", True),
    "watchdog": ("watchdog.py", False),
    "autopilot": ("autopilot.py", False),
    "observatory.cache": ("observatory.py", False),
    "fleet.status": ("fleet.py", False),
    "batched.queue": ("parallel/batched.py", False),
}


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv(tlw.ENV, "1")
    monkeypatch.setenv(tlw.STRICT_ENV, "1")
    jlw.reset()
    tlw.reset()
    yield
    jlw.reset()
    tlw.reset()


@pytest.fixture
def disarmed(monkeypatch):
    monkeypatch.delenv(tlw.ENV, raising=False)
    tlw.reset()
    yield
    tlw.reset()


@pytest.fixture
def isolated(monkeypatch, tmp_path):
    monkeypatch.setattr(tfs_cache, "DIR", str(tmp_path / "t-cache"))
    prev = tservice.set_default(None)
    tslo._reset()
    yield
    tservice.set_default(prev)
    tslo._reset()


# ---------------------------------------------------------------------------
# the same scripted acquires on both witnesses
# ---------------------------------------------------------------------------

def _inversion(lw):
    a, b = lw.lock("A"), lw.lock("B")
    with a:
        with b:
            pass
    raised = False
    try:
        with b:
            with a:
                pass
    except lw.LockOrderViolation as e:
        raised = "'A'" in str(e) and "'B'" in str(e)
    # the raise released what it took: both reacquirable
    again = a.acquire(timeout=1) and b.acquire(timeout=1)
    a.release()
    b.release()
    return {"raised": raised, "again": again}


def _record_only(lw):
    os.environ[lw.STRICT_ENV] = "0"
    a, b = lw.lock("A"), lw.lock("B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return {}


def _three_lock_cycle(lw):
    a, b, c = lw.lock("A"), lw.lock("B"), lw.lock("C")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    try:
        with c:
            with a:
                pass
    except lw.LockOrderViolation:
        return {"raised": True}
    return {"raised": False}


def _clean_nesting(lw):
    a, b = lw.lock("A"), lw.lock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    return {}


def _reentrant(lw):
    r = lw.rlock("R")
    with r:
        with r:
            with r:
                pass
    return {}


def _condition(lw):
    r = lw.rlock("svc")
    cv = threading.Condition(r)
    inner = lw.lock("inner")
    hits = []
    ready = threading.Event()

    def waiter():
        with cv:
            ready.set()
            hits.append(cv.wait(timeout=5))
            with inner:
                pass

    t = threading.Thread(target=waiter, name="waiter")
    t.start()
    ready.wait(5)
    with cv:
        cv.notify_all()
    t.join(5)
    return {"hits": hits}


def _contended(lw):
    lk = lw.lock("hot")
    started = threading.Event()

    def holder():
        with lk:
            started.set()
            time.sleep(0.05)

    t = threading.Thread(target=holder, name="holder")
    t.start()
    started.wait(5)
    with lk:
        pass
    t.join(5)
    return {}


SCENARIOS = {
    "inversion": _inversion, "record-only": _record_only,
    "three-lock-cycle": _three_lock_cycle, "clean-nesting": _clean_nesting,
    "reentrant": _reentrant, "condition": _condition,
    "contended": _contended,
}


def _drive(lw, name, monkeypatch):
    monkeypatch.setenv(lw.STRICT_ENV, "1")
    lw.reset()
    out = SCENARIOS[name](lw)
    rep = lw.report()
    return out, rep


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_acquires_report_as_the_reference(name, armed,
                                                   monkeypatch):
    want_out, want = _drive(jlw, name, monkeypatch)
    got_out, got = _drive(tlw, name, monkeypatch)
    assert got_out == want_out
    assert got["edges"] == want["edges"]
    assert got["cycles"] == want["cycles"]
    assert got["cycle"] is want["cycle"]
    assert sorted(got["locks"]) == sorted(want["locks"])
    assert set(got) == set(want)
    for label, st in got["locks"].items():
        assert set(st) == set(want["locks"][label])
        if name != "contended":
            assert st["acquires"] == want["locks"][label]["acquires"]
    expect = {"inversion": True, "record-only": True,
              "three-lock-cycle": True}.get(name, False)
    assert got["cycle"] is expect
    if name in ("inversion", "three-lock-cycle"):
        assert got_out["raised"] is True
    if name == "inversion":
        assert got_out["again"] is True
        assert got["cycles"][0]["locks"] == ["A", "B"]
    if name == "reentrant":
        assert got["edges"] == [] and got["locks"]["R"]["acquires"] == 1
    if name == "condition":
        assert got_out["hits"] == [True]
        assert ["svc", "inner"] in got["edges"]
    if name == "contended":
        assert got["locks"]["hot"]["contended"] >= 1
        assert got["locks"]["hot"]["wait_max_s"] > 0
    tlw.reset()


def test_the_api_is_the_references():
    names = ["ENV", "STRICT_ENV", "LockOrderViolation", "lock", "rlock",
             "WatchedLock", "enabled", "strict", "report", "bank", "reset",
             "events"]
    for n in names:
        assert hasattr(tlw, n) and hasattr(jlw, n), n
    assert (tlw.ENV, tlw.STRICT_ENV) == (jlw.ENV, jlw.STRICT_ENV)
    assert issubclass(tlw.LockOrderViolation, AssertionError)
    for m in ("_release_save", "_acquire_restore", "_is_owned", "locked"):
        assert callable(getattr(tlw.WatchedLock, m))


@pytest.mark.parametrize("which", ["port", "reference"])
def test_bank_writes_a_lintable_record(which, armed, tmp_path):
    lw = tlw if which == "port" else jlw
    if which == "port":
        led = tledger.Ledger(str(tmp_path))
    else:
        from jepsen_tpu import ledger as jledger
        led = jledger.Ledger(str(tmp_path))
    a, b = lw.lock("A"), lw.lock("B")
    with a:
        with b:
            pass
    rid = lw.bank(led)
    assert rid
    assert telemetry_lint.lint_ledger_file(led.record_path(rid)) == []
    (rec,) = led.query(kind="lockwatch")
    assert rec["cycle"] is False and ["A", "B"] in rec["edges"]
    assert rec["name"] == f"lockwatch:{os.getpid()}"


def test_series_points_lint(armed, monkeypatch):
    reg = tmetrics.Registry()
    monkeypatch.setattr(tlw, "_SAMPLE_EVERY_S", 0.0)
    with tmetrics.use(reg):
        _contended(tlw)
        _record_only(tlw)
    pts = reg.series("lockwatch").points
    assert {p["event"] for p in pts} >= {"acquire", "release", "cycle"}
    for p in pts:
        line = {"type": "sample", "series": "lockwatch", **p}
        assert telemetry_lint.lint_line(line, "w") == [], p


# ---------------------------------------------------------------------------
# the six sites
# ---------------------------------------------------------------------------

def _site_locks(tmp_path, monkeypatch):
    """The lock each of the six sites builds: {label: lock}."""
    out = {}
    svc = tservice.Service(str(tmp_path / "svc"), device="cpu", workers=1,
                           warm_ladder=False, slo_every_s=3600.0,
                           mesh_serving=False, heartbeat_every_s=0)
    out["service"] = svc._lock
    svc.close(timeout=5)
    wd = twatchdog.Watchdog()
    out["watchdog"] = wd._lock
    wd.stop()
    out["autopilot"] = tautopilot.Supervisor(tautopilot.Host())._lock
    out["observatory.cache"] = tobservatory.FederatedLedger(
        [str(tmp_path)])._cache_lock
    out["fleet.status"] = tfleet.RunStatus()._lock
    made = []
    real = tlw.lock

    def spy(label):
        lk = real(label)
        made.append((label, lk))
        return lk

    monkeypatch.setattr(tlw, "lock", spy)
    hists = [tsynth.cas_register_history(40, n_procs=3, seed=s)
             for s in (1, 2)]
    res = tbatched.check_streamed(cas_register(), hists,
                                  devices=["cpu", "cpu"])
    assert [r["valid?"] for r in res] == [True, True]
    monkeypatch.setattr(tlw, "lock", real)
    (out["batched.queue"],) = [lk for lab, lk in made
                               if lab == "batched.queue"]
    return out


def test_disabled_sites_hold_plain_locks(disarmed, isolated, tmp_path,
                                         monkeypatch):
    locks = _site_locks(tmp_path, monkeypatch)
    assert sorted(locks) == sorted(SITES)
    for label, lk in locks.items():
        want = PLAIN_RLOCK if SITES[label][1] else PLAIN_LOCK
        assert type(lk) is want, label
    assert tlw.events() == 0
    assert tlw.report()["locks"] == {}
    assert tlw.bank() is None


def test_armed_sites_are_witnessed_under_the_references_labels(
        armed, isolated, tmp_path, monkeypatch):
    locks = _site_locks(tmp_path, monkeypatch)
    for label, lk in locks.items():
        assert isinstance(lk, tlw.WatchedLock), label
        assert lk.label == label
        want = PLAIN_RLOCK if SITES[label][1] else PLAIN_LOCK
        assert type(lk._inner) is want
    seen = set(tlw.report()["locks"])
    assert {"service", "batched.queue"} <= seen, seen
    assert tlw.report()["cycle"] is False


def _factory_labels(root, rel):
    """Each `lockwatch.lock(...)` / `rlock(...)` call of a module, in
    source order: (factory, label)."""
    with open(os.path.join(root, rel)) as fh:
        tree = ast.parse(fh.read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and n.func.attr in ("lock", "rlock")
             and isinstance(n.func.value, ast.Name)
             and n.func.value.id == "lockwatch"]
    return [(c.func.attr, c.args[0].value)
            for c in sorted(calls, key=lambda c: c.lineno)]


@pytest.mark.parametrize("label", sorted(SITES))
def test_each_site_is_the_references_letter_for_letter(label):
    rel = SITES[label][0]
    want = _factory_labels(os.path.join(REPO, "jepsen_tpu"), rel)
    got = _factory_labels(os.path.join(REPO, "jepsen_tpu_torch"), rel)
    assert got == want
    assert label in [lab for _, lab in got]


def test_disabled_witness_counts_nothing_over_a_cpu_check(disarmed,
                                                          isolated,
                                                          tmp_path):
    svc = tservice.Service(str(tmp_path), device="cpu", workers=1,
                           warm_ladder=False, slo_every_s=3600.0,
                           mesh_serving=False, heartbeat_every_s=0)
    svc.start()
    try:
        h = tsynth.cas_register_history(60, n_procs=3, seed=3)
        rid = svc.submit({"model": "cas-register",
                          "history": [op.to_dict() for op in h]})["id"]
        info = _wait(svc, rid)
        assert info["verdict"] is True
        assert "lockwatch" not in svc.snapshot()
    finally:
        svc.close(timeout=10)
    assert tlw.events() == 0
    assert svc.ledger.query(kind="lockwatch") == []


def _wait(svc, rid, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        info = svc.get(rid)
        if info and info["state"] in ("done", "rejected"):
            return info
        time.sleep(0.02)
    raise AssertionError(f"run {rid} never finished")


def test_armed_service_snapshot_and_close(armed, isolated, tmp_path):
    svc = tservice.Service(str(tmp_path), device="cpu", workers=1,
                           warm_ladder=False, slo_every_s=3600.0,
                           mesh_serving=False, heartbeat_every_s=0)
    svc.start()
    try:
        h = tsynth.cas_register_history(60, n_procs=3, seed=3)
        rid = svc.submit({"model": "cas-register",
                          "history": [op.to_dict() for op in h]})["id"]
        assert _wait(svc, rid)["verdict"] is True
        block = svc.snapshot()["lockwatch"]
    finally:
        svc.close(timeout=10)
    assert set(block) == set(jlw.report())
    assert block["enabled"] is True and block["cycle"] is False
    assert "service" in block["locks"]
    assert set(block["locks"]["service"]) == {
        "acquires", "contended", "wait_p95_s", "wait_max_s",
        "hold_p95_s", "hold_max_s"}
    recs = svc.ledger.query(kind="lockwatch")
    assert len(recs) == 1 and recs[0]["cycle"] is False
    assert telemetry_lint.lint_ledger_file(
        svc.ledger.record_path(recs[0]["id"])) == []
    assert tlw.events() > 0


# ---------------------------------------------------------------------------
# the doctor's D016 on a real series
# ---------------------------------------------------------------------------

def _contend(lw, n, hold_s):
    """`n` acquires of one lock, each made while another thread holds
    it for `hold_s`: a real contended series."""
    lk = lw.lock("hot")
    for _ in range(n):
        held = threading.Event()

        def holder():
            with lk:
                held.set()
                time.sleep(hold_s)

        t = threading.Thread(target=holder)
        t.start()
        held.wait(5)
        with lk:
            pass
        t.join(5)


def test_d016_fires_on_a_real_contended_series(armed, monkeypatch):
    monkeypatch.setattr(tlw, "_SAMPLE_EVERY_S", 0.0)
    reg = tmetrics.Registry()
    with tmetrics.use(reg):
        _contend(tlw, 12, 0.02)
    pts = [p for p in reg.series("lockwatch").points
           if p["event"] == "acquire"]
    assert len(pts) >= tdoctor.LOCK_CONTENTION_MIN_POINTS
    got = tdoctor.diagnose(tdoctor.view_from_registry(reg))
    d016 = [f for f in got["findings"] if f["rule"] == "D016"]
    assert [f["subject"] for f in d016] == ["hot"]
    want = jdoctor.diagnose(jdoctor.TelemetryView(
        target="run", series={"lockwatch": reg.series("lockwatch").points}))
    assert [f for f in want["findings"] if f["rule"] == "D016"] == d016


def test_d016_silent_without_contention(armed, monkeypatch):
    monkeypatch.setattr(tlw, "_SAMPLE_EVERY_S", 0.0)
    reg = tmetrics.Registry()
    with tmetrics.use(reg):
        lk = tlw.lock("cold")
        for _ in range(20):
            with lk:
                pass
    assert not [p for p in reg.series("lockwatch").points
                if p["event"] == "acquire"]
    got = tdoctor.diagnose(tdoctor.view_from_registry(reg))
    assert "D016" not in {f["rule"] for f in got["findings"]}
