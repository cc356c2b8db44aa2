"""The port's chronos suite (`jepsen_tpu_torch/dbs/chronos.py`), held
against the JAX package: the twins of `tests/test_chronos.py` (the
target-window checker, the live mini scheduler firing real runs, missed
windows staying missed across kill -9, the full suite with the chronos
and set-full checkers), here over the port's `httpclient` in place of
`requests`, and parity cases: the embedded scheduler equal to the
reference's, the mini scheduler's commands through the dummy remote,
the generated jobs, the chronos and set-full checkers' results on the
same histories (valid, and with one missed target) equal to the
reference's, and the HTTP client's failures (a refused connection, a
timeout, a 500) classified as the reference's `requests`-based client
classifies them.

Also: the port's ports and store root are its own.
"""

import ast
import os
import signal
import subprocess
import sys
import time
from urllib.parse import urlsplit

import pytest

import jepsen_tpu.control as ref_c
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import chronos as ref_chr
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import chronos as chr_mod
from jepsen_tpu_torch.dbs import httpclient
from jepsen_tpu_torch.history import History, invoke, ok
from test_torch_httpclient import fault_url
from test_torch_sqlite import ephemeral_range

FIXTURE_PORT = 30940


# -- checker unit tests -------------------------------------------------------

def _job(name=1, start=100.0, count=3, interval=2.0, epsilon=0.4,
         duration=0.1):
    return {"name": name, "start": start, "count": count,
            "interval": interval, "epsilon": epsilon,
            "duration": duration}


def test_job_targets_cutoff():
    j = _job()
    ts = chr_mod.job_targets(103.1, j)
    assert [t[0] for t in ts] == [100.0, 102.0]
    ts = chr_mod.job_targets(102.0 + 0.4 + 0.5 + 0.1 - 0.01, j)
    assert [t[0] for t in ts] == [100.0]
    ts = chr_mod.job_targets(1000.0, j)
    assert len(ts) == 3


def test_job_solution_valid_and_missing():
    j = _job()
    runs = [{"name": 1, "start": 100.1, "end": 100.2},
            {"name": 1, "start": 102.3, "end": 102.4},
            {"name": 1, "start": 104.0, "end": 104.1}]
    s = chr_mod.job_solution(1000.0, j, runs)
    assert s["valid?"] is True and not s["missing-targets"]
    s = chr_mod.job_solution(1000.0, j, [runs[0], runs[2]])
    assert s["valid?"] is False
    assert [m[0] for m in s["missing-targets"]] == [102.0]


def test_job_solution_runs_are_distinct():
    j = _job(interval=0.5, epsilon=1.0, count=2)
    runs = [{"name": 1, "start": 100.5, "end": 100.6}]
    s = chr_mod.job_solution(1000.0, j, runs)
    assert s["valid?"] is False


def test_incomplete_runs_dont_count():
    j = _job(count=1)
    s = chr_mod.job_solution(
        1000.0, j, [{"name": 1, "start": 100.1, "end": None}])
    assert s["valid?"] is False and s["incomplete"] == 1


def test_checker_over_history():
    j = _job(count=1)
    h = History([
        invoke(0, "add-job", j), ok(0, "add-job", j),
        invoke(1, "read", None),
        ok(1, "read", {"runs": [{"name": 1, "start": 100.2,
                                 "end": 100.3}], "now": 1000.0}),
    ]).index()
    res = chr_mod.chronos_checker().check({}, h, {})
    assert res["valid?"] is True and res["job-count"] == 1
    h2 = History([
        invoke(0, "add-job", j), ok(0, "add-job", j),
        invoke(1, "read", None),
        ok(1, "read", {"runs": [], "now": 1000.0}),
    ]).index()
    res2 = chr_mod.chronos_checker().check({}, h2, {})
    assert res2["valid?"] is False


# -- live mini scheduler ------------------------------------------------------

@pytest.fixture()
def mini(tmp_path):
    srv_py = tmp_path / "minichronos.py"
    srv_py.write_text(chr_mod.MINICHRONOS_SRC)
    port = FIXTURE_PORT
    state = {"proc": None}

    def start():
        state["proc"] = subprocess.Popen(
            [sys.executable, str(srv_py), "--port", str(port),
             "--dir", str(tmp_path)], cwd=tmp_path)
        deadline = time.monotonic() + 10
        while True:
            try:
                httpclient.get(f"http://127.0.0.1:{port}/runs", timeout=1)
                return f"http://127.0.0.1:{port}"
            except httpclient.RequestException:
                assert time.monotonic() < deadline, "never up"
                time.sleep(0.1)

    yield start, state
    if state["proc"] is not None:
        state["proc"].kill()
        state["proc"].wait(timeout=10)


def test_mini_fires_scheduled_runs(mini):
    start, _ = mini
    url = start()
    job = {"name": 1, "start": time.time() + 0.3, "count": 2,
           "interval": 0.8, "epsilon": 0.4, "duration": 0.05}
    assert httpclient.post(f"{url}/jobs", json=job,
                           timeout=2).status_code == 200
    time.sleep(2.4)
    data = httpclient.get(f"{url}/runs", timeout=2).json()
    sol = chr_mod.job_solution(data["now"], job, [
        r for r in data["runs"] if str(r["name"]) == "1"])
    assert sol["valid?"] is True, (data, sol)


def test_mini_missed_windows_stay_missed(mini):
    """Jobs persist across kill -9 but windows missed while down are
    NOT resurrected — the checker reports them as missing."""
    start, state = mini
    url = start()
    job = {"name": 1, "start": time.time() + 0.3, "count": 3,
           "interval": 0.8, "epsilon": 0.3, "duration": 0.05}
    httpclient.post(f"{url}/jobs", json=job, timeout=2)
    time.sleep(0.7)  # let the first target fire
    state["proc"].send_signal(signal.SIGKILL)
    state["proc"].wait(timeout=10)
    time.sleep(1.2)  # at least one window passes while down
    url = start()
    time.sleep(1.6)  # let any remaining targets play out
    data = httpclient.get(f"{url}/runs", timeout=2).json()
    sol = chr_mod.job_solution(data["now"], job, data["runs"])
    assert sol["valid?"] is False
    assert sol["missing-targets"], sol


# -- full suite ---------------------------------------------------------------

def test_full_suite_live(tmp_path):
    opts = {"nodes": ["c1", "c2"], "concurrency": 4, "time_limit": 7,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster")}
    done = core.run(chr_mod.chronos_test(opts))
    res = done["results"]
    assert res["valid?"] is True, res
    assert res["chronos"]["valid?"] is True
    assert res["chronos"]["job-count"] > 0
    assert res["set"]["valid?"] is True


# -- parity with the reference ------------------------------------------------

def test_scheduler_src_is_the_references_and_imports_neither_package():
    assert chr_mod.MINICHRONOS_SRC == ref_chr.MINICHRONOS_SRC
    mods = set()
    for node in ast.walk(ast.parse(chr_mod.MINICHRONOS_SRC)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "http" in mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch",
                       "requests"}


def db_commands(ctl, remote_cls, mod) -> list:
    """The mini scheduler's lifecycle through the dummy remote, on ports
    named by the test map (each package's own base aside)."""
    test = {"nodes": ["c1", "c2"], "chronos_ports": {"c1": 5101, "c2": 5102}}
    log: list = []
    db = mod.MiniChronosDB()
    with ctl.with_remote(remote_cls(log)):
        for node in test["nodes"]:
            with ctl.on(node):
                db.setup(test, node)
                db.kill(test, node)
                db.start(test, node)
                db.teardown(test, node)
    return log


def test_db_commands_match_reference():
    log = db_commands(c, DummyRemote, chr_mod)
    assert log == db_commands(ref_c, RefDummyRemote, ref_chr)
    joined = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "minichronos.py --port 5102" in joined


def test_generated_jobs_match_reference(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    port, ref = chr_mod.add_job_gen(), ref_chr.add_job_gen()
    got = [port({}, None) for _ in range(12)]
    assert got == [ref({}, None) for _ in range(12)]
    assert [op["value"]["name"] for op in got] == list(range(1, 13))


def histories(missed: bool) -> tuple:
    """(port, reference) histories of two jobs read by two nodes; with
    `missed`, job 2's second target has no run."""
    jobs = [_job(name=1, count=2), _job(name=2, start=101.0, count=2)]
    runs_a = [{"name": "1", "start": 100.1, "end": 100.2},
              {"name": "2", "start": 101.2, "end": 101.3}]
    runs_b = [{"name": "1", "start": 102.2, "end": 102.3}]
    if not missed:
        runs_b.append({"name": "2", "start": 103.1, "end": 103.2})
    runs_b.append({"name": "2", "start": 105.0, "end": None})
    ops = []
    for i, j in enumerate(jobs):
        ops += [{"type": "invoke", "process": i, "f": "add-job",
                 "value": j, "time": i},
                {"type": "ok", "process": i, "f": "add-job", "value": j,
                 "time": 10 + i}]
    ops.append({"type": "invoke", "process": 2, "f": "add-job",
                "value": _job(name=3), "time": 12})
    ops.append({"type": "info", "process": 2, "f": "add-job",
                "value": _job(name=3), "time": 13})
    for p, runs, now in ((0, runs_a, 1000.0), (1, runs_b, 999.0)):
        ops += [{"type": "invoke", "process": p, "f": "read",
                 "value": None, "time": 20 + p},
                {"type": "ok", "process": p, "f": "read",
                 "value": {"runs": runs, "now": now}, "time": 30 + p}]
    ops += [{"type": "invoke", "process": 3, "f": "read", "value": None,
             "time": 40},
            {"type": "fail", "process": 3, "f": "read", "value": None,
             "time": 41}]
    return History(ops).index(), RefHistory(ops).index()


@pytest.mark.parametrize("missed", (False, True), ids=("valid", "missed"))
def test_checkers_match_reference(missed):
    port_h, ref_h = histories(missed)
    got = chr_mod.chronos_checker().check({}, port_h, {})
    assert got == ref_chr.chronos_checker().check({}, ref_h, {})
    assert got["valid?"] is (not missed)
    assert got["read-time"] == 999.0 and got["incomplete-count"] == 1
    got = chr_mod._SetViewChecker().check({}, port_h, {})
    assert got == ref_chr._SetViewChecker().check({}, ref_h, {})
    assert got["valid?"] is True


@pytest.mark.parametrize("fault", ("refused", "timeout", "http-500"))
def test_http_failures_classified_as_reference(fault):
    """The port's client (on `httpclient`) and the reference's (on
    `requests`) against the same fault: a failed read is :fail with an
    error, a failed add-job :info; a 500's error text is `requests`'
    own."""
    ops = [{"type": "invoke", "process": 0, "f": "add-job",
            "value": _job()},
           {"type": "invoke", "process": 0, "f": "read", "value": None}]
    with fault_url(fault) as base:
        addr = urlsplit(base)
        got = {}
        for name, mod in (("port", chr_mod), ("ref", ref_chr)):
            cl = mod.ChronosClient(
                port_fn=lambda test, node: (addr.hostname, addr.port),
                timeout=0.3).open({}, "c1")
            got[name] = [cl.invoke({}, op) for op in ops]
            cl.close({})
    assert [o["type"] for o in got["port"]] == ["info", "fail"]
    assert [o["type"] for o in got["ref"]] == ["info", "fail"]
    for p, r in zip(got["port"], got["ref"]):
        assert bool(p.get("error")) == bool(r.get("error"))
    assert got["port"][1]["error"]
    if fault == "http-500":
        assert [o.get("error") for o in got["port"]] == \
            [o.get("error") for o in got["ref"]]


def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert chr_mod.MINI_BASE_PORT == 30900
    assert chr_mod.MINI_BASE_PORT != ref_chr.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < chr_mod.MINI_BASE_PORT and chr_mod.MINI_BASE_PORT + 5 < lo
    assert chr_mod.MINI_BASE_PORT + 5 <= FIXTURE_PORT < lo
    test = {"nodes": ["c1", "c2"]}
    assert [chr_mod.mini_node_port(test, n) for n in test["nodes"]] == \
        [chr_mod.MINI_BASE_PORT, chr_mod.MINI_BASE_PORT + 1]
    t = chr_mod.chronos_test({"nodes": ["c1", "c2"], "concurrency": 2})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["client"].port_fn(t, "c2") == ("127.0.0.1",
                                            chr_mod.MINI_BASE_PORT + 1)
