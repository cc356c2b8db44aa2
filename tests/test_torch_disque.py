"""The port's disque suite (`jepsen_tpu_torch/dbs/disque.py`), held
against the JAX package: the twins of `tests/test_disque.py` (the mini
job-queue server's RESP protocol, at-least-once redelivery, AOF crash
recovery, the full suite against live servers under kill -9, the
volatile-loss counterexample), and parity cases: the embedded server
equal to the reference's, the real-disque DB's commands through the
dummy remote, the generated ops, and `total_queue` on the same
histories (valid, and with one lost job) equal to the reference's.

Also: the port's ports and store root are its own.
"""

import ast
import os
import signal
import subprocess
import sys
import time

import pytest

import jepsen_tpu.control as ref_c
from jepsen_tpu import checker as ref_checker
from jepsen_tpu import generator as ref_gen
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import disque as ref_disque
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import checker as jchecker
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import disque
from jepsen_tpu_torch.dbs.redis import RedisConn
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, invoke, ok
from test_torch_sqlite import ephemeral_range

FIXTURE_PORT = 30990


@pytest.fixture()
def mini(tmp_path):
    srv_py = tmp_path / "minidisque.py"
    srv_py.write_text(disque.MINIDISQUE_SRC)
    port = FIXTURE_PORT
    state = {"proc": None}

    def start(*extra):
        state["proc"] = subprocess.Popen(
            [sys.executable, str(srv_py), "--port", str(port),
             "--dir", str(tmp_path), "--retry-ms", "500", *extra],
            cwd=tmp_path)
        deadline = time.monotonic() + 10
        while True:
            try:
                return RedisConn("127.0.0.1", port, timeout=2)
            except OSError:
                assert time.monotonic() < deadline, "server never up"
                time.sleep(0.1)

    yield start, state, port
    if state["proc"] is not None:
        state["proc"].kill()
        state["proc"].wait(timeout=10)


# -- the twins of tests/test_disque.py ----------------------------------------

def test_add_get_ack_cycle(mini):
    start, state, _port = mini
    conn = start()
    jid = conn.cmd("ADDJOB", "jepsen", "7", "100")
    assert jid.startswith("D-")
    q, jid2, body = conn.cmd("GETJOB", "NOHANG", "FROM", "jepsen")[0]
    assert (q, jid2, body) == ("jepsen", jid, "7")
    assert conn.cmd("ACKJOB", jid) == 1
    # acked: gone for good
    assert conn.cmd("GETJOB", "NOHANG", "FROM", "jepsen") is None
    conn.close()


def test_unacked_job_redelivers(mini):
    start, state, _port = mini
    conn = start()
    conn.cmd("ADDJOB", "jepsen", "42", "100")
    assert conn.cmd("GETJOB", "NOHANG", "FROM", "jepsen")[0][2] == "42"
    # not acked: invisible during the retry window, then redelivered
    assert conn.cmd("GETJOB", "NOHANG", "FROM", "jepsen") is None
    time.sleep(0.7)
    assert conn.cmd("GETJOB", "NOHANG", "FROM", "jepsen")[0][2] == "42"
    conn.close()


def test_aof_survives_kill(mini):
    start, state, port = mini
    conn = start()
    conn.cmd("ADDJOB", "jepsen", "1", "100")
    conn.cmd("ADDJOB", "jepsen", "2", "100")
    got = conn.cmd("GETJOB", "NOHANG", "FROM", "jepsen")[0]
    conn.cmd("ACKJOB", got[1])
    conn.close()
    state["proc"].send_signal(signal.SIGKILL)
    state["proc"].wait(timeout=10)
    conn = start()
    bodies = set()
    while True:
        res = conn.cmd("GETJOB", "NOHANG", "FROM", "jepsen")
        if res is None:
            break
        bodies.add(res[0][2])
        conn.cmd("ACKJOB", res[0][1])
    assert bodies == {"2"} or bodies == {"1"}
    # exactly the un-acked body survives: it is the one NOT acked above
    assert bodies == ({"1"} if got[2] == "2" else {"2"})
    conn.close()


def _options(tmp_path, **kw):
    return {"nodes": kw.pop("nodes", ["q1", "q2"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 6),
            "nemesis_interval": kw.pop("nemesis_interval", 2.0),
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), **kw}


def test_full_suite_live_mini(tmp_path):
    """enqueue/dequeue under kill -9, recover, drain: nothing lost,
    nothing unexpected (total-queue), against live subprocesses."""
    done = core.run(disque.disque_test(_options(tmp_path)))
    q = done["results"]["queue"]
    assert done["results"]["valid?"] is True, q
    assert q["valid?"] is True
    assert q["attempt-count"] > 0
    assert q["lost-count"] == 0 and q["unexpected-count"] == 0


def test_volatile_loses_jobs(mini, tmp_path):
    """--volatile drops the AOF: kill -9 while acknowledged enqueues are
    outstanding forgets them, and total-queue catches the loss."""
    start, state, _port = mini
    conn = start("--volatile")
    hist = []
    for i in range(5):
        hist.append(invoke(0, "enqueue", i))
        conn.cmd("ADDJOB", "jepsen", str(i), "100")
        hist.append(ok(0, "enqueue", i))
    conn.close()
    state["proc"].send_signal(signal.SIGKILL)
    state["proc"].wait(timeout=10)
    conn = start("--volatile")
    drained = []
    while True:
        res = conn.cmd("GETJOB", "NOHANG", "FROM", "jepsen")
        if res is None:
            break
        drained.append(int(res[0][2]))
        conn.cmd("ACKJOB", res[0][1])
    conn.close()
    hist.append(invoke(1, "drain", None))
    hist.append(ok(1, "drain", drained))
    res = jchecker.total_queue().check({}, History(hist).index(), {})
    assert drained == []  # the volatile server forgot everything
    assert res["valid?"] is False
    assert res["lost-count"] == 5


# -- parity with the reference ------------------------------------------------

def test_server_src_is_the_references_and_imports_neither_package():
    assert disque.MINIDISQUE_SRC == ref_disque.MINIDISQUE_SRC
    mods = set()
    for node in ast.walk(ast.parse(disque.MINIDISQUE_SRC)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "socketserver" in mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


def db_commands(ctl, remote_cls, mod) -> tuple:
    test = {"nodes": ["n1", "n2"]}
    log: list = []
    db = mod.DisqueDB()
    with ctl.with_remote(remote_cls(log)):
        with ctl.on("n1"):
            db.setup(test, "n1")
            db.kill(test, "n1")
            db.start(test, "n1")
            db.teardown(test, "n1")
    return log, db.log_files(test, "n1")


def test_db_commands_match_reference():
    log, files = db_commands(c, DummyRemote, disque)
    ref_log, ref_files = db_commands(ref_c, RefDummyRemote, ref_disque)
    assert log == ref_log and files == ref_files
    joined = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "git clone" in joined and disque.GIT_SHA in joined
    assert "disque-server" in joined


def generated(mod, g_mod, tl, n: int = 40) -> list:
    """The first `n` ops of the suite's generator, every op completing
    at once, under a seeded RNG."""
    g_mod.RNG.seed(11)
    return [(o["f"], o["value"]) for o in
            tl.quick(g_mod.limit(n, g_mod.clients(mod.queue_gen())))]


def test_generated_ops_match_reference():
    got = generated(disque, gen, testlib)
    assert got == generated(ref_disque, ref_gen, ref_testlib)
    assert len(got) == 40
    assert {f for f, _ in got} == {"enqueue", "dequeue"}


QUEUE_HIST = [
    ("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
    ("invoke", 1, "enqueue", 2), ("info", 1, "enqueue", 2),
    ("invoke", 0, "dequeue", None), ("ok", 0, "dequeue", 1),
    ("invoke", 2, "enqueue", 3), ("ok", 2, "enqueue", 3),
    ("invoke", 0, "dequeue", None), ("fail", 0, "dequeue", None),
    ("invoke", 3, "drain", None),
]


@pytest.mark.parametrize("drained,valid", (([3, 2], True), ([2], False),
                                           ([3, 3], True), ([3, 9], True)),
                         ids=("valid", "lost", "duplicated", "unexpected"))
def test_total_queue_matches_reference(drained, valid):
    ops = [{"type": t, "process": p, "f": f, "value": v}
           for t, p, f, v in QUEUE_HIST]
    ops.append({"type": "ok", "process": 3, "f": "drain", "value": drained})
    got = jchecker.total_queue().check({}, History(ops).index(), {})
    want = ref_checker.total_queue().check({}, RefHistory(ops).index(), {})
    assert got == want
    if drained == [3, 9]:
        assert got["valid?"] is False and got["unexpected-count"] == 1
    else:
        assert got["valid?"] is valid


def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert disque.MINI_BASE_PORT == 30950
    assert disque.MINI_BASE_PORT != ref_disque.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < disque.MINI_BASE_PORT and disque.MINI_BASE_PORT + 5 < lo
    assert disque.MINI_BASE_PORT + 5 <= FIXTURE_PORT < lo
    test = {"nodes": ["q1", "q2"]}
    assert [disque.mini_node_port(test, n) for n in test["nodes"]] == \
        [disque.MINI_BASE_PORT, disque.MINI_BASE_PORT + 1]
    t = disque.disque_test({"nodes": ["q1", "q2"], "concurrency": 2})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["client"].port_fn(t, "q2") == ("127.0.0.1",
                                            disque.MINI_BASE_PORT + 1)
