"""The port's sqlite suite (`jepsen_tpu_torch/dbs/sqlite.py`), held
against the JAX package: the twins of `tests/test_sqlite.py` (real ACID
transactions behind the live minisql server: serializability under
elle's eye, conserved bank totals, WAL commits surviving kill -9, and
the test-all sweep), and one live `append` history judged by the port's
checker and by the reference's `elle.append.check`, with equal results.

Also: the embedded server is the reference's and imports neither
package, the port's ports and store root are its own, the `device`
option reaches the append / wr checkers, and a missing card raises
before any node is set up. The suites check on the CPU
(`device="cpu"`).
"""

import ast
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from jepsen_tpu.dbs import sqlite as ref_sq
from jepsen_tpu.elle import append as ref_append
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu_torch import core
from jepsen_tpu_torch.dbs import sqlite as sq
from jepsen_tpu_torch.dbs.redis import RedisConn


@pytest.fixture()
def mini(tmp_path):
    srv_py = tmp_path / "minisql.py"
    srv_py.write_text(sq.MINISQL_SRC)
    port = 32290
    state = {"proc": None}

    def start(*extra):
        state["proc"] = subprocess.Popen(
            [sys.executable, str(srv_py), "--port", str(port),
             "--db", str(tmp_path / "t.db"), *extra], cwd=tmp_path)
        deadline = time.monotonic() + 10
        while True:
            try:
                return RedisConn("127.0.0.1", port, timeout=2)
            except OSError:
                assert time.monotonic() < deadline, "server never up"
                time.sleep(0.1)

    yield start, state
    if state["proc"] is not None:
        state["proc"].kill()
        state["proc"].wait(timeout=10)


def test_txn_atomicity_and_reads(mini):
    start, _state = mini
    conn = start()
    done = json.loads(conn.cmd("TXN", json.dumps(
        [["append", 1, 10], ["w", 2, 5], ["r", 1, None],
         ["r", 2, None]])))
    assert done == [["append", 1, 10], ["w", 2, 5], ["r", 1, [10]],
                    ["r", 2, 5]]
    conn.close()


def test_wal_commit_survives_kill(mini):
    start, state = mini
    conn = start()
    conn.cmd("TXN", json.dumps([["append", 7, 1], ["append", 7, 2]]))
    conn.close()
    state["proc"].send_signal(signal.SIGKILL)
    state["proc"].wait(timeout=10)
    conn = start()
    done = json.loads(conn.cmd("TXN", json.dumps([["r", 7, None]])))
    assert done == [["r", 7, [1, 2]]]
    conn.close()


def test_bank_xfer_guards_balance(mini):
    start, _state = mini
    conn = start()
    conn.cmd("BANKINIT", json.dumps({"0": 10, "1": 0}))
    assert conn.cmd("XFER", "0", "1", "4") == 1
    assert conn.cmd("XFER", "0", "1", "100") == 0  # insufficient
    assert json.loads(conn.cmd("BANKREAD")) == {"0": 6, "1": 4}
    conn.close()


def _options(tmp_path, **kw):
    return {"nodes": ["p1"], "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 6),
            "nemesis_interval": kw.pop("nemesis_interval", 2.0),
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.fixture(scope="module")
def append_run(tmp_path_factory):
    """One live append run (the generator seeded): its test map and
    what `core.run` returned."""
    from jepsen_tpu_torch import generator as gen
    gen.RNG.seed(21)
    test = sq.sqlite_test(_options(tmp_path_factory.mktemp("append"),
                                   workload="append"))
    return test, core.run(test)


def test_append_suite_live(append_run):
    """elle list-append over real sqlite txns under primary kill -9:
    serializable engine + WAL -> zero anomalies, or the harness lies."""
    _, done = append_run
    assert done["results"]["valid?"] is True, done["results"]["append"]
    assert done["results"]["append"]["valid?"] is True
    assert done["results"]["append"]["anomaly-types"] == []


def test_bank_suite_live(tmp_path):
    done = core.run(sq.sqlite_test(_options(tmp_path,
                                            workload="bank")))
    assert done["results"]["valid?"] is True, done["results"]["bank"]


def test_wr_suite_live(tmp_path):
    done = core.run(sq.sqlite_test(_options(tmp_path, workload="wr")))
    assert done["results"]["valid?"] is True, done["results"]["wr"]


def test_tests_fn_sweeps_workloads(tmp_path):
    names = [t["name"] for t in sq.sqlite_tests(_options(tmp_path))]
    assert names == ["sqlite-append", "sqlite-bank", "sqlite-wr"]


# -- parity and the port's own choices ---------------------------------------

def test_live_append_history_matches_reference(append_run):
    """The live append history, judged by the suite's own checker (the
    port's, on the CPU) and by the reference's `elle.append.check` with
    the suite's anomalies and graphs: equal results."""
    test, done = append_run
    hist = done["history"]
    chk = test["checker"].checker_map["append"]
    port = done["results"]["append"]
    ref = ref_append.check(
        RefHistory([RefOp.from_dict(o.to_dict()) for o in hist]),
        anomalies=chk.anomalies, additional_graphs=chk.additional_graphs)
    keys = ("valid?", "anomaly-types", "anomalies", "not")
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["valid?"] is True
    assert sum(1 for o in hist if o.is_ok and o.f == "txn") > 10


def test_server_src_is_the_references_and_imports_neither_package():
    assert sq.MINISQL_SRC == ref_sq.MINISQL_SRC
    mods = set()
    for node in ast.walk(ast.parse(sq.MINISQL_SRC)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "sqlite3" in mods and not mods & {"jepsen_tpu",
                                             "jepsen_tpu_torch", "jax",
                                             "torch"}


def ephemeral_range() -> tuple:
    """Linux's range of ephemeral ports (the default where unreadable)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            lo, hi = fh.read().split()
        return int(lo), int(hi)
    except OSError:
        return 32768, 60999


def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert sq.MINI_BASE_PORT == 32100
    assert sq.MINI_BASE_PORT != ref_sq.MINI_BASE_PORT
    # below the ephemeral range: a client retrying a down server's port
    # there can connect to itself, read its own command back as the reply
    # and hold the port, so the restarted server cannot bind it
    lo, _ = ephemeral_range()
    assert sq.MINI_BASE_PORT + 8 < lo
    test = {"nodes": ["p1", "p2"]}
    assert [sq.node_port(test, n) for n in test["nodes"]] == \
        [sq.MINI_BASE_PORT, sq.MINI_BASE_PORT + 1]
    assert sq.node_port({**test, "sqlite_ports": {"p2": 4000}}, "p2") == 4000
    t = sq.sqlite_test({"nodes": ["p1"], "concurrency": 2,
                        "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")


@pytest.mark.parametrize("which", ["append", "wr"])
def test_device_reaches_the_elle_checkers(tmp_path, which):
    t = sq.sqlite_test(_options(tmp_path, workload=which))
    assert t["checker"].checker_map[which].device == torch.device("cpu")


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for which in ("append", "wr", "bank"):
        with pytest.raises(RuntimeError, match="CUDA"):
            sq.sqlite_test({**_options(tmp_path, workload=which),
                            "device": None})
    assert not (tmp_path / "cluster").exists()
