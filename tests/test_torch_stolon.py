"""The port's stolon suite (`jepsen_tpu_torch/dbs/stolon.py`), on the
port's postgres and etcd, held against the JAX package: the twins of
`tests/test_stolon.py` (the ledger double-spend checker, the live mini
pgwire server: tags, transactional isolation, WAL durability across a
kill -9; both workloads live under the kill/restart nemesis, the
sentinel/keeper/proxy HA recipe through the dummy remote), and parity
cases: the embedded server's source, the `ha` recipe's commands, the SQL
the ledger and append clients send and what they answer, the generated ops
of each workload and attack (seeded), the ledger checker's results (valid,
and with one seeded double spend), and one live `append` history judged by
both packages' Elle.

Also: the port's ports and store root are its own, the `device` option
reaches the append check, and a missing card raises before any node is set
up. The suite checks on the CPU (`device="cpu"`).
"""

import itertools
import os
import subprocess
import sys
import time

import pytest
import torch

import jepsen_tpu.control as ref_c
from conftest import kill_and_wait
from jepsen_tpu import generator as ref_gen
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import stolon as ref_st
from jepsen_tpu.elle import append as ref_append
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import stolon as st
from jepsen_tpu_torch.dbs.postgres import PgConn
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, fail, info, invoke, ok
from test_torch_galera import (dummy_log, plain, ref_history, server_imports,
                               workload_ops)
from test_torch_postgres import PgScript
from test_torch_sqlite import ephemeral_range

#: the twin fixture's server port, inside stolon's block (31300-31349)
FIXTURE_PORT = 31340


# -- ledger checker -----------------------------------------------------------

def test_ledger_checker_double_spend():
    # +10 funded, two -9 withdrawals BOTH ok: -8 => double spend
    h = History([
        invoke(0, "transfer", [0, 10]), ok(0, "transfer", [0, 10]),
        invoke(1, "transfer", [0, -9]), ok(1, "transfer", [0, -9]),
        invoke(2, "transfer", [0, -9]), ok(2, "transfer", [0, -9]),
    ]).index()
    res = st.LedgerChecker().check({}, h, {})
    assert res["valid?"] is False
    assert res["overdrawn-accounts"] == {0: -8}


def test_ledger_checker_charitable():
    # indeterminate withdrawal assumed FAILED; indeterminate deposit
    # assumed SUCCEEDED (ledger.clj:143-150)
    h = History([
        invoke(0, "transfer", [0, 10]), info(0, "transfer", [0, 10]),
        invoke(1, "transfer", [0, -9]), info(1, "transfer", [0, -9]),
        invoke(2, "transfer", [0, -9]), ok(2, "transfer", [0, -9]),
    ]).index()
    res = st.LedgerChecker().check({}, h, {})
    assert res["valid?"] is True  # 10 - 9 = 1 >= 0
    assert res["nonzero-count"] == 1


def test_ledger_checker_failed_ops_ignored():
    h = History([
        invoke(0, "transfer", [3, -9]), fail(0, "transfer", [3, -9]),
    ]).index()
    res = st.LedgerChecker().check({}, h, {})
    assert res["valid?"] is True
    assert res["overdrawn-accounts"] == {}


# -- live mini pgwire server -------------------------------------------------

def start_minipg(path, port: int):
    """The embedded server on `port` in `path`: (its process, a
    connection to it)."""
    proc = subprocess.Popen(
        [sys.executable, str(path / "minipg.py"), "--port", str(port),
         "--dir", str(path)], cwd=path)
    deadline = time.monotonic() + 30
    while True:
        try:
            return proc, PgConn("127.0.0.1", port, timeout=2)
        except OSError:
            assert time.monotonic() < deadline, "never up"
            time.sleep(0.1)


@pytest.fixture()
def mini(tmp_path):
    (tmp_path / "minipg.py").write_text(st.MINIPG_SRC)
    proc, conn = start_minipg(tmp_path, FIXTURE_PORT)
    yield conn, FIXTURE_PORT, tmp_path
    conn.close()
    proc.kill()
    proc.wait(timeout=10)


def test_minipg_roundtrip_and_tags(mini):
    conn, _, _ = mini
    conn.query("CREATE TABLE t (a INTEGER PRIMARY KEY, b TEXT)")
    _, tag = conn.query("INSERT INTO t VALUES (1, 'x')")
    assert tag == "INSERT 0 1"
    rows, tag = conn.query("SELECT a, b FROM t")
    assert rows == [["1", "x"]] and tag == "SELECT 1"
    _, tag = conn.query("UPDATE t SET b = 'y' WHERE a = 1")
    assert tag == "UPDATE 1"
    _, tag = conn.query("UPDATE t SET b = 'z' WHERE a = 99")
    assert tag == "UPDATE 0"


def test_minipg_txn_isolation(mini):
    conn, port, _ = mini
    conn.query("CREATE TABLE d (id INTEGER PRIMARY KEY, x INTEGER)")
    conn.query("INSERT INTO d VALUES (0, -1)")
    conn.query("BEGIN ISOLATION LEVEL SERIALIZABLE")
    conn.query("UPDATE d SET x = 99")
    c2 = PgConn("127.0.0.1", port, timeout=2)
    rows, _ = c2.query("SELECT x FROM d")
    assert rows == [["-1"]]  # uncommitted update invisible
    conn.query("ROLLBACK")
    rows, _ = c2.query("SELECT x FROM d")
    assert rows == [["-1"]]
    c2.close()


def test_minipg_survives_kill(mini):
    """Committed rows survive kill -9 (WAL + synchronous=FULL)."""
    conn, port, path = mini
    conn.query("CREATE TABLE k (id INTEGER PRIMARY KEY)")
    conn.query("INSERT INTO k VALUES (42)")
    kill_and_wait("minipg.py", port)
    proc, c2 = start_minipg(path, port)
    try:
        rows, _ = c2.query("SELECT id FROM k")
        assert rows == [["42"]]
        c2.close()
    finally:
        proc.kill()
        proc.wait(timeout=10)


# -- full suites against LIVE mini servers -----------------------------------

def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["s1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.mark.parametrize("which", ["ledger", "append"])
@pytest.mark.slow  # the reference twin's mark (tests/test_stolon.py)
def test_full_suite_live(tmp_path, which):
    done = core.run(st.stolon_test(_options(tmp_path, which)))
    res = done["results"]
    assert res["valid?"] is True, res
    if which == "ledger":
        assert any(op.f == "transfer" for op in done["history"])


# -- HA automation (command assertions) --------------------------------------

def test_ha_commands():
    log: list = []
    db = st.StolonDB()
    test = {"nodes": ["n1", "n2"], "force_reinstall": True}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
    joined = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "postgresql-12" in joined
    assert "sorintlab/stolon" in st.tarball_url(st.VERSION)
    assert joined.count("stolonctl") == 1
    assert "synchronousReplication" in joined
    i_s = joined.index("stolon-sentinel")
    i_k = joined.index("stolon-keeper")
    i_p = joined.index("stolon-proxy")
    assert i_s < i_k < i_p
    assert "--uid pg0" in joined
    assert "--store-backend etcdv3" in joined
    assert f"--pg-port {st.KEEPER_PG_PORT}" in joined
    log.clear()
    with c.with_remote(DummyRemote(log)):
        with c.on("n2"):
            db.setup(test, "n2")
    joined2 = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "stolonctl" not in joined2


def test_store_endpoints():
    t = {"nodes": ["a", "b"]}
    assert st.store_endpoints(t) == "http://a:2379,http://b:2379"


# -- parity with the reference ------------------------------------------------

def test_server_src_is_the_references_and_imports_neither_package():
    assert st.MINIPG_SRC == ref_st.MINIPG_SRC
    mods = server_imports(st.MINIPG_SRC)
    assert {"socketserver", "sqlite3"} <= mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


def ha_steps(mod):
    db = mod.StolonDB()
    test = {"nodes": ["n1", "n2", "n3"], "force_reinstall": True}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in ("n1", "n3")
            for f in ("setup", "kill", "start", "teardown")], \
        db.log_files(test, "n1")


def test_ha_commands_match_reference():
    steps, files = ha_steps(st)
    ref_steps, ref_files = ha_steps(ref_st)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert files == ref_files
    assert st.cluster_spec() == ref_st.cluster_spec()
    assert st.tarball_url("0.17.0") == ref_st.tarball_url("0.17.0")
    for n in (1, 3, 5):
        test = {"nodes": [f"n{i}" for i in range(n)]}
        assert st.store_endpoints(test) == ref_st.store_endpoints(test)


def ledger_session(mod, script: dict) -> tuple:
    """The ledger client over a `PgScript`: its setup, a deposit and two
    withdrawals, its row ids counted from 1."""
    cl = mod.LedgerClient().open({}, "s1")
    cl._ids = itertools.count(1)
    conn = PgScript(mod, **script)
    cl.conn = conn
    cl.setup({})
    out = []
    for v in ([0, 10], [0, -9], [1, -3]):
        cl.conn = conn
        d = cl.invoke({}, {"type": "invoke", "process": 0, "f": "transfer",
                           "value": v})
        out.append((d["type"], d.get("error")))
    return conn.sent, out


@pytest.mark.parametrize("script", (
    dict(rows=[["10"]]), dict(rows=[["10"], ["-9"]]),
    dict(rows=[], fail_on="COMMIT")), ids=("funded", "spent", "down"))
def test_ledger_client_sql_matches_reference(script):
    got = ledger_session(st, script)
    assert got == ledger_session(ref_st, script)


def test_append_client_setup_matches_reference():
    sent = []
    for mod in (st, ref_st):
        cl = mod.StolonAppendClient().open({}, "s1")
        cl.conn = PgScript(mod, rows=[])
        cl.setup({})
        sent.append(cl.conn.sent)
    assert sent[0] == sent[1] == [
        "CREATE TABLE IF NOT EXISTS lists (k INTEGER PRIMARY KEY, v TEXT)"]


def attack_ops(mod, g_mod, tl, attack: str, n: int = 60) -> list:
    """The first `n` invocations of the ledger workload under `attack`,
    its generator seeded, every op completing ok at once."""
    g_mod.RNG.seed(25)
    w = mod.WORKLOADS["ledger"]({"attack": attack, "device": "cpu"})
    return [(o["process"], o["f"], o["value"]) for o in tl.simulate(
        g_mod.limit(n, w["generator"]), lambda ctx, inv: {**inv, "type": "ok"})
        if o["type"] == "invoke"]


@pytest.mark.parametrize("attack", ("double-spend", "rand"))
def test_ledger_ops_match_reference(attack):
    got = attack_ops(st, gen, testlib, attack)
    assert got == attack_ops(ref_st, ref_gen, ref_testlib, attack)
    assert {f for _, f, _ in got} == {"transfer"}


def test_append_ops_match_reference():
    got = workload_ops(st, gen, testlib, "append")
    assert got == workload_ops(ref_st, ref_gen, ref_testlib, "append")
    assert {f for _, f, _ in got} == {"txn"}


def ledger_history(spent: bool) -> list:
    ops = [invoke(0, "transfer", [0, 10]), ok(0, "transfer", [0, 10]),
           invoke(1, "transfer", [0, -9]), ok(1, "transfer", [0, -9]),
           invoke(2, "transfer", [0, -9]),
           (ok if spent else fail)(2, "transfer", [0, -9]),
           invoke(3, "transfer", [1, 10]), info(3, "transfer", [1, 10]),
           invoke(4, "transfer", [1, -3]), info(4, "transfer", [1, -3])]
    return ops


@pytest.mark.parametrize("spent", (False, True), ids=("valid", "double-spend"))
def test_ledger_checker_matches_reference(spent):
    ops = ledger_history(spent)
    got = st.LedgerChecker().check({}, History(ops).index(), {})
    want = ref_st.LedgerChecker().check({}, ref_history(ops), {})
    assert plain(got) == plain(want)
    assert got["valid?"] is (not spent)


@pytest.fixture(scope="module")
def append_run(tmp_path_factory):
    """A live append run (one mini node, 4 workers, 4 s, the kill/restart
    every 1.5 s), its generators seeded."""
    gen.RNG.seed(25)
    opts = _options(tmp_path_factory.mktemp("append"), "append",
                    time_limit=4, nemesis_interval=1.5)
    test = st.stolon_test(opts)
    w = st.WORKLOADS["append"](opts)
    w["generator"].rng.seed(25)
    test["generator"] = gen.time_limit(4, gen.nemesis(
        gen.cycle([gen.sleep(1.5), {"type": "info", "f": "start"},
                   gen.sleep(1.5), {"type": "info", "f": "stop"}]),
        w["generator"]))
    return test, core.run(test)


def test_live_append_history_matches_reference(append_run):
    """The live append history, judged by the suite's own checker (the
    port's, on the CPU) and by the reference's `elle.append.check` with
    the suite's anomalies and graphs: equal results, True."""
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
    assert any(o.process == "nemesis" and o.value == {"s1": "killed"}
               for o in hist)


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert st.MINI_BASE_PORT == 31300
    assert st.MINI_BASE_PORT != ref_st.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < st.MINI_BASE_PORT and st.MINI_BASE_PORT + 50 <= lo
    assert st.MINI_BASE_PORT + 5 <= FIXTURE_PORT < st.MINI_BASE_PORT + 50
    test = {"nodes": ["s1", "s2"]}
    assert [st.mini_node_port(test, n) for n in test["nodes"]] == \
        [st.MINI_BASE_PORT, st.MINI_BASE_PORT + 1]
    assert st.mini_node_port({**test, "stolon_ports": {"s2": 4000}},
                             "s2") == 4000
    t = st.stolon_test({"nodes": ["s1"], "concurrency": 2})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["db"].port(t, "s1") == st.MINI_BASE_PORT
    assert t["client"].addr_fn(t, "s1") == ("127.0.0.1", st.MINI_BASE_PORT)
    t = st.stolon_test({"nodes": ["s1"], "concurrency": 2, "server": "ha"})
    assert t["client"].addr_fn(t, "s1") == ("s1", st.PROXY_PORT)
    assert st.PROXY_PORT == ref_st.PROXY_PORT == 5432


def test_device_reaches_the_checker(tmp_path):
    t = st.stolon_test(_options(tmp_path, "append"))
    assert t["checker"].checker_map["append"].device == torch.device("cpu")


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "ha"):
        with pytest.raises(RuntimeError, match="CUDA"):
            st.stolon_test({**_options(tmp_path, "append"), "server": server,
                            "device": None})
    with pytest.raises(RuntimeError, match="CUDA"):
        list(st.stolon_tests({**_options(tmp_path, None), "device": None}))
    assert not (tmp_path / "cluster").exists()
    # the ledger's check takes no device: no card is needed
    t = st.stolon_test({**_options(tmp_path, "ledger"), "device": None})
    assert t["name"] == "stolon-ledger-mini"
