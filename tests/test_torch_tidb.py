"""The port's tidb suite (`jepsen_tpu_torch/dbs/tidb.py`), on the port's
galera, held against the JAX package: the twins of `tests/test_tidb.py`
(the option-axis combinatorics, the dialect bridge the mini server adds
for TiDB's SQL, the TableChecker, five workloads live under the
kill/restart nemesis, the pd/tikv/tidb automation through the dummy
remote), and parity cases: the test-all matrix under every `combos`
selection, the bridge's `translate` output on TiDB's statements, the
tarball commands and PD strings, the SQL each of the eleven clients sends
and what it answers, the generated ops of every workload, the
TableChecker's and the register check's results (valid, and with one
seeded anomaly each), and one live `append` history judged by both
packages' Elle.

Also: the port's ports and store root are its own, the `device` option
reaches the register, append and txn-cycle checks, and a missing card
raises before any node is set up. The suites check on the CPU
(`device="cpu"`).
"""

import os

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import galera as ref_ga
from jepsen_tpu.dbs import tidb as ref_ti
from jepsen_tpu.elle import append as ref_append
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import galera as ga
from jepsen_tpu_torch.dbs import tidb as ti
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, fail, invoke, ok
from jepsen_tpu_torch.independent import tuple_
from test_torch_galera import (SqlConn, dummy_log, mini_server, plain,
                               ref_history, translate_of, workload_ops)
from test_torch_mongodb import register_history
from test_torch_sqlite import ephemeral_range

#: the twin fixture's server port, inside tidb's block (31250-31299)
FIXTURE_PORT = 31290


# -- option-axis combinatorics (core.clj:111-151) -----------------------------

def test_all_combos():
    assert ti.all_combos({}) == [{}]
    combos = ti.all_combos({"a": [1, 2], "b": [True, False]})
    assert len(combos) == 4
    assert {"a": 1, "b": True} in combos
    assert len({tuple(sorted(c.items())) for c in combos}) == 4
    # the reference's append axes: 2*2*2 = 8
    assert len(ti.all_combos(ti.WORKLOAD_OPTIONS["append"])) == 8
    # register: 2*2*2*2 = 16
    assert len(ti.all_combos(ti.WORKLOAD_OPTIONS["register"])) == 16
    assert ti.all_combos(ti.WORKLOAD_OPTIONS["table"]) == [{}]


def test_expected_to_pass_pins_retry_off():
    table = ti.expected_to_pass(ti.WORKLOAD_OPTIONS)
    for w, opts in table.items():
        assert opts["auto_retry"] == [False]
        assert opts["auto_retry_limit"] == [0]
    # other axes survive
    assert table["register"]["read_lock"] == [None, "FOR UPDATE"]


def test_quick_options_shape():
    q = ti.quick_workload_options(ti.WORKLOAD_OPTIONS)
    # redundant workloads dropped (core.clj:145-151)
    for dropped in ("bank", "long-fork", "monotonic", "sequential",
                    "table"):
        assert dropped not in q
    assert "append" in q and "bank-multitable" in q
    # retry axes -> defaults, read locks off
    assert q["append"]["auto_retry"] == ["default"]
    assert q["append"]["read_lock"] == [None]
    # use-index kept only where true
    assert q.get("register", {}).get("use_index") == [True]


def test_tidb_tests_matrix(tmp_path):
    opts = {"nodes": ["n1"], "concurrency": 2, "combos": "quick",
            "store_root": str(tmp_path / "s"),
            "sandbox": str(tmp_path / "c"), "device": "cpu"}
    tests = list(ti.tidb_tests(opts))
    names = [t["name"] for t in tests]
    assert len(names) == len(set(names)), "duplicate test names"
    # quick keeps 6 workloads; register expands use_index=True only
    assert any("register" in n for n in names)
    assert not any("long-fork" in n for n in names)
    # explicit workload + combos=all expands every axis product
    all_reg = list(ti.tidb_tests({**opts, "workload": "register",
                                  "combos": "all"}))
    assert len(all_reg) == 16


# -- the dialect bridge (mini server translate) -------------------------------

@pytest.fixture()
def mini(tmp_path):
    with mini_server(tmp_path, FIXTURE_PORT) as (start, _):
        conn = start()
        try:
            yield conn, FIXTURE_PORT
        finally:
            conn.close()


def test_on_duplicate_key_update_bridge(mini):
    conn, _ = mini
    conn.query("CREATE TABLE test (id INT NOT NULL PRIMARY KEY, "
               "sk INT, val INT)")
    conn.query("INSERT INTO test (id, sk, val) VALUES (1, 1, 10) "
               "ON DUPLICATE KEY UPDATE val = 10")
    conn.query("INSERT INTO test (id, sk, val) VALUES (1, 1, 20) "
               "ON DUPLICATE KEY UPDATE val = 20")
    rows, _ = conn.query("SELECT val FROM test WHERE id = 1")
    assert rows == [["20"]]


def test_for_update_bridge(mini):
    conn, _ = mini
    conn.query("CREATE TABLE t2 (id INT PRIMARY KEY, v INT)")
    conn.query("INSERT INTO t2 VALUES (1, 7)")
    rows, _ = conn.query("SELECT v FROM t2 WHERE id = 1 FOR UPDATE")
    assert rows == [["7"]]


def test_session_axes_accepted(mini):
    conn, _ = mini
    conn.query("SET @@tidb_disable_txn_auto_retry = 1")
    conn.query("SET @@tidb_retry_limit = 0")
    rows, _ = conn.query("SELECT 1")
    assert rows == [["1"]]


# -- table-workload checker ---------------------------------------------------

def test_table_checker():
    h = History([
        invoke(0, "insert", [1, 0]),
        fail(0, "insert", [1, 0], error="doesn't-exist"),
    ]).index()
    res = ti.TableChecker().check({}, h, {})
    assert res["valid?"] is False and res["errors"]
    h2 = History([
        invoke(0, "insert", [1, 0]),
        fail(0, "insert", [1, 0], error="duplicate-key"),
        invoke(1, "create-table", 2), ok(1, "create-table", 2),
    ]).index()
    assert ti.TableChecker().check({}, h2, {})["valid?"] is True


# -- full suites against LIVE mini servers ------------------------------------

def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["t1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.mark.parametrize("which,axes", [
    ("register", {"use_index": True, "read_lock": "FOR UPDATE"}),
    ("append", {}),
    ("set-cas", {"read_lock": "FOR UPDATE"}),
    ("table", {}),
    ("bank-multitable", {"update_in_place": False}),
])
@pytest.mark.slow  # the reference twin's mark (tests/test_tidb.py)
def test_full_suite_live(tmp_path, which, axes):
    done = core.run(ti.tidb_test(_options(tmp_path, which, **axes)))
    res = done["results"]
    assert res["valid?"] is True, res


# -- real-cluster automation (tarball mode) -----------------------------------

def test_tarball_commands():
    log: list = []
    db = ti.TidbDB()
    test = {"nodes": ["n1", "n2", "n3"], "force_reinstall": True}
    with c.with_remote(DummyRemote(log)):
        with c.on("n2"):
            db.setup(test, "n2")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    # install via (cached) archive fetch into /opt/tidb
    assert "/opt/tidb" in joined
    assert "download.pingcap.org" in ti.tarball_url(ti.VERSION)
    # dependency order: pd before tikv before tidb
    i_pd = joined.index("pd-server")
    i_kv = joined.index("tikv-server")
    i_db = joined.index("tidb-server")
    assert i_pd < i_kv < i_db
    assert "--initial-cluster" in joined
    assert "pd1=http://n1:2380" in joined
    assert "pd2=http://n2:2380" in joined
    assert "--store tikv" in joined or "--store" in joined
    # kill runs in reverse dependency order
    log.clear()
    with c.with_remote(DummyRemote(log)):
        with c.on("n2"):
            db.kill(test, "n2")
    kcmds = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert kcmds.index("tidb-server") < kcmds.index("tikv-server") \
        < kcmds.index("pd-server")


def test_pd_cluster_strings():
    test = {"nodes": ["a", "b"]}
    assert ti.pd_name(test, "a") == "pd1"
    assert ti.pd_initial_cluster(test) == \
        "pd1=http://a:2380,pd2=http://b:2380"
    assert ti.pd_endpoints(test) == "a:2379,b:2379"


# -- parity with the reference ------------------------------------------------

AXES = ("auto_retry", "auto_retry_limit", "read_lock", "use_index",
        "update_in_place")


def matrix(mod, opts) -> list:
    """Each test map of `tidb_tests(opts)` as plain data: its name,
    workload axes, client, nemesis and checkers."""
    return [(t["name"], {k: t[k] for k in AXES if k in t},
             type(t["client"]).__name__, type(t["nemesis"]).__name__,
             sorted(t["checker"].checker_map), t["concurrency"],
             type(t["db"]).__name__)
            for t in mod.tidb_tests(opts)]


@pytest.mark.parametrize("combos", ("quick", "expected", "all", "none"))
@pytest.mark.parametrize("workload", (None, "register", "bank"))
def test_test_all_matrix_matches_reference(tmp_path, combos, workload):
    opts = {"nodes": ["n1", "n2"], "concurrency": 4, "combos": combos,
            "store_root": str(tmp_path / "s"),
            "sandbox": str(tmp_path / "c"), "device": "cpu"}
    if workload:
        opts["workload"] = workload
    got = matrix(ti, opts)
    assert got == matrix(ref_ti, opts)
    assert len(got) == len({g[0] for g in got}) > 0
    for nem in ("kill,pause", "partition,none"):
        n_opts = {**opts, "nemesis": nem, "workload": "append"}
        assert matrix(ti, n_opts) == matrix(ref_ti, n_opts)


def test_option_tables_match_reference():
    assert ti.WORKLOAD_OPTIONS == ref_ti.WORKLOAD_OPTIONS
    assert sorted(ti.WORKLOADS) == sorted(ref_ti.WORKLOADS)
    assert sorted(ti.NEMESES) == sorted(ref_ti.NEMESES)
    for fn in ("expected_to_pass", "quick_workload_options"):
        assert getattr(ti, fn)(ti.WORKLOAD_OPTIONS) == \
            getattr(ref_ti, fn)(ref_ti.WORKLOAD_OPTIONS)
    for w, o in ti.WORKLOAD_OPTIONS.items():
        assert ti.all_combos(o) == ref_ti.all_combos(o)


TIDB_SQL = (
    "CREATE TABLE IF NOT EXISTS test (id INT NOT NULL PRIMARY KEY, sk INT, "
    "val INT)",
    "SELECT val FROM test WHERE sk = 3 FOR UPDATE",
    "INSERT INTO test (id, sk, val) VALUES (3, 3, 4) ON DUPLICATE KEY "
    "UPDATE val = 4",
    "INSERT INTO txn (id, sk, val) VALUES (1, 1, '5,6') ON DUPLICATE KEY "
    "UPDATE val = '5,6'",
    "CREATE TABLE IF NOT EXISTS sets (id INTEGER PRIMARY KEY "
    "AUTO_INCREMENT, value BIGINT NOT NULL)",
    "SELECT value FROM csets WHERE id = 0 FOR UPDATE",
    "SELECT id, balance FROM accounts FOR UPDATE",
    "REPLACE INTO seq VALUES ('0_1', 1)",
)


def test_translate_on_tidb_sql_matches_reference():
    port, ref = translate_of(ga.MINIMYSQL_SRC), \
        translate_of(ref_ga.MINIMYSQL_SRC)
    got = [port(s) for s in TIDB_SQL]
    assert got == [ref(s) for s in TIDB_SQL]
    assert got[2].endswith("ON CONFLICT(id) DO UPDATE SET val = 4")
    assert "FOR UPDATE" not in got[1] + got[5] + got[6]


def test_tarball_commands_match_reference():
    def steps(mod):
        db = mod.TidbDB()
        test = {"nodes": ["n1", "n2", "n3"], "force_reinstall": True}
        return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
                for n in ("n1", "n3")
                for f in ("setup", "pause", "resume", "kill", "start",
                          "teardown")], db.log_files(test, "n1")

    got, files = steps(ti)
    want, ref_files = steps(ref_ti)
    assert dummy_log(c, DummyRemote, got) == \
        dummy_log(ref_c, RefDummyRemote, want)
    assert files == ref_files
    for n in (1, 2, 5):
        test = {"nodes": [f"n{i}" for i in range(1, n + 1)]}
        for fn in ("pd_initial_cluster", "pd_endpoints"):
            assert getattr(ti, fn)(test) == getattr(ref_ti, fn)(test)
        assert [ti.pd_name(test, x) for x in test["nodes"]] == \
            [ref_ti.pd_name(test, x) for x in test["nodes"]]
    assert ti.tarball_url(ti.VERSION) == ref_ti.tarball_url(ref_ti.VERSION)


def kv(mod, k, v):
    return (tuple_ if mod is ti else ref_independent.tuple_)(k, v)


def sessions():
    """(client class name, test axes, connection script, ops): every
    client of the suite, with its option axes."""
    reg = lambda mod: [  # noqa: E731
        {"f": "read", "value": kv(mod, 3, None)},
        {"f": "write", "value": kv(mod, 3, 4)},
        {"f": "cas", "value": kv(mod, 3, [4, 5])},
        {"f": "cas", "value": kv(mod, 3, [9, 5])}]
    txn = [{"f": "txn", "value": [["r", 1, None], ["append", 1, 5],
                                  ["w", 2, 6], ["append", 2, 7]]}]
    bank = [{"f": "read", "value": None},
            {"f": "transfer", "value": {"from": 0, "to": 1, "amount": 2}},
            {"f": "transfer", "value": {"from": 1, "to": 0, "amount": 9}}]
    return [
        ("TidbRegisterClient", {}, dict(rows=[["4"]]), reg),
        ("TidbRegisterClient", {"use_index": True,
                                "read_lock": "FOR UPDATE"},
         dict(rows=[]), reg),
        ("TidbRegisterClient", {}, dict(rows=[["4"]], fail_on="UPDATE",
                                        msg="Write conflict"), reg),
        ("TidbAppendClient", {}, dict(rows=[["1,2"]]), lambda m: txn),
        ("TidbAppendClient", {"read_lock": "FOR UPDATE"}, dict(rows=[]),
         lambda m: txn),
        ("TidbWrClient", {"use_index": True}, dict(rows=[["8"]]),
         lambda m: [{"f": "txn", "value": [["r", 1, None], ["w", 1, 5]]}]),
        ("TidbWrClient", {}, dict(rows=[["8"]], fail_on="INSERT",
                                  msg="database is locked"),
         lambda m: [{"f": "txn", "value": [["w", 1, 5]]}]),
        ("TidbBankClient", {"update_in_place": True},
         dict(rows=[["0", "10"], ["1", "5"]]), lambda m: bank),
        ("TidbBankClient", {"read_lock": "FOR UPDATE"},
         dict(rows=[["7", "3"]]), lambda m: bank),
        ("TidbMultiBankClient", {"update_in_place": False},
         dict(rows=[["6"]]), lambda m: bank),
        ("TidbMultiBankClient", {"update_in_place": True},
         dict(rows=[["1"]]), lambda m: bank),
        ("TidbSetClient", {}, dict(rows=[["3"], ["1"]]),
         lambda m: [{"f": "add", "value": 7}, {"f": "read", "value": None}]),
        ("TidbCasSetClient", {"read_lock": "FOR UPDATE"},
         dict(rows=[["1,2"]]),
         lambda m: [{"f": "add", "value": 7}, {"f": "read", "value": None}]),
        ("TidbCasSetClient", {}, dict(rows=[]),
         lambda m: [{"f": "add", "value": 7}, {"f": "read", "value": None}]),
        ("TidbMonotonicClient", {}, dict(rows=[["4"]]),
         lambda m: [{"f": "inc", "value": {2: None}},
                    {"f": "read", "value": {2: None, 1: None}}]),
        ("TidbMonotonicClient", {"use_index": True, "update_in_place": True},
         dict(rows=[], affected=0),
         lambda m: [{"f": "inc", "value": {2: None}},
                    {"f": "read", "value": {1: None}}]),
        ("TidbSeqClient", {"key_count": 3}, dict(rows=[["1"]]),
         lambda m: [{"f": "write", "value": 4}, {"f": "read", "value": [4]}]),
        ("TidbTableClient", {}, dict(rows=[]),
         lambda m: [{"f": "create-table", "value": 2},
                    {"f": "insert", "value": [2, 9]}]),
        ("TidbTableClient", {}, dict(rows=[], fail_on="INSERT",
                                     msg="no such table: t2"),
         lambda m: [{"f": "insert", "value": [2, 9]}]),
        ("TidbTableClient", {}, dict(rows=[], fail_on="INSERT",
                                     msg="UNIQUE constraint failed"),
         lambda m: [{"f": "insert", "value": [2, 9]}]),
    ]


def client_session(mod, name, axes, script, ops) -> tuple:
    test = {"nodes": ["t1"], "accounts": [0, 1], "total-amount": 10,
            "auto_retry": False, "auto_retry_limit": 0, **axes}
    cl = getattr(mod, name)().open(test, "t1")
    conn = SqlConn(mod, **script)
    cl._post_connect(conn, test)
    cl.conn = conn
    cl.setup(test)
    out = []
    for op in ops(mod):
        cl.conn = conn
        done = cl.invoke(test, {"type": "invoke", "process": 0, **op})
        v = done.get("value")
        if hasattr(v, "k"):
            v = ("kv", v.k, v.v)
        out.append((done["type"], v, done.get("error")))
    return conn.sent, out


@pytest.mark.parametrize("case", range(len(sessions())))
def test_client_sql_matches_reference(case):
    name, axes, script, ops = sessions()[case]
    got = client_session(ti, name, axes, script, ops)
    assert got == client_session(ref_ti, name, axes, script, ops)
    assert got[0][:2] == ["SET @@tidb_disable_txn_auto_retry = 1",
                          "SET @@tidb_retry_limit = 0"]


@pytest.mark.parametrize("which", sorted(ti.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(ti, gen, testlib, which)
    assert got == workload_ops(ref_ti, ref_gen, ref_testlib, which)
    assert got


@pytest.mark.parametrize("bad", (False, True), ids=("valid", "doesnt-exist"))
def test_table_checker_matches_reference(bad):
    ops = [invoke(0, "create-table", 1), ok(0, "create-table", 1),
           invoke(1, "insert", [1, 5]), ok(1, "insert", [1, 5]),
           invoke(2, "insert", [1, 5]),
           fail(2, "insert", [1, 5], error="duplicate-key")]
    if bad:
        ops += [invoke(3, "insert", [1, 6]),
                fail(3, "insert", [1, 6], error="doesn't-exist")]
    got = ti.TableChecker().check({}, History(ops).index(), {})
    want = ref_ti.TableChecker().check({}, ref_history(ops), {})
    assert plain(got) == plain(want)
    assert got["valid?"] is (not bad)


@pytest.mark.parametrize("stale", (False, True), ids=("valid", "stale"))
def test_register_verdicts_match_reference(tmp_path, stale):
    opts = _options(tmp_path, "register")
    chk = ti.tidb_test(opts)["checker"].checker_map["register"]
    ref_chk = ref_ti.tidb_test(opts)["checker"].checker_map["register"]
    ops = register_history(stale)
    got = chk.check({}, History([{**o, "value": tuple_(*o["value"])}
                                 for o in ops]).index(), {})
    want = ref_chk.check({}, RefHistory(
        [{**o, "value": ref_independent.tuple_(*o["value"])}
         for o in ops]).index(), {})
    assert got["valid?"] is (not stale) and want["valid?"] is (not stale)
    assert {k: r["valid?"] for k, r in got["results"].items()} == \
        {k: r["valid?"] for k, r in want["results"].items()}


@pytest.fixture(scope="module")
def append_run(tmp_path_factory):
    """A live append run (one mini node, 4 workers, 4 s, the kill/restart
    every 1.5 s), its generator seeded."""
    gen.RNG.seed(24)
    test = ti.tidb_test(_options(tmp_path_factory.mktemp("append"),
                                 "append", time_limit=4,
                                 nemesis_interval=1.5))
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
    assert any(o.process == "nemesis" and o.value == {"t1": "killed"}
               for o in hist)


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert ti.MINI_BASE_PORT == 31250
    assert ti.MINI_BASE_PORT != ref_ti.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < ti.MINI_BASE_PORT and ti.MINI_BASE_PORT + 50 <= lo
    assert ti.MINI_BASE_PORT + 5 <= FIXTURE_PORT < ti.MINI_BASE_PORT + 50
    test = {"nodes": ["t1", "t2"]}
    assert [ti.mini_node_port(test, n) for n in test["nodes"]] == \
        [ti.MINI_BASE_PORT, ti.MINI_BASE_PORT + 1]
    assert ti.mini_node_port({**test, "tidb_ports": {"t2": 4000}},
                             "t2") == 4000
    t = ti.tidb_test({"nodes": ["t1"], "concurrency": 2, "workload": "bank"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["db"].port(t, "t1") == ti.MINI_BASE_PORT
    assert t["client"].port_fn(t, "t1") == ("127.0.0.1", ti.MINI_BASE_PORT)


@pytest.mark.parametrize("which", ti.DEVICE_WORKLOADS)
def test_device_reaches_the_checkers(tmp_path, which):
    t = ti.tidb_test(_options(tmp_path, which))
    chk = t["checker"].checker_map[which]
    if which == "register":
        chk = chk.checker.checker_map["linear"]
        assert chk.algorithm == "competition"
    assert chk.device == torch.device("cpu")


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for which in ti.DEVICE_WORKLOADS:
        for server in ("mini", "tarball"):
            with pytest.raises(RuntimeError, match="CUDA"):
                ti.tidb_test({**_options(tmp_path, which), "server": server,
                              "device": None})
        with pytest.raises(RuntimeError, match="CUDA"):
            list(ti.tidb_tests({**_options(tmp_path, None),
                                "workload": which, "device": None}))
    assert not (tmp_path / "cluster").exists()
    # the other workloads' checks take no device: no card is needed
    for which in sorted(set(ti.WORKLOADS) - set(ti.DEVICE_WORKLOADS)):
        t = ti.tidb_test({**_options(tmp_path, which), "device": None})
        assert t["name"] == f"tidb-{which}-kill"
