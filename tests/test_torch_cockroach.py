"""The port's cockroach suite (`jepsen_tpu_torch/dbs/cockroach.py`), on
the port's postgres and stolon's mini server, held against the JAX
package: the twins of `tests/test_cockroach.py` (the monotonic and
comments checkers on hand-built histories, both workloads live against the
pgwire stub and, under the kill/restart nemesis, against live mini
servers), and parity cases: the SQL each client sends and what it
answers, the generated ops of each workload, both checkers' results
(valid, and with one seeded anomaly each), and the test maps of each
server mode.

Also: the port's ports and store root are its own. Its checks run on the
host and take no device. The stub is `tests/test_torch_postgres.py`'s.
"""

import os
import threading

import pytest

from jepsen_tpu import generator as ref_gen
from jepsen_tpu.dbs import cockroach as ref_cr
from jepsen_tpu.dbs import stolon as ref_st
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.dbs import cockroach as cr
from jepsen_tpu_torch.dbs import stolon as st
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, info, invoke, ok
from test_torch_galera import plain, ref_history, workload_ops
from test_torch_postgres import PgScript, PgStub, PgStubHandler
from test_torch_sqlite import ephemeral_range


# -- checker units ----------------------------------------------------------

def _row(val, sts, node="n1", process=0):
    return {"val": val, "sts": sts, "node": node, "process": process}


def test_monotonic_checker_valid():
    h = History([
        invoke(0, "add", None), ok(0, "add", _row(0, "a")),
        invoke(1, "add", None), ok(1, "add", _row(1, "b")),
        invoke(0, "read", None),
        ok(0, "read", [_row(0, "a"), _row(1, "b")]),
    ]).index()
    res = cr.MonotonicChecker().check({}, h, {})
    assert res["valid?"] is True, res


def test_monotonic_checker_catches_inversion_dup_loss():
    h = History([
        invoke(0, "read", None),
        ok(0, "read", [_row(1, "a"), _row(0, "b")]),
    ]).index()
    res = cr.MonotonicChecker().check({}, h, {})
    assert res["valid?"] is False and res["off-order-val"]
    h = History([
        invoke(0, "read", None),
        ok(0, "read", [_row(0, "a"), _row(0, "b")]),
    ]).index()
    assert cr.MonotonicChecker().check({}, h, {})["duplicates"] == [0]
    h = History([
        invoke(0, "add", None), ok(0, "add", _row(5, "a")),
        invoke(0, "read", None), ok(0, "read", []),
    ]).index()
    res = cr.MonotonicChecker().check({}, h, {})
    assert res["valid?"] is False and res["lost"] == [5]


def test_comments_checker_catches_missing_predecessor():
    h = History([
        invoke(0, "write", 0), ok(0, "write", 0),
        invoke(1, "write", 1), ok(1, "write", 1),
        invoke(2, "read", None), ok(2, "read", [1]),
    ]).index()
    res = cr.CommentsChecker().check({}, h, {})
    assert res["valid?"] is False
    assert res["errors"][0]["missing"] == [0]
    h2 = History([
        invoke(0, "write", 0),
        invoke(1, "write", 1), ok(1, "write", 1),
        ok(0, "write", 0),  # w0 concurrent with w1: no precedence
        invoke(2, "read", None), ok(2, "read", [1]),
    ]).index()
    assert cr.CommentsChecker().check({}, h2, {})["valid?"] is True


# -- live against the pgwire stub -------------------------------------------

@pytest.fixture()
def stub(tmp_path):
    srv = PgStub(("127.0.0.1", 0), PgStubHandler, str(tmp_path / "crdb.db"))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


def _run(stub, tmp_path, workload, **kw):
    opts = {"nodes": ["n1"], "concurrency": kw.pop("concurrency", 3),
            "time_limit": kw.pop("time_limit", 4), "workload": workload,
            "addr": f"{stub[0]}:{stub[1]}",
            "store_root": str(tmp_path / "store"), **kw}
    return core.run(cr.cockroach_test(opts))


def test_monotonic_suite_live(stub, tmp_path):
    done = _run(stub, tmp_path, "monotonic")
    res = done["results"]
    assert res["valid?"] is True, res
    assert res["monotonic"]["add-count"] > 0
    assert res["monotonic"]["read-count"] >= res["monotonic"]["add-count"]


def test_comments_suite_live(stub, tmp_path):
    done = _run(stub, tmp_path, "comments")
    res = done["results"]
    assert res["valid?"] is True, res
    assert res["comments"]["write-count"] > 0


def test_tests_fn_sweeps(tmp_path):
    names = [t["name"] for t in cr.cockroach_tests(
        {"nodes": ["n1"], "concurrency": 2, "store_root": str(tmp_path)})]
    assert names == ["cockroach-comments", "cockroach-monotonic"]


@pytest.mark.parametrize("which", ["monotonic", "comments"])
@pytest.mark.slow  # the reference twin's mark (tests/test_cockroach.py)
def test_full_suite_live(tmp_path, which):
    """Live pgwire mini servers under the kill/restart nemesis: the
    strict-serializability checkers hold across crash recovery."""
    done = core.run(cr.cockroach_test({
        "nodes": ["c1"], "concurrency": 4, "time_limit": 8,
        "nemesis_interval": 2.5, "workload": which,
        "store_root": str(tmp_path / "store"),
        "sandbox": str(tmp_path / "cluster")}))
    res = done["results"]
    assert res["valid?"] is True, res


# -- parity with the reference ------------------------------------------------

def session(mod, name: str, script: dict, ops) -> tuple:
    """Client `name` of `mod` over a `PgScript`: its setup, then each op.
    Returns (the statements sent, each op's (type, value, error))."""
    cl = getattr(mod, name)().open({}, "n1")
    conn = PgScript(mod, **script)
    cl.conn = conn
    cl.setup({})
    out = []
    for op in ops:
        if cl.conn is None:
            cl.conn = conn
        d = cl.invoke({}, {"type": "invoke", "process": 3, **op})
        out.append((d["type"], d.get("value"), d.get("error")))
    return conn.sent, out


ADD = {"f": "add", "value": None}
READ = {"f": "read", "value": None}
SESSIONS = (
    ("MonotonicClient", dict(rows=[["4"]]), [ADD]),
    ("MonotonicClient", dict(rows=[["1", "t1", "n1", "0"],
                                   ["2", "t2", "n2", "1"]]), [READ]),
    ("MonotonicClient", dict(rows=[["4"]], fail_on="INSERT",
                             msg="database is locked"), [ADD, ADD]),
    ("MonotonicClient", dict(rows=[["4"]], fail_on="SELECT"), [ADD, READ]),
    ("CommentsClient", dict(rows=[["3"], ["0"]]),
     [{"f": "write", "value": 7}, {"f": "write", "value": 8}, READ]),
    ("CommentsClient", dict(rows=[], affected=0, fail_on="SELECT"),
     [READ, {"f": "write", "value": 2}]),
)


@pytest.mark.parametrize("case", range(len(SESSIONS)))
def test_client_sql_matches_reference(case):
    name, script, ops = SESSIONS[case]
    got = session(cr, name, script, ops)
    assert got == session(ref_cr, name, script, ops)
    assert got[1]


def test_ts_sql_carried_as_reference():
    for mod in (cr, ref_cr):
        cl = mod.MonotonicClient(ts_sql="now()::text").open({}, "n2")
        assert (cl.ts_sql, cl.node) == ("now()::text", "n2")
    assert cr.SQLITE_TS == ref_cr.SQLITE_TS
    assert (cr.TABLE, cr.COMMENT_TABLES) == (ref_cr.TABLE,
                                             ref_cr.COMMENT_TABLES)
    assert [cr.id_table(i) for i in range(7)] == \
        [ref_cr.id_table(i) for i in range(7)]


@pytest.mark.parametrize("which", sorted(cr.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(cr, gen, testlib, which)
    assert got == workload_ops(ref_cr, ref_gen, ref_testlib, which)
    assert got


def monotonic_history(bad: str) -> list:
    rows = [_row(0, "a"), _row(1, "b"), _row(2, "c")]
    final = {"": rows, "inversion": [rows[0], _row(2, "b"), _row(1, "c")],
             "duplicate": rows + [_row(2, "d")], "lost": rows[:2],
             "sts": [_row(0, "b"), _row(1, "a"), rows[2]]}[bad]
    ops = []
    for i, r in enumerate(rows):
        ops += [invoke(i, "add", None), ok(i, "add", r)]
    return ops + [invoke(5, "add", None), info(5, "add", None),
                  invoke(0, "read", None), ok(0, "read", final)]


@pytest.mark.parametrize("bad", ("", "inversion", "duplicate", "lost", "sts"))
def test_monotonic_checker_matches_reference(bad):
    ops = monotonic_history(bad)
    got = cr.MonotonicChecker().check({}, History(ops).index(), {})
    want = ref_cr.MonotonicChecker().check({}, ref_history(ops), {})
    assert plain(got) == plain(want)
    assert got["valid?"] is (not bad)


def test_monotonic_unread_matches_reference():
    ops = [invoke(0, "add", None), ok(0, "add", _row(0, "a"))]
    got = cr.MonotonicChecker().check({}, History(ops).index(), {})
    assert got == ref_cr.MonotonicChecker().check({}, ref_history(ops), {})
    assert got["valid?"] == "unknown"


def comments_history(bad: bool) -> list:
    ops = [invoke(0, "write", 0), ok(0, "write", 0),
           invoke(1, "write", 1), invoke(2, "write", 2), ok(1, "write", 1),
           ok(2, "write", 2), invoke(3, "write", 3), ok(3, "write", 3),
           invoke(1, "read", None), ok(1, "read", [0, 1, 2, 3]),
           invoke(2, "read", None), ok(2, "read", [0, 2])]
    if bad:
        ops += [invoke(2, "read", None), ok(2, "read", [0, 3])]
    return ops


@pytest.mark.parametrize("bad", (False, True), ids=("valid", "missing"))
def test_comments_checker_matches_reference(bad):
    ops = comments_history(bad)
    got = cr.CommentsChecker().check({}, History(ops).index(), {})
    want = ref_cr.CommentsChecker().check({}, ref_history(ops), {})
    assert plain(got) == plain(want)
    assert got["valid?"] is (not bad)


def test_non_monotonic_matches_reference():
    rows = [{"x": v} for v in (1, 3, 2, 2, 5, 0)]
    for cmp in (lambda a, b: a < b, lambda a, b: a <= b):
        assert cr.non_monotonic(cmp, "x", rows) == \
            ref_cr.non_monotonic(cmp, "x", rows)


def suite_map(mod, tmp_path, mode: str, which: str) -> tuple:
    """A test map of `mod` as plain data: its name, DB, client, nemesis,
    checkers, where a client connects, and its ssh options."""
    opts = {"nodes": ["c1", "c2"], "concurrency": 4, "workload": which,
            "store_root": str(tmp_path / "s"), "sandbox": str(tmp_path / "c")}
    if mode == "external":
        opts["addr"] = "db.example:26257"
    t = mod.cockroach_test(opts)
    return (t["name"], type(t["db"]).__name__, type(t["client"]).__name__,
            type(t.get("nemesis")).__name__, sorted(t["checker"].checker_map),
            t["client"].addr_fn(t, "c2"), t["ssh"])


@pytest.mark.parametrize("mode", ("mini", "external"))
@pytest.mark.parametrize("which", sorted(cr.WORKLOADS))
def test_test_maps_match_reference(tmp_path, mode, which):
    got = suite_map(cr, tmp_path, mode, which)
    want = suite_map(ref_cr, tmp_path, mode, which)
    if mode == "mini":
        # each package's mini servers on its own block
        assert got[5] == ("127.0.0.1", cr.MINI_BASE_PORT)
        assert want[5] == ("127.0.0.1", ref_cr.MINI_BASE_PORT)
        got, want = got[:5] + got[6:], want[:5] + want[6:]
    assert got == want


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert cr.MINI_BASE_PORT == 31350
    assert cr.MINI_BASE_PORT != ref_cr.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < cr.MINI_BASE_PORT and cr.MINI_BASE_PORT + 50 <= lo
    # stolon's block (and its twin fixture) below, clear of five nodes
    assert st.MINI_BASE_PORT + 50 <= cr.MINI_BASE_PORT
    assert ref_st.MINI_BASE_PORT != st.MINI_BASE_PORT
    test = {"nodes": ["c1", "c2"]}
    assert [cr.mini_node_port(test, n) for n in test["nodes"]] == \
        [cr.MINI_BASE_PORT, cr.MINI_BASE_PORT + 1]
    assert cr.mini_node_port({**test, "crdb_ports": {"c2": 4000}},
                             "c2") == 4000
    t = cr.cockroach_test({"nodes": ["c1"], "concurrency": 2})
    assert t["store_root"] == os.path.join("store", "torch")
    # stolon's server, on cockroach's block
    assert isinstance(t["db"], st.MiniStolonDB)
    assert t["db"].script == "minipg.py"
    assert t["db"].port(t, "c1") == cr.MINI_BASE_PORT
