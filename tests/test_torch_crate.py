"""The port's crate suite (`jepsen_tpu_torch/dbs/crate.py`), on the port's
postgres, held against the JAX package: the twins of `tests/test_crate.py`
(the `_version` MVCC semantics on the live mini server, the dialect
bridge, all three checkers' anomaly detection, the workloads live under
the kill/restart nemesis, the `zip` recipe through the dummy remote), and
parity cases: the embedded server's source, its dialect bridge
(`translate`, the statements it absorbs) on crate's statements, the `zip`
recipe's commands and `crate.yml`, the SQL each client sends and what it
answers, the generated ops of each workload (seeded), and the three
checkers' results (valid, and with one seeded anomaly each), alone and
under `independent.checker`.

Also: the port's ports and store root are its own. Its checks run on the
host and take no device.
"""

import ast
import os
import subprocess
import sys
import time

import pytest

import jepsen_tpu.control as ref_c
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import crate as ref_cr
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import crate as cr
from jepsen_tpu_torch.dbs.postgres import PgConn, tag_count
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, fail, info, invoke, ok
from jepsen_tpu_torch.independent import tuple_
from test_torch_galera import (dummy_log, plain, ref_history, server_imports,
                               translate_of, workload_ops)
from test_torch_postgres import PgScript
from test_torch_sqlite import ephemeral_range

#: the twin fixture's server port, inside crate's block (31400-31449)
FIXTURE_PORT = 31440


@pytest.fixture()
def mini(tmp_path):
    srv_py = tmp_path / "minicrate.py"
    srv_py.write_text(cr.MINICRATE_SRC)
    proc = subprocess.Popen(
        [sys.executable, str(srv_py), "--port", str(FIXTURE_PORT),
         "--dir", str(tmp_path)], cwd=tmp_path)
    conn = None
    try:
        deadline = time.monotonic() + 30
        while True:
            try:
                conn = PgConn("127.0.0.1", FIXTURE_PORT, timeout=3)
                break
            except OSError:
                assert time.monotonic() < deadline, "never up"
                time.sleep(0.1)
        yield conn, FIXTURE_PORT
    finally:
        if conn is not None:
            conn.close()
        proc.kill()
        proc.wait(timeout=10)


def test_version_column_semantics(mini):
    conn, _ = mini
    conn.query("create table registers (id integer primary key, "
               "value integer)")
    conn.query("insert into registers (id, value) values (1, 10)")
    rows, _ = conn.query("select value, _version from registers "
                         "where id = 1")
    assert rows == [["10", "1"]]            # fresh row: version 1
    conn.query("update registers set value = 11 where id = 1")
    rows, _ = conn.query("select value, _version from registers "
                         "where id = 1")
    assert rows == [["11", "2"]]            # update bumped it
    _, tag = conn.query("update registers set value = 99 "
                        "where id = 1 and _version = 1")
    assert tag_count(tag) == 0
    _, tag = conn.query("update registers set value = 12 "
                        "where id = 1 and _version = 2")
    assert tag_count(tag) == 1
    rows, _ = conn.query("select value, _version from registers")
    assert rows == [["12", "3"]]


def test_dialect_bridge(mini):
    conn, _ = mini
    conn.query("create table sets (id integer primary key, "
               "elements string INDEX OFF STORAGE WITH "
               "(columnstore = false))")
    conn.query('alter table sets set (number_of_replicas = "0-all")')
    conn.query("refresh table sets")        # absorbed, not an error
    conn.query("insert into sets (id, elements) values (5, 'a') "
               "on duplicate key update elements = VALUES(elements)")
    conn.query("insert into sets (id, elements) values (5, 'b') "
               "on duplicate key update elements = VALUES(elements)")
    rows, _ = conn.query("select elements, _version from sets")
    assert rows == [["b", "2"]]


def test_multiversion_checker():
    good = History([
        invoke(0, "read", None), ok(0, "read", [7, 2]),
        invoke(1, "read", None), ok(1, "read", [7, 2]),
    ]).index()
    assert cr.MultiVersionChecker().check({}, good, {})["valid?"]
    bad = History([
        invoke(0, "read", None), ok(0, "read", [7, 2]),
        invoke(1, "read", None), ok(1, "read", [8, 2]),
    ]).index()
    res = cr.MultiVersionChecker().check({}, bad, {})
    assert res["valid?"] is False and "v2" in res["multis"]


def test_lost_updates_checker():
    h = History([
        invoke(0, "add", 1), ok(0, "add", 1),
        invoke(1, "add", 2), ok(1, "add", 2),
        invoke(2, "add", 9), fail(2, "add", 9),
        invoke(0, "read", None), ok(0, "read", [1]),
    ]).index()
    res = cr.LostUpdatesChecker().check({}, h, {})
    assert res["valid?"] is False
    assert res["lost"] == [2]
    assert 9 not in res["lost"]


def test_dirty_read_checker():
    h = History([
        invoke(0, "write", 0), ok(0, "write", 0),
        invoke(1, "read", 0), ok(1, "read", 0),
        invoke(2, "read", 5), ok(2, "read", 5),   # never visible!
        invoke(0, "strong-read", None), ok(0, "strong-read", [0, 1]),
        invoke(1, "strong-read", None), ok(1, "strong-read", [0, 1]),
    ]).index()
    res = cr.DirtyReadChecker().check({}, h, {})
    assert res["valid?"] is False
    assert res["dirty"] == [5]
    assert res["nodes-agree?"] is True
    h2 = History([
        invoke(0, "write", 0), ok(0, "write", 0),
        invoke(0, "strong-read", None), ok(0, "strong-read", [0]),
        invoke(1, "strong-read", None), ok(1, "strong-read", []),
    ]).index()
    res2 = cr.DirtyReadChecker().check({}, h2, {})
    assert res2["valid?"] is False
    assert res2["nodes-agree?"] is False


def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["c1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), **kw}


@pytest.mark.parametrize("which", ["version-divergence",
                                   "lost-updates", "dirty-read"])
@pytest.mark.slow  # the reference twin's mark (tests/test_crate.py)
def test_full_suite_live(tmp_path, which):
    done = core.run(cr.crate_test(_options(tmp_path, which)))
    res = done["results"]
    assert res["valid?"] is True, res


def test_zip_commands():
    log: list = []
    db = cr.CrateDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
            db.teardown(test, "n1")
    joined = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "openjdk-8" in joined
    assert "bin/crate" in joined
    assert "io.crate.bootstrap.CrateDB" in joined
    yml = cr.CrateDB.crate_yml(test, "n2")
    assert '"n1:44300", "n2:44300", "n3:44300"' in yml
    assert "minimum_master_nodes: 2" in yml
    assert "psql.port: 5432" in yml


# -- parity with the reference ------------------------------------------------

def test_server_src_is_the_references_and_imports_neither_package():
    assert cr.MINICRATE_SRC == ref_cr.MINICRATE_SRC
    mods = server_imports(cr.MINICRATE_SRC)
    assert {"socketserver", "sqlite3", "re"} <= mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


def noop_re_of(src: str):
    """The embedded server's `NOOP_RE`: the statements it absorbs."""
    tree = ast.parse(src)
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "NOOP_RE")
    ns: dict = {}
    exec(compile(ast.Module(body=[ast.parse("import re").body[0], node],
                            type_ignores=[]), "<noop>", "exec"), ns)
    return ns["NOOP_RE"]


CRATE_SQL = (
    "create table if not exists registers (id integer primary key, "
    "value integer)",
    "create table if not exists sets (id integer primary key, elements "
    "string INDEX OFF STORAGE WITH (columnstore = false))",
    "CREATE TABLE dirty_read (id integer primary key)",
    "create table if not exists t (a string, b STRING)",
    "insert into registers (id, value) values (3, 7) on duplicate key "
    "update value = VALUES(value)",
    "INSERT INTO sets (k, elements) VALUES (1, 'a') ON DUPLICATE KEY UPDATE "
    "elements = VALUES(elements)",
    "insert into t values (1, 2) on duplicate key update b = VALUES(b)",
    "update sets set elements = '1,2' where id = 4 and _version = 3",
    "UPDATE registers SET value = 1 WHERE id = 2",
    "update t set a = 1",
    "select value, _version from registers where id = 3",
    "insert into dirty_read (id) values (5)",
    'alter table sets set (number_of_replicas = "0-all")',
    "refresh table dirty_read",
    "  REFRESH TABLE x",
    "select 'string' from t",
)


def test_translate_matches_reference():
    port, ref = translate_of(cr.MINICRATE_SRC), \
        translate_of(ref_cr.MINICRATE_SRC)
    got = [port(s) for s in CRATE_SQL]
    assert got == [ref(s) for s in CRATE_SQL]
    assert got[0].endswith(", _version INTEGER NOT NULL DEFAULT 1)")
    assert "TEXT" in got[1] and "INDEX OFF" not in got[1]
    assert got[4].endswith("ON CONFLICT(id) DO UPDATE SET value=excluded.value"
                           ", _version = _version + 1")
    assert "_version = _version + 1" in got[7]
    noop, ref_noop = noop_re_of(cr.MINICRATE_SRC), \
        noop_re_of(ref_cr.MINICRATE_SRC)
    absorbed = [bool(noop.match(s)) for s in CRATE_SQL]
    assert absorbed == [bool(ref_noop.match(s)) for s in CRATE_SQL]
    assert sum(absorbed) == 3


def zip_steps(mod):
    db = mod.CrateDB()
    test = {"nodes": ["n1", "n2", "n3", "n4"]}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in ("n1", "n4")
            for f in ("setup", "kill", "start", "teardown")], \
        db.log_files(test, "n1"), db.tarball_url()


def test_zip_commands_match_reference():
    steps, files, url = zip_steps(cr)
    ref_steps, ref_files, ref_url = zip_steps(ref_cr)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert (files, url) == (ref_files, ref_url)
    for n in range(1, 6):
        test = {"nodes": [f"n{i}" for i in range(n)]}
        assert cr.CrateDB.crate_yml(test, "n0") == \
            ref_cr.CrateDB.crate_yml(test, "n0")


def kv(mod, k, v):
    return (tuple_ if mod is cr else ref_independent.tuple_)(k, v)


def session(mod, name: str, script: dict, ops) -> tuple:
    """Client `name` of `mod` over a `PgScript`: its setup, then each op.
    Returns (the statements sent, each op's (type, value, error))."""
    cl = getattr(mod, name)().open({}, "c1")
    conn = PgScript(mod, **script)
    cl.conn = conn
    cl.setup({})
    out = []
    for op in ops(mod):
        if cl.conn is None:
            cl.conn = conn
        d = cl.invoke({}, {"type": "invoke", "process": 0, **op})
        v = d.get("value")
        out.append((d["type"], ("kv", v.k, v.v) if hasattr(v, "k") else v,
                    d.get("error")))
    return conn.sent, out


def vd_ops(mod):
    return [{"f": "read", "value": kv(mod, 2, None)},
            {"f": "write", "value": kv(mod, 2, 9)}]


def lu_ops(mod):
    return [{"f": "add", "value": kv(mod, 1, 4)},
            {"f": "read", "value": kv(mod, 1, None)}]


DR_OPS = [{"f": "write", "value": 3}, {"f": "read", "value": 3},
          {"f": "read", "value": -1}, {"f": "refresh", "value": None},
          {"f": "strong-read", "value": None}]

SESSIONS = (
    ("VersionDivergenceClient", dict(rows=[["9", "2"]]), vd_ops),
    ("VersionDivergenceClient", dict(rows=[]), vd_ops),
    ("VersionDivergenceClient", dict(rows=[], fail_on="insert"), vd_ops),
    ("LostUpdatesClient", dict(rows=[["1,2", "3"]]), lu_ops),
    ("LostUpdatesClient", dict(rows=[["1,2", "3"]], affected=0), lu_ops),
    ("LostUpdatesClient", dict(rows=[]), lu_ops),
    ("LostUpdatesClient", dict(rows=[], fail_on="insert into sets (id",
                               msg="UNIQUE constraint failed: sets.id"),
     lu_ops),
    ("LostUpdatesClient", dict(rows=[], fail_on="insert into sets (id",
                               msg="disk I/O error"), lu_ops),
    ("DirtyReadClient", dict(rows=[["3"], ["1"]]), lambda m: DR_OPS),
    ("DirtyReadClient", dict(rows=[]), lambda m: DR_OPS),
    ("DirtyReadClient", dict(rows=[], fail_on="refresh"), lambda m: DR_OPS),
)


@pytest.mark.parametrize("case", range(len(SESSIONS)))
def test_client_sql_matches_reference(case):
    name, script, ops = SESSIONS[case]
    got = session(cr, name, script, ops)
    assert got == session(ref_cr, name, script, ops)
    assert got[1]


@pytest.mark.parametrize("which", sorted(cr.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(cr, gen, testlib, which, n=60)
    assert got == workload_ops(ref_cr, ref_gen, ref_testlib, which, n=60)
    assert got


def checker_histories(which: str, bad: bool) -> list:
    """A history of the workload `which` (per key, values unwrapped; the
    dirty-read history whole), with one seeded anomaly when `bad`."""
    if which == "version-divergence":
        ops = [invoke(0, "write", 1), ok(0, "write", 1),
               invoke(1, "read", None), ok(1, "read", [1, 1]),
               invoke(0, "write", 2), info(0, "write", 2),
               invoke(1, "read", None), ok(1, "read", [2, 2]),
               invoke(2, "read", None), ok(2, "read", None)]
        if bad:
            ops += [invoke(1, "read", None), ok(1, "read", [3, 2])]
    elif which == "lost-updates":
        ops = [invoke(0, "add", 1), ok(0, "add", 1),
               invoke(1, "add", 2), fail(1, "add", 2),
               invoke(0, "add", 3), info(0, "add", 3),
               invoke(2, "add", 4), ok(2, "add", 4),
               invoke(1, "read", None),
               ok(1, "read", [1] if bad else [1, 4])]
    else:
        ops = [invoke(0, "write", 0), ok(0, "write", 0),
               invoke(0, "write", 1), info(0, "write", 1),
               invoke(1, "read", 1), ok(1, "read", 1),
               invoke(2, "read", 2), fail(2, "read", 2),
               invoke(0, "refresh", None), ok(0, "refresh", None)]
        for p in range(3):
            ops += [invoke(p, "strong-read", None),
                    ok(p, "strong-read", [0] if bad and p == 2 else [0, 1])]
    return ops


CHECKERS = {"version-divergence": "MultiVersionChecker",
            "lost-updates": "LostUpdatesChecker",
            "dirty-read": "DirtyReadChecker"}


@pytest.mark.parametrize("bad", (False, True), ids=("valid", "anomaly"))
@pytest.mark.parametrize("which", sorted(CHECKERS))
def test_checkers_match_reference(which, bad):
    ops = checker_histories(which, bad)
    got = getattr(cr, CHECKERS[which])().check({}, History(ops).index(), {})
    want = getattr(ref_cr, CHECKERS[which])().check({}, ref_history(ops), {})
    assert plain(got) == plain(want)
    assert got["valid?"] is (not bad)


def test_lost_updates_unread_key_matches_reference():
    ops = [invoke(0, "add", 1), ok(0, "add", 1)]
    got = cr.LostUpdatesChecker().check({}, History(ops).index(), {})
    assert got == ref_cr.LostUpdatesChecker().check({}, ref_history(ops), {})
    assert got["valid?"] is True and got["no-final-read"] is True


@pytest.mark.parametrize("bad", (False, True), ids=("valid", "anomaly"))
@pytest.mark.parametrize("which", ("version-divergence", "lost-updates"))
def test_keyed_checkers_match_reference(tmp_path, which, bad):
    """The suite's own checker (`independent.checker` over the workload's)
    on two keys, key 1's history carrying the anomaly."""
    chk = cr.crate_test(_options(tmp_path, which))["checker"]
    ref_chk = ref_cr.crate_test(_options(tmp_path, which))["checker"]
    ops, ref_ops = [], []
    for k in (0, 1):
        for o in checker_histories(which, bad and k == 1):
            d = {**o.to_dict(), "process": o.process + 3 * k}
            ops.append({**d, "value": tuple_(k, o.value)})
            ref_ops.append({**d, "value": ref_independent.tuple_(k, o.value)})
    got = chk.check({}, History(ops).index(), {})
    want = ref_chk.check({}, RefHistory(ref_ops).index(), {})
    assert got["valid?"] is want["valid?"] is (not bad)
    res, ref_res = plain(got[which]["results"]), plain(want[which]["results"])
    for r in list(res.values()) + list(ref_res.values()):
        # each key's shard record carries its own clock readings
        del r["shard"]["t0"], r["shard"]["wall_s"]
    assert res == ref_res
    assert isinstance(chk.checker_map[which], independent.IndependentChecker)


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert cr.MINI_BASE_PORT == 31400
    assert cr.MINI_BASE_PORT != ref_cr.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < cr.MINI_BASE_PORT and cr.MINI_BASE_PORT + 50 <= lo
    assert cr.MINI_BASE_PORT + 5 <= FIXTURE_PORT < cr.MINI_BASE_PORT + 50
    test = {"nodes": ["c1", "c2"]}
    assert [cr.mini_node_port(test, n) for n in test["nodes"]] == \
        [cr.MINI_BASE_PORT, cr.MINI_BASE_PORT + 1]
    assert cr.mini_node_port({**test, "crate_ports": {"c2": 4000}},
                             "c2") == 4000
    t = cr.crate_test({"nodes": ["c1"], "concurrency": 2})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["db"].port(t, "c1") == cr.MINI_BASE_PORT
    assert t["client"].addr_fn(t, "c1") == ("127.0.0.1", cr.MINI_BASE_PORT)
    assert (cr.PSQL_PORT, cr.ES_PORT) == (ref_cr.PSQL_PORT, ref_cr.ES_PORT)
