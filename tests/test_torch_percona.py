"""The port's percona suite (`jepsen_tpu_torch/dbs/percona.py`), on the
port's galera, held against the JAX package: the twins of
`tests/test_percona.py` (the row-lock clauses through the shared mini
server's dialect bridge, the bank client's lock_type / in_place axes and
dirty reads live under the kill/restart nemesis, the test-all sweep, the
deb recipe through the dummy remote), and parity cases: the DB's commands
and config, the SQL the bank client sends for each lock and in-place axis
(deadlock retries included) and what it answers, the test-all matrix, the
generated ops, and the bank checker's results (valid, and with one seeded
wrong total) equal to the reference's.

Also: the port's ports and store root are its own. percona's checks run
on the host and take no device.
"""

import os

import pytest

import jepsen_tpu.control as ref_c
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import nemesis as ref_jn
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import percona as ref_pc
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis as jn
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import galera as ga
from jepsen_tpu_torch.dbs import percona as pc
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History
from test_torch_galera import (bank_history, dummy_log, mini_server, plain,
                               ref_history, workload_ops)
from test_torch_sqlite import ephemeral_range

#: the twin fixture's server port, inside percona's block (31150-31199)
FIXTURE_PORT = 31190


# -- mini-server dialect bridge -----------------------------------------------

@pytest.fixture()
def mini(tmp_path):
    with mini_server(tmp_path, FIXTURE_PORT) as (start, _):
        conn = start()
        try:
            yield conn
        finally:
            conn.close()


def test_lock_clauses_accepted(mini):
    """Both MySQL row-lock clauses must survive the dialect bridge."""
    mini.query("CREATE TABLE accounts "
               "(id INTEGER PRIMARY KEY, balance BIGINT)")
    mini.query("INSERT INTO accounts VALUES (0, 50)")
    rows, _ = mini.query("SELECT balance FROM accounts "
                         "WHERE id=0 FOR UPDATE")
    assert rows == [["50"]]
    rows, _ = mini.query("SELECT balance FROM accounts "
                         "WHERE id=0 LOCK IN SHARE MODE")
    assert rows == [["50"]]


def test_bad_lock_type_rejected():
    with pytest.raises(ValueError, match="lock_type"):
        pc.PerconaBankClient(lock_type="table")


# -- full suites against live servers -----------------------------------------

def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["p1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), **kw}


@pytest.mark.parametrize("lock,in_place", [
    ("none", False), ("update", True), ("share", False)])
@pytest.mark.slow  # the reference twin's mark (tests/test_percona.py)
def test_bank_live(tmp_path, lock, in_place):
    done = core.run(pc.percona_test(_options(
        tmp_path, "bank", lock_type=lock, in_place=in_place)))
    res = done["results"]
    assert res["valid?"] is True, res


def test_dirty_reads_live(tmp_path):
    done = core.run(pc.percona_test(_options(tmp_path, "dirty-reads")))
    assert done["results"]["valid?"] is True, done["results"]


def test_test_all_matrix_shape(tmp_path):
    tests = list(pc.percona_tests(_options(tmp_path, None)))
    names = [t["name"] for t in tests]
    # lock/in-place sweep + dirty-reads (percona.clj permutations)
    assert len(tests) == 5
    assert any("bank-none" in n for n in names)
    assert any("bank-update-inplace" in n for n in names)
    assert any("bank-share" in n for n in names)
    assert any("dirty-reads" in n for n in names)
    # deb mode flips the nemesis to a partitioner (percona.clj:212)
    deb = pc.percona_test(_options(tmp_path, "bank", server="deb",
                                   nodes=["p1", "p2", "p3"]))
    assert isinstance(deb["nemesis"], jn.Partitioner)


# -- deb recipe command assertions --------------------------------------------

def test_deb_commands():
    log: list = []
    db = pc.PerconaDB()
    test = {"nodes": ["n1", "n2"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
        with c.on("n2"):
            db.setup(test, "n2")
        with c.on("n1"):
            db.teardown(test, "n1")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "debconf-set-selections" in joined
    assert "percona-xtradb-cluster-56" in joined
    assert joined.count("bootstrap-pxc") == 1   # ONLY the primary
    assert "cp -rp /var/lib/mysql /var/lib/mysql-stock" in joined
    # teardown restores the pristine datadir (percona.clj:139-144)
    assert "cp -rp /var/lib/mysql-stock /var/lib/mysql" in joined
    ups = [x[1] for x in log if isinstance(x[1], tuple)
           and x[1][0] == "upload"]
    assert any("jepsen.cnf" in str(u[2]) for u in ups)
    # primary's gcomm is EMPTY, joiners carry the full list
    assert pc.PerconaDB.cluster_address(test, "n1") == "gcomm://"
    assert pc.PerconaDB.cluster_address(test, "n2") == "gcomm://n1,n2"


# -- parity with the reference ------------------------------------------------

def percona_db_steps(mod):
    db = mod.PerconaDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in test["nodes"]
            for f in ("setup", "kill", "start", "teardown")], \
        db.log_files(test, "n1")


def test_db_commands_match_reference():
    steps, files = percona_db_steps(pc)
    ref_steps, ref_files = percona_db_steps(ref_pc)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert files == ref_files
    test = {"nodes": ["a", "b", "c"]}
    for node in test["nodes"]:
        assert pc.PerconaDB.jepsen_cnf(test, node) == \
            ref_pc.PerconaDB.jepsen_cnf(test, node)
    assert pc.DEBCONF_PRESEEDS == ref_pc.DEBCONF_PRESEEDS
    assert pc.LOCK_CLAUSES == ref_pc.LOCK_CLAUSES


class ScriptedConn:
    """A connection that records each statement and answers from a
    script: balances for SELECTs, a deadlock for the first `deadlocks`
    UPDATEs."""

    def __init__(self, mod, balances: dict, deadlocks: int = 0):
        self.mod, self.balances, self.deadlocks = mod, balances, deadlocks
        self.sent: list = []

    def query(self, sql):
        self.sent.append(sql)
        if sql.startswith("UPDATE") and self.deadlocks:
            self.deadlocks -= 1
            raise self.mod.MySqlError(1213, "Deadlock found")
        if sql.startswith("SELECT id, balance"):
            return [[str(k), str(v)] for k, v in self.balances.items()], 0
        if sql.startswith("SELECT balance"):
            k = int(sql.split("id=")[1].split()[0])
            return [[str(self.balances[k])]], 0
        return [], 1

    def close(self):
        pass


def bank_session(mod, lock, in_place, deadlocks) -> tuple:
    cl = mod.PerconaBankClient(lock_type=lock, in_place=in_place,
                               timeout=2.0).open({}, "p1")
    conn = ScriptedConn(mod, {0: 10, 1: 2}, deadlocks)
    cl.conn = conn
    ops = [{"type": "invoke", "f": "read", "value": None, "process": 0},
           {"type": "invoke", "f": "transfer", "process": 0,
            "value": {"from": 0, "to": 1, "amount": 4}},
           {"type": "invoke", "f": "transfer", "process": 0,
            "value": {"from": 1, "to": 0, "amount": 5}}]
    out = []
    for op in ops:
        cl.conn = conn
        out.append(cl.invoke({}, op))
    return conn.sent, out


@pytest.mark.parametrize("lock", sorted(pc.LOCK_CLAUSES))
@pytest.mark.parametrize("in_place", (False, True))
@pytest.mark.parametrize("deadlocks", (0, 1))
def test_bank_client_sql_matches_reference(lock, in_place, deadlocks):
    got = bank_session(pc, lock, in_place, deadlocks)
    assert got == bank_session(ref_pc, lock, in_place, deadlocks)
    sent, out = got
    assert [o["type"] for o in out] == ["ok", "ok", "fail"]
    assert sent.count("START TRANSACTION") == 2 + deadlocks


def test_test_all_matrix_matches_reference(tmp_path):
    for which in (None, "bank", "dirty-reads"):
        opts = _options(tmp_path, which)
        got = [(t["name"], type(t["client"]).__name__,
                getattr(t["client"], "lock_type", None),
                getattr(t["client"], "in_place", None))
               for t in pc.percona_tests(opts)]
        want = [(t["name"], type(t["client"]).__name__,
                 getattr(t["client"], "lock_type", None),
                 getattr(t["client"], "in_place", None))
                for t in ref_pc.percona_tests(opts)]
        assert got == want
    deb = ref_pc.percona_test(_options(tmp_path, "bank", server="deb",
                                       nodes=["p1", "p2"]))
    assert isinstance(deb["nemesis"], ref_jn.Partitioner)


@pytest.mark.parametrize("which", sorted(pc.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(pc, gen, testlib, which)
    assert got == workload_ops(ref_pc, ref_gen, ref_testlib, which)
    assert len(got) == 40


@pytest.mark.parametrize("wrong", (False, True), ids=("valid", "wrong-total"))
def test_bank_checker_matches_reference(tmp_path, wrong):
    opts = _options(tmp_path, "bank")
    t, rt = pc.percona_test(opts), ref_pc.percona_test(opts)
    ops = bank_history(wrong)
    got = t["checker"].checker_map["bank"].check(t, History(ops).index(), {})
    want = rt["checker"].checker_map["bank"].check(rt, ref_history(ops), {})
    assert got["valid?"] == want["valid?"] == (not wrong)
    assert plain(got["SI"]) == plain(want["SI"])


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert pc.MINI_BASE_PORT == 31150
    assert pc.MINI_BASE_PORT != ref_pc.MINI_BASE_PORT
    assert pc.MINI_BASE_PORT >= ga.MINI_BASE_PORT + 50
    lo, _ = ephemeral_range()
    assert 30680 < pc.MINI_BASE_PORT and pc.MINI_BASE_PORT + 50 <= lo
    assert pc.MINI_BASE_PORT + 5 <= FIXTURE_PORT < pc.MINI_BASE_PORT + 50
    test = {"nodes": ["p1", "p2"]}
    assert [pc.mini_node_port(test, n) for n in test["nodes"]] == \
        [pc.MINI_BASE_PORT, pc.MINI_BASE_PORT + 1]
    t = pc.percona_test({"nodes": ["p1", "p2"], "concurrency": 2})
    assert t["store_root"] == os.path.join("store", "torch")
    assert isinstance(t["db"], pc.MiniPerconaDB)
    assert t["db"].port(t, "p2") == pc.MINI_BASE_PORT + 1
    assert t["client"].port_fn(t, "p1") == ("127.0.0.1", pc.MINI_BASE_PORT)
