"""The port's mysql_cluster suite (`jepsen_tpu_torch/dbs/mysql_cluster.py`),
on the port's galera, held against the JAX package: the twins of
`tests/test_mysql_cluster.py` (the three-role node-id and config algebra,
the deb recipe through the dummy remote, the register workload live under
the kill/restart nemesis), and parity cases: the role config files for one
to five nodes, the DB's commands, the SQL the register client sends and
what it answers, the generated ops, and one live register history judged
key by key by both packages' `wgl` oracles.

Also: the port's ports and store root are its own, the `device` option
reaches the register check, and a missing card raises before any node is
set up. The suite checks on the CPU (`device="cpu"`).
"""

import os

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import checker as ref_checker
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import mysql_cluster as ref_mc
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu_torch import checker, core, independent, store
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import mysql_cluster as mc
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.independent import tuple_
from jepsen_tpu_torch.models import cas_register
from test_torch_etcd import kv_of, ref_kv_history
from test_torch_galera import SqlConn, dummy_log, workload_ops
from test_torch_sqlite import ephemeral_range

NODES5 = ["n1", "n2", "n3", "n4", "n5"]


def test_node_id_blocks():
    test = {"nodes": NODES5}
    assert mc.mgmd_node_id(test, "n1") == 1
    assert mc.mgmd_node_id(test, "n5") == 5
    assert mc.ndbd_node_id(test, "n1") == 11
    assert mc.mysqld_node_id(test, "n1") == 21
    assert mc.mysqld_node_id(test, "n5") == 25


def test_ndbd_group_is_first_four():
    assert mc.ndbd_nodes({"nodes": NODES5}) == ["n1", "n2", "n3", "n4"]
    assert mc.ndbd_nodes({"nodes": ["a", "b"]}) == ["a", "b"]


def test_nodes_conf_sections():
    test = {"nodes": NODES5}
    conf = mc.nodes_conf(test)
    # mgmd + mysqld everywhere, ndbd on the storage group only
    assert conf.count("[ndb_mgmd]") == 5
    assert conf.count("[ndbd]") == 4
    assert conf.count("[mysqld]") == 5
    assert "NodeId=11" in conf and "NodeId=15" not in conf
    assert mc.ndb_connect_string(test) == "n1,n2,n3,n4,n5"


def test_deb_commands():
    log: list = []
    db = mc.MySQLClusterDB()
    test = {"nodes": ["n1", "n2", "n3", "n4", "n5"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n5"):
            db.setup(test, "n5")   # NOT in the storage group
        with c.on("n1"):
            db.setup(test, "n1")   # storage + sql + mgmd
            db.setup_primary(test, "n1")
            db.teardown(test, "n1")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "mysql-cluster-gpl" in joined
    assert "--force-confask --force-confnew" in joined
    assert "ndb_mgmd" in joined
    assert joined.count("/ndbd") == 1      # only the storage node
    assert "mysqld_safe" in joined
    assert "--ndb-nodeid=11" in joined     # n1's storage id
    assert "--ndb-nodeid=1" in joined      # n1's mgmd id
    assert "ndb_mgm -e show" in joined     # primary readiness poll
    ups = [x[1] for x in log if isinstance(x[1], tuple)
           and x[1][0] == "upload"]
    dests = " ".join(str(u[2]) for u in ups)
    assert "/etc/my.cnf" in dests and "/etc/my.config.ini" in dests


def _options(tmp_path, **kw):
    return {"nodes": ["m1"], "concurrency": 4,
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.mark.slow  # the reference twin's mark (tests/test_mysql_cluster.py)
def test_register_live(tmp_path):
    done = core.run(mc.ndb_test(_options(tmp_path)))
    res = done["results"]
    assert res["valid?"] is True, res


# -- parity with the reference ------------------------------------------------

@pytest.mark.parametrize("n", range(1, 6))
def test_role_configs_match_reference(n):
    test = {"nodes": NODES5[:n]}
    for fn in ("ndbd_nodes", "nodes_conf", "ndb_connect_string"):
        assert getattr(mc, fn)(test) == getattr(ref_mc, fn)(test)
    for node in test["nodes"]:
        for fn in ("mgmd_node_id", "ndbd_node_id", "mysqld_node_id",
                   "mgmd_conf", "ndbd_conf", "mysqld_conf"):
            assert getattr(mc, fn)(test, node) == \
                getattr(ref_mc, fn)(test, node)
    assert mc.MY_CNF_TEMPLATE == ref_mc.MY_CNF_TEMPLATE
    assert mc.CONFIG_INI_HEADER == ref_mc.CONFIG_INI_HEADER


def ndb_db_steps(mod):
    db = mod.MySQLClusterDB()
    test = {"nodes": NODES5}
    steps = [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
             for n in ("n5", "n1")
             for f in ("setup", "kill", "start", "teardown")]
    steps.append(("n1", lambda: db.setup_primary(test, "n1")))
    return steps, db.log_files(test, "n1"), db.deb_url()


def test_db_commands_match_reference():
    steps, files, url = ndb_db_steps(mc)
    ref_steps, ref_files, ref_url = ndb_db_steps(ref_mc)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert (files, url) == (ref_files, ref_url)


def register_session(mod, kv, value, affected) -> tuple:
    cl = mod.NdbRegisterClient().open({}, "m1")
    conn = SqlConn(mod, [[str(value)]] if value is not None else [],
                   affected)
    out = []
    for f, v in (("read", None), ("write", 3), ("cas", [3, 4])):
        cl.conn = conn
        out.append(cl.invoke({}, {"type": "invoke", "f": f, "process": 0,
                                  "value": kv(7, v)}))
    return conn.sent, [(o["type"], o["value"].k, o["value"].v) for o in out]


@pytest.mark.parametrize("value,affected", ((None, 0), (3, 1), (5, 0)))
def test_register_client_sql_matches_reference(value, affected):
    got = register_session(mc, tuple_, value, affected)
    assert got == register_session(ref_mc, ref_independent.tuple_, value,
                                   affected)
    assert got[1][0] == ("ok", 7, value)
    assert got[1][2][0] == ("ok" if affected else "fail")


def test_generated_ops_match_reference():
    got = workload_ops(mc, gen, testlib, "register", n=60)
    assert got == workload_ops(ref_mc, ref_gen, ref_testlib, "register", n=60)
    assert {f for _, f, _ in got} == {"read", "write", "cas"}


@pytest.fixture(scope="module")
def register_run(tmp_path_factory):
    """A live register run (the reference test's one mini node and 4
    workers, the suite's 100 ops a key, for 4 s with the kill/restart every
    1.5 s so that the restart falls inside the run), its generator seeded,
    judged by the port's host `wgl` oracle: the suite's competition race
    with `device="cpu"` holds a key as long as the plain device lane's
    chunk (ROADMAP Queue C, C3), which `test_register_live` meets."""
    gen.RNG.seed(24)
    test = mc.ndb_test(_options(tmp_path_factory.mktemp("register"),
                                time_limit=4, nemesis_interval=1.5))
    test["checker"] = checker.compose({"register": independent.checker(
        checker.linearizable(cas_register(), algorithm="wgl",
                             device="cpu"))})
    return test, core.run(test)


def test_live_register_history_matches_reference(register_run):
    """The live register history, read back from the store, judged key by
    key by the port's `wgl` oracle and by the reference's: equal verdicts
    on every key, all True, equal to the run's own."""
    test, done = register_run
    stored = store.load_latest(test["store_root"])
    hist = History([{**o, "value": kv_of(o.get("value"))}
                    for o in stored["history"]]).index()
    assert [o.to_dict() for o in hist] == \
        [o.to_dict() for o in done["history"]]
    port = independent.checker(checker.linearizable(
        cas_register(), algorithm="wgl", device="cpu")).check(
            {"name": "ndb-oracle"}, hist, {})
    ref = ref_independent.checker(ref_checker.linearizable(
        ref_cas_register(), algorithm="wgl")).check(
            {"name": "ndb-oracle"}, ref_kv_history(hist), {})
    run = done["results"]["register"]["results"]
    verdicts = {k: r["valid?"] for k, r in port["results"].items()}
    assert verdicts == {k: r["valid?"] for k, r in ref["results"].items()}
    assert verdicts == {k: r["valid?"] for k, r in run.items()}
    assert len(verdicts) >= 3 and all(v is True for v in verdicts.values())
    assert any(o.process == "nemesis" and o.value == {"m1": "killed"}
               for o in hist)


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert mc.MINI_BASE_PORT == 31200
    assert mc.MINI_BASE_PORT != ref_mc.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < mc.MINI_BASE_PORT and mc.MINI_BASE_PORT + 50 <= lo
    test = {"nodes": ["m1", "m2"]}
    assert [mc.mini_node_port(test, n) for n in test["nodes"]] == \
        [mc.MINI_BASE_PORT, mc.MINI_BASE_PORT + 1]
    assert mc.mini_node_port({**test, "ndb_ports": {"m2": 4000}},
                             "m2") == 4000
    t = mc.ndb_test(_options(tmp_path))
    assert t["store_root"] == str(tmp_path / "store")
    t = mc.ndb_test({"nodes": ["m1"], "concurrency": 2, "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["db"].port(t, "m1") == mc.MINI_BASE_PORT
    assert t["client"].port_fn(t, "m1") == ("127.0.0.1", mc.MINI_BASE_PORT)


def test_device_reaches_the_checker(tmp_path):
    t = mc.ndb_test(_options(tmp_path))
    lin = t["checker"].checker_map["register"].checker.checker_map["linear"]
    assert lin.device == torch.device("cpu")
    assert lin.algorithm == "competition"


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "deb"):
        with pytest.raises(RuntimeError, match="CUDA"):
            mc.ndb_test({**_options(tmp_path), "server": server,
                         "device": None})
    assert not (tmp_path / "cluster").exists()
