"""The port's dgraph suite (`jepsen_tpu_torch/dbs/dgraph.py`) held against
the JAX package: the twins of `tests/test_dgraph.py` (the mini alpha's MVCC
transaction model: snapshot reads, write-write conflicts, the @upsert
index-read conflict and the duplicate-uid anomaly without it, list
predicates and deletes, crash durability; the checkers; the eight workloads
live; the zip automation through the dummy remote), and parity cases: the
alpha's source byte for byte, the zip and mini-server commands, the
generated ops of every workload, both checkers on the reference tests'
histories, what the clients make of a refused, a reset and a timed-out
connection and of an error body that is not JSON (the fail / info split),
one live `register` history judged key by key by both packages' host
`wgl` oracles, and one live `wr` history judged by both Elles on the host.

Also: the port's ports and store root are its own, the `device` option
reaches the `register` and `wr` checks, and a missing card raises before
any node is set up. The suite checks on the CPU (`device="cpu"`).
"""

import os
import subprocess
import sys
import time
from urllib.parse import urlsplit

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import checker as ref_checker
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import dgraph as ref_dg
from jepsen_tpu.elle import wr as ref_wr
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.history import invoke as ref_invoke
from jepsen_tpu.history import ok as ref_ok
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu.workloads import cycle_wr as ref_cycle_wr
from jepsen_tpu_torch import checker, core, independent, store
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import dgraph as dg
from jepsen_tpu_torch.dbs import httpclient
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, invoke, ok
from jepsen_tpu_torch.independent import tuple_
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.workloads import cycle_wr
from test_torch_etcd import kv_of, ref_kv_history
from test_torch_galera import dummy_log, workload_ops
from test_torch_httpclient import fault_url
from test_torch_logcabin import src_imports
from test_torch_sqlite import ephemeral_range
from test_torch_yuga import plain_value

#: the twin fixture's server ports, inside dgraph's block (31900-31949)
FIXTURE_PORTS = (31940, 31941, 31942)


@pytest.fixture()
def mini(tmp_path):
    state = {"procs": []}

    def start(port=FIXTURE_PORTS[0], subdir="d"):
        d = tmp_path / subdir
        d.mkdir(exist_ok=True)
        srv_py = d / "minidgraph.py"
        srv_py.write_text(dg.MINIDGRAPH_SRC)
        proc = subprocess.Popen(
            [sys.executable, str(srv_py), "--port", str(port),
             "--dir", str(d)], cwd=d)
        state["procs"].append(proc)
        deadline = time.monotonic() + 30
        while True:
            try:
                return dg.DgraphConn("127.0.0.1", port, timeout=3)
            except (OSError, dg.DgraphError):
                assert time.monotonic() < deadline, "never up"
                time.sleep(0.1)

    yield start, state
    for proc in state["procs"]:
        proc.kill()
        proc.wait(timeout=10)


def test_snapshot_reads_and_ryw(mini):
    start, _ = mini
    conn = start()
    conn.alter("name: string @index(exact) .")
    conn.mutate(None, set_objs=[{"name": "a"}], commit_now=True)
    # a txn's snapshot is fixed at start; its own writes overlay it
    ts = conn.begin()
    before = conn.query("{ q(func: eq(name, $n)) { uid } }",
                        {"n": "a"}, ts=ts)["q"]
    assert len(before) == 1
    conn.mutate(ts, set_objs=[{"name": "a"}])
    ryw = conn.query("{ q(func: eq(name, $n)) { uid } }",
                     {"n": "a"}, ts=ts)["q"]
    assert len(ryw) == 2          # read-your-writes
    # a commit AFTER our start_ts is invisible to us
    conn.mutate(None, set_objs=[{"name": "a"}], commit_now=True)
    snap = conn.query("{ q(func: eq(name, $n)) { uid } }",
                      {"n": "a"}, ts=ts)["q"]
    assert len(snap) == 2         # still 1 committed + 1 ours
    conn.abort(ts)
    conn.close()


def test_write_write_conflict(mini):
    start, _ = mini
    conn = start()
    conn.alter("value: int .")
    uids = conn.mutate(None, set_objs=[{"value": 1}],
                       commit_now=True)
    uid = next(iter(uids.values()))
    t1, t2 = conn.begin(), conn.begin()
    conn.mutate(t1, set_objs=[{"uid": uid, "value": 2}])
    conn.mutate(t2, set_objs=[{"uid": uid, "value": 3}])
    conn.commit(t1)
    with pytest.raises(dg.TxnConflict):
        conn.commit(t2)
    conn.close()


def _upsert_race(conn, key):
    """Two racing insert-unless-exists txns; returns #committed."""
    t1, t2 = conn.begin(), conn.begin()
    committed = 0
    for t in (t1, t2):
        found = conn.query("{ q(func: eq(email, $e)) { uid } }",
                           {"e": key}, ts=t)["q"]
        assert found == []
        conn.mutate(t, set_objs=[{"email": key}])
    for t in (t1, t2):
        try:
            conn.commit(t)
            committed += 1
        except dg.TxnConflict:
            pass
    return committed


def test_upsert_schema_axis_decides_the_anomaly(mini):
    """Without @upsert the index read doesn't conflict and both inserts
    commit (duplicate uids); with @upsert exactly one wins."""
    start, _ = mini
    conn = start()
    conn.alter("email: string @index(exact) .")     # no @upsert
    assert _upsert_race(conn, "dup@x") == 2          # anomaly!
    recs = conn.query("{ q(func: eq(email, $e)) { uid } }",
                      {"e": "dup@x"})["q"]
    assert len(recs) == 2
    conn.alter("email: string @index(exact) @upsert .")
    assert _upsert_race(conn, "uniq@x") == 1         # cured
    conn.close()


def test_list_pred_and_delete(mini):
    start, _ = mini
    conn = start()
    conn.alter("tags: [int] .")
    uids = conn.mutate(None, set_objs=[{"tags": 1}],
                       commit_now=True)
    uid = next(iter(uids.values()))
    conn.mutate(None, set_objs=[{"uid": uid, "tags": 2}],
                commit_now=True)
    recs = conn.query("{ q(func: uid($u)) { uid tags } }",
                      {"u": uid})["q"]
    assert sorted(recs[0]["tags"]) == [1, 2]
    # whole-node delete clears every pred
    conn.mutate(None, del_objs=[{"uid": uid}], commit_now=True)
    recs = conn.query("{ q(func: uid($u)) { uid tags } }",
                      {"u": uid})["q"]
    assert recs == []
    conn.close()


def test_crash_durability(mini):
    start, state = mini
    conn = start(port=FIXTURE_PORTS[1], subdir="dur")
    conn.alter("key: int @index(int) .")
    conn.mutate(None, set_objs=[{"key": 42, "value": 7}],
                commit_now=True)
    conn.close()
    state["procs"][-1].kill()
    state["procs"][-1].wait(timeout=10)
    conn = start(port=FIXTURE_PORTS[2], subdir="dur")
    recs = conn.query("{ q(func: eq(key, $k)) { uid value } }",
                      {"k": 42})["q"]
    assert len(recs) == 1 and recs[0]["value"] == 7
    conn.close()


def test_upsert_checker():
    good = History([
        invoke(0, "upsert", tuple_(1, None)),
        ok(0, "upsert", tuple_(1, "0x1")),
        invoke(1, "read", None), ok(1, "read", ["0x1"]),
    ]).index()
    assert dg.UpsertChecker().check({}, good, {})["valid?"]
    bad = History([
        invoke(0, "read", None), ok(0, "read", ["0x1", "0x2"]),
    ]).index()
    res = dg.UpsertChecker().check({}, bad, {})
    assert res["valid?"] is False and res["bad-reads"]


def test_delete_checker():
    good = History([
        invoke(0, "read", None), ok(0, "read", []),
        invoke(1, "read", None),
        ok(1, "read", [{"uid": "0x1", "key": 3}]),
    ]).index()
    assert dg.DeleteChecker().check({}, good,
                                    {"history_key": 3})["valid?"]
    bad = History([
        invoke(0, "read", None),
        ok(0, "read", [{"uid": "0x1"}]),          # key index stale
    ]).index()
    assert dg.DeleteChecker().check({}, bad, {})["valid?"] is False


def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["d1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.mark.parametrize("which", sorted(dg.WORKLOADS))
@pytest.mark.slow  # as its twin in tests/test_dgraph.py
def test_full_suite_live(tmp_path, which):
    done = core.run(dg.dgraph_test(_options(tmp_path, which)))
    res = done["results"]
    assert res["valid?"] is True, res


def test_zip_commands():
    log: list = []
    db = dg.DgraphDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n2"):
            db.setup(test, "n2")
            db.teardown(test, "n2")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "zero" in joined and "alpha" in joined
    assert "--replicas 2" in joined
    assert "--peer n1:5080" in joined      # joiners point at primary
    assert "--zero n2:5080" in joined      # alpha at the local zero


# -- parity with the reference ------------------------------------------------

def test_constants_match_reference():
    for name in ("VERSION", "ALPHA_HTTP_PORT", "ZERO_PORT", "PRED_COUNT"):
        assert getattr(dg, name) == getattr(ref_dg, name), name
    for name in ("script", "pidfile", "logfile", "data_files"):
        assert getattr(dg.MiniDgraphDB, name) == \
            getattr(ref_dg.MiniDgraphDB, name), name
    assert sorted(dg.WORKLOADS) == sorted(ref_dg.WORKLOADS)
    assert set(dg.DEVICE_WORKLOADS) == {"register", "wr"}
    assert dg.DgraphDB().tarball_url() == ref_dg.DgraphDB().tarball_url()
    assert [dg.gen_pred("key", 7, k) for k in range(9)] == \
        [ref_dg.gen_pred("key", 7, k) for k in range(9)]
    assert dg.gen_preds("amount", 3) == ref_dg.gen_preds("amount", 3)
    # the builtin ConnectionError, not the client's: every client error
    # is an OSError, as requests' are
    assert dg._DgraphBase.retry_excs == (OSError, dg.DgraphError)
    assert issubclass(httpclient.RequestException, OSError)


def test_source_is_the_references_and_imports_neither_package():
    assert dg.MINIDGRAPH_SRC == ref_dg.MINIDGRAPH_SRC
    mods = src_imports(dg.MINIDGRAPH_SRC)
    assert {"http", "json"} <= mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


def zip_steps(mod):
    db = mod.DgraphDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in ("n1", "n2")
            for f in ("setup", "kill", "start", "teardown")], \
        db.log_files(test, "n1")


def test_zip_commands_match_reference(monkeypatch):
    # the zip steps wait for the alpha's port: no alpha listens here
    from jepsen_tpu.control import nodeutil as ref_nodeutil
    from jepsen_tpu_torch.control import nodeutil
    for m in (nodeutil, ref_nodeutil):
        monkeypatch.setattr(m, "await_tcp_port", lambda *a, **kw: None)
    steps, files = zip_steps(dg)
    ref_steps, ref_files = zip_steps(ref_dg)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert files == ref_files


def test_mini_db_commands_match_reference():
    """The mini alpha's lifecycle: the same commands on the same ports."""
    def steps(mod):
        db = mod.MiniDgraphDB()
        test = {"nodes": ["d1", "d2"], "dgraph_ports": {"d1": 40000,
                                                        "d2": 40001}}
        return [("d2", (lambda f=f: getattr(db, f)(test, "d2")))
                for f in ("setup", "kill", "start", "pause", "resume",
                          "teardown")]
    assert dummy_log(c, DummyRemote, steps(dg)) == \
        dummy_log(ref_c, RefDummyRemote, steps(ref_dg))


@pytest.mark.parametrize("which", sorted(dg.WORKLOADS))
def test_generated_ops_match_reference(which, monkeypatch):
    # wr's Elle generator draws from an RNG of its own, which the suite
    # leaves unseeded
    for mod in (cycle_wr, ref_cycle_wr):
        orig = mod.workload
        monkeypatch.setattr(mod, "workload", lambda *a, _o=orig, **kw:
                            _o(*a, **{**kw, "seed": 24}))
    got = workload_ops(dg, gen, testlib, which)
    assert got == workload_ops(ref_dg, ref_gen, ref_testlib, which)
    assert len(got) == 40


def checker_histories(hist_cls, inv, okd, tup):
    """The reference tests' checker histories, built with one package's
    History, ops and tuples: (name, checker name, history, opts)."""
    return [
        ("upsert-good", "UpsertChecker", hist_cls([
            inv(0, "upsert", tup(1, None)), okd(0, "upsert", tup(1, "0x1")),
            inv(1, "read", None), okd(1, "read", ["0x1"])]).index(), {}),
        ("upsert-two-uids", "UpsertChecker", hist_cls([
            inv(0, "read", None), okd(0, "read", ["0x1", "0x2"])]).index(),
         {}),
        ("upsert-two-oks", "UpsertChecker", hist_cls([
            inv(0, "upsert", tup(1, None)), okd(0, "upsert", tup(1, "0x1")),
            inv(1, "upsert", tup(1, None)),
            okd(1, "upsert", tup(1, "0x2"))]).index(), {}),
        ("delete-good", "DeleteChecker", hist_cls([
            inv(0, "read", None), okd(0, "read", []),
            inv(1, "read", None),
            okd(1, "read", [{"uid": "0x1", "key": 3}])]).index(),
         {"history_key": 3}),
        ("delete-stale", "DeleteChecker", hist_cls([
            inv(0, "read", None), okd(0, "read", [{"uid": "0x1"}])]).index(),
         {}),
        ("delete-wrong-key", "DeleteChecker", hist_cls([
            inv(0, "read", None),
            okd(0, "read", [{"uid": "0x1", "key": 4}])]).index(),
         {"history_key": 3}),
    ]


def test_checkers_match_reference():
    port = checker_histories(History, invoke, ok, tuple_)
    ref = checker_histories(RefHistory, ref_invoke, ref_ok,
                            ref_independent.tuple_)
    verdicts = []
    for (name, chk, h, opts), (_, _, rh, _) in zip(port, ref):
        got = getattr(dg, chk)().check({}, h, opts)
        assert got == getattr(ref_dg, chk)().check({}, rh, opts), name
        verdicts.append(got["valid?"])
    assert verdicts == [True, False, False, True, False, False]


# (client, its ops: (f, value), a ("kv", k, v) value made each package's
# `[k v]` tuple): the register's, the wr micro-op txns', the set's and the
# upsert's
CLIENT_OPS = {
    "RegisterClient": [("read", ("kv", 1, None)), ("write", ("kv", 1, 3)),
                       ("cas", ("kv", 1, [3, 4]))],
    "MopClient": [("txn", [["r", 1, None], ["w", 2, 5]])],
    "SetClient": [("add", 3), ("read", None)],
    "UpsertClient": [("upsert", ("kv", 2, None)), ("read", ("kv", 2, None))],
}
FAULTS = ("refused", "reset", "timeout", "http-500")


def fault_completions(mod, name: str, base: str) -> list:
    """The completions of client `name` of `mod` on a connection to
    `base` (a `fault_url`): (type, value, whether an error was given,
    whether the client still holds the connection). The connection is
    made as `DgraphConn` makes it, less its first probe, which a faulty
    server would fail."""
    import requests
    addr = urlsplit(base)
    cl = getattr(mod, name)(port_fn=lambda test, node: (
        addr.hostname, addr.port), timeout=0.3).open({}, "d1")
    out = []
    for f, v in CLIENT_OPS[name]:
        conn = object.__new__(mod.DgraphConn)
        conn.base, conn.timeout, conn.finished = base, 0.3, set()
        conn.http = (httpclient.Session() if mod is dg
                     else requests.Session())
        cl.conn = conn
        if isinstance(v, tuple):
            v = (tuple_ if mod is dg else ref_independent.tuple_)(v[1], v[2])
        done = cl.invoke({"nodes": ["d1"]}, {"type": "invoke", "f": f,
                                             "value": v, "process": 0})
        out.append((done["type"], plain_value(done.get("value")),
                    bool(done.get("error")), cl.conn is conn))
    return out


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", sorted(CLIENT_OPS))
def test_client_faults_classified_as_reference(name, fault):
    """The port's client (on `httpclient`) and the reference's (on
    `requests`) against the same fault: equal completions; a read fails,
    a mutation goes indefinite, and the connection is dropped."""
    pytest.importorskip("requests")
    with fault_url(fault) as base:
        got = fault_completions(dg, name, base)
        assert got == fault_completions(ref_dg, name, base)
    for (t, _, err, held), (f, _) in zip(got, CLIENT_OPS[name]):
        assert t == ("fail" if f == "read" else "info")
        assert err and not held


@pytest.fixture(scope="module")
def register_run(tmp_path_factory):
    """A live register run (the reference test's one mini node and 4
    workers, for 3 s with the kill/restart every 1 s so that a restart
    falls inside the run), its generator seeded, judged key by key by the
    port's host `wgl` oracle (the suite's competition race with
    `device="cpu"` is `test_full_suite_live`'s)."""
    gen.RNG.seed(28)
    test = dg.dgraph_test(_options(tmp_path_factory.mktemp("dgraph"),
                                   "register", time_limit=3,
                                   nemesis_interval=1.0))
    test["checker"] = checker.compose({"register": independent.checker(
        checker.linearizable(cas_register(), algorithm="wgl",
                             device="cpu"))})
    return test, core.run(test)


def test_live_register_history_matches_reference(register_run):
    """The live register history, read back from the store, judged key by
    key by the port's `wgl` oracle and by the reference's: equal verdicts
    on every key, all True, equal to the run's own; a kill landed in the
    run."""
    test, done = register_run
    hist = History([{**o, "value": kv_of(o.get("value"))}
                    for o in store.load_latest(test["store_root"])[
                        "history"]]).index()
    assert [o.to_dict() for o in hist] == \
        [o.to_dict() for o in done["history"]]
    port = independent.checker(checker.linearizable(
        cas_register(), algorithm="wgl", device="cpu")).check({}, hist, {})
    ref = ref_independent.checker(ref_checker.linearizable(
        ref_cas_register(), algorithm="wgl")).check(
            {}, ref_kv_history(hist), {})
    verdicts = {k: r["valid?"] for k, r in port["results"].items()}
    assert verdicts == {k: r["valid?"] for k, r in ref["results"].items()}
    assert verdicts == {
        k: r["valid?"]
        for k, r in done["results"]["register"]["results"].items()}
    assert len(verdicts) >= 2 and all(v is True for v in verdicts.values())
    assert any(o.process == "nemesis" and o.value == {"d1": "killed"}
               for o in hist)
    assert any(o.f == "cas" and o.is_ok for o in hist)


@pytest.fixture(scope="module")
def wr_run(tmp_path_factory):
    """A live wr run (one mini node, 4 workers, for 3 s with the
    kill/restart every 1 s), its generators seeded, the suite's own Elle
    check on the CPU."""
    gen.RNG.seed(28)
    test = dg.dgraph_test(_options(tmp_path_factory.mktemp("dgraph-wr"),
                                   "wr", time_limit=3,
                                   nemesis_interval=1.0))
    return test, core.run(test)


def test_live_wr_history_matches_reference(wr_run):
    """The live wr history, read back from the store, judged by the suite's
    own checker (the port's Elle, on the CPU) and by the reference's
    `elle.wr.check` with the suite's options on the host: equal results,
    valid, with committed transactions."""
    test, done = wr_run
    hist = History(store.load_latest(test["store_root"])["history"]).index()
    assert [o.to_dict() for o in hist] == \
        [o.to_dict() for o in done["history"]]
    chk = test["checker"].checker_map["wr"]
    port = done["results"]["wr"]
    ref = ref_wr.check(
        RefHistory([RefOp.from_dict(o.to_dict()) for o in hist]),
        anomalies=chk.anomalies, additional_graphs=chk.additional_graphs,
        sequential_keys=chk.sequential_keys,
        linearizable_keys=chk.linearizable_keys, wfr_keys=chk.wfr_keys,
        cycle_backend="host")
    keys = ("valid?", "anomaly-types", "anomalies", "not")
    assert {k: port.get(k) for k in keys} == {k: ref.get(k) for k in keys}
    assert port["valid?"] is True
    assert sum(1 for o in hist if o.is_ok and o.f == "txn") > 10


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert dg.MINI_BASE_PORT == 31900
    assert dg.MINI_BASE_PORT != ref_dg.MINI_BASE_PORT
    # below the ephemeral range, clear of the reference's bases
    # (21850-30680), with room for five nodes and the twin fixtures
    lo, _ = ephemeral_range()
    assert 30680 < dg.MINI_BASE_PORT and dg.MINI_BASE_PORT + 50 <= lo
    assert all(dg.MINI_BASE_PORT + 5 <= p < dg.MINI_BASE_PORT + 50
               for p in FIXTURE_PORTS)
    test = {"nodes": ["d1", "d2"]}
    assert [dg.mini_node_port(test, n) for n in test["nodes"]] == \
        [dg.MINI_BASE_PORT, dg.MINI_BASE_PORT + 1]
    assert dg.mini_node_port({**test, "dgraph_ports": {"d2": 4000}},
                             "d2") == 4000
    for which in dg.WORKLOADS:
        t = dg.dgraph_test(_options(tmp_path, which, nodes=["d1", "d2"]))
        assert t["store_root"] == str(tmp_path / "store")
        assert t["db"].port(t, "d2") == dg.MINI_BASE_PORT + 1
        # every worker drives the primary's alpha (`_conn` pins it)
        assert t["client"].port_fn(t, "d2") == ("127.0.0.1",
                                                dg.MINI_BASE_PORT + 1)
        assert t["client"].pin_primary is True
    t = dg.dgraph_test({"nodes": ["d1"], "concurrency": 2, "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["name"] == "dgraph-register-mini"


def test_device_reaches_the_checks(tmp_path):
    for server in ("mini", "zip"):
        for which in dg.WORKLOADS:
            t = dg.dgraph_test({**_options(tmp_path, which),
                                "server": server})
            chk = t["checker"].checker_map[which]
            if which == "register":
                lin = chk.checker.checker_map["linear"]
                assert lin.device == torch.device("cpu")
                assert lin.algorithm == "competition"
                assert lin.model == cas_register()
            elif which == "wr":
                assert chk.device == torch.device("cpu")
            else:
                assert getattr(chk, "device", None) is None, which


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for which in dg.DEVICE_WORKLOADS:
        for server in ("mini", "zip"):
            with pytest.raises(RuntimeError, match="CUDA"):
                dg.dgraph_test({**_options(tmp_path, which),
                                "server": server, "device": None})
    # the sweep resolves it before it makes its first test
    with pytest.raises(RuntimeError, match="CUDA"):
        next(dg.dgraph_tests({**_options(tmp_path, None), "device": None}))
    assert not (tmp_path / "cluster").exists()
    # a workload whose check runs on the host needs no card
    t = dg.dgraph_test({**_options(tmp_path, "bank"), "device": None})
    assert t["name"] == "dgraph-bank-mini"
