"""The port's fauna suite (`jepsen_tpu_torch/dbs/fauna.py`) held against the
JAX package: the twins of `tests/test_fauna.py` (the FQL-subset evaluator:
auth, atomic Do/Abort, If/Equals CAS, At temporal reads, both pagination
modes with the non-serialized page-straddle anomaly, crash durability; the
pages and monotonic checkers; the six workloads live; the zip automation
through the dummy remote), and parity cases: the server's source byte for
byte, the zip and mini-server commands and `faunadb.yml`, the generated ops
of every workload, both checkers on the reference tests' histories, the
secret the client sends in its session's headers, what the clients make of
a refused, a reset and a timed-out connection and of an error body that is
not JSON (the fail / info split), and one live `register` history judged
key by key by both packages' host `wgl` oracles.

Also: the port's ports and store root are its own, the `device` option
reaches the `register` check, and a missing card raises before any node is
set up. The suite checks on the CPU (`device="cpu"`).
"""

import base64
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
from jepsen_tpu.dbs import fauna as ref_fn
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import invoke as ref_invoke
from jepsen_tpu.history import ok as ref_ok
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu_torch import checker, core, independent, store
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import fauna as fn
from jepsen_tpu_torch.dbs import httpclient
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, invoke, ok
from jepsen_tpu_torch.independent import tuple_
from jepsen_tpu_torch.models import cas_register
from test_torch_etcd import kv_of, ref_kv_history
from test_torch_galera import dummy_log, workload_ops
from test_torch_httpclient import fault_url
from test_torch_logcabin import src_imports
from test_torch_sqlite import ephemeral_range
from test_torch_yuga import plain_value

#: the twin fixture's server ports, inside fauna's block (32000-32049)
FIXTURE_PORTS = (32040, 32041, 32042)


@pytest.fixture()
def mini(tmp_path):
    state = {"procs": []}

    def start(port=FIXTURE_PORTS[0], subdir="d"):
        d = tmp_path / subdir
        d.mkdir(exist_ok=True)
        srv_py = d / "minifauna.py"
        srv_py.write_text(fn.MINIFAUNA_SRC)
        proc = subprocess.Popen(
            [sys.executable, str(srv_py), "--port", str(port),
             "--dir", str(d), "--secret", fn.SECRET], cwd=d)
        state["procs"].append(proc)
        deadline = time.monotonic() + 30
        while True:
            try:
                return fn.FaunaConn("127.0.0.1", port, timeout=3)
            except (OSError, fn.FaunaError):
                assert time.monotonic() < deadline, "never up"
                time.sleep(0.1)

    yield start, state
    for proc in state["procs"]:
        proc.kill()
        proc.wait(timeout=10)


def test_auth_rejected(mini):
    start, _ = mini
    start()
    with pytest.raises(fn.FaunaError, match="unauthorized"):
        fn.FaunaConn("127.0.0.1", FIXTURE_PORTS[0], timeout=3,
                     secret="wrong")


def test_crud_and_cas(mini):
    start, _ = mini
    conn = start()
    conn.upsert_class("test")
    conn.query({"create": ["test", 1], "data": {"register": 5}})
    res = conn.query({"select": ["data", "register"],
                      "from": {"get": ["test", 1]}})
    assert res["resource"] == 5
    # CAS via If/Equals (register.clj:51-61)
    res = conn.query(
        {"if": {"equals": [{"select": ["data", "register"],
                            "from": {"get": ["test", 1]}}, 5]},
         "then": {"update": ["test", 1], "data": {"register": 7}},
         "else": False})
    assert res["resource"] is not False
    res = conn.query(
        {"if": {"equals": [{"select": ["data", "register"],
                            "from": {"get": ["test", 1]}}, 5]},
         "then": {"update": ["test", 1], "data": {"register": 9}},
         "else": False})
    assert res["resource"] is False
    conn.close()


def test_abort_has_no_partial_effects(mini):
    start, _ = mini
    conn = start()
    conn.upsert_class("t")
    conn.query({"create": ["t", 1], "data": {"v": 1}})
    with pytest.raises(fn.FaunaAbort):
        conn.query({"do": [
            {"update": ["t", 1], "data": {"v": 99}},
            {"abort": "nope"}]})
    res = conn.query({"select": ["data", "v"],
                      "from": {"get": ["t", 1]}})
    assert res["resource"] == 1      # the buffered update vanished
    conn.close()


def test_at_temporal_reads(mini):
    start, _ = mini
    conn = start()
    conn.upsert_class("r")
    t1 = conn.query({"create": ["r", 1], "data": {"v": 10}})["ts"]
    t2 = conn.query({"update": ["r", 1], "data": {"v": 20}})["ts"]
    sel = {"select": ["data", "v"], "from": {"get": ["r", 1]}}
    assert conn.query({"at": t1, "expr": sel})["resource"] == 10
    assert conn.query({"at": t2, "expr": sel})["resource"] == 20
    assert conn.query(sel)["resource"] == 20
    conn.close()


def test_pagination_serialized_axis(mini):
    """The pages.clj anomaly, demonstrated: a group committed between page
    reads straddles the cursor on a NON-serialized index; the serialized
    mode pins every page to one snapshot."""
    start, _ = mini
    conn = start()
    conn.upsert_class("pages")
    conn.upsert_index("idx", "pages", terms=["data", "key"],
                      values=["data", "value"])
    # seed: values 0,2,4,...,18 so the group below interleaves
    conn.query({"do": [
        {"create": ["pages", None],
         "data": {"key": 0, "value": v}} for v in range(0, 20, 2)]})

    # read page 1 (size 4), THEN commit a group spanning the cursor,
    # then read the rest — exactly the racing interleave
    def read_split(serialized):
        expr = {"paginate": ["idx", 0], "size": 4, "after": 0}
        page1 = conn.query(expr)["resource"]
        snap = page1["ts"]
        conn.query({"do": [
            {"create": ["pages", None],
             "data": {"key": 0, "value": v}} for v in (1, 15)]})
        out = list(page1["data"])
        after = page1["after"]
        while after is not None:
            expr = {"paginate": ["idx", 0], "size": 4,
                    "after": after}
            if serialized:
                expr = {"at": snap, "expr": expr}
            page = conn.query(expr)["resource"]
            out.extend(page["data"])
            after = page["after"]
        return out

    seen = read_split(serialized=False)
    assert 15 in seen and 1 not in seen      # the torn group!
    conn.query({"do": [
        {"create": ["pages", None],
         "data": {"key": 0, "value": v}} for v in (3, 17)]})
    seen = read_split(serialized=True)
    # serialized: whatever snapshot we pin, groups arrive whole
    assert (3 in seen) == (17 in seen)
    conn.close()


def test_crash_durability(mini):
    start, state = mini
    conn = start(port=FIXTURE_PORTS[1], subdir="dur")
    conn.upsert_class("kv")
    conn.query({"create": ["kv", 5], "data": {"v": 77}})
    conn.close()
    state["procs"][-1].kill()
    state["procs"][-1].wait(timeout=10)
    conn = start(port=FIXTURE_PORTS[2], subdir="dur")
    res = conn.query({"select": ["data", "v"],
                      "from": {"get": ["kv", 5]}})
    assert res["resource"] == 77
    conn.close()


def test_pages_checker():
    good = History([
        invoke(0, "add", [1, 2]), ok(0, "add", [1, 2]),
        invoke(1, "add", [3]), ok(1, "add", [3]),
        invoke(2, "read", None), ok(2, "read", [1, 2, 3]),
        invoke(3, "read", None), ok(3, "read", [3]),
    ]).index()
    assert fn.PagesChecker().check({}, good, {})["valid?"]
    bad = History([
        invoke(0, "add", [1, 2]), ok(0, "add", [1, 2]),
        invoke(1, "read", None), ok(1, "read", [1]),  # torn group
    ]).index()
    res = fn.PagesChecker().check({}, bad, {})
    assert res["valid?"] is False and res["errors"]


def test_monotonic_checker():
    good = History([
        invoke(0, "inc", None), ok(0, "inc", [1, 1]),
        invoke(1, "read", [1, None]), ok(1, "read", [1, 1]),
        invoke(0, "inc", None), ok(0, "inc", [5, 2]),
    ]).index()
    assert fn.MonotonicChecker().check({}, good, {})["valid?"]
    bad = History([
        invoke(0, "inc", None), ok(0, "inc", [1, 5]),
        invoke(1, "read", [3, None]), ok(1, "read", [3, 2]),
    ]).index()
    assert fn.MonotonicChecker().check({}, bad, {})["valid?"] is False


def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["f1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.mark.parametrize("which", sorted(fn.WORKLOADS))
@pytest.mark.slow  # as its twin in tests/test_fauna.py
def test_full_suite_live(tmp_path, which):
    done = core.run(fn.fauna_test(_options(tmp_path, which)))
    res = done["results"]
    assert res["valid?"] is True, res


def test_zip_commands():
    log: list = []
    db = fn.FaunaDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n2"):
            db.setup(test, "n2")   # a joiner
            db.teardown(test, "n2")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "faunadb-admin join n1" in joined  # joiners, not init
    assert "init" not in joined.replace("join", "")
    yml = fn.FaunaDB.fauna_yml(test, "n2")
    assert "network_broadcast_address: n2" in yml


# -- parity with the reference ------------------------------------------------

def test_constants_match_reference():
    for name in ("VERSION", "PORT", "SECRET"):
        assert getattr(fn, name) == getattr(ref_fn, name), name
    for name in ("script", "pidfile", "logfile", "data_files"):
        assert getattr(fn.MiniFaunaDB, name) == \
            getattr(ref_fn.MiniFaunaDB, name), name
    assert sorted(fn.WORKLOADS) == sorted(ref_fn.WORKLOADS)
    assert fn.DEVICE_WORKLOADS == ("register",)
    assert fn.MonotonicClient.REF == ref_fn.MonotonicClient.REF
    assert fn._FaunaBase.retry_excs == (OSError, fn.FaunaError)


def test_source_is_the_references_and_imports_neither_package():
    assert fn.MINIFAUNA_SRC == ref_fn.MINIFAUNA_SRC
    mods = src_imports(fn.MINIFAUNA_SRC)
    assert {"http", "json", "base64"} <= mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


def zip_steps(mod):
    db = mod.FaunaDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in ("n1", "n2")
            for f in ("setup", "kill", "start", "teardown")], \
        db.log_files(test, "n1"), \
        [mod.FaunaDB.fauna_yml(test, n) for n in test["nodes"]]


def test_zip_commands_match_reference(monkeypatch):
    # the zip steps wait for Fauna's port: nothing listens here
    from jepsen_tpu.control import nodeutil as ref_nodeutil
    from jepsen_tpu_torch.control import nodeutil
    for m in (nodeutil, ref_nodeutil):
        monkeypatch.setattr(m, "await_tcp_port", lambda *a, **kw: None)
    steps, files, ymls = zip_steps(fn)
    ref_steps, ref_files, ref_ymls = zip_steps(ref_fn)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert (files, ymls) == (ref_files, ref_ymls)


def test_mini_db_commands_match_reference():
    """The mini server's lifecycle: the same commands on the same ports,
    the secret among its arguments."""
    def steps(mod):
        db = mod.MiniFaunaDB()
        test = {"nodes": ["f1", "f2"], "fauna_ports": {"f1": 40000,
                                                       "f2": 40001}}
        return [("f2", (lambda f=f: getattr(db, f)(test, "f2")))
                for f in ("setup", "kill", "start", "pause", "resume",
                          "teardown")]
    got = dummy_log(c, DummyRemote, steps(fn))
    assert got == dummy_log(ref_c, RefDummyRemote, steps(ref_fn))
    assert any(fn.SECRET in str(x) for _, x in got)


@pytest.mark.parametrize("which", sorted(fn.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(fn, gen, testlib, which)
    assert got == workload_ops(ref_fn, ref_gen, ref_testlib, which)
    assert len(got) == 40


def checker_histories(hist_cls, inv, okd):
    """The reference tests' checker histories, built with one package's
    History and ops: (name, checker name, history)."""
    return [
        ("pages-good", "PagesChecker", hist_cls([
            inv(0, "add", [1, 2]), okd(0, "add", [1, 2]),
            inv(1, "add", [3]), okd(1, "add", [3]),
            inv(2, "read", None), okd(2, "read", [1, 2, 3]),
            inv(3, "read", None), okd(3, "read", [3])]).index()),
        ("pages-torn", "PagesChecker", hist_cls([
            inv(0, "add", [1, 2]), okd(0, "add", [1, 2]),
            inv(1, "read", None), okd(1, "read", [1])]).index()),
        ("pages-unknown", "PagesChecker", hist_cls([
            inv(0, "add", [1]), okd(0, "add", [1]),
            inv(1, "read", None), okd(1, "read", [1, 9])]).index()),
        ("monotonic-good", "MonotonicChecker", hist_cls([
            inv(0, "inc", None), okd(0, "inc", [1, 1]),
            inv(1, "read", [1, None]), okd(1, "read", [1, 1]),
            inv(0, "inc", None), okd(0, "inc", [5, 2])]).index()),
        ("monotonic-back", "MonotonicChecker", hist_cls([
            inv(0, "inc", None), okd(0, "inc", [1, 5]),
            inv(1, "read", [3, None]), okd(1, "read", [3, 2])]).index()),
    ]


def test_checkers_match_reference():
    port = checker_histories(History, invoke, ok)
    ref = checker_histories(RefHistory, ref_invoke, ref_ok)
    verdicts = []
    for (name, chk, h), (_, _, rh) in zip(port, ref):
        got = getattr(fn, chk)().check({}, h, {})
        assert got == getattr(ref_fn, chk)().check({}, rh, {}), name
        verdicts.append(got["valid?"])
    assert verdicts[:2] == [True, False] and verdicts[3:] == [True, False]


def test_secret_sent_as_the_references_client_sends_it(monkeypatch):
    """The session's Authorization header: the same basic-auth secret as
    the reference's `requests` session carries, sent with every query."""
    requests = pytest.importorskip("requests")
    sent = {}
    for mod, cls in ((fn, httpclient.Session), (ref_fn, requests.Session)):
        monkeypatch.setattr(mod.FaunaConn, "query", lambda self, e: None)
        conn = mod.FaunaConn("127.0.0.1", 1, secret="s3")
        assert isinstance(conn.http, cls)
        sent[mod.__name__] = conn.http.headers["Authorization"]
    assert len(set(sent.values())) == 1
    assert sent[fn.__name__] == "Basic " + base64.b64encode(b"s3:").decode()


# (client, its ops: (f, value), a ("kv", k, v) value made each package's
# `[k v]` tuple): the register's, the set's, the pages' and the monotonic
# register's
CLIENT_OPS = {
    "RegisterClient": [("read", ("kv", 1, None)), ("write", ("kv", 1, 3)),
                       ("cas", ("kv", 1, [3, 4]))],
    "SetClient": [("add", 3), ("read", None)],
    "PagesClient": [("add", ("kv", 0, [1, 2])), ("read", ("kv", 0, None))],
    "MonotonicClient": [("inc", None), ("read", None), ("read", [3, None])],
}
FAULTS = ("refused", "reset", "timeout", "http-500")


def fault_completions(mod, name: str, base: str) -> list:
    """The completions of client `name` of `mod` on a connection to
    `base` (a `fault_url`): (type, value, whether an error was given,
    whether the client still holds the connection). The connection is
    made as `FaunaConn` makes it, less its first probe, which a faulty
    server would fail."""
    import requests
    addr = urlsplit(base)
    cl = getattr(mod, name)(port_fn=lambda test, node: (
        addr.hostname, addr.port), timeout=0.3).open({}, "f1")
    out = []
    for f, v in CLIENT_OPS[name]:
        conn = object.__new__(mod.FaunaConn)
        conn.base, conn.timeout = base, 0.3
        conn.http = (httpclient.Session() if mod is fn
                     else requests.Session())
        conn.http.headers["Authorization"] = "Basic c2VjcmV0Og=="
        cl.conn = conn
        if isinstance(v, tuple):
            v = (tuple_ if mod is fn else ref_independent.tuple_)(v[1], v[2])
        done = cl.invoke({"nodes": ["f1"]}, {"type": "invoke", "f": f,
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
        got = fault_completions(fn, name, base)
        assert got == fault_completions(ref_fn, name, base)
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
    test = fn.fauna_test(_options(tmp_path_factory.mktemp("fauna"),
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
    assert any(o.process == "nemesis" and o.value == {"f1": "killed"}
               for o in hist)
    assert any(o.f == "cas" and o.is_ok for o in hist)


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert fn.MINI_BASE_PORT == 32000
    assert fn.MINI_BASE_PORT != ref_fn.MINI_BASE_PORT
    # below the ephemeral range, clear of the reference's bases
    # (21850-30680), with room for five nodes and the twin fixtures
    lo, _ = ephemeral_range()
    assert 30680 < fn.MINI_BASE_PORT and fn.MINI_BASE_PORT + 50 <= lo
    assert all(fn.MINI_BASE_PORT + 5 <= p < fn.MINI_BASE_PORT + 50
               for p in FIXTURE_PORTS)
    test = {"nodes": ["f1", "f2"]}
    assert [fn.mini_node_port(test, n) for n in test["nodes"]] == \
        [fn.MINI_BASE_PORT, fn.MINI_BASE_PORT + 1]
    assert fn.mini_node_port({**test, "fauna_ports": {"f2": 4000}},
                             "f2") == 4000
    for which in fn.WORKLOADS:
        t = fn.fauna_test(_options(tmp_path, which, nodes=["f1", "f2"]))
        assert t["store_root"] == str(tmp_path / "store")
        assert t["db"].port(t, "f2") == fn.MINI_BASE_PORT + 1
        # every worker drives the primary's server (`_conn` pins it)
        assert t["client"].port_fn(t, "f2") == ("127.0.0.1",
                                                fn.MINI_BASE_PORT + 1)
        assert t["client"].pin_primary is True
    t = fn.fauna_test({"nodes": ["f1"], "concurrency": 2, "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["name"] == "fauna-register-mini"


def test_device_reaches_the_checks(tmp_path):
    for server in ("mini", "zip"):
        for which in fn.WORKLOADS:
            t = fn.fauna_test({**_options(tmp_path, which),
                               "server": server})
            chk = t["checker"].checker_map[which]
            if which in fn.DEVICE_WORKLOADS:
                lin = chk.checker.checker_map["linear"]
                assert lin.device == torch.device("cpu")
                assert lin.algorithm == "competition"
                assert lin.model == cas_register()
            else:
                assert getattr(chk, "device", None) is None, which


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "zip"):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn.fauna_test({**_options(tmp_path, "register"),
                           "server": server, "device": None})
    # the sweep resolves it before it makes its first test
    with pytest.raises(RuntimeError, match="CUDA"):
        next(fn.fauna_tests({**_options(tmp_path, None), "device": None}))
    assert not (tmp_path / "cluster").exists()
    # a workload whose check runs on the host needs no card
    t = fn.fauna_test({**_options(tmp_path, "pages"), "device": None})
    assert t["name"] == "fauna-pages-mini"
