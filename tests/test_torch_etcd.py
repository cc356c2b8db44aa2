"""The port's etcd suite (`jepsen_tpu_torch/dbs/etcd.py`), held against
the JAX package: the twins of `tests/test_etcd.py` (the v3-gateway client
against the reference test's in-process stub, now through the port's
`httpclient`; the DB's commands through the dummy remote; the whole
workload x nemesis matrix against the stub; a live mini-etcd register
run under kill -9), and parity cases: the DB's commands and the embedded
server equal to the reference's, one live `register` history judged key
by key by both packages' `wgl` oracle, one live `append` history judged
by both packages' Elle, and the HTTP client's failures (a refused
connection, a timeout, a non-2xx reply) classified as the reference's
`requests`-based client classifies them.

Also: the port's ports and store root are its own, the `device` option
reaches the register, append and wr checkers, and a missing card raises
before any node is set up. The suites check on the CPU
(`device="cpu"`).
"""

import ast
import os
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import checker as ref_checker
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import etcd as ref_etcd
from jepsen_tpu.elle import append as ref_append
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu_torch import checker, core, independent, store
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import etcd
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.independent import tuple_
from jepsen_tpu_torch.models import cas_register
from test_etcd import EtcdStub
from test_torch_httpclient import fault_url
from test_torch_sqlite import ephemeral_range

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def stub():
    EtcdStub.data = {}
    EtcdStub.rev = [0]
    srv = ThreadingHTTPServer(("127.0.0.1", 0), EtcdStub)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


# -- the twins of tests/test_etcd.py ----------------------------------------

def test_client_read_write_cas(stub):
    cl = etcd.EtcdClient(base_url_fn=lambda node: stub).open({}, "n1")
    op = {"type": "invoke", "f": "read", "value": tuple_(7, None),
          "process": 0}
    assert cl.invoke({}, op)["value"] == tuple_(7, None)

    w = {"type": "invoke", "f": "write", "value": tuple_(7, 3),
         "process": 0}
    assert cl.invoke({}, w)["type"] == "ok"
    assert cl.invoke({}, op)["value"] == tuple_(7, 3)

    cas_ok = {"type": "invoke", "f": "cas", "value": tuple_(7, [3, 4]),
              "process": 0}
    cas_fail = {"type": "invoke", "f": "cas", "value": tuple_(7, [3, 5]),
                "process": 0}
    assert cl.invoke({}, cas_ok)["type"] == "ok"
    assert cl.invoke({}, cas_fail)["type"] == "fail"
    assert cl.invoke({}, op)["value"] == tuple_(7, 4)
    cl.close({})


def test_client_down_node_errors_are_contained():
    cl = etcd.EtcdClient(
        base_url_fn=lambda node: "http://127.0.0.1:1",
        timeout=0.2).open({}, "n1")
    r = cl.invoke({}, {"type": "invoke", "f": "read",
                       "value": tuple_(1, None), "process": 0})
    assert r["type"] == "fail"
    w = cl.invoke({}, {"type": "invoke", "f": "write",
                       "value": tuple_(1, 2), "process": 0})
    assert w["type"] == "info"


def db_commands(ctl, remote_cls, mod) -> tuple:
    test = {"nodes": ["n1", "n2", "n3"]}
    log: list = []
    db = mod.EtcdDB()
    with ctl.with_remote(remote_cls(log)):
        with ctl.on("n1"):
            db.setup(test, "n1")
            db.kill(test, "n1")
            db.teardown(test, "n1")
    return log, db.log_files(test, "n1")


def test_db_setup_teardown_commands():
    log, files = db_commands(c, DummyRemote, etcd)
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "/opt/etcd" in joined
    assert etcd.tarball_url(etcd.VERSION).split("/")[-1].split(".tar")[0] \
        .startswith("etcd-v")
    start = next(x for x in cmds if "--initial-cluster " in x)
    for n in ("n1", "n2", "n3"):
        assert f"{n}=http://{n}:2380" in start
    assert "--name n1" in start
    assert any("rm -rf" in x and "/opt/etcd/data" in x for x in cmds)
    assert files == [etcd.LOGFILE]


def test_full_suite_with_stub(stub, tmp_path):
    opts = {"nodes": ["n1", "n2"], "concurrency": 4,
            "time_limit": 4, "per_key_limit": 15,
            "store_root": str(tmp_path / "store"),
            "ssh": {"dummy?": True}, "device": "cpu"}
    t = etcd.etcd_test(opts)
    t["client"] = etcd.EtcdClient(base_url_fn=lambda node: stub)
    t["name"] = "etcd-stub"
    done = core.run(t)
    assert done["results"]["valid?"] is True
    indep = done["results"]["register"]
    assert indep["valid?"] is True
    completions = [op for op in done["history"]
                   if getattr(op, "type", None) in ("ok", "fail")]
    assert completions


def test_txn_mops_atomic_append(stub):
    cl = etcd.EtcdClient(base_url_fn=lambda node: stub).open({}, "n1")
    done = cl.txn_mops([["append", 1, 10], ["append", 2, 20],
                        ["r", 1, None]])
    assert done == [["append", 1, 10], ["append", 2, 20],
                    ["r", 1, [10]]]
    done = cl.txn_mops([["r", 1, None], ["r", 2, None]])
    assert done == [["r", 1, [10]], ["r", 2, [20]]]


def test_txn_mops_contention_retries(stub):
    cl = etcd.EtcdClient(base_url_fn=lambda node: stub).open({}, "n1")
    real_snapshot = cl.kv_snapshot
    hits = {"n": 0}

    def racing_snapshot(keys):
        snap = real_snapshot(keys)
        if hits["n"] == 0:
            hits["n"] += 1
            cl.kv_put("/jepsen/7", "[99]")
        return snap

    cl.kv_snapshot = racing_snapshot
    done = cl.txn_mops([["append", 7, 1]])
    assert done == [["append", 7, 1]]
    assert hits["n"] == 1
    cl.kv_snapshot = real_snapshot
    done = cl.txn_mops([["r", 7, None]])
    assert done == [["r", 7, [99, 1]]]


def test_full_append_suite_with_stub(stub, tmp_path):
    opts = {"nodes": ["n1", "n2"], "concurrency": 4,
            "time_limit": 4, "workload": "append",
            "store_root": str(tmp_path / "store"),
            "ssh": {"dummy?": True}, "device": "cpu"}
    t = etcd.etcd_test(opts)
    t["client"] = etcd.EtcdClient(base_url_fn=lambda node: stub)
    t["name"] = "etcd-append-stub"
    done = core.run(t)
    assert done["results"]["valid?"] is True
    txns = [op for op in done["history"]
            if getattr(op, "type", None) == "ok"
            and getattr(op, "f", None) == "txn"]
    assert txns


def _matrix_opts(stub, tmp_path, **kw):
    return {"nodes": ["n1", "n2"], "concurrency": 4,
            "time_limit": kw.pop("time_limit", 4),
            "store_root": str(tmp_path / "store"),
            "ssh": {"dummy?": True}, "device": "cpu", **kw}


def _run_suite(stub, tmp_path, workload, client_cls, **kw):
    t = etcd.etcd_test(_matrix_opts(stub, tmp_path, workload=workload,
                                    **kw))
    t["client"] = client_cls(base_url_fn=lambda node: stub)
    return core.run(t)


def test_wr_suite_with_stub(stub, tmp_path):
    done = _run_suite(stub, tmp_path, "wr", etcd.EtcdClient)
    assert done["results"]["valid?"] is True
    assert done["results"]["wr"]["valid?"] is True


def test_bank_suite_with_stub(stub, tmp_path):
    done = _run_suite(stub, tmp_path, "bank", etcd.EtcdBankClient)
    assert done["results"]["valid?"] is True
    assert done["results"]["bank"]["valid?"] is True
    reads = [op for op in done["history"]
             if getattr(op, "type", None) == "ok"
             and getattr(op, "f", None) == "read"]
    assert reads and all(
        sum(v for v in op.value.values() if v is not None) == 100
        for op in reads)


def test_sets_suite_with_stub(stub, tmp_path):
    done = _run_suite(stub, tmp_path, "sets", etcd.EtcdSetClient,
                      time_limit=5)
    assert done["results"]["valid?"] is True
    assert done["results"]["sets"]["valid?"] is True


def test_long_fork_suite_with_stub(stub, tmp_path):
    done = _run_suite(stub, tmp_path, "long-fork", etcd.EtcdClient)
    assert done["results"]["valid?"] is True
    assert done["results"]["long-fork"]["valid?"] is True


def test_nemesis_matrix_kill_mode(stub, tmp_path):
    done = _run_suite(stub, tmp_path, "register", etcd.EtcdClient,
                      nemesis="kill", per_key_limit=15)
    assert done["results"]["valid?"] is True


def test_tests_fn_sweeps_matrix(tmp_path):
    opts = {"nodes": ["n1"], "concurrency": 2,
            "store_root": str(tmp_path / "store"),
            "ssh": {"dummy?": True}, "device": "cpu"}
    names = [t["name"] for t in etcd.etcd_tests(opts)]
    assert len(names) == len(etcd.WORKLOADS) * len(etcd.NEMESES)
    assert "etcd-bank-partition" in names
    assert "etcd-long-fork-none" in names
    only = [t["name"] for t in
            etcd.etcd_tests({**opts, "workload": "register"})]
    assert len(only) == len(etcd.NEMESES)
    assert names == [t["name"] for t in ref_etcd.etcd_tests(
        {k: v for k, v in opts.items() if k != "device"})]


def test_monotonic_suite_with_stub(stub, tmp_path):
    done = _run_suite(stub, tmp_path, "monotonic",
                      etcd.EtcdMonotonicClient)
    assert done["results"]["valid?"] is True, \
        done["results"]["monotonic"]
    incs = [op for op in done["history"]
            if getattr(op, "type", None) == "ok"
            and getattr(op, "f", None) == "inc"]
    assert incs


def test_sequential_suite_with_stub(stub, tmp_path):
    done = _run_suite(stub, tmp_path, "sequential", etcd.EtcdSeqClient)
    assert done["results"]["valid?"] is True, \
        done["results"]["sequential"]


def _live_options(tmp_path, **kw):
    return {"nodes": ["t1"], "concurrency": 4,
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "server": "mini", "per_key_limit": 40,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.fixture(scope="module")
def register_run(tmp_path_factory):
    """The reference test's live register run (`test_full_suite_live_mini`:
    one node, 4 workers, 40 ops a key, kill/restart every 2.5 s, 8 s),
    its generator seeded: its test map and what `core.run` returned."""
    gen.RNG.seed(22)
    test = etcd.etcd_test(_live_options(
        tmp_path_factory.mktemp("register")))
    return test, core.run(test)


def test_full_suite_live_mini(register_run):
    """LIVE mini-etcd processes under the kill/restart nemesis: the
    fsync'd revision log must carry acknowledged writes across
    kill -9 (register + CAS over real mod revisions)."""
    _, done = register_run
    res = done["results"]
    assert res["valid?"] is True, res


# -- parity and the port's own choices ---------------------------------------

def test_db_commands_match_reference():
    log, files = db_commands(c, DummyRemote, etcd)
    ref_log, ref_files = db_commands(ref_c, RefDummyRemote, ref_etcd)
    assert log == ref_log and files == ref_files


def test_server_src_is_the_references_and_imports_neither_package():
    assert etcd.MINIETCD_SRC == ref_etcd.MINIETCD_SRC
    mods = set()
    for node in ast.walk(ast.parse(etcd.MINIETCD_SRC)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "http" in mods and not mods & {
        "jepsen_tpu", "jepsen_tpu_torch", "jax", "torch", "requests"}


def ref_kv_history(ops) -> RefHistory:
    """The port's ops as the reference's History, [k v] tuples made the
    reference's (`KV` is each package's own class)."""
    out = []
    for o in ops:
        d = o.to_dict()
        if isinstance(o.value, independent.KV):
            d["value"] = ref_independent.KV(o.value.k, o.value.v)
        out.append(RefOp.from_dict(d))
    return RefHistory(out).index()


def kv_of(value):
    """A stored `[k v]` tuple value (the store writes its repr) as a `KV`
    again; any other value unchanged."""
    if not (isinstance(value, str) and value.startswith("[")
            and value.endswith("]") and " " in value):
        return value
    k, v = value[1:-1].split(" ", 1)
    return tuple_(ast.literal_eval(k), ast.literal_eval(v))


def test_live_register_history_matches_reference(register_run):
    """The live register history, read back from the store, judged key by
    key by the port's `wgl` oracle and by the reference's: equal verdicts
    on every key, equal to the suite's own (the competition race, on the
    CPU)."""
    test, done = register_run
    stored = store.load_latest(test["store_root"])
    hist = History([{**o, "value": kv_of(o.get("value"))}
                    for o in stored["history"]]).index()
    assert [o.to_dict() for o in hist] == \
        [o.to_dict() for o in done["history"]]
    port = independent.checker(checker.linearizable(
        cas_register(), algorithm="wgl", device="cpu")).check(
            {"name": "etcd-oracle"}, hist, {})
    ref = ref_independent.checker(ref_checker.linearizable(
        ref_cas_register(), algorithm="wgl")).check(
            {"name": "etcd-oracle"}, ref_kv_history(hist), {})
    suite = done["results"]["register"]["results"]
    verdicts = {k: r["valid?"] for k, r in port["results"].items()}
    assert verdicts == {k: r["valid?"] for k, r in ref["results"].items()}
    assert verdicts == {k: r["valid?"] for k, r in suite.items()}
    assert len(verdicts) >= 3 and all(v is True for v in verdicts.values())


@pytest.fixture(scope="module")
def append_run(tmp_path_factory):
    """A live append run (one node, 4 workers, kill/restart every 2 s,
    4 s, the generator seeded)."""
    gen.RNG.seed(22)
    test = etcd.etcd_test(_live_options(
        tmp_path_factory.mktemp("append"), workload="append",
        time_limit=4, nemesis_interval=2.0))
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


@pytest.mark.parametrize("fault", ("refused", "timeout", "http-500"))
def test_http_failures_classified_as_reference(fault):
    """The port's client (on `httpclient`) and the reference's (on
    `requests`) against the same fault: a read fails, a write, a cas and
    a txn are indefinite, each with an error; a 500's error text is
    `requests`' own."""
    ops = [("read", None), ("write", 3), ("cas", [1, 2])]
    with fault_url(fault) as base:
        got = {}
        for name, mod, tup in (("port", etcd, tuple_),
                               ("ref", ref_etcd, ref_independent.tuple_)):
            cl = mod.EtcdClient(base_url_fn=lambda node: base,
                                timeout=0.3).open({}, "n1")
            got[name] = [cl.invoke({}, {"type": "invoke", "f": f,
                                        "value": tup(1, v), "process": 0})
                         for f, v in ops]
            got[name].append(cl.invoke({}, {
                "type": "invoke", "f": "txn", "process": 0,
                "value": [["append", 1, 5]]}))
            cl.close({})
    for p, r in zip(got["port"], got["ref"]):
        assert p["type"] == r["type"] and p["error"] and r["error"]
    assert [o["type"] for o in got["port"]] == \
        ["fail", "info", "info", "info"]
    if fault == "http-500":
        assert [o["error"] for o in got["port"]] == \
            [o["error"] for o in got["ref"]]


def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert etcd.MINI_BASE_PORT == 30700
    assert etcd.MINI_BASE_PORT != ref_etcd.MINI_BASE_PORT
    # below the ephemeral range (a client retrying a down server's port
    # there can connect to itself and hold it), and clear of the
    # reference's bases (21850-30680) with room for five nodes
    lo, _ = ephemeral_range()
    assert 30680 < etcd.MINI_BASE_PORT and etcd.MINI_BASE_PORT + 5 < lo
    test = {"nodes": ["t1", "t2"]}
    assert [etcd.mini_node_port(test, n) for n in test["nodes"]] == \
        [etcd.MINI_BASE_PORT, etcd.MINI_BASE_PORT + 1]
    assert etcd.mini_node_port({**test, "etcd_ports": {"t2": 4000}},
                               "t2") == 4000
    t = etcd.etcd_test({"nodes": ["t1"], "concurrency": 2,
                        "server": "mini", "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["client"].base_url_fn("t1") == "http://127.0.0.1:30700"


@pytest.mark.parametrize("which", ["register", "append", "wr"])
def test_device_reaches_the_checkers(tmp_path, which):
    t = etcd.etcd_test(_live_options(tmp_path, workload=which))
    chk = t["checker"].checker_map[which]
    if which == "register":
        chk = chk.checker.checker_map["linear"]
    assert chk.device == torch.device("cpu")


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for which in sorted(etcd.WORKLOADS):
        with pytest.raises(RuntimeError, match="CUDA"):
            etcd.etcd_test({**_live_options(tmp_path, workload=which),
                            "device": None})
    assert not (tmp_path / "cluster").exists()


@pytest.mark.slow  # ~50 s on the CPU: the analysis of ~300 keys
def test_cli_register_run_on_the_cpu(tmp_path):
    """`python -m jepsen_tpu_torch.dbs.etcd test ... --device cpu` exits
    0 with the suite valid; without `--device` and without a card it
    exits 255 before any node is set up."""
    args = [sys.executable, "-m", "jepsen_tpu_torch.dbs.etcd", "test",
            "--nodes", "t1", "--server", "mini", "--workload", "register",
            "--time-limit", "5", "--store-root", str(tmp_path / "store"),
            "--sandbox", str(tmp_path / "cluster")]
    env = {**os.environ, "PYTHONPATH": REPO}
    done = subprocess.run(args + ["--device", "cpu"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "'valid?': True" in done.stderr + done.stdout
    if not torch.cuda.is_available():
        sandbox = tmp_path / "cluster2"
        done = subprocess.run(args[:-2] + ["--sandbox", str(sandbox)],
                              cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=300)
        assert done.returncode == 255 and "CUDA" in done.stderr
        assert not sandbox.exists()
