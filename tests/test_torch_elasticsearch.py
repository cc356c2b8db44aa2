"""The port's elasticsearch suite (`jepsen_tpu_torch/dbs/
elasticsearch.py`), held against the JAX package: the twins of
`tests/test_elasticsearch.py` (the set client against the reference
test's in-process REST stub, now through the port's `httpclient`; the
refresh gate; the DB's commands through the dummy remote; the full suite
and the lossy counterexample against the stub and against live mini
servers, the lossy live run slow as its reference twin), and parity
cases: the DB's commands and the embedded server equal to the
reference's, one live run's history judged by both packages' set
checkers with equal results, and the HTTP client's failures (a refused
connection, a timeout, a non-2xx reply) classified as the reference's
`requests`-based client classifies them.

Also: the port's ports and store root are its own; the suite has no
`device` option (its checks reach no kernel).
"""

import ast
import os
import threading
from http.server import ThreadingHTTPServer

import pytest

import jepsen_tpu.control as ref_c
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import elasticsearch as ref_es
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.workloads import sets as ref_sets
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import elasticsearch as es
from jepsen_tpu_torch.dbs import httpclient
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.workloads import sets
from test_elasticsearch import EsStub
from test_torch_httpclient import fault_url
from test_torch_sqlite import ephemeral_range


@pytest.fixture()
def stub():
    EsStub.docs = {}
    EsStub.indices = set()
    EsStub.searchable = set()
    EsStub.lossy_every = 0
    EsStub.acked = [0]
    srv = ThreadingHTTPServer(("127.0.0.1", 0), EsStub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _client(stub):
    return es.EsSetClient(base_url_fn=lambda node: stub).open({}, "n1")


# -- the twins of tests/test_elasticsearch.py ------------------------------

def test_add_and_refresh_scan(stub):
    cl = _client(stub)
    for v in (3, 1, 2):
        assert cl.invoke({}, {"f": "add", "value": v,
                              "process": 0})["type"] == "ok"
    r = cl.invoke({}, {"f": "read", "value": None, "process": 0})
    assert r["type"] == "ok" and r["value"] == [1, 2, 3]


def test_unrefreshed_docs_invisible_until_read(stub):
    cl = _client(stub)
    cl.invoke({}, {"f": "add", "value": 9, "process": 0})
    raw = httpclient.get(stub + "/jepsen/_search",
                         params={"size": 10}, timeout=2).json()
    assert raw["hits"]["hits"] == []
    r = cl.invoke({}, {"f": "read", "value": None, "process": 0})
    assert r["value"] == [9]


def db_commands(ctl, remote_cls, mod) -> tuple:
    log: list = []
    db = mod.ElasticsearchDB()
    test = {"nodes": ["n1", "n2"]}
    with ctl.with_remote(remote_cls(log)):
        with ctl.on("n1"):
            db.setup(test, "n1")
            db.teardown(test, "n1")
    return log, db.log_files(test, "n1")


def test_db_commands():
    log, _ = db_commands(c, DummyRemote, es)
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "elasticsearch" in joined
    assert "unicast.hosts" in joined and "n2" in joined


def _stub_options(tmp_path, **kw):
    return {"nodes": ["n1", "n2"], "concurrency": 4, "time_limit": 4,
            "server": "deb", "store_root": str(tmp_path / "store"),
            "ssh": {"dummy?": True}, **kw}


def test_full_suite_with_stub(stub, tmp_path):
    t = es.elasticsearch_test(_stub_options(tmp_path))
    t["client"] = es.EsSetClient(base_url_fn=lambda node: stub)
    t["name"] = "es-stub"
    done = core.run(t)
    assert done["results"]["valid?"] is True
    assert done["results"]["sets"]["valid?"] is True


def test_lossy_stub_caught(stub, tmp_path):
    EsStub.lossy_every = 5
    t = es.elasticsearch_test(_stub_options(
        tmp_path, nodes=["n1"], concurrency=2, time_limit=3))
    t["client"] = es.EsSetClient(base_url_fn=lambda node: stub)
    t["name"] = "es-lossy"
    done = core.run(t)
    sets_res = done["results"]["sets"]
    assert sets_res["valid?"] is False
    assert sets_res["set"]["lost-count"] > 0


def _mini_options(tmp_path, **kw):
    return {"nodes": kw.pop("nodes", ["e1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), **kw}


@pytest.fixture(scope="module")
def live_run(tmp_path_factory):
    """The reference test's live run (one node, 4 workers, kill/restart
    every 2.5 s, 8 s): what `core.run` returned."""
    return core.run(es.elasticsearch_test(_mini_options(
        tmp_path_factory.mktemp("live"))))


def test_full_suite_live(live_run):
    """LIVE mini-ES processes under the kill/restart nemesis: the
    fsync'd translog must carry acknowledged docs across kill -9,
    and the refresh gate must rebuild searchability after restart."""
    res = live_run["results"]
    assert res["valid?"] is True, res


@pytest.mark.slow  # as its reference twin (tests/test_elasticsearch.py)
def test_lossy_live_caught(tmp_path):
    done = core.run(es.elasticsearch_test(_mini_options(
        tmp_path, lossy_every=5, nemesis_interval=60.0)))
    sets_res = done["results"]["sets"]
    assert sets_res["valid?"] is False
    assert sets_res["set"]["lost-count"] > 0


# -- parity and the port's own choices ---------------------------------------

def test_db_commands_match_reference():
    assert db_commands(c, DummyRemote, es) == \
        db_commands(ref_c, RefDummyRemote, ref_es)


def test_server_src_is_the_references_and_imports_neither_package():
    assert es.MINIES_SRC == ref_es.MINIES_SRC
    mods = set()
    for node in ast.walk(ast.parse(es.MINIES_SRC)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "http" in mods and not mods & {
        "jepsen_tpu", "jepsen_tpu_torch", "jax", "torch", "requests"}


def as_data(x):
    if hasattr(x, "to_dict"):
        return x.to_dict()
    if isinstance(x, dict):
        return {k: as_data(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_data(v) for v in x]
    return x


def test_live_history_matches_reference(live_run):
    """The live run's history, judged by the suite's set checkers in
    both packages: equal results, True, with adds acknowledged."""
    hist = live_run["history"]
    port = sets.workload()["checker"].check(
        {}, History(list(hist)).index(), {})
    ref = ref_sets.workload()["checker"].check(
        {}, RefHistory([RefOp.from_dict(o.to_dict()) for o in hist])
        .index(), {})
    assert as_data(port) == as_data(ref)
    assert port["valid?"] is True and port["set"]["ok-count"] > 10


@pytest.mark.parametrize("fault", ("refused", "timeout", "http-500"))
def test_http_failures_classified_as_reference(fault):
    """The port's client (on `httpclient`) and the reference's (on
    `requests`) against the same fault: an add is indefinite and the
    final read fails, each with an error, the same error text on a
    500."""
    with fault_url(fault) as base:
        got = {}
        for name, mod in (("port", es), ("ref", ref_es)):
            cl = mod.EsSetClient(base_url_fn=lambda node: base,
                                 timeout=0.3).open({}, "n1")
            got[name] = [cl.invoke({}, {"type": "invoke", "f": f,
                                        "value": v, "process": 0})
                         for f, v in (("add", 1), ("read", None))]
            cl.close({})
    for p, r in zip(got["port"], got["ref"]):
        assert p["type"] == r["type"] and p["error"] and r["error"]
    assert [o["type"] for o in got["port"]] == ["info", "fail"]
    if fault == "http-500":
        assert [o["error"] for o in got["port"]] == \
            [o["error"] for o in got["ref"]]


def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert es.MINI_BASE_PORT == 30850
    assert es.MINI_BASE_PORT != ref_es.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < es.MINI_BASE_PORT and es.MINI_BASE_PORT + 5 < lo
    test = {"nodes": ["e1", "e2"]}
    assert [es.mini_node_port(test, n) for n in test["nodes"]] == \
        [es.MINI_BASE_PORT, es.MINI_BASE_PORT + 1]
    t = es.elasticsearch_test({"nodes": ["e1", "e2"], "concurrency": 2})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["client"].base_url_fn("e2") == "http://127.0.0.1:30850"
    assert not [o for o in es.ELASTICSEARCH_OPTS if o.name == "device"]
