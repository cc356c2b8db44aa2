"""The port's consul suite (`jepsen_tpu_torch/dbs/consul.py`), held
against the JAX package: the twins of `tests/test_consul.py` (the
index-CAS client against the reference test's in-process v1/kv stub, now
through the port's `httpclient`; the DB's commands through the dummy
remote; the full suite against the stub and against live mini servers
under kill -9 and SIGSTOP), and parity cases: the DB's commands and the
embedded server equal to the reference's, and the HTTP client's failures
(a refused connection, a timeout, a non-2xx reply) classified as the
reference's `requests`-based client classifies them.

Also: the port's ports and store root are its own, the `device` option
reaches the register checker, and a missing card raises before any node
is set up. The suites check on the CPU (`device="cpu"`).
"""

import ast
import os
import threading
from http.server import ThreadingHTTPServer

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import consul as ref_consul
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import consul
from jepsen_tpu_torch.independent import tuple_
from test_consul import ConsulStub
from test_torch_httpclient import fault_url
from test_torch_sqlite import ephemeral_range


@pytest.fixture()
def stub():
    ConsulStub.data = {}
    ConsulStub.index = [0]
    srv = ThreadingHTTPServer(("127.0.0.1", 0), ConsulStub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/v1/kv/"
    srv.shutdown()
    srv.server_close()


def _client(stub):
    return consul.ConsulClient(
        base_url_fn=lambda node: stub).open({}, "n1")


# -- the twins of tests/test_consul.py ----------------------------------------

def test_read_write_cas(stub):
    cl = _client(stub)
    rd = {"type": "invoke", "f": "read", "value": tuple_(1, None),
          "process": 0}
    assert cl.invoke({}, rd)["value"] == tuple_(1, None)
    assert cl.invoke({}, {"f": "write", "value": tuple_(1, 4),
                          "process": 0})["type"] == "ok"
    assert cl.invoke({}, rd)["value"] == tuple_(1, 4)
    assert cl.invoke({}, {"f": "cas", "value": tuple_(1, [4, 9]),
                          "process": 0})["type"] == "ok"
    assert cl.invoke({}, {"f": "cas", "value": tuple_(1, [4, 2]),
                          "process": 0})["type"] == "fail"
    assert cl.invoke({}, rd)["value"] == tuple_(1, 9)


def test_index_cas_detects_interleaved_write(stub):
    cl = _client(stub)
    cl.kv_put("k", 1)
    val, idx = cl.kv_get("k")
    assert (val, idx > 0) == ("1", True)
    cl.kv_put("k", 2)
    cl.kv_put("k", 1)
    assert cl.kv_put("k", 3, cas=idx) is False
    assert cl.kv_get("k")[0] == "1"


def db_commands(ctl, remote_cls, mod) -> tuple:
    log: list = []
    db = mod.ConsulDB()
    test = {"nodes": ["n1", "n2"]}
    with ctl.with_remote(remote_cls(log)):
        with ctl.on("n1"):
            db.setup(test, "n1")
        with ctl.on("n2"):
            db.setup(test, "n2")
        with ctl.on("n1"):
            db.teardown(test, "n1")
    return log, db.log_files(test, "n1")


def test_db_commands():
    log, files = db_commands(c, DummyRemote, consul)
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "consul" in joined and "-bootstrap" in joined
    assert "-retry-join n1" in joined
    assert files == [consul.LOGFILE]


def test_full_suite_with_stub(stub, tmp_path):
    opts = {"nodes": ["n1", "n2"], "concurrency": 4, "time_limit": 4,
            "ops_per_key": 15, "rate": 200.0,
            "store_root": str(tmp_path / "store"),
            "ssh": {"dummy?": True}, "device": "cpu"}
    t = consul.consul_test(opts)
    t["client"] = consul.ConsulClient(base_url_fn=lambda node: stub)
    t["name"] = "consul-stub"
    done = core.run(t)
    assert done["results"]["valid?"] is True
    assert done["results"]["register"]["valid?"] is True


def _mini(tmp_path, **kw):
    return {"concurrency": 4, "time_limit": 6, "ops_per_key": 30,
            "rate": 50.0, "nemesis_interval": 2.0, "server": "mini",
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


def test_mini_suite_live_kill(tmp_path):
    """install -> start -> kill -9 -> restart against live v1/kv
    servers; the register stays linearizable."""
    done = core.run(consul.consul_test(_mini(
        tmp_path, nodes=["c1", "c2"], fault="kill")))
    res = done["results"]
    assert res["valid?"] is True, res
    assert res["register"]["valid?"] is True
    nem = [o for o in done["history"] if o.process == "nemesis"
           and o.f == "start" and o.value is not None]
    assert nem, "nemesis never killed anything"


def test_mini_suite_live_pause(tmp_path):
    """SIGSTOP/SIGCONT faults against live servers: paused processes
    stall clients (timeouts -> info), resume recovers, verdict holds."""
    done = core.run(consul.consul_test(_mini(
        tmp_path, nodes=["c1"], fault="pause")))
    res = done["results"]
    assert res["valid?"] is True, res


# -- parity and the port's own choices ---------------------------------------

def test_db_commands_match_reference():
    assert db_commands(c, DummyRemote, consul) == \
        db_commands(ref_c, RefDummyRemote, ref_consul)


def test_server_src_is_the_references_and_imports_neither_package():
    assert consul.MINICONSUL_SRC == ref_consul.MINICONSUL_SRC
    mods = set()
    for node in ast.walk(ast.parse(consul.MINICONSUL_SRC)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "http" in mods and not mods & {
        "jepsen_tpu", "jepsen_tpu_torch", "jax", "torch", "requests"}


@pytest.mark.parametrize("fault", ("refused", "timeout", "http-500"))
def test_http_failures_classified_as_reference(fault):
    """The port's client (on `httpclient`) and the reference's (on
    `requests`) against the same fault: a read fails, a write and a cas
    are indefinite, each with an error; a 500's error text is
    `requests`' own."""
    ops = [("read", None), ("write", 3), ("cas", [1, 2])]
    with fault_url(fault) as base:
        got = {}
        for name, mod, tup in (("port", consul, tuple_),
                               ("ref", ref_consul, ref_independent.tuple_)):
            cl = mod.ConsulClient(base_url_fn=lambda node: base + "/v1/kv/",
                                  timeout=0.3).open({}, "n1")
            got[name] = [cl.invoke({}, {"type": "invoke", "f": f,
                                        "value": tup(1, v), "process": 0})
                         for f, v in ops]
            cl.close({})
    for p, r in zip(got["port"], got["ref"]):
        assert p["type"] == r["type"] and p["error"] and r["error"]
    assert [o["type"] for o in got["port"]] == ["fail", "info", "info"]
    if fault == "http-500":
        assert [o["error"] for o in got["port"]] == \
            [o["error"] for o in got["ref"]]


def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert consul.MINI_BASE_PORT == 30750
    assert consul.MINI_BASE_PORT != ref_consul.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < consul.MINI_BASE_PORT and consul.MINI_BASE_PORT + 5 < lo
    test = {"nodes": ["c1", "c2"]}
    assert [consul.mini_node_port(test, n) for n in test["nodes"]] == \
        [consul.MINI_BASE_PORT, consul.MINI_BASE_PORT + 1]
    t = consul.consul_test(_mini(tmp_path, nodes=["c1", "c2"]))
    assert t["store_root"] == str(tmp_path / "store")
    # the clients reach the servers' own ports
    assert [t["client"].base_url_fn(n) for n in ("c1", "c2")] == \
        [f"http://127.0.0.1:{consul.MINI_BASE_PORT + i}/v1/kv/"
         for i in range(2)]
    t = consul.consul_test({"nodes": ["c1"], "concurrency": 2,
                            "server": "mini", "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")


def test_device_reaches_the_checker(tmp_path):
    t = consul.consul_test(_mini(tmp_path, nodes=["c1"]))
    lin = t["checker"].checker_map["register"].checker.checker_map["linear"]
    assert lin.device == torch.device("cpu")
    assert lin.algorithm == "competition"


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "release"):
        with pytest.raises(RuntimeError, match="CUDA"):
            consul.consul_test({**_mini(tmp_path, nodes=["c1"]),
                                "server": server, "device": None})
    assert not (tmp_path / "cluster").exists()
