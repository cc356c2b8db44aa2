"""The port's mongodb suite (`jepsen_tpu_torch/dbs/mongodb.py`), held
against the JAX package: the twins of `tests/test_mongodb.py` (the BSON
subset codec and OP_MSG framing, the document-CAS and logger clients
against the reference test's wire-compatible stub, the DB's commands
through the dummy remote, the storage-engine and SmartOS axes, the full
suite over the stub and live mini OP_MSG servers under kill -9), and
parity cases: BSON bytes and OP_MSG frames, the embedded server, the
DB's commands, the logger's generated ops and the register check's
verdicts on the same histories (valid, and with one stale read) equal
to the reference's.

Also: the port's ports and store root are its own, the `device` option
reaches the register check, and a missing card raises before any node is
set up. The suites check on the CPU (`device="cpu"`).
"""

import ast
import io
import os
import struct
import threading

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import mongodb as ref_mdb
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import mongodb as mdb
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.independent import tuple_
from test_mongodb import MongoStub, MongoStubHandler
from test_torch_sqlite import ephemeral_range


# -- codec --------------------------------------------------------------------

def test_bson_roundtrip():
    doc = {"int": 7, "big": 2**40, "s": "hi", "b": True, "n": None,
           "d": {"x": 1}, "a": [1, "two", {"y": False}],
           "f": 2.5}
    out, n = mdb.bson_decode(mdb.bson_encode(doc))
    assert out == doc
    assert n == len(mdb.bson_encode(doc))


def test_bson_golden_bytes():
    assert mdb.bson_encode({"a": 1}) == \
        b"\x0c\x00\x00\x00\x10a\x00\x01\x00\x00\x00\x00"


def test_op_msg_roundtrip():
    msg = mdb.encode_op_msg({"ping": 1, "$db": "admin"}, 42)
    length, rid, rto, opcode = struct.unpack("<iiii", msg[:16])
    assert (length, rid, opcode) == (len(msg), 42, 2013)
    doc = mdb.read_op_msg(io.BytesIO(msg))
    assert doc == {"ping": 1, "$db": "admin"}


# -- the wire-compatible stub (the reference test's) --------------------------

@pytest.fixture()
def stub():
    srv = MongoStub(("127.0.0.1", 0), MongoStubHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()
    srv.server_close()


def _client(stub):
    port = stub.server_address[1]
    return mdb.MongoClient(
        addr_fn=lambda test, node: ("127.0.0.1", port)).open({}, "n1")


def test_document_cas_semantics(stub):
    cl = _client(stub)
    rd = {"type": "invoke", "f": "read", "value": tuple_(1, None),
          "process": 0}
    assert cl.invoke({}, rd)["value"] == tuple_(1, None)
    assert cl.invoke({}, {"f": "write", "value": tuple_(1, 3),
                          "process": 0})["type"] == "ok"
    assert cl.invoke({}, rd)["value"] == tuple_(1, 3)
    assert cl.invoke({}, {"f": "cas", "value": tuple_(1, [3, 5]),
                          "process": 0})["type"] == "ok"
    assert cl.invoke({}, {"f": "cas", "value": tuple_(1, [3, 7]),
                          "process": 0})["type"] == "fail"
    assert cl.invoke({}, rd)["value"] == tuple_(1, 5)
    upd = [d for d in stub.commands if "update" in d]
    assert all(d["writeConcern"] == {"w": "majority"} for d in upd)


def test_client_down_server_contained():
    cl = mdb.MongoClient(
        addr_fn=lambda test, node: ("127.0.0.1", 1),
        timeout=0.2).open({}, "n1")
    assert cl.invoke({}, {"f": "read", "value": tuple_(1, None),
                          "process": 0})["type"] == "fail"
    assert cl.invoke({}, {"f": "write", "value": tuple_(1, 2),
                          "process": 0})["type"] == "info"


def test_db_commands():
    log: list = []
    db = mdb.MongoDB()
    test = {"nodes": ["n1"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.kill(test, "n1")
            db.teardown(test, "n1")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "mongod" in joined
    assert any("rm -rf" in x and "/var/lib/mongodb" in x for x in cmds)
    assert db.log_files(test, "n1") == [mdb.LOGFILE]


@pytest.mark.slow  # the reference twin's mark (tests/test_mongodb.py)
def test_full_suite_with_stub(stub, tmp_path):
    port = stub.server_address[1]
    opts = {"nodes": ["n1", "n2"], "concurrency": 4, "time_limit": 4,
            "per_key_limit": 15, "server": "deb",
            "store_root": str(tmp_path / "store"),
            "ssh": {"dummy?": True}, "device": "cpu"}
    t = mdb.mongodb_test(opts)
    t["client"] = mdb.MongoClient(
        addr_fn=lambda test, node: ("127.0.0.1", port))
    t["name"] = "mongodb-stub"
    done = core.run(t)
    assert done["results"]["valid?"] is True
    assert done["results"]["register"]["valid?"] is True


def test_logger_queue_semantics(stub):
    port = stub.server_address[1]
    cl = mdb.LoggerClient(
        addr_fn=lambda test, node: ("127.0.0.1", port)).open({}, "n1")
    for i, t in [("a", 30), ("b", 10), ("c", 20)]:
        r = cl.invoke({}, {"f": "write", "value": i, "time_ms": t,
                           "process": 0})
        assert r["type"] == "ok"
    out = [cl.invoke({}, {"f": "delete", "value": None,
                          "process": 0})["value"] for _ in range(3)]
    assert out == ["b", "c", "a"]
    assert cl.invoke({}, {"f": "delete", "value": None,
                          "process": 0})["type"] == "fail"


def test_storage_engine_axis():
    log: list = []
    db = mdb.MongoDB(storage_engine="rocksdb")
    test = {"nodes": ["n1"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "--storageEngine rocksdb" in joined
    assert "parse-mongodb-builds" in mdb.ROCKS_DEB_URL
    assert "parse-mongodb-builds" not in mdb.DEB_URL
    with pytest.raises(ValueError, match="storage_engine"):
        mdb.MongoDB(storage_engine="leveldb")


def test_smartos_path(tmp_path):
    from jepsen_tpu_torch import net as jnet
    from jepsen_tpu_torch.os_setup import SmartOS
    t = mdb.mongodb_test({"nodes": ["n1"], "concurrency": 2,
                          "os": "smartos", "server": "deb",
                          "store_root": str(tmp_path / "store"),
                          "device": "cpu"})
    assert isinstance(t["os"], SmartOS)
    assert isinstance(t["net"], jnet.IPFilter)


@pytest.mark.slow  # the reference twin's mark (tests/test_mongodb.py)
def test_logger_full_suite_with_stub(stub, tmp_path):
    port = stub.server_address[1]
    opts = {"nodes": ["n1", "n2"], "concurrency": 4, "time_limit": 4,
            "workload": "logger", "server": "deb",
            "store_root": str(tmp_path / "store"),
            "ssh": {"dummy?": True}}
    t = mdb.mongodb_test(opts)
    t["client"].addr_fn = lambda test, node: ("127.0.0.1", port)
    t["name"] = "mongodb-logger-stub"
    done = core.run(t)
    assert done["results"]["valid?"] is True


def _mini_options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["m1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.mark.parametrize("which", ["register", "logger"])
@pytest.mark.slow  # the reference twin's mark (tests/test_mongodb.py)
def test_full_suite_live(tmp_path, which):
    """LIVE mini-mongod processes under the kill/restart nemesis: the
    wire client, DB automation, and crash recovery all real."""
    done = core.run(mdb.mongodb_test(_mini_options(tmp_path, which)))
    res = done["results"]
    assert res["valid?"] is True, res


# -- parity with the reference ------------------------------------------------

DOCS = (
    {}, {"a": 1}, {"neg": -(2**31)}, {"edge": 2**31 - 1},
    {"big": 2**31}, {"huge": -(2**62)}, {"f": -0.5, "g": 1e300},
    {"s": "", "u": "héllo ☃"}, {"t": True, "n": None},
    {"d": {"x": {"y": [1, {"z": "w"}]}}}, {"a": [], "t": (1, 2)},
    {"update": "registers", "$db": "jepsen",
     "updates": [{"q": {"_id": 3, "value": 1},
                  "u": {"_id": 3, "value": 2}, "upsert": False}],
     "writeConcern": {"w": "majority"}},
    {7: "int key"})


@pytest.mark.parametrize("doc", DOCS, ids=range(len(DOCS)))
def test_bson_bytes_match_reference(doc):
    b = mdb.bson_encode(doc)
    assert b == ref_mdb.bson_encode(doc)
    assert mdb.bson_decode(b) == ref_mdb.bson_decode(b)


@pytest.mark.parametrize("bad", ({"x": object()}, {"s": {1, 2}}),
                         ids=("object", "set"))
def test_bson_rejections_match_reference(bad):
    with pytest.raises(TypeError):
        ref_mdb.bson_encode(bad)
    with pytest.raises(TypeError):
        mdb.bson_encode(bad)


@pytest.mark.parametrize("rid", (0, 1, 2**31 - 1))
def test_op_msg_frames_match_reference(rid):
    for doc in DOCS[:-1]:
        msg = mdb.encode_op_msg(doc, rid)
        assert msg == ref_mdb.encode_op_msg(doc, rid)
        assert mdb.read_op_msg(io.BytesIO(msg)) == \
            ref_mdb.read_op_msg(io.BytesIO(msg))


def test_short_and_foreign_frames_rejected_as_reference():
    good = mdb.encode_op_msg({"ping": 1}, 1)
    foreign = good[:12] + struct.pack("<i", 2004) + good[16:]
    kind1 = good[:20] + b"\x01" + good[21:]
    for bad, exc in ((good[:10], ConnectionError),
                     (good[:-3], ConnectionError),
                     (foreign, ValueError), (kind1, ValueError)):
        with pytest.raises(exc):
            ref_mdb.read_op_msg(io.BytesIO(bad))
        with pytest.raises(exc):
            mdb.read_op_msg(io.BytesIO(bad))


def test_server_src_is_the_references_and_imports_neither_package():
    assert mdb.MINIMONGO_SRC == ref_mdb.MINIMONGO_SRC
    mods = set()
    for node in ast.walk(ast.parse(mdb.MINIMONGO_SRC)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "socketserver" in mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


def db_commands(ctl, remote_cls, mod, engine: str) -> tuple:
    test = {"nodes": ["n1", "n2"]}
    log: list = []
    db = mod.MongoDB(storage_engine=engine)
    with ctl.with_remote(remote_cls(log)):
        for node in test["nodes"]:
            with ctl.on(node):
                db.setup(test, node)
                db.kill(test, node)
                db.start(test, node)
                db.teardown(test, node)
    return log, db.log_files(test, "n1")


@pytest.mark.parametrize("engine", mdb.STORAGE_ENGINES)
def test_db_commands_match_reference(engine):
    log, files = db_commands(c, DummyRemote, mdb, engine)
    ref_log, ref_files = db_commands(ref_c, RefDummyRemote, ref_mdb, engine)
    assert log == ref_log and files == ref_files
    assert f"--storageEngine {engine}" in "\n".join(
        x[1] for x in log if isinstance(x[1], str))


def test_logger_ops_match_reference():
    def ops(mod, g_mod, tl):
        g_mod.RNG.seed(5)
        g = mod._logger_workload({})["generator"]
        return [(o["f"], o["value"], o.get("time_ms"))
                for o in tl.quick(g_mod.limit(30, g))]

    got = ops(mdb, gen, testlib)
    assert got == ops(ref_mdb, ref_gen, ref_testlib)
    assert {f for f, *_ in got} == {"write", "delete"}


def register_history(stale: bool) -> list:
    """Two keys, two processes a key; with `stale`, key 1's last read
    returns a value overwritten before it began."""
    ops = []

    def pair(p, f, k, v, out=None, typ="ok"):
        ops.append({"type": "invoke", "process": p, "f": f,
                    "value": [k, v]})
        ops.append({"type": typ, "process": p, "f": f,
                    "value": [k, v if out is None else out]})

    for k in (0, 1):
        pair(2 * k, "write", k, 1)
        pair(2 * k + 1, "read", k, None, out=1)
        pair(2 * k, "cas", k, [1, 2])
        pair(2 * k, "cas", k, [1, 4], typ="fail")
        pair(2 * k + 1, "read", k, None, out=1 if stale and k == 1 else 2)
    return ops


@pytest.mark.parametrize("stale", (False, True), ids=("valid", "stale"))
def test_register_verdicts_match_reference(tmp_path, stale):
    opts = {"nodes": ["m1"], "concurrency": 4, "device": "cpu",
            "store_root": str(tmp_path / "store")}
    chk = mdb.mongodb_test(opts)["checker"].checker_map["register"]
    ref_chk = ref_mdb.mongodb_test(opts)["checker"].checker_map["register"]
    ops = register_history(stale)
    got = chk.check({}, History([{**o, "value": tuple_(*o["value"])}
                                 for o in ops]).index(), {})
    want = ref_chk.check({}, RefHistory(
        [{**o, "value": ref_independent.tuple_(*o["value"])}
         for o in ops]).index(), {})
    assert got["valid?"] is (not stale) and want["valid?"] is (not stale)
    assert {k: r["valid?"] for k, r in got["results"].items()} == \
        {k: r["valid?"] for k, r in want["results"].items()}


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert mdb.MINI_BASE_PORT == 31000
    assert mdb.MINI_BASE_PORT != ref_mdb.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < mdb.MINI_BASE_PORT and mdb.MINI_BASE_PORT + 5 < lo
    test = {"nodes": ["m1", "m2"]}
    assert [mdb.mini_node_port(test, n) for n in test["nodes"]] == \
        [mdb.MINI_BASE_PORT, mdb.MINI_BASE_PORT + 1]
    t = mdb.mongodb_test({"nodes": ["m1", "m2"], "concurrency": 2,
                          "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")
    # every client drives the primary's server, on the port's base
    assert t["client"].addr_fn(t, "m2") == ("127.0.0.1", mdb.MINI_BASE_PORT)


def test_device_reaches_the_checker(tmp_path):
    t = mdb.mongodb_test(_mini_options(tmp_path, "register"))
    lin = t["checker"].checker_map["register"].checker.checker_map["linear"]
    assert lin.device == torch.device("cpu")
    assert lin.algorithm == "competition"


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "deb"):
        with pytest.raises(RuntimeError, match="CUDA"):
            mdb.mongodb_test({**_mini_options(tmp_path, "register"),
                              "server": server, "device": None})
    assert not (tmp_path / "cluster").exists()
    # the logger's checker takes no device: no card is needed
    t = mdb.mongodb_test({**_mini_options(tmp_path, "logger"),
                          "device": None})
    assert t["name"] == "mongodb-logger-mini-3.2.0"
