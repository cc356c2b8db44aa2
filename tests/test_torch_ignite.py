"""The port's ignite suite (`jepsen_tpu_torch/dbs/ignite.py`) held against
the JAX package: the twins of `tests/test_ignite.py` (the thin-protocol
handshake and framing, both transaction concurrency models on the live mini
grid, the pds persistence axis, the runner's configuration matrix, the
register live under the kill nemesis and the bank live under both models,
the zip automation through the dummy remote), and parity cases: the
handshake's and every request's bytes, the configuration lattice, the
runner's matrix, `server_xml` with pds on and off, the server's source byte
for byte, what each client sends and makes of the replies and of errors
(the fail / info split), the zip automation's and the mini server's
commands, the partition nemesis, and the generated ops of both workloads.

Also: the port's ports and store root are its own, the `device` option
reaches the `register` check, and a missing card raises before any node is
set up. The suite checks on the CPU (`device="cpu"`).
"""

import builtins
import io
import itertools
import json
import os
import struct
import subprocess
import sys
import time

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import ignite as ref_ig
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import ignite as ig
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.independent import tuple_
from jepsen_tpu_torch.models import cas_register
from test_torch_galera import dummy_log, workload_ops
from test_torch_logcabin import src_imports
from test_torch_sqlite import ephemeral_range
from test_torch_yuga import plain_value

#: the twin fixtures' server ports, inside ignite's block (31750-31799): the
#: reference's 28990-28994, one for one
FIXTURE_PORTS = (31790, 31791, 31792, 31793, 31794)


@pytest.fixture()
def mini(tmp_path):
    state = {"procs": []}

    def start(pds=True, port=FIXTURE_PORTS[0], subdir="d"):
        d = tmp_path / subdir
        d.mkdir(exist_ok=True)
        srv_py = d / "miniignite.py"
        srv_py.write_text(ig.MINIIGNITE_SRC)
        proc = subprocess.Popen(
            [sys.executable, str(srv_py), "--port", str(port),
             "--dir", str(d),
             "--pds", "true" if pds else "false"],
            cwd=d)
        state["procs"].append(proc)
        deadline = time.monotonic() + 30  # generous: loaded CI
        while True:
            try:
                return ig.IgniteConn("127.0.0.1", port, timeout=3)
            except OSError:
                assert time.monotonic() < deadline, "never up"
                time.sleep(0.1)

    yield start, state
    for proc in state["procs"]:
        proc.kill()
        proc.wait(timeout=10)


def test_cache_ops_and_replace(mini):
    start, _ = mini
    conn = start()
    assert conn.get("C", "k") is None
    conn.put("C", "k", 3)
    assert conn.get("C", "k") == 3
    assert conn.replace("C", "k", 3, 4) is True
    assert conn.replace("C", "k", 3, 5) is False
    assert conn.get("C", "k") == 4
    conn.close()


def test_pessimistic_lock_wait_aborts(mini):
    """Two pessimistic txns contending on one entry: the second
    write must time out (TransactionTimeoutException analog)."""
    start, _ = mini
    c1 = start()
    c2 = ig.IgniteConn("127.0.0.1", FIXTURE_PORTS[0], timeout=10)
    c1.put("C", "x", 0)
    t1 = c1.tx_start("PESSIMISTIC", "REPEATABLE_READ")
    c1.put("C", "x", 1, tx=t1)          # t1 holds the entry lock
    t2 = c2.tx_start("PESSIMISTIC", "REPEATABLE_READ")
    with pytest.raises(ig.TxConflict):
        c2.put("C", "x", 2, tx=t2)       # waits, then aborts
    c1.tx_commit(t1)
    assert c1.get("C", "x") == 1
    c1.close()
    c2.close()


def test_optimistic_serializable_validation(mini):
    """Optimistic-serializable read/write sets validate at commit:
    the loser of a racing update must get TxConflict."""
    start, _ = mini
    c1 = start()
    c2 = ig.IgniteConn("127.0.0.1", FIXTURE_PORTS[0], timeout=5)
    c1.put("C", "y", 10)
    t1 = c1.tx_start("OPTIMISTIC", "SERIALIZABLE")
    t2 = c2.tx_start("OPTIMISTIC", "SERIALIZABLE")
    assert c1.get("C", "y", tx=t1) == 10
    assert c2.get("C", "y", tx=t2) == 10
    c1.put("C", "y", 11, tx=t1)
    c2.put("C", "y", 12, tx=t2)
    c1.tx_commit(t1)                     # wins
    with pytest.raises(ig.TxConflict):
        c2.tx_commit(t2)                 # version moved: must abort
    assert c1.get("C", "y") == 11
    c1.close()
    c2.close()


def test_pds_axis_controls_durability(mini):
    """pds=true survives a kill -9 + restart; pds=false loses the
    grid's data — the reference's ##pds## toggle, made observable."""
    start, state = mini
    conn = start(pds=True, port=FIXTURE_PORTS[1], subdir="pds-on")
    tx = conn.tx_start("PESSIMISTIC", "REPEATABLE_READ")
    conn.put("C", "durable", 7, tx=tx)
    conn.tx_commit(tx)
    conn.close()
    state["procs"][-1].kill()
    state["procs"][-1].wait(timeout=10)
    conn = start(pds=True, port=FIXTURE_PORTS[2], subdir="pds-on")
    assert conn.get("C", "durable") == 7    # replayed from the log
    conn.close()

    conn = start(pds=False, port=FIXTURE_PORTS[3], subdir="pds-off")
    conn.put("C", "volatile", 9)
    conn.close()
    state["procs"][-1].kill()
    state["procs"][-1].wait(timeout=10)
    conn = start(pds=False, port=FIXTURE_PORTS[4], subdir="pds-off")
    assert conn.get("C", "volatile") is None  # grid data lost
    conn.close()


def test_config_validation():
    with pytest.raises(ValueError, match="atomicity"):
        ig.cache_config({"cache_atomicity": "EVENTUAL"}, "C")
    with pytest.raises(ValueError, match="concurrency"):
        ig.transaction_config({"tx_concurrency": "CHAOTIC"})
    cfg = ig.cache_config({}, "REGISTER")
    assert cfg["atomicity"] == "TRANSACTIONAL"
    assert cfg["backups"] == 1


def test_matrix_shape(tmp_path):
    tests = list(ig.ignite_tests(_options(tmp_path, None)))
    names = [t["name"] for t in tests]
    # bank sweeps 2 concurrency x 3 isolation; register pins one
    assert len(tests) == 7
    assert sum("bank" in n for n in names) == 6
    assert any("optimistic-serializable" in n for n in names)
    for t in tests:
        assert t["tx_config"]["concurrency"] in ig.TX_CONCURRENCY


def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["i1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "grid"), "device": "cpu", **kw}


def test_register_live(tmp_path):
    done = core.run(ig.ignite_test(_options(tmp_path, "register")))
    res = done["results"]
    assert res["valid?"] is True, res


@pytest.mark.parametrize("conc,iso", [
    ("PESSIMISTIC", "REPEATABLE_READ"),
    ("OPTIMISTIC", "SERIALIZABLE")])
@pytest.mark.slow  # as its twin in tests/test_ignite.py
def test_bank_live(tmp_path, conc, iso):
    done = core.run(ig.ignite_test(_options(
        tmp_path, "bank", tx_concurrency=conc, tx_isolation=iso)))
    res = done["results"]
    assert res["valid?"] is True, res


def test_zip_commands():
    log: list = []
    db = ig.IgniteDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
            db.teardown(test, "n1")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "/opt/ignite" in joined
    assert "openjdk-8" in joined
    assert "bin/ignite.sh" in joined
    assert "servers=3," in joined          # topology await
    assert "--activate" in joined
    assert "CommandLineStartup" in joined  # targeted kill
    ups = [x[1] for x in log if isinstance(x[1], tuple)
           and x[1][0] == "upload"]
    assert any("server-ignite-n1.xml" in str(u[2]) for u in ups)
    xml = ig.server_xml(test, False, True)
    assert "n2:47500..47509" in xml and "persistenceEnabled=\"true\"" in xml


# -- parity with the reference ------------------------------------------------

OPS = ("OP_HANDSHAKE", "OP_CACHE_GET", "OP_CACHE_PUT",
       "OP_CACHE_REPLACE_IF_EQUALS", "OP_CACHE_GET_ALL", "OP_TX_START",
       "OP_TX_COMMIT", "OP_TX_ROLLBACK")
LATTICE = ("CACHE_ATOMICITY", "CACHE_MODES", "WRITE_SYNC_MODES",
           "TX_CONCURRENCY", "TX_ISOLATION")


def test_constants_match_reference():
    for name in OPS + LATTICE + ("VERSION", "PORT", "SERVER_DIR",
                                 "LOGFILE"):
        assert getattr(ig, name) == getattr(ref_ig, name), name
    for name in ("script", "pidfile", "logfile", "data_files"):
        assert getattr(ig.MiniIgniteDB, name) == \
            getattr(ref_ig.MiniIgniteDB, name), name
    assert ig.IgniteRegisterClient.CACHE == ref_ig.IgniteRegisterClient.CACHE
    assert ig.IgniteBankClient.CACHE == ref_ig.IgniteBankClient.CACHE
    assert sorted(ig.WORKLOADS) == sorted(ref_ig.WORKLOADS)
    assert set(ig.DEVICE_WORKLOADS) < set(ig.WORKLOADS)
    assert ig.IgniteDB().zip_url() == ref_ig.IgniteDB().zip_url()


def test_source_is_the_references_and_imports_neither_package():
    assert ig.MINIIGNITE_SRC == ref_ig.MINIIGNITE_SRC
    mods = src_imports(ig.MINIIGNITE_SRC)
    assert {"socketserver", "struct", "threading"} <= mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}
    # the reference's timeouts: a 3 s lock wait, the deadlock abort
    assert "LOCK_WAIT_S = 3.0" in ig.MINIIGNITE_SRC


def frame(op: int, rid: int, payload: dict) -> bytes:
    body = json.dumps(payload).encode()
    return struct.pack("<IHq", len(body) + 10, op, rid) + body


class Wire:
    """A socket and its reader: what the client sends, and the server's
    frames, read in turn."""

    def __init__(self, replies: bytes):
        self.sent, self.rf = bytearray(), io.BytesIO(replies)

    def sendall(self, b):
        self.sent += b

    def close(self):
        pass


# (the conn's call, its arguments, the server's reply) in turn
CALLS = (
    ("get", ("REGISTER", "k1"), {"value": None}),
    ("put", ("REGISTER", "k1", 3), {}),
    ("replace", ("REGISTER", "k1", 3, 4), {"value": True}),
    ("replace", ("REGISTER", "k1", 3, 5), {"value": False}),
    ("tx_start", ("OPTIMISTIC", "SERIALIZABLE"), {"tx": 7}),
    ("get", ("ACCOUNTS", "a0"), {"value": 10}, 7),
    ("get_all", ("ACCOUNTS", ["a0", "a1"]), {"value": {"a0": 10,
                                                       "a1": None}}, 7),
    ("put", ("ACCOUNTS", "a0", 5), {}, 7),
    ("tx_commit", (7,), {"err": "optimistic validation failed",
                         "conflict": True}),
    ("tx_rollback", (7,), {}),
    ("get", ("C", "x"), {"err": "ValueError: unknown op 9"}),
)


def wire_session(mod) -> tuple:
    """The handshake and CALLS over one scripted wire: the bytes the client
    sent, and what each call returned or raised."""
    replies = frame(mod.OP_HANDSHAKE, 0, {"success": True,
                                          "version": [2, 7, 0]})
    names = {"get": "OP_CACHE_GET", "put": "OP_CACHE_PUT",
             "replace": "OP_CACHE_REPLACE_IF_EQUALS",
             "get_all": "OP_CACHE_GET_ALL", "tx_start": "OP_TX_START",
             "tx_commit": "OP_TX_COMMIT", "tx_rollback": "OP_TX_ROLLBACK"}
    for rid, (verb, _, reply, *_) in enumerate(CALLS, 1):
        replies += frame(getattr(mod, names[verb]), rid, reply)
    wire = Wire(replies)
    conn = mod.IgniteConn.__new__(mod.IgniteConn)
    conn.sock, conn.rf, conn.req_id = wire, wire.rf, 0
    conn._handshake()
    out = []
    for verb, args, _, *tx in CALLS:
        try:
            out.append(("ok", getattr(conn, verb)(
                *args, **({"tx": tx[0]} if tx else {}))))
        except mod.IgniteError as e:
            out.append((type(e).__name__, str(e)))
    return bytes(wire.sent), out


def test_wire_bytes_match_reference():
    sent, out = wire_session(ig)
    assert (sent, out) == wire_session(ref_ig)
    # the handshake leads: op 1, request id 0, the thin client's version
    n, op, rid = struct.unpack("<IHq", sent[:14])
    assert (op, rid) == (1, 0)
    assert json.loads(sent[14:4 + n]) == {"version": [2, 7, 0],
                                          "client": "thin"}
    assert out[-3:] == [("TxConflict", "optimistic validation failed"),
                        ("ok", None),
                        ("IgniteError", "ValueError: unknown op 9")]


def test_refused_handshake_matches_reference():
    for mod in (ig, ref_ig):
        wire = Wire(frame(1, 0, {"success": False}))
        conn = mod.IgniteConn.__new__(mod.IgniteConn)
        conn.sock, conn.rf, conn.req_id = wire, wire.rf, 0
        with pytest.raises(mod.IgniteError, match="handshake refused"):
            conn._handshake()
        with pytest.raises(ConnectionError, match="short frame length"):
            conn._read_frame()


LATTICE_OPTS = [
    dict(zip(("cache_atomicity", "cache_mode", "write_sync", "backups",
              "read_from_backup"), combo))
    for combo in itertools.product(ig.CACHE_ATOMICITY + (None,),
                                   ig.CACHE_MODES + (None,),
                                   ig.WRITE_SYNC_MODES + (None,),
                                   (None, 0, 2), (True, False))]


def config_or_error(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


def test_configuration_lattice_matches_reference():
    for opts in LATTICE_OPTS:
        for name in ("REGISTER", "ACCOUNTS"):
            assert ig.cache_config(opts, name) == \
                ref_ig.cache_config(opts, name), opts
    for conc, iso in itertools.product(ig.TX_CONCURRENCY + (None,),
                                       ig.TX_ISOLATION + (None,)):
        opts = {"tx_concurrency": conc, "tx_isolation": iso}
        assert ig.transaction_config(opts) == \
            ref_ig.transaction_config(opts)
    for bad in ({"cache_atomicity": "EVENTUAL"}, {"cache_mode": "LOCAL"},
                {"write_sync": "NEVER"}):
        got = config_or_error(ig.cache_config, bad, "C")
        assert got == config_or_error(ref_ig.cache_config, bad, "C")
        assert got[0] == "ValueError"
    for bad in ({"tx_concurrency": "CHAOTIC"},
                {"tx_isolation": "READ_UNCOMMITTED"}):
        got = config_or_error(ig.transaction_config, bad)
        assert got == config_or_error(ref_ig.transaction_config, bad)
        assert got[0] == "ValueError"


PLAIN_KEYS = ("name", "store_root", "nodes", "concurrency", "cache_config",
              "tx_config", "pds", "accounts", "total-amount", "max-transfer")


def matrix(mod, tmp_path, **kw) -> list:
    return [{k: t.get(k) for k in PLAIN_KEYS}
            | {"db": type(t["db"]).__name__,
               "nemesis": type(t["nemesis"]).__name__,
               "checks": sorted(t["checker"].checker_map)}
            for t in mod.ignite_tests(_options(tmp_path, None, **kw))]


@pytest.mark.parametrize("kw", [{}, {"name": "grid", "pds": False},
                                {"workload": "bank",
                                 "cache_mode": "REPLICATED"}],
                         ids=["default", "named-no-pds", "bank-replicated"])
def test_tests_matrix_matches_reference(tmp_path, kw):
    got = matrix(ig, tmp_path, **kw)
    assert got == matrix(ref_ig, tmp_path, **kw)
    assert len(got) == (6 if kw.get("workload") == "bank" else 7)


@pytest.mark.parametrize("pds", [True, False])
@pytest.mark.parametrize("client_mode", [True, False])
def test_server_xml_matches_reference(pds, client_mode):
    for n in (1, 3, 5):
        test = {"nodes": [f"n{i}" for i in range(n)]}
        xml = ig.server_xml(test, client_mode, pds)
        assert xml == ref_ig.server_xml(test, client_mode, pds)
        assert f'persistenceEnabled="{str(pds).lower()}"' in xml


class FakeIgnite:
    """An in-memory grid connection: each verb recorded in `sent`; a verb
    named in `fail_on` raises `exc` instead."""

    def __init__(self, exc=None, fail_on=()):
        self.exc, self.fail_on = exc, fail_on
        self.cache, self.sent, self.next_tx = {}, [], 0

    def _call(self, verb, *args):
        self.sent.append((verb, *args))
        if verb in self.fail_on:
            raise self.exc

    def get(self, cache, key, tx=None):
        self._call("get", cache, key, tx)
        return self.cache.get((cache, key))

    def get_all(self, cache, keys, tx=None):
        self._call("get_all", cache, list(keys), tx)
        return {k: self.cache.get((cache, k)) for k in keys}

    def put(self, cache, key, value, tx=None):
        self._call("put", cache, key, value, tx)
        self.cache[(cache, key)] = value

    def replace(self, cache, key, old, new):
        self._call("replace", cache, key, old, new)
        if self.cache.get((cache, key)) != old:
            return False
        self.cache[(cache, key)] = new
        return True

    def tx_start(self, concurrency, isolation):
        self._call("tx_start", concurrency, isolation)
        self.next_tx += 1
        return self.next_tx

    def tx_commit(self, tx):
        self._call("tx_commit", tx)

    def tx_rollback(self, tx):
        self._call("tx_rollback", tx)

    def close(self):
        pass


VERBS = ("get", "get_all", "put", "replace", "tx_start", "tx_commit",
         "tx_rollback")
BANK_TEST = {"nodes": ["i1"], "accounts": [0, 1, 2], "total-amount": 31,
             "tx_config": {"concurrency": "OPTIMISTIC",
                           "isolation": "SERIALIZABLE"}}
# (client, whether it runs `setup`, its ops: (f, value), a ("kv", k, v)
# value made each package's `[k v]` tuple)
SESSIONS = {
    "IgniteRegisterClient": (False, [
        ("read", ("kv", 1, None)), ("write", ("kv", 1, 3)),
        ("cas", ("kv", 1, [3, 4])), ("cas", ("kv", 1, [3, 5])),
        ("read", ("kv", 1, None))]),
    "IgniteBankClient": (True, [
        ("read", None), ("transfer", {"from": 0, "to": 1, "amount": 5}),
        ("transfer", {"from": 2, "to": 0, "amount": 1000}),
        ("read", None)]),
}


def client_session(mod, name: str, conn) -> tuple:
    """The verbs the client `name` of `mod` sends over `conn` (`setup`
    first where it seeds its accounts) and its completions: (type, value,
    error, whether it still holds `conn`)."""
    seeds, ops = SESSIONS[name]
    cl = getattr(mod, name)().open(BANK_TEST, "i1")
    cl.conn = conn
    if seeds and not conn.fail_on:
        cl.setup(BANK_TEST)
    out = []
    for f, v in ops:
        if isinstance(v, tuple):
            v = (tuple_ if mod is ig else ref_independent.tuple_)(v[1], v[2])
        cl.conn = conn
        done = cl.invoke(BANK_TEST, {"type": "invoke", "f": f, "value": v,
                                     "process": 0})
        out.append((done["type"], plain_value(done.get("value")),
                    done.get("error"), cl.conn is conn))
    return conn.sent, out


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_client_sessions_match_reference(name):
    got = client_session(ig, name, FakeIgnite())
    assert got == client_session(ref_ig, name, FakeIgnite())
    assert got[1][0][0] == "ok"
    if name == "IgniteBankClient":
        assert [t for t, *_ in got[1]] == ["ok", "ok", "fail", "ok"]
        assert got[1][-1][1] == {0: 6, 1: 15, 2: 10}


# errors raised by the connection: (the module's TxConflict or IgniteError,
# or a builtin, and its message): the reference tests' aborts, a protocol
# fault, and a refused, a reset and a timed-out connection
ERRORS = (
    ("TxConflict", "lock wait timeout on ACCOUNTS['a0']"),
    ("TxConflict", "optimistic validation failed on ACCOUNTS['a1']"),
    ("IgniteError", "handshake refused: {}"),
    ("ConnectionError", "request-id mismatch"),
    ("ConnectionRefusedError", "[Errno 111] Connection refused"),
    ("ConnectionResetError", "[Errno 104] Connection reset by peer"),
    ("TimeoutError", "timed out"),
)


def error_of(mod, kind, msg):
    return (getattr(mod, kind)(msg) if kind in ("TxConflict", "IgniteError")
            else getattr(builtins, kind)(msg))


@pytest.mark.parametrize("fail_on", [VERBS, ("tx_commit",),
                                     ("tx_commit", "tx_rollback")],
                         ids=["every-verb", "commit", "commit-rollback"])
@pytest.mark.parametrize("kind,msg", ERRORS,
                         ids=[f"{k}:{m[:12]}" for k, m in ERRORS])
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_client_errors_match_reference(name, kind, msg, fail_on):
    """Reads fail, mutations go indefinite, and a transaction's conflict
    (an optimistic validation, a pessimistic lock wait) fails it after a
    rollback; a rollback that fails drops the connection."""
    got = client_session(ig, name, FakeIgnite(error_of(ig, kind, msg),
                                              fail_on))
    assert got == client_session(
        ref_ig, name, FakeIgnite(error_of(ref_ig, kind, msg), fail_on))
    for (t, _, _, held), (f, _) in zip(got[1], SESSIONS[name][1]):
        if f == "read" and fail_on == VERBS:
            assert t == "fail" and not held
        if t == "info":
            assert f != "read" and not held


def zip_steps(mod):
    db = mod.IgniteDB(pds=False)
    test = {"nodes": ["n1", "n2", "n3"]}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in ("n1", "n3")
            for f in ("setup", "start", "kill", "teardown")], \
        db.log_files(test, "n1")


def test_zip_commands_match_reference():
    steps, files = zip_steps(ig)
    ref_steps, ref_files = zip_steps(ref_ig)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert files == ref_files


@pytest.mark.parametrize("pds", [True, False])
def test_mini_db_commands_match_reference(pds):
    """The mini grid's lifecycle, its pds flag included: the same commands
    on the same ports."""
    def steps(mod):
        db = mod.MiniIgniteDB(pds=pds)
        test = {"nodes": ["i1", "i2"], "ignite_ports": {"i1": 40000,
                                                        "i2": 40001}}
        return [("i2", (lambda f=f: getattr(db, f)(test, "i2")))
                for f in ("setup", "kill", "start", "pause", "resume",
                          "teardown")]
    assert dummy_log(c, DummyRemote, steps(ig)) == \
        dummy_log(ref_c, RefDummyRemote, steps(ref_ig))


def test_partition_nemesis_matches_reference(tmp_path):
    """The partition nemesis carries an iptables `Net` in zip mode and is
    refused in mini mode, as the reference's is."""
    for mod in (ig, ref_ig):
        with pytest.raises(ValueError, match="no network to partition"):
            mod.ignite_test(_options(tmp_path, "register",
                                     nemesis="partition"))
    got = ig.ignite_test(_options(tmp_path, "bank", nemesis="partition",
                                  server="zip"))
    want = ref_ig.ignite_test(_options(tmp_path, "bank", nemesis="partition",
                                       server="zip"))
    assert type(got["net"]).__name__ == type(want["net"]).__name__ == \
        "IPTables"
    assert type(got["nemesis"]).__name__ == type(want["nemesis"]).__name__
    assert type(got["os"]).__name__ == type(want["os"]).__name__


@pytest.mark.parametrize("which", sorted(ig.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(ig, gen, testlib, which)
    assert got == workload_ops(ref_ig, ref_gen, ref_testlib, which)
    assert len(got) == 40


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert ig.MINI_BASE_PORT == 31750
    assert ig.MINI_BASE_PORT != ref_ig.MINI_BASE_PORT
    # below the ephemeral range, clear of the reference's bases
    # (21850-30680), with room for five nodes and the twin fixtures
    lo, _ = ephemeral_range()
    assert 30680 < ig.MINI_BASE_PORT and ig.MINI_BASE_PORT + 50 <= lo
    assert all(ig.MINI_BASE_PORT + 5 <= p < ig.MINI_BASE_PORT + 50
               for p in FIXTURE_PORTS)
    test = {"nodes": ["i1", "i2"]}
    assert [ig.mini_node_port(test, n) for n in test["nodes"]] == \
        [ig.MINI_BASE_PORT, ig.MINI_BASE_PORT + 1]
    assert ig.mini_node_port({**test, "ignite_ports": {"i2": 4000}},
                             "i2") == 4000
    for which in ig.WORKLOADS:
        t = ig.ignite_test(_options(tmp_path, which, nodes=["i1", "i2"]))
        assert t["store_root"] == str(tmp_path / "store")
        assert t["db"].port(t, "i2") == ig.MINI_BASE_PORT + 1
        # each worker on its node's server, pinned to the primary's
        assert t["client"].port_fn(t, "i2") == ("127.0.0.1",
                                                ig.MINI_BASE_PORT + 1)
        assert t["client"].pin_primary is True
    t = ig.ignite_test({"nodes": ["i1"], "concurrency": 2, "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["name"] == "ignite-register-pessimistic-repeatable_read-mini"


def test_device_reaches_the_checks(tmp_path):
    for server in ("mini", "zip"):
        for which in ig.WORKLOADS:
            t = ig.ignite_test({**_options(tmp_path, which),
                                "server": server})
            chk = t["checker"].checker_map[which]
            if which in ig.DEVICE_WORKLOADS:
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
            ig.ignite_test({**_options(tmp_path, "register"),
                            "server": server, "device": None})
    # the sweep resolves it before it makes its first test, a bank test
    with pytest.raises(RuntimeError, match="CUDA"):
        next(ig.ignite_tests({**_options(tmp_path, None), "device": None}))
    assert not (tmp_path / "grid").exists()
    # a sweep of the bank alone needs no card
    names = [t["name"] for t in ig.ignite_tests(
        {**_options(tmp_path, "bank"), "device": None})]
    assert len(names) == 6 and all("bank" in n for n in names)
