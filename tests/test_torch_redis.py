"""The port's redis suite (`jepsen_tpu_torch/dbs/redis.py`), held against
the JAX package: the twins of `tests/test_redis.py` (the from-scratch
RESP codec and client against an in-process RESP2 stub, the DB's
commands through the dummy remote, the full suite against the stub and
against live mini-redis servers, both slow as their reference twins, and
the mini server's AOF across kill -9), and parity cases: the codec's
bytes and replies, the DB's command lists, and the embedded server
source, equal to the reference's.

Also: the port's ports and store root are its own, and a missing card
raises before any node is set up. The suites check on the CPU
(`device="cpu"`).
"""

import io
import os
import signal
import socketserver
import subprocess
import sys
import threading
import time

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import redis as ref_redis
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import redis
from jepsen_tpu_torch.independent import tuple_


# -- in-process RESP2 server ------------------------------------------------

class RespStub(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.data: dict = {}
        self.store_lock = threading.Lock()


class RespHandler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            try:
                args = self._read_command()
            except (ConnectionError, ValueError):
                return
            if args is None:
                return
            self.wfile.write(self._apply([str(a) for a in args]))
            self.wfile.flush()

    def _read_command(self):
        line = self.rfile.readline()
        if not line:
            return None
        assert line[:1] == b"*", line
        n = int(line[1:].strip())
        out = []
        for _ in range(n):
            hdr = self.rfile.readline()
            assert hdr[:1] == b"$", hdr
            ln = int(hdr[1:].strip())
            out.append(self.rfile.read(ln + 2)[:ln].decode())
        return out

    def _apply(self, args) -> bytes:
        srv = self.server
        cmd = args[0].upper()
        with srv.store_lock:
            if cmd == "GET":
                v = srv.data.get(args[1])
                if v is None:
                    return b"$-1\r\n"
                b = str(v).encode()
                return b"$%d\r\n%s\r\n" % (len(b), b)
            if cmd == "SET":
                srv.data[args[1]] = args[2]
                return b"+OK\r\n"
            if cmd == "EVAL":
                # the suite's CAS script: EVAL <lua> 1 key old new
                _lua, _nkeys, key, old, new = args[1:6]
                if srv.data.get(key) == old:
                    srv.data[key] = new
                    return b":1\r\n"
                return b":0\r\n"
            return b"-ERR unknown command\r\n"


@pytest.fixture()
def resp_server():
    srv = RespStub(("127.0.0.1", 0), RespHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()
    srv.server_close()


# -- codec ------------------------------------------------------------------

def test_resp_encode():
    assert redis.resp_encode(["GET", "k"]) == \
        b"*2\r\n$3\r\nGET\r\n$1\r\nk\r\n"


def test_resp_read_types():
    rf = io.BytesIO(b"+OK\r\n:42\r\n$3\r\nfoo\r\n$-1\r\n"
                    b"*2\r\n:1\r\n$1\r\nx\r\n")
    assert redis.resp_read(rf) == "OK"
    assert redis.resp_read(rf) == 42
    assert redis.resp_read(rf) == "foo"
    assert redis.resp_read(rf) is None
    assert redis.resp_read(rf) == [1, "x"]
    with pytest.raises(redis.RedisError):
        redis.resp_read(io.BytesIO(b"-ERR boom\r\n"))


# -- client vs stub ---------------------------------------------------------

def test_client_semantics(resp_server):
    port = resp_server.server_address[1]
    cl = redis.RedisClient(
        port_fn=lambda test, node: ("127.0.0.1", port)).open({}, "n1")
    rd = {"type": "invoke", "f": "read", "value": tuple_(3, None),
          "process": 0}
    assert cl.invoke({}, rd)["value"] == tuple_(3, None)
    assert cl.invoke({}, {"f": "write", "value": tuple_(3, 7),
                          "process": 0})["type"] == "ok"
    assert cl.invoke({}, rd)["value"] == tuple_(3, 7)
    assert cl.invoke({}, {"f": "cas", "value": tuple_(3, [7, 9]),
                          "process": 0})["type"] == "ok"
    assert cl.invoke({}, {"f": "cas", "value": tuple_(3, [7, 1]),
                          "process": 0})["type"] == "fail"
    assert cl.invoke({}, rd)["value"] == tuple_(3, 9)
    cl.close({})


def test_client_down_server_contained():
    cl = redis.RedisClient(
        port_fn=lambda test, node: ("127.0.0.1", 1),
        timeout=0.2).open({}, "n1")
    r = cl.invoke({}, {"f": "read", "value": tuple_(1, None),
                       "process": 0})
    assert r["type"] == "fail"
    w = cl.invoke({}, {"f": "write", "value": tuple_(1, 2),
                       "process": 0})
    assert w["type"] == "info"


# -- DB orchestration -------------------------------------------------------

def db_commands(ctl, remote_cls, mod) -> tuple:
    log: list = []
    db = mod.RedisDB()
    test = {"nodes": ["n1"]}
    with ctl.with_remote(remote_cls(log)):
        with ctl.on("n1"):
            db.setup(test, "n1")
            db.kill(test, "n1")
            db.teardown(test, "n1")
    return log, db.log_files(test, "n1")


def test_db_commands():
    log, files = db_commands(c, DummyRemote, redis)
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "redis-" in joined and "make" in joined
    assert "redis-server" in joined and "--appendonly yes" in joined
    assert files == [redis.LOGFILE]


# -- full suite -------------------------------------------------------------

@pytest.mark.slow  # as its reference twin (tests/test_redis.py)
def test_full_suite_with_stub(resp_server, tmp_path):
    # the source-mode suite shape, driven against the in-process stub
    # (DB automation goes to the dummy remote; the wire contract is
    # what's under test here)
    port = resp_server.server_address[1]
    opts = {"nodes": ["n1", "n2"], "concurrency": 4, "time_limit": 4,
            "per_key_limit": 15, "store_root": str(tmp_path / "store"),
            "server": "source", "ssh": {"dummy?": True}, "device": "cpu"}
    t = redis.redis_test(opts)
    t["client"] = redis.RedisClient(
        port_fn=lambda test, node: ("127.0.0.1", port))
    t["name"] = "redis-stub"
    done = core.run(t)
    assert done["results"]["valid?"] is True
    assert done["results"]["register"]["valid?"] is True


@pytest.mark.slow  # as its reference twin (tests/test_redis.py)
def test_full_suite_live_mini(tmp_path):
    """install -> daemon start -> real-TCP RESP workload -> kill/
    restart nemesis -> AOF replay -> checker, all against live
    mini-redis subprocesses."""
    opts = {"nodes": ["r1", "r2"], "concurrency": 4, "time_limit": 6,
            "per_key_limit": 12, "nemesis_interval": 2.0,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu"}
    done = core.run(redis.redis_test(opts))
    assert done["results"]["valid?"] is True
    assert done["results"]["register"]["valid?"] is True
    run_dir = done["store_dir"]
    # node logs snarfed; the nemesis really killed at least one server
    logs = "".join(
        open(os.path.join(run_dir, n, redis.MINI_LOGFILE)).read()
        for n in ("r1", "r2"))
    assert logs.count("miniredis serving on") >= 3


def test_mini_aof_survives_kill(tmp_path):
    """Durability probe without the suite: start one mini server,
    write over real RESP, kill -9, restart, read the value back from
    the replayed AOF."""
    srv_py = tmp_path / "miniredis.py"
    srv_py.write_text(redis.MINIREDIS_SRC)
    port = 31999

    def start():
        return subprocess.Popen(
            [sys.executable, str(srv_py), "--port", str(port),
             "--appendonly", "yes", "--dir", str(tmp_path)],
            cwd=tmp_path)

    def connect(what):
        deadline = time.monotonic() + 10
        while True:
            try:
                return redis.RedisConn("127.0.0.1", port, timeout=2)
            except OSError:
                assert time.monotonic() < deadline, what
                time.sleep(0.1)

    proc = start()
    try:
        conn = connect("server never up")
        assert conn.cmd("SET", "k", "42") == "OK"
        assert conn.cmd("EVAL", redis.CAS_LUA, 1, "k", "42", "43") == 1
        assert conn.cmd("SET", "gone", "1") == "OK"
        assert conn.cmd("DEL", "gone") == 1
        conn.close()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        proc = start()
        conn = connect("no restart")
        assert conn.cmd("GET", "k") == "43"
        # acknowledged deletes survive the crash too (AOF replays DEL)
        assert conn.cmd("GET", "gone") is None
        conn.close()
    finally:
        proc.kill()
        proc.wait(timeout=10)


# -- parity and the port's own choices ---------------------------------------

def test_server_source_and_script_match_reference():
    assert redis.MINIREDIS_SRC == ref_redis.MINIREDIS_SRC
    assert redis.CAS_LUA == ref_redis.CAS_LUA
    assert (redis.VERSION, redis.PORT, redis.DIR, redis.PIDFILE,
            redis.LOGFILE) == (ref_redis.VERSION, ref_redis.PORT,
                               ref_redis.DIR, ref_redis.PIDFILE,
                               ref_redis.LOGFILE)


@pytest.mark.parametrize("args", [["GET", "k"], ["SET", "jepsen:3", 7],
                                  ["EVAL", ref_redis.CAS_LUA, 1, "k", "é", 0],
                                  [], ["MSET", "a", "", "b", "x y"]],
                         ids=str)
def test_codec_matches_reference(args):
    assert redis.resp_encode(args) == ref_redis.resp_encode(args)


@pytest.mark.parametrize("wire", [
    b"+OK\r\n", b":-7\r\n", b"$5\r\nhello\r\n", b"$-1\r\n", b"*-1\r\n",
    b"*3\r\n:1\r\n$0\r\n\r\n*1\r\n+x\r\n", b"-ERR boom\r\n", b"",
    b"$9\r\nshort\r\n", b"?what\r\n"], ids=str)
def test_replies_match_reference(wire):
    def read(mod):
        try:
            return ("ok", mod.resp_read(io.BytesIO(wire)))
        except Exception as e:  # noqa: BLE001 - compared below
            return ("raised", type(e).__name__, str(e))
    assert read(redis) == read(ref_redis)


def test_db_commands_match_reference():
    assert db_commands(c, DummyRemote, redis) == \
        db_commands(ref_c, RefDummyRemote, ref_redis)


def test_mini_db_commands_match_reference():
    """The mini server's lifecycle (miniserver.MiniServerDB): the same
    commands, the port's own ports."""
    def run(ctl, remote_cls, mod, base):
        log: list = []
        db = mod.MiniRedisDB()
        test = {"nodes": ["r1", "r2"],
                "redis_ports": {"r1": base, "r2": base + 1}}
        with ctl.with_remote(remote_cls(log)):
            with ctl.on("r2"):
                db.kill(test, "r2")
                db.pause(test, "r2")
                db.resume(test, "r2")
                db.teardown(test, "r2")
        return log, db.log_files(test, "r2")
    assert run(c, DummyRemote, redis, 40000) == \
        run(ref_c, RefDummyRemote, ref_redis, 40000)


def test_ports_and_store_root_are_the_ports_own():
    assert redis.MINI_BASE_PORT == 32350
    assert redis.MINI_BASE_PORT != ref_redis.MINI_BASE_PORT
    # below Linux's ephemeral range (32768-60999), where a client could
    # connect to itself on a down server's port
    assert redis.MINI_BASE_PORT + 8 < 32768
    test = {"nodes": ["r1", "r2", "r3"]}
    assert [redis.mini_node_port(test, n) for n in test["nodes"]] == \
        [redis.MINI_BASE_PORT + i for i in range(3)]
    assert redis.mini_node_port({**test, "redis_ports": {"r2": 4000}},
                                "r2") == 4000
    for k in range(50):
        assert redis.node_for_key(test, k) == ref_redis.node_for_key(test, k)
    t = redis.redis_test({"nodes": ["r1"], "concurrency": 2,
                          "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        redis.redis_test({"nodes": ["r1"], "concurrency": 2,
                          "sandbox": str(tmp_path / "cluster")})
    assert not (tmp_path / "cluster").exists()
