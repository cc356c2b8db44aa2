"""Redis test suite — the redis-protocol family exemplar (the
reference ships disque, antirez's redis-derived queue:
disque/src/jepsen/disque.clj; this suite speaks the same RESP wire
protocol against stock redis).

DB automation builds redis from a release tarball (the disque suite's
clone-and-make pattern) and drives redis-server with a pidfile +
logfile; the client is a from-scratch RESP2 codec over one TCP
connection per worker — GET/SET for reads and writes, and CAS as an
atomic server-side Lua script (EVAL compare-and-set), the idiomatic
redis recipe. Ops ride [k v] independent tuples.

Two server modes:

- ``source`` — the production path: wget/untar/make real redis on each
  (SSH/docker) node.
- ``mini`` (default when no cluster is configured) — a LIVE subprocess
  per node running the in-repo mini-redis (`MINIREDIS_SRC`): a real
  RESP2 server with an fsync'd append-only file, started/killed
  through the same DB automation over the localexec sandbox remote —
  so CI exercises install -> daemon start -> real TCP workload ->
  kill -9 nemesis -> AOF replay -> checker against live processes
  (the toykv pattern), speaking the genuine wire protocol end to end.

The port's copy of `jepsen_tpu/dbs/redis.py`. Its own choices: the mini
servers listen from `MINI_BASE_PORT` 32350 (the reference's from 22350,
so that both packages' clusters can run on one host at once; `source`
mode keeps stock redis's `PORT` 6379); `--device` (default the card; a
missing card raises before any node is set up, `--device cpu` runs the
plain PyTorch lane of the register check); the store root `store/torch`.

    python -m jepsen_tpu_torch.dbs.redis test --nodes r1,r2 --device cpu
"""

from __future__ import annotations

import socket
import sys
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import net as jnet
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..os_setup import Debian
from ..util import resolve_device
from ..workloads import linearizable_register
from . import miniserver

VERSION = "7.2.5"
PORT = 6379
DIR = "/opt/redis"
PIDFILE = f"{DIR}/redis.pid"
LOGFILE = f"{DIR}/redis.log"

CAS_LUA = ("if redis.call('GET', KEYS[1]) == ARGV[1] then "
           "redis.call('SET', KEYS[1], ARGV[2]); return 1 "
           "else return 0 end")


def tarball_url(version: str) -> str:
    return f"https://download.redis.io/releases/redis-{version}.tar.gz"


# -- mini-redis: the in-repo live server ------------------------------------

MINI_BASE_PORT = 32350
MINI_PIDFILE = "miniredis.pid"
MINI_LOGFILE = "miniredis.log"

# A real RESP2 server, not a line-protocol toy: commands arrive as RESP
# arrays, replies use the full tag set, and writes append the encoded
# SET to an fsync'd AOF that replays on boot (redis's appendonly
# design). EVAL supports exactly the suite's CAS script — recognized by
# text and executed atomically server-side, which is the semantics the
# suite depends on (general Lua would need an interpreter; anything
# else errors like a syntax-checking redis would).
MINIREDIS_SRC = r'''
import argparse, os, socketserver, threading

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--appendonly", default="yes")
p.add_argument("--dir", default=".")
args = p.parse_args()

AOF = os.path.join(args.dir, "appendonly.aof")
DATA, LOCK = {}, threading.Lock()
CAS_LUA = "__CAS_LUA__"
__RESP_COMMON__

def replay():
    if args.appendonly != "yes" or not os.path.exists(AOF):
        return
    with open(AOF, "rb") as fh:
        while True:
            try:
                cmd = read_resp(fh)
            except ValueError:
                break  # torn tail after a crash: ignore, like redis
            if cmd is None:
                break
            if not cmd:
                continue
            if cmd[0].upper() == "SET":
                DATA[cmd[1]] = cmd[2]
            elif cmd[0].upper() == "MSET":
                pairs = cmd[1:]
                for i in range(0, len(pairs) - 1, 2):
                    DATA[pairs[i]] = pairs[i + 1]
            elif cmd[0].upper() == "DEL":
                for k in cmd[1:]:
                    DATA.pop(k, None)

def persist(*cmd):
    if args.appendonly != "yes":
        return
    with open(AOF, "ab") as fh:
        fh.write(enc_cmd(list(cmd)))
        fh.flush()
        os.fsync(fh.fileno())

class Handler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            try:
                cmd = read_resp(self.rfile)
            except ValueError:
                self.wfile.write(b"-ERR protocol error\r\n")
                return
            if cmd is None:
                return
            self.wfile.write(self.apply(cmd))
            self.wfile.flush()

    def apply(self, cmd):
        op = cmd[0].upper()
        with LOCK:
            if op == "PING":
                return b"+PONG\r\n"
            if op == "GET":
                v = DATA.get(cmd[1])
                if v is None:
                    return b"$-1\r\n"
                b = v.encode()
                return b"$%d\r\n%s\r\n" % (len(b), b)
            if op == "SET":
                DATA[cmd[1]] = cmd[2]
                persist("SET", cmd[1], cmd[2])
                return b"+OK\r\n"
            if op == "DEL":
                n = sum(1 for k in cmd[1:] if DATA.pop(k, None)
                        is not None)
                if n:  # acknowledged deletes must survive kill -9 too
                    persist("DEL", *cmd[1:])
                return b":%d\r\n" % n
            if op == "MGET":
                # atomic under LOCK like real single-threaded redis:
                # the snapshot the long-fork/multi-key reads rely on
                out = [b"*%d\r\n" % (len(cmd) - 1)]
                for k in cmd[1:]:
                    v = DATA.get(k)
                    if v is None:
                        out.append(b"$-1\r\n")
                    else:
                        b = v.encode()
                        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
                return b"".join(out)
            if op == "MSET":
                pairs = cmd[1:]
                if len(pairs) % 2:
                    return b"-ERR wrong number of arguments\r\n"
                for i in range(0, len(pairs), 2):
                    DATA[pairs[i]] = pairs[i + 1]
                persist("MSET", *pairs)
                return b"+OK\r\n"
            if op == "EVAL":
                if cmd[1] != CAS_LUA:
                    return b"-ERR unsupported script\r\n"
                key, old, new = cmd[3], cmd[4], cmd[5]
                if DATA.get(key) == old:
                    DATA[key] = new
                    persist("SET", key, new)
                    return b":1\r\n"
                return b":0\r\n"
            return b"-ERR unknown command '%s'\r\n" % op.encode()

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

replay()
print("miniredis serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Handler).serve_forever()
'''

# One source of truth for the script text: the server recognizes the
# suite's CAS script by EXACT text, so the embedded copy must be the
# module constant, not a duplicate that can drift. The shared RESP
# codec splices in the same way (miniserver.build_src).
MINIREDIS_SRC = miniserver.build_src(
    MINIREDIS_SRC.replace("__CAS_LUA__", CAS_LUA))


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "redis_ports")


def node_for_key(test: dict, k) -> str:
    from . import node_for_key as _shared
    return _shared(test, k)


class MiniRedisDB(miniserver.MiniServerDB):
    """Upload + daemon lifecycle for the in-repo mini-redis: the same
    protocol surface as `RedisDB` but installable on any node with
    python3 — which is what lets CI run the whole suite against live
    processes (localexec remote). Lifecycle shared with every mini
    server (miniserver.MiniServerDB)."""

    script = "miniredis.py"
    src = MINIREDIS_SRC
    pidfile = MINI_PIDFILE
    logfile = MINI_LOGFILE
    data_files = ("appendonly.aof",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--appendonly", "yes", "--dir", "."]


class RedisDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Build-from-source install + daemon lifecycle (the disque
    suite's pattern: wget/untar/make, then run the server with
    explicit pidfile/logfile)."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, test, node):
        nodeutil.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
            f"{DIR}/src/redis-server",
            "--port", str(PORT),
            "--appendonly", "yes",
            "--dir", DIR,
            "--protected-mode", "no")
        nodeutil.await_tcp_port(PORT, timeout_s=60)

    def setup(self, test, node):
        with control.su():
            nodeutil.install_archive(tarball_url(self.version), DIR)
            control.exec_("make", "-C", DIR, "-j2")
        self._start(test, node)

    def teardown(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("redis-server")
        with control.su():
            # redis 7.x writes multi-part AOFs under appendonlydir/
            control.exec_("rm", "-rf", f"{DIR}/appendonlydir",
                          f"{DIR}/appendonly.aof", f"{DIR}/dump.rdb",
                          LOGFILE)

    def start(self, test, node):
        self._start(test, node)
        return "started"

    def kill(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("redis-server")
        return "killed"

    def log_files(self, test, node):
        return [LOGFILE]


# -- RESP2 wire codec -------------------------------------------------------

def resp_encode(args: list) -> bytes:
    """Client command as a RESP array of bulk strings."""
    out = [f"*{len(args)}\r\n".encode()]
    for a in args:
        b = str(a).encode()
        out.append(b"$" + str(len(b)).encode() + b"\r\n" + b + b"\r\n")
    return b"".join(out)


def resp_read(rf) -> object:
    """One RESP2 reply from a buffered reader: simple string, error,
    integer, bulk string (None for nil), or array."""
    line = rf.readline()
    if not line:
        raise ConnectionError("server closed")
    tag, rest = line[:1], line[1:].strip()
    if tag == b"+":
        return rest.decode()
    if tag == b"-":
        raise RedisError(rest.decode())
    if tag == b":":
        return int(rest)
    if tag == b"$":
        n = int(rest)
        if n == -1:
            return None
        data = rf.read(n + 2)
        if len(data) < n + 2:  # connection died mid-reply: a partial
            # value must never complete an op as "ok"
            raise ConnectionError("short read in bulk reply")
        return data[:n].decode()
    if tag == b"*":
        n = int(rest)
        if n == -1:
            return None
        return [resp_read(rf) for _ in range(n)]
    raise ValueError(f"bad RESP tag {tag!r}")


class RedisError(Exception):
    pass


class RedisConn:
    """One blocking RESP connection."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.rf = self.sock.makefile("rb")

    def cmd(self, *args):
        self.sock.sendall(resp_encode(list(args)))
        return resp_read(self.rf)

    def close(self):
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


class RedisClient(jclient.Client):
    """CAS-register client: GET/SET plus Lua compare-and-set. One lazy
    connection per target node. `port_fn` maps a node to (host, port) —
    tests point it at in-process stubs; `route_fn(test, k)` picks the
    node owning key k (hash sharding for standalone-server clusters);
    without it every op goes to the worker's own node."""

    def __init__(self, port_fn=None, timeout: float = 5.0,
                 route_fn=None):
        self.port_fn = port_fn or (lambda test, node: (node, PORT))
        self.route_fn = route_fn
        self.timeout = timeout
        self.node: Optional[str] = None
        self.conns: dict = {}

    def open(self, test, node):
        c = RedisClient(self.port_fn, self.timeout, self.route_fn)
        c.node = node
        return c

    def _conn(self, test, node) -> RedisConn:
        conn = self.conns.get(node)
        if conn is None:
            host, port = self.port_fn(test, node)
            conn = RedisConn(host, port, self.timeout)
            self.conns[node] = conn
        return conn

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"redis wants [k v] tuples, got {kv!r}")
        k, v = kv
        key = f"jepsen:{k}"
        f = op["f"]
        node = (self.route_fn(test, k) if self.route_fn
                else self.node)
        try:
            conn = self._conn(test, node)
            if f == "read":
                cur = conn.cmd("GET", key)
                return {**op, "type": "ok",
                        "value": tuple_(k, None if cur is None
                                        else int(cur))}
            if f == "write":
                conn.cmd("SET", key, v)
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                won = conn.cmd("EVAL", CAS_LUA, 1, key, old, new)
                return {**op, "type": "ok" if won == 1 else "fail"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, RedisError) as e:
            stale = self.conns.pop(node, None)
            if stale is not None:
                stale.close()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def close(self, test):
        for conn in self.conns.values():
            conn.close()


def redis_test(options: dict) -> dict:
    """Test map from CLI options (disque.clj suite shape: register
    workload under a kill/restart nemesis).

    `server` option: "mini" (the default — live in-repo mini-redis
    subprocesses over the localexec sandbox remote, key-sharded
    standalone servers; ssh/nodes options are ignored) or "source"
    (build real redis from the release tarball on the SSH/docker
    cluster you point it at, each worker driving its own node). The
    default is static and documented rather than sniffed from the ssh
    options, because the CLI always materializes an ssh dict — pass
    --server source to drive a real cluster. The register checker's device
    lane runs on `options["device"]` (default the card), resolved here,
    so that a missing card raises before any node is set up."""
    device = resolve_device(options.get("device"))
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    if mode == "mini":
        # loud, because a user pointing --ssh at a real cluster
        # without --server source would otherwise silently get a
        # verdict about toy localhost servers
        import logging
        logging.getLogger(__name__).info(
            "server=mini: running in-repo mini-redis servers over "
            "localexec (ssh/nodes are local names); pass "
            "--server source to drive a real cluster")
    w = linearizable_register.workload(
        {"nodes": nodes,
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 100,
         "algorithm": "competition",
         "device": device})
    interval = options.get("nemesis_interval") or 10.0
    if mode == "mini":
        db: jdb.DB = MiniRedisDB()
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "redis-cluster"),
            "ssh": {"dummy?": False},
            "client": RedisClient(
                port_fn=lambda test, node:
                    ("127.0.0.1", mini_node_port(test, node)),
                route_fn=node_for_key),
        }
    elif mode == "source":
        db = RedisDB(options.get("version") or VERSION)
        extra = {
            "ssh": options.get("ssh") or {},
            "os": Debian(),
            "net": jnet.iptables(),
            "client": RedisClient(),
        }
    else:
        raise ValueError(f"unknown server mode {mode!r}")
    return {
        "name": options.get("name") or f"redis-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "nemesis": jnemesis.node_start_stopper(
            lambda nodes: [gen.RNG.choice(nodes)],
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node)),
        "checker": jchecker.compose({
            "register": w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": gen.time_limit(
            options.get("time_limit") or 30,
            gen.nemesis(
                gen.cycle([gen.sleep(interval),
                           {"type": "info", "f": "start"},
                           gen.sleep(interval),
                           {"type": "info", "f": "stop"}]),
                w["generator"])),
        **extra,
    }


REDIS_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Where to write results"),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (default: live in-repo RESP servers over "
                 "localexec) or source (build real redis from the "
                 "tarball on your --ssh cluster)"),
    cli.Opt("version", metavar="VERSION", default=VERSION,
            help="redis release to build (server=source)"),
    cli.Opt("sandbox", metavar="DIR", default="redis-cluster",
            help="Node sandbox dir for the localexec remote "
                 "(server=mini)"),
    cli.Opt("per_key_limit", metavar="N", default=100, parse=int,
            help="Ops per key"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=10.0,
            parse=float, help="Seconds between kill/restart cycles"),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's device lane runs (default: "
                 "the card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": redis_test,
                           "opt_spec": REDIS_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
