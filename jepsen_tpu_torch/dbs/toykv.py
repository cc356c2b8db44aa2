"""toykv: a real networked KV store + the suite that tests it.

The minimal end-to-end DB suite, playing the role of the reference's
zookeeper exemplar (`zookeeper/src/jepsen/zookeeper.clj:1-145`): a DB
lifecycle implementation (install, daemon start/stop with pidfiles and
readiness polling, log collection — db.clj:11-41 protocols), a
workload client, a process-kill nemesis, and a CLI main wired through
`cli.single_test_cmd` — all against *live TCP servers* launched
through the control layer (localexec remote by default, any Remote in
principle).

The store itself is deliberately small but honest: a line-protocol
TCP server, one per node, sharding keys by hash; each write appends to
an fsync'd recovery log and state replays on restart, so kill -9 is
survivable (run with --volatile to watch the linearizability checker
catch the resulting data loss). Ops use [k v] independent tuples; the
suite workload is `workloads.linearizable_register` over the sharded
cluster, each key decided by the competition race, whose device lane
runs the `wgl32_chunk` kernel on the card.

The port's copy of `jepsen_tpu/dbs/toykv.py`. Its own choices: the
servers listen from `BASE_PORT` 31850 (the reference's from 21850, so
that both packages' clusters can run on one host at once: `grepkill`
matches the port in a server's command line); `--device` (default the
card; a missing card raises before any node is set up, `--device cpu`
runs the plain PyTorch lane); the store root `store/torch`.

    python -m jepsen_tpu_torch.dbs.toykv test --nodes a,b,c
"""

from __future__ import annotations

import socket
import sys
import threading
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..util import resolve_device
from ..workloads import linearizable_register

BASE_PORT = 31850

# The server program uploaded to each node. Kept as source here (the
# suite uploads and runs it like the reference uploads clock programs,
# nemesis/time.clj:20-39) so the node needs nothing but python3.
SERVER_SRC = r'''
import argparse, os, socket, socketserver, sys, threading

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--state", default="state.log")
p.add_argument("--volatile", action="store_true",
               help="skip the recovery log: kill -9 loses data")
args = p.parse_args()

DATA, LOCK = {}, threading.Lock()

def replay():
    if args.volatile or not os.path.exists(args.state):
        return
    with open(args.state) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 2:
                continue
            if parts[0].startswith("set:"):
                DATA.setdefault(parts[0], set()).add(parts[1])
            else:
                DATA[parts[0]] = parts[1]

def persist(k, v):
    if args.volatile:
        return
    with open(args.state, "a") as fh:
        fh.write(f"{k}\t{v}\n")
        fh.flush()
        os.fsync(fh.fileno())

class Handler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            line = self.rfile.readline()
            if not line:
                return
            parts = line.decode().rstrip("\n").split(" ")
            with LOCK:
                out = self.apply(parts)
            self.wfile.write((out + "\n").encode())
            self.wfile.flush()

    def apply(self, parts):
        cmd = parts[0]
        if cmd == "R":
            return "OK " + DATA.get(parts[1], "nil")
        if cmd == "W":
            DATA[parts[1]] = parts[2]
            persist(parts[1], parts[2])
            return "OK"
        if cmd == "CAS":
            k, old, new = parts[1], parts[2], parts[3]
            if DATA.get(k, "nil") == old:
                DATA[k] = new
                persist(k, new)
                return "OK"
            return "FAIL"
        if cmd == "SADD":
            s = DATA.setdefault("set:" + parts[1], set())
            s.add(parts[2])
            persist("set:" + parts[1], parts[2])
            return "OK"
        if cmd == "SMEMBERS":
            s = DATA.get("set:" + parts[1], set())
            return "OK " + ",".join(sorted(s))
        return "ERR unknown " + cmd

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

replay()
print("toykv serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Handler).serve_forever()
'''

PIDFILE = "toykv.pid"
LOGFILE = "server.log"


def node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, BASE_PORT, "toykv_ports")


def node_for_key(test: dict, k) -> str:
    from . import node_for_key as _shared
    return _shared(test, k)


class ToyKVDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Install + daemon lifecycle (zookeeper.clj db; db.clj:11-41)."""

    def __init__(self, volatile: bool = False,
                 env: Optional[dict] = None):
        self.volatile = volatile
        self.env = env  # extra daemon env, e.g. a faultlib preload

    def _start(self, test, node):
        args = ["toykv_server.py", "--port", str(node_port(test, node))]
        if self.volatile:
            args.append("--volatile")
        # chdir=$PWD: start-stop-daemon --background daemonizes with
        # chdir("/"), which would make every node share /state.log;
        # $PWD expands on the node to its own working directory
        nodeutil.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE,
             "exec": "/usr/bin/python3",
             "env": self.env,
             "chdir": control.lit("$PWD")},
            "/usr/bin/python3", *args)
        nodeutil.await_tcp_port(node_port(test, node), timeout_s=30)

    def setup(self, test, node):
        # defensively kill any orphan from a crashed previous run —
        # it would hold the port with stale state (the standard suite
        # grepkill-before-start move, e.g. tidb/db.clj)
        nodeutil.grepkill(f"toykv_server.py --port "
                          f"{node_port(test, node)}")
        control.exec_("bash", "-c",
                      f"cat > toykv_server.py <<'TOYKV_EOF'\n"
                      f"{SERVER_SRC}\nTOYKV_EOF")
        control.exec_("rm", "-f", "state.log")
        self._start(test, node)

    def teardown(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill(f"toykv_server.py --port "
                          f"{node_port(test, node)}")
        control.exec_("rm", "-f", "state.log", "toykv_server.py")

    # -- db.Process (kill/restart faults) --
    def start(self, test, node):
        self._start(test, node)
        return "started"

    def kill(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        return "killed"

    def log_files(self, test, node):
        return [LOGFILE]


class ToyKVClient(jclient.Client):
    """Routes each [k v] op to the node owning the key; one lazy TCP
    connection per node. Connection errors surface as :info (the op
    may or may not have applied) — exactly how real suite clients
    behave under a process-kill nemesis."""

    def __init__(self):
        self.socks: dict = {}
        self.lock = threading.Lock()

    def open(self, test, node):
        c = ToyKVClient()
        return c

    def _sock(self, test, node):
        s = self.socks.get(node)
        if s is None:
            s = socket.create_connection(
                ("127.0.0.1", node_port(test, node)), timeout=5)
            s.settimeout(5)
            self.socks[node] = s
        return s

    def _round_trip(self, test, node, msg: str) -> str:
        with self.lock:
            try:
                s = self._sock(test, node)
                s.sendall((msg + "\n").encode())
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = s.recv(4096)
                    if not chunk:
                        raise ConnectionError("server closed")
                    buf += chunk
                return buf.decode().strip()
            except (OSError, ConnectionError):
                self.socks.pop(node, None)
                raise

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"toykv wants [k v] tuple values, got {kv!r}")
        k, v = kv
        node = node_for_key(test, k)
        f = op["f"]
        try:
            if f == "read":
                out = self._round_trip(test, node, f"R {k}")
                val = out.split(" ", 1)[1]
                return {**op, "type": "ok",
                        "value": tuple_(k, None if val == "nil"
                                        else int(val))}
            if f == "write":
                self._round_trip(test, node, f"W {k} {v}")
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                out = self._round_trip(test, node,
                                       f"CAS {k} {old} {new}")
                return {**op, "type": "ok" if out == "OK" else "fail"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError) as e:
            # indeterminate: the server may have applied it
            return {**op, "type": "info", "error": str(e)}

    def close(self, test):
        for s in self.socks.values():
            try:
                s.close()
            except OSError:
                pass


class ToyKVSetClient(jclient.Client):
    """Set workload client: add x / read-all against one shared set on
    node 0 — the workload that makes durability violations observable
    (register reads of nil are model wildcards; lost set elements are
    not)."""

    def __init__(self):
        self.kv = ToyKVClient()

    def open(self, test, node):
        c = ToyKVSetClient()
        return c

    def invoke(self, test, op):
        node = test["nodes"][0]
        try:
            if op["f"] == "add":
                self.kv._round_trip(test, node, f"SADD s {op['value']}")
                return {**op, "type": "ok"}
            if op["f"] == "read":
                out = self.kv._round_trip(test, node, "SMEMBERS s")
                rest = out.split(" ", 1)
                vals = [int(x) for x in rest[1].split(",") if x] \
                    if len(rest) > 1 else []
                return {**op, "type": "ok", "value": vals}
            raise ValueError(f"unknown op {op['f']!r}")
        except (OSError, ConnectionError) as e:
            return {**op, "type": "info", "error": str(e)}

    def close(self, test):
        self.kv.close(test)


class ToyKVSeqClient(jclient.Client):
    """Sequential workload client (workloads.sequential contract): a
    write inserts key k's subkeys k_0..k_{n-1} IN ORDER as separate
    per-node writes (sharded by subkey, so they land on different
    servers); a read fetches them in REVERSE. Client order makes the
    history sequentially consistent on a durable cluster; a volatile
    node that loses an early subkey after acknowledging it surfaces as
    a trailing-nil violation."""

    def __init__(self):
        self.kv = ToyKVClient()

    def open(self, test, node):
        return ToyKVSeqClient()

    def invoke(self, test, op):
        from ..workloads.sequential import DEFAULT_KEY_COUNT, subkeys
        kc = test.get("key_count") or DEFAULT_KEY_COUNT
        try:
            if op["f"] == "write":
                for sk in subkeys(kc, op["value"]):
                    node = node_for_key(test, sk)
                    self.kv._round_trip(test, node, f"W {sk} 1")
                return {**op, "type": "ok"}
            if op["f"] == "read":
                k = op["value"][0]
                out = []
                for sk in reversed(subkeys(kc, k)):
                    node = node_for_key(test, sk)
                    got = self.kv._round_trip(test, node, f"R {sk}")
                    val = got.split(" ", 1)[1]
                    out.append(None if val == "nil" else sk)
                return {**op, "type": "ok",
                        "value": [k, out]}
            raise ValueError(f"unknown op {op['f']!r}")
        except (OSError, ConnectionError) as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)}

    def close(self, test):
        self.kv.close(test)


def kill_restart_nemesis(db: ToyKVDB):
    """Kill the server on a random node on :start, restart on :stop
    (node_start_stopper, nemesis.clj:452-495)."""
    def targeter(nodes):
        return [gen.RNG.choice(nodes)]
    return jnemesis.node_start_stopper(
        targeter,
        lambda test, node: db.kill(test, node),
        lambda test, node: db.start(test, node))


def toykv_test(options: dict) -> dict:
    """Build the full test map from CLI options (zookeeper.clj
    zk-test). `workload`: register (default) or sequential. The register
    checker's device lane runs on `options["device"]` (default the
    card), resolved here, so that a missing card raises before any node
    is set up."""
    device = resolve_device(options.get("device"))
    nodes = options["nodes"]
    volatile = bool(options.get("volatile"))
    db = ToyKVDB(volatile=volatile)
    which = options.get("workload") or "register"
    extra: dict = {}
    if which == "sequential":
        from ..workloads import sequential
        # writers take half the worker threads, so at least one reader
        # exists at any concurrency >= 2 (all-writer runs would make
        # the checker pass vacuously)
        n_writers = max(1, int(options["concurrency"]) // 2)
        w = sequential.workload({"n_writers": n_writers})
        client: jclient.Client = ToyKVSeqClient()
        extra["key_count"] = w["key_count"]
    elif which == "register":
        w = linearizable_register.workload(
            {"nodes": nodes,
             "concurrency": options["concurrency"],
             "per_key_limit": options.get("per_key_limit") or 40,
             "algorithm": "competition",
             "device": device})
        client = ToyKVClient()
    else:
        raise ValueError(f"unknown workload {which!r}")
    nem_interval = options.get("nemesis_interval") or 10.0
    return {
        "name": options.get("name") or "toykv",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "remote": localexec.remote(options.get("sandbox")
                                   or "toykv-cluster"),
        "ssh": {"dummy?": False},
        "db": db,
        "client": client,
        "nemesis": kill_restart_nemesis(db),
        "checker": jchecker.compose({
            which: w["checker"],
            "stats": jchecker.unhandled_exceptions(),
            "logs": jchecker.log_file_pattern(r"Traceback", LOGFILE),
        }),
        "generator": gen.time_limit(
            options.get("time_limit") or 30,
            gen.nemesis(
                gen.cycle([gen.sleep(nem_interval),
                           {"type": "info", "f": "start"},
                           gen.sleep(nem_interval),
                           {"type": "info", "f": "stop"}]),
                w["generator"])),
        **extra,
    }


TOYKV_OPTS = [
    cli.Opt("name", metavar="NAME", default="toykv"),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Where to write results"),
    cli.Opt("sandbox", metavar="DIR", default="toykv-cluster",
            help="Node sandbox directory for the localexec remote"),
    cli.Opt("per_key_limit", metavar="N", default=40, parse=int,
            help="Ops per key"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=10.0,
            parse=float, help="Seconds between kill/restart cycles"),
    cli.Opt("volatile", default=False,
            help="Run servers without the recovery log (kill -9 then "
                 "loses acknowledged writes; the checker should "
                 "catch it)"),
    cli.Opt("workload", metavar="NAME", default="register",
            help="register (independent cas-register) or sequential "
                 "(ordered subkey visibility)"),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's device lane runs (default: "
                 "the card)"),
]

def toykv_tests(options: dict):
    """tests_fn for `test-all`: the sweep of durability x fault cadence
    (the tidb all-combos pattern, tidb/src/tidb/core.clj:46-120 —
    scaled to this suite's two axes)."""
    base = options.get("nemesis_interval") or 10.0
    for volatile in (False, True):
        for interval in (base, base / 2):
            opts = dict(options, volatile=volatile,
                        nemesis_interval=interval)
            opts["name"] = (f"{options.get('name') or 'toykv'}"
                            f"{'-volatile' if volatile else ''}"
                            f"-nem{interval:g}")
            yield toykv_test(opts)


COMMANDS = {
    **cli.single_test_cmd({"test_fn": toykv_test,
                           "opt_spec": TOYKV_OPTS}),
    **cli.test_all_cmd({"tests_fn": toykv_tests,
                        "opt_spec": TOYKV_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
