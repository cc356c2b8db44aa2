"""LogCabin test suite — the raft-reference-implementation family
(logcabin/src/jepsen/logcabin.clj, 246 LoC; LogCabin is the original
RAFT paper's companion implementation).

The reference's client is unusual: it shells the `TreeOps` example
binary ON THE NODES over the control plane (logcabin.clj:130-177) —
reads, writes, and conditional writes against the replicated tree at
`/jepsen` — rather than speaking a wire protocol. This suite keeps
that structure (the zookeeper-suite transport pattern): the client
execs a TreeOps-shaped CLI through the `control` facade, so the
whole L0 remote stack is exercised per operation.

Workload: one linearizable CAS register (read / write / cas with a
condition — TreeOps' --condition flag), checked against the
CAS-register model; partition nemesis in source mode.

``mini`` mode (default) uploads a TreeOps-shaped CLI plus a LIVE
tree server (fsync'd op log, kill -9 recovery) and runs everything
over localexec; ``source`` mode emits the real build recipe — scons
build from git, per-node serverId config, --bootstrap on the
primary, daemon start, and the Reconfigure example adding the rest
(logcabin.clj:23-115) — command-assertion tested.

The port's copy of `jepsen_tpu/dbs/logcabin.py`. Its own choices: the
mini tree servers listen from `MINI_BASE_PORT` 31600 (the reference's
from 30200, so that both packages' servers can run on one host at once;
below Linux's ephemeral range, 32768-60999; `source` mode keeps
LogCabin's `PORT` 5254); `--device`, passed to the `linear` checker's
competition race, whose device lane runs the WGL chunk kernels there
(default the card: a missing card raises before any node is set up,
`--device cpu` runs their plain PyTorch versions); the store root
`store/torch`. `MINITREE_SRC` and `TREEOPS_SRC` are the reference's,
byte for byte.

    python -m jepsen_tpu_torch.dbs.logcabin test --nodes l1 --device cpu \
        --time-limit 6
"""

from __future__ import annotations

import sys
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..ledger import BASE_DIR
from ..models import cas_register
from ..os_setup import Debian
from ..util import resolve_device
from . import miniserver, retryclient

PORT = 5254
MINI_BASE_PORT = 31600
TREE_PATH = "/jepsen"


# -- the LIVE mini server (replicated tree stand-in) --------------------------

MINITREE_SRC = r'''
import argparse, json, os, socketserver, threading

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

LOG_PATH = os.path.join(args.dir, "minitree.jsonl")
TREE, LOCK = {}, threading.Lock()

def replay():
    if not os.path.exists(LOG_PATH):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail
            TREE[rec["path"]] = rec["value"]

def persist(path, value):
    with open(LOG_PATH, "a") as fh:
        fh.write(json.dumps({"path": path, "value": value}) + "\n")
        fh.flush()
        os.fsync(fh.fileno())

class Conn(socketserver.StreamRequestHandler):
    def handle(self):
        line = self.rfile.readline()
        if not line:
            return
        req = json.loads(line)
        with LOCK:
            op = req["op"]
            if op == "read":
                out = {"ok": True,
                       "value": TREE.get(req["path"])}
            elif op == "write":
                if "condition" in req and \
                        TREE.get(req["path"]) != req["condition"]:
                    out = {"ok": False, "error": "CONDITION_NOT_MET",
                           "value": TREE.get(req["path"])}
                else:
                    TREE[req["path"]] = req["value"]
                    persist(req["path"], req["value"])
                    out = {"ok": True}
            else:
                out = {"ok": False, "error": "bad op"}
        self.wfile.write((json.dumps(out) + "\n").encode())
        self.wfile.flush()

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

replay()
print("minitree serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Conn).serve_forever()
'''

# The TreeOps-shaped CLI the client execs on nodes (the reference
# shells /root/TreeOps the same way, logcabin.clj:134-177). Exits 0
# on success, 1 on CONDITION_NOT_MET (printing the current value),
# 2 on connection trouble.
TREEOPS_SRC = r'''
import json, socket, sys

args = sys.argv[1:]
port = int(args[args.index("--port") + 1])
cmd = args[args.index("--port") + 2]
path = args[args.index("--port") + 3]
req = {"op": cmd, "path": path}
if cmd == "write":
    req["value"] = args[args.index("--port") + 4]
    if "--condition" in args:
        req["condition"] = args[args.index("--condition") + 1]
try:
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall((json.dumps(req) + "\n").encode())
    out = json.loads(s.makefile("rb").readline())
except OSError as e:
    print("connection error:", e, file=sys.stderr)
    sys.exit(2)
if out.get("ok"):
    if "value" in out:
        print(json.dumps(out["value"]))
    sys.exit(0)
print(out.get("error", "?"), json.dumps(out.get("value")))
sys.exit(1)
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "logcabin_ports")


class MiniTreeDB(miniserver.MiniServerDB):
    script = "minitree.py"
    src = MINITREE_SRC
    pidfile = "minitree.pid"
    logfile = "minitree.out"
    data_files = ("minitree.jsonl",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]

    def setup(self, test, node):
        super().setup(test, node)
        # the TreeOps-shaped CLI rides along (zookeeper's zkCli
        # pattern: the client execs it over the control plane)
        control.exec_("bash", "-c",
                      "cat > treeops.py <<'TREEOPS_EOF'\n"
                      f"{TREEOPS_SRC}\nTREEOPS_EOF")


class LogCabinDB(jdb.DB, jdb.Primary, jdb.LogFiles):
    """Source-build automation (logcabin.clj:23-115): scons build,
    serverId config, --bootstrap on the primary, daemon start;
    Reconfigure adds the rest AFTER every node's daemon is up (the
    db.cycle Primary hook provides the barrier the reference built
    with jepsen/synchronize)."""

    def setup(self, test, node):
        primary = test["nodes"][0]
        server_id = str(test["nodes"].index(node) + 1)
        with control.su():
            control.exec_("apt-get", "install", "-y", "git-core",
                          "protobuf-compiler", "libprotobuf-dev",
                          "libcrypto++-dev", "g++", "scons")
            control.exec_("git", "clone", "--depth", "1",
                          "https://github.com/logcabin/"
                          "logcabin.git", "/logcabin")
            with control.cd("/logcabin"):
                control.exec_("git", "submodule", "update",
                              "--init")
                control.exec_("scons")
            control.exec_("cp", "-f", "/logcabin/build/LogCabin",
                          "/root")
            control.exec_("cp", "-f",
                          "/logcabin/build/Examples/Reconfigure",
                          "/root")
            control.exec_("cp", "-f",
                          "/logcabin/build/Examples/TreeOps",
                          "/root")
            nodeutil.write_file(
                f"serverId = {server_id}\n"
                f"listenAddresses = {node}:{PORT}\n",
                "/root/logcabin.conf")
            if node == primary:
                control.exec_("/root/LogCabin", "-c",
                              "/root/logcabin.conf", "-l",
                              "/root/logcabin.log", "--bootstrap")
            control.exec_("/root/LogCabin", "-c",
                          "/root/logcabin.conf", "-d", "-l",
                          "/root/logcabin.log", "-p",
                          "/root/logcabin.pid")
        nodeutil.await_tcp_port(PORT, timeout_s=120)

    # -- db.Primary: runs once on nodes[0], after EVERY node's
    # setup has completed (all daemons listening) --
    def primaries(self, test):
        return [test["nodes"][0]]

    def setup_primary(self, test, node):
        with control.su():
            control.exec_(
                "/root/Reconfigure", "-c",
                ",".join(f"{n}:{PORT}" for n in test["nodes"]),
                "set", *[f"{n}:{PORT}" for n in test["nodes"]])

    def teardown(self, test, node):
        with control.su():
            nodeutil.grepkill("LogCabin")
            control.exec_("rm", "-rf", "/root/storage",
                          "/root/logcabin.pid")

    def log_files(self, test, node):
        return ["/root/logcabin.log"]


# -- client -------------------------------------------------------------------

class TreeOpsClient(jclient.Client):
    """CAS register by shelling the TreeOps CLI over the control
    plane (logcabin.clj cas-client:115-177). Exit 1 with
    CONDITION_NOT_MET = definite cas fail; exit 2 = connection
    trouble (info for writes)."""

    def __init__(self, port_fn=None):
        self.port_fn = port_fn or (lambda test, node: PORT)
        self.node: Optional[str] = None

    def open(self, test, node):
        c = type(self)(self.port_fn)
        c.node = node
        return c

    def _treeops(self, test, *args) -> tuple:
        """(exit, out) of one CLI run on the node."""
        port = self.port_fn(test, self.node)
        try:
            # -S skips site init: a site customization may import
            # heavy packages on every bare python3 start, and the CLI
            # only needs the stdlib
            out = control.exec_("python3", "-S", "treeops.py",
                                "--port", str(port), *args)
            return 0, (out or "").strip()
        except control.NonzeroExit as e:
            res = e.result
            return (res.get("exit", 2),
                    ((res.get("out") or "")
                     + (res.get("err") or "")).strip())

    def invoke(self, test, op):
        import json as _json
        f = op["f"]
        with control.on(self.node):
            if f == "read":
                code, out = self._treeops(test, "read", TREE_PATH)
                if code != 0:
                    return {**op, "type": "fail",
                            "error": out[:200]}
                val = _json.loads(out) if out else None
                return {**op, "type": "ok",
                        "value": int(val) if val is not None
                        else None}
            if f == "write":
                code, out = self._treeops(
                    test, "write", TREE_PATH, str(int(op["value"])))
                if code == 0:
                    return {**op, "type": "ok"}
                return {**op, "type": "info", "error": out[:200]}
            if f == "cas":
                old, new = op["value"]
                code, out = self._treeops(
                    test, "write", TREE_PATH, str(int(new)),
                    "--condition", str(int(old)))
                if code == 0:
                    return {**op, "type": "ok"}
                if code == 1:
                    return {**op, "type": "fail",
                            "error": "condition not met"}
                return {**op, "type": "info", "error": out[:200]}
            raise ValueError(f"unknown op {f!r}")

    def setup(self, test):
        pass

    def close(self, test):
        pass


def _r(test, ctx):
    return {"f": "read", "value": None}


def _w(test, ctx):
    return {"f": "write", "value": gen.RNG.randrange(5)}


def _cas(test, ctx):
    return {"f": "cas", "value": [gen.RNG.randrange(5),
                                  gen.RNG.randrange(5)]}


def logcabin_test(options: dict) -> dict:
    """The `linear` check's device lane runs on `options["device"]`
    (default the card), resolved here, so that a missing card raises
    before any node is set up."""
    device = resolve_device(options.get("device"))
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    client = TreeOpsClient()
    if mode == "mini":
        db: jdb.DB = MiniTreeDB()
        client.port_fn = lambda test, node: mini_node_port(
            test, test["nodes"][0])
        nemesis = jnemesis.node_start_stopper(
            retryclient.kill_targets(mode),
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "logcabin-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "source":
        db = LogCabinDB()
        nemesis = jnemesis.partition_random_halves()
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    interval = options.get("nemesis_interval") or 3.0
    return {
        "name": options.get("name") or f"logcabin-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "nemesis": nemesis,
        "checker": jchecker.compose({
            "linear": jchecker.linearizable(
                cas_register(None), algorithm="competition",
                device=device),
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": gen.time_limit(
            options.get("time_limit") or 10,
            gen.nemesis(
                gen.cycle([gen.sleep(interval),
                           {"type": "info", "f": "start"},
                           gen.sleep(interval),
                           {"type": "info", "f": "stop"}]),
                gen.stagger(0.05, gen.mix([_r, _w, _cas])))),
        **extra,
    }


LOGCABIN_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo tree servers + uploaded "
                 "TreeOps CLI) or source (scons-built LogCabin on "
                 "--ssh nodes)"),
    cli.Opt("sandbox", metavar="DIR", default="logcabin-cluster"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's kernels run (default: the "
                 "card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": logcabin_test,
                           "opt_spec": LOGCABIN_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
