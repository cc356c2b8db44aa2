"""ZooKeeper test suite — the reference's minimal single-file exemplar
(zookeeper/src/jepsen/zookeeper.clj:1-145) rebuilt on this framework.

DB automation installs the distro zookeeper packages, writes per-node
`myid` and the cluster `zoo.cfg`, and drives the service; the client is
a CAS register on the /jepsen znode. Where the reference rides the JVM
avout/zk-atom client, this client shells out to `zkCli.sh` over the
control plane — znode versions make CAS honest (`set /jepsen v <ver>`
fails on a version mismatch), and the suite stays dependency-free.

Two server modes: ``release`` (the distro-package recipe above) and
``mini`` — a LIVE in-repo znode server per node (dataVersion'd znodes
with version-guarded SET over an fsync'd AOF) PLUS an uploaded
`zkcli.py` that prints zkCli.sh-shaped output, so the UNCHANGED
client exercises the full exec-a-CLI-over-the-control-plane path
against real subprocesses; kill -9 and SIGSTOP faults recover live
(VERDICT r3 #6).

The port's copy of `jepsen_tpu/dbs/zookeeper.py`. Its own choices: the
mini znode servers listen from `MINI_BASE_PORT` 30800 (the reference's
from 25100, so that both packages' servers can run on one host at once;
below Linux's ephemeral range, 32768-60999, where a client retrying a
down server's port could connect to itself and hold the port);
`--device`, passed to the `linear` checker's competition race, whose
device lane runs the WGL chunk kernels there (default the card: a
missing card raises before any node is set up, `--device cpu` runs
their plain PyTorch versions); the store root `store/torch`.

    python -m jepsen_tpu_torch.dbs.zookeeper test --nodes z1 \
        --server mini --device cpu --time-limit 6
"""

from __future__ import annotations

import re
import sys
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import net as jnet
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..ledger import BASE_DIR
from ..models import cas_register
from ..os_setup import Debian
from ..util import resolve_device
from . import miniserver

VERSION = "3.4.13-2"
CONF = "/etc/zookeeper/conf"
LOG = "/var/log/zookeeper/zookeeper.log"
ZKCLI = "/usr/share/zookeeper/bin/zkCli.sh"
ZNODE = "/jepsen"
PORT = 2181

ZOO_CFG = """tickTime=2000
initLimit=10
syncLimit=5
dataDir=/var/lib/zookeeper
clientPort=2181
"""


def node_ids(test: dict) -> dict:
    """node name -> numeric id (zookeeper.clj:20-31)."""
    return {n: i for i, n in enumerate(test["nodes"])}


def zoo_cfg_servers(test: dict) -> str:
    """server.N lines for zoo.cfg (zookeeper.clj:33-39)."""
    return "\n".join(f"server.{i}={n}:2888:3888"
                     for n, i in node_ids(test).items())


class ZkDB(jdb.DB, jdb.LogFiles):
    """ZooKeeper lifecycle (zookeeper.clj:41-73)."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        os = Debian()
        with control.su():
            os.install([f"zookeeper={self.version}",
                        f"zookeeper-bin={self.version}",
                        f"zookeeperd={self.version}"])
            nodeutil.write_file(str(node_ids(test)[node]),
                                f"{CONF}/myid")
            nodeutil.write_file(ZOO_CFG + "\n" + zoo_cfg_servers(test),
                                f"{CONF}/zoo.cfg")
            # restart often fails upstream; stop+start (zookeeper.clj:59-60)
            nodeutil.meh(control.exec_, "service", "zookeeper", "stop")
            control.exec_("service", "zookeeper", "start")
        nodeutil.await_tcp_port(PORT, timeout_s=60)

    def teardown(self, test, node):
        with control.su():
            nodeutil.meh(control.exec_, "service", "zookeeper", "stop")
            control.exec_("rm", "-rf",
                          control.lit("/var/lib/zookeeper/version-*"),
                          control.lit("/var/log/zookeeper/*"))

    def log_files(self, test, node):
        return [LOG]


MINI_BASE_PORT = 30800
MINI_PIDFILE = "minizk.pid"
MINI_LOGFILE = "minizk.log"

# A LIVE znode server: line protocol (GET/SET/CREATE path [...]) with
# per-znode dataVersion, version-guarded SET (the CAS primitive), and
# an fsync'd AOF so committed znode state survives kill -9.
MINIZK_SRC = r'''
import argparse, base64, os, socketserver, threading

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

AOF = os.path.join(args.dir, "zk.aof")
LOCK = threading.Lock()
NODES = {}  # path -> (data, version)

def persist(line):
    with open(AOF, "ab") as fh:
        fh.write(line.encode() + b"\n")
        fh.flush()
        os.fsync(fh.fileno())

def replay():
    if not os.path.exists(AOF):
        return
    with open(AOF) as fh:
        for raw in fh:
            parts = raw.split()
            if len(parts) != 4 or parts[0] != "S":
                continue
            try:
                NODES[parts[1]] = (
                    base64.b64decode(parts[3]).decode(),
                    int(parts[2]))
            except ValueError:
                continue  # torn tail

class H(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            line = self.rfile.readline()
            if not line:
                return
            parts = line.decode().split()
            self.wfile.write((self.apply(parts) + "\n").encode())
            self.wfile.flush()

    def apply(self, parts):
        if not parts:
            return "ERR empty"
        cmd = parts[0].upper()
        with LOCK:
            if cmd == "GET":
                ent = NODES.get(parts[1])
                if ent is None:
                    return "NONODE"
                data, ver = ent
                return "OK %d %s" % (
                    ver, base64.b64encode(data.encode()).decode())
            if cmd == "CREATE":
                if parts[1] in NODES:
                    return "EXISTS"
                data = parts[2] if len(parts) > 2 else ""
                persist("S %s 0 %s" % (
                    parts[1],
                    base64.b64encode(data.encode()).decode()))
                NODES[parts[1]] = (data, 0)
                return "OK 0"
            if cmd == "SET":
                ent = NODES.get(parts[1])
                if ent is None:
                    return "NONODE"
                data = parts[2] if len(parts) > 2 else ""
                cur_ver = ent[1]
                if len(parts) > 3 and int(parts[3]) != cur_ver:
                    return "BADVERSION"
                persist("S %s %d %s" % (
                    parts[1], cur_ver + 1,
                    base64.b64encode(data.encode()).decode()))
                NODES[parts[1]] = (data, cur_ver + 1)
                return "OK %d" % (cur_ver + 1)
            return "ERR unknown %s" % cmd

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

replay()
print("minizk serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), H).serve_forever()
'''

# The zkCli.sh stand-in: same argv contract (-server host:port "cmd"),
# zkCli-shaped output (the data line before cZxid, "dataVersion = N",
# "version No is not valid" on a CAS miss) — so ZkClient's parser
# works against both the real CLI and this one.
ZKCLI_SRC = r'''
import base64, socket, sys

server = sys.argv[sys.argv.index("-server") + 1]
command = sys.argv[-1]
host, port = server.rsplit(":", 1)
parts = command.split()

sock = socket.create_connection((host, int(port)), timeout=5)
rf = sock.makefile("rb")

def ask(*words):
    sock.sendall((" ".join(words) + "\n").encode())
    return rf.readline().decode().split()

if parts[0] == "get":
    r = ask("GET", parts[1])
    if r[0] == "NONODE":
        print("Node does not exist:", parts[1])
        sys.exit(1)
    data = base64.b64decode(r[2]).decode() if len(r) > 2 else ""
    print(data)
    print("cZxid = 0x0")
    print("dataVersion = %s" % r[1])
elif parts[0] == "create":
    r = ask("CREATE", parts[1], *parts[2:3])
    print("Created" if r[0] == "OK" else "Node already exists")
elif parts[0] == "set":
    r = ask("SET", *parts[1:])
    if r[0] == "BADVERSION":
        # exit 0: ZkClient detects a CAS loss by OUTPUT TEXT (real
        # zkCli prints this and keeps the shell alive); a nonzero
        # exit would make control.exec_ raise and turn every lost
        # CAS into an indeterminate :info instead of a clean :fail
        print("version No is not valid :", parts[1])
    elif r[0] == "NONODE":
        print("Node does not exist:", parts[1])
        sys.exit(1)
    else:
        print("dataVersion = %s" % r[1])
else:
    print("unsupported:", command)
    sys.exit(2)
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "zk_ports")


class MiniZkDB(miniserver.MiniServerDB):
    """Uploads BOTH the znode server (daemonized) and the zkcli.py
    the client shells out to."""

    script = "minizk.py"
    src = MINIZK_SRC
    pidfile = MINI_PIDFILE
    logfile = MINI_LOGFILE
    data_files = ("zk.aof",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]

    def setup(self, test, node):
        control.exec_("bash", "-c",
                      "cat > zkcli.py <<'MINIZKCLI_EOF'\n"
                      f"{ZKCLI_SRC}\nMINIZKCLI_EOF")
        super().setup(test, node)

    def teardown(self, test, node):
        super().teardown(test, node)
        control.exec_("rm", "-f", "zkcli.py")


class ZkClient(jclient.Client):
    """CAS register on a znode via zkCli.sh (zookeeper.clj:75-110).

    `get` yields the value and the Stat's dataVersion; `set` with an
    explicit version is an atomic CAS (BadVersion on conflict) — the
    same primitive avout's zk-atom swap!! uses underneath."""

    def __init__(self, znode: str = ZNODE, cli_argv=(ZKCLI,),
                 addr_fn=None):
        self.znode = znode
        self.cli_argv = tuple(cli_argv)
        self.addr_fn = addr_fn or (lambda node: (node, PORT))
        self.node: Optional[str] = None

    def open(self, test, node):
        c = ZkClient(self.znode, self.cli_argv, self.addr_fn)
        c.node = node
        return c

    def setup(self, test):
        """Create the register znode with initial value 0 (the
        reference's zk-atom conn /jepsen 0)."""
        with self._bound(test):
            nodeutil.meh(self._cli, f"create {self.znode} 0")

    def _bound(self, test):
        """Bind this node's control session for the calling (worker)
        thread — the client rides the control plane, and sessions are
        thread-local."""
        import contextlib
        sess = (test.get("sessions") or {}).get(self.node)
        if sess is None:
            return contextlib.nullcontext()
        return control.with_session(self.node, sess)

    def _cli(self, command: str) -> str:
        host, port = self.addr_fn(self.node)
        return control.exec_(*self.cli_argv, "-server",
                             f"{host}:{port}", command)

    def _get(self):
        """(value, dataVersion) of the znode."""
        out = self._cli(f"get {self.znode}")
        m = re.search(r"^dataVersion = (\d+)$", out, re.M)
        if m is None:
            raise ValueError(f"unparseable get output: {out[-200:]!r}")
        version = int(m.group(1))
        # the data line is the last non-Stat line before cZxid
        lines = out.splitlines()
        data = None
        for i, line in enumerate(lines):
            if line.startswith("cZxid"):
                data = lines[i - 1].strip() if i > 0 else ""
                break
        if data in (None, "", "null"):
            return None, version
        return int(data), version

    def invoke(self, test, op):
        f = op["f"]
        try:
            with self._bound(test):
                return self._invoke(test, op)
        except Exception as e:  # noqa: BLE001 — remote exec failed
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def _invoke(self, test, op):
        f = op["f"]
        if f == "read":
            value, _ = self._get()
            return {**op, "type": "ok", "value": value}
        if f == "write":
            self._cli(f"set {self.znode} {op['value']}")
            return {**op, "type": "ok"}
        if f == "cas":
            old, new = op["value"]
            value, version = self._get()
            if value != old:
                return {**op, "type": "fail"}
            out = self._cli(f"set {self.znode} {new} {version}")
            if "version No is not valid" in out \
                    or "BadVersion" in out:
                return {**op, "type": "fail"}
            return {**op, "type": "ok"}
        raise ValueError(f"unknown op {f!r}")

    def close(self, test):
        return None


# op generators shared with the register workload (seeded via gen.RNG,
# so runs reproduce under a pinned seed)
from ..workloads.linearizable_register import cas, r, w  # noqa: E402


def zk_test(options: dict) -> dict:
    """Test map from CLI options (zookeeper.clj:112-137). server=mini
    runs live in-repo znode servers + zkcli over localexec under a
    kill or pause nemesis. The checker's device lane runs on
    `options["device"]` (default the card), resolved here, so that a
    missing card raises before any node is set up."""
    options = {**options, "device": resolve_device(options.get("device"))}
    nodes = options["nodes"]
    mode = options.get("server") or "release"
    if mode == "mini":
        db: jdb.DB = MiniZkDB()
        # ONE register (/jepsen) -> one logical store: every client
        # drives the primary's server (nodes[0], the sqlite-suite
        # topology) and faults target it — crash-recovery semantics
        primary_port = MINI_BASE_PORT
        fault = options.get("fault") or "kill"
        if fault == "kill":
            nemesis = jnemesis.node_start_stopper(
                lambda ns: [ns[0]],
                lambda test, node: db.kill(test, node),
                lambda test, node: db.start(test, node))
        elif fault == "pause":
            nemesis = jnemesis.node_start_stopper(
                lambda ns: [ns[0]],
                lambda test, node: db.pause(test, node),
                lambda test, node: db.resume(test, node))
        else:
            raise ValueError(f"unknown fault {fault!r}")
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "zk-cluster"),
            "ssh": {"dummy?": False},
            "client": ZkClient(
                cli_argv=("/usr/bin/python3", "zkcli.py"),
                addr_fn=lambda node: ("127.0.0.1", primary_port)),
            "nemesis": nemesis,
        }
    elif mode == "release":
        db = ZkDB(options.get("version") or VERSION)
        extra = {
            "ssh": options.get("ssh") or {},
            "os": Debian(),
            "net": jnet.iptables(),
            "client": ZkClient(),
            "nemesis": jnemesis.partition_random_halves(),
        }
    else:
        raise ValueError(f"unknown server mode {mode!r}")
    return {
        "name": options.get("name") or f"zookeeper-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        **extra,
        # linear + perf, matching the reference exemplar
        # (zookeeper.clj:133-137). Deliberately NOT stats: a short run
        # where no cas happens to hit its expected value would flap the
        # whole test invalid.
        "checker": jchecker.compose({
            "linear": jchecker.linearizable(
                cas_register(0), algorithm="competition",
                device=options["device"]),
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": gen.time_limit(
            options.get("time_limit") or 15,
            gen.nemesis(
                gen.cycle([gen.sleep(options.get("nemesis_interval")
                                     or 5),
                           {"type": "info", "f": "start"},
                           gen.sleep(options.get("nemesis_interval")
                                     or 5),
                           {"type": "info", "f": "stop"}]),
                gen.stagger(1.0 / (options.get("rate") or 1.0),
                            gen.mix([r, w, cas])))),
    }


ZK_OPTS = [
    cli.Opt("version", metavar="VERSION", default=VERSION,
            help="zookeeper package version"),
    cli.Opt("server", metavar="MODE", default="release",
            help="release (distro packages on your --ssh cluster) or "
                 "mini (live in-repo znode servers over localexec)"),
    cli.Opt("fault", metavar="F", default="kill",
            help="mini-mode nemesis: kill or pause"),
    cli.Opt("sandbox", metavar="DIR", default="zk-cluster"),
    cli.Opt("rate", metavar="HZ", default=1.0, parse=float),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=5.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's kernels run (default: the "
                 "card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": zk_test, "opt_spec": ZK_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
