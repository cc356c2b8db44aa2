"""Raftis test suite — redis-over-raft, the reference's smallest
standalone suite (raftis/src/jepsen/raftis.clj, 142 LoC: a floyd
raft cluster speaking RESP on 6379).

One linearizable register at key "r": reads GET, writes SET random
ints, partition-random-halves nemesis, linearizable register checker
(raftis.clj:115-127). The suite's one interesting wrinkle is its
error taxonomy (raftis.clj:46-58): a write failing with "no leader
node!" or a closed socket is a DEFINITE fail — the raft layer
refused it before replication — while other write errors stay
indefinite (info); reads always fail definite.

``mini`` mode (default) drives the shared live mini-redis servers
(RESP2 from scratch, fsync'd AOF) over localexec with kill faults;
``tarball`` mode emits the real floyd release recipe
(raftis.clj:79-103): install-archive from PikaLabs/floyd releases,
one daemon per node with the initial-cluster string, raft port 8901,
client port 6379 — command-assertion tested.

The port's copy of `jepsen_tpu/dbs/raftis.py`, on the port's `redis`. Its
own choices: `mini` mode runs the mini-redis servers from
`MINI_BASE_PORT` 31450 (`MiniRaftisDB`, its `raftis_ports` map), not on
redis's ports (the reference's mini mode shares them, and `MiniServerDB`
kills by `miniredis.py --port N` across the host, so the port's redis
tests and this suite's would kill each other's servers; below Linux's
ephemeral range, 32768-60999; `tarball` mode keeps floyd's
`CLIENT_PORT` 6379); `--device`, passed to the `linear` checker's
competition race, whose device lane runs the WGL chunk kernels there
(default the card: a missing card raises before any node is set up,
`--device cpu` runs their plain PyTorch versions); the store root
`store/torch`.

    python -m jepsen_tpu_torch.dbs.raftis test --nodes r1 --device cpu \
        --time-limit 6
"""

from __future__ import annotations

import sys

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..ledger import BASE_DIR
from ..models import cas_register
from ..os_setup import Debian
from ..util import resolve_device
from . import retryclient
from .redis import MiniRedisDB, RedisConn, RedisError

VERSION = "v2.0.4"
DIR = "/opt/raftis"
RAFT_PORT = 8901
CLIENT_PORT = 6379
# the mini servers' block (the reference's mini mode runs on redis's)
MINI_BASE_PORT = 31450

# raftis.clj:46-52: these write failures are DEFINITE — the raft
# layer rejected the command before replication could start
DEFINITE_WRITE_ERRORS = ("no leader node!", "socket closed")


def tarball_url(version: str) -> str:
    return ("https://github.com/PikaLabs/floyd/releases/download/"
            f"{version}/raftis-{version}.tar.gz")


def initial_cluster(test: dict) -> str:
    """n1:8901,n2:8901,... (raftis.clj:68-75)."""
    return ",".join(f"{n}:{RAFT_PORT}" for n in test["nodes"])


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "raftis_ports")


class MiniRaftisDB(MiniRedisDB):
    """The mini-redis server lifecycle on raftis's own ports."""

    def port(self, test, node):
        return mini_node_port(test, node)


class RaftisDB(jdb.DB, jdb.LogFiles):
    """Floyd tarball install + positional-arg daemon
    (raftis.clj:79-109)."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            nodeutil.install_archive(
                tarball_url(self.version), DIR,
                force=bool(test.get("force_reinstall")))
            nodeutil.start_daemon(
                {"logfile": f"{DIR}/raftis.log",
                 "pidfile": f"{DIR}/raftis.pid", "chdir": DIR},
                "raftis",
                initial_cluster(test), node, str(RAFT_PORT),
                "data", str(CLIENT_PORT))
        nodeutil.await_tcp_port(CLIENT_PORT, timeout_s=60)

    def teardown(self, test, node):
        with control.su():
            nodeutil.stop_daemon(f"{DIR}/raftis.pid")
            nodeutil.grepkill("raftis")
            control.exec_("rm", "-rf", DIR)

    def log_files(self, test, node):
        return [f"{DIR}/data/LOG"]


class RaftisClient(retryclient.RetryClient):
    """GET/SET on the single register "r" (raftis.clj:28-63), with
    the reference's definite/indefinite error split."""

    default_port = CLIENT_PORT

    def _connect(self, host, port) -> RedisConn:
        return RedisConn(host, port, timeout=self.timeout)

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                raw = conn.cmd("GET", "r")
                return {**op, "type": "ok",
                        "value": int(raw) if raw is not None else None}
            if f == "write":
                conn.cmd("SET", "r", str(int(op["value"])))
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, RedisError) as e:
            self._drop()
            msg = str(e)
            # raftis.clj:46-52's closed-socket case arrives here as
            # the exception TYPE, not the Java message text
            definite = (f == "read"
                        or isinstance(e, (ConnectionResetError,
                                          BrokenPipeError))
                        or any(p in msg
                               for p in DEFINITE_WRITE_ERRORS))
            return {**op, "type": "fail" if definite else "info",
                    "error": msg[:200]}


def _r(test, ctx):
    return {"f": "read", "value": None}


def _w(test, ctx):
    return {"f": "write", "value": gen.RNG.randrange(5)}


def raftis_test(options: dict) -> dict:
    """The `linear` check's device lane runs on `options["device"]`
    (default the card), resolved here, so that a missing card raises
    before any node is set up."""
    device = resolve_device(options.get("device"))
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    client = RaftisClient()
    if mode == "mini":
        db: jdb.DB = MiniRaftisDB()
        # every worker drives the primary's live server: one logical
        # store under crash-recovery faults
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, test["nodes"][0]))
        nemesis = jnemesis.node_start_stopper(
            retryclient.kill_targets(mode),
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "raftis-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "tarball":
        db = RaftisDB(options.get("version") or VERSION)
        nemesis = jnemesis.partition_random_halves()
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    interval = options.get("nemesis_interval") or 3.0
    return {
        "name": options.get("name") or f"raftis-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "nemesis": nemesis,
        # the register model starts EMPTY (reads may see nil);
        # raftis.clj:121 models a fresh register the same way
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
                gen.stagger(0.05, gen.mix([_r, _w])))),
        **extra,
    }


RAFTIS_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo RESP servers) or tarball "
                 "(real floyd raftis on --ssh nodes)"),
    cli.Opt("sandbox", metavar="DIR", default="raftis-cluster"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's kernels run (default: the "
                 "card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": raftis_test,
                           "opt_spec": RAFTIS_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
