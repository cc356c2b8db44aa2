"""Stolon test suite — the PostgreSQL-HA family exemplar
(stolon/src/jepsen/stolon/{append,client,db,ledger,nemesis}.clj,
6 files / 1,041 LoC).

Stolon is a PostgreSQL high-availability manager: *keepers* run the
actual postgres instances, *sentinels* elect the master through an
etcd store, and *proxies* route clients to the current master. The
reference suite exists because that failover machinery lost G2-item
serializability under partitions; its two workloads are:

- ``append`` — elle list-append over SQL transactions (append.clj),
  the anomaly detector that found the original bugs; shared with the
  postgres suite (`postgres.PgAppendClient`).
- ``ledger`` — the concrete double-spend demonstration
  (ledger.clj:1-6): each transaction is a ledger ROW; withdrawals
  insert only if the account's summed balance stays non-negative.
  Under serializability two concurrent withdrawals can't both see
  the same funding row and both commit — a negative charitable
  balance is a materialized double-spend. The generator replays the
  reference's fund-then-double-spend attack (ledger.clj:159-166).

Two server modes: ``mini`` (default) runs LIVE in-repo pgwire
servers (the from-scratch pgwire v3 codec from the postgres suite on
the client side; real sqlite WAL + full-fsync engines behind the
wire) over localexec with kill faults; ``ha`` emits the real
stolon recipe — postgres apt install (db.clj:44-60), stolon release
tarball (:62-70), `stolonctl init` with the synchronous-replication
cluster spec (:89-108), sentinel -> keeper -> proxy daemons over an
etcdv3 store (the reference composes jepsen.etcd.db; this composes
the etcd suite's automation the same way) — command-assertion
tested.

The port's copy of `jepsen_tpu/dbs/stolon.py`, on the port's `postgres`
and `etcd`. Its own choices: the mini servers listen from
`MINI_BASE_PORT` 31300 (the reference's from 26700, so that both
packages' servers can run on one host at once: `MiniServerDB` kills by
`minipg.py --port N` across the host, and cockroach runs the same
script from its own block; below Linux's ephemeral range, 32768-60999;
`ha` mode keeps the proxy's `PROXY_PORT` 5432); `--device` on `test`
and `test-all`, passed to the `append` checker (its cycle search),
default the card: a missing card raises before any node is set up,
`--device cpu` runs the plain PyTorch versions (the ledger's check runs
on the host and takes no device); the store root `store/torch`.
`MINIPG_SRC` is the reference's server, byte for byte.

    python -m jepsen_tpu_torch.dbs.stolon test --nodes s1 --workload append \
        --time-limit 8 --device cpu
"""

from __future__ import annotations

import itertools
import sys

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..ledger import BASE_DIR
from ..os_setup import Debian
from ..util import resolve_device
from . import etcd as etcd_suite
from . import miniserver, retryclient
from .postgres import (BEGIN_SQL, PgAppendClient, PgClientBase,
                       PgError)

VERSION = "0.16.0"
PG_VERSION = "12"
DIR = "/opt/stolon"
CLUSTER = "jepsen-cluster"
PROXY_PORT = 5432   # clients talk to the proxy (db.clj:162-178)
KEEPER_PG_PORT = 5433
MINI_BASE_PORT = 31300


# -- the LIVE mini server -----------------------------------------------------

MINIPG_SRC = r'''
import argparse, os, socketserver, sqlite3, struct

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

DB_PATH = os.path.join(args.dir, "minipg.db")

class Conn(socketserver.StreamRequestHandler):
    def send(self, t, payload):
        self.wfile.write(t + struct.pack("!i", len(payload) + 4)
                         + payload)
        self.wfile.flush()

    def handle(self):
        raw = self.rfile.read(4)
        if len(raw) < 4:
            return
        n = struct.unpack("!i", raw)[0]
        self.rfile.read(n - 4)  # startup params: trust auth
        self.send(b"R", struct.pack("!i", 0))  # AuthenticationOk
        self.send(b"Z", b"I")
        # one sqlite connection per wire connection: real isolation
        db = sqlite3.connect(DB_PATH, timeout=10,
                             check_same_thread=False)
        db.isolation_level = None  # explicit BEGIN/COMMIT only
        db.execute("PRAGMA journal_mode=WAL")
        db.execute("PRAGMA synchronous=FULL")
        db.execute("PRAGMA busy_timeout=8000")
        in_txn = [False]
        try:
            while True:
                t = self.rfile.read(1)
                if not t or t == b"X":
                    return
                n = struct.unpack("!i", self.rfile.read(4))[0]
                payload = self.rfile.read(n - 4)
                if t != b"Q":
                    self.send(b"E", b"SERROR\x00Munsupported message"
                              b"\x00\x00")
                    self.send(b"Z", b"I")
                    continue
                sql = payload[:-1].decode(errors="replace") \
                    .strip().rstrip(";")
                self.run_sql(db, in_txn, sql)
        finally:
            try:
                if in_txn[0]:
                    db.rollback()
                db.close()
            except sqlite3.Error:
                pass

    def run_sql(self, db, in_txn, sql):
        up = sql.upper()
        if up.startswith("BEGIN"):
            # any BEGIN variant (incl. ISOLATION LEVEL SERIALIZABLE)
            # becomes a full write lock: sqlite has no weaker levels
            sql = "BEGIN IMMEDIATE"
        try:
            before = db.total_changes
            cur = db.execute(sql)
            rows = cur.fetchall() if cur.description else []
            changed = db.total_changes - before
            if up.startswith("BEGIN"):
                in_txn[0] = True
            elif up.startswith("COMMIT") or up.startswith("ROLLBACK"):
                in_txn[0] = False
        except sqlite3.Error as e:
            if in_txn[0]:
                try:
                    db.rollback()
                except sqlite3.Error:
                    pass
                in_txn[0] = False
            self.send(b"E", b"SERROR\x00M"
                      + str(e)[:120].encode() + b"\x00\x00")
            self.send(b"Z", b"I")
            return
        if cur.description:
            cols = b"".join(
                c[0].encode() + b"\x00"
                + struct.pack("!ihihih", 0, 0, 25, -1, -1, 0)
                for c in cur.description)
            self.send(b"T", struct.pack("!h", len(cur.description))
                      + cols)
            for row in rows:
                out = struct.pack("!h", len(row))
                for v in row:
                    if v is None:
                        out += struct.pack("!i", -1)
                    else:
                        b = str(v).encode()
                        out += struct.pack("!i", len(b)) + b
                self.send(b"D", out)
            tag = "SELECT %d" % len(rows)
        elif up.startswith("UPDATE"):
            tag = "UPDATE %d" % changed
        elif up.startswith("INSERT"):
            tag = "INSERT 0 %d" % changed
        else:
            tag = up.split()[0] if up else "OK"
        self.send(b"C", tag.encode() + b"\x00")
        self.send(b"Z", b"I")

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

print("minipg serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Conn).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "stolon_ports")


class MiniStolonDB(miniserver.MiniServerDB):
    script = "minipg.py"
    src = MINIPG_SRC
    pidfile = "minipg.pid"
    logfile = "minipg.log"
    data_files = ("minipg.db", "minipg.db-wal", "minipg.db-shm")

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


# -- real HA automation -------------------------------------------------------

def tarball_url(version: str) -> str:
    """db.clj install-stolon!:62-70 release URL."""
    return ("https://github.com/sorintlab/stolon/releases/download/"
            f"v{version}/stolon-v{version}-linux-amd64.tar.gz")


def store_endpoints(test: dict) -> str:
    """The etcd address stolon commands use (db.clj:72-76)."""
    return ",".join(f"http://{n}:{etcd_suite.CLIENT_PORT}"
                    for n in test["nodes"])


def cluster_spec() -> str:
    """initial-cluster-spec (db.clj:89-108): synchronous replication
    so acknowledged writes survive failover."""
    import json
    return json.dumps({
        "initMode": "new",
        "sleepInterval": "1s",
        "requestTimeout": "2s",
        "failInterval": "4s",
        "proxyCheckInterval": "1s",
        "proxyTimeout": "3s",
        "synchronousReplication": True,
        "automaticPgRestart": True,
    })


class StolonDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """sentinel + keeper + proxy over an etcdv3 store
    (db.clj:110-230). The store is the etcd suite's automation — the
    reference composes jepsen.etcd.db exactly the same way
    (db.clj:16)."""

    def __init__(self, version: str = VERSION):
        self.version = version
        self.store = etcd_suite.EtcdDB()

    def _stolonctl(self, test, *args):
        """stolonctl with cluster/store flags (db.clj:77-87)."""
        control.exec_(f"{DIR}/bin/stolonctl",
                      "--cluster-name", CLUSTER,
                      "--store-backend", "etcdv3",
                      "--store-endpoints", store_endpoints(test),
                      *args)

    def _start_sentinel(self, test, node):
        nodeutil.start_daemon(
            {"logfile": f"{DIR}/sentinel.log",
             "pidfile": f"{DIR}/sentinel.pid", "chdir": DIR},
            f"{DIR}/bin/stolon-sentinel",
            "--cluster-name", CLUSTER,
            "--store-backend", "etcdv3",
            "--store-endpoints", store_endpoints(test))

    def _start_keeper(self, test, node):
        """Keeper uid ties the postgres instance to the node
        (db.clj node->pg-id:129-138)."""
        uid = f"pg{test['nodes'].index(node)}"
        nodeutil.start_daemon(
            {"logfile": f"{DIR}/keeper.log",
             "pidfile": f"{DIR}/keeper.pid", "chdir": DIR},
            f"{DIR}/bin/stolon-keeper",
            "--cluster-name", CLUSTER,
            "--store-backend", "etcdv3",
            "--store-endpoints", store_endpoints(test),
            "--uid", uid,
            "--data-dir", f"{DIR}/data",
            "--pg-listen-address", node,
            "--pg-port", str(KEEPER_PG_PORT),
            "--pg-su-password", "jepsen-pw",
            "--pg-repl-username", "repl",
            "--pg-repl-password", "jepsen-pw")

    def _start_proxy(self, test, node):
        nodeutil.start_daemon(
            {"logfile": f"{DIR}/proxy.log",
             "pidfile": f"{DIR}/proxy.pid", "chdir": DIR},
            f"{DIR}/bin/stolon-proxy",
            "--cluster-name", CLUSTER,
            "--store-backend", "etcdv3",
            "--store-endpoints", store_endpoints(test),
            "--listen-address", "0.0.0.0",
            "--port", str(PROXY_PORT))

    def setup(self, test, node):
        self.store.setup(test, node)
        with control.su():
            # postgres from the pgdg apt repo (db.clj:44-60)
            control.exec_("apt-get", "install", "-y",
                          f"postgresql-{PG_VERSION}")
            control.exec_("service", "postgresql", "stop")
            nodeutil.install_archive(
                tarball_url(self.version), DIR,
                force=bool(test.get("force_reinstall")))
        if node == test["nodes"][0]:
            self._stolonctl(test, "init", "--yes", cluster_spec())
        self.start(test, node)

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf", f"{DIR}/data",
                          *(f"{DIR}/{f}.log" for f in
                            ("sentinel", "keeper", "proxy")))
        self.store.teardown(test, node)

    # -- db.Process --
    def start(self, test, node):
        self._start_sentinel(test, node)
        self._start_keeper(test, node)
        self._start_proxy(test, node)
        nodeutil.await_tcp_port(PROXY_PORT, timeout_s=120)
        return "started"

    def kill(self, test, node):
        for daemon, pattern in (("proxy", "stolon-proxy"),
                                ("keeper", "stolon-keeper"),
                                ("sentinel", "stolon-sentinel")):
            nodeutil.stop_daemon(f"{DIR}/{daemon}.pid")
            nodeutil.grepkill(pattern)
        nodeutil.grepkill("postgres")
        return "killed"

    def log_files(self, test, node):
        return [f"{DIR}/{f}.log" for f in
                ("sentinel", "keeper", "proxy")]


# -- ledger workload ----------------------------------------------------------

class LedgerClient(PgClientBase):
    """ledger.clj Client: every transfer inserts a ledger row inside
    a serializable txn; withdrawals first sum the account's OTHER
    rows and only insert if the balance stays non-negative
    (transfer!:55-68)."""

    _ids = itertools.count(1)

    def setup(self, test):
        conn = self._conn(test)
        conn.query("CREATE TABLE IF NOT EXISTS ledger "
                   "(id INTEGER PRIMARY KEY, account INTEGER NOT "
                   "NULL, amount INTEGER NOT NULL)")
        conn.query("CREATE INDEX IF NOT EXISTS i_account "
                   "ON ledger (account)")

    def invoke(self, test, op):
        account, amount = op["value"]
        # row ids come from a class-level counter shared by every
        # client thread in this interpreter, so inserts never collide
        rid = next(self._ids)
        try:
            conn = self._conn(test)
            conn.query(BEGIN_SQL)
            if amount > 0:
                conn.query(f"INSERT INTO ledger VALUES ({rid}, "
                           f"{int(account)}, {int(amount)})")
                conn.query("COMMIT")
                return {**op, "type": "ok"}
            # withdrawal: direct read + client-side sum
            # (balance-select, ledger.clj:44-52; its id-exclusion is
            # dropped — our row is not inserted until after this read)
            rows, _ = conn.query(
                f"SELECT amount FROM ledger WHERE account = "
                f"{int(account)}")
            balance = sum(int(r[0]) for r in rows)
            if balance + amount < 0:
                conn.query("ROLLBACK")
                return {**op, "type": "fail",
                        "error": "insufficient funds"}
            conn.query(f"INSERT INTO ledger VALUES ({rid}, "
                       f"{int(account)}, {int(amount)})")
            conn.query("COMMIT")
            return {**op, "type": "ok"}
        except (OSError, ConnectionError, PgError) as e:
            self._drop()
            return {**op, "type": "info", "error": str(e)[:200]}


class LedgerChecker(jchecker.Checker):
    """ledger.clj check-account:143-157, charitable reading: assume
    indeterminate deposits succeeded and indeterminate withdrawals
    failed. A NEGATIVE balance under that reading is a materialized
    double-spend — the G2-item anomaly made concrete. (The reference
    flags any nonzero balance; nonzero-positive is just an
    incomplete attack, reported here but not a violation.)"""

    def check(self, test, history, opts=None):
        by_account: dict = {}
        for op in history:
            if op.f != "transfer" or not (op.is_ok or op.is_info):
                continue
            if not isinstance(op.value, (list, tuple)):
                continue
            account, amount = op.value
            if amount > 0 or op.is_ok:  # charitable
                by_account[account] = by_account.get(account, 0) \
                    + amount
        overdrawn = {a: b for a, b in by_account.items() if b < 0}
        nonzero = {a: b for a, b in by_account.items() if b != 0}
        return {"valid?": not overdrawn,
                "overdrawn-accounts": dict(list(overdrawn.items())[:8]),
                "nonzero-count": len(nonzero)}


def double_spend_gen():
    """fund-then-double-spend-gen (ledger.clj:159-166): +10, then
    2^(0..4) concurrent -9 withdrawals per account. At most ONE may
    commit."""
    def ops():
        for account in itertools.count():
            yield {"f": "transfer", "value": [account, 10]}
            for _ in range(2 ** gen.RNG.randrange(5)):
                yield {"f": "transfer", "value": [account, -9]}
    it = ops()
    # light stagger: without it, a downed server turns instant
    # connection-refused fails into a megaop spin loop
    return gen.clients(gen.stagger(0.005,
                                   lambda test, ctx: next(it)))


def rand_gen():
    """rand-gen (ledger.clj:168-175): 16 transfers of -3..+1 per
    account."""
    def ops():
        for account in itertools.count():
            for _ in range(16):
                yield {"f": "transfer",
                       "value": [account, gen.RNG.randrange(5) - 3]}
    it = ops()
    return gen.clients(gen.stagger(0.005,
                                   lambda test, ctx: next(it)))


# -- workloads ----------------------------------------------------------------

def _w_ledger(options):
    attack = (options.get("attack") or "double-spend")
    return {"client": LedgerClient(),
            "checker": LedgerChecker(),
            "generator": (double_spend_gen()
                          if attack == "double-spend" else rand_gen())}


class StolonAppendClient(PgAppendClient):
    """The shared pgwire append client plus schema setup (mini mode
    has no external DB creating tables)."""

    def setup(self, test):
        self._conn(test).query(
            "CREATE TABLE IF NOT EXISTS lists "
            "(k INTEGER PRIMARY KEY, v TEXT)")


def _w_append(options):
    from ..workloads import cycle_append
    w = cycle_append.workload(anomalies=("G0", "G1", "G2"),
                              device=options.get("device"))
    return {**w, "client": StolonAppendClient()}


WORKLOADS = {"ledger": _w_ledger, "append": _w_append}

#: the workloads whose checks run kernels: the append's cycle search
DEVICE_WORKLOADS = ("append",)


def stolon_test(options: dict) -> dict:
    """The checks of `DEVICE_WORKLOADS` run their kernels on
    `options["device"]` (default the card), resolved here, so that a
    missing card raises before any node is set up."""
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    which = options.get("workload") or "ledger"
    if which in DEVICE_WORKLOADS:
        options = {**options,
                   "device": resolve_device(options.get("device"))}
    try:
        w = WORKLOADS[which](options)
    except KeyError:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}") from None
    client = w["client"]

    if mode == "mini":
        db: jdb.DB = MiniStolonDB()
        # all workers drive the primary's server: one logical store,
        # crash-recovery faults (the sqlite-suite topology)
        client.addr_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, test["nodes"][0]))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "stolon-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "ha":
        db = StolonDB(options.get("version") or VERSION)
        # clients talk to the local proxy, which routes to the master
        client.addr_fn = lambda test, node: (node, PROXY_PORT)
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    interval = options.get("nemesis_interval") or 3.0
    time_limit = options.get("time_limit") or 10
    workload_gen = gen.nemesis(
        gen.cycle([gen.sleep(interval),
                   {"type": "info", "f": "start"},
                   gen.sleep(interval),
                   {"type": "info", "f": "stop"}]),
        w["generator"])
    workload_gen = gen.time_limit(time_limit, workload_gen)
    pass_extra = {k: v for k, v in w.items()
                  if k not in ("checker", "generator", "client")}
    return {
        "name": options.get("name") or f"stolon-{which}-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "nemesis": jnemesis.node_start_stopper(
            retryclient.kill_targets(mode),
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node)),
        "checker": jchecker.compose({
            which: w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": workload_gen,
        **extra,
        **pass_extra,
    }


def stolon_tests(options: dict):
    which = options.get("workload")
    for name in ([which] if which else sorted(WORKLOADS)):
        opts = dict(options, workload=name)
        opts["name"] = f"{options.get('name') or 'stolon'}-{name}"
        yield stolon_test(opts)


STOLON_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo pgwire servers) or ha (real "
                 "stolon sentinel/keeper/proxy on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("attack", metavar="KIND", default="double-spend",
            help="ledger generator: double-spend or rand"),
    cli.Opt("sandbox", metavar="DIR", default="stolon-cluster"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the append check's kernels run (default: the "
                 "card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": stolon_test,
                           "opt_spec": STOLON_OPTS}),
    **cli.test_all_cmd({"tests_fn": stolon_tests,
                        "opt_spec": STOLON_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
