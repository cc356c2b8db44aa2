"""SQLite test suite — the SQL/ACID family exemplar, standing in for
the reference's relational suites (galera, percona, stolon,
postgres-rds: SURVEY.md §2.4) with a database that actually ships in
this environment.

A LIVE `minisql` server wraps stdlib sqlite3 behind the shared RESP
wire (miniserver machinery): micro-op transactions execute server-side
in one `BEGIN IMMEDIATE` sqlite transaction (serializable by sqlite's
global write lock), bank transfers are balance-guarded SQL updates,
and WAL journaling with synchronous=FULL makes committed transactions
survive kill -9 — which the suite proves under the process-kill
nemesis with three workloads:

- ``append`` — elle list-append over real SQL txns: sqlite is
  serializable, so the cycle checker must find NOTHING, and any
  anomaly is a real bug in the harness or the engine.
- ``wr``     — elle rw-register txns, same bar.
- ``bank``   — conserved-total transfers (the classic ACID probe).

Single-primary topology, like the reference's stolon suite: every
client drives nodes[0]; the nemesis kills and restarts exactly that
primary, so every fault is a crash-recovery test of the WAL.

The port's copy of `jepsen_tpu/dbs/sqlite.py`. Its own choices: the
minisql servers listen from `MINI_BASE_PORT` 32100 (the reference's
from 23100, so that both packages' servers can run on one host at
once; below Linux's ephemeral range, 32768-60999, where a client
retrying a down server's port could connect to itself and hold the
port); `--device`, passed to the `append` and `wr` checkers, whose
cycle search runs its kernels there (default the card; a missing card
raises before any node is set up, `--device cpu` runs their plain
PyTorch versions); the store root `store/torch`.

    python -m jepsen_tpu_torch.dbs.sqlite test --nodes p1 --device cpu
"""

from __future__ import annotations

import json
import sys
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec
from ..ledger import BASE_DIR
from ..util import resolve_device
from . import miniserver
from .redis import RedisConn, RedisError

MINI_BASE_PORT = 32100
PIDFILE = "minisql.pid"
LOGFILE = "minisql.log"

MINISQL_SRC = miniserver.build_src(r'''
import argparse, json, os, socketserver, sqlite3, threading

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--db", default="minisql.db")
p.add_argument("--unsafe", action="store_true",
               help="journal_mode=MEMORY: kill -9 loses commits")
args = p.parse_args()

LOCK = threading.Lock()
__RESP_COMMON__

def connect():
    conn = sqlite3.connect(args.db, timeout=10,
                           check_same_thread=False)
    if args.unsafe:
        conn.execute("PRAGMA journal_mode=MEMORY")
        conn.execute("PRAGMA synchronous=OFF")
    else:
        # committed transactions survive kill -9: WAL + full fsync
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=FULL")
    conn.execute("CREATE TABLE IF NOT EXISTS kv"
                 " (k TEXT PRIMARY KEY, v TEXT)")
    conn.execute("CREATE TABLE IF NOT EXISTS bank"
                 " (acct TEXT PRIMARY KEY, bal INTEGER)")
    conn.commit()
    return conn

DB = connect()

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
            # error handling stays INSIDE the lock: a rollback issued
            # after releasing it could abort another thread's
            # in-progress transaction on the shared connection
            try:
                return self.apply_locked(op, cmd)
            except Exception as e:
                # ANY failure mid-command must roll back while still
                # holding the lock, or the shared connection is left
                # inside an open write transaction for the next thread
                try:
                    DB.rollback()
                except sqlite3.Error:
                    pass
                return b"-ERR %s: %s\r\n" % (
                    type(e).__name__.encode(), str(e)[:80].encode())

    def apply_locked(self, op, cmd):
            if op == "PING":
                return b"+PONG\r\n"
            if op == "TXN":
                # one serializable transaction over micro-ops
                mops = json.loads(cmd[1])
                DB.execute("BEGIN IMMEDIATE")
                done = []
                for f, k, v in mops:
                    if f == "w":  # blind write: no read needed
                        DB.execute(
                            "INSERT INTO kv (k, v) VALUES (?, ?) "
                            "ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                            (str(k), json.dumps(v)))
                        done.append([f, k, v])
                        continue
                    row = DB.execute(
                        "SELECT v FROM kv WHERE k = ?",
                        (str(k),)).fetchone()
                    cur = json.loads(row[0]) if row else None
                    if f == "append":
                        cur = (cur or []) + [v]
                        DB.execute(
                            "INSERT INTO kv (k, v) VALUES (?, ?) "
                            "ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                            (str(k), json.dumps(cur)))
                        done.append([f, k, v])
                    else:  # r
                        done.append([f, k, cur])
                DB.commit()
                return bulk(json.dumps(done))
            if op == "CASKV":
                # CASKV k old new -> 1/0, one serializable txn (the
                # conditional-UPDATE recipe the yugabyte ysql clients
                # use; added for the dual-API suite, dbs/yuga.py)
                k, old, new = cmd[1], cmd[2], cmd[3]
                DB.execute("BEGIN IMMEDIATE")
                row = DB.execute("SELECT v FROM kv WHERE k = ?",
                                 (k,)).fetchone()
                if row is None or row[0] != old:
                    DB.rollback()
                    return b":0\r\n"
                DB.execute("UPDATE kv SET v = ? WHERE k = ?", (new, k))
                DB.commit()
                return b":1\r\n"
            if op == "INCRKV":
                # INCRKV k delta -> new value, one serializable txn
                k, delta = cmd[1], int(cmd[2])
                DB.execute("BEGIN IMMEDIATE")
                row = DB.execute("SELECT v FROM kv WHERE k = ?",
                                 (k,)).fetchone()
                cur = int(json.loads(row[0])) if row else 0
                cur += delta
                DB.execute(
                    "INSERT INTO kv (k, v) VALUES (?, ?) "
                    "ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                    (k, json.dumps(cur)))
                DB.commit()
                return b":%d\r\n" % cur
            if op == "BANKINIT":
                balances = json.loads(cmd[1])
                DB.execute("BEGIN IMMEDIATE")
                for acct, bal in balances.items():
                    DB.execute(
                        "INSERT OR IGNORE INTO bank (acct, bal) "
                        "VALUES (?, ?)", (acct, int(bal)))
                DB.commit()
                return b"+OK\r\n"
            if op == "BANKREAD":
                DB.execute("BEGIN")
                rows = DB.execute(
                    "SELECT acct, bal FROM bank").fetchall()
                DB.commit()
                return bulk(json.dumps(dict(rows)))
            if op == "XFER":
                src, dst, amt = cmd[1], cmd[2], int(cmd[3])
                DB.execute("BEGIN IMMEDIATE")
                row = DB.execute("SELECT bal FROM bank WHERE acct=?",
                                 (src,)).fetchone()
                if row is None or row[0] < amt:
                    DB.rollback()
                    return b":0\r\n"
                DB.execute("UPDATE bank SET bal = bal - ? "
                           "WHERE acct = ?", (amt, src))
                DB.execute("UPDATE bank SET bal = bal + ? "
                           "WHERE acct = ?", (amt, dst))
                DB.commit()
                return b":1\r\n"
            return b"-ERR unknown command '%s'\r\n" % op.encode()

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

print("minisql serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Handler).serve_forever()
''')


def node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "sqlite_ports")


def primary(test: dict) -> str:
    return test["nodes"][0]


class MiniSqlDB(miniserver.MiniServerDB):
    """Shared mini-server lifecycle for the sqlite wrapper; the WAL
    and .db files are wiped on teardown so runs start fresh."""

    script = "minisql.py"
    src = MINISQL_SRC
    pidfile = PIDFILE
    logfile = LOGFILE
    data_files = ("minisql.db", "minisql.db-wal", "minisql.db-shm")

    def __init__(self, unsafe: bool = False):
        self.unsafe = unsafe

    def port(self, test, node):
        return node_port(test, node)

    def extra_args(self, test, node):
        return ["--db", "minisql.db"] + \
            (["--unsafe"] if self.unsafe else [])


class SqliteClient(jclient.Client):
    """All ops drive the primary (nodes[0]) — stolon-style
    single-primary topology; faults are crash-recovery tests."""

    def __init__(self, port_fn=None, timeout: float = 5.0):
        self.port_fn = port_fn or (
            lambda test, node: ("127.0.0.1", node_port(test, node)))
        self.timeout = timeout
        self.node: Optional[str] = None
        self.conn: Optional[RedisConn] = None

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout)
        c.node = node
        return c

    def _conn(self, test) -> RedisConn:
        if self.conn is None:
            host, port = self.port_fn(test, primary(test))
            self.conn = RedisConn(host, port, self.timeout)
        return self.conn

    def _drop_conn(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "txn":
                out = conn.cmd("TXN", json.dumps(
                    [[m[0], m[1], m[2]] for m in op["value"]]))
                return {**op, "type": "ok", "value": json.loads(out)}
            if f == "read":  # bank read
                out = conn.cmd("BANKREAD")
                bals = json.loads(out)
                return {**op, "type": "ok",
                        "value": {int(a): b for a, b in bals.items()}}
            if f == "transfer":
                t = op["value"]
                won = conn.cmd("XFER", str(t["from"]), str(t["to"]),
                               t["amount"])
                return {**op, "type": "ok" if won == 1 else "fail"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, RedisError) as e:
            self._drop_conn()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def close(self, test):
        self._drop_conn()


class SqliteBankClient(SqliteClient):
    """Adds idempotent balance initialization (runs per node client
    BEFORE the interpreter starts; INSERT OR IGNORE makes the race
    harmless)."""

    def setup(self, test):
        accounts = test["accounts"]
        total = test["total-amount"]
        per, rem = divmod(total, len(accounts))
        balances = {str(a): per + (1 if i < rem else 0)
                    for i, a in enumerate(accounts)}
        try:
            self._conn(test).cmd("BANKINIT", json.dumps(balances))
        except (OSError, ConnectionError, RedisError):
            # an uninitialized bank would read as a FALSE wrong-total
            # "data loss": abort the run loudly instead
            self._drop_conn()
            raise


def _w_append(options):
    from ..workloads import cycle_append
    w = cycle_append.workload(anomalies=("G0", "G1", "G2"),
                              additional_graphs=("realtime",),
                              device=options.get("device"))
    return {**w, "client": SqliteClient()}


def _w_wr(options):
    from ..workloads import cycle_wr
    w = cycle_wr.workload(linearizable_keys=True,
                          device=options.get("device"))
    return {**w, "client": SqliteClient()}


def _w_bank(options):
    from ..workloads import bank
    w = bank.workload(options)
    return {**w, "client": SqliteBankClient()}


WORKLOADS = {"append": _w_append, "wr": _w_wr, "bank": _w_bank}


def sqlite_test(options: dict) -> dict:
    """Test map: chosen workload against the live minisql primary
    under a primary-kill/restart nemesis. The append / wr checkers'
    kernels run on `options["device"]` (default the card), resolved
    here, so that a missing card raises before any node is set up."""
    options = {**options, "device": resolve_device(options.get("device"))}
    nodes = options["nodes"]
    db = MiniSqlDB(unsafe=bool(options.get("unsafe")))
    which = options.get("workload") or "append"
    try:
        w = WORKLOADS[which](options)
    except KeyError:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}") from None
    interval = options.get("nemesis_interval") or 3.0
    extra = {k: v for k, v in w.items()
             if k not in ("checker", "generator", "client")}
    return {
        "name": options.get("name") or f"sqlite-{which}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "remote": localexec.remote(options.get("sandbox")
                                   or "sqlite-cluster"),
        "ssh": {"dummy?": False},
        "db": db,
        "client": w["client"],
        "nemesis": jnemesis.node_start_stopper(
            lambda nodes: [nodes[0]],  # always the primary
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node)),
        "checker": jchecker.compose({
            which: w["checker"],
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


def sqlite_tests(options: dict):
    """tests_fn for `test-all`: sweep the workload axis."""
    workloads = ([options["workload"]] if options.get("workload")
                 else sorted(WORKLOADS))
    for which in workloads:
        opts = dict(options, workload=which)
        opts["name"] = f"{options.get('name') or 'sqlite'}-{which}"
        yield sqlite_test(opts)


SQLITE_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Where to write results"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))} "
                 "(test: default append; test-all: sweeps all)"),
    cli.Opt("sandbox", metavar="DIR", default="sqlite-cluster",
            help="Node sandbox dir for the localexec remote"),
    cli.Opt("unsafe", default=False,
            help="journal_mode=MEMORY / synchronous=OFF: kill -9 "
                 "then loses committed transactions"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float, help="Seconds between kill/restart cycles"),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the append / wr checks' kernels run (default: "
                 "the card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": sqlite_test,
                           "opt_spec": SQLITE_OPTS}),
    **cli.test_all_cmd({"tests_fn": sqlite_tests,
                        "opt_spec": SQLITE_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
