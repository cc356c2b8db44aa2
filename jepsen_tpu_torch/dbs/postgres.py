"""Postgres test suite — the external-SQL-endpoint exemplar
(reference: postgres-rds/src/jepsen/postgres_rds.clj — no install
automation, the suite drives an EXISTING postgres endpoint;
stolon/src/jepsen/stolon.clj supplies the workload set).

The wire layer is a from-scratch pgwire v3 codec speaking the simple
query protocol: StartupMessage -> AuthenticationOk/ReadyForQuery
handshake, `Query` messages, RowDescription/DataRow/CommandComplete/
ErrorResponse/ReadyForQuery parsing (text format). Only trust auth is
supported — the reference's RDS tests authenticate out of band too.

Workloads (each a real-SQL client):

- ``register`` — independent [k v] registers: INSERT .. ON CONFLICT
  DO UPDATE writes, and cas as `UPDATE .. WHERE k=.. AND v=old` —
  the CommandComplete tag ("UPDATE 1"/"UPDATE 0") decides, postgres's
  conditional update being the compare-and-set.
- ``bank``     — postgres_rds.clj:160-233: transfers inside
  BEGIN..COMMIT transactions, conserved totals.
- ``append``   — stolon/append.clj: elle list-append txns, each mop
  batch inside one SQL transaction over a TEXT-csv list column.

CI drives all three against a pgwire-framed stub backed by a REAL SQL
engine (sqlite3 in tests/test_postgres.py), so the wire codec and the
SQL shapes are exercised end to end; point --host at a real postgres
/ stolon / RDS endpoint for the production path.

The port's copy of `jepsen_tpu/dbs/postgres.py`, the pgwire family's
base (stolon, cockroach and crate build on its codec and its client
bases). Its own choices: `--device` on `test` and `test-all`, passed to
the `register` workload's competition race (its device lane runs the WGL
chunk kernels) and to the `append` checker (its cycle search), default
the card: a missing card raises before any node is set up, `--device
cpu` runs the plain PyTorch versions (the bank's check runs on the host
and takes no device); the store root `store/torch`. It has no server of
its own (`PORT` stays postgres's 5432): point `--nodes` at an endpoint,
or a test's `client.addr_fn` at a stolon mini node.

    python -m jepsen_tpu_torch.dbs.postgres test --nodes 127.0.0.1 \
        --workload bank --time-limit 5
"""

from __future__ import annotations

import socket
import struct
import sys
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..util import resolve_device
from ..workloads import linearizable_register

PORT = 5432


# -- pgwire v3 codec --------------------------------------------------------

def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def encode_startup(user: str, database: str) -> bytes:
    body = struct.pack("!i", 196608)  # protocol 3.0
    body += _cstr("user") + _cstr(user)
    body += _cstr("database") + _cstr(database)
    body += b"\x00"
    return struct.pack("!i", len(body) + 4) + body


def encode_query(sql: str) -> bytes:
    body = _cstr(sql)
    return b"Q" + struct.pack("!i", len(body) + 4) + body


def read_message(rf) -> tuple[bytes, bytes]:
    """One backend message: (type byte, payload)."""
    t = rf.read(1)
    if not t:
        raise ConnectionError("server closed")
    hdr = rf.read(4)
    if len(hdr) < 4:
        raise ConnectionError("short read in message length")
    n = struct.unpack("!i", hdr)[0]
    payload = rf.read(n - 4)
    if len(payload) < n - 4:
        raise ConnectionError("short read in message payload")
    return t, payload


class PgError(Exception):
    pass


def _parse_error(payload: bytes) -> str:
    fields = {}
    off = 0
    while off < len(payload) and payload[off] != 0:
        code = chr(payload[off])
        end = payload.index(b"\x00", off + 1)
        fields[code] = payload[off + 1:end].decode()
        off = end + 1
    return fields.get("M", "unknown error")


class PgConn:
    """One blocking simple-protocol connection (text format)."""

    def __init__(self, host: str, port: int, user: str = "jepsen",
                 database: str = "jepsen", timeout: float = 5.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.rf = self.sock.makefile("rb")
        self.sock.sendall(encode_startup(user, database))
        # handshake: AuthenticationOk (R, code 0) ... ReadyForQuery (Z)
        while True:
            t, payload = read_message(self.rf)
            if t == b"R":
                code = struct.unpack("!i", payload[:4])[0]
                if code != 0:
                    raise PgError(f"unsupported auth method {code}")
            elif t == b"E":
                raise PgError(_parse_error(payload))
            elif t == b"Z":
                break
            # ParameterStatus (S), BackendKeyData (K): ignored

    def query(self, sql: str) -> tuple[list, Optional[str]]:
        """Execute one statement; returns (rows, command tag). Rows
        are lists of str-or-None (text format)."""
        self.sock.sendall(encode_query(sql))
        rows: list = []
        tag: Optional[str] = None
        err: Optional[str] = None
        while True:
            t, payload = read_message(self.rf)
            if t == b"T":  # RowDescription: column metadata, unused
                continue
            if t == b"D":
                n = struct.unpack("!h", payload[:2])[0]
                off = 2
                row = []
                for _ in range(n):
                    ln = struct.unpack("!i", payload[off:off + 4])[0]
                    off += 4
                    if ln == -1:
                        row.append(None)
                    else:
                        row.append(payload[off:off + ln].decode())
                        off += ln
                rows.append(row)
            elif t == b"C":
                tag = payload[:-1].decode()
            elif t == b"E":
                err = _parse_error(payload)
            elif t == b"Z":
                if err is not None:
                    raise PgError(err)
                return rows, tag
            # NoticeResponse (N), EmptyQueryResponse (I): ignored

    def close(self):
        try:
            self.sock.sendall(b"X" + struct.pack("!i", 4))  # Terminate
        except OSError:
            pass
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


def tag_count(tag: Optional[str]) -> int:
    """Rows-affected from a CommandComplete tag ("UPDATE 1")."""
    if not tag:
        return 0
    parts = tag.split()
    try:
        return int(parts[-1])
    except ValueError:
        return 0


class ExternalDB(jdb.DB):
    """postgres-rds pattern: the endpoint already exists — setup
    creates the suite's tables, teardown drops them; no daemons."""

    def __init__(self, conn_fn):
        self.conn_fn = conn_fn

    def setup(self, test, node):
        if node != test["nodes"][0]:
            return  # schema once, from the first "node"
        conn = self.conn_fn(test, node)
        try:
            conn.query("CREATE TABLE IF NOT EXISTS registers "
                       "(k INTEGER PRIMARY KEY, v INTEGER)")
            conn.query("CREATE TABLE IF NOT EXISTS accounts "
                       "(id INTEGER PRIMARY KEY, balance INTEGER)")
            conn.query("CREATE TABLE IF NOT EXISTS lists "
                       "(k INTEGER PRIMARY KEY, v TEXT)")
        finally:
            conn.close()

    def teardown(self, test, node):
        if node != test["nodes"][0]:
            return
        try:
            conn = self.conn_fn(test, node)
        except (OSError, PgError):
            return  # endpoint gone: nothing to drop
        try:
            for t in ("registers", "accounts", "lists"):
                conn.query(f"DROP TABLE IF EXISTS {t}")
        finally:
            conn.close()


class PgClientBase(jclient.Client):
    """Shared connection plumbing; addr_fn maps a node to
    (host, port) — tests point it at the stub."""

    def __init__(self, addr_fn=None, user: str = "jepsen",
                 database: str = "jepsen", timeout: float = 5.0):
        self.addr_fn = addr_fn or (lambda test, node: (node, PORT))
        self.user = user
        self.database = database
        self.timeout = timeout
        self.node: Optional[str] = None
        self.conn: Optional[PgConn] = None

    def open(self, test, node):
        c = type(self)(self.addr_fn, self.user, self.database,
                       self.timeout)
        c.node = node
        return c

    def _conn(self, test) -> PgConn:
        if self.conn is None:
            host, port = self.addr_fn(test, self.node)
            self.conn = PgConn(host, port, self.user, self.database,
                               self.timeout)
        return self.conn

    def _drop(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def close(self, test):
        self._drop()


class PgRetryClientBase(PgClientBase):
    """Pg plumbing + the family's shared connect-retry window
    (retryclient.connect_with_retry), for suites whose mini servers
    get kill -9'd mid-run: ops spanning the restart reconnect instead
    of spraying connection-refused infos."""

    def _conn(self, test):
        from .retryclient import connect_with_retry
        return connect_with_retry(
            lambda: PgClientBase._conn(self, test),
            (OSError, PgError))


# Serializable isolation: the suite's checkers (bank conservation,
# elle G2/G-single) assert serializable behavior — postgres's default
# READ COMMITTED would legitimately fail them on a HEALTHY endpoint.
# The CI stub treats any BEGIN variant as a full write lock.
BEGIN_SQL = "BEGIN ISOLATION LEVEL SERIALIZABLE"


class PgRegisterClient(PgClientBase):
    """Independent [k v] registers over conditional updates."""

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"postgres wants [k v] tuples, got {kv!r}")
        k, v = kv
        f = op["f"]
        if f not in ("read", "write", "cas"):
            raise ValueError(f"unknown op {f!r}")
        try:
            conn = self._conn(test)
            if f == "read":
                rows, _ = conn.query(
                    f"SELECT v FROM registers WHERE k = {int(k)}")
                cur = int(rows[0][0]) if rows and rows[0][0] is not None \
                    else None
                return {**op, "type": "ok", "value": tuple_(k, cur)}
            if f == "write":
                conn.query(
                    f"INSERT INTO registers (k, v) VALUES "
                    f"({int(k)}, {int(v)}) ON CONFLICT (k) DO UPDATE "
                    f"SET v = excluded.v")
                return {**op, "type": "ok"}
            old, new = v
            _, tag = conn.query(
                f"UPDATE registers SET v = {int(new)} "
                f"WHERE k = {int(k)} AND v = {int(old)}")
            return {**op,
                    "type": "ok" if tag_count(tag) == 1 else "fail"}
        except (OSError, ConnectionError, PgError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class PgBankClient(PgClientBase):
    """Bank transfers in BEGIN..COMMIT transactions
    (postgres_rds.clj:160-233)."""

    def setup(self, test):
        accounts = test["accounts"]
        total = test["total-amount"]
        per, rem = divmod(total, len(accounts))
        try:
            conn = self._conn(test)
            for i, a in enumerate(accounts):
                conn.query(
                    f"INSERT INTO accounts (id, balance) VALUES "
                    f"({int(a)}, {per + (1 if i < rem else 0)}) "
                    f"ON CONFLICT (id) DO NOTHING")
        except (OSError, ConnectionError, PgError):
            # an unseeded bank would read as a FALSE wrong-total
            # "data loss": abort the run loudly instead
            self._drop()
            raise

    def invoke(self, test, op):
        try:
            conn = self._conn(test)
            if op["f"] == "read":
                conn.query(BEGIN_SQL)
                rows, _ = conn.query(
                    "SELECT id, balance FROM accounts")
                conn.query("COMMIT")
                return {**op, "type": "ok",
                        "value": {int(r[0]): int(r[1])
                                  for r in rows}}
            if op["f"] == "transfer":
                t = op["value"]
                conn.query(BEGIN_SQL)
                rows, _ = conn.query(
                    f"SELECT balance FROM accounts "
                    f"WHERE id = {int(t['from'])}")
                if not rows or int(rows[0][0]) < t["amount"]:
                    conn.query("ROLLBACK")
                    return {**op, "type": "fail",
                            "error": "insufficient funds"}
                conn.query(
                    f"UPDATE accounts SET balance = balance - "
                    f"{int(t['amount'])} WHERE id = "
                    f"{int(t['from'])}")
                conn.query(
                    f"UPDATE accounts SET balance = balance + "
                    f"{int(t['amount'])} WHERE id = "
                    f"{int(t['to'])}")
                conn.query("COMMIT")
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {op['f']!r}")
        except (OSError, ConnectionError, PgError) as e:
            self._drop()
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class PgAppendClient(PgClientBase):
    """elle list-append txns: each mop batch in one SQL transaction
    over a TEXT-csv list column (stolon/append.clj shape)."""

    def invoke(self, test, op):
        from ..txn import APPEND, R
        try:
            conn = self._conn(test)
            conn.query(BEGIN_SQL)
            done = []
            for f, k, v in op["value"]:
                if f == APPEND:
                    conn.query(
                        f"INSERT INTO lists (k, v) VALUES "
                        f"({int(k)}, '{int(v)}') "
                        f"ON CONFLICT (k) DO UPDATE SET "
                        f"v = lists.v || ',{int(v)}'")
                    done.append([f, k, v])
                elif f == R:
                    rows, _ = conn.query(
                        f"SELECT v FROM lists WHERE k = {int(k)}")
                    cur = ([int(x) for x in
                            rows[0][0].split(",")]
                           if rows and rows[0][0] else None)
                    done.append([f, k, cur])
                else:
                    raise ValueError(f"unknown mop verb {f!r}")
            conn.query("COMMIT")
            return {**op, "type": "ok", "value": done}
        except (OSError, ConnectionError, PgError) as e:
            # the connection may hold an aborted transaction or a
            # desynchronized stream: drop it, don't repair it
            self._drop()
            return {**op, "type": "info", "error": str(e)[:200]}


def _w_register(options):
    w = linearizable_register.workload(
        {"nodes": options["nodes"],
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 100,
         "algorithm": "competition",
         "device": options.get("device")})
    return {**w, "client": PgRegisterClient()}


def _w_bank(options):
    from ..workloads import bank
    w = bank.workload(options)
    return {**w, "client": PgBankClient()}


def _w_append(options):
    from ..workloads import cycle_append
    w = cycle_append.workload(anomalies=("G0", "G1", "G2"),
                              device=options.get("device"))
    return {**w, "client": PgAppendClient()}


WORKLOADS = {"register": _w_register, "bank": _w_bank,
             "append": _w_append}

#: the workloads whose checks run kernels: the register's competition
#: race (its device lane) and the append's cycle search
DEVICE_WORKLOADS = ("register", "append")


def postgres_test(options: dict) -> dict:
    """Test map targeting an existing endpoint (postgres-rds shape):
    no daemons to kill, so the default nemesis is none — point the
    partitioner at it only when the endpoint's nodes are yours. The
    checks of `DEVICE_WORKLOADS` run their kernels on
    `options["device"]` (default the card), resolved here, so that a
    missing card raises before any node is set up."""
    nodes = options["nodes"]
    which = options.get("workload") or "register"
    if which in DEVICE_WORKLOADS:
        options = {**options,
                   "device": resolve_device(options.get("device"))}
    try:
        w = WORKLOADS[which](options)
    except KeyError:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}") from None
    client = w["client"]
    db = ExternalDB(lambda test, node: PgConn(
        *client.addr_fn(test, node), user=client.user,
        database=client.database))
    extra = {k: v for k, v in w.items()
             if k not in ("checker", "generator", "client")}
    return {
        "name": options.get("name") or f"postgres-{which}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "ssh": {"dummy?": True},  # nothing to shell into: RDS pattern
        "db": db,
        "client": client,
        "nemesis": jnemesis.Nemesis(),
        "checker": jchecker.compose({
            which: w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        # client-scoped: with no nemesis stream, an unwrapped workload
        # generator could hand ops to the nemesis process
        "generator": gen.time_limit(
            options.get("time_limit") or 30,
            gen.clients(w["generator"])),
        **extra,
    }


def postgres_tests(options: dict):
    """tests_fn for `test-all`: sweep the workload axis."""
    workloads = ([options["workload"]] if options.get("workload")
                 else sorted(WORKLOADS))
    for which in workloads:
        opts = dict(options, workload=which)
        opts["name"] = f"{options.get('name') or 'postgres'}-{which}"
        yield postgres_test(opts)


POSTGRES_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Where to write results"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))} "
                 "(test: default register; test-all: sweeps all)"),
    cli.Opt("per_key_limit", metavar="N", default=100, parse=int,
            help="Ops per key"),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register / append checks' kernels run "
                 "(default: the card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": postgres_test,
                           "opt_spec": POSTGRES_OPTS}),
    **cli.test_all_cmd({"tests_fn": postgres_tests,
                        "opt_spec": POSTGRES_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
