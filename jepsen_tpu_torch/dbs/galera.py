"""Galera test suite — the MySQL-replication family exemplar
(galera/src/jepsen/galera{,.galera/dirty_reads}.clj, standing for
galera / percona / mysql-cluster, which all speak the same wire).

Everything on the wire is a FROM-SCRATCH MySQL client/server protocol
subset (the pgwire/BSON/RESP/AMQP/SSH discipline): 3-byte-length
packet framing, HandshakeV10 + HandshakeResponse41 with real
mysql_native_password scrambling (SHA1(pw) XOR SHA1(nonce ||
SHA1(SHA1(pw)))), COM_QUERY with OK/ERR/resultset parsing (lenenc
integers/strings, classic EOF framing).

Workloads (galera.clj / dirty_reads.clj):

- ``set``   — auto-increment inserts, final SELECT, set checker
  (sets-test, galera.clj:214-256).
- ``bank``  — conserved-total transfers in BEGIN..COMMIT txns
  (the percona exemplar, percona.clj:289-343).
- ``dirty-reads`` — writers UPDATE every row to a marker value in one
  txn and deliberately ROLLBACK some; readers SELECT all rows
  transactionally. A read containing a rolled-back marker is a DIRTY
  READ; rows disagreeing with each other is an inconsistent read
  (dirty_reads.clj:69-97 checker) — the anomaly the galera suite
  became famous for.

Two server modes: ``mini`` (default) runs LIVE in-repo MySQL-wire
servers per node (real sqlite WAL behind the codec) over localexec
with kill faults; ``deb`` emits the real percona-xtradb/galera
cluster recipe (wsrep provider config, bootstrap-first-node,
joiners), command-assertion tested.

The port's copy of `jepsen_tpu/dbs/galera.py`, the MySQL-wire family's
base (percona, mysql_cluster and tidb build on its codec, its embedded
server and its client base). Its own choices: the mini servers listen
from `MINI_BASE_PORT` 31100 (the reference's from 25500, so that both
packages' servers can run on one host at once: `MiniServerDB` kills by
`minimysql.py --port N` across the host; below Linux's ephemeral range,
32768-60999; `deb` mode keeps MySQL's `PORT` 3306); the store root
`store/torch`. `MINIMYSQL_SRC` is the reference's server, byte for byte.
The checks of its workloads run on the host and take no device.

    python -m jepsen_tpu_torch.dbs.galera test --nodes g1 --workload set \
        --time-limit 8
"""

from __future__ import annotations

import hashlib
import socket
import struct
import sys
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..history import History
from ..ledger import BASE_DIR
from ..os_setup import Debian
from . import miniserver

VERSION = "5.6.25-25.12"  # percona xtradb cluster era (galera.clj)
PORT = 3306
MINI_BASE_PORT = 31100
MINI_PIDFILE = "minimysql.pid"
MINI_LOGFILE = "minimysql.log"
MINI_PASSWORD = "jepsen-pw"
N_DIRTY_ROWS = 4


# -- MySQL wire codec (client side) -----------------------------------------

class MySqlError(Exception):
    def __init__(self, code: int, msg: str):
        self.code = code
        super().__init__(f"({code}) {msg}")


def native_scramble(password: str, nonce: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(nonce||SHA1(SHA1(pw)))."""
    if not password:
        return b""
    p1 = hashlib.sha1(password.encode()).digest()
    p2 = hashlib.sha1(p1).digest()
    mix = hashlib.sha1(nonce + p2).digest()
    return bytes(a ^ b for a, b in zip(p1, mix))


def lenenc(b: bytes, i: int) -> tuple[int, int]:
    """(value, next_offset) of a length-encoded integer."""
    c = b[i]
    if c < 0xFB:
        return c, i + 1
    if c == 0xFC:
        return struct.unpack_from("<H", b, i + 1)[0], i + 3
    if c == 0xFD:
        return int.from_bytes(b[i + 1:i + 4], "little"), i + 4
    if c == 0xFE:
        return struct.unpack_from("<Q", b, i + 1)[0], i + 9
    raise MySqlError(2027, f"bad lenenc prefix {c:#x}")


def put_lenenc(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + n.to_bytes(3, "little")
    return b"\xfe" + struct.pack("<Q", n)


CAPS = (0x00000001   # LONG_PASSWORD
        | 0x00000002  # FOUND_ROWS: affected-rows = matched, not
        #               changed — the CAS clients decide success by
        #               UPDATE ... WHERE value=old row counts, and a
        #               cas [x, x] against real MySQL would otherwise
        #               report 0 changed rows = a spurious failure
        | 0x00000008  # CONNECT_WITH_DB
        | 0x00000200  # PROTOCOL_41
        | 0x00002000  # TRANSACTIONS
        | 0x00008000  # SECURE_CONNECTION
        | 0x00080000)  # PLUGIN_AUTH


class MySqlConn:
    """One blocking COM_QUERY connection."""

    def __init__(self, host: str, port: int, user: str = "jepsen",
                 password: str = MINI_PASSWORD,
                 database: str = "jepsen", timeout: float = 5.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.rf = self.sock.makefile("rb")
        self.seq = 0
        self._handshake(user, password, database)

    # packet framing: 3-byte length + 1-byte sequence
    def _send(self, payload: bytes):
        self.sock.sendall(len(payload).to_bytes(3, "little")
                          + bytes([self.seq]) + payload)
        self.seq = (self.seq + 1) & 0xFF

    def _recv(self) -> bytes:
        hdr = self.rf.read(4)
        if len(hdr) < 4:
            raise MySqlError(2013, "lost connection")
        n = int.from_bytes(hdr[:3], "little")
        self.seq = (hdr[3] + 1) & 0xFF
        body = self.rf.read(n)
        if len(body) < n:
            raise MySqlError(2013, "short packet")
        return body

    def _handshake(self, user: str, password: str, database: str):
        greet = self._recv()
        if greet[0] == 0xFF:
            raise self._err(greet)
        if greet[0] != 10:
            raise MySqlError(2027, f"protocol {greet[0]} != 10")
        i = greet.index(b"\x00", 1) + 1  # server version string
        i += 4  # thread id
        auth1 = greet[i:i + 8]
        i += 8 + 1  # filler
        i += 2 + 1 + 2 + 2  # caps_low, charset, status, caps_high
        auth_len = greet[i]
        i += 1 + 10  # reserved
        auth2 = greet[i:i + max(13, auth_len - 8) - 1]
        nonce = (auth1 + auth2)[:20]
        scr = native_scramble(password, nonce)
        resp = (struct.pack("<IIB", CAPS, 1 << 24, 33) + b"\x00" * 23
                + user.encode() + b"\x00"
                + bytes([len(scr)]) + scr
                + database.encode() + b"\x00"
                + b"mysql_native_password\x00")
        self._send(resp)
        ok = self._recv()
        if ok[0] == 0xFF:
            raise self._err(ok)
        if ok[0] not in (0x00, 0xFE):
            raise MySqlError(2027, f"unexpected auth reply {ok[0]:#x}")

    @staticmethod
    def _err(pkt: bytes) -> MySqlError:
        code = struct.unpack_from("<H", pkt, 1)[0]
        msg = pkt[3:].decode(errors="replace")
        if msg.startswith("#"):
            msg = msg[6:]
        return MySqlError(code, msg)

    def query(self, sql: str) -> tuple[list, int]:
        """Execute one statement: (rows, affected). Rows are lists of
        str-or-None."""
        self.seq = 0
        self._send(b"\x03" + sql.encode())
        first = self._recv()
        if first[0] == 0xFF:
            raise self._err(first)
        if first[0] == 0x00:  # OK
            affected, i = lenenc(first, 1)
            return [], affected
        ncols, _ = lenenc(first, 0)
        for _ in range(ncols):  # column definitions: skipped
            self._recv()
        eof = self._recv()
        if eof[0] != 0xFE:
            raise MySqlError(2027, "expected EOF after columns")
        rows = []
        while True:
            pkt = self._recv()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return rows, 0
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            row, i = [], 0
            for _ in range(ncols):
                if pkt[i] == 0xFB:
                    row.append(None)
                    i += 1
                else:
                    n, i = lenenc(pkt, i)
                    row.append(pkt[i:i + n].decode())
                    i += n
            rows.append(row)

    def close(self):
        try:
            self.seq = 0
            self._send(b"\x01")  # COM_QUIT
        except OSError:
            pass
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


# -- the LIVE mini server ---------------------------------------------------

MINIMYSQL_SRC = r'''
import argparse, hashlib, os, re, socketserver, sqlite3, struct

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
p.add_argument("--password", default="jepsen-pw")
args = p.parse_args()

DB_PATH = os.path.join(args.dir, "minimysql.db")
# writer serialization = BEGIN IMMEDIATE + busy_timeout per connection
DOUBLE_HASH = hashlib.sha1(
    hashlib.sha1(args.password.encode()).digest()).digest()

def put_lenenc(n):
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + n.to_bytes(3, "little")
    return b"\xfe" + struct.pack("<Q", n)

def translate(sql):
    # the dialect bridge: suite clients speak real MySQL SQL; the
    # sqlite engine behind the wire needs these three MySQL-isms
    # rewritten (everything else is common SQL)
    sql = sql.replace("auto_increment", "AUTOINCREMENT") \
             .replace("AUTO_INCREMENT", "AUTOINCREMENT")
    # row-lock hints: BEGIN IMMEDIATE already serializes writers
    sql = re.sub(r"\s+for\s+update\s*$", "", sql, flags=re.I)
    sql = re.sub(r"\s+lock\s+in\s+share\s+mode\s*$", "", sql,
                 flags=re.I)
    # storage-engine clauses (NDBCLUSTER, InnoDB...): one engine here
    sql = re.sub(r"\s+engine\s*=\s*\w+", "", sql, flags=re.I)
    # upsert: ON DUPLICATE KEY UPDATE -> ON CONFLICT(pk) DO UPDATE
    # SET, conflict target = first column of the insert column list
    m = re.search(r"\son\s+duplicate\s+key\s+update\s+", sql, re.I)
    if m:
        head, tail = sql[:m.start()], sql[m.end():]
        cm = re.search(r"insert\s+into\s+\S+\s*\(\s*"
                       r"([A-Za-z_][A-Za-z_0-9]*)", head, re.I)
        pk = cm.group(1) if cm else "id"
        sql = head + " ON CONFLICT(" + pk + ") DO UPDATE SET " + tail
    return sql

class Conn(socketserver.StreamRequestHandler):
    def send_pkt(self, payload):
        self.wfile.write(len(payload).to_bytes(3, "little")
                         + bytes([self.seq]) + payload)
        self.wfile.flush()
        self.seq = (self.seq + 1) & 0xFF

    def recv_pkt(self):
        hdr = self.rfile.read(4)
        if len(hdr) < 4:
            return None
        n = int.from_bytes(hdr[:3], "little")
        self.seq = (hdr[3] + 1) & 0xFF
        body = self.rfile.read(n)
        return body if len(body) == n else None

    def ok(self, affected=0):
        self.send_pkt(b"\x00" + put_lenenc(affected) + put_lenenc(0)
                      + struct.pack("<HH", 2, 0))

    def err(self, code, msg):
        self.send_pkt(b"\xff" + struct.pack("<H", code) + b"#HY000"
                      + msg.encode()[:200])

    def eof(self):
        self.send_pkt(b"\xfe" + struct.pack("<HH", 0, 2))

    def handle(self):
        self.seq = 0
        nonce = os.urandom(20)
        greet = (b"\x0a" + b"5.7.0-minimysql\x00"
                 + struct.pack("<I", 1) + nonce[:8] + b"\x00"
                 + struct.pack("<H", 0xF7FF) + b"\x21"
                 + struct.pack("<H", 2)
                 + struct.pack("<H", 0x000F) + bytes([21])
                 + b"\x00" * 10 + nonce[8:] + b"\x00"
                 + b"mysql_native_password\x00")
        self.send_pkt(greet)
        resp = self.recv_pkt()
        if resp is None or len(resp) < 36:
            return
        i = 32
        user_end = resp.index(b"\x00", i)
        i = user_end + 1
        alen = resp[i]
        scramble = resp[i + 1:i + 1 + alen]
        # verify: SHA1(nonce||double_hash) XOR scramble == SHA1(pw)
        mix = hashlib.sha1(nonce + DOUBLE_HASH).digest()
        p1 = bytes(a ^ b for a, b in zip(scramble, mix))
        if not scramble or hashlib.sha1(p1).digest() != DOUBLE_HASH:
            self.err(1045, "Access denied")
            return
        self.ok()
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
                self.seq = 0
                # recv resets seq from the client's 0
                pkt = self.recv_pkt()
                if pkt is None or pkt[:1] == b"\x01":  # COM_QUIT
                    return
                if pkt[:1] == b"\x0e":  # COM_PING
                    self.ok()
                    continue
                if pkt[:1] != b"\x03":  # COM_QUERY only
                    self.err(1047, "unsupported command")
                    continue
                self.run_sql(db, in_txn,
                             pkt[1:].decode(errors="replace"))
        finally:
            try:
                if in_txn[0]:
                    db.rollback()
                db.close()
            except sqlite3.Error:
                pass

    def run_sql(self, db, in_txn, sql):
        up = sql.strip().upper()
        try:
            if up.startswith("BEGIN") or up.startswith(
                    "START TRANSACTION"):
                db.execute("BEGIN IMMEDIATE")
                in_txn[0] = True
                return self.ok()
            if up.startswith("COMMIT"):
                db.execute("COMMIT")
                in_txn[0] = False
                return self.ok()
            if up.startswith("ROLLBACK"):
                db.execute("ROLLBACK")
                in_txn[0] = False
                return self.ok()
            if up.startswith("SET "):
                return self.ok()  # session knobs: accepted, ignored
            sql = translate(sql)
            before = db.total_changes
            cur = db.execute(sql)
            if cur.description is None:
                return self.ok(db.total_changes - before)
            rows = cur.fetchall()
            ncols = len(cur.description)
            self.send_pkt(put_lenenc(ncols))
            for col in cur.description:
                name = col[0].encode()
                cdef = (put_lenenc(3) + b"def"
                        + put_lenenc(0) + put_lenenc(0)
                        + put_lenenc(0)
                        + put_lenenc(len(name)) + name
                        + put_lenenc(len(name)) + name
                        + b"\x0c" + struct.pack("<HIBHBH", 33, 255,
                                                253, 0, 0, 0))
                self.send_pkt(cdef)
            self.eof()
            for row in rows:
                out = b""
                for v in row:
                    if v is None:
                        out += b"\xfb"
                    else:
                        b = str(v).encode()
                        out += put_lenenc(len(b)) + b
                self.send_pkt(out)
            self.eof()
        except sqlite3.Error as e:
            if in_txn[0]:
                try:
                    db.rollback()
                except sqlite3.Error:
                    pass
                in_txn[0] = False
            self.err(1213, str(e)[:150])

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

print("minimysql serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Conn).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "galera_ports")


class MiniGaleraDB(miniserver.MiniServerDB):
    script = "minimysql.py"
    src = MINIMYSQL_SRC
    pidfile = MINI_PIDFILE
    logfile = MINI_LOGFILE
    data_files = ("minimysql.db", "minimysql.db-wal",
                  "minimysql.db-shm")

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", ".", "--password", MINI_PASSWORD]


class GaleraDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real percona-xtradb-cluster automation (galera.clj:34-101):
    apt install, wsrep provider config with the full cluster address,
    bootstrap-pc on the primary, joiners start normally."""

    def __init__(self, version: str = VERSION):
        self.version = version

    @staticmethod
    def galera_cnf(test: dict, node: str) -> str:
        """The wsrep cluster config (galera.clj:59-74 configure!)."""
        cluster = ",".join(test["nodes"])
        return ("[mysqld]\n"
                "wsrep_provider=/usr/lib/libgalera_smm.so\n"
                f"wsrep_cluster_address=gcomm://{cluster}\n"
                f"wsrep_node_address={node}\n"
                "wsrep_sst_method=rsync\n"
                "binlog_format=ROW\n"
                "default_storage_engine=InnoDB\n"
                "innodb_autoinc_lock_mode=2\n")

    def setup(self, test, node):
        primary = test["nodes"][0]
        with control.su():
            control.exec_("apt-get", "install", "-y",
                          f"percona-xtradb-cluster-56={self.version}")
            nodeutil.write_file(self.galera_cnf(test, node),
                                "/etc/mysql/conf.d/galera.cnf")
            if node == primary:
                control.exec_("service", "mysql", "bootstrap-pc")
            else:
                control.exec_("service", "mysql", "start")

    def teardown(self, test, node):
        with control.su():
            nodeutil.meh(control.exec_, "service", "mysql", "stop")
            control.exec_("rm", "-rf",
                          control.lit("/var/lib/mysql/grastate.dat"))

    def start(self, test, node):
        with control.su():
            control.exec_("service", "mysql", "start")
        return "started"

    def kill(self, test, node):
        with control.su():
            nodeutil.grepkill("mysqld")
        return "killed"

    def log_files(self, test, node):
        return ["/var/log/mysql/error.log"]


# -- clients ----------------------------------------------------------------

class _GaleraBase(jclient.Client):
    """In mini mode every worker drives the PRIMARY's server
    (pin_primary: single logical store, crash-recovery faults — the
    sqlite-suite topology); in deb mode each worker drives ITS OWN
    node, because cross-node visibility is exactly what the galera
    workloads probe (a primary-pinned dirty-reads run could never
    observe the anomaly). Connects retry briefly across the restart
    window."""

    def __init__(self, port_fn=None, timeout: float = 5.0,
                 pin_primary: bool = False):
        self.port_fn = port_fn or (lambda test, node: (node, PORT))
        self.timeout = timeout
        self.pin_primary = pin_primary
        self.node: Optional[str] = None
        self.conn: Optional[MySqlConn] = None

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout, self.pin_primary)
        c.node = node
        return c

    def _conn(self, test) -> MySqlConn:
        if self.conn is None:
            from .retryclient import connect_with_retry
            target = (test["nodes"][0] if self.pin_primary
                      else self.node)
            host, port = self.port_fn(test, target)
            # MySqlError counts too: a server dying mid-handshake
            # surfaces as (2013) lost connection
            self.conn = connect_with_retry(
                lambda: MySqlConn(host, port, timeout=self.timeout),
                (OSError, MySqlError))
        return self.conn

    def _drop(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def close(self, test):
        self._drop()


class GaleraSetClient(_GaleraBase):
    """sets-test client (galera.clj:214-235): add = INSERT, final
    read = SELECT all."""

    def setup(self, test):
        self._conn(test).query(
            "CREATE TABLE IF NOT EXISTS jepsen (id INTEGER PRIMARY "
            "KEY AUTOINCREMENT, value BIGINT NOT NULL)")

    def invoke(self, test, op):
        try:
            conn = self._conn(test)
            if op["f"] == "add":
                conn.query("INSERT INTO jepsen (value) VALUES "
                           f"({int(op['value'])})")
                return {**op, "type": "ok"}
            if op["f"] == "read":
                rows, _ = conn.query("SELECT value FROM jepsen")
                return {**op, "type": "ok",
                        "value": sorted(int(r[0]) for r in rows)}
            raise ValueError(f"unknown op {op['f']!r}")
        except (OSError, ConnectionError, MySqlError) as e:
            self._drop()
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class GaleraBankClient(_GaleraBase):
    """Conserved-total transfers in explicit txns (percona.clj
    bank-client)."""

    def setup(self, test):
        conn = self._conn(test)
        conn.query("CREATE TABLE IF NOT EXISTS accounts "
                   "(id INTEGER PRIMARY KEY, balance BIGINT)")
        accounts = test["accounts"]
        total = test["total-amount"]
        per, rem = divmod(total, len(accounts))
        for i, a in enumerate(accounts):
            bal = per + (1 if i < rem else 0)
            try:
                conn.query(f"INSERT INTO accounts VALUES ({a}, {bal})")
            except MySqlError:
                pass  # another worker's setup won the race: idempotent

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                rows, _ = conn.query("SELECT id, balance FROM accounts")
                return {**op, "type": "ok",
                        "value": {int(r[0]): int(r[1]) for r in rows}}
            if f == "transfer":
                t = op["value"]
                src, dst, amt = t["from"], t["to"], t["amount"]
                try:
                    conn.query("BEGIN")
                    rows, _ = conn.query(
                        f"SELECT balance FROM accounts WHERE id={src}")
                    if not rows or int(rows[0][0]) < amt:
                        conn.query("ROLLBACK")
                        return {**op, "type": "fail"}
                    conn.query(f"UPDATE accounts SET balance = "
                               f"balance - {amt} WHERE id = {src}")
                    conn.query(f"UPDATE accounts SET balance = "
                               f"balance + {amt} WHERE id = {dst}")
                    conn.query("COMMIT")
                except MySqlError as e:
                    try:
                        conn.query("ROLLBACK")
                    except (OSError, MySqlError):
                        self._drop()
                    return {**op, "type": "fail",
                            "error": str(e)[:200]}
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, MySqlError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class DirtyReadsClient(_GaleraBase):
    """dirty_reads.clj client: a write txn UPDATEs every row to the
    op's marker value, then COMMITs (ok) or deliberately ROLLBACKs
    (fail — the marker must never become visible); a read SELECTs all
    rows in one txn."""

    def setup(self, test):
        conn = self._conn(test)
        conn.query("CREATE TABLE IF NOT EXISTS dirty "
                   "(id INTEGER PRIMARY KEY, x BIGINT)")
        for i in range(N_DIRTY_ROWS):
            try:
                conn.query(f"INSERT INTO dirty VALUES ({i}, -1)")
            except MySqlError:
                pass

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "write":
                v = int(op["value"])
                commit = v % 2 == 0  # odd markers always roll back
                try:
                    conn.query("BEGIN")
                    conn.query(f"UPDATE dirty SET x = {v}")
                    conn.query("COMMIT" if commit else "ROLLBACK")
                except MySqlError as e:
                    try:
                        conn.query("ROLLBACK")
                    except (OSError, MySqlError):
                        self._drop()
                    return {**op, "type": "fail",
                            "error": str(e)[:200]}
                return {**op, "type": "ok" if commit else "fail"}
            if f == "read":
                try:
                    conn.query("BEGIN")
                    rows, _ = conn.query("SELECT x FROM dirty")
                    conn.query("COMMIT")
                except MySqlError as e:
                    try:
                        conn.query("ROLLBACK")
                    except (OSError, MySqlError):
                        self._drop()
                    return {**op, "type": "fail",
                            "error": str(e)[:200]}
                return {**op, "type": "ok",
                        "value": [int(r[0]) for r in rows]}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, MySqlError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class DirtyReadsChecker(jchecker.Checker):
    """dirty_reads.clj:73-97: a FAILED write's marker visible to any
    ok read is a dirty read; a read whose rows disagree is an
    inconsistent read. Valid iff no dirty reads."""

    def check(self, test, history: History, opts=None):
        failed = {op.value for op in history
                  if op.f == "write" and op.is_fail
                  and op.value is not None}
        dirty, inconsistent = [], []
        for op in history:
            if op.f == "read" and op.is_ok:
                vals = op.value
                if any(v in failed for v in vals):
                    dirty.append(vals)
                if len(set(vals)) > 1:
                    inconsistent.append(vals)
        return {"valid?": not dirty,
                "dirty-reads": dirty[:8],
                "inconsistent-reads": inconsistent[:8]}


# -- test map ---------------------------------------------------------------

def _w_set(options):
    from ..workloads import sets
    w = sets.workload({"time_limit":
                       max(1, (options.get("time_limit") or 10) - 3)})
    return {**w, "client": GaleraSetClient(), "wrap_time": False}


def _w_bank(options):
    from ..workloads import bank
    w = bank.workload(options)
    return {**w, "client": GaleraBankClient()}


def _w_dirty(options):
    counter = iter(range(10**9))

    def write(test, ctx):
        return {"f": "write", "value": next(counter)}

    return {
        "client": DirtyReadsClient(),
        "checker": DirtyReadsChecker(),
        "generator": gen.clients(gen.mix(
            [write, gen.repeat({"f": "read", "value": None})])),
    }


WORKLOADS = {"set": _w_set, "bank": _w_bank, "dirty-reads": _w_dirty}


def galera_test(options: dict) -> dict:
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    which = options.get("workload") or "set"
    try:
        w = WORKLOADS[which](options)
    except KeyError:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}") from None

    if mode == "mini":
        db: jdb.DB = MiniGaleraDB()
        client = w["client"]
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, node))
        client.pin_primary = True  # one logical store in mini mode
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "galera-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "deb":
        db = GaleraDB(options.get("version") or VERSION)
        client = w["client"]
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    interval = options.get("nemesis_interval") or 3.0
    time_limit = options.get("time_limit") or 10
    workload_gen = w["generator"]
    nem_gen = gen.cycle([gen.sleep(interval),
                         {"type": "info", "f": "start"},
                         gen.sleep(interval),
                         {"type": "info", "f": "stop"}])
    if not w.get("wrap_time", True):
        nem_gen = gen.phases(
            gen.time_limit(max(1.0, time_limit - 4.0), nem_gen),
            gen.once(lambda test, ctx: {"type": "info", "f": "stop"}))
    workload_gen = gen.nemesis(nem_gen, workload_gen)
    if w.get("wrap_time", True):
        workload_gen = gen.time_limit(time_limit, workload_gen)
    pass_extra = {k: v for k, v in w.items()
                  if k not in ("checker", "generator", "client",
                               "wrap_time")}
    return {
        "name": options.get("name") or f"galera-{which}-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "nemesis": jnemesis.node_start_stopper(
            lambda ns: [ns[0]],  # the primary holds the store
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


def galera_tests(options: dict):
    which = options.get("workload")
    for name in ([which] if which else sorted(WORKLOADS)):
        opts = dict(options, workload=name)
        opts["name"] = f"{options.get('name') or 'galera'}-{name}"
        yield galera_test(opts)


GALERA_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo MySQL-wire servers) or deb "
                 "(real percona-xtradb cluster on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("sandbox", metavar="DIR", default="galera-cluster"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": galera_test,
                           "opt_spec": GALERA_OPTS}),
    **cli.test_all_cmd({"tests_fn": galera_tests,
                        "opt_spec": GALERA_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
