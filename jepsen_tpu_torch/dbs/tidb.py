"""TiDB test suite — the distributed-SQL deep-dive exemplar
(tidb/src/tidb/{core,db,sql,bank,monotonic,register,sets,sequential,
long_fork,table}.clj, 13 files / 2,598 LoC; SURVEY.md §2.4's
representative suite).

What makes the reference's TiDB suite the deep-dive exemplar, all
replicated here:

- **11 workloads** (core.clj:32-44): bank, bank-multitable,
  long-fork, monotonic (inc cycles), txn-cycle (wr), append,
  register, set, set-cas, sequential, table (DDL races).
- **Workload option axes** (core.clj:46-120): ``auto-retry`` /
  ``auto-retry-limit`` (session vars ``tidb_disable_txn_auto_retry``
  / ``tidb_retry_limit``, sql.clj:27-47), ``read-lock`` (nil or
  "FOR UPDATE" appended to reads), ``use-index`` (query the secondary
  ``sk`` column instead of the primary key), ``update-in-place``
  (blind UPDATE vs read-then-write). ``all_combos`` expands the axes
  combinatorially for `test-all`, with the reference's
  ``expected-to-pass`` (no auto-retry) and ``quick`` restrictions.
- **3-daemon DB automation** (db.clj:18-410): pd -> tikv -> tidb
  start order with per-daemon pid/log files and readiness polling,
  pd-leader discovery over the pd HTTP API, restart loops.

Everything rides the from-scratch MySQL wire codec shared with the
galera family (`galera.MySqlConn` — TiDB speaks the MySQL protocol,
tidb/sql.clj's mariadb jdbc spec:17-25). ``mini`` mode (default) runs
LIVE in-repo MySQL-wire servers over localexec (real sqlite WAL
engines behind the codec; the dialect bridge translates FOR UPDATE /
ON DUPLICATE KEY UPDATE); ``tarball`` mode emits the real
pingcap-tarball pd/tikv/tidb cluster recipe, command-assertion
tested like the reference's own automation.

The port's copy of `jepsen_tpu/dbs/tidb.py`, on the port's `galera`. Its
own choices: the mini servers listen from `MINI_BASE_PORT` 31250 (the
reference's from 26300, so that both packages' servers can run on one
host at once; below Linux's ephemeral range, 32768-60999; `tarball` mode
keeps tidb-server's `SQL_PORT` 4000); `--device` on `test` and
`test-all`, passed to the `register` workload's competition race (its
device lane runs the WGL chunk kernels) and to the `append` and
`txn-cycle` checkers (their cycle search), default the card: a missing
card raises before any node is set up, `--device cpu` runs the plain
PyTorch versions (the other workloads' checks run on the host and take
no device); the store root `store/torch`.

    python -m jepsen_tpu_torch.dbs.tidb test --nodes n1 --workload append \
        --time-limit 5 --device cpu
"""

from __future__ import annotations

import itertools
import sys
from typing import Optional

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..os_setup import Debian
from ..txn import APPEND, R, W, is_mop
from ..util import resolve_device
from . import retryclient
from .galera import MiniGaleraDB, MySqlConn, MySqlError

VERSION = "v3.0.3"  # pingcap release era of the reference suite
SQL_PORT = 4000      # tidb-server client port (sql.clj:22)
PD_CLIENT_PORT = 2379
PD_PEER_PORT = 2380
DIR = "/opt/tidb"
MINI_BASE_PORT = 31250

# transaction-abort shapes: TiDB's retryable conflicts (sql.clj
# rollback-msg / capture-txn-abort:178-199) plus the mini engine's
# writer-lock timeout, all of which mean "txn aborted, definite fail"
ABORT_PATTERNS = ("Deadlock found", "try again later",
                  "Write conflict", "database is locked")


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "tidb_ports")


class TxnAbort(Exception):
    """A definite transaction abort (sql.clj capture-txn-abort)."""


def classify(e: MySqlError) -> str:
    """abort (definite fail) vs indefinite error."""
    msg = str(e)
    return ("abort" if any(p in msg for p in ABORT_PATTERNS)
            else "error")


# -- DB automation (tarball mode) --------------------------------------------

def tarball_url(version: str) -> str:
    """db.clj:147-153 download URL shape."""
    return (f"http://download.pingcap.org/tidb-{version}"
            "-linux-amd64.tar.gz")


def pd_name(test: dict, node: str) -> str:
    """node -> pd member name pd1..pdN (db.clj:48-55 tidb-map)."""
    return f"pd{test['nodes'].index(node) + 1}"


def pd_initial_cluster(test: dict) -> str:
    """pd1=http://n1:2380,... (db.clj:72-79)."""
    return ",".join(
        f"{pd_name(test, n)}=http://{n}:{PD_PEER_PORT}"
        for n in test["nodes"])


def pd_endpoints(test: dict) -> str:
    """Comma-joined pd client URLs (db.clj:81-87)."""
    return ",".join(f"{n}:{PD_CLIENT_PORT}" for n in test["nodes"])


class TidbDB(jdb.DB, jdb.Process, jdb.Pause, jdb.LogFiles):
    """The pd/tikv/tidb daemon stack (db.clj:165-410): one tarball,
    three pidfiled daemons started in dependency order with
    readiness gates between them."""

    def __init__(self, version: str = VERSION):
        self.version = version

    # -- per-daemon start (db.clj start-pd!:165, start-kv!:180,
    # start-db!:195) --
    def _start_pd(self, test, node):
        nodeutil.start_daemon(
            {"logfile": f"{DIR}/pd.stdout", "pidfile": f"{DIR}/pd.pid",
             "chdir": DIR},
            "./bin/pd-server",
            "--name", pd_name(test, node),
            "--data-dir", f"{DIR}/data/pd",
            "--client-urls", f"http://0.0.0.0:{PD_CLIENT_PORT}",
            "--advertise-client-urls",
            f"http://{node}:{PD_CLIENT_PORT}",
            "--peer-urls", f"http://0.0.0.0:{PD_PEER_PORT}",
            "--advertise-peer-urls", f"http://{node}:{PD_PEER_PORT}",
            "--initial-cluster", pd_initial_cluster(test),
            "--log-file", f"{DIR}/pd.log")
        nodeutil.await_tcp_port(PD_CLIENT_PORT, timeout_s=60)

    def _start_kv(self, test, node):
        nodeutil.start_daemon(
            {"logfile": f"{DIR}/kv.stdout", "pidfile": f"{DIR}/kv.pid",
             "chdir": DIR},
            "./bin/tikv-server",
            "--pd", pd_endpoints(test),
            "--addr", "0.0.0.0:20160",
            "--advertise-addr", f"{node}:20160",
            "--data-dir", f"{DIR}/data/kv",
            "--log-file", f"{DIR}/kv.log")
        nodeutil.await_tcp_port(20160, timeout_s=60)

    def _start_db(self, test, node):
        nodeutil.start_daemon(
            {"logfile": f"{DIR}/db.stdout", "pidfile": f"{DIR}/db.pid",
             "chdir": DIR},
            "./bin/tidb-server",
            "--store", "tikv",
            "--path", pd_endpoints(test),
            "-P", str(SQL_PORT),
            "--log-file", f"{DIR}/db.log")
        nodeutil.await_tcp_port(SQL_PORT, timeout_s=120)

    def setup(self, test, node):
        with control.su():
            nodeutil.install_archive(
                tarball_url(self.version), DIR,
                force=bool(test.get("force_reinstall")))
        self.start(test, node)

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf", f"{DIR}/data",
                          *(f"{DIR}/{f}.log" for f in
                            ("pd", "kv", "db", "slow")))

    # -- db.Process --
    def start(self, test, node):
        self._start_pd(test, node)
        self._start_kv(test, node)
        self._start_db(test, node)
        return "started"

    def kill(self, test, node):
        # reverse dependency order (db.clj stop-db!/kv!/pd!:210-230)
        for daemon, pattern in (("db", "tidb-server"),
                                ("kv", "tikv-server"),
                                ("pd", "pd-server")):
            nodeutil.stop_daemon(f"{DIR}/{daemon}.pid")
            nodeutil.grepkill(pattern)
        return "killed"

    # -- db.Pause --
    def pause(self, test, node):
        for pattern in ("tidb-server", "tikv-server", "pd-server"):
            nodeutil.signal(pattern, "STOP")
        return "paused"

    def resume(self, test, node):
        for pattern in ("tidb-server", "tikv-server", "pd-server"):
            nodeutil.signal(pattern, "CONT")
        return "resumed"

    def log_files(self, test, node):
        return [f"{DIR}/{f}" for f in
                ("pd.log", "kv.log", "db.log", "slow.log")]


class MiniTidbDB(MiniGaleraDB):
    """Mini mode: the shared live MySQL-wire server (galera family)."""
    pidfile = "minitidb.pid"
    logfile = "minitidb.log"

    def port(self, test, node):
        return mini_node_port(test, node)


# -- client base --------------------------------------------------------------

class _TidbBase(retryclient.RetryClient):
    """Shared TiDB SQL client plumbing: connect-with-retry to the
    node (or the primary in mini mode), session init for the
    auto-retry axes (sql.clj init-conn!:28-47), txn helpers with
    abort capture (sql.clj:178-230)."""

    retry_excs = (OSError, MySqlError)
    default_port = SQL_PORT

    def _connect(self, host, port) -> MySqlConn:
        return MySqlConn(host, port, timeout=self.timeout)

    def _post_connect(self, conn, test):
        # session axes (sql.clj init-conn!): :default leaves the
        # server's own behavior in place
        ar = test.get("auto_retry", "default")
        if ar != "default":
            conn.query("SET @@tidb_disable_txn_auto_retry = "
                       f"{0 if ar else 1}")
        lim = test.get("auto_retry_limit", "default")
        if lim != "default":
            conn.query(f"SET @@tidb_retry_limit = {int(lim)}")

    # -- SQL helpers honoring the option axes --
    @staticmethod
    def read_lock(test) -> str:
        rl = test.get("read_lock")
        return f" {rl}" if rl else ""

    @staticmethod
    def key_col(test) -> str:
        """pk vs the indexed sk column (register.clj:24-27,
        monotonic.clj read-key)."""
        return "sk" if test.get("use_index") else "id"

    def _txn(self, conn: MySqlConn, body, vote: bool = False):
        """BEGIN..COMMIT around body(conn); MySqlError inside rolls
        back; abort-shaped errors raise TxnAbort (definite fail).
        With vote=True the body's truthiness decides COMMIT vs
        ROLLBACK (bank transfers: a failed precondition must leave
        no trace)."""
        conn.query("BEGIN")
        try:
            out = body(conn)
        except MySqlError as e:
            try:
                conn.query("ROLLBACK")
            except (OSError, MySqlError):
                self._drop()
            if classify(e) == "abort":
                raise TxnAbort(str(e)) from e
            raise
        conn.query("COMMIT" if (out or not vote) else "ROLLBACK")
        return out

    def invoke(self, test, op):
        """Template: subclasses implement _invoke; this maps errors
        exactly like sql.clj with-error-handling / with-txn-aborts:
        TxnAbort -> fail; conn-level errors -> fail for reads, info
        for writes."""
        try:
            return self._invoke(test, op)
        except TxnAbort as e:
            return {**op, "type": "fail", "error": str(e)[:200]}
        except (OSError, ConnectionError, MySqlError) as e:
            self._drop()
            t = "fail" if op["f"] in ("read", "r") else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def _invoke(self, test, op):
        raise NotImplementedError


# -- register ----------------------------------------------------------------

class TidbRegisterClient(_TidbBase):
    """Linearizable register over `test (id, sk, val)`
    (register.clj:30-71): write = upsert, cas = read-then-update in a
    txn, read honors use-index + read-lock."""

    def setup(self, test):
        conn = self._conn(test)
        conn.query("CREATE TABLE IF NOT EXISTS test "
                   "(id INT NOT NULL PRIMARY KEY, sk INT, val INT)")
        if test.get("use_index"):
            # TiDB supports IF NOT EXISTS on CREATE INDEX
            conn.query("CREATE INDEX IF NOT EXISTS test_sk_val "
                       "ON test (sk, val)")

    def _read(self, conn, test, k) -> Optional[int]:
        rows, _ = conn.query(
            f"SELECT val FROM test WHERE {self.key_col(test)} = "
            f"{int(k)}{self.read_lock(test)}")
        return int(rows[0][0]) if rows and rows[0][0] is not None \
            else None

    def _invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"register wants [k v] tuples, got {kv!r}")
        k, v = kv
        conn = self._conn(test)
        f = op["f"]
        if f == "read":
            out = self._txn(conn,
                            lambda c: self._read(c, test, k))
            return {**op, "type": "ok", "value": tuple_(k, out)}
        if f == "write":
            self._txn(conn, lambda c: c.query(
                f"INSERT INTO test (id, sk, val) VALUES ({int(k)}, "
                f"{int(k)}, {int(v)}) ON DUPLICATE KEY UPDATE "
                f"val = {int(v)}"))
            return {**op, "type": "ok"}
        if f == "cas":
            expected, new = v

            def cas(c):
                cur = self._read(c, test, k)
                if cur != expected:
                    return False
                c.query(f"UPDATE test SET val = {int(new)} "
                        f"WHERE id = {int(k)}")
                return True

            won = self._txn(conn, cas)
            return {**op, "type": "ok" if won else "fail",
                    **({} if won else {"error": "precondition-failed"})}
        raise ValueError(f"unknown op {f!r}")


# -- txn clients (append / wr / long-fork) ------------------------------------

class _TidbMopClient(_TidbBase):
    """Micro-op transactions over `txn (id, sk, val TEXT)`: each op's
    value is a mop list executed in one BEGIN..COMMIT
    (monotonic.clj txn-workload / append-workload shape)."""

    #: "int" (wr/long-fork registers) or "list" (append)
    value_mode = "int"

    def setup(self, test):
        conn = self._conn(test)
        conn.query("CREATE TABLE IF NOT EXISTS txn "
                   "(id INT NOT NULL PRIMARY KEY, sk INT, val TEXT)")
        if test.get("use_index"):
            conn.query("CREATE INDEX IF NOT EXISTS txn_sk "
                       "ON txn (sk)")

    def _get(self, conn, test, k) -> Optional[str]:
        rows, _ = conn.query(
            f"SELECT val FROM txn WHERE {self.key_col(test)} = "
            f"{int(k)}{self.read_lock(test)}")
        return rows[0][0] if rows else None

    def _put(self, conn, k, text: str):
        conn.query(
            f"INSERT INTO txn (id, sk, val) VALUES ({int(k)}, "
            f"{int(k)}, '{text}') ON DUPLICATE KEY UPDATE "
            f"val = '{text}'")

    def _invoke(self, test, op):
        mops = op["value"]
        if not (isinstance(mops, list) and mops
                and all(is_mop(m) for m in mops)):
            raise ValueError(f"txn client wants mop lists, got {mops!r}")
        conn = self._conn(test)

        def run(c):
            done = []
            for f, k, v in mops:
                if f == R:
                    raw = self._get(c, test, k)
                    if self.value_mode == "list":
                        out = ([int(x) for x in raw.split(",")]
                               if raw else None)
                    else:
                        out = int(raw) if raw is not None else None
                    done.append([f, k, out])
                elif f == W:
                    self._put(c, k, str(int(v)))
                    done.append([f, k, v])
                elif f == APPEND:
                    raw = self._get(c, test, k)
                    text = f"{raw},{int(v)}" if raw else str(int(v))
                    self._put(c, k, text)
                    done.append([f, k, v])
                else:
                    raise ValueError(f"unknown mop {f!r}")
            return done

        done = self._txn(conn, run)
        return {**op, "type": "ok", "value": done}


class TidbAppendClient(_TidbMopClient):
    """Elle list-append: values are comma-joined lists
    (monotonic.clj append-workload)."""
    value_mode = "list"


class TidbWrClient(_TidbMopClient):
    """Elle wr + long-fork: register-valued keys
    (monotonic.clj txn-workload, long_fork.clj)."""
    value_mode = "int"


# -- bank ---------------------------------------------------------------------

class TidbBankClient(_TidbBase):
    """Single-table bank (bank.clj:20-77): transfers in explicit
    txns; `update-in-place` does blind UPDATEs then validates, else
    read-check-update; reads honor read-lock."""

    table = "accounts"

    def setup(self, test):
        conn = self._conn(test)
        conn.query(f"CREATE TABLE IF NOT EXISTS {self.table} "
                   "(id INT NOT NULL PRIMARY KEY, balance BIGINT)")
        accounts = test["accounts"]
        total = test["total-amount"]
        per, rem = divmod(total, len(accounts))
        for i, a in enumerate(accounts):
            bal = per + (1 if i < rem else 0)
            try:
                conn.query(f"INSERT INTO {self.table} VALUES "
                           f"({a}, {bal})")
            except MySqlError:
                pass  # setup race: idempotent

    def _invoke(self, test, op):
        conn = self._conn(test)
        f = op["f"]
        if f == "read":
            def read(c):
                rows, _ = c.query(
                    f"SELECT id, balance FROM {self.table}"
                    f"{self.read_lock(test)}")
                return {int(r[0]): int(r[1]) for r in rows}
            return {**op, "type": "ok",
                    "value": self._txn(conn, read)}
        if f == "transfer":
            t = op["value"]
            src, dst, amt = t["from"], t["to"], t["amount"]

            def transfer(c):
                if test.get("update_in_place"):
                    # blind updates, then validate (bank.clj:60-70)
                    c.query(f"UPDATE {self.table} SET balance = "
                            f"balance - {amt} WHERE id = {src}")
                    c.query(f"UPDATE {self.table} SET balance = "
                            f"balance + {amt} WHERE id = {dst}")
                    rows, _ = c.query(
                        f"SELECT balance FROM {self.table} "
                        f"WHERE id = {src}{self.read_lock(test)}")
                    return bool(rows) and int(rows[0][0]) >= 0
                rows, _ = c.query(
                    f"SELECT balance FROM {self.table} WHERE id = "
                    f"{src}{self.read_lock(test)}")
                if not rows or int(rows[0][0]) < amt:
                    return False
                c.query(f"UPDATE {self.table} SET balance = "
                        f"balance - {amt} WHERE id = {src}")
                c.query(f"UPDATE {self.table} SET balance = "
                        f"balance + {amt} WHERE id = {dst}")
                return True

            won = self._txn(conn, transfer, vote=True)
            return {**op, "type": "ok" if won else "fail"}
        raise ValueError(f"unknown op {f!r}")


class TidbMultiBankClient(TidbBankClient):
    """bank-multitable (bank.clj:90-160): one table per account,
    balance lives in row id=0 of each."""

    @staticmethod
    def _t(a) -> str:
        return f"accounts{int(a)}"

    def setup(self, test):
        conn = self._conn(test)
        accounts = test["accounts"]
        total = test["total-amount"]
        per, rem = divmod(total, len(accounts))
        for i, a in enumerate(accounts):
            bal = per + (1 if i < rem else 0)
            conn.query(f"CREATE TABLE IF NOT EXISTS {self._t(a)} "
                       "(id INT NOT NULL PRIMARY KEY, balance BIGINT)")
            try:
                conn.query(f"INSERT INTO {self._t(a)} VALUES (0, {bal})")
            except MySqlError:
                pass

    def _invoke(self, test, op):
        conn = self._conn(test)
        f = op["f"]
        accounts = test["accounts"]
        if f == "read":
            def read(c):
                out = {}
                for a in accounts:
                    rows, _ = c.query(
                        f"SELECT balance FROM {self._t(a)} WHERE "
                        f"id = 0{self.read_lock(test)}")
                    if rows:
                        out[a] = int(rows[0][0])
                return out
            return {**op, "type": "ok", "value": self._txn(conn, read)}
        if f == "transfer":
            t = op["value"]
            src, dst, amt = t["from"], t["to"], t["amount"]

            def transfer(c):
                if test.get("update_in_place"):
                    # blind updates then validate (bank.clj:140-152)
                    c.query(f"UPDATE {self._t(src)} SET balance = "
                            f"balance - {amt} WHERE id = 0")
                    c.query(f"UPDATE {self._t(dst)} SET balance = "
                            f"balance + {amt} WHERE id = 0")
                    rows, _ = c.query(
                        f"SELECT balance FROM {self._t(src)} WHERE "
                        f"id = 0{self.read_lock(test)}")
                    return bool(rows) and int(rows[0][0]) >= 0
                rows, _ = c.query(
                    f"SELECT balance FROM {self._t(src)} WHERE id = 0"
                    f"{self.read_lock(test)}")
                if not rows or int(rows[0][0]) < amt:
                    return False
                c.query(f"UPDATE {self._t(src)} SET balance = "
                        f"balance - {amt} WHERE id = 0")
                c.query(f"UPDATE {self._t(dst)} SET balance = "
                        f"balance + {amt} WHERE id = 0")
                return True

            won = self._txn(conn, transfer, vote=True)
            return {**op, "type": "ok" if won else "fail"}
        raise ValueError(f"unknown op {f!r}")


# -- sets ---------------------------------------------------------------------

class TidbSetClient(_TidbBase):
    """sets.clj SetClient: auto-increment inserts, read-all."""

    def setup(self, test):
        self._conn(test).query(
            "CREATE TABLE IF NOT EXISTS sets (id INTEGER PRIMARY KEY "
            "AUTO_INCREMENT, value BIGINT NOT NULL)")

    def _invoke(self, test, op):
        conn = self._conn(test)
        if op["f"] == "add":
            conn.query("INSERT INTO sets (value) VALUES "
                       f"({int(op['value'])})")
            return {**op, "type": "ok"}
        if op["f"] == "read":
            rows, _ = conn.query("SELECT value FROM sets")
            return {**op, "type": "ok",
                    "value": sorted(int(r[0]) for r in rows)}
        raise ValueError(f"unknown op {op['f']!r}")


class TidbCasSetClient(_TidbBase):
    """sets.clj CasSetClient: the whole set is one comma-joined text
    row CAS'd in a txn — reveals lost updates the insert variant
    can't."""

    def setup(self, test):
        self._conn(test).query(
            "CREATE TABLE IF NOT EXISTS csets "
            "(id INT NOT NULL PRIMARY KEY, value TEXT)")

    def _invoke(self, test, op):
        conn = self._conn(test)
        if op["f"] == "add":
            e = int(op["value"])

            def add(c):
                rows, _ = c.query(
                    "SELECT value FROM csets WHERE id = 0"
                    f"{self.read_lock(test)}")
                if rows:
                    c.query("UPDATE csets SET value = "
                            f"'{rows[0][0]},{e}' WHERE id = 0")
                else:
                    c.query(f"INSERT INTO csets VALUES (0, '{e}')")

            self._txn(conn, add)
            return {**op, "type": "ok"}
        if op["f"] == "read":
            rows, _ = conn.query("SELECT value FROM csets WHERE id = 0")
            vals = (sorted(int(x) for x in rows[0][0].split(","))
                    if rows and rows[0][0] else [])
            return {**op, "type": "ok", "value": vals}
        raise ValueError(f"unknown op {op['f']!r}")


# -- monotonic ----------------------------------------------------------------

class TidbMonotonicClient(_TidbBase):
    """monotonic.clj IncrementClient: `cycle (pk, sk, val)`; inc is a
    read-modify-write (or blind update when update-in-place), group
    reads snapshot keys in one txn; missing keys read -1."""

    def setup(self, test):
        conn = self._conn(test)
        conn.query("CREATE TABLE IF NOT EXISTS cycle "
                   "(pk INT NOT NULL PRIMARY KEY, sk INT NOT NULL, "
                   "val INT)")
        if test.get("use_index"):
            conn.query("CREATE INDEX IF NOT EXISTS cycle_sk_val "
                       "ON cycle (sk, val)")

    def _read_key(self, conn, test, k) -> int:
        col = "sk" if test.get("use_index") else "pk"
        rows, _ = conn.query(
            f"SELECT val FROM cycle WHERE {col} = {int(k)}")
        return int(rows[0][0]) if rows else -1

    def _invoke(self, test, op):
        conn = self._conn(test)
        if op["f"] == "inc":
            (k,) = op["value"].keys()

            def inc(c):
                if test.get("update_in_place"):
                    _, n = c.query("UPDATE cycle SET val = val + 1 "
                                   f"WHERE pk = {int(k)}")
                    if n == 0:
                        c.query(f"INSERT INTO cycle VALUES ({int(k)}, "
                                f"{int(k)}, 0)")
                    return {}  # no observed-value constraint
                v = self._read_key(c, test, k)
                if v == -1:
                    c.query(f"INSERT INTO cycle VALUES ({int(k)}, "
                            f"{int(k)}, 0)")
                    return {k: 0}
                col = "sk" if test.get("use_index") else "pk"
                c.query(f"UPDATE cycle SET val = {v + 1} "
                        f"WHERE {col} = {int(k)}")
                return {k: v + 1}

            return {**op, "type": "ok", "value": self._txn(conn, inc)}
        if op["f"] == "read":
            ks = sorted(op["value"])

            def read(c):
                return {k: self._read_key(c, test, k) for k in ks}
            return {**op, "type": "ok", "value": self._txn(conn, read)}
        raise ValueError(f"unknown op {op['f']!r}")


# -- sequential ---------------------------------------------------------------

class TidbSeqClient(_TidbBase):
    """sequential.clj: subkeys inserted in order, each in its own
    txn; reads scan in reverse."""

    def setup(self, test):
        self._conn(test).query(
            "CREATE TABLE IF NOT EXISTS seq "
            "(sk VARCHAR(64) NOT NULL PRIMARY KEY, val INT)")

    def _invoke(self, test, op):
        from ..workloads.sequential import DEFAULT_KEY_COUNT, subkeys
        kc = test.get("key_count") or DEFAULT_KEY_COUNT
        conn = self._conn(test)
        if op["f"] == "write":
            for sk in subkeys(kc, op["value"]):
                try:
                    # REPLACE: re-invocations after an indefinite
                    # insert must stay idempotent (both dialects)
                    conn.query(f"REPLACE INTO seq VALUES ('{sk}', 1)")
                except MySqlError as e:
                    if classify(e) == "abort":
                        raise TxnAbort(str(e)) from e
                    raise
            return {**op, "type": "ok"}
        if op["f"] == "read":
            k = op["value"][0]
            out = []
            for sk in reversed(subkeys(kc, k)):
                rows, _ = conn.query(
                    f"SELECT val FROM seq WHERE sk = '{sk}'")
                out.append(sk if rows else None)
            return {**op, "type": "ok", "value": [k, out]}
        raise ValueError(f"unknown op {op['f']!r}")


# -- table (DDL races) --------------------------------------------------------

class TidbTableClient(_TidbBase):
    """table.clj TableClient: `create-table` makes t<N>; `insert`
    writes into a table whose creation has ALREADY completed — a
    "doesn't exist" failure is a DDL-visibility bug. `box` is the
    shared last-created-table cell (table.clj's atom, swapped on
    create success:27-32)."""

    def __init__(self, port_fn=None, timeout: float = 5.0,
                 pin_primary: bool = False, box: Optional[dict] = None):
        super().__init__(port_fn, timeout, pin_primary)
        self.box = box if box is not None else {"created": None}

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout, self.pin_primary,
                       self.box)
        c.node = node
        return c

    def _invoke(self, test, op):
        conn = self._conn(test)
        if op["f"] == "create-table":
            tid = int(op["value"])
            conn.query(f"CREATE TABLE IF NOT EXISTS t{tid}"
                       " (id INT NOT NULL PRIMARY KEY, val INT)")
            prev = self.box["created"]
            self.box["created"] = tid if prev is None else max(prev, tid)
            return {**op, "type": "ok"}
        if op["f"] == "insert":
            table, k = op["value"]
            try:
                conn.query(f"INSERT INTO t{int(table)} (id) "
                           f"VALUES ({int(k)})")
                return {**op, "type": "ok"}
            except MySqlError as e:
                msg = str(e)
                if "no such table" in msg or "doesn't exist" in msg:
                    return {**op, "type": "fail",
                            "error": "doesn't-exist"}
                if ("UNIQUE" in msg or "Duplicate" in msg
                        or "PRIMARY" in msg):
                    return {**op, "type": "fail",
                            "error": "duplicate-key"}
                raise
        raise ValueError(f"unknown op {op['f']!r}")


class TableChecker(jchecker.Checker):
    """Inserts failing with doesn't-exist against an
    already-created table are errors (table.clj:71-78)."""

    def check(self, test, history, opts=None):
        bad = [op.to_dict() for op in history
               if op.is_fail and "doesn't-exist" ==
               (op.error or op.extra.get("error"))]
        return {"valid?": not bad, "errors": bad[:10]}


def table_generator(box: dict):
    """80% insert into the last FULLY-CREATED table (the shared cell
    the client updates on create success — table.clj's atom), else
    create the next one (table.clj:55-68)."""
    state = {"next": 0}

    def nxt(test, ctx):
        if box["created"] is not None and gen.RNG.random() < 0.8:
            return {"f": "insert",
                    "value": [box["created"], gen.RNG.randrange(10**9)]}
        state["next"] += 1
        return {"f": "create-table", "value": state["next"]}

    return gen.clients(nxt)


# -- the workload matrix (core.clj:32-44) -------------------------------------

def _w_register(options):
    from ..workloads import linearizable_register
    w = linearizable_register.workload(
        {"nodes": options["nodes"],
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 100,
         "algorithm": "competition",
         "device": options.get("device")})
    return {**w, "client": TidbRegisterClient()}


def _w_append(options):
    from ..workloads import cycle_append
    w = cycle_append.workload(anomalies=("G0", "G1", "G2"),
                              device=options.get("device"))
    return {**w, "client": TidbAppendClient()}


def _w_txn_cycle(options):
    from ..workloads import cycle_wr
    w = cycle_wr.workload(device=options.get("device"))
    return {**w, "client": TidbWrClient()}


def _w_long_fork(options):
    from ..workloads import long_fork
    w = long_fork.workload()
    return {**w, "client": TidbWrClient()}


def _w_bank(options):
    from ..workloads import bank
    w = bank.workload(options)
    return {**w, "client": TidbBankClient()}


def _w_bank_multitable(options):
    from ..workloads import bank
    w = bank.workload(options)
    return {**w, "client": TidbMultiBankClient()}


def _w_set(options):
    from ..workloads import sets
    w = sets.workload({"time_limit":
                       max(1, (options.get("time_limit") or 10) - 3)})
    return {**w, "client": TidbSetClient(), "wrap_time": False}


def _w_set_cas(options):
    from ..workloads import sets
    w = sets.workload({"time_limit":
                       max(1, (options.get("time_limit") or 10) - 3)})
    return {**w, "client": TidbCasSetClient(), "wrap_time": False}


def _w_monotonic(options):
    from ..workloads import monotonic
    w = monotonic.workload()
    return {**w, "client": TidbMonotonicClient()}


def _w_sequential(options):
    from ..workloads import sequential
    n_writers = max(1, int(options["concurrency"]) // 2)
    w = sequential.workload({"n_writers": n_writers})
    return {**w, "client": TidbSeqClient()}


def _w_table(options):
    box = {"created": None}
    return {"client": TidbTableClient(box=box),
            "checker": TableChecker(),
            "generator": table_generator(box)}


WORKLOADS = {
    "bank": _w_bank,
    "bank-multitable": _w_bank_multitable,
    "long-fork": _w_long_fork,
    "monotonic": _w_monotonic,
    "txn-cycle": _w_txn_cycle,
    "append": _w_append,
    "register": _w_register,
    "set": _w_set,
    "set-cas": _w_set_cas,
    "sequential": _w_sequential,
    "table": _w_table,
}

#: the workloads whose checks run kernels: the register's competition
#: race (its device lane) and the append / txn-cycle cycle search
DEVICE_WORKLOADS = ("register", "append", "txn-cycle")

# -- workload option axes (core.clj:46-120) -----------------------------------

WORKLOAD_OPTIONS = {
    "append":          {"auto_retry": [True, False],
                        "auto_retry_limit": [10, 0],
                        "read_lock": [None, "FOR UPDATE"]},
    "bank":            {"auto_retry": [True, False],
                        "auto_retry_limit": [10, 0],
                        "update_in_place": [True, False],
                        "read_lock": [None, "FOR UPDATE"]},
    "bank-multitable": {"auto_retry": [True, False],
                        "auto_retry_limit": [10, 0],
                        "update_in_place": [True, False],
                        "read_lock": [None, "FOR UPDATE"]},
    "long-fork":       {"auto_retry": [True, False],
                        "auto_retry_limit": [10, 0],
                        "use_index": [True, False]},
    "monotonic":       {"auto_retry": [True, False],
                        "auto_retry_limit": [10, 0],
                        "use_index": [True, False]},
    "register":        {"auto_retry": [True, False],
                        "auto_retry_limit": [10, 0],
                        "read_lock": [None, "FOR UPDATE"],
                        "use_index": [True, False]},
    "set":             {"auto_retry": [True, False],
                        "auto_retry_limit": [10, 0]},
    "set-cas":         {"auto_retry": [True, False],
                        "auto_retry_limit": [10, 0],
                        "read_lock": [None, "FOR UPDATE"]},
    "sequential":      {"auto_retry": [True, False],
                        "auto_retry_limit": [10, 0]},
    "txn-cycle":       {"auto_retry": [True, False],
                        "auto_retry_limit": [10, 0]},
    "table":           {},
}


def all_combos(opts: dict) -> list:
    """Combinatorial expansion of {option: [values]} into every
    possible {option: value} map (core.clj all-combos:111-122)."""
    if not opts:
        return [{}]
    keys = sorted(opts)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(opts[k] for k in keys))]


def expected_to_pass(workload_options: dict) -> dict:
    """Restrict every workload to no-auto-retry
    (core.clj workload-options-expected-to-pass:124-129)."""
    return {w: {**o, "auto_retry": [False], "auto_retry_limit": [0]}
            for w, o in workload_options.items()}


def quick_workload_options(workload_options: dict) -> dict:
    """The reference's quick subset (core.clj:131-151): defaults for
    retry axes, no read locks, no update-in-place, use-index only
    where it was an axis; redundant workloads dropped."""
    out = {}
    for w, o in workload_options.items():
        if w in ("bank", "long-fork", "monotonic", "sequential",
                 "table"):
            continue
        o = dict(o, auto_retry=["default"],
                 auto_retry_limit=["default"])
        o.pop("update_in_place", None)
        if "read_lock" in o:
            o["read_lock"] = [None]
        if "use_index" in o:
            o["use_index"] = [u for u in o["use_index"] if u]
            if not o["use_index"]:
                del o["use_index"]
        out[w] = o
    return out


NEMESES = {
    "partition": lambda db, mode: jnemesis.partition_random_halves(),
    "kill": lambda db, mode: jnemesis.node_start_stopper(
        retryclient.kill_targets(mode),
        lambda test, node: db.kill(test, node),
        lambda test, node: db.start(test, node)),
    # pause follows the same targeting: in mini mode every client is
    # pinned to the primary, so pausing anyone else faults nobody
    "pause": lambda db, mode: jnemesis.node_start_stopper(
        retryclient.kill_targets(mode),
        lambda test, node: db.pause(test, node),
        lambda test, node: db.resume(test, node)),
    "none": lambda db, mode: jnemesis.Nemesis(),
}


# -- test map -----------------------------------------------------------------

def tidb_test(options: dict) -> dict:
    """Full test map. Option axes (auto_retry, auto_retry_limit,
    read_lock, use_index, update_in_place) land in the test map where
    clients read them — exactly the reference's test-is-a-map flow
    (core.clj tidb-test:153-190). The checks of `DEVICE_WORKLOADS` run
    their kernels on `options["device"]` (default the card), resolved
    here, so that a missing card raises before any node is set up."""
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    which = options.get("workload") or "register"
    if which in DEVICE_WORKLOADS:
        options = {**options,
                   "device": resolve_device(options.get("device"))}
    try:
        w = WORKLOADS[which](options)
    except KeyError:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}") from None

    if mode == "mini":
        db: jdb.DB = MiniTidbDB()
        client = w["client"]
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, node))
        client.pin_primary = True
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                      or "tidb-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "tarball":
        db = TidbDB(options.get("version") or VERSION)
        client = w["client"]
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    nem_name = options.get("nemesis") or "kill"
    nemesis = NEMESES[nem_name](db, mode)
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
    axes = {k: options[k] for k in
            ("auto_retry", "auto_retry_limit", "read_lock",
             "use_index", "update_in_place") if k in options}
    return {
        "name": options.get("name") or f"tidb-{which}-{nem_name}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "nemesis": nemesis,
        "checker": jchecker.compose({
            which: w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": workload_gen,
        **axes,
        **extra,
        **pass_extra,
    }


def tidb_tests(options: dict):
    """test-all: workloads x option combos x nemeses. `combos`
    selects the expansion (core.clj:200-231): "quick" (default),
    "expected" (all axes, retry off), "all" (the full cross
    product), "none" (one default-axes test per workload)."""
    which = options.get("workload")
    names = [which] if which else sorted(WORKLOADS)
    sel = options.get("combos") or "quick"
    if sel == "quick":
        table = quick_workload_options(WORKLOAD_OPTIONS)
    elif sel == "expected":
        table = expected_to_pass(WORKLOAD_OPTIONS)
    elif sel == "all":
        table = WORKLOAD_OPTIONS
    elif sel == "none":
        table = {w: {} for w in WORKLOAD_OPTIONS}
    else:
        raise ValueError(f"unknown combos {sel!r}")
    nemeses = (options.get("nemesis").split(",")
               if options.get("nemesis") else ["kill"])
    for name in names:
        if which is None and sel == "quick" and name not in table:
            continue  # quick drops redundant workloads
        for combo in all_combos(table.get(name, {})):
            for nem in nemeses:
                opts = dict(options, workload=name, nemesis=nem,
                            **combo)
                axes = "-".join(
                    f"{k}={v}" for k, v in sorted(combo.items())
                    if v not in (None, "default"))
                opts["name"] = "-".join(
                    x for x in ("tidb", name, nem, axes) if x)
                yield tidb_test(opts)


TIDB_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo MySQL-wire servers) or tarball "
                 "(real pd/tikv/tidb cluster on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("nemesis", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(NEMESES))}"),
    cli.Opt("combos", metavar="SET", default="quick",
            help="test-all axis expansion: quick, expected, all, none"),
    cli.Opt("sandbox", metavar="DIR", default="tidb-cluster"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register / append / txn-cycle checks' kernels "
                 "run (default: the card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": tidb_test,
                           "opt_spec": TIDB_OPTS}),
    **cli.test_all_cmd({"tests_fn": tidb_tests,
                        "opt_spec": TIDB_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
