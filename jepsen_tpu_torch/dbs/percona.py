"""Percona XtraDB test suite (percona/src/jepsen/percona.clj,
percona/dirty_reads.clj).

Where the galera suite is the MySQL-*replication* exemplar, percona's
suite is the MySQL-*transaction* exemplar: its bank client sweeps two
option axes the galera bank has none of —

- ``lock_type`` (percona.clj:252-270): the row-read locking clause
  appended to every SELECT inside the transfer txn. ``none`` (plain
  snapshot reads — the configuration under which percona famously
  loses conserved totals), ``update`` (SELECT .. FOR UPDATE) and
  ``share`` (LOCK IN SHARE MODE).
- ``in_place`` (percona.clj:279-285): apply transfers as relative
  ``UPDATE .. SET balance = balance - ?`` (in-place) vs writing back
  absolute balances computed from the txn's own reads
  (read-modify-write — the shape that needs the row locks).

Deadlock-abort retries replicate with-txn-retries
(percona.clj:166-173): ER_LOCK_DEADLOCK (1213) aborts are retried
within the op's 5 s budget, then surfaced as info.

The wire is the SAME from-scratch MySQL codec as galera
(``galera.MySqlConn``) — one protocol implementation for the whole
MySQL family, like the reference's shared mariadb-jdbc driver. The
``dirty-reads`` workload (percona/dirty_reads.clj:69-97) is imported
from galera, which credits it to percona in its docstring.

Server modes: ``mini`` (default) LIVE in-repo MySQL-wire servers;
``deb`` emits the real percona-xtradb-cluster recipe with the
reference's debconf preseeds, stock-datadir squirrel/restore
(percona.clj:52-71), and gcomm:// bootstrap address algebra
(percona.clj:73-78: the primary bootstraps with an EMPTY gcomm://).

The port's copy of `jepsen_tpu/dbs/percona.py`, on the port's `galera`.
Its own choices: the mini servers listen from `MINI_BASE_PORT` 31150
(the reference's from 25900, so that both packages' servers can run on
one host at once; below Linux's ephemeral range, 32768-60999; `deb` mode
keeps MySQL's `PORT` 3306); the store root `store/torch`. The bank and
dirty-reads checks run on the host and take no device.

    python -m jepsen_tpu_torch.dbs.percona test --nodes p1 --workload bank \
        --lock-type update --time-limit 8
"""

from __future__ import annotations

import sys
import time

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import nemesis as jnemesis
from .. import net as jnet
from ..control import localexec, nodeutil
from ..ledger import BASE_DIR
from ..os_setup import Debian
from . import retryclient
from .galera import (MySqlError, MiniGaleraDB, _GaleraBase, _w_dirty)

VERSION = "5.6.25-25.12"
PORT = 3306
MINI_BASE_PORT = 31150
DIR = "/var/lib/mysql"
STOCK_DIR = "/var/lib/mysql-stock"
ER_LOCK_DEADLOCK = 1213

LOCK_CLAUSES = {"none": "", "update": " FOR UPDATE",
                "share": " LOCK IN SHARE MODE"}

LOG_FILES = ["/var/log/syslog", "/var/log/mysql.log",
             "/var/log/mysql.err", "/var/lib/mysql/queries.log"]

DEBCONF_PRESEEDS = [
    "percona-xtradb-cluster-56 mysql-server/root_password password jepsen",
    "percona-xtradb-cluster-56 mysql-server/root_password_again password jepsen",
    "percona-xtradb-cluster-56 mysql-server-5.1/start_on_boot boolean false",
    "percona-xtradb-cluster-server-5.6 percona-xtradb-cluster-server/"
    "root_password_again password jepsen",
    "percona-xtradb-cluster-server-5.6 percona-xtradb-cluster-server/"
    "root_password password jepsen",
]


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "percona_ports")


class MiniPerconaDB(MiniGaleraDB):
    """Same live MySQL-wire server, percona's own port block."""

    def port(self, test, node):
        return mini_node_port(test, node)


class PerconaDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real percona-xtradb-cluster automation (percona.clj:34-147):
    debconf preseeds, stock-datadir backup after first install,
    cluster-address config, primary bootstrap-pxc, jepsen grants."""

    def __init__(self, version: str = VERSION):
        self.version = version

    @staticmethod
    def cluster_address(test: dict, node: str) -> str:
        """percona.clj:73-78 — the primary bootstraps a NEW cluster
        with an empty gcomm://; everyone else joins the full list."""
        if node == test["nodes"][0]:
            return "gcomm://"
        return "gcomm://" + ",".join(test["nodes"])

    @staticmethod
    def jepsen_cnf(test: dict, node: str) -> str:
        return ("[mysqld]\n"
                "wsrep_provider=/usr/lib/libgalera_smm.so\n"
                f"wsrep_cluster_address="
                f"{PerconaDB.cluster_address(test, node)}\n"
                "wsrep_sst_method=rsync\n"
                "binlog_format=ROW\n"
                "innodb_autoinc_lock_mode=2\n"
                "general_log=1\n"
                "general_log_file=/var/lib/mysql/queries.log\n")

    def setup(self, test, node):
        primary = test["nodes"][0]
        with control.su():
            for line in DEBCONF_PRESEEDS:
                control.exec_("echo", line, control.lit("|"),
                              "debconf-set-selections")
            control.exec_("rm", "-rf",
                          "/etc/mysql/conf.d/jepsen.cnf", DIR)
            control.exec_("apt-get", "install", "-y", "rsync",
                          f"percona-xtradb-cluster-56={self.version}")
            control.exec_("service", "mysql", "stop")
            # squirrel away pristine data files (percona.clj:69-71)
            control.exec_("rm", "-rf", STOCK_DIR)
            control.exec_("cp", "-rp", DIR, STOCK_DIR)
            nodeutil.write_file(self.jepsen_cnf(test, node),
                                "/etc/mysql/conf.d/jepsen.cnf")
            if node == primary:
                control.exec_("service", "mysql", "start",
                              "bootstrap-pxc")
            else:
                control.exec_("service", "mysql", "start")
            for sql in ("create database if not exists jepsen;",
                        "GRANT ALL PRIVILEGES ON jepsen.* TO "
                        "'jepsen'@'%' IDENTIFIED BY 'jepsen';"):
                control.exec_("mysql", "-u", "root",
                              "--password=jepsen", "-e", sql)

    def teardown(self, test, node):
        with control.su():
            nodeutil.meh(nodeutil.grepkill, "mysqld")
            control.exec_("truncate", "-c", "--size", "0", *LOG_FILES)
            control.exec_("rm", "-rf", DIR)
            control.exec_("cp", "-rp", STOCK_DIR, DIR)

    def start(self, test, node):
        with control.su():
            control.exec_("service", "mysql", "start")
        return "started"

    def kill(self, test, node):
        with control.su():
            nodeutil.grepkill("mysqld")
        return "killed"

    def log_files(self, test, node):
        return LOG_FILES


class PerconaBankClient(_GaleraBase):
    """Bank transfers with the lock_type / in_place axes
    (percona.clj:231-293) and deadlock-abort retries
    (percona.clj:166-173)."""

    def __init__(self, port_fn=None, timeout: float = 5.0,
                 pin_primary: bool = False,
                 lock_type: str = "update", in_place: bool = False):
        super().__init__(port_fn, timeout, pin_primary)
        if lock_type not in LOCK_CLAUSES:
            raise ValueError(f"lock_type {lock_type!r} not in "
                             f"{sorted(LOCK_CLAUSES)}")
        self.lock_type = lock_type
        self.in_place = in_place

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout, self.pin_primary,
                       self.lock_type, self.in_place)
        c.node = node
        return c

    def setup(self, test):
        conn = self._conn(test)
        conn.query("CREATE TABLE IF NOT EXISTS accounts "
                   "(id INTEGER PRIMARY KEY, balance BIGINT NOT NULL)")
        accounts = test["accounts"]
        total = test["total-amount"]
        per, rem = divmod(total, len(accounts))
        for i, a in enumerate(accounts):
            bal = per + (1 if i < rem else 0)
            try:
                conn.query(f"INSERT INTO accounts VALUES ({a}, {bal})")
            except MySqlError:
                pass  # setup races are idempotent

    def _read_all(self, conn) -> dict:
        lock = LOCK_CLAUSES[self.lock_type]
        rows, _ = conn.query(
            f"SELECT id, balance FROM accounts{lock}")
        return {int(r[0]): int(r[1]) for r in rows}

    def _transfer_once(self, conn, src, dst, amt) -> str:
        """One attempt: 'ok', 'fail', or raises MySqlError."""
        lock = LOCK_CLAUSES[self.lock_type]
        try:
            conn.query("START TRANSACTION")
            rows, _ = conn.query(
                f"SELECT balance FROM accounts WHERE id={src}{lock}")
            b1 = (int(rows[0][0]) if rows else 0) - amt
            rows, _ = conn.query(
                f"SELECT balance FROM accounts WHERE id={dst}{lock}")
            b2 = (int(rows[0][0]) if rows else 0) + amt
            if b1 < 0 or b2 < 0:
                conn.query("ROLLBACK")
                return "fail"
            if self.in_place:
                conn.query(f"UPDATE accounts SET balance = balance - "
                           f"{amt} WHERE id = {src}")
                conn.query(f"UPDATE accounts SET balance = balance + "
                           f"{amt} WHERE id = {dst}")
            else:
                conn.query(f"UPDATE accounts SET balance = {b1} "
                           f"WHERE id = {src}")
                conn.query(f"UPDATE accounts SET balance = {b2} "
                           f"WHERE id = {dst}")
            conn.query("COMMIT")
            return "ok"
        except MySqlError:
            try:
                conn.query("ROLLBACK")
            except (OSError, MySqlError):
                self._drop()
            raise

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                return {**op, "type": "ok",
                        "value": self._read_all(conn)}
            if f == "transfer":
                t = op["value"]
                deadline = time.monotonic() + self.timeout
                while True:
                    try:
                        verdict = self._transfer_once(
                            conn, t["from"], t["to"], t["amount"])
                        return {**op, "type": verdict}
                    except MySqlError as e:
                        # with-txn-retries: deadlock aborts left the
                        # db unchanged — safe to retry within budget
                        # (briefly backed off: the mini server tags
                        # every engine error 1213, so a persistent
                        # error must not hot-loop the wire)
                        if (e.code != ER_LOCK_DEADLOCK
                                or time.monotonic() >= deadline):
                            raise
                        time.sleep(0.05)
                        conn = self._conn(test)
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, MySqlError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


# -- test map ---------------------------------------------------------------

def _w_bank(options):
    from ..workloads import bank
    w = bank.workload(options)
    return {**w, "client": PerconaBankClient(
        lock_type=options.get("lock_type") or "update",
        in_place=bool(options.get("in_place")))}


WORKLOADS = {"bank": _w_bank, "dirty-reads": _w_dirty}


def percona_test(options: dict) -> dict:
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    which = options.get("workload") or "bank"
    try:
        w = WORKLOADS[which](options)
    except KeyError:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}") from None

    client = w["client"]
    if mode == "mini":
        db: jdb.DB = MiniPerconaDB()
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, node))
        client.pin_primary = True
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "percona-cluster"),
            "ssh": {"dummy?": False},
        }
        nemesis = jnemesis.node_start_stopper(
            lambda ns: [ns[0]],
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node))
    elif mode == "deb":
        db = PerconaDB(options.get("version") or VERSION)
        # Partitioner.setup heals test["net"], so the deb run carries
        # the iptables Net implementation (nemesis/__init__.py).
        extra = {"ssh": options.get("ssh") or {}, "os": Debian(),
                 "net": jnet.iptables()}
        # percona.clj:212 — the suite nemesis is partition-random-
        # halves, not a killer: the anomalies are replication-level
        nemesis = jnemesis.partition_random_halves()
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    interval = options.get("nemesis_interval") or 3.0
    time_limit = options.get("time_limit") or 10
    # percona.clj:215-229 with-nemesis = the suites' shared shape
    workload_gen = retryclient.standard_generator(
        w, nemesis, interval, time_limit)
    pass_extra = {k: v for k, v in w.items()
                  if k not in ("checker", "generator", "client",
                               "wrap_time")}
    lock = options.get("lock_type") or "update"
    in_place = bool(options.get("in_place"))
    return {
        "name": options.get("name")
                or f"percona-{which}-{lock}"
                   f"{'-inplace' if in_place else ''}-{mode}",
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
        **extra,
        **pass_extra,
    }


def percona_tests(options: dict):
    """Sweep the bank's lock/in-place axes plus dirty-reads
    (percona.clj bank-test permutations)."""
    which = options.get("workload")
    combos = ([(which, options.get("lock_type"),
                options.get("in_place"))] if which else
              [("bank", "none", False), ("bank", "update", False),
               ("bank", "update", True), ("bank", "share", False),
               ("dirty-reads", None, None)])
    for name, lock, in_place in combos:
        opts = dict(options, workload=name)
        if lock is not None:
            opts["lock_type"] = lock
        if in_place is not None:
            opts["in_place"] = in_place
        tag = name if lock is None else f"{name}-{lock}" + (
            "-inplace" if in_place else "")
        opts["name"] = f"{options.get('name') or 'percona'}-{tag}"
        yield percona_test(opts)


PERCONA_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo MySQL-wire servers) or deb "
                 "(real percona-xtradb cluster on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("lock_type", metavar="LOCK", default="update",
            help=f"row-lock clause: {', '.join(sorted(LOCK_CLAUSES))}"),
    cli.Opt("in_place", metavar="BOOL", default=False,
            parse=lambda s: s in ("1", "true", "yes")),
    cli.Opt("sandbox", metavar="DIR", default="percona-cluster"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": percona_test,
                           "opt_spec": PERCONA_OPTS}),
    **cli.test_all_cmd({"tests_fn": percona_tests,
                        "opt_spec": PERCONA_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
