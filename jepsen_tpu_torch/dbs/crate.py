"""CrateDB test suite (crate/src/jepsen/crate/{core,dirty_read,
lost_updates,version_divergence}.clj).

Crate's distinguishing feature — and what all three reference
workloads probe — is its MVCC ``_version`` column: every row carries
a server-maintained version that bumps on each update and can guard
optimistic read-modify-write. This module keeps that axis central:

- ``version-divergence`` (version_divergence.clj:1-5,96-110): upsert
  writers race partitions; every ok read returns ``(value,
  _version)`` and the checker requires each (key, _version) pair to
  identify ONE value — diverged version histories are the anomaly.
- ``lost-updates`` (lost_updates.clj:1-4,58-100): a set per key grown
  by read-modify-write guarded on ``_version`` (UPDATE .. WHERE id=?
  AND _version=?; 0 rows = fail, the CAS lost). Every acked add must
  appear in the final reads.
- ``dirty-read`` (dirty_read.clj:54-123,143-193): writers insert
  sequential ids while readers chase the in-flight id; a final
  refresh + per-worker strong read partitions history into
  dirty (read but never visible) / lost (acked but never visible) /
  not-on-all (replicas disagree) sets.

The wire is the family's from-scratch pgwire v3 codec
(postgres.PgConn — crate's own client is a shaded postgresql driver,
core.clj:34-44), and the LIVE mini servers are pgwire-speaking
processes whose dialect bridge implements ``_version`` FOR REAL on
the engine side: CREATE TABLE grows a ``_version`` column defaulted
to 1, every UPDATE bumps it, upserts ride ON CONFLICT, and crate-isms
(``string`` columns, ``INDEX OFF STORAGE``, ``number_of_replicas``,
``refresh table``) are translated or absorbed. ``zip`` mode emits the
real automation (JDK + crate tarball + unicast-hosts YAML,
core.clj:120-180), command-assertion tested.

The port's copy of `jepsen_tpu/dbs/crate.py`, on the port's `postgres`.
Its own choices: the mini servers listen from `MINI_BASE_PORT` 31400
(the reference's from 27300, so that both packages' servers can run on
one host at once: `MiniServerDB` kills by `minicrate.py --port N` across
the host; below Linux's ephemeral range, 32768-60999; `zip` mode keeps
crate's `PSQL_PORT` 5432); the store root `store/torch`.
`MINICRATE_SRC` is the reference's server, byte for byte. Its checks
run on the host (`independent.checker` over host checkers) and take no
device.

    python -m jepsen_tpu_torch.dbs.crate test --nodes c1 \
        --workload lost-updates --time-limit 8
"""

from __future__ import annotations

import sys

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import generator as gen
from .. import independent
from .. import nemesis as jnemesis
from ..checker import Checker
from ..control import localexec, nodeutil
from ..history import History
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..os_setup import Debian
from . import miniserver, retryclient
from .postgres import PgError, PgRetryClientBase, tag_count

VERSION = "2.3.4"  # reference era (crate/project.clj)
PSQL_PORT = 5432
ES_PORT = 44300
MINI_BASE_PORT = 31400
DIR = "/opt/crate"


# -- the LIVE mini server (pgwire + crate dialect) ---------------------------

MINICRATE_SRC = r'''
import argparse, os, re, socketserver, sqlite3, struct

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

DB_PATH = os.path.join(args.dir, "minicrate.db")

def translate(sql):
    """The crate dialect bridge. _version is REAL: created with the
    table, bumped by every UPDATE, guardable in WHERE clauses."""
    # crate's `string` column type + storage options
    sql = re.sub(r"\bstring\b", "TEXT", sql, flags=re.I)
    sql = re.sub(r"\s+INDEX\s+OFF\s+STORAGE\s+WITH\s*\([^)]*\)", "",
                 sql, flags=re.I)
    m = re.match(r"\s*create\s+table\s+(if\s+not\s+exists\s+)?(\S+)"
                 r"\s*\((.*)\)\s*$", sql, flags=re.I | re.S)
    if m:
        return ("CREATE TABLE %s%s (%s, _version INTEGER NOT NULL "
                "DEFAULT 1)" % (m.group(1) or "", m.group(2),
                                m.group(3)))
    # upsert: mysql-flavored spelling used by version_divergence.clj
    mm = re.search(r"\son\s+duplicate\s+key\s+update\s+"
                   r"(\w+)\s*=\s*VALUES\s*\(\s*(\w+)\s*\)", sql,
                   flags=re.I)
    if mm:
        head = sql[:mm.start()]
        cm = re.search(r"insert\s+into\s+\S+\s*\(\s*"
                       r"([A-Za-z_][A-Za-z_0-9]*)", head, re.I)
        pk = cm.group(1) if cm else "id"
        return (head + " ON CONFLICT(%s) DO UPDATE SET %s=excluded.%s"
                ", _version = _version + 1"
                % (pk, mm.group(1), mm.group(2)))
    mu = re.match(r"\s*update\s+(\S+)\s+set\s+(.*?)\s+(where\s+.*)$",
                  sql, flags=re.I | re.S)
    if mu:
        return ("UPDATE %s SET %s, _version = _version + 1 %s"
                % (mu.group(1), mu.group(2), mu.group(3)))
    return sql

NOOP_RE = re.compile(r"\s*(alter\s+table\s+\S+\s+set\s*\(|"
                     r"refresh\s+table\s)", re.I)

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
        db = sqlite3.connect(DB_PATH, timeout=10,
                             check_same_thread=False)
        db.isolation_level = None
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
        if NOOP_RE.match(sql):
            self.send(b"C", b"OK\x00")
            self.send(b"Z", b"I")
            return
        if up.startswith("BEGIN"):
            sql = "BEGIN IMMEDIATE"
        else:
            sql = translate(sql)
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

print("minicrate serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Conn).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "crate_ports")


class MiniCrateDB(miniserver.MiniServerDB):
    script = "minicrate.py"
    src = MINICRATE_SRC
    pidfile = "minicrate.pid"
    logfile = "minicrate.log"
    data_files = ("minicrate.db", "minicrate.db-wal",
                  "minicrate.db-shm")

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


class CrateDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real crate automation (core.clj:120-180): jdk + tarball,
    crate.yml with the cluster's unicast hosts, daemon start with
    pidfile, ES transport port 44300 + psql 5432."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def tarball_url(self) -> str:
        return (f"https://cdn.crate.io/downloads/releases/"
                f"crate-{self.version}.tar.gz")

    @staticmethod
    def crate_yml(test: dict, node: str) -> str:
        hosts = ", ".join(f'"{n}:44300"' for n in test["nodes"])
        quorum = len(test["nodes"]) // 2 + 1
        return (f"cluster.name: crate\n"
                f"node.name: {node}\n"
                f"network.host: _site_\n"
                f"transport.tcp.port: {ES_PORT}\n"
                f"psql.port: {PSQL_PORT}\n"
                f"discovery.zen.ping.unicast.hosts: [{hosts}]\n"
                f"discovery.zen.minimum_master_nodes: {quorum}\n")

    def setup(self, test, node):
        with control.su():
            control.exec_("apt-get", "install", "-y",
                          "openjdk-8-jre-headless")
            nodeutil.install_archive(self.tarball_url(), DIR)
            nodeutil.meh(control.exec_, "adduser",
                         "--disabled-password", "--gecos", "",
                         "crate")
            # config upload needs root too: the dir is crate-owned
            nodeutil.write_file(self.crate_yml(test, node),
                                f"{DIR}/config/crate.yml")
            control.exec_("chown", "-R", "crate:crate", DIR)
        self.start(test, node)
        nodeutil.await_tcp_port(PSQL_PORT, timeout_s=120)

    def teardown(self, test, node):
        with control.su():
            nodeutil.meh(nodeutil.grepkill,
                         "io.crate.bootstrap.CrateDB")
            control.exec_("rm", "-rf", control.lit(f"{DIR}/data/*"),
                          f"{DIR}/logs/stdout.log")

    def start(self, test, node):
        with control.sudo_user("crate"):
            nodeutil.start_daemon(
                {"logfile": f"{DIR}/logs/stdout.log",
                 "pidfile": "/tmp/crate.pid", "chdir": DIR},
                "bin/crate")
        return "started"

    def kill(self, test, node):
        # root: the daemon runs as user crate
        with control.su():
            nodeutil.meh(nodeutil.grepkill,
                         "io.crate.bootstrap.CrateDB")
        return "killed"

    def log_files(self, test, node):
        return [f"{DIR}/logs/stdout.log"]


# -- clients ----------------------------------------------------------------

class _CrateBase(PgRetryClientBase):
    """Pg plumbing + the shared connect-retry window."""


class VersionDivergenceClient(_CrateBase):
    """version_divergence.clj:30-92: upsert writers, (value,
    _version) readers over independent keys."""

    def setup(self, test):
        conn = self._conn(test)
        conn.query("create table if not exists registers ("
                   "id integer primary key, value integer)")
        conn.query('alter table registers set '
                   '(number_of_replicas = "0-all")')

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, v = kv
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                rows, _ = conn.query(
                    f"select value, _version from registers "
                    f"where id = {int(k)}")
                val = ([int(rows[0][0]), int(rows[0][1])]
                       if rows else None)
                return {**op, "type": "ok", "value": tuple_(k, val)}
            if f == "write":
                conn.query(
                    f"insert into registers (id, value) values "
                    f"({int(k)}, {int(v)}) on duplicate key update "
                    f"value = VALUES(value)")
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, PgError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class MultiVersionChecker(Checker):
    """version_divergence.clj:96-110: within one key, every _version
    must identify a single value."""

    def check(self, test, history: History, opts=None):
        # runs under independent.checker: values arrive unwrapped,
        # one key per subhistory (independent.clj:266-317 discipline)
        by_version: dict = {}
        for op in history:
            if op.is_ok and op.f == "read" and op.value is not None:
                val, ver = op.value
                by_version.setdefault(ver, set()).add(val)
        multis = {f"v{ver}": sorted(vals)
                  for ver, vals in by_version.items()
                  if len(vals) > 1}
        return {"valid?": not multis, "multis": multis}


class LostUpdatesClient(_CrateBase):
    """lost_updates.clj:31-100: per-key integer sets grown by
    _version-guarded read-modify-write."""

    def setup(self, test):
        conn = self._conn(test)
        conn.query("create table if not exists sets ("
                   "id integer primary key, elements string "
                   "INDEX OFF STORAGE WITH (columnstore = false))")
        conn.query('alter table sets set '
                   '(number_of_replicas = "0-all")')

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, v = kv
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                rows, _ = conn.query(
                    f"select elements from sets where id = {int(k)}")
                els = (sorted(int(x) for x in rows[0][0].split(","))
                       if rows and rows[0][0] else [])
                return {**op, "type": "ok", "value": tuple_(k, els)}
            if f == "add":
                rows, _ = conn.query(
                    f"select elements, _version from sets "
                    f"where id = {int(k)}")
                if rows:
                    els = ([int(x) for x in rows[0][0].split(",")]
                           if rows[0][0] else [])
                    ver = int(rows[0][1])
                    els2 = ",".join(str(x) for x in els + [int(v)])
                    _, tag = conn.query(
                        f"update sets set elements = '{els2}' "
                        f"where id = {int(k)} and _version = {ver}")
                    if tag_count(tag) == 0:
                        return {**op, "type": "fail",
                                "error": "version conflict"}
                    return {**op, "type": "ok"}
                try:
                    conn.query(
                        f"insert into sets (id, elements) values "
                        f"({int(k)}, '{int(v)}')")
                except PgError as e:
                    if "UNIQUE" in str(e):
                        # another worker won the first-insert race:
                        # this add did not apply — a clean CAS loss
                        return {**op, "type": "fail",
                                "error": "insert race lost"}
                    raise
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, PgError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class LostUpdatesChecker(Checker):
    """Every acked add must appear in the key's final ok read
    (lost_updates.clj:1-4)."""

    def check(self, test, history: History, opts=None):
        # runs under independent.checker: values arrive unwrapped
        acked = set()
        final = None
        for op in history:
            if op.is_ok and op.f == "add":
                acked.add(op.value)
            if op.is_ok and op.f == "read":
                final = set(op.value or [])
        if final is None:
            # the time limit cut this key before its read phase:
            # nothing to falsify (vacuous, recorded for the report)
            return {"valid?": True, "no-final-read": True,
                    "add-count": len(acked)}
        lost = sorted(acked - final)
        return {"valid?": not lost, "lost": lost[:32],
                "lost-count": len(lost), "add-count": len(acked)}


class DirtyReadClient(_CrateBase):
    """dirty_read.clj:31-123: id probes, sequential-id writers,
    refresh + strong reads."""

    def setup(self, test):
        conn = self._conn(test)
        conn.query("create table if not exists dirty_read ("
                   "id integer primary key)")
        conn.query('alter table dirty_read set '
                   '(number_of_replicas = "0-all")')

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                if op["value"] is None or int(op["value"]) < 0:
                    return {**op, "type": "fail",
                            "error": "nothing in flight"}
                rows, _ = conn.query(
                    f"select id from dirty_read where "
                    f"id = {int(op['value'])}")
                return {**op, "type": "ok" if rows else "fail"}
            if f == "refresh":
                conn.query("refresh table dirty_read")
                return {**op, "type": "ok"}
            if f == "strong-read":
                rows, _ = conn.query("select id from dirty_read")
                return {**op, "type": "ok",
                        "value": sorted(int(r[0]) for r in rows)}
            if f == "write":
                conn.query(f"insert into dirty_read (id) values "
                           f"({int(op['value'])})")
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, PgError) as e:
            self._drop()
            t = "fail" if f in ("read", "strong-read") else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class DirtyReadChecker(Checker):
    """dirty_read.clj:143-193: dirty = ok reads never visible in any
    strong read; lost = acked writes visible in none; replicas must
    agree (on-all == on-some)."""

    def check(self, test, history: History, opts=None):
        writes, reads, strong = set(), set(), []
        for op in history:
            if not op.is_ok:
                continue
            if op.f == "write":
                writes.add(op.value)
            elif op.f == "read":
                reads.add(op.value)
            elif op.f == "strong-read":
                strong.append(set(op.value))
        if not strong:
            return {"valid?": "unknown",
                    "error": "no strong reads"}
        on_all = set.intersection(*strong)
        on_some = set.union(*strong)
        dirty = reads - on_some
        lost = writes - on_some
        nodes_agree = on_all == on_some
        return {"valid?": bool(nodes_agree and not dirty
                               and not lost),
                "nodes-agree?": nodes_agree,
                "strong-read-count": len(strong),
                "read-count": len(reads),
                "on-all-count": len(on_all),
                "on-some-count": len(on_some),
                "not-on-all": sorted(on_some - on_all)[:32],
                "dirty": sorted(dirty)[:32],
                "dirty-count": len(dirty),
                "lost": sorted(lost)[:32],
                "lost-count": len(lost)}


# -- workloads ---------------------------------------------------------------

def _keyed_generator(options, fgen):
    n = max(1, int(options["concurrency"]) // 2)
    keys = iter(range(10 ** 9))
    return independent.concurrent_generator(n, keys, fgen)


def _w_version_divergence(options):
    counter = iter(range(10 ** 9))

    def fgen(k):
        def write(test, ctx):
            return {"f": "write", "value": next(counter)}

        return gen.limit(
            options.get("per_key_limit") or 40,
            gen.mix([write,
                     gen.repeat({"f": "read", "value": None})]))

    return {"client": VersionDivergenceClient(),
            "checker": independent.checker(MultiVersionChecker()),
            "generator": _keyed_generator(options, fgen)}


def _w_lost_updates(options):
    counter = iter(range(10 ** 9))

    def fgen(k):
        def add(test, ctx):
            return {"f": "add", "value": next(counter)}

        return gen.phases(
            gen.limit(options.get("per_key_limit") or 40,
                      add),
            gen.once(lambda test, ctx: {"f": "read", "value": None}))

    return {"client": LostUpdatesClient(),
            "checker": independent.checker(LostUpdatesChecker()),
            "generator": _keyed_generator(options, fgen)}


def _w_dirty_read(options):
    state = {"next": 0, "in_flight": -1}

    def write(test, ctx):
        v = state["next"]
        state["next"] += 1
        state["in_flight"] = v
        return {"f": "write", "value": v}

    def read(test, ctx):
        return {"f": "read", "value": state["in_flight"]}

    return {
        "client": DirtyReadClient(),
        "checker": DirtyReadChecker(),
        # main phase: writers chase readers; final phase: refresh,
        # then one strong read on EVERY worker (dirty_read.clj:196+)
        "generator": gen.phases(
            gen.time_limit(
                max(1.0, (options.get("time_limit") or 10) - 3),
                gen.clients(gen.mix([write, read, read]))),
            gen.clients(gen.once(
                lambda test, ctx: {"f": "refresh", "value": None})),
            gen.clients(gen.each_thread(gen.once(
                lambda test, ctx: {"f": "strong-read",
                                   "value": None})))),
        "wrap_time": False,
    }


WORKLOADS = {"version-divergence": _w_version_divergence,
             "lost-updates": _w_lost_updates,
             "dirty-read": _w_dirty_read}


def crate_test(options: dict) -> dict:
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    which = options.get("workload") or "version-divergence"
    try:
        w = WORKLOADS[which](options)
    except KeyError:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}") from None

    client = w["client"]
    if mode == "mini":
        db: jdb.DB = MiniCrateDB()
        client.addr_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, test["nodes"][0]))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "crate-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "zip":
        db = CrateDB(options.get("version") or VERSION)
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    interval = options.get("nemesis_interval") or 3.0
    time_limit = options.get("time_limit") or 10
    nemesis = jnemesis.node_start_stopper(
        lambda ns: [ns[0]],
        lambda test, node: db.kill(test, node),
        lambda test, node: db.start(test, node))
    workload_gen = retryclient.standard_generator(
        w, nemesis, interval, time_limit)
    return {
        "name": options.get("name") or f"crate-{which}-{mode}",
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
    }


def crate_tests(options: dict):
    which = options.get("workload")
    for name in ([which] if which else sorted(WORKLOADS)):
        opts = dict(options, workload=name)
        opts["name"] = f"{options.get('name') or 'crate'}-{name}"
        yield crate_test(opts)


CRATE_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo pgwire servers) or zip (real "
                 "crate tarball on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("per_key_limit", metavar="N", default=40, parse=int),
    cli.Opt("sandbox", metavar="DIR", default="crate-cluster"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": crate_test,
                           "opt_spec": CRATE_OPTS}),
    **cli.test_all_cmd({"tests_fn": crate_tests,
                        "opt_spec": CRATE_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
