"""CockroachDB-style test suite — the strict-serializability workloads
(cockroachdb/src/jepsen/cockroach/{monotonic,comments}.clj) over this
package's from-scratch pgwire v3 client (dbs/postgres.py).

Two workloads, two custom checkers:

- **monotonic** (monotonic.clj): each `add` runs ONE serializable txn
  that reads the current max value and inserts max+1 together with a
  DB-side timestamp. If timestamps are meaningful (cockroach's HLC),
  sorting the final read by timestamp must yield strictly increasing
  values; the checker also catches duplicates and lost acknowledged
  adds (check-monotonic: off-order-stss with <=, off-order-vals
  with <, :lost/:duplicates sets).
- **comments** (comments.clj): concurrent blind inserts across N
  tables (ids hashed across tables to cross shard ranges) racing
  transactional multi-table reads. Replay the history tracking which
  writes had COMPLETED before each write w was invoked; a read that
  observes w but misses some earlier-completed w' exhibits the
  T1 < T2-but-only-T2-visible anomaly — the strict serializability
  violation cockroach's comments workload was built to catch.

``server=mini`` (default) runs LIVE in-repo pgwire servers (the
stolon family's WAL + full-fsync sqlite engines) under a kill
nemesis, so both strict-serializability checkers hold across crash
recovery in CI; ``--addr`` targets any external pgwire endpoint. The
DB-side timestamp expression is configurable: the default
`strftime('%Y-%m-%d %H:%M:%f','now')` suits the sqlite engines; a
real postgres/cockroach endpoint passes e.g. ``now()::text`` /
``cluster_logical_timestamp()``.

The port's copy of `jepsen_tpu/dbs/cockroach.py`, on the port's
`postgres` and (lazily) `stolon`'s mini server. Its own choices: the
mini servers listen from `MINI_BASE_PORT` 31350 (the reference's from
28600, so that both packages' servers can run on one host at once; a
block of its own beside stolon's 31300, since both run `minipg.py` and
`MiniServerDB` kills by `minipg.py --port N`; below Linux's ephemeral
range, 32768-60999); the store root `store/torch`. Both checks run on
the host and take no device.

    python -m jepsen_tpu_torch.dbs.cockroach test --nodes c1 \
        --workload comments --time-limit 6
"""

from __future__ import annotations

import sys
from typing import Optional

from .. import checker as jchecker
from .. import cli, db as jdb, generator as gen
from .. import nemesis as jnemesis
from ..control import localexec
from ..history import History
from ..ledger import BASE_DIR
from . import retryclient
from .postgres import (BEGIN_SQL, PgError, PgRetryClientBase,
                       tag_count)

MINI_BASE_PORT = 31350

#: Pg plumbing + the shared connect-retry window (one copy of the
#: retrying base lives in postgres.py)
_CrdbBase = PgRetryClientBase


class _ExternalEndpoint(jdb.DB):
    """postgres-rds deployment model: the endpoint already exists and
    each workload's client creates its own schema in setup."""

    def setup(self, test, node):
        pass

    def teardown(self, test, node):
        pass


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "crdb_ports")


def _mini_db():
    """LIVE pgwire mini servers — the stolon family's WAL-backed
    sqlite engine behind the shared pgwire codec, cockroach's own
    port block."""
    from .stolon import MiniStolonDB

    class MiniCrdbDB(MiniStolonDB):
        def port(self, test, node):
            return mini_node_port(test, node)

    return MiniCrdbDB()

TABLE = "mono"
COMMENT_TABLES = 3
SQLITE_TS = "strftime('%Y-%m-%d %H:%M:%f','now')"


# -- monotonic --------------------------------------------------------------

class MonotonicClient(_CrdbBase):
    """add = one serializable txn: SELECT max(val) -> INSERT max+1
    with a DB timestamp (monotonic.clj:100-125); read = full scan
    ordered by (sts, val) — sts ties (ms clock) are broken by val so
    equal-timestamp neighbors can't flag falsely."""

    def __init__(self, addr_fn=None, user: str = "jepsen",
                 database: str = "jepsen", timeout: float = 5.0,
                 ts_sql: str = SQLITE_TS):
        # positional prefix must match PgClientBase (its open()
        # reconstructs clients positionally)
        super().__init__(addr_fn, user, database, timeout)
        self.ts_sql = ts_sql

    def open(self, test, node):
        c = super().open(test, node)
        c.ts_sql = self.ts_sql
        return c

    def setup(self, test):
        conn = self._conn(test)
        conn.query(f"CREATE TABLE IF NOT EXISTS {TABLE} "
                   "(val INT, sts TEXT, node TEXT, process INT)")

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "add":
                try:
                    conn.query(BEGIN_SQL)
                    rows, _ = conn.query(
                        f"SELECT COALESCE(MAX(val), -1) FROM {TABLE}")
                    cur_max = int(rows[0][0])
                    sts = conn.query(
                        f"SELECT {self.ts_sql}")[0][0][0]
                    conn.query(
                        f"INSERT INTO {TABLE} VALUES ({cur_max + 1}, "
                        f"'{sts}', '{self.node}', {op['process']})")
                    conn.query("COMMIT")
                except PgError as e:
                    # a txn the server rejected (serialization/lock
                    # conflict) definitely didn't commit: :fail, the
                    # reference's with-txn-retry-as-fail discipline
                    try:
                        conn.query("ROLLBACK")
                    except (OSError, PgError):
                        self._drop()
                    return {**op, "type": "fail",
                            "error": str(e)[:200]}
                return {**op, "type": "ok",
                        "value": {"val": cur_max + 1, "sts": sts,
                                  "node": self.node,
                                  "process": op["process"]}}
            if f == "read":
                rows, _ = conn.query(
                    f"SELECT val, sts, node, process FROM {TABLE} "
                    "ORDER BY sts, val")
                return {**op, "type": "ok",
                        "value": [{"val": int(r[0]), "sts": r[1],
                                   "node": r[2], "process": int(r[3])}
                                  for r in rows]}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, PgError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


def non_monotonic(cmp_ok, key, rows) -> list:
    """Successive pairs where cmp_ok(x[key], x'[key]) fails
    (monotonic.clj non-monotonic)."""
    return [[a, b] for a, b in zip(rows, rows[1:])
            if not cmp_ok(a[key], b[key])]


class MonotonicChecker(jchecker.Checker):
    """check-monotonic (monotonic.clj:166-250): on the LAST ok read,
    sts must be non-decreasing, val strictly increasing in sts order,
    no duplicate vals, and every acknowledged add present."""

    def check(self, test, history: History, opts=None):
        # NB: indeterminate (:info) adds carry no value — this client
        # learns its val only on ok — so unlike monotonic.clj's
        # recovered/fail-value sets, they cannot enter loss accounting
        # here; extra rows from them are legal and unflagged.
        final = None
        acked = []
        for op in history:
            if op.f == "add" and op.is_ok:
                acked.append(op.value["val"])
            elif op.f == "read" and op.is_ok:
                final = op.value
        if final is None:
            return {"valid?": "unknown", "error": "set was never read"}
        from collections import Counter
        vals = [r["val"] for r in final]
        seen = set(vals)
        dups = sorted(v for v, n in Counter(vals).items() if n > 1)
        lost = sorted(v for v in acked if v not in seen)
        off_sts = non_monotonic(lambda a, b: a <= b, "sts", final)
        off_val = non_monotonic(lambda a, b: a < b, "val", final)
        valid = not (dups or lost or off_sts or off_val)
        return {"valid?": valid,
                "add-count": len(acked),
                "read-count": len(final),
                "off-order-sts": off_sts[:8],
                "off-order-val": off_val[:8],
                "duplicates": dups[:8],
                "lost": lost[:8]}


# -- comments ---------------------------------------------------------------

def id_table(i: int) -> str:
    return f"comment_{i % COMMENT_TABLES}"


class CommentsClient(_CrdbBase):
    """Blind single-row inserts across N tables + transactional
    multi-table reads (comments.clj:44-82)."""

    def setup(self, test):
        conn = self._conn(test)
        for i in range(COMMENT_TABLES):
            conn.query(f"CREATE TABLE IF NOT EXISTS comment_{i} "
                       "(id INT PRIMARY KEY)")

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "write":
                i = int(op["value"])
                _, tag = conn.query(
                    f"INSERT INTO {id_table(i)} VALUES ({i})")
                if tag_count(tag) != 1:
                    return {**op, "type": "fail", "error": tag}
                return {**op, "type": "ok"}
            if f == "read":
                try:
                    conn.query(BEGIN_SQL)
                    seen: list = []
                    for i in range(COMMENT_TABLES):
                        rows, _ = conn.query(
                            f"SELECT id FROM comment_{i}")
                        seen.extend(int(r[0]) for r in rows)
                    conn.query("COMMIT")
                except PgError as e:
                    try:
                        conn.query("ROLLBACK")
                    except (OSError, PgError):
                        self._drop()
                    return {**op, "type": "fail",
                            "error": str(e)[:200]}
                return {**op, "type": "ok", "value": sorted(seen)}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, PgError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class CommentsChecker(jchecker.Checker):
    """comments.clj checker: expected[w] = writes COMPLETED before w's
    invocation; every ok read observing w must observe all of
    expected[w] — a miss is a strict-serializability violation."""

    def check(self, test, history: History, opts=None):
        completed: set = set()
        expected: dict = {}
        errors = []
        for op in history:
            if op.f == "write":
                if op.is_invoke:
                    expected[op.value] = set(completed)
                elif op.is_ok:
                    completed.add(op.value)
            elif op.f == "read" and op.is_ok:
                seen = set(op.value)
                must = set()
                for w in seen:
                    must |= expected.get(w, set())
                missing = must - seen
                if missing:
                    errors.append({"index": op.index,
                                   "missing": sorted(missing)[:16],
                                   "expected-count": len(must)})
        return {"valid?": not errors,
                "write-count": len(completed),
                "error-count": len(errors),
                "errors": errors[:8]}


# -- workloads / test map ---------------------------------------------------

def _w_monotonic(options):
    def add(test, ctx):
        return {"f": "add", "value": None}

    final = gen.clients(gen.each_thread(gen.once(
        lambda test, ctx: {"f": "read", "value": None})))
    return {
        "client": MonotonicClient(
            ts_sql=options.get("ts_sql") or SQLITE_TS),
        "checker": MonotonicChecker(),
        "generator": gen.phases(
            gen.time_limit(max(1.0, (options.get("time_limit") or 10)
                               - 2),
                           gen.clients(gen.stagger(0.01, add))),
            final),
    }


def _w_comments(options):
    counter = iter(range(10**9))

    def write(test, ctx):
        return {"f": "write", "value": next(counter)}

    return {
        "client": CommentsClient(),
        "checker": CommentsChecker(),
        "generator": gen.time_limit(
            options.get("time_limit") or 10,
            gen.clients(gen.mix(
                [gen.stagger(0.01, write),
                 gen.stagger(0.05,
                             gen.repeat({"f": "read",
                                         "value": None}))]))),
    }


WORKLOADS = {"monotonic": _w_monotonic, "comments": _w_comments}


def cockroach_test(options: dict) -> dict:
    """``server=mini`` (default): LIVE in-repo pgwire servers under a
    kill/restart nemesis. ``--addr host:port`` switches to the
    external-endpoint deployment model (the DB lifecycle is NOT
    managed — point it at a real cockroach / postgres / stub)."""
    which = options.get("workload") or "monotonic"
    try:
        w = WORKLOADS[which](options)
    except KeyError:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}") from None
    client = w["client"]
    mode = options.get("server") or "mini"
    workload_gen = w["generator"]
    if options.get("addr"):
        # explicit endpoint wins: the external deployment model
        host, port = options["addr"].rsplit(":", 1)
        client.addr_fn = lambda test, node: (host, int(port))
        mode = "external"
    if mode == "mini":
        db: jdb.DB = _mini_db()
        client.addr_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, test["nodes"][0]))
        nemesis = jnemesis.node_start_stopper(
            retryclient.kill_targets("mini"),
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "crdb-cluster"),
            "ssh": {"dummy?": False},
            "nemesis": nemesis,
        }
        # both workloads manage their own phases/limits, so the
        # shared shape runs them unwrapped with a self-bounding fault
        # stream that stops before monotonic's final reads
        workload_gen = retryclient.standard_generator(
            {**w, "wrap_time": False}, nemesis,
            options.get("nemesis_interval") or 3.0,
            options.get("time_limit") or 10)
    elif mode == "external":
        db = _ExternalEndpoint()
        extra = {"ssh": {"dummy?": True}}
    else:
        raise ValueError(f"unknown server mode {mode!r}")
    return {
        "name": options.get("name") or f"cockroach-{which}-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": options["nodes"],
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "checker": jchecker.compose({
            which: w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": workload_gen,
        **extra,
    }


def cockroach_tests(options: dict):
    which = options.get("workload")
    for name in ([which] if which else sorted(WORKLOADS)):
        opts = dict(options, workload=name)
        opts["name"] = f"{options.get('name') or 'cockroach'}-{name}"
        yield cockroach_test(opts)


COCKROACH_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo pgwire servers, kill faults) "
                 "or external (point --addr at an endpoint)"),
    cli.Opt("sandbox", metavar="DIR", default="crdb-cluster"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("addr", metavar="HOST:PORT", default=None,
            help="pgwire endpoint (cockroach / postgres / stub); "
                 "implies server=external"),
    cli.Opt("ts_sql", metavar="SQL", default=None,
            help="DB-side timestamp expression (default suits the "
                 "sqlite-backed CI stub; real cockroach: "
                 "cluster_logical_timestamp())"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": cockroach_test,
                           "opt_spec": COCKROACH_OPTS}),
    **cli.test_all_cmd({"tests_fn": cockroach_tests,
                        "opt_spec": COCKROACH_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
