"""Dual-API test suite — the yugabyte structure (the reference's
largest suite, yugabyte/src/yugabyte/core.clj): ONE database exposing
two API families, with a namespaced workload registry ("ycql/set",
"ysql/bank", ...) built from SHARED workload definitions and per-API
clients, and a test-all sweep over the api x workload matrix
(core.clj workloads-ycql / workloads-ysql / workload-options-
expected-to-pass).

The point of replicating this shape is structural: workload logic
(generators + checkers) is written once and reused across API
surfaces, with only the thin transport client swapped — exactly how
core.clj composes `with-client` over shared yugabyte.{set,bank,...}
namespaces. Here the two surfaces ride this package's existing live
transports:

- **ycql** — the key-value/CQL-flavored surface over the mini-redis
  RESP transport (dbs/redis.py): GET/SET, atomic server-side CAS,
  atomic MGET/MSET batches. Workloads: set (CAS-loop list under one
  key), counter (CAS-loop increments), single-key-acid (the
  linearizable register), multi-key-acid (txn batches over 3-subkey
  groups, linearizable against the multi-register model), bank
  (whole-map CAS transfers), long-fork (MGET snapshots).
- **ysql** — the SQL surface over the mini-sqlite transport
  (dbs/sqlite.py): serializable TXN micro-ops, conditional-UPDATE
  CAS (CASKV), transactional INCRKV. Workloads: set, counter,
  single-key-acid, multi-key-acid, bank, append (elle list-append),
  long-fork.

Both run as LIVE per-node subprocesses over localexec, like every
mini suite, under a kill/restart nemesis.

The port's copy of `jepsen_tpu/dbs/yuga.py`, on the port's `redis` and
`sqlite`. Its own choices: each surface's servers listen on ports of
their own, ycql's from `YCQL_BASE_PORT` 31500 (`MiniYcqlDB`, its
`yuga_ycql_ports` map) and ysql's from `YSQL_BASE_PORT` 31550
(`MiniYsqlDB`, `yuga_ysql_ports`), and every client's default `port_fn`
reads them (the reference's run on redis's and sqlite's ports, and
`MiniServerDB` kills by `<script> --port N` across the host, so those
suites' tests and this one's would kill each other's servers; below
Linux's ephemeral range, 32768-60999); `--device` on `test` and
`test-all`, passed to the checks of `DEVICE_WORKLOADS` (the registers'
and the multi-key groups' competition races, whose device lane runs the
WGL chunk kernels, and the append's cycle search), default the card: a
missing card raises before any node is set up, `--device cpu` runs the
plain PyTorch versions (the other workloads' checks run on the host and
take no device); the store root `store/torch`.

    python -m jepsen_tpu_torch.dbs.yuga test --nodes y1 \
        --workload ycql/multi-key-acid --time-limit 6 --device cpu
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
from .redis import (CAS_LUA, MiniRedisDB, RedisClient, RedisConn,
                    RedisError)
from .sqlite import (MiniSqlDB, SqliteBankClient, SqliteClient)

SET_KEY = "yuga:set"
COUNTER_KEY = "yuga:counter"
# each surface's servers' block (the reference's run on redis's and
# sqlite's)
YCQL_BASE_PORT = 31500
YSQL_BASE_PORT = 31550


def ycql_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, YCQL_BASE_PORT, "yuga_ycql_ports")


def ysql_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, YSQL_BASE_PORT, "yuga_ysql_ports")


def _ycql_addr(test, node):
    return ("127.0.0.1", ycql_port(test, node))


def _ysql_addr(test, node):
    return ("127.0.0.1", ysql_port(test, node))


class MiniYcqlDB(MiniRedisDB):
    """The mini-redis server lifecycle on the ycql surface's ports."""

    def port(self, test, node):
        return ycql_port(test, node)


class MiniYsqlDB(MiniSqlDB):
    """The minisql server lifecycle on the ysql surface's ports."""

    def port(self, test, node):
        return ysql_port(test, node)


# -- ycql clients (RESP transport) ------------------------------------------

class _YcqlBase(jclient.Client):
    def __init__(self, port_fn=None, timeout: float = 5.0):
        self.port_fn = port_fn or _ycql_addr
        self.timeout = timeout
        self.node: Optional[str] = None
        self.conn: Optional[RedisConn] = None

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout)
        c.node = node
        return c

    def _conn(self, test) -> RedisConn:
        if self.conn is None:
            # single logical store: every worker drives nodes[0], and
            # faults are crash-recovery (the sqlite-suite topology).
            # Connects RETRY briefly: the restart window after a
            # kill -9 otherwise turns every op into a hot-spinning
            # refusal — including the one final read the set checker
            # depends on.
            import time as _t
            host, port = self.port_fn(test, test["nodes"][0])
            deadline = _t.monotonic() + 5.0
            while True:
                try:
                    self.conn = RedisConn(host, port, self.timeout)
                    break
                except OSError:
                    if _t.monotonic() >= deadline:
                        raise
                    _t.sleep(0.1)
        return self.conn

    def _drop(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def _cas(self, test, key: str, old: str, new: str) -> bool:
        return self._conn(test).cmd("EVAL", CAS_LUA, 1, key,
                                    old, new) == 1

    #: CAS-loop retry bound shared by every ycql mutate path
    CAS_ATTEMPTS = 48

    def _cas_loop(self, test, op, key: str, update):
        """THE one copy of the GET -> update(cur) -> CAS retry loop.
        `update(cur)` returns the new serialized value, or a
        completed op dict to short-circuit (insufficient funds,
        unseeded key); None means re-seed was issued, retry."""
        conn = self._conn(test)
        for _ in range(self.CAS_ATTEMPTS):
            cur = conn.cmd("GET", key)
            new = update(cur)
            if new is None:
                continue
            if isinstance(new, dict):
                return new
            if self._cas(test, key, cur, new):
                return {**op, "type": "ok"}
        return {**op, "type": "info", "error": "cas-contention"}

    def close(self, test):
        self._drop()


class YcqlSetClient(_YcqlBase):
    """add = CAS-loop over a JSON list under one key (the ycql set
    table compressed to the KV surface); read = GET.

    The key is SEEDED to [] in setup (pre-interpreter, idempotent:
    every racer writes the same empty list) so the hot path is pure
    CAS — a blind "first writer" SET inside invoke would clobber an
    established list when two workers race the empty window (measured:
    interleaved element loss at test start)."""

    def setup(self, test):
        conn = self._conn(test)
        if conn.cmd("GET", SET_KEY) is None:
            conn.cmd("SET", SET_KEY, "[]")

    def invoke(self, test, op):
        try:
            conn = self._conn(test)
            if op["f"] == "add":
                v = int(op["value"])

                def update(cur):
                    if cur is None:
                        # pre-seed window (shouldn't happen: setup
                        # runs first; AOF replay keeps it): never
                        # blind-SET over a racing seeder
                        conn.cmd("SET", SET_KEY, "[]")
                        return None
                    return json.dumps(json.loads(cur) + [v])

                return self._cas_loop(test, op, SET_KEY, update)
            if op["f"] == "read":
                cur = conn.cmd("GET", SET_KEY)
                return {**op, "type": "ok",
                        "value": sorted(json.loads(cur)) if cur else []}
            raise ValueError(f"unknown op {op['f']!r}")
        except (OSError, ConnectionError, RedisError) as e:
            self._drop()
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class YcqlCounterClient(_YcqlBase):
    """add = CAS-loop increment (ycql counter UPDATE ... SET count =
    count + ?); read = GET. Seeded to 0 in setup — a blind SET in the
    hot path would erase concurrent increments (see YcqlSetClient)."""

    def setup(self, test):
        conn = self._conn(test)
        if conn.cmd("GET", COUNTER_KEY) is None:
            conn.cmd("SET", COUNTER_KEY, "0")

    def invoke(self, test, op):
        try:
            conn = self._conn(test)
            if op["f"] == "add":
                d = int(op["value"])

                def update(cur):
                    if cur is None:
                        conn.cmd("SET", COUNTER_KEY, "0")
                        return None
                    return str(int(cur) + d)

                return self._cas_loop(test, op, COUNTER_KEY, update)
            if op["f"] == "read":
                cur = conn.cmd("GET", COUNTER_KEY)
                return {**op, "type": "ok",
                        "value": int(cur) if cur is not None else 0}
            raise ValueError(f"unknown op {op['f']!r}")
        except (OSError, ConnectionError, RedisError) as e:
            self._drop()
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class YcqlBankClient(_YcqlBase):
    """Bank over the KV surface (ycql/bank.clj shape): the account
    map lives as ONE JSON document under a key; transfers are a CAS
    loop on the whole map — the single-key atomicity the CQL surface
    gives cheaply."""

    KEY = "yuga:bank"

    def setup(self, test):
        conn = self._conn(test)
        if conn.cmd("GET", self.KEY) is None:
            accounts = test["accounts"]
            total = test["total-amount"]
            per, rem = divmod(total, len(accounts))
            m = {str(a): per + (1 if i < rem else 0)
                 for i, a in enumerate(accounts)}
            conn.cmd("SET", self.KEY, json.dumps(m, sort_keys=True))

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                cur = conn.cmd("GET", self.KEY)
                m = json.loads(cur) if cur else {}
                return {**op, "type": "ok",
                        "value": {int(k): v for k, v in m.items()}}
            if f == "transfer":
                t = op["value"]
                src, dst, amt = (str(t["from"]), str(t["to"]),
                                 t["amount"])

                def update(cur):
                    if cur is None:
                        return {**op, "type": "fail",
                                "error": "unseeded"}
                    m = json.loads(cur)
                    if m.get(src, 0) < amt:
                        return {**op, "type": "fail"}
                    m[src] = m.get(src, 0) - amt
                    m[dst] = m.get(dst, 0) + amt
                    return json.dumps(m, sort_keys=True)

                return self._cas_loop(test, op, self.KEY, update)
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, RedisError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class YcqlTxnClient(_YcqlBase):
    """Micro-op txns over the KV surface for long-fork /
    multi-key-acid: all-read txns are ONE atomic MGET snapshot,
    write mops land in ONE atomic MSET (single-threaded server =
    real txn atomicity, like CQL batches)."""

    PREFIX = "yuga:mk"

    def _key(self, k) -> str:
        return f"{self.PREFIX}:{k}"

    def invoke(self, test, op):
        mops = op["value"]
        try:
            conn = self._conn(test)
            reads = [m for m in mops if m[0] == "r"]
            writes = [m for m in mops if m[0] == "w"]
            done = []
            if writes and reads:
                # not produced by these workloads; writes-first
                # would break read-your-txn semantics
                raise ValueError("mixed r/w txns unsupported on "
                                 "the ycql KV surface")
            if writes:
                flat = []
                for _, k, v in writes:
                    flat += [self._key(k), json.dumps(v)]
                conn.cmd("MSET", *flat)
                done = [list(m) for m in mops]
            elif reads:
                vals = conn.cmd("MGET",
                                *[self._key(m[1]) for m in reads])
                done = [["r", m[1],
                         json.loads(v) if v is not None else None]
                        for m, v in zip(reads, vals)]
            return {**op, "type": "ok", "value": done}
        except (OSError, ConnectionError, RedisError) as e:
            self._drop()
            t = "fail" if not any(m[0] == "w" for m in mops) \
                else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class YcqlMultiKeyClient(YcqlTxnClient):
    """multi-key-acid over the KV surface: [K [mops]] independent
    tuples, each group's sub-registers namespaced under K (one
    worker runs one op at a time, so the group marker is safe
    instance state)."""

    _group = None

    def _key(self, k) -> str:
        return f"{self.PREFIX}:{self._group}:{k}"

    def invoke(self, test, op):
        from ..independent import KV, tuple_
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"want [k mops] tuples, got {kv!r}")
        K, mops = kv
        self._group = K
        done = super().invoke(test, {**op, "value": mops})
        # re-wrap EVERY completion: the independent layer pairs and
        # unwraps by tuple, and error paths echoed the raw mops
        return {**done, "value": tuple_(K, done["value"])}


# -- ysql clients (SQL transport) -------------------------------------------

class _YsqlBase(SqliteClient):
    """`SqliteClient` on the ysql surface's ports."""

    def __init__(self, port_fn=None, timeout: float = 5.0):
        super().__init__(port_fn or _ysql_addr, timeout)


class YsqlSetClient(_YsqlBase):
    """add = transactional list-append micro-op; read = txn read —
    the ysql set table as one serializable row."""

    def invoke(self, test, op):
        try:
            conn = self._conn(test)
            if op["f"] == "add":
                conn.cmd("TXN", json.dumps(
                    [["append", SET_KEY, int(op["value"])]]))
                return {**op, "type": "ok"}
            if op["f"] == "read":
                out = json.loads(conn.cmd("TXN", json.dumps(
                    [["r", SET_KEY, None]])))
                cur = out[0][2]
                return {**op, "type": "ok",
                        "value": sorted(cur) if cur else []}
            raise ValueError(f"unknown op {op['f']!r}")
        except (OSError, ConnectionError, RedisError) as e:
            self._drop_conn()
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class YsqlCounterClient(_YsqlBase):
    """add = INCRKV (one serializable read-modify-write txn)."""

    def invoke(self, test, op):
        try:
            conn = self._conn(test)
            if op["f"] == "add":
                conn.cmd("INCRKV", COUNTER_KEY, int(op["value"]))
                return {**op, "type": "ok"}
            if op["f"] == "read":
                out = json.loads(conn.cmd("TXN", json.dumps(
                    [["r", COUNTER_KEY, None]])))
                cur = out[0][2]
                return {**op, "type": "ok", "value": int(cur or 0)}
            raise ValueError(f"unknown op {op['f']!r}")
        except (OSError, ConnectionError, RedisError) as e:
            self._drop_conn()
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class YsqlRegisterClient(_YsqlBase):
    """Independent [k v] register over the SQL surface: txn read/
    write, CASKV conditional update (single-key-acid)."""

    def invoke(self, test, op):
        from ..independent import KV, tuple_
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"want [k v] tuples, got {kv!r}")
        k, v = kv
        key = f"yuga:reg:{k}"
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                out = json.loads(conn.cmd("TXN", json.dumps(
                    [["r", key, None]])))
                return {**op, "type": "ok", "value": tuple_(k, out[0][2])}
            if f == "write":
                conn.cmd("TXN", json.dumps([["w", key, int(v)]]))
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                won = conn.cmd("CASKV", key, json.dumps(int(old)),
                               json.dumps(int(new)))
                return {**op, "type": "ok" if won == 1 else "fail"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, RedisError) as e:
            self._drop_conn()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class YsqlTxnClient(_YsqlBase):
    """Micro-op txns for append / long-fork: every value is a list of
    [f k v] micro-ops run in ONE serializable transaction."""

    def invoke(self, test, op):
        try:
            conn = self._conn(test)
            out = json.loads(conn.cmd("TXN", json.dumps(
                [[m[0], m[1], m[2]] for m in op["value"]])))
            return {**op, "type": "ok",
                    "value": [tuple(m) for m in out]}
        except (OSError, ConnectionError, RedisError) as e:
            self._drop_conn()
            # reads never applied -> fail; writes may have -> info
            writes = any(m[0] != "r" for m in op["value"])
            return {**op, "type": "info" if writes else "fail",
                    "error": str(e)[:200]}


class YsqlMultiKeyClient(_YsqlBase):
    """multi-key-acid over the SQL surface: the group's mops run in
    ONE serializable transaction, sub-registers namespaced under K."""

    def invoke(self, test, op):
        from ..independent import KV, tuple_
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"want [k mops] tuples, got {kv!r}")
        K, mops = kv
        keyed = [[m[0], f"yuga:mk:{K}:{m[1]}", m[2]] for m in mops]
        try:
            conn = self._conn(test)
            out = json.loads(conn.cmd("TXN", json.dumps(keyed)))
            done = [[o[0], m[1], o[2]] for o, m in zip(out, mops)]
            return {**op, "type": "ok", "value": tuple_(K, done)}
        except (OSError, ConnectionError, RedisError) as e:
            self._drop_conn()
            writes = any(m[0] != "r" for m in mops)
            return {**op, "type": "info" if writes else "fail",
                    "error": str(e)[:200]}


class YsqlBankClient(_YsqlBase, SqliteBankClient):
    """`SqliteBankClient` on the ysql surface's ports."""


# -- shared workload fragments ----------------------------------------------

def _counter_workload(options):
    """adds of random positive deltas racing reads, counter-checked
    (yugabyte/counter.clj shape)."""
    def add(test, ctx):
        return {"f": "add", "value": 1 + gen.RNG.randrange(5)}

    return {
        "checker": jchecker.counter(),
        "generator": gen.clients(gen.mix(
            [add, gen.repeat({"f": "read", "value": None})])),
    }


def _set_workload(options):
    from ..workloads import sets
    w = sets.workload({"time_limit":
                       max(1, (options.get("time_limit") or 10) - 2)})
    # sets manages its own phases (add-then-final-read): no outer
    # time_limit may cut the final read (the etcd wrap_time pattern)
    return {**w, "wrap_time": False}


def _register_workload(options):
    from ..workloads import linearizable_register
    return linearizable_register.workload(
        {"nodes": options["nodes"],
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 60,
         "time_limit": options.get("time_limit"),
         "device": options.get("device")})


def _bank_workload(options):
    from ..workloads import bank
    return bank.workload(options)


def _append_workload(options):
    from ..workloads import cycle_append
    return cycle_append.workload(anomalies=("G0", "G1", "G2"),
                                 additional_graphs=("realtime",),
                                 device=options.get("device"))


def _long_fork_workload(options):
    from ..workloads import long_fork
    return long_fork.workload(n=2)


def _multi_key_workload(options):
    """multi_key_acid.clj:40-70: txns of [r/w k v] mops over a
    3-subkey group, linearizable against the multi-register model,
    independent groups."""
    import itertools

    from .. import independent
    from ..models import multi_register

    subkeys = [0, 1, 2]

    def _subset():
        ks = [k for k in subkeys if gen.RNG.random() < 0.5]
        return ks or [gen.RNG.choice(subkeys)]

    def fgen(K):
        def r(test, ctx):
            return {"f": "txn",
                    "value": [["r", k, None] for k in _subset()]}

        def w(test, ctx):
            return {"f": "txn",
                    "value": [["w", k, gen.RNG.randrange(5)]
                              for k in _subset()]}

        return gen.limit(options.get("per_key_limit") or 40,
                         gen.mix([r, w]))

    n = max(1, min(int(options["concurrency"]),
                   2 * len(options["nodes"])))
    return {
        "checker": independent.checker(jchecker.linearizable(
            model=multi_register(), algorithm="competition",
            device=options.get("device"))),
        "generator": independent.concurrent_generator(
            n, itertools.count(), fgen),
    }


def _with_client(workload_fn, client_ctor):
    """core.clj's with-client macro: same workload, swapped client."""
    def build(options):
        w = workload_fn(options)
        return {**w, "client": client_ctor()}
    return build


# The namespaced registry (core.clj workloads-ycql / workloads-ysql).
WORKLOADS = {
    "ycql/set":             _with_client(_set_workload, YcqlSetClient),
    "ycql/counter":         _with_client(_counter_workload,
                                         YcqlCounterClient),
    "ycql/single-key-acid": _with_client(_register_workload,
                                         RedisClient),
    "ycql/multi-key-acid":  _with_client(_multi_key_workload,
                                         YcqlMultiKeyClient),
    "ycql/bank":            _with_client(_bank_workload,
                                         YcqlBankClient),
    "ycql/long-fork":       _with_client(_long_fork_workload,
                                         YcqlTxnClient),
    "ysql/set":             _with_client(_set_workload, YsqlSetClient),
    "ysql/counter":         _with_client(_counter_workload,
                                         YsqlCounterClient),
    "ysql/single-key-acid": _with_client(_register_workload,
                                         YsqlRegisterClient),
    "ysql/multi-key-acid":  _with_client(_multi_key_workload,
                                         YsqlMultiKeyClient),
    "ysql/bank":            _with_client(_bank_workload,
                                         YsqlBankClient),
    "ysql/append":          _with_client(_append_workload,
                                         YsqlTxnClient),
    "ysql/long-fork":       _with_client(_long_fork_workload,
                                         YsqlTxnClient),
}

# core.clj's workload-options-expected-to-pass: the sweep skips
# entries whose client/transport pairing is out of scope (mirrors the
# reference commenting out ycql/bank-multitable etc.)
EXPECTED_TO_PASS = sorted(WORKLOADS)

#: the workloads whose checks run kernels: the registers' and the
#: multi-key groups' competition races (their device lane) and the
#: append's cycle search
DEVICE_WORKLOADS = ("ycql/single-key-acid", "ysql/single-key-acid",
                    "ycql/multi-key-acid", "ysql/multi-key-acid",
                    "ysql/append")


def yuga_test(options: dict) -> dict:
    """The checks of `DEVICE_WORKLOADS` run their kernels on
    `options["device"]` (default the card), resolved here, so that a
    missing card raises before any node is set up."""
    which = options.get("workload") or "ysql/append"
    if which not in WORKLOADS:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}")
    if which in DEVICE_WORKLOADS:
        options = {**options,
                   "device": resolve_device(options.get("device"))}
    api = which.split("/", 1)[0]
    nodes = options["nodes"]
    w = WORKLOADS[which](options)

    if api == "ycql":
        db: jdb.DB = MiniYcqlDB()
        client = w["client"]
        if isinstance(client, RedisClient):
            # the registry stores the redis register client directly;
            # point it at the mini port map
            client = RedisClient(port_fn=_ycql_addr)
        sandbox = options.get("sandbox") or "yuga-ycql-cluster"
    else:
        db = MiniYsqlDB()
        client = w["client"]
        sandbox = options.get("sandbox") or "yuga-ysql-cluster"

    interval = options.get("nemesis_interval") or 3.0
    time_limit = options.get("time_limit") or 10
    workload_gen = w["generator"]
    nem_gen = gen.cycle([gen.sleep(interval),
                         {"type": "info", "f": "start"},
                         gen.sleep(interval),
                         {"type": "info", "f": "stop"}])
    if not w.get("wrap_time", True):
        # the workload phases itself (sets: add-then-final-read): the
        # nemesis must bound itself to the ADD window and then
        # RECOVER, or the final read lands on a killed node and the
        # set checker degrades to unknown
        nem_gen = gen.phases(
            gen.time_limit(max(1.0, time_limit - 4.0), nem_gen),
            gen.once(lambda test, ctx: {"type": "info", "f": "stop"}))
    workload_gen = gen.nemesis(nem_gen, workload_gen)
    if w.get("wrap_time", True):
        workload_gen = gen.time_limit(time_limit, workload_gen)
    extra = {k: v for k, v in w.items()
             if k not in ("checker", "generator", "client",
                          "wrap_time")}
    wname = which.replace("/", "-")
    return {
        "name": options.get("name") or f"yuga-{wname}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "remote": localexec.remote(sandbox),
        "ssh": {"dummy?": False},
        "db": db,
        "client": client,
        "nemesis": jnemesis.node_start_stopper(
            lambda ns: [ns[0]],
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node)),
        "checker": jchecker.compose({
            wname: w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": workload_gen,
        **extra,
    }


def yuga_tests(options: dict):
    """test-all: the api x workload sweep
    (workload-options-expected-to-pass). Where the sweep holds a workload
    of `DEVICE_WORKLOADS`, the device is resolved before the first test
    is made, so that a missing card raises before any node is set
    up."""
    which = options.get("workload")
    names = [which] if which else EXPECTED_TO_PASS
    if any(n in DEVICE_WORKLOADS for n in names):
        options = {**options,
                   "device": resolve_device(options.get("device"))}
    for name in names:
        opts = dict(options, workload=name)
        opts["name"] = (f"{options.get('name') or 'yuga'}-"
                        f"{name.replace('/', '-')}")
        yield yuga_test(opts)


YUGA_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("workload", metavar="API/NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))} "
                 "(test: default ysql/append; test-all: sweeps all)"),
    cli.Opt("sandbox", metavar="DIR", default=None),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register / multi-key / append checks' kernels "
                 "run (default: the card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": yuga_test,
                           "opt_spec": YUGA_OPTS}),
    **cli.test_all_cmd({"tests_fn": yuga_tests,
                        "opt_spec": YUGA_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
