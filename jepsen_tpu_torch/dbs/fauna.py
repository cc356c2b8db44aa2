"""FaunaDB test suite (faunadb/src/jepsen/faunadb/{client,query,
register,bank,set,pages,monotonic,g2,topology,...}.clj — 14 files /
3,605 LoC, the reference's largest suite).

Fauna's model: every query is ONE strictly-serializable transaction
executed at a transaction timestamp; instances are versioned, so
``At(ts, expr)`` reads historical snapshots; collections are reached
through INDEXES whose reads paginate — and whether a multi-page read
is one snapshot or many is governed by the index's ``serialized``
flag. The reference's distinctive workloads probe exactly those
corners, and all are here:

- ``register``  — ref-keyed instances, CAS via If/Equals
  (register.clj:22-66), independent keys, linearizable checker.
- ``bank``      — conserved transfers in single-query txns.
- ``set``       — creates + final index read (set.clj).
- ``pages``     — groups of elements created atomically, read back
  through PAGINATED index reads; every read must be a union of add
  groups (pages.clj:1-100). With ``serialized_indices`` off, each
  page reads its own snapshot and a group can straddle a page
  boundary — the anomaly is demonstrable on the mini server.
- ``monotonic`` — an incremented register where (ts, value) pairs
  from current and AT-timestamp reads must be monotonic
  (monotonic.clj:1-90).
- ``g2``        — adya predicate anti-dependency probe over two
  classes + two indexes (g2.clj:21-68).

The wire is Fauna's actual shape — HTTP POST of a JSON query
EXPRESSION TREE with basic-auth secret — re-designed as a
from-scratch FQL subset (Do/Create/Get/Update/Delete/Exists/Match/
Paginate/If/Equals/Select/Add/At/Abort; query.clj's combinators).
The LIVE mini server evaluates the tree under a global commit lock
(one query = one strictly-serializable txn), buffers writes so Abort
has no partial effects, version-chains instances for At queries, and
implements both pagination modes. ``zip`` mode emits the real
enterprise-tarball automation (auto.clj: init_db_path/log, replicated
topology via join, faunadb.yml) as command assertions.

The reference's topology nemesis (grow/shrink the replica set,
topology.clj) requires a real multi-node cluster; the zip recipe
carries the join flags it would drive, the mini mode runs the
kill/partition axes.

The port's copy of `jepsen_tpu/dbs/fauna.py`. Its own choices: the
client speaks HTTP through the port's `httpclient` (on `http.client`;
the reference's uses `requests`, which the card's machine lacks), the
secret in its session's `headers`, its exceptions `OSError`s as
`requests`' are, so that the client classifies them as the reference
classifies `requests`'; the mini servers listen from `MINI_BASE_PORT`
32000 (the reference's from 27700, so that both packages' servers can
run on one host at once; below Linux's ephemeral range, 32768-60999;
`zip` mode keeps Fauna's `PORT` 8443); `--device` on `test` and
`test-all`, passed to the `register` workload's competition race, whose
device lane runs the WGL chunk kernels there (default the card: a
missing card raises before any node is set up, `--device cpu` runs
their plain PyTorch versions; the other five workloads check on the
host); the store root `store/torch`. `MINIFAUNA_SRC` is the
reference's, byte for byte.

    python -m jepsen_tpu_torch.dbs.fauna test --nodes f1 \
        --workload register --device cpu"""

from __future__ import annotations

import base64
import sys

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import generator as gen
from .. import independent
from .. import nemesis as jnemesis
from .. import net as jnet
from ..checker import Checker
from ..control import localexec, nodeutil
from ..history import History
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..os_setup import Debian
from ..util import resolve_device
from . import httpclient, miniserver, retryclient

VERSION = "2.5.5"  # reference era (faunadb/project.clj)
PORT = 8443
MINI_BASE_PORT = 32000
SECRET = "secret"  # the enterprise image's root key (auto.clj)


class FaunaError(Exception):
    pass


class FaunaAbort(FaunaError):
    """Transaction aborted by an Abort() expression: no effects."""


# -- the LIVE mini server ----------------------------------------------------

MINIFAUNA_SRC = r'''
import argparse, base64, json, os, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
p.add_argument("--secret", default="secret")
args = p.parse_args()

LOG_PATH = os.path.join(args.dir, "minifauna.jsonl")
GIANT = threading.Lock()
CLASSES = {}    # name -> {"history": {id: [(ts, data_or_None)]}}
INDEXES = {}    # name -> {source, terms, values, serialized}
NEXT_TS = [1]
RESERVED_TS = [0]   # durable high-water mark (reserved in blocks)
NEXT_ID = [1]

def next_ts():
    """Read-only queries consume timestamps too, and a ts handed to
    a client must never be reissued after a kill -9 (a later commit
    landing below an already-returned read ts would fake a
    monotonicity violation). Reserve blocks durably."""
    ts = NEXT_TS[0]
    NEXT_TS[0] += 1
    if NEXT_TS[0] > RESERVED_TS[0]:
        RESERVED_TS[0] = NEXT_TS[0] + 1000
        log_append(["ts", RESERVED_TS[0]])
    return ts

def log_append(rec):
    with open(LOG_PATH, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
        os.fsync(fh.fileno())

def apply_writes(ts, writes):
    for cls, iid, data in writes:
        CLASSES.setdefault(cls, {}).setdefault(str(iid), []).append(
            (ts, data))
    if ts >= NEXT_TS[0]:
        NEXT_TS[0] = ts + 1

def replay():
    if not os.path.exists(LOG_PATH):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail
            if rec[0] == "commit":
                apply_writes(rec[1], rec[2])
            elif rec[0] == "index":
                INDEXES[rec[1]] = rec[2]
            elif rec[0] == "class":
                CLASSES.setdefault(rec[1], {})
            elif rec[0] == "id":
                NEXT_ID[0] = max(NEXT_ID[0], rec[1])
            elif rec[0] == "ts":
                NEXT_TS[0] = max(NEXT_TS[0], rec[1])
    RESERVED_TS[0] = max(RESERVED_TS[0], NEXT_TS[0])

def visible(cls, iid, ts, overlay):
    chain = list(CLASSES.get(cls, {}).get(str(iid), ()))
    chain = [(t, d) for (t, d) in chain if t <= ts]
    if overlay:
        chain += [(ts + 1, d) for (c, i, d) in overlay
                  if c == cls and str(i) == str(iid)]
    return chain[-1][1] if chain else None

def select_path(data, path, default=None):
    cur = data
    for p in path:
        if isinstance(cur, dict) and p in cur:
            cur = cur[p]
        else:
            return default
    return cur

class Abort(Exception):
    pass

class Txn:
    def __init__(self):
        self.writes = []   # (cls, id, data_or_None)

    def eval(self, e, ts):
        if e is None or isinstance(e, (bool, int, float, str)):
            return e
        if isinstance(e, list):
            return [self.eval(x, ts) for x in e]
        assert isinstance(e, dict), e
        if "do" in e:
            out = None
            for sub in e["do"]:
                out = self.eval(sub, ts)
            return out
        if "if" in e:
            if self.eval(e["if"], ts):
                return self.eval(e.get("then"), ts)
            return self.eval(e.get("else"), ts)
        if "not" in e:
            return not self.eval(e["not"], ts)
        if "equals" in e:
            vals = [self.eval(x, ts) for x in e["equals"]]
            return all(v == vals[0] for v in vals)
        if "lt" in e:
            a, b = (self.eval(x, ts) for x in e["lt"])
            return a < b
        if "add" in e:
            return sum(self.eval(x, ts) for x in e["add"])
        if "select" in e:
            return select_path(self.eval(e["from"], ts), e["select"],
                               e.get("default"))
        if "abort" in e:
            raise Abort(str(e["abort"]))
        if "at" in e:
            return self.eval(e["expr"], int(e["at"]))
        if "create" in e:
            cls, iid = e["create"]
            if cls not in CLASSES:
                raise ValueError("class %r not found" % cls)
            if iid is None:
                iid = NEXT_ID[0]
                NEXT_ID[0] += 1
                log_append(["id", NEXT_ID[0]])
            if visible(cls, iid, ts, self.writes) is not None:
                raise Abort("instance already exists")
            data = self.eval(e.get("data") or {}, ts)
            self.writes.append((cls, iid, data))
            return {"ref": [cls, iid], "ts": ts, "data": data}
        if "get" in e:
            cls, iid = e["get"]
            data = visible(cls, iid, ts, self.writes)
            if data is None:
                raise Abort("instance not found")
            return {"ref": [cls, iid], "ts": ts, "data": data}
        if "exists" in e:
            cls, iid = e["exists"]
            return visible(cls, iid, ts, self.writes) is not None
        if "update" in e:
            cls, iid = e["update"]
            cur = visible(cls, iid, ts, self.writes)
            if cur is None:
                raise Abort("instance not found")
            data = dict(cur)
            data.update(self.eval(e.get("data") or {}, ts))
            self.writes.append((cls, iid, data))
            return {"ref": [cls, iid], "ts": ts, "data": data}
        if "delete" in e:
            cls, iid = e["delete"]
            if visible(cls, iid, ts, self.writes) is None:
                raise Abort("instance not found")
            self.writes.append((cls, iid, None))
            return None
        if "exists_match" in e:
            idx, term = e["exists_match"]
            return bool(self.match(idx, self.eval(term, ts), ts))
        if "paginate" in e:
            idx, term = e["paginate"]
            hits = self.match(idx, self.eval(term, ts), ts)
            size = int(e.get("size") or 64)
            after = e.get("after") or 0
            page = hits[after:after + size]
            nxt = after + size if after + size < len(hits) else None
            return {"data": page, "after": nxt, "ts": ts}
        # no operator key: a literal object (e.g. a data map whose
        # values may themselves be expressions)
        return {k: self.eval(v, ts) for k, v in e.items()}

    def match(self, idx, term, ts):
        spec = INDEXES.get(idx)
        if spec is None:
            raise ValueError("index %r not found" % idx)
        hits = []
        cls = spec["source"]
        ids = set(CLASSES.get(cls, {}).keys())
        ids |= {str(i) for (c, i, _) in self.writes if c == cls}
        for iid in ids:
            data = visible(cls, iid, ts, self.writes)
            if data is None:
                continue
            if spec.get("terms"):
                if select_path({"data": data},
                               spec["terms"]) != term:
                    continue
            if spec.get("values"):
                hits.append(select_path({"data": data},
                                        spec["values"]))
            else:
                hits.append([cls, iid])
        return sorted(hits, key=lambda x: (str(type(x)), str(x)))

class H(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _reply(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        auth = self.headers.get("Authorization") or ""
        want = "Basic " + base64.b64encode(
            (args.secret + ":").encode()).decode()
        if auth != want:
            return self._reply(401, {"err": "unauthorized"})
        n = int(self.headers.get("Content-Length") or 0)
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
        except ValueError:
            return self._reply(400, {"err": "bad json"})
        try:
            with GIANT:
                if self.path == "/classes":
                    CLASSES.setdefault(body["name"], {})
                    log_append(["class", body["name"]])
                    return self._reply(200, {"ok": True})
                if self.path == "/indexes":
                    spec = {"source": body["source"],
                            "terms": body.get("terms"),
                            "values": body.get("values"),
                            "serialized":
                                bool(body.get("serialized", True))}
                    INDEXES[body["name"]] = spec
                    log_append(["index", body["name"], spec])
                    return self._reply(200, {"ok": True})
                if self.path == "/":
                    txn = Txn()
                    # every query consumes a timestamp, so snapshots
                    # taken at ts can never gain later commits
                    ts = next_ts()
                    try:
                        out = txn.eval(body, ts)
                    except Abort as e:
                        return self._reply(
                            400, {"err": "transaction aborted: %s"
                                  % e})
                    if txn.writes:
                        apply_writes(ts, txn.writes)
                        log_append(["commit", ts, txn.writes])
                    return self._reply(200, {"resource": out,
                                             "ts": ts})
            self._reply(404, {"err": "no such endpoint"})
        except Exception as e:
            try:
                self._reply(500, {"err": "%s: %s"
                                  % (type(e).__name__, e)})
            except OSError:
                pass

replay()
print("minifauna serving on", args.port, flush=True)
ThreadingHTTPServer(("127.0.0.1", args.port), H).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "fauna_ports")


class MiniFaunaDB(miniserver.MiniServerDB):
    script = "minifauna.py"
    src = MINIFAUNA_SRC
    pidfile = "minifauna.pid"
    logfile = "minifauna.log"
    data_files = ("minifauna.jsonl",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", ".", "--secret", SECRET]


class FaunaDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Enterprise-tarball automation (auto.clj): faunadb.yml with
    per-node storage/log paths, init on the primary, join flags for
    the rest — the handles the topology nemesis would drive."""

    def __init__(self, version: str = VERSION):
        self.version = version

    @staticmethod
    def fauna_yml(test: dict, node: str) -> str:
        return ("auth_root_key: secret\n"
                f"network_broadcast_address: {node}\n"
                "network_listen_address: 0.0.0.0\n"
                "storage_data_path: /var/lib/faunadb\n"
                "log_path: /var/log/faunadb\n")

    def setup(self, test, node):
        primary = test["nodes"][0]
        with control.su():
            control.exec_("apt-get", "install", "-y",
                          "openjdk-8-jre-headless")
            nodeutil.install_archive(
                f"https://packages.fauna.com/enterprise/"
                f"faunadb-enterprise-{self.version}.tar.gz",
                "/opt/faunadb")
            nodeutil.write_file(self.fauna_yml(test, node),
                                "/etc/faunadb.yml")
            control.exec_("mkdir", "-p", "/var/lib/faunadb",
                          "/var/log/faunadb")
            if node == primary:
                control.exec_("/opt/faunadb/bin/faunadb-admin",
                              "init", "-c", "/etc/faunadb.yml")
            else:
                control.exec_("/opt/faunadb/bin/faunadb-admin",
                              "join", primary,
                              "-c", "/etc/faunadb.yml")
            nodeutil.start_daemon(
                {"logfile": "/var/log/faunadb/stdout.log",
                 "pidfile": "/var/run/faunadb.pid",
                 "chdir": "/opt/faunadb"},
                "/opt/faunadb/bin/faunadb",
                "-c", "/etc/faunadb.yml")
        nodeutil.await_tcp_port(PORT, timeout_s=180)

    def teardown(self, test, node):
        with control.su():
            nodeutil.stop_daemon("/var/run/faunadb.pid")
            nodeutil.meh(nodeutil.grepkill, "faunadb")
            control.exec_("rm", "-rf",
                          control.lit("/var/lib/faunadb/*"),
                          control.lit("/var/log/faunadb/*"))

    def start(self, test, node):
        with control.su():
            nodeutil.start_daemon(
                {"logfile": "/var/log/faunadb/stdout.log",
                 "pidfile": "/var/run/faunadb.pid",
                 "chdir": "/opt/faunadb"},
                "/opt/faunadb/bin/faunadb",
                "-c", "/etc/faunadb.yml")
        return "started"

    def kill(self, test, node):
        with control.su():
            nodeutil.stop_daemon("/var/run/faunadb.pid")
            nodeutil.meh(nodeutil.grepkill, "faunadb")
        return "killed"

    def log_files(self, test, node):
        return ["/var/log/faunadb/stdout.log"]


# -- wire client -------------------------------------------------------------

class FaunaConn:
    """HTTP session speaking the JSON expression protocol."""

    def __init__(self, host: str, port: int, timeout: float = 5.0,
                 secret: str = SECRET):
        self.base = f"http://{host}:{port}"
        self.http = httpclient.Session()
        self.http.headers["Authorization"] = (
            "Basic " + base64.b64encode(
                (secret + ":").encode()).decode())
        self.timeout = timeout
        self.query({"equals": [1, 1]})  # probe: auth + liveness

    def _post(self, path: str, body: dict) -> dict:
        r = self.http.post(self.base + path, json=body,
                           timeout=self.timeout)
        data = r.json()
        if r.status_code != 200:
            msg = data.get("err", f"http {r.status_code}")
            if "aborted" in msg:
                raise FaunaAbort(msg)
            raise FaunaError(msg)
        return data

    def upsert_class(self, name: str):
        self._post("/classes", {"name": name})

    def upsert_index(self, name: str, source: str, terms=None,
                     values=None, serialized: bool = True):
        self._post("/indexes", {"name": name, "source": source,
                                "terms": terms, "values": values,
                                "serialized": serialized})

    def query(self, expr) -> dict:
        """One transaction: {"resource": ..., "ts": ...}."""
        return self._post("/", expr)

    def query_all(self, idx: str, term, size: int = 4,
                  serialized: bool = True) -> list:
        """Paginate an index match to exhaustion (f/query-all).
        Serialized indexes re-read every page AT the first page's
        snapshot; non-serialized pages each read fresh state — the
        pages.clj anomaly surface."""
        out = []
        after = 0
        snap_ts = None
        while after is not None:
            expr: dict = {"paginate": [idx, term], "size": size,
                          "after": after}
            if serialized and snap_ts is not None:
                expr = {"at": snap_ts, "expr": expr}
            res = self.query(expr)
            page = res["resource"]
            if snap_ts is None:
                snap_ts = page["ts"]
            out.extend(page["data"])
            after = page["after"]
        return out

    def close(self):
        self.http.close()


class _FaunaBase(retryclient.RetryClient):
    """Connect-retry plumbing + with-errors (client.clj's error
    taxonomy: aborts → fail; transport loss → info unless the op is
    an idempotent read)."""

    retry_excs = (OSError, FaunaError)
    default_port = PORT

    def _connect(self, host: str, port: int) -> FaunaConn:
        return FaunaConn(host, port, timeout=self.timeout)

    def guard(self, op, body, idempotent=("read",)):
        try:
            return body()
        except FaunaAbort as e:
            return {**op, "type": "fail", "error": str(e)[:200]}
        except (OSError, ConnectionError, FaunaError) as e:
            self._drop()
            t = "fail" if op["f"] in idempotent else "info"
            return {**op, "type": t, "error": str(e)[:200]}


# -- register ---------------------------------------------------------------

class RegisterClient(_FaunaBase):
    """Ref-keyed register, CAS via If/Equals (register.clj:22-66)."""

    def setup(self, test):
        self._conn(test).upsert_class("test")

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, v = kv
        ref = ["test", int(k)]
        f = op["f"]

        def body():
            conn = self._conn(test)
            if f == "read":
                res = conn.query(
                    {"if": {"exists": ref},
                     "then": {"select": ["data", "register"],
                              "from": {"get": ref}},
                     "else": None})
                return {**op, "type": "ok",
                        "value": tuple_(k, res["resource"])}
            if f == "write":
                conn.query(
                    {"if": {"exists": ref},
                     "then": {"update": ref,
                              "data": {"register": int(v)}},
                     "else": {"create": ref,
                              "data": {"register": int(v)}}})
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                res = conn.query(
                    {"if": {"exists": ref},
                     "then": {"if": {"equals": [
                         {"select": ["data", "register"],
                          "from": {"get": ref}}, int(old)]},
                         "then": {"update": ref,
                                  "data": {"register": int(new)}},
                         "else": False},
                     "else": False})
                okd = res["resource"] is not False
                return {**op, "type": "ok" if okd else "fail"}
            raise ValueError(f"unknown op {f!r}")

        return self.guard(op, body)


def _w_register(options):
    from ..workloads import linearizable_register
    w = linearizable_register.workload(
        {"nodes": options["nodes"],
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 100,
         "algorithm": "competition",
         "device": options.get("device")})
    return {**w, "client": RegisterClient()}


# -- bank -------------------------------------------------------------------

class BankClient(_FaunaBase):
    """Single-query transfer txns over account instances."""

    def setup(self, test):
        conn = self._conn(test)
        conn.upsert_class("accounts")
        accounts = test["accounts"]
        total = test["total-amount"]
        per, rem = divmod(total, len(accounts))
        for i, a in enumerate(accounts):
            try:
                conn.query({"create": ["accounts", int(a)],
                            "data": {"balance":
                                     per + (1 if i < rem else 0)}})
            except FaunaAbort:
                pass  # another worker's setup won

    def invoke(self, test, op):
        f = op["f"]

        def body():
            conn = self._conn(test)
            if f == "read":
                # ONE txn: an array expression evaluates atomically
                res = conn.query(
                    [{"if": {"exists": ["accounts", int(a)]},
                      "then": {"select": ["data", "balance"],
                               "from": {"get": ["accounts",
                                                int(a)]}},
                      "else": None}
                     for a in test["accounts"]])
                return {**op, "type": "ok",
                        "value": {a: v for a, v in
                                  zip(test["accounts"],
                                      res["resource"])
                                  if v is not None}}
            if f == "transfer":
                t = op["value"]
                src = ["accounts", int(t["from"])]
                dst = ["accounts", int(t["to"])]
                amt = int(t["amount"])
                b_src = {"select": ["data", "balance"],
                         "from": {"get": src}}
                b_dst = {"select": ["data", "balance"],
                         "from": {"get": dst}}
                try:
                    conn.query(
                        {"if": {"lt": [b_src, amt]},
                         "then": {"abort": "insufficient funds"},
                         "else": {"do": [
                             {"update": src,
                              "data": {"balance":
                                       {"add": [b_src, -amt]}}},
                             {"update": dst,
                              "data": {"balance":
                                       {"add": [b_dst, amt]}}}]}})
                except FaunaAbort:
                    # insufficient funds / missing account: no
                    # effects (the server buffers writes)
                    return {**op, "type": "fail"}
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")

        return self.guard(op, body)


def _w_bank(options):
    from ..workloads import bank
    w = bank.workload(options)
    return {**w, "client": BankClient()}


# -- set --------------------------------------------------------------------

class SetClient(_FaunaBase):
    """Creates + final index read (set.clj)."""

    def setup(self, test):
        conn = self._conn(test)
        conn.upsert_class("elements")
        conn.upsert_index(
            "all-elements", "elements",
            values=["data", "value"],
            serialized=bool(test.get("serialized_indices", True)))

    def invoke(self, test, op):
        f = op["f"]

        def body():
            conn = self._conn(test)
            if f == "add":
                conn.query({"create": ["elements", None],
                            "data": {"value": int(op["value"])}})
                return {**op, "type": "ok"}
            if f == "read":
                vals = conn.query_all(
                    "all-elements", None, size=64,
                    serialized=bool(test.get("serialized_indices",
                                             True)))
                return {**op, "type": "ok", "value": sorted(vals)}
            raise ValueError(f"unknown op {f!r}")

        return self.guard(op, body)


def _w_set(options):
    from ..workloads import sets
    w = sets.workload({"time_limit":
                       max(1, (options.get("time_limit") or 10) - 3)})
    return {**w, "client": SetClient(), "wrap_time": False}


# -- pages ------------------------------------------------------------------

class PagesClient(_FaunaBase):
    """Atomic group inserts vs paginated reads (pages.clj:26-64)."""

    def setup(self, test):
        conn = self._conn(test)
        conn.upsert_class("pages")
        conn.upsert_index(
            "all-pages", "pages",
            terms=["data", "key"], values=["data", "value"],
            serialized=bool(test.get("serialized_indices", True)))

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, v = kv
        f = op["f"]

        def body():
            conn = self._conn(test)
            if f == "add":
                conn.query({"do": [
                    {"create": ["pages", None],
                     "data": {"key": int(k), "value": int(x)}}
                    for x in v]})
                return {**op, "type": "ok"}
            if f == "read":
                vals = conn.query_all(
                    "all-pages", int(k), size=4,
                    serialized=bool(test.get("serialized_indices",
                                             True)))
                return {**op, "type": "ok",
                        "value": tuple_(k, sorted(vals))}
            raise ValueError(f"unknown op {f!r}")

        return self.guard(op, body)


class PagesChecker(Checker):
    """Every ok read must be a union of add groups
    (pages.clj:69-100 read-errs)."""

    def check(self, test, history: History, opts=None):
        groups = [frozenset(op.value) for op in history
                  if op.is_ok and op.f == "add"]
        errs = []
        for op in history:
            if not (op.is_ok and op.f == "read"):
                continue
            rest = set(op.value or [])
            for g in groups:
                if rest & g == g:
                    rest -= g
            # leftovers: elements whose group is only partially seen
            leftover = {x for x in rest
                        if any(x in g for g in groups)}
            if leftover:
                errs.append({"read": sorted(op.value),
                             "partial": sorted(leftover)})
        return {"valid?": not errs, "errors": errs[:8]}


def _w_pages(options):
    n = max(1, min(int(options["concurrency"]),
                   2 * len(options["nodes"])))
    counter = iter(range(0, 10 ** 9))

    def fgen(k):
        def add(test, ctx):
            group = [next(counter)
                     for _ in range(1 + gen.RNG.randrange(4))]
            return {"f": "add", "value": group}

        def read(test, ctx):
            return {"f": "read", "value": None}

        return gen.limit(options.get("per_key_limit") or 30,
                         gen.mix([add, read]))

    return {"client": PagesClient(),
            "checker": independent.checker(PagesChecker()),
            "generator": independent.concurrent_generator(
                n, iter(range(10 ** 9)), fgen)}


# -- monotonic ---------------------------------------------------------------

class MonotonicClient(_FaunaBase):
    """Incremented register + AT-timestamp reads
    (monotonic.clj:1-90). inc returns [ts, v]; read [ts, nil] reads
    at ts (or now when nil), completing with [ts, v]."""

    REF = ["registers", 0]

    def setup(self, test):
        conn = self._conn(test)
        conn.upsert_class("registers")
        try:
            conn.query({"create": self.REF, "data": {"value": 0}})
        except FaunaAbort:
            pass

    def invoke(self, test, op):
        f = op["f"]

        def body():
            conn = self._conn(test)
            if f == "inc":
                res = conn.query(
                    {"update": self.REF,
                     "data": {"value": {"add": [
                         {"select": ["data", "value"],
                          "from": {"get": self.REF}}, 1]}}})
                v = res["resource"]["data"]["value"]
                return {**op, "type": "ok",
                        "value": [res["ts"], v]}
            if f == "read":
                ts = (op["value"] or [None])[0]
                expr = {"select": ["data", "value"],
                        "from": {"get": self.REF}}
                if ts is not None:
                    expr = {"at": int(ts), "expr": expr}
                res = conn.query(expr)
                return {**op, "type": "ok",
                        "value": [ts if ts is not None
                                  else res["ts"],
                                  res["resource"]]}
            raise ValueError(f"unknown op {f!r}")

        return self.guard(op, body)


class MonotonicChecker(Checker):
    """(ts, value) pairs must be monotonic: sorted by ts, values
    never decrease (monotonic.clj's core claim)."""

    def check(self, test, history: History, opts=None):
        pairs = [tuple(op.value) for op in history
                 if op.is_ok and op.f in ("inc", "read")
                 and isinstance(op.value, (list, tuple))
                 and len(op.value) == 2 and op.value[1] is not None]
        pairs.sort()
        errs = []
        for (t1, v1), (t2, v2) in zip(pairs, pairs[1:]):
            if v2 < v1:
                errs.append({"ts": [t1, t2], "values": [v1, v2]})
        return {"valid?": not errs, "read-count": len(pairs),
                "errors": errs[:8]}


def _w_monotonic(options):
    recent: list = []

    def inc(test, ctx):
        return {"f": "inc", "value": None}

    def read_now(test, ctx):
        return {"f": "read", "value": None}

    def read_past(test, ctx):
        if not recent:
            return {"f": "read", "value": None}
        return {"f": "read", "value": [gen.RNG.choice(recent), None]}

    class _Track(gen.Generator):
        """Harvest inc timestamps into the recency buffer."""

        def __init__(self, child):
            self.child = child

        def op(self, test, ctx):
            res = gen.op(self.child, test, ctx)
            if res is None:
                return None
            op_, child2 = res
            return op_, _Track(child2)

        def update(self, test, ctx, event):
            if (event.get("type") == "ok"
                    and event.get("f") == "inc"
                    and event.get("value")):
                recent.append(event["value"][0])
                del recent[:-8]
            return _Track(gen.update(self.child, test, ctx, event))

    return {"client": MonotonicClient(),
            "checker": MonotonicChecker(),
            "generator": gen.clients(_Track(gen.mix(
                [inc, inc, read_now, read_past])))}


# -- g2 ---------------------------------------------------------------------

class G2Client(_FaunaBase):
    """Predicate anti-dependency probe (g2.clj:34-68): insert into
    one class only if the OTHER class's index has no row for k."""

    def setup(self, test):
        conn = self._conn(test)
        serialized = bool(test.get("serialized_indices", True))
        for cls in ("a", "b"):
            conn.upsert_class(cls)
            conn.upsert_index(f"{cls}-index", cls,
                              terms=["data", "key"],
                              serialized=serialized)

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, ids = kv
        a_id, b_id = ids
        cls = "a" if a_id is not None else "b"
        other_idx = "b-index" if a_id is not None else "a-index"
        iid = a_id if a_id is not None else b_id

        def body():
            conn = self._conn(test)
            res = conn.query(
                {"if": {"not": {"exists_match": [other_idx,
                                                 int(k)]}},
                 "then": {"create": [cls, int(iid)],
                          "data": {"key": int(k)}},
                 "else": None})
            okd = res["resource"] is not None
            return {**op, "type": "ok" if okd else "fail"}

        return self.guard(op, body)


def _w_g2(options):
    from ..workloads import adya
    w = adya.workload()
    return {**w, "client": G2Client(),
            "generator": gen.clients(w["generator"])}


WORKLOADS = {
    "bank": _w_bank,
    "g2": _w_g2,
    "monotonic": _w_monotonic,
    "pages": _w_pages,
    "register": _w_register,
    "set": _w_set,
}


#: the workloads whose checks run kernels: the register's competition race
#: (its device lane)
DEVICE_WORKLOADS = ("register",)


def fauna_test(options: dict) -> dict:
    """The checks of `DEVICE_WORKLOADS` run their kernels on
    `options["device"]` (default the card), resolved here, so that a
    missing card raises before any node is set up."""
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

    client = w["client"]
    if mode == "mini":
        db: jdb.DB = MiniFaunaDB()
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, node))
        client.pin_primary = True
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "fauna-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "zip":
        db = FaunaDB(options.get("version") or VERSION)
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    if options.get("nemesis") == "partition":
        if mode == "mini":
            raise ValueError("mini mode has no network to partition; "
                             "use the default kill nemesis")
        # Partitioner.setup heals test["net"] (nemesis/__init__.py),
        # so a partition run must carry a Net implementation.
        extra["net"] = jnet.iptables()
        nemesis = jnemesis.partition_random_halves()
    else:
        nemesis = jnemesis.node_start_stopper(
            retryclient.kill_targets(mode),
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node))

    workload_gen = retryclient.standard_generator(
        w, nemesis,
        options.get("nemesis_interval") or 3.0,
        options.get("time_limit") or 10)
    pass_extra = {k: v for k, v in w.items()
                  if k not in ("checker", "generator", "client",
                               "wrap_time")}
    return {
        "name": options.get("name") or f"fauna-{which}-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "serialized_indices": bool(
            options.get("serialized_indices", True)),
        "nemesis": nemesis,
        "checker": jchecker.compose({
            which: w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": workload_gen,
        **extra,
        **pass_extra,
    }


def fauna_tests(options: dict):
    """test-all: each workload in turn. Where the sweep holds a workload of
    `DEVICE_WORKLOADS`, the device is resolved before the first test is
    made, so that a missing card raises before any node is set up."""
    which = options.get("workload")
    names = [which] if which else sorted(WORKLOADS)
    if any(n in DEVICE_WORKLOADS for n in names):
        options = {**options,
                   "device": resolve_device(options.get("device"))}
    for name in names:
        opts = dict(options, workload=name)
        opts["name"] = f"{options.get('name') or 'fauna'}-{name}"
        yield fauna_test(opts)


FAUNA_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo FQL servers) or zip (real "
                 "faunadb-enterprise on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("serialized_indices", metavar="BOOL", default=True,
            parse=lambda s: s not in ("0", "false", "no"),
            help="false lets paginated reads span snapshots "
                 "(pages.clj's anomaly axis)"),
    cli.Opt("per_key_limit", metavar="N", default=30, parse=int),
    cli.Opt("nemesis", metavar="KIND", default="kill",
            help="kill or partition"),
    cli.Opt("sandbox", metavar="DIR", default="fauna-cluster"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's kernels run (default: the "
                 "card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": fauna_test,
                           "opt_spec": FAUNA_OPTS}),
    **cli.test_all_cmd({"tests_fn": fauna_tests,
                        "opt_spec": FAUNA_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
