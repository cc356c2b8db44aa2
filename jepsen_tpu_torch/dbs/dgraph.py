"""Dgraph test suite (dgraph/src/jepsen/dgraph/{client,core,bank,
delete,linearizable_register,long_fork,sequential,set,upsert,wr}.clj
— 14 files / 2,562 LoC, the reference's graph-database exemplar).

Dgraph's substance is its DISTRIBUTED MVCC TRANSACTION model: Zero
hands out start timestamps, transactions read a snapshot at start_ts,
and commit aborts with TxnConflictException when a concurrently
committed transaction touched an overlapping (uid, predicate) — plus,
*only when the schema says ``@upsert``*, when an eq-index the
transaction READ was changed under it. That last clause is the whole
point of the reference's upsert workload: without ``@upsert``,
concurrent insert-unless-exists races both commit and a key ends up
with TWO uids (upsert.clj:1-4,55-68). The LIVE mini alpha implements
exactly this model — version-chained triples, snapshot reads with
read-your-writes overlay, write-write conflict detection at commit,
index-read conflicts gated on the schema flag — so the anomaly is
reproducible on demand and its cure testable (the ``upsert_schema``
test-map axis, core.clj's --upsert-schema).

Workloads (all eight data workloads of the reference suite):

- ``bank``     — pred-STRIPED accounts (key_i/amount_i/type_i with
  i = k mod pred-count, bank.clj:14-101): reads merge per-stripe
  queries; zero-balance accounts are deleted, not written.
- ``delete``   — upsert/delete/read races on an indexed key; reads
  must see zero-or-one well-formed records (delete.clj:66-88).
- ``upsert``   — at most one upsert per key may succeed; reads must
  never see two uids (upsert.clj:55-68).
- ``register`` — linearizable register over eq(key) + uid mutation
  (linearizable_register.clj:13-70), independent keys, competition
  checker.
- ``set``      — unique inserts, final read (set.clj:13-56).
- ``long-fork``— the G2-family divergence long_fork.clj wires in.
- ``sequential``— per-process subkey chains probing sequential
  consistency (sequential.clj via the tidb-shaped workload).
- ``wr``       — elle rw-register cycles (wr.clj:17-32).

The wire is dgraph's HTTP/JSON surface (the reference speaks gRPC to
the same alpha endpoints — /alter /query /mutate /commit with
startTs; client.clj:52-78): a from-scratch JSON protocol, no client
library. Error taxonomy follows with-conflict-as-fail
(client.clj:141-244): conflicts/aborts → fail, timeouts/resets →
info.

``zip`` mode emits the real automation: dgraph zero + alpha daemons
with --my/--zero flags and a replicas quorum (support.clj), kill +
restart via nodeutil. The reference's move-tablet nemesis needs a
multi-group cluster and is not replicated here (the mini alpha is
single-group); its alpha-kill/partition axes are.

The port's copy of `jepsen_tpu/dbs/dgraph.py`. Its own choices: the
client speaks HTTP through the port's `httpclient` (on `http.client`;
the reference's uses `requests`, which the card's machine lacks), whose
exceptions are `OSError`s as `requests`' are, so that the client
classifies them as the reference classifies `requests`'; the mini alphas
listen from `MINI_BASE_PORT` 31900 (the reference's from 27500, so that
both packages' servers can run on one host at once; below Linux's
ephemeral range, 32768-60999; `zip` mode keeps dgraph's own ports);
`--device` on `test` and `test-all`, passed to the `register`
workload's competition race (its device lane runs the WGL chunk
kernels) and to the `wr` workload's cycle search (default the card: a
missing card raises before any node is set up, `--device cpu` runs
their plain PyTorch versions; the other six workloads check on the
host); the store root `store/torch`. `MINIDGRAPH_SRC` is the
reference's, byte for byte.

    python -m jepsen_tpu_torch.dbs.dgraph test --nodes d1 \
        --workload register --device cpu"""

from __future__ import annotations

import sys
from typing import Optional

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
from ..txn import R, W, is_mop
from ..util import resolve_device
from . import httpclient, miniserver, retryclient

VERSION = "1.1.1"  # reference era (dgraph/project.clj)
ALPHA_HTTP_PORT = 8080
ZERO_PORT = 5080
MINI_BASE_PORT = 31900
PRED_COUNT = 7  # bank stripe width (bank.clj:14-15)


class DgraphError(Exception):
    pass


class TxnConflict(DgraphError):
    """'Conflicts with pending transaction. Please abort.' — the
    write-write / index-read abort (client.clj:232-244)."""


class DgraphAborted(DgraphError):
    """Transaction already aborted/finished."""


# -- the LIVE mini alpha -----------------------------------------------------

MINIDGRAPH_SRC = r'''
import argparse, json, os, re, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

LOG_PATH = os.path.join(args.dir, "minidgraph.jsonl")
GIANT = threading.Lock()
SCHEMA = {}     # pred -> {"upsert": bool, "list": bool}
# version chains: VERSIONS[pred][uid] = [(commit_ts, op, value)]
# op: "set" | "del" (del with value=None wipes the pred)
VERSIONS = {}
NEXT_TS = [1]
RESERVED_TS = [0]   # durable high-water mark (reserved in blocks)
NEXT_UID = [1]
TXNS = {}       # start_ts -> {"writes": [...], "index_reads": set}

def next_ts():
    """Timestamps must NEVER be reissued across a kill -9 — a
    reissued start_ts would let a stale client's /commit ack writes
    that died with the old process. Reserve blocks durably."""
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

def apply_schema(line):
    m = re.match(r"\s*([\w.-]+)\s*:\s*(\[?)\s*\w+\s*\]?\s*(.*?)\s*\.\s*$",
                 line)
    if not m:
        return
    pred, listp, directives = m.group(1), m.group(2), m.group(3)
    SCHEMA[pred] = {"upsert": "@upsert" in directives,
                    "list": listp == "["}

def apply_writes(commit_ts, writes):
    for uid, pred, op, value in writes:
        VERSIONS.setdefault(pred, {}).setdefault(uid, []).append(
            (commit_ts, op, value))
    if commit_ts >= NEXT_TS[0]:
        NEXT_TS[0] = commit_ts + 1

def replay():
    if not os.path.exists(LOG_PATH):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail
            if rec[0] == "schema":
                apply_schema(rec[1])
            elif rec[0] == "commit":
                apply_writes(rec[1], [tuple(w) for w in rec[2]])
            elif rec[0] == "uid":
                NEXT_UID[0] = max(NEXT_UID[0], rec[1])
            elif rec[0] == "ts":
                NEXT_TS[0] = max(NEXT_TS[0], rec[1])
    RESERVED_TS[0] = max(RESERVED_TS[0], NEXT_TS[0])

def visible(pred, uid, ts, overlay=None):
    """Value(s) of (uid, pred) at snapshot ts (+ txn overlay):
    scalar preds last-write-wins, list preds accumulate."""
    chain = list(VERSIONS.get(pred, {}).get(uid, ()))
    chain = [(t, op, v) for (t, op, v) in chain if t <= ts]
    if overlay:
        chain += [(ts + 1, op, v) for (u2, p2, op, v) in overlay
                  if u2 == uid and p2 == pred]
    if SCHEMA.get(pred, {}).get("list"):
        vals = []
        for _, op, v in chain:
            if op == "set":
                vals.append(v)
            else:
                vals = [] if v is None else [x for x in vals if x != v]
        return vals
    out = None
    for _, op, v in chain:
        out = v if op == "set" else None
    return out

def uids_with(pred, value, ts, overlay=None):
    """eq(pred, value) index scan at snapshot ts."""
    hits = []
    uids = set(VERSIONS.get(pred, {}).keys())
    if overlay:
        uids |= {u for (u, p, _, _) in overlay if p == pred}
    for uid in uids:
        v = visible(pred, uid, ts, overlay)
        if SCHEMA.get(pred, {}).get("list"):
            if value in v:
                hits.append(uid)
        elif v == value:
            hits.append(uid)
    return sorted(hits)

QUERY_RE = re.compile(
    r"\{\s*(\w+)\s*\(\s*func:\s*(eq|uid)\s*\(\s*"
    r"([\w.$-]+)\s*(?:,\s*([^)]+?)\s*)?\)\s*\)\s*"
    r"\{([^}]*)\}\s*\}", re.S)

def subst(token, vars_):
    token = token.strip()
    if token.startswith("$"):
        return vars_.get(token[1:])
    if token.startswith('"') and token.endswith('"'):
        return token[1:-1]
    try:
        return int(token)
    except ValueError:
        return token

def run_query(q, vars_, ts, txn):
    m = QUERY_RE.search(q)
    if m is None:
        raise ValueError("unsupported query: %s" % q[:120])
    name, func, a1, a2, fields = m.groups()
    fields = [f.strip().rstrip(",") for f in fields.split()]
    fields = [f for f in fields if f]
    overlay = txn["writes"] if txn else None
    if func == "uid":
        uid = subst(a1, vars_) if a1.startswith("$") else a1
        uids = [uid] if uid is not None else []
    else:
        pred = a1
        value = subst(a2, vars_)
        uids = uids_with(pred, value, ts, overlay)
        if txn is not None and SCHEMA.get(pred, {}).get("upsert"):
            # @upsert: the index read participates in conflict
            # detection (the reference's upsert-schema axis)
            txn["index_reads"].add((pred, json.dumps(value)))
    out = []
    for uid in uids:
        rec = {}
        present = False
        for f in fields:
            if f == "uid":
                rec["uid"] = uid
                continue
            v = visible(f, uid, ts, overlay)
            if v is not None and v != []:
                rec[f] = v
                present = True
        if present or ("uid" in rec and len(fields) == 1):
            out.append(rec)
    return {name: out}

def mutate(txn, body):
    """JSON mutations: {"set": [objs], "delete": [objs]}. Objects
    without uid get a fresh one; returns the uid map."""
    assigned = {}
    for i, obj in enumerate(body.get("set") or []):
        uid = obj.get("uid")
        if uid is None:
            uid = "0x%x" % NEXT_UID[0]
            NEXT_UID[0] += 1
            log_append(["uid", NEXT_UID[0]])
            assigned["blank-%d" % i] = uid
        for pred, val in obj.items():
            if pred == "uid":
                continue
            txn["writes"].append((uid, pred, "set", val))
    for obj in body.get("delete") or []:
        uid = obj.get("uid")
        if uid is None:
            continue
        preds = [p for p in obj if p != "uid"]
        if not preds:
            preds = sorted(
                p for p, by_uid in VERSIONS.items() if uid in by_uid)
        for pred in preds:
            txn["writes"].append((uid, pred, "del", obj.get(pred)))
    return assigned

def commit(txn, start_ts):
    """Write-write + (gated) index-read conflict detection
    (dgraph's Zero commit path)."""
    for uid, pred, _, _ in txn["writes"]:
        for t, _, _ in VERSIONS.get(pred, {}).get(uid, ()):
            if t > start_ts:
                raise Conflict()
    for pred, valj in txn["index_reads"]:
        value = json.loads(valj)
        for uid, chain in VERSIONS.get(pred, {}).items():
            for t, op, v in chain:
                if t > start_ts and (v == value or op == "del"):
                    raise Conflict()
    commit_ts = next_ts()
    apply_writes(commit_ts, txn["writes"])
    log_append(["commit", commit_ts, txn["writes"]])
    return commit_ts

class Conflict(Exception):
    pass

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

    def _body(self):
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def do_POST(self):
        path, _, qs = self.path.partition("?")
        params = dict(kv.split("=") for kv in qs.split("&") if "=" in kv)
        try:
            body = self._body()
            with GIANT:
                if path == "/alter":
                    for line in body.get("schema", "").splitlines():
                        if line.strip():
                            apply_schema(line)
                            log_append(["schema", line])
                    return self._reply(200, {"ok": True})
                if path == "/begin":
                    ts = next_ts()
                    TXNS[ts] = {"writes": [], "index_reads": set()}
                    return self._reply(200, {"start_ts": ts})
                ts = int(params.get("startTs") or 0)
                txn = TXNS.get(ts)
                if path == "/query":
                    if ts and txn is None:
                        return self._reply(
                            409, {"err": "ABORTED: txn unknown"})
                    res = run_query(body["query"],
                                    body.get("vars") or {},
                                    ts or NEXT_TS[0], txn)
                    return self._reply(200, {"data": res})
                if path == "/mutate":
                    if ts and txn is None:
                        # unknown nonzero startTs: the txn died with
                        # a previous process — never resurrect it
                        return self._reply(
                            409, {"err": "ABORTED: Transaction has "
                                         "been aborted. Please retry."})
                    if txn is None:
                        txn = {"writes": [], "index_reads": set()}
                    uids = mutate(txn, body)
                    if params.get("commitNow") == "true" or ts == 0:
                        try:
                            commit(txn, ts or NEXT_TS[0])
                        except Conflict:
                            TXNS.pop(ts, None)
                            return self._reply(409, {
                                "err": "Conflicts with pending "
                                       "transaction. Please abort."})
                        TXNS.pop(ts, None)
                    return self._reply(200, {"uids": uids})
                if path == "/commit":
                    if txn is None:
                        return self._reply(
                            409, {"err": "ABORTED: Transaction has "
                                         "been aborted. Please retry."})
                    del TXNS[ts]
                    try:
                        cts = commit(txn, ts)
                    except Conflict:
                        return self._reply(409, {
                            "err": "Conflicts with pending "
                                   "transaction. Please abort."})
                    return self._reply(200, {"commit_ts": cts})
                if path == "/abort":
                    TXNS.pop(ts, None)
                    return self._reply(200, {"ok": True})
            self._reply(404, {"err": "no such endpoint " + path})
        except Exception as e:
            try:
                self._reply(500, {"err": "%s: %s"
                                  % (type(e).__name__, e)})
            except OSError:
                pass

replay()
print("minidgraph serving on", args.port, flush=True)
ThreadingHTTPServer(("127.0.0.1", args.port), H).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "dgraph_ports")


class MiniDgraphDB(miniserver.MiniServerDB):
    script = "minidgraph.py"
    src = MINIDGRAPH_SRC
    pidfile = "minidgraph.pid"
    logfile = "minidgraph.log"
    data_files = ("minidgraph.jsonl",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


class DgraphDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real cluster automation (support.clj): one zero per node (the
    first bootstraps, the rest join via --peer), one alpha per node
    pointed at the local zero, replicas = cluster quorum."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def tarball_url(self) -> str:
        return (f"https://github.com/dgraph-io/dgraph/releases/"
                f"download/v{self.version}/dgraph-linux-amd64.tar.gz")

    def setup(self, test, node):
        primary = test["nodes"][0]
        n = len(test["nodes"])
        idx = test["nodes"].index(node) + 1
        with control.su():
            nodeutil.install_archive(self.tarball_url(), "/opt/dgraph")
            zero_args = ["--my", f"{node}:{ZERO_PORT}",
                         "--replicas", str(n // 2 + 1),
                         "--idx", str(idx)]
            if node != primary:
                zero_args += ["--peer", f"{primary}:{ZERO_PORT}"]
            nodeutil.start_daemon(
                {"logfile": "/var/log/dgraph-zero.log",
                 "pidfile": "/var/run/dgraph-zero.pid",
                 "chdir": "/opt/dgraph"},
                "/opt/dgraph/dgraph", "zero", *zero_args)
            nodeutil.start_daemon(
                {"logfile": "/var/log/dgraph-alpha.log",
                 "pidfile": "/var/run/dgraph-alpha.pid",
                 "chdir": "/opt/dgraph"},
                "/opt/dgraph/dgraph", "alpha",
                "--my", f"{node}:7080",
                "--zero", f"{node}:{ZERO_PORT}")
        nodeutil.await_tcp_port(ALPHA_HTTP_PORT, timeout_s=120)

    def teardown(self, test, node):
        with control.su():
            nodeutil.stop_daemon("/var/run/dgraph-alpha.pid")
            nodeutil.stop_daemon("/var/run/dgraph-zero.pid")
            nodeutil.meh(nodeutil.grepkill, "dgraph")
            control.exec_("rm", "-rf", "/opt/dgraph/p",
                          "/opt/dgraph/w", "/opt/dgraph/zw")

    def start(self, test, node):
        self.setup(test, node)
        return "started"

    def kill(self, test, node):
        with control.su():
            nodeutil.stop_daemon("/var/run/dgraph-alpha.pid")
            nodeutil.meh(nodeutil.grepkill, "dgraph alpha")
        return "killed"

    def log_files(self, test, node):
        return ["/var/log/dgraph-zero.log", "/var/log/dgraph-alpha.log"]


# -- wire client -------------------------------------------------------------

class DgraphConn:
    """One HTTP client session against an alpha; transactions carry
    their start_ts explicitly (client.clj's Transaction object)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.base = f"http://{host}:{port}"
        self.http = httpclient.Session()
        self.timeout = timeout
        # start_ts of txns this session deliberately finished (commit,
        # abort, or commitNow mutate): _DgraphBase.txn only swallows a
        # commit-time ABORTED for these — an ABORTED on an unfinished
        # txn (e.g. a restarted alpha that lost the startTs) must
        # surface as fail, never as a false ok.
        self.finished: set = set()
        # touch the endpoint so the retry window covers startup
        self._post("/query", {"query": "{ q(func: eq(_probe_, 0)) "
                                       "{ uid } }"})

    def _post(self, path: str, body: dict, **params) -> dict:
        qs = "&".join(f"{k}={v}" for k, v in params.items() if v)
        url = f"{self.base}{path}" + (f"?{qs}" if qs else "")
        r = self.http.post(url, json=body, timeout=self.timeout)
        data = r.json()
        if r.status_code != 200:
            msg = data.get("err", f"http {r.status_code}")
            if "Conflicts with pending transaction" in msg:
                raise TxnConflict(msg)
            if "ABORTED" in msg:
                raise DgraphAborted(msg)
            raise DgraphError(msg)
        return data

    def alter(self, schema: str):
        self._post("/alter", {"schema": schema})

    def begin(self) -> int:
        return self._post("/begin", {})["start_ts"]

    def query(self, q: str, vars: Optional[dict] = None,
              ts: Optional[int] = None) -> dict:
        return self._post("/query", {"query": q, "vars": vars or {}},
                          startTs=ts)["data"]

    def mutate(self, ts: Optional[int], set_objs=None, del_objs=None,
               commit_now: bool = False) -> dict:
        uids = self._post(
            "/mutate",
            {"set": set_objs or [], "delete": del_objs or []},
            startTs=ts,
            commitNow="true" if commit_now else "")["uids"]
        if commit_now and ts is not None:
            self.finished.add(ts)
        return uids

    def commit(self, ts: int):
        self._post("/commit", {}, startTs=ts)
        self.finished.add(ts)

    def abort(self, ts: int):
        self.finished.add(ts)
        try:
            self._post("/abort", {}, startTs=ts)
        except (OSError, DgraphError):
            pass

    def close(self):
        self.http.close()


def gen_pred(prefix: str, count: int, k) -> str:
    """Stripe a key across numbered predicates (bank.clj:16-20 via
    client.clj gen-pred)."""
    return f"{prefix}_{int(k) % count}"


def gen_preds(prefix: str, count: int) -> list:
    return [f"{prefix}_{i}" for i in range(count)]


class _DgraphBase(retryclient.RetryClient):
    """Connect-retry plumbing + the with-txn / with-conflict-as-fail
    discipline (client.clj:106-125,141-244): conflicts → fail,
    connection loss mid-mutation → info."""

    retry_excs = (OSError, DgraphError)
    default_port = ALPHA_HTTP_PORT

    def _connect(self, host: str, port: int) -> DgraphConn:
        return DgraphConn(host, port, timeout=self.timeout)

    def txn(self, test, body):
        """Run body(conn, ts) in a transaction; commits unless the
        body committed/aborted itself. Aborts on error."""
        conn = self._conn(test)
        ts = conn.begin()
        try:
            out = body(conn, ts)
        except BaseException:
            conn.abort(ts)
            raise
        try:
            conn.commit(ts)
        except DgraphAborted:
            # Only a txn the body itself finished (commit/abort/
            # commitNow) gets the with-txn TxnFinishedException pass;
            # any other ABORTED (conflict, or a restarted alpha that
            # no longer knows this startTs) means nothing committed —
            # guard() turns the re-raise into a fail op.
            if ts not in conn.finished:
                raise
        return out

    def guard(self, op, body):
        """with-conflict-as-fail: returns a completed op."""
        reads_only = op["f"] in ("read",)
        try:
            return body()
        except TxnConflict as e:
            return {**op, "type": "fail", "error": "conflict"}
        except DgraphAborted as e:
            return {**op, "type": "fail",
                    "error": "transaction-aborted"}
        except (OSError, ConnectionError, DgraphError) as e:
            self._drop()
            t = "fail" if reads_only else "info"
            return {**op, "type": t, "error": str(e)[:200]}


# -- upsert workload ---------------------------------------------------------

class UpsertClient(_DgraphBase):
    """Insert-unless-exists races (upsert.clj:23-51): the schema's
    @upsert directive decides whether the index read conflicts."""

    def setup(self, test):
        conn = self._conn(test)
        upsert = " @upsert" if test.get("upsert_schema") else ""
        conn.alter(f"email: string @index(exact){upsert} .")

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, _ = kv
        f = op["f"]

        def body():
            if f == "upsert":
                def run(conn, ts):
                    found = conn.query(
                        "{ q(func: eq(email, $email)) { uid } }",
                        {"email": str(k)}, ts=ts)["q"]
                    if found:
                        conn.abort(ts)
                        return None
                    uids = conn.mutate(ts,
                                       set_objs=[{"email": str(k)}])
                    return next(iter(uids.values()), None)

                uid = self.txn(test, run)
                return {**op,
                        "type": "ok" if uid else "fail",
                        "value": tuple_(k, uid)}
            if f == "read":
                def run(conn, ts):
                    return conn.query(
                        "{ q(func: eq(email, $email)) { uid } }",
                        {"email": str(k)}, ts=ts)["q"]

                found = self.txn(test, run)
                return {**op, "type": "ok",
                        "value": tuple_(k, sorted(
                            r["uid"] for r in found))}
            raise ValueError(f"unknown op {f!r}")

        return self.guard(op, body)


class UpsertChecker(Checker):
    """≤1 ok upsert per key; no read may see two uids
    (upsert.clj:55-68)."""

    def check(self, test, history: History, opts=None):
        upserts = [op for op in history
                   if op.is_ok and op.f == "upsert"]
        bad_reads = [list(op.value) for op in history
                     if op.is_ok and op.f == "read"
                     and len(op.value or []) > 1]
        return {"valid?": not bad_reads and len(upserts) <= 1,
                "ok-upsert-count": len(upserts),
                "bad-reads": bad_reads[:8]}


def _w_upsert(options):
    n = max(1, min(int(options["concurrency"]),
                   2 * len(options["nodes"])))

    def fgen(k):
        return gen.phases(
            gen.each_thread(gen.once(
                lambda test, ctx: {"f": "upsert", "value": None})),
            gen.each_thread(gen.once(
                lambda test, ctx: {"f": "read", "value": None})))

    return {"client": UpsertClient(),
            "checker": independent.checker(UpsertChecker()),
            "generator": independent.concurrent_generator(
                n, iter(range(10 ** 9)), fgen)}


# -- delete workload ---------------------------------------------------------

class DeleteClient(_DgraphBase):
    """upsert/delete/read races on eq(key) (delete.clj:23-63)."""

    def setup(self, test):
        conn = self._conn(test)
        upsert = " @upsert" if test.get("upsert_schema") else ""
        conn.alter(f"key: int @index(int){upsert} .")

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, _ = kv
        f = op["f"]

        def body():
            if f == "read":
                def run(conn, ts):
                    return conn.query(
                        "{ q(func: eq(key, $key)) { uid key } }",
                        {"key": int(k)}, ts=ts)["q"]

                return {**op, "type": "ok",
                        "value": tuple_(k, self.txn(test, run))}
            if f == "upsert":
                def run(conn, ts):
                    found = conn.query(
                        "{ q(func: eq(key, $key)) { uid } }",
                        {"key": int(k)}, ts=ts)["q"]
                    if found:
                        conn.abort(ts)
                        return None
                    uids = conn.mutate(ts, set_objs=[{"key": int(k)}])
                    return next(iter(uids.values()), None)

                uid = self.txn(test, run)
                if uid is None:
                    return {**op, "type": "fail", "error": "present"}
                return {**op, "type": "ok"}
            if f == "delete":
                def run(conn, ts):
                    found = conn.query(
                        "{ q(func: eq(key, $key)) { uid } }",
                        {"key": int(k)}, ts=ts)["q"]
                    if not found:
                        conn.abort(ts)
                        return None
                    conn.mutate(ts,
                                del_objs=[{"uid": found[0]["uid"]}])
                    return found[0]["uid"]

                uid = self.txn(test, run)
                if uid is None:
                    return {**op, "type": "fail",
                            "error": "not-found"}
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")

        return self.guard(op, body)


class DeleteChecker(Checker):
    """Every ok read sees zero records or exactly one {uid, key}
    with the right key (delete.clj:66-88)."""

    def check(self, test, history: History, opts=None):
        k = (opts or {}).get("history_key")
        bad = []
        for op in history:
            if not (op.is_ok and op.f == "read"):
                continue
            recs = op.value or []
            if len(recs) == 0:
                continue
            if len(recs) == 1:
                rec = recs[0]
                if set(rec) == {"uid", "key"} and (
                        k is None or rec["key"] == k):
                    continue
            bad.append(recs)
        return {"valid?": not bad, "bad-reads": bad[:8]}


def _w_delete(options):
    n = max(1, min(int(options["concurrency"]),
                   2 * len(options["nodes"])))

    def fgen(k):
        def u(test, ctx):
            return {"f": "upsert", "value": None}

        def d(test, ctx):
            return {"f": "delete", "value": None}

        def r(test, ctx):
            return {"f": "read", "value": None}

        return gen.limit(options.get("per_key_limit") or 60,
                         gen.mix([r, u, d]))

    return {"client": DeleteClient(),
            "checker": independent.checker(DeleteChecker()),
            "generator": independent.concurrent_generator(
                n, iter(range(10 ** 9)), fgen)}


# -- set workload ------------------------------------------------------------

class SetClient(_DgraphBase):
    """Unique inserts under eq(jepsen-type) (set.clj:13-46)."""

    def setup(self, test):
        conn = self._conn(test)
        conn.alter("jepsen-type: string @index(exact) .\n"
                   "value: int .")

    def invoke(self, test, op):
        f = op["f"]

        def body():
            if f == "add":
                def run(conn, ts):
                    conn.mutate(ts, set_objs=[
                        {"jepsen-type": "element",
                         "value": int(op["value"])}])

                self.txn(test, run)
                return {**op, "type": "ok"}
            if f == "read":
                def run(conn, ts):
                    return conn.query(
                        "{ q(func: eq(jepsen-type, $type)) "
                        "{ uid value } }",
                        {"type": "element"}, ts=ts)["q"]

                recs = self.txn(test, run)
                return {**op, "type": "ok",
                        "value": sorted(r["value"] for r in recs
                                        if "value" in r)}
            raise ValueError(f"unknown op {f!r}")

        return self.guard(op, body)


def _w_set(options):
    from ..workloads import sets
    w = sets.workload({"time_limit":
                       max(1, (options.get("time_limit") or 10) - 3)})
    return {**w, "client": SetClient(), "wrap_time": False}


# -- bank workload -----------------------------------------------------------

class BankClient(_DgraphBase):
    """Pred-striped accounts (bank.clj:36-101): key_i/amount_i/type_i
    with i = k mod pred-count; zero balances are deleted."""

    def __init__(self, port_fn=None, timeout: float = 5.0,
                 pin_primary: bool = False,
                 pred_count: int = PRED_COUNT):
        super().__init__(port_fn, timeout, pin_primary)
        self.pred_count = pred_count

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout, self.pin_primary,
                       self.pred_count)
        c.node = node
        return c

    def setup(self, test):
        conn = self._conn(test)
        upsert = " @upsert" if test.get("upsert_schema") else ""
        lines = []
        for p in gen_preds("key", self.pred_count):
            lines.append(f"{p}: int @index(int){upsert} .")
        for p in gen_preds("type", self.pred_count):
            lines.append(f"{p}: string @index(exact){upsert} .")
        for p in gen_preds("amount", self.pred_count):
            lines.append(f"{p}: int .")
        conn.alter("\n".join(lines))
        # initial accounts, one txn (bank.clj setup)
        accounts = test["accounts"]
        total = test["total-amount"]
        per, rem = divmod(total, len(accounts))

        def run(conn, ts):
            existing = self._read_accounts(conn, ts)
            if existing:
                conn.abort(ts)
                return
            objs = []
            for i, a in enumerate(accounts):
                objs.append({
                    gen_pred("key", self.pred_count, a): int(a),
                    gen_pred("amount", self.pred_count, a):
                        per + (1 if i < rem else 0),
                    gen_pred("type", self.pred_count, a): "account"})
            conn.mutate(ts, set_objs=objs)

        try:
            self.txn(test, run)
        except TxnConflict:
            pass  # another worker's setup won

    def _read_accounts(self, conn, ts) -> dict:
        """Merge per-stripe queries (bank.clj:36-57)."""
        out = {}
        for i in range(self.pred_count):
            fields = " ".join(gen_preds("key", self.pred_count)
                              + gen_preds("amount", self.pred_count))
            recs = conn.query(
                "{ q(func: eq(type_%d, $type)) { %s } }"
                % (i, fields),
                {"type": "account"}, ts=ts)["q"]
            for rec in recs:
                key = amount = None
                for pred, v in rec.items():
                    if pred.startswith("key_"):
                        key = v
                    elif pred.startswith("amount_"):
                        amount = v
                if key is not None:
                    out[key] = amount
        return out

    def _find_account(self, conn, ts, k) -> dict:
        kp = gen_pred("key", self.pred_count, k)
        ap = gen_pred("amount", self.pred_count, k)
        recs = conn.query(
            "{ q(func: eq(%s, $key)) { uid %s %s } }" % (kp, kp, ap),
            {"key": int(k)}, ts=ts)["q"]
        if recs:
            return {"uid": recs[0]["uid"], "key": k,
                    "amount": recs[0].get(ap, 0)}
        return {"uid": None, "key": k, "amount": 0}

    def _write_account(self, conn, ts, account):
        k = account["key"]
        kp = gen_pred("key", self.pred_count, k)
        ap = gen_pred("amount", self.pred_count, k)
        tp = gen_pred("type", self.pred_count, k)
        if account["amount"] == 0 and account["uid"]:
            conn.mutate(ts, del_objs=[{"uid": account["uid"]}])
        elif account["uid"]:
            conn.mutate(ts, set_objs=[{"uid": account["uid"],
                                       ap: account["amount"]}])
        else:
            conn.mutate(ts, set_objs=[{kp: int(k),
                                       ap: account["amount"],
                                       tp: "account"}])

    def invoke(self, test, op):
        f = op["f"]

        def body():
            if f == "read":
                def run(conn, ts):
                    return self._read_accounts(conn, ts)

                return {**op, "type": "ok",
                        "value": self.txn(test, run)}
            if f == "transfer":
                t = op["value"]
                src, dst, amt = t["from"], t["to"], t["amount"]

                def run(conn, ts):
                    a1 = self._find_account(conn, ts, src)
                    a2 = self._find_account(conn, ts, dst)
                    if a1["amount"] - amt < 0:
                        conn.abort(ts)
                        return False
                    a1["amount"] -= amt
                    a2["amount"] += amt
                    self._write_account(conn, ts, a1)
                    self._write_account(conn, ts, a2)
                    return True

                okd = self.txn(test, run)
                return {**op, "type": "ok" if okd else "fail"}
            raise ValueError(f"unknown op {f!r}")

        return self.guard(op, body)


def _w_bank(options):
    from ..workloads import bank
    w = bank.workload(options)
    return {**w, "client": BankClient(
        pred_count=options.get("pred_count") or PRED_COUNT)}


# -- linearizable register ---------------------------------------------------

class RegisterClient(_DgraphBase):
    """eq(key) read + uid mutation (linearizable_register.clj:13-70);
    read timeouts demote to fail (reads are idempotent)."""

    def setup(self, test):
        conn = self._conn(test)
        upsert = " @upsert" if test.get("upsert_schema") else ""
        conn.alter(f"key: int @index(int){upsert} .\nvalue: int .")

    def _read(self, conn, ts, k):
        recs = conn.query(
            "{ q(func: eq(key, $key)) { uid value } }",
            {"key": int(k)}, ts=ts)["q"]
        return recs[0] if recs else None

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, v = kv
        f = op["f"]

        def body():
            if f == "read":
                def run(conn, ts):
                    rec = self._read(conn, ts, k)
                    return rec.get("value") if rec else None

                return {**op, "type": "ok",
                        "value": tuple_(k, self.txn(test, run))}
            if f == "write":
                def run(conn, ts):
                    rec = self._read(conn, ts, k)
                    if rec:
                        conn.mutate(ts, set_objs=[
                            {"uid": rec["uid"], "value": int(v)}])
                    else:
                        conn.mutate(ts, set_objs=[
                            {"key": int(k), "value": int(v)}])

                self.txn(test, run)
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v

                def run(conn, ts):
                    rec = self._read(conn, ts, k)
                    if rec is None or rec.get("value") != old:
                        conn.abort(ts)
                        return False
                    conn.mutate(ts, set_objs=[
                        {"uid": rec["uid"], "value": int(new)}])
                    return True

                okd = self.txn(test, run)
                if not okd:
                    return {**op, "type": "fail",
                            "error": "value-mismatch"}
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")

        done = self.guard(op, body)
        # read-info->fail (linearizable_register.clj:25-31)
        if done["f"] == "read" and done["type"] == "info":
            done = {**done, "type": "fail"}
        return done


def _w_register(options):
    from ..workloads import linearizable_register
    w = linearizable_register.workload(
        {"nodes": options["nodes"],
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 100,
         "algorithm": "competition",
         "device": options.get("device")})
    return {**w, "client": RegisterClient()}


# -- mop client (long-fork, wr) ----------------------------------------------

class MopClient(_DgraphBase):
    """Micro-op txns over eq(key)-indexed registers — the wr.clj /
    long_fork.clj transaction shape, one dgraph txn per op."""

    def setup(self, test):
        conn = self._conn(test)
        upsert = " @upsert" if test.get("upsert_schema") else ""
        conn.alter(f"key: int @index(int){upsert} .\nvalue: int .")

    def invoke(self, test, op):
        mops = op["value"]
        if not (isinstance(mops, list) and mops
                and all(is_mop(m) for m in mops)):
            raise ValueError(f"wants mop lists, got {mops!r}")

        def body():
            def run(conn, ts):
                done = []
                for f, k, v in mops:
                    recs = conn.query(
                        "{ q(func: eq(key, $key)) { uid value } }",
                        {"key": int(k)}, ts=ts)["q"]
                    if f == R:
                        done.append([f, k, recs[0].get("value")
                                     if recs else None])
                    elif f == W:
                        if recs:
                            conn.mutate(ts, set_objs=[
                                {"uid": recs[0]["uid"],
                                 "value": int(v)}])
                        else:
                            conn.mutate(ts, set_objs=[
                                {"key": int(k), "value": int(v)}])
                        done.append([f, k, v])
                    else:
                        raise ValueError(f"unsupported mop {f!r}")
                return done

            done = self.txn(test, run)
            return {**op, "type": "ok", "value": done}

        return self.guard(op, body)


def _w_long_fork(options):
    from ..workloads import long_fork
    w = long_fork.workload()
    return {**w, "client": MopClient()}


def _w_wr(options):
    from ..workloads import cycle_wr
    w = cycle_wr.workload(key_count=4, min_txn_length=2,
                          max_txn_length=4, max_writes_per_key=16,
                          device=options.get("device"))
    return {**w, "client": MopClient(),
            "generator": gen.clients(w["generator"])}


# -- sequential --------------------------------------------------------------

class SequentialClient(_DgraphBase):
    """Subkey chains: write k inserts k_0..k_{n-1} in order, each its
    own txn; read scans them in reverse (sequential.clj:44-88)."""

    def setup(self, test):
        conn = self._conn(test)
        conn.alter("skey: string @index(exact) .")

    def invoke(self, test, op):
        from ..workloads import sequential as seq
        key_count = test.get("key_count") or seq.DEFAULT_KEY_COUNT
        f = op["f"]

        def body():
            if f == "write":
                k = op["value"]
                for sk in seq.subkeys(key_count, k):
                    def run(conn, ts, sk=sk):
                        found = conn.query(
                            "{ q(func: eq(skey, $k)) { uid } }",
                            {"k": sk}, ts=ts)["q"]
                        if not found:
                            conn.mutate(ts, set_objs=[{"skey": sk}])

                    self.txn(test, run)
                return {**op, "type": "ok"}
            if f == "read":
                k, _ = op["value"]
                vs = []
                for sk in reversed(seq.subkeys(key_count, k)):
                    def run(conn, ts, sk=sk):
                        found = conn.query(
                            "{ q(func: eq(skey, $k)) { uid skey } }",
                            {"k": sk}, ts=ts)["q"]
                        return found[0]["skey"] if found else None

                    vs.append(self.txn(test, run))
                return {**op, "type": "ok", "value": [k, vs]}
            raise ValueError(f"unknown op {f!r}")

        return self.guard(op, body)


def _w_sequential(options):
    from ..workloads import sequential
    w = sequential.workload(options)
    return {**w, "client": SequentialClient(),
            "generator": gen.clients(w["generator"])}


WORKLOADS = {
    "bank": _w_bank,
    "delete": _w_delete,
    "long-fork": _w_long_fork,
    "register": _w_register,
    "sequential": _w_sequential,
    "set": _w_set,
    "upsert": _w_upsert,
    "wr": _w_wr,
}

#: the workloads whose checks run kernels: the register's competition race
#: (its device lane) and wr's cycle search
DEVICE_WORKLOADS = ("register", "wr")


def dgraph_test(options: dict) -> dict:
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
        db: jdb.DB = MiniDgraphDB()
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, node))
        client.pin_primary = True
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "dgraph-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "zip":
        db = DgraphDB(options.get("version") or VERSION)
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
        "name": options.get("name") or f"dgraph-{which}-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "upsert_schema": bool(options.get("upsert_schema", True)),
        "nemesis": nemesis,
        "checker": jchecker.compose({
            which: w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": workload_gen,
        **extra,
        **pass_extra,
    }


def dgraph_tests(options: dict):
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
        opts["name"] = f"{options.get('name') or 'dgraph'}-{name}"
        yield dgraph_test(opts)


DGRAPH_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo alpha) or zip (real dgraph "
                 "zero+alpha on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("upsert_schema", metavar="BOOL", default=True,
            parse=lambda s: s not in ("0", "false", "no"),
            help="add @upsert to indexed schemas (--upsert-schema; "
                 "false reproduces the duplicate-uid anomaly)"),
    cli.Opt("pred_count", metavar="N", default=PRED_COUNT, parse=int),
    cli.Opt("per_key_limit", metavar="N", default=60, parse=int),
    cli.Opt("nemesis", metavar="KIND", default="kill",
            help="kill or partition"),
    cli.Opt("sandbox", metavar="DIR", default="dgraph-cluster"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register / wr checks' kernels run (default: "
                 "the card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": dgraph_test,
                           "opt_spec": DGRAPH_OPTS}),
    **cli.test_all_cmd({"tests_fn": dgraph_tests,
                        "opt_spec": DGRAPH_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
