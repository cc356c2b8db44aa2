"""etcd test suite: the tutorial exemplar DB (doc/tutorial semantics of
the reference, jepsen docs build exactly this suite step by step).

DB automation installs an etcd release tarball per node, runs the
daemon with a static initial cluster over the test's nodes, and wires
the full fault surface (db.clj:11-41 protocols: Process kill/start,
Pause, Primary via leader status, LogFiles). The client speaks the
etcd v3 JSON gateway (/v3/kv/range|put|txn) — reads, writes, and
version-free value-compare CAS transactions, with the standard
definite/indefinite error discipline (HTTP error = fail for reads,
info for writes that may have applied).

``server=mini`` runs LIVE in-repo v3-gateway servers (per-key mod
revisions, txn compare/branch semantics, fsync'd revision log with
torn-tail replay) under kill/pause faults, so the tutorial exemplar's
CI exercises real processes; ``server=deb`` (default) is the real
etcd automation.

Reference surfaces: zookeeper/src/jepsen/zookeeper.clj:1-145 (suite
shape), doc/tutorial/02-db.md..05-nemesis.md (etcd automation),
jepsen/src/jepsen/db.clj:11-41 (protocols).

The port's copy of `jepsen_tpu/dbs/etcd.py`. Its own choices: the
client speaks HTTP through the port's `httpclient` (on `http.client`;
the reference's uses `requests`, which the card's machine lacks), its
`RequestException` classified as the reference classifies `requests`';
the mini servers listen from `MINI_BASE_PORT` 30700 (the reference's
from 28500, so that both packages' servers can run on one host at once;
below Linux's ephemeral range, 32768-60999, where a client retrying a
down server's port could connect to itself and hold the port);
`--device`, passed to the `register` checker's competition race (its
device lane runs the WGL chunk kernels) and to the `append` / `wr`
checkers (their cycle search), default the card: a missing card raises
before any node is set up, `--device cpu` runs the plain PyTorch
versions; the store root `store/torch`.

    python -m jepsen_tpu_torch.dbs.etcd test --nodes t1 --server mini \
        --workload register --device cpu --time-limit 5
"""

from __future__ import annotations

import base64
import json
import sys
from typing import Callable, Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import net as jnet
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from . import httpclient, miniserver
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..os_setup import Debian
from ..util import resolve_device
from ..workloads import linearizable_register

VERSION = "3.5.14"
CLIENT_PORT = 2379
PEER_PORT = 2380
DIR = "/opt/etcd"
PIDFILE = f"{DIR}/etcd.pid"
LOGFILE = f"{DIR}/etcd.log"
DATA_DIR = f"{DIR}/data"


def node_url(node: str, port: int) -> str:
    """http://<node>:<port> (tutorial 02-db.md node-url)."""
    return f"http://{node}:{port}"


def peer_url(node: str) -> str:
    return node_url(node, PEER_PORT)


def client_url(node: str) -> str:
    return node_url(node, CLIENT_PORT)


def initial_cluster(test: dict) -> str:
    """The --initial-cluster fragment: n1=http://n1:2380,...
    (tutorial 02-db.md initial-cluster)."""
    return ",".join(f"{n}={peer_url(n)}" for n in test["nodes"])


def tarball_url(version: str) -> str:
    return ("https://github.com/etcd-io/etcd/releases/download/"
            f"v{version}/etcd-v{version}-linux-amd64.tar.gz")


class EtcdDB(jdb.DB, jdb.Process, jdb.Pause, jdb.Primary, jdb.LogFiles):
    """etcd lifecycle (tutorial 02-db.md db; db.clj:11-41)."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, test, node):
        nodeutil.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
            f"{DIR}/etcd",
            "--name", node,
            "--data-dir", DATA_DIR,
            "--listen-peer-urls", peer_url(node),
            "--initial-advertise-peer-urls", peer_url(node),
            "--listen-client-urls",
            f"http://0.0.0.0:{CLIENT_PORT}",
            "--advertise-client-urls", client_url(node),
            "--initial-cluster-state", "new",
            "--initial-cluster", initial_cluster(test),
            "--enable-v2=false")
        nodeutil.await_tcp_port(CLIENT_PORT, timeout_s=60)

    def setup(self, test, node):
        with control.su():
            nodeutil.install_archive(
                tarball_url(self.version), DIR,
                force=bool(test.get("force_reinstall")))
        self._start(test, node)

    def teardown(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("etcd --name")
        with control.su():
            control.exec_("rm", "-rf", DATA_DIR, LOGFILE)

    # -- db.Process --
    def start(self, test, node):
        self._start(test, node)
        return "started"

    def kill(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("etcd --name")
        return "killed"

    # -- db.Pause --
    def pause(self, test, node):
        nodeutil.signal("etcd", "STOP")
        return "paused"

    def resume(self, test, node):
        nodeutil.signal("etcd", "CONT")
        return "resumed"

    # -- db.Primary --
    def primaries(self, test):
        """Nodes reporting themselves leader via `etcdctl endpoint
        status` (probed in parallel, meh'd: a dead node is simply not
        primary)."""

        def probe(t, node):
            return nodeutil.meh(
                control.exec_, f"{DIR}/etcdctl", "--endpoints",
                client_url(node), "endpoint", "status",
                "--write-out", "json")

        out = []
        for node, raw in control.on_nodes(test, probe).items():
            try:
                status = json.loads(raw)[0]
                if status["Status"]["header"]["member_id"] == \
                        status["Status"]["leader"]:
                    out.append(node)
            except (TypeError, ValueError, KeyError, IndexError):
                continue
        return out

    def setup_primary(self, test, node):
        return None

    def log_files(self, test, node):
        return [LOGFILE]


# -- the LIVE mini server ----------------------------------------------------

MINI_BASE_PORT = 30700

MINIETCD_SRC = r'''
import argparse, base64, json, os, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

LOG_PATH = os.path.join(args.dir, "minietcd.jsonl")
LOCK = threading.Lock()
DATA = {}       # key -> (value, mod_revision)
REV = [0]

def log_append(rec):
    with open(LOG_PATH, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
        os.fsync(fh.fileno())

def put(k, v):
    REV[0] += 1
    DATA[k] = (v, REV[0])

def replay():
    if not os.path.exists(LOG_PATH):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                k, v, rev = json.loads(line)
            except ValueError:
                break  # torn tail
            DATA[k] = (v, rev)
            REV[0] = max(REV[0], rev)

def b64(s):
    return base64.b64encode(s.encode()).decode()

def unb64(s):
    return base64.b64decode(s).decode()

def kvs_for(k):
    if k not in DATA:
        return []
    v, rev = DATA[k]
    return [{"key": b64(k), "value": b64(v),
             "mod_revision": str(rev)}]

def compare_holds(cmp):
    k = unb64(cmp["key"])
    if cmp.get("target") == "MOD":
        have = DATA[k][1] if k in DATA else 0
        want = cmp.get("mod_revision", cmp.get("modRevision", 0))
        return have == int(want)
    want = unb64(cmp["value"])
    return k in DATA and DATA[k][0] == want

class H(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _reply(self, obj):
        body = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        req = json.loads(self.rfile.read(n) or b"{}")
        with LOCK:
            if self.path == "/v3/kv/put":
                k, v = unb64(req["key"]), unb64(req["value"])
                put(k, v)
                log_append([k, v, REV[0]])
                self._reply({"header": {}})
            elif self.path == "/v3/kv/range":
                kvs = kvs_for(unb64(req["key"]))
                self._reply({"header": {}, "kvs": kvs,
                             "count": str(len(kvs))})
            elif self.path == "/v3/kv/txn":
                ok = all(compare_holds(c)
                         for c in req.get("compare") or [])
                branch = req.get("success" if ok else "failure") or []
                responses = []
                for o in branch:
                    if "requestPut" in o:
                        pk = unb64(o["requestPut"]["key"])
                        pv = unb64(o["requestPut"]["value"])
                        put(pk, pv)
                        log_append([pk, pv, REV[0]])
                        responses.append({"responsePut": {}})
                    elif "requestRange" in o:
                        kvs = kvs_for(unb64(
                            o["requestRange"]["key"]))
                        responses.append(
                            {"response_range": {"kvs": kvs}})
                self._reply({"header": {}, "succeeded": ok,
                             "responses": responses})
            else:
                self.send_error(404)

replay()
print("minietcd serving on", args.port, flush=True)
ThreadingHTTPServer(("127.0.0.1", args.port), H).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "etcd_ports")


class MiniEtcdDB(miniserver.MiniServerDB):
    """LIVE in-repo v3-gateway servers: per-key mod revisions, txn
    compare/branch semantics, fsync'd revision log with torn-tail
    replay — the tutorial exemplar's CI runs against killable
    processes like the rest of the family."""

    script = "minietcd.py"
    src = MINIETCD_SRC
    pidfile = "minietcd.pid"
    logfile = "minietcd.log"
    data_files = ("minietcd.jsonl",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


class EtcdClient(jclient.Client):
    """CAS-register client over the v3 JSON gateway. Values ride [k v]
    independent tuples; keys are namespaced under /jepsen/.

    `base_url_fn` maps a node name to its client URL — tests point it
    at wire-compatible stub servers on localhost."""

    def __init__(self, base_url_fn: Optional[Callable] = None,
                 timeout: float = 5.0):
        self.base_url_fn = base_url_fn or client_url
        self.timeout = timeout
        self.node: Optional[str] = None
        self.http = None  # httpclient.Session, made per opened client

    def open(self, test, node):
        # type(self): subclasses (bank/set clients) share this open
        c = type(self)(self.base_url_fn, self.timeout)
        c.node = node
        c.http = httpclient.Session()  # keep-alive: one per worker
        return c

    # -- v3 gateway plumbing ------------------------------------------
    def _post(self, path: str, body: dict) -> dict:
        url = self.base_url_fn(self.node) + path
        http = self.http or httpclient
        r = http.post(url, json=body, timeout=self.timeout)
        r.raise_for_status()
        return r.json()

    @staticmethod
    def _b64(s) -> str:
        return base64.b64encode(str(s).encode()).decode()

    @staticmethod
    def _unb64(s: str) -> str:
        return base64.b64decode(s).decode()

    def kv_range(self, key: str):
        res = self._post("/v3/kv/range", {"key": self._b64(key)})
        kvs = res.get("kvs") or []
        return self._unb64(kvs[0]["value"]) if kvs else None

    def kv_put(self, key: str, value) -> None:
        self._post("/v3/kv/put", {"key": self._b64(key),
                                  "value": self._b64(value)})

    def kv_cas(self, key: str, old, new) -> bool:
        """Value-compare transaction: succeeds iff key's current value
        equals `old` (tutorial 03-client.md cas semantics)."""
        res = self._post("/v3/kv/txn", {
            "compare": [{"key": self._b64(key), "target": "VALUE",
                         "result": "EQUAL", "value": self._b64(old)}],
            "success": [{"requestPut": {"key": self._b64(key),
                                        "value": self._b64(new)}}],
            "failure": []})
        return bool(res.get("succeeded"))

    def kv_snapshot(self, keys: list) -> dict:
        """key -> (value, mod_revision) via one read-only txn (the
        success branch of a compare-less txn executes its ranges
        atomically)."""
        res = self._post("/v3/kv/txn", {
            "compare": [],
            "success": [{"requestRange": {"key": self._b64(k)}}
                        for k in keys],
            "failure": []})
        out = {}
        for k, rr in zip(keys, res.get("responses") or []):
            # the real v3 JSON gateway emits snake_case field names;
            # accept camelCase too (proto JSON printers vary)
            rng = rr.get("response_range") or rr.get("responseRange") \
                or {}
            kvs = rng.get("kvs") or []
            if kvs:
                rev = kvs[0].get("mod_revision",
                                 kvs[0].get("modRevision", 0))
                out[k] = (self._unb64(kvs[0]["value"]), int(rev))
            else:
                out[k] = (None, 0)
        return out

    def txn_mops(self, mops: list, retries: int = 8) -> Optional[list]:
        """Execute a micro-op txn atomically via optimistic
        concurrency: snapshot the involved keys with their revisions,
        compute the post-state, then commit guarded by MOD-revision
        compares on every involved key — the standard etcd
        software-transaction recipe. Handles all three mop verbs
        (txn.py): "append" (list append, elle list-append workload),
        "w" (register write, elle wr / long-fork workloads), "r"
        (read: appends see lists, registers see scalars). Values are
        stored as JSON, so one key namespace serves every txn
        workload. Returns the completed mops (reads filled), or None
        if contention exhausted the retries (indefinite: nothing
        committed)."""
        from ..txn import APPEND, R, W
        keys = sorted({f"/jepsen/{k}" for _f, k, _v in mops})
        for _ in range(retries):
            snap = self.kv_snapshot(keys)
            state = {k: (json.loads(v) if v else None)
                     for k, (v, _r) in snap.items()}
            done = []
            writes = set()
            for f, k, v in mops:
                kk = f"/jepsen/{k}"
                if f == APPEND:
                    state[kk] = (state[kk] or []) + [v]
                    writes.add(kk)
                    done.append([f, k, v])
                elif f == W:
                    state[kk] = v
                    writes.add(kk)
                    done.append([f, k, v])
                elif f == R:
                    cur = state[kk]
                    done.append([f, k, list(cur)
                                 if isinstance(cur, list) else cur])
                else:
                    raise ValueError(f"unknown mop verb {f!r}")
            compare = [{"key": self._b64(k), "target": "MOD",
                        "result": "EQUAL",
                        "modRevision": str(snap[k][1])}
                       for k in keys]
            success = [{"requestPut": {
                "key": self._b64(k),
                "value": self._b64(json.dumps(state[k]))}}
                for k in sorted(writes)]
            res = self._post("/v3/kv/txn", {
                "compare": compare, "success": success, "failure": []})
            if res.get("succeeded"):
                return done
        return None

    # -- jepsen client ------------------------------------------------
    @staticmethod
    def _is_mops(v) -> bool:
        from ..txn import is_mop
        return (isinstance(v, list) and len(v) > 0
                and all(is_mop(m) for m in v))

    def invoke(self, test, op):
        f = op["f"]
        if f == "txn" or self._is_mops(op.get("value")):
            # micro-op txns: elle list-append ("txn"), elle wr ("txn"),
            # and long-fork ("write"/"read" carrying mop lists)
            try:
                done = self.txn_mops(op["value"])
            except httpclient.RequestException as e:
                return {**op, "type": "info", "error": str(e)[:200]}
            if done is None:
                return {**op, "type": "fail",
                        "error": "txn contention: retries exhausted"}
            return {**op, "type": "ok", "value": done}
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"etcd wants [k v] tuple values, got {kv!r}")
        k, v = kv
        key = f"/jepsen/{k}"
        try:
            if f == "read":
                cur = self.kv_range(key)
                return {**op, "type": "ok",
                        "value": tuple_(k, None if cur is None
                                        else int(cur))}
            if f == "write":
                self.kv_put(key, v)
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                ok = self.kv_cas(key, old, new)
                return {**op, "type": "ok" if ok else "fail"}
            raise ValueError(f"unknown op {f!r}")
        except httpclient.RequestException as e:
            # indefinite for writes/cas; reads never applied anything
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def close(self, test):
        if self.http is not None:
            self.http.close()


class EtcdBankClient(EtcdClient):
    """Bank workload client: balances as JSON ints under
    /jepsen/bank/<acct>. Reads snapshot every account in ONE read-only
    txn (atomic, so the checker sees consistent totals); transfers
    commit guarded by MOD compares on both accounts with the standard
    retry loop. setup() initializes balances — it runs per node client
    BEFORE the interpreter starts (core.py open_and_setup), and every
    client writes the same values, so the race is idempotent."""

    @staticmethod
    def _acct_key(a) -> str:
        return f"/jepsen/bank/{a}"

    def setup(self, test):
        accounts = test["accounts"]
        total = test["total-amount"]
        per, rem = divmod(total, len(accounts))
        for i, a in enumerate(accounts):
            # the first `rem` accounts carry the remainder, so initial
            # balances sum EXACTLY to total-amount (the checker's
            # conservation invariant)
            self.kv_put(self._acct_key(a),
                        json.dumps(per + (1 if i < rem else 0)))

    def invoke(self, test, op):
        accounts = test["accounts"]
        keys = [self._acct_key(a) for a in accounts]
        try:
            if op["f"] == "read":
                snap = self.kv_snapshot(keys)
                return {**op, "type": "ok",
                        "value": {a: (json.loads(snap[k][0])
                                      if snap[k][0] else None)
                                  for a, k in zip(accounts, keys)}}
            if op["f"] == "transfer":
                t = op["value"]
                src, dst = self._acct_key(t["from"]), \
                    self._acct_key(t["to"])
                for _ in range(8):
                    snap = self.kv_snapshot([src, dst])
                    cur_s = json.loads(snap[src][0] or "0")
                    cur_d = json.loads(snap[dst][0] or "0")
                    if cur_s - t["amount"] < 0 and \
                            not test.get("negative-balances"):
                        return {**op, "type": "fail",
                                "error": "insufficient funds"}
                    res = self._post("/v3/kv/txn", {
                        "compare": [
                            {"key": self._b64(k), "target": "MOD",
                             "result": "EQUAL",
                             "modRevision": str(snap[k][1])}
                            for k in (src, dst)],
                        "success": [
                            {"requestPut": {
                                "key": self._b64(src),
                                "value": self._b64(json.dumps(
                                    cur_s - t["amount"]))}},
                            {"requestPut": {
                                "key": self._b64(dst),
                                "value": self._b64(json.dumps(
                                    cur_d + t["amount"]))}}],
                        "failure": []})
                    if res.get("succeeded"):
                        return {**op, "type": "ok"}
                return {**op, "type": "fail",
                        "error": "transfer contention"}
            raise ValueError(f"unknown op {op['f']!r}")
        except httpclient.RequestException as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class EtcdSetClient(EtcdClient):
    """Set workload client: one JSON list at /jepsen/set, adds via the
    MOD-compare retry loop, the final read returns the whole list."""

    SET_KEY = "/jepsen/set"

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                for _ in range(16):
                    snap = self.kv_snapshot([self.SET_KEY])
                    cur = json.loads(snap[self.SET_KEY][0] or "[]")
                    res = self._post("/v3/kv/txn", {
                        "compare": [
                            {"key": self._b64(self.SET_KEY),
                             "target": "MOD", "result": "EQUAL",
                             "modRevision":
                                 str(snap[self.SET_KEY][1])}],
                        "success": [{"requestPut": {
                            "key": self._b64(self.SET_KEY),
                            "value": self._b64(json.dumps(
                                cur + [op["value"]]))}}],
                        "failure": []})
                    if res.get("succeeded"):
                        return {**op, "type": "ok"}
                return {**op, "type": "fail",
                        "error": "add contention"}
            if op["f"] == "read":
                cur = self.kv_range(self.SET_KEY)
                return {**op, "type": "ok",
                        "value": json.loads(cur) if cur else []}
            raise ValueError(f"unknown op {op['f']!r}")
        except httpclient.RequestException as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


# The workload matrix (tidb/src/tidb/core.clj:32-45 pattern: a map of
# name -> workload builder; each returns {"checker", "generator",
# "client", extra-test-keys...}). `wrap_time` = False when the
# workload's generator manages its own phases (sets: add-then-read).
def _w_register(options):
    w = linearizable_register.workload(
        {"nodes": options["nodes"],
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 100,
         "algorithm": "competition",
         "device": options.get("device")})
    return {**w, "client": EtcdClient()}


def _w_append(options):
    from ..workloads import cycle_append
    w = cycle_append.workload(anomalies=("G0", "G1", "G2"),
                              additional_graphs=("realtime",),
                              device=options.get("device"))
    return {**w, "client": EtcdClient()}


def _w_wr(options):
    from ..workloads import cycle_wr
    w = cycle_wr.workload(linearizable_keys=True,
                          device=options.get("device"))
    return {**w, "client": EtcdClient()}


def _w_bank(options):
    from ..workloads import bank
    w = bank.workload(options)
    return {**w, "client": EtcdBankClient()}


def _w_sets(options):
    from ..workloads import sets
    w = sets.workload({"time_limit":
                       max(1, (options.get("time_limit") or 30) - 2)})
    return {**w, "client": EtcdSetClient(), "wrap_time": False}


def _w_long_fork(options):
    from ..workloads import long_fork
    w = long_fork.workload()
    return {**w, "client": EtcdClient()}


def _w_monotonic(options):
    from ..workloads import monotonic
    w = monotonic.workload()
    return {**w, "client": EtcdMonotonicClient()}


def _w_sequential(options):
    from ..workloads import sequential
    # writers take half the worker threads so readers always exist
    n_writers = max(1, int(options["concurrency"]) // 2)
    w = sequential.workload({"n_writers": n_writers})
    return {**w, "client": EtcdSeqClient()}


WORKLOADS = {
    "register": _w_register,
    "append": _w_append,
    "wr": _w_wr,
    "bank": _w_bank,
    "sets": _w_sets,
    "long-fork": _w_long_fork,
    "monotonic": _w_monotonic,
    "sequential": _w_sequential,
}

NEMESES = {
    "partition": lambda db: jnemesis.partition_random_halves(),
    "kill": lambda db: jnemesis.node_start_stopper(
        lambda nodes: [gen.RNG.choice(nodes)],
        lambda test, node: db.kill(test, node),
        lambda test, node: db.start(test, node)),
    "pause": lambda db: jnemesis.node_start_stopper(
        lambda nodes: [gen.RNG.choice(nodes)],
        lambda test, node: db.pause(test, node),
        lambda test, node: db.resume(test, node)),
    "none": lambda db: jnemesis.Nemesis(),
}


class EtcdMonotonicClient(EtcdClient):
    """Monotonic workload client (tidb/monotonic.clj contract): inc is
    a read-modify-write over a key group, committed atomically behind
    MOD-revision compares (the optimistic recipe); reads snapshot the
    group in one txn."""

    @staticmethod
    def _key(k) -> str:
        return f"/jepsen/mono/{k}"

    def invoke(self, test, op):
        ks = sorted(op["value"])
        keys = [self._key(k) for k in ks]
        try:
            if op["f"] == "inc":
                for _ in range(8):
                    snap = self.kv_snapshot(keys)
                    new = {k: (int(snap[kk][0]) if snap[kk][0]
                               else 0) + 1
                           for k, kk in zip(ks, keys)}
                    res = self._post("/v3/kv/txn", {
                        "compare": [
                            {"key": self._b64(kk), "target": "MOD",
                             "result": "EQUAL",
                             "modRevision": str(snap[kk][1])}
                            for kk in keys],
                        "success": [{"requestPut": {
                            "key": self._b64(self._key(k)),
                            "value": self._b64(new[k])}}
                            for k in ks],
                        "failure": []})
                    if res.get("succeeded"):
                        return {**op, "type": "ok", "value": new}
                return {**op, "type": "fail",
                        "error": "inc contention"}
            if op["f"] == "read":
                snap = self.kv_snapshot(keys)
                # missing -> -1 (the workload contract): an "absent"
                # observation must still order against later values —
                # None would be skipped by the checker entirely
                return {**op, "type": "ok",
                        "value": {k: (int(snap[kk][0])
                                      if snap[kk][0] else -1)
                                  for k, kk in zip(ks, keys)}}
            raise ValueError(f"unknown op {op['f']!r}")
        except httpclient.RequestException as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class EtcdSeqClient(EtcdClient):
    """Sequential workload client (workloads.sequential contract,
    tidb/sequential.clj): writes insert key k's subkeys IN ORDER as
    separate puts; reads fetch them in REVERSE — a store that shows a
    later subkey without an earlier one violates sequential
    consistency (trailing-nil)."""

    def invoke(self, test, op):
        from ..workloads.sequential import DEFAULT_KEY_COUNT, subkeys
        kc = test.get("key_count") or DEFAULT_KEY_COUNT
        try:
            if op["f"] == "write":
                for sk in subkeys(kc, op["value"]):
                    self.kv_put(f"/jepsen/seq/{sk}", 1)
                return {**op, "type": "ok"}
            if op["f"] == "read":
                k = op["value"][0]
                out = []
                for sk in reversed(subkeys(kc, k)):
                    cur = self.kv_range(f"/jepsen/seq/{sk}")
                    out.append(None if cur is None else sk)
                return {**op, "type": "ok", "value": [k, out]}
            raise ValueError(f"unknown op {op['f']!r}")
        except httpclient.RequestException as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


def etcd_test(options: dict) -> dict:
    """Full test map from CLI options (zookeeper.clj zk-test shape).
    `workload`: one of WORKLOADS (register, append, wr, bank, sets,
    long-fork, monotonic, sequential — tidb's workload list);
    `nemesis`: one of NEMESES (partition, kill, pause, none) — the
    tidb-style matrix both axes of `test-all` sweep. The register
    checker's device lane and the append / wr checkers' kernels run on
    `options["device"]` (default the card), resolved here, so that a
    missing card raises before any node is set up."""
    options = {**options, "device": resolve_device(options.get("device"))}
    nodes = options["nodes"]
    mode = options.get("server") or "deb"
    db: jdb.DB = (MiniEtcdDB() if mode == "mini"
                  else EtcdDB(options.get("version") or VERSION))
    which = options.get("workload") or "register"
    try:
        w = WORKLOADS[which](options)
    except KeyError:
        raise ValueError(f"unknown workload {which!r}; have "
                         f"{sorted(WORKLOADS)}") from None
    nem_name = options.get("nemesis") or (
        "kill" if mode == "mini" else "partition")
    if mode == "mini" and nem_name == "partition":
        raise ValueError("mini mode has no network to partition; "
                         "use kill/pause/none")
    if mode == "mini" and nem_name in ("kill", "pause"):
        # mini clients pin the primary's store (the galera-family
        # one-logical-store convention): faults must hit THAT node,
        # not a random idle placeholder
        if nem_name == "kill":
            nemesis = jnemesis.node_start_stopper(
                lambda ns: [ns[0]],
                lambda test, node: db.kill(test, node),
                lambda test, node: db.start(test, node))
        else:
            nemesis = jnemesis.node_start_stopper(
                lambda ns: [ns[0]],
                lambda test, node: db.pause(test, node),
                lambda test, node: db.resume(test, node))
        nem_name_resolved = True
    else:
        nem_name_resolved = False
    if not nem_name_resolved:
        try:
            nemesis = NEMESES[nem_name](db)
        except KeyError:
            raise ValueError(f"unknown nemesis {nem_name!r}; have "
                             f"{sorted(NEMESES)}") from None
    interval = options.get("nemesis_interval") or 5.0
    workload_gen = w["generator"]
    time_limit = options.get("time_limit") or 30
    if nem_name != "none":
        nem_gen = gen.cycle([gen.sleep(interval),
                             {"type": "info", "f": "start"},
                             gen.sleep(interval),
                             {"type": "info", "f": "stop"}])
        if not w.get("wrap_time", True):
            # the workload manages its own phases (sets: add-then-
            # final-read) so no outer time_limit bounds the run — the
            # infinite nemesis cycle must bound itself or the test
            # never ends
            nem_gen = gen.time_limit(time_limit, nem_gen)
        workload_gen = gen.nemesis(nem_gen, workload_gen)
    if w.get("wrap_time", True):
        workload_gen = gen.time_limit(time_limit, workload_gen)
    extra = {k: v for k, v in w.items()
             if k not in ("checker", "generator", "client",
                          "wrap_time")}
    if mode == "mini":
        client = w["client"]
        # the primary holds the one logical store; honor etcd_ports
        # overrides the server side (node_port) also honors
        client.base_url_fn = lambda node, _test={"nodes": nodes,
                                                 **options}: (
            "http://127.0.0.1:%d"
            % mini_node_port(_test, nodes[0]))
        extra.update({
            "remote": localexec.remote(options.get("sandbox")
                                       or "etcd-cluster"),
            "ssh": {"dummy?": False},
        })
    else:
        extra.update({"ssh": options.get("ssh") or {},
                      "os": Debian(), "net": jnet.iptables()})
    return {
        "name": options.get("name")
                or f"etcd-{which}-{nem_name}-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": w["client"],
        "nemesis": nemesis,
        # No gating stats checker: a short run where some op type
        # never succeeds (e.g. every cas misses) would flap invalid.
        "checker": jchecker.compose({
            which: w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": workload_gen,
        **extra,
    }


def etcd_tests(options: dict):
    """tests_fn for `test-all`: the cartesian workload x nemesis sweep
    (tidb/src/tidb/core.clj:46-120 test-all pattern). `--workload` /
    `--nemesis` restrict either axis; defaults sweep everything."""
    workloads = ([options["workload"]] if options.get("workload")
                 else sorted(WORKLOADS))
    nemeses = ([options["nemesis"]] if options.get("nemesis")
               else sorted(NEMESES))
    if (options.get("server") or "deb") == "mini":
        # no network to partition over localexec: sweep the rest
        nemeses = [n for n in nemeses if n != "partition"] or ["kill"]
    for which in workloads:
        for nem in nemeses:
            opts = dict(options, workload=which, nemesis=nem)
            opts["name"] = (f"{options.get('name') or 'etcd'}"
                            f"-{which}-{nem}")
            yield etcd_test(opts)


ETCD_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Where to write results"),
    cli.Opt("version", metavar="VERSION", default=VERSION,
            help="etcd release to install"),
    cli.Opt("server", metavar="MODE", default="deb",
            help="deb (real etcd on --ssh nodes) or mini (live "
                 "in-repo v3-gateway servers, kill/pause faults)"),
    cli.Opt("sandbox", metavar="DIR", default="etcd-cluster"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))} "
                 "(test: default register; test-all: sweeps all)"),
    cli.Opt("nemesis", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(NEMESES))} "
                 "(test: default partition; test-all: sweeps all)"),
    cli.Opt("per_key_limit", metavar="N", default=100, parse=int,
            help="Ops per key"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=5.0,
            parse=float,
            help="Seconds between partition start/stop"),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register / append / wr checks' kernels run "
                 "(default: the card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": etcd_test,
                           "opt_spec": ETCD_OPTS}),
    **cli.test_all_cmd({"tests_fn": etcd_tests,
                        "opt_spec": ETCD_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
