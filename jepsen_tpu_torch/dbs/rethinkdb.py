"""RethinkDB test suite — the document-store-with-topology family
(rethinkdb/src/jepsen/rethinkdb{,/document_cas}.clj, 529 LoC).

The reference suite is document-level compare-and-set under two axes
the others don't have: **durability tuning** (write_acks
single/majority via `rethinkdb.table_config`, read_mode
single/majority per TABLE term — document_cas.clj:31-47,76) and a
**reconfigure nemesis** that reshuffles replica topology THROUGH THE
CLIENT PROTOCOL mid-test (rethinkdb.clj:180-240) — faults injected
as admin queries, not process signals.

Everything on the wire is a FROM-SCRATCH ReQL subset: the V0_4
handshake (magic 0x400c2d20, auth-key frame, JSON protocol word,
"SUCCESS" gate), token+length framed JSON queries, and real ReQL
term ASTs — DB=14 / TABLE=15 / GET=16 / GET_FIELD=31 / INSERT=56 /
UPDATE=53 / BRANCH=65 / EQ=17 / FUNC=69 / VAR=10 / ERROR=12 /
DEFAULT=92 / RECONFIGURE=176 — the exact terms the reference client
builds via rethinkdb.query (document_cas.clj:74-106):

- read  = DEFAULT(GET_FIELD(GET(table{read_mode}, k), "val"), nil)
- write = INSERT(table, {id, val}, conflict=update)
- cas   = UPDATE(row, FUNC(r -> BRANCH(EQ(GET_FIELD(r,"val"), old),
          {val: new}, ERROR("abort")))) — ok iff errors=0 and
          replaced=1.

``mini`` mode (default) runs LIVE in-repo servers interpreting that
term subset over an fsync'd op log (kill -9 recovery) via localexec;
``deb`` emits the real rethinkdb automation (apt repo, join-lines
config, --bind all daemon — rethinkdb.clj:52-95), command-assertion
tested. `test-all` sweeps the reference's (write_acks, read_mode)
matrix plus the reconfigure variant.

The port's copy of `jepsen_tpu/dbs/rethinkdb.py`. Its own choices: the
mini servers listen from `MINI_BASE_PORT` 31800 (the reference's from
27900, so that both packages' servers can run on one host at once; below
Linux's ephemeral range, 32768-60999; `deb` mode keeps RethinkDB's `PORT`
28015); `--device` on `test` and `test-all`, passed to the register's
competition race, whose device lane runs the WGL chunk kernels (default
the card: a missing card raises before any node is set up, `--device cpu`
runs their plain PyTorch versions); the store root `store/torch`.
`MINIRETHINK_SRC` is the reference's, byte for byte.

    python -m jepsen_tpu_torch.dbs.rethinkdb test --nodes r1 \
        --time-limit 8 --device cpu
"""

from __future__ import annotations

import json
import socket
import struct
import sys

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..os_setup import Debian
from ..util import resolve_device
from . import miniserver, retryclient

VERSION = "2.1.5+2~0jessie"  # reference era (rethinkdb.clj:52)
PORT = 28015
MINI_BASE_PORT = 31800

V0_4 = 0x400C2D20
PROTO_JSON = 0x7E6970C7

# ReQL term constants (the real protocol numbers)
MAKE_ARRAY, DB, TABLE, GET, EQ = 2, 14, 15, 16, 17
GET_FIELD, UPDATE, INSERT = 31, 53, 56
BRANCH, FUNC, VAR, ERROR, DEFAULT = 65, 69, 10, 12, 92
RECONFIGURE = 176

START = 1
SUCCESS_ATOM = 1
RUNTIME_ERROR = 18


class ReqlError(Exception):
    pass


# -- term builders (rethinkdb.query equivalents) ------------------------------

def t_table(db: str, table: str, read_mode=None) -> list:
    opts = {"read_mode": read_mode} if read_mode else {}
    term = [TABLE, [[DB, [db]], table]]
    if opts:
        term.append(opts)
    return term


def t_read(db, table, key, read_mode=None) -> list:
    """DEFAULT(GET_FIELD(GET(tbl, k), "val"), nil)
    (document_cas.clj:74-88)."""
    row = [GET, [t_table(db, table, read_mode), key]]
    return [DEFAULT, [[GET_FIELD, [row, "val"]], None]]


def t_write(db, table, key, value) -> list:
    return [INSERT, [t_table(db, table), {"id": key, "val": value}],
            {"conflict": "update"}]


def t_cas(db, table, key, old, new, read_mode=None) -> list:
    """UPDATE(row, r -> BRANCH(EQ(r.val, old), {val:new},
    ERROR("abort"))) (document_cas.clj:93-102)."""
    row = [GET, [t_table(db, table, read_mode), key]]
    fn = [FUNC, [[MAKE_ARRAY, [1]],
                 [BRANCH, [[EQ, [[GET_FIELD, [[VAR, [1]], "val"]],
                                 old]],
                           {"val": new},
                           [ERROR, ["abort"]]]]]]
    return [UPDATE, [row, fn]]


def t_write_acks(write_acks: str, nodes: list) -> list:
    """Admin update to rethinkdb.table_config
    (document_cas.clj:31-40)."""
    return [UPDATE, [t_table("rethinkdb", "table_config"),
                     {"write_acks": write_acks,
                      "shards": [{"primary_replica": nodes[0],
                                  "replicas": list(nodes)}]}]]


def t_reconfigure(db, table, primary: str, replicas: list) -> list:
    """r.table(...).reconfigure(...) (rethinkdb.clj:180-193)."""
    return [RECONFIGURE, [t_table(db, table)],
            {"shards": 1,
             "replicas": {r: 1 for r in replicas},
             "primary_replica_tag": primary}]


class ReqlConn:
    """One V0_4 connection: magic + empty auth key + JSON protocol
    word, then token/length-framed JSON queries."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.rf = self.sock.makefile("rb")
        self.token = 0
        self.sock.sendall(struct.pack("<I", V0_4)
                          + struct.pack("<I", 0)
                          + struct.pack("<I", PROTO_JSON))
        gate = b""
        while not gate.endswith(b"\x00"):
            b = self.rf.read(1)
            if not b:
                raise ConnectionError("handshake EOF")
            gate += b
        if not gate.startswith(b"SUCCESS"):
            raise ReqlError(gate.decode(errors="replace"))

    def run(self, term) -> object:
        """START a query, return the single datum; RUNTIME_ERROR
        raises ReqlError."""
        self.token += 1
        q = json.dumps([START, term, {}]).encode()
        self.sock.sendall(struct.pack("<Q", self.token)
                          + struct.pack("<I", len(q)) + q)
        hdr = self.rf.read(12)
        if len(hdr) < 12:
            raise ConnectionError("short response header")
        n = struct.unpack("<I", hdr[8:12])[0]
        body = self.rf.read(n)
        if len(body) < n:
            raise ConnectionError("short response body")
        resp = json.loads(body)
        if resp["t"] == RUNTIME_ERROR:
            raise ReqlError(str(resp.get("r", ["?"])[0]))
        if resp["t"] != SUCCESS_ATOM:
            raise ReqlError(f"response type {resp['t']}")
        return resp["r"][0]

    def close(self):
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


# -- the LIVE mini server -----------------------------------------------------

MINIRETHINK_SRC = r'''
import argparse, json, os, socketserver, struct, threading

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

LOG_PATH = os.path.join(args.dir, "minirethink.jsonl")
TABLES, LOCK = {}, threading.Lock()   # (db, table) -> {id: row}
ADMIN = {"write_acks": "majority", "topology": None}

def replay():
    if not os.path.exists(LOG_PATH):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail after a crash
            TABLES.setdefault((rec["d"], rec["t"]), {})[rec["k"]] \
                = rec["row"]

def persist(d, t, k, row):
    with open(LOG_PATH, "a") as fh:
        fh.write(json.dumps({"d": d, "t": t, "k": k, "row": row})
                 + "\n")
        fh.flush()
        os.fsync(fh.fileno())

def table_ref(term):
    # [15, [[14, [db]], name]] (+opts) -> (db, name, opts)
    assert term[0] == 15, term
    db = term[1][0][1][0]
    opts = term[2] if len(term) > 2 else {}
    return db, term[1][1], opts

def eval_row_term(term):
    # [16, [table, key]] -> (db, table, key)
    assert term[0] == 16, term
    d, t, _ = table_ref(term[1][0])
    return d, t, term[1][1]

def apply_query(term):
    op = term[0]
    if op == 92:   # DEFAULT(GET_FIELD(GET(...), f), fallback)
        inner, fallback = term[1]
        d, t, k = eval_row_term(inner[1][0])
        field = inner[1][1]
        with LOCK:
            row = TABLES.get((d, t), {}).get(str(k))
        return row.get(field, fallback) if row else fallback
    if op == 56:   # INSERT(table, doc, {conflict})
        d, t, _ = table_ref(term[1][0])
        doc = term[1][1]
        k = str(doc["id"])
        with LOCK:
            tbl = TABLES.setdefault((d, t), {})
            existed = k in tbl
            tbl[k] = dict(doc)
            persist(d, t, k, tbl[k])
        return {"inserted": 0 if existed else 1,
                "replaced": 1 if existed else 0, "errors": 0}
    if op == 53:   # UPDATE(target, obj-or-func)
        target, body = term[1][0], term[1][1]
        if target[0] == 15:   # admin table update
            d, t, _ = table_ref(target)
            if d == "rethinkdb":
                if isinstance(body, dict):
                    ADMIN.update({kk: vv for kk, vv in body.items()
                                  if kk in ("write_acks", "shards")})
                return {"replaced": 1, "errors": 0}
            return {"replaced": 0, "errors": 0}
        d, t, k = eval_row_term(target)
        k = str(k)
        with LOCK:
            tbl = TABLES.setdefault((d, t), {})
            row = tbl.get(k)
            if isinstance(body, dict):
                if row is None:
                    return {"replaced": 0, "skipped": 1, "errors": 0}
                row.update(body)
                persist(d, t, k, row)
                return {"replaced": 1, "errors": 0}
            # FUNC branch: the cas shape
            # [69, [[2,[v]], [65, [[17, [[31,[[10,[v]],f]], old]],
            #                      {f: new}, [12,[msg]]]]]]
            branch = body[1][1]
            assert branch[0] == 65, branch
            cond, then, els = branch[1]
            field = cond[1][0][1][1]
            old = cond[1][1]
            cur = row.get(field) if row else None
            if row is not None and cur == old:
                row.update(then)
                persist(d, t, k, row)
                return {"replaced": 1, "errors": 0}
            return {"replaced": 0, "errors": 1,
                    "first_error": els[1][0]}
    if op == 176:  # RECONFIGURE: acknowledged, topology recorded
        opts = term[2] if len(term) > 2 else {}
        with LOCK:
            ADMIN["topology"] = opts
        return {"reconfigured": 1}
    raise ValueError("unsupported term %r" % op)

class Conn(socketserver.StreamRequestHandler):
    def handle(self):
        magic = self.rfile.read(4)
        if len(magic) < 4 or struct.unpack("<I", magic)[0] != \
                __V04_MAGIC__:
            return
        alen = struct.unpack("<I", self.rfile.read(4))[0]
        self.rfile.read(alen)
        self.rfile.read(4)  # protocol word
        self.wfile.write(b"SUCCESS\x00")
        self.wfile.flush()
        while True:
            hdr = self.rfile.read(12)
            if len(hdr) < 12:
                return
            token = hdr[:8]
            n = struct.unpack("<I", hdr[8:12])[0]
            raw = self.rfile.read(n)
            if len(raw) < n:
                return
            q = json.loads(raw)
            try:
                out = {"t": 1, "r": [apply_query(q[1])]}
            except Exception as e:
                out = {"t": 18, "r": [str(e)[:150]]}
            body = json.dumps(out).encode()
            self.wfile.write(token + struct.pack("<I", len(body))
                             + body)
            self.wfile.flush()

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

replay()
print("minirethink serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Conn).serve_forever()
'''.replace("__V04_MAGIC__", str(V0_4))


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "rethinkdb_ports")


class MiniRethinkDB(miniserver.MiniServerDB):
    script = "minirethink.py"
    src = MINIRETHINK_SRC
    pidfile = "minirethink.pid"
    logfile = "minirethink.out"
    data_files = ("minirethink.jsonl",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


class RethinkDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real automation (rethinkdb.clj install!:52-65,
    configure!:75-87, start!:89-95): apt repo install, join-lines
    config, --bind all daemon."""

    def __init__(self, version: str = VERSION):
        self.version = version

    @staticmethod
    def config(test: dict, node: str) -> str:
        joins = "\n".join(f"join={n}:29015" for n in test["nodes"]
                          if n != node)
        return (f"bind=all\nserver-name={node}\n"
                f"directory=/var/lib/rethinkdb/jepsen\n{joins}\n")

    def setup(self, test, node):
        with control.su():
            control.exec_("apt-get", "install", "-y",
                          f"rethinkdb={self.version}")
            nodeutil.write_file(
                self.config(test, node),
                "/etc/rethinkdb/instances.d/jepsen.conf")
            control.exec_("service", "rethinkdb", "start")
        nodeutil.await_tcp_port(PORT, timeout_s=120)

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf",
                          control.lit("/var/lib/rethinkdb/jepsen/*"))

    def start(self, test, node):
        with control.su():
            control.exec_("service", "rethinkdb", "start")
        return "started"

    def kill(self, test, node):
        with control.su():
            nodeutil.meh(control.exec_, "service", "rethinkdb",
                         "stop")
            nodeutil.grepkill("rethinkdb")
        return "killed"

    def log_files(self, test, node):
        return ["/var/log/rethinkdb"]


# -- client -------------------------------------------------------------------

class RethinkCasClient(retryclient.RetryClient):
    """Document CAS over independent [k v] tuples
    (document_cas.clj:53-106). The write_acks/read_mode axes ride
    the test map; table setup runs the admin write-acks update the
    reference performs (:31-40)."""

    DB_NAME = "jepsen"
    TBL = "cas"

    default_port = PORT
    retry_excs = (OSError, ReqlError)

    def _connect(self, host, port) -> ReqlConn:
        return ReqlConn(host, port, timeout=self.timeout)

    def setup(self, test):
        conn = self._conn(test)
        conn.run(t_write_acks(test.get("write_acks") or "majority",
                              test["nodes"]))

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, v = kv
        f = op["f"]
        read_mode = test.get("read_mode") or "majority"
        try:
            conn = self._conn(test)
            if f == "read":
                out = conn.run(t_read(self.DB_NAME, self.TBL, str(k),
                                      read_mode))
                return {**op, "type": "ok", "value": tuple_(k, out)}
            if f == "write":
                res = conn.run(t_write(self.DB_NAME, self.TBL,
                                       str(k), int(v)))
                if res.get("errors"):
                    raise ReqlError(str(res))
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                res = conn.run(t_cas(self.DB_NAME, self.TBL, str(k),
                                     old, int(new), read_mode))
                won = (res.get("errors") == 0
                       and res.get("replaced") == 1)
                return {**op, "type": "ok" if won else "fail"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, ReqlError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


# -- the reconfigure nemesis --------------------------------------------------

class ReconfigureNemesis(jnemesis.Nemesis):
    """rethinkdb.clj:196-240: on f=reconfigure, pick a random
    replica set + primary and issue r.reconfigure THROUGH the client
    protocol — topology churn as data-plane traffic. Composes with
    process faults via nemesis.compose."""

    def __init__(self, db_name: str, table: str, conn_fn=None):
        self.db_name = db_name
        self.table = table
        self.conn_fn = conn_fn or (lambda test, node:
                                   ReqlConn(node, PORT))

    def setup(self, test):
        return self

    def invoke(self, test, op):
        if op["f"] != "reconfigure":
            raise ValueError(f"unknown nemesis op {op['f']!r}")
        nodes = list(test["nodes"])
        k = gen.RNG.randrange(len(nodes)) + 1
        replicas = gen.RNG.sample(nodes, k)
        primary = gen.RNG.choice(replicas)
        try:
            conn = self.conn_fn(test, primary)
            try:
                res = conn.run(t_reconfigure(
                    self.db_name, self.table, primary, replicas))
            finally:
                conn.close()
            return {**op, "type": "info",
                    "value": {"primary": primary,
                              "replicas": replicas,
                              "reconfigured":
                              res.get("reconfigured")}}
        except (OSError, ConnectionError, ReqlError) as e:
            return {**op, "type": "info",
                    "value": {"error": str(e)[:200]}}

    def teardown(self, test):
        pass


# -- test maps ----------------------------------------------------------------

#: the reference's durability matrix (document_cas.clj cas-test
#: callers): write_acks x read_mode
AXES = [("single", "single"), ("majority", "single"),
        ("majority", "majority")]


def rethinkdb_test(options: dict) -> dict:
    """The register's check runs its kernels on `options["device"]`
    (default the card), resolved here, so that a missing card raises
    before any node is set up."""
    device = resolve_device(options.get("device"))
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    write_acks = options.get("write_acks") or "majority"
    read_mode = options.get("read_mode") or "majority"
    reconfigure = bool(options.get("reconfigure"))

    from ..workloads import linearizable_register
    w = linearizable_register.workload(
        {"nodes": nodes,
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 100,
         "algorithm": "competition",
         "device": device})
    client = RethinkCasClient()

    if mode == "mini":
        db: jdb.DB = MiniRethinkDB()
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, test["nodes"][0]))
        conn_fn = lambda test, node: ReqlConn(
            "127.0.0.1", mini_node_port(test, test["nodes"][0]))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "rethinkdb-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "deb":
        db = RethinkDB(options.get("version") or VERSION)
        conn_fn = lambda test, node: ReqlConn(node, PORT)
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    kill_nemesis = jnemesis.node_start_stopper(
        retryclient.kill_targets(mode),
        lambda test, node: db.kill(test, node),
        lambda test, node: db.start(test, node))
    interval = options.get("nemesis_interval") or 3.0
    base_cycle = [gen.sleep(interval),
                  {"type": "info", "f": "start"},
                  gen.sleep(interval),
                  {"type": "info", "f": "stop"}]
    if reconfigure:
        # interpose reconfigure between every fault transition
        # (cas-reconfigure-test, document_cas.clj:150-182)
        nemesis = jnemesis.compose({
            frozenset(["reconfigure"]):
                ReconfigureNemesis(RethinkCasClient.DB_NAME,
                                   RethinkCasClient.TBL, conn_fn),
            frozenset(["start", "stop"]): kill_nemesis,
        })
        cycle = [gen.sleep(interval),
                 {"type": "info", "f": "reconfigure"},
                 {"type": "info", "f": "start"},
                 gen.sleep(interval),
                 {"type": "info", "f": "reconfigure"},
                 {"type": "info", "f": "stop"}]
    else:
        nemesis = kill_nemesis
        cycle = base_cycle

    name = options.get("name") or (
        f"rethinkdb-{'reconfigure' if reconfigure else 'cas'}-"
        f"w{write_acks}-r{read_mode}-{mode}")
    return {
        "name": name,
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "nemesis": nemesis,
        "write_acks": write_acks,
        "read_mode": read_mode,
        "checker": jchecker.compose({
            "register": w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": gen.time_limit(
            options.get("time_limit") or 10,
            gen.nemesis(gen.cycle(cycle), w["generator"])),
        **{k: v for k, v in w.items()
           if k not in ("checker", "generator", "client")},
        **extra,
    }


def rethinkdb_tests(options: dict):
    """test-all: the durability matrix plus the reconfigure
    variant. An explicit --name becomes the prefix (sibling suites'
    pattern), keeping per-test store directories distinct."""
    base = options.get("name")
    for write_acks, read_mode in AXES:
        opts = dict(options, write_acks=write_acks,
                    read_mode=read_mode)
        if base:
            opts["name"] = f"{base}-w{write_acks}-r{read_mode}"
        yield rethinkdb_test(opts)
    opts = dict(options, reconfigure=True)
    if base:
        opts["name"] = f"{base}-reconfigure"
    yield rethinkdb_test(opts)


RETHINKDB_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo ReQL servers) or deb (real "
                 "rethinkdb on --ssh nodes)"),
    cli.Opt("write_acks", metavar="MODE", default="majority",
            help="single or majority"),
    cli.Opt("read_mode", metavar="MODE", default="majority",
            help="single or majority"),
    cli.Opt("reconfigure", metavar="BOOL", default=False,
            parse=lambda s: s in ("true", "1", "yes"),
            help="add the topology-churn nemesis"),
    cli.Opt("per_key_limit", metavar="N", default=100, parse=int),
    cli.Opt("sandbox", metavar="DIR", default="rethinkdb-cluster"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's kernels run (default: the "
                 "card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": rethinkdb_test,
                           "opt_spec": RETHINKDB_OPTS}),
    **cli.test_all_cmd({"tests_fn": rethinkdb_tests,
                        "opt_spec": RETHINKDB_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
