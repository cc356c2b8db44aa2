"""MongoDB test suite — the document-store family exemplar
(reference: mongodb-rocks/src/jepsen/mongodb_rocks.clj and
mongodb-smartos/src/jepsen/mongodb_smartos/document_cas.clj).

The wire layer is from scratch: a BSON subset codec (int32/int64/
double/string/document/array/bool/null — everything the suite's
commands touch) and OP_MSG framing (the modern mongo wire protocol:
message header + flagBits + one kind-0 body section). On top of it,
the reference's document-CAS semantics (document_cas.clj:50-82):

- read  — `find` by _id (primary read preference),
- write — `update` by _id with upsert,
- cas   — `update` filtered on {_id, value: old}: nModified tells
  whether the compare won (0 = fail, 1 = ok) — mongo's conditional
  update IS the compare-and-set.

Write/read concerns ride the command documents (`writeConcern:
{w: majority}`), matching the reference's WriteConcern knobs. Ops use
[k v] independent tuples (one document per key in jepsen.registers).

DB automation: deb-package install (mongodb_rocks.clj:29-38 pattern),
mongod --replSet daemon per node, and replica-set initiation issued
over this module's own wire client as `replSetInitiate` against the
primary (the reference drives the same command through monger).
``server=mini`` (default) runs LIVE in-repo OP_MSG servers (fsync'd
mutation log, crash-safe replay) under a kill nemesis — CI exercises
the real wire + automation + recovery; ``server=deb`` is the real
replica set under partition-random-halves, with the mongodb-rocks
``storage_engine`` axis and the mongodb-smartos ``os=smartos`` path.

The port's copy of `jepsen_tpu/dbs/mongodb.py`. Its own choices: the
mini servers listen from `MINI_BASE_PORT` 31000 (the reference's from
28100, so that both packages' clusters can run on one host at once;
below Linux's ephemeral range, 32768-60999; `deb` mode keeps mongod's
`PORT` 27017); `--device`, passed to the register workload's
competition race, whose device lane runs the WGL chunk kernels there
(default the card: a missing card raises before any node is set up,
`--device cpu` runs the plain PyTorch versions; the logger workload's
checker runs on the host and takes no device); the store root
`store/torch`.

    python -m jepsen_tpu_torch.dbs.mongodb test --nodes m1 --server mini \
        --device cpu --time-limit 8
"""

from __future__ import annotations

import socket
import struct
import sys
import threading
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import net as jnet
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..os_setup import Debian, SmartOS
from ..util import resolve_device
from ..workloads import linearizable_register
from . import miniserver

VERSION = "3.2.0"
PORT = 27017
DEB_URL = ("https://repo.mongodb.org/apt/debian/dists/jessie/mongodb-org"
           "/{v}/main/binary-amd64/mongodb-org-server_{v}_amd64.deb")
PIDFILE = "/var/run/mongod.pid"
LOGFILE = "/var/log/mongodb/mongod.log"
DATA_DIR = "/var/lib/mongodb"
REPL_SET = "jepsen"


# -- BSON subset codec ------------------------------------------------------

def _enc_elem(name: str, v) -> bytes:
    nb = name.encode() + b"\x00"
    if isinstance(v, bool):  # before int: bool is an int subclass
        return b"\x08" + nb + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(2**31) <= v < 2**31:
            return b"\x10" + nb + struct.pack("<i", v)
        return b"\x12" + nb + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + nb + struct.pack("<d", v)
    if isinstance(v, str):
        sb = v.encode() + b"\x00"
        return b"\x02" + nb + struct.pack("<i", len(sb)) + sb
    if v is None:
        return b"\x0a" + nb
    if isinstance(v, dict):
        return b"\x03" + nb + bson_encode(v)
    if isinstance(v, (list, tuple)):
        doc = {str(i): x for i, x in enumerate(v)}
        return b"\x04" + nb + bson_encode(doc)
    raise TypeError(f"bson: unsupported type {type(v).__name__}")


def bson_encode(doc: dict) -> bytes:
    body = b"".join(_enc_elem(str(k), v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _dec_elem(buf: bytes, off: int):
    tag = buf[off]
    off += 1
    end = buf.index(b"\x00", off)
    name = buf[off:end].decode()
    off = end + 1
    if tag == 0x10:
        return name, struct.unpack_from("<i", buf, off)[0], off + 4
    if tag == 0x12:
        return name, struct.unpack_from("<q", buf, off)[0], off + 8
    if tag == 0x01:
        return name, struct.unpack_from("<d", buf, off)[0], off + 8
    if tag == 0x02:
        n = struct.unpack_from("<i", buf, off)[0]
        s = buf[off + 4:off + 4 + n - 1].decode()
        return name, s, off + 4 + n
    if tag == 0x08:
        return name, buf[off] == 1, off + 1
    if tag == 0x0A:
        return name, None, off
    if tag in (0x03, 0x04):
        n = struct.unpack_from("<i", buf, off)[0]
        sub, _ = bson_decode(buf[off:off + n])
        if tag == 0x04:
            return name, [sub[k] for k in sorted(sub, key=int)], off + n
        return name, sub, off + n
    raise ValueError(f"bson: unsupported tag 0x{tag:02x}")


def bson_decode(buf: bytes) -> tuple[dict, int]:
    """Decode one document; returns (doc, bytes consumed)."""
    n = struct.unpack_from("<i", buf, 0)[0]
    out: dict = {}
    off = 4
    while buf[off] != 0:
        name, v, off = _dec_elem(buf, off)
        out[name] = v
    return out, n


# -- OP_MSG framing ---------------------------------------------------------

OP_MSG = 2013


def encode_op_msg(doc: dict, request_id: int) -> bytes:
    body = struct.pack("<I", 0) + b"\x00" + bson_encode(doc)
    header = struct.pack("<iiii", 16 + len(body), request_id, 0, OP_MSG)
    return header + body


def read_op_msg(rf) -> dict:
    header = rf.read(16)
    if len(header) < 16:
        raise ConnectionError("short read in message header")
    length, _rid, _rto, opcode = struct.unpack("<iiii", header)
    body = rf.read(length - 16)
    if len(body) < length - 16:
        raise ConnectionError("short read in message body")
    if opcode != OP_MSG:
        raise ValueError(f"unsupported opcode {opcode}")
    # flagBits (4) + section kind byte (1) + BSON body
    if body[4] != 0:
        raise ValueError(f"unsupported section kind {body[4]}")
    doc, _ = bson_decode(body[5:])
    return doc


class MongoError(Exception):
    pass


class MongoConn:
    """One blocking OP_MSG connection."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.rf = self.sock.makefile("rb")
        self._rid = 0
        self._lock = threading.Lock()

    def cmd(self, doc: dict) -> dict:
        with self._lock:
            self._rid += 1
            self.sock.sendall(encode_op_msg(doc, self._rid))
            reply = read_op_msg(self.rf)
        if reply.get("ok") != 1:
            raise MongoError(reply.get("errmsg") or f"not ok: {reply}")
        # ok:1 does not mean durably applied: writeConcernError means the
        # write wasn't majority-acknowledged (rollback-eligible), writeErrors
        # means it wasn't applied at all.  Surface both as exceptions so the
        # client maps mutations to :info / :fail instead of a false :ok
        # (document_cas.clj parse-result discipline).
        wce = reply.get("writeConcernError")
        wes = reply.get("writeErrors")
        if wce:
            raise MongoError(f"writeConcernError: {wce.get('errmsg', wce)}")
        if wes:
            raise MongoError(f"writeErrors: {wes}")
        return reply

    def close(self):
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


# -- DB automation ----------------------------------------------------------

# -- the LIVE mini server ----------------------------------------------------

MINI_BASE_PORT = 31000

MINIMONGO_SRC = r'''
import argparse, json, os, socketserver, struct, threading

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

LOG_PATH = os.path.join(args.dir, "minimongo.jsonl")
LOCK = threading.Lock()
COLLS = {}

def enc_elem(name, v):
    nb = name.encode() + b"\x00"
    if isinstance(v, bool):
        return b"\x08" + nb + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(2**31) <= v < 2**31:
            return b"\x10" + nb + struct.pack("<i", v)
        return b"\x12" + nb + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + nb + struct.pack("<d", v)
    if isinstance(v, str):
        sb = v.encode() + b"\x00"
        return b"\x02" + nb + struct.pack("<i", len(sb)) + sb
    if v is None:
        return b"\x0a" + nb
    if isinstance(v, dict):
        return b"\x03" + nb + bson_encode(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + nb + bson_encode(
            {str(i): x for i, x in enumerate(v)})
    raise TypeError("bson: %r" % type(v))

def bson_encode(doc):
    body = b"".join(enc_elem(str(k), v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"

def dec_elem(buf, off):
    tag = buf[off]
    off += 1
    end = buf.index(b"\x00", off)
    name = buf[off:end].decode()
    off = end + 1
    if tag == 0x10:
        return name, struct.unpack_from("<i", buf, off)[0], off + 4
    if tag == 0x12:
        return name, struct.unpack_from("<q", buf, off)[0], off + 8
    if tag == 0x01:
        return name, struct.unpack_from("<d", buf, off)[0], off + 8
    if tag == 0x02:
        n = struct.unpack_from("<i", buf, off)[0]
        return name, buf[off + 4:off + 4 + n - 1].decode(), off + 4 + n
    if tag == 0x08:
        return name, buf[off] == 1, off + 1
    if tag == 0x0A:
        return name, None, off
    if tag in (0x03, 0x04):
        n = struct.unpack_from("<i", buf, off)[0]
        sub = bson_decode(buf[off:off + n])
        if tag == 0x04:
            sub = [sub[k] for k in sorted(sub, key=int)]
        return name, sub, off + n
    raise ValueError("bson tag 0x%02x" % tag)

def bson_decode(buf):
    out = {}
    off = 4
    while buf[off] != 0:
        name, v, off = dec_elem(buf, off)
        out[name] = v
    return out

def log_append(rec):
    with open(LOG_PATH, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
        os.fsync(fh.fileno())

def apply_mut(rec):
    kind, coll, doc = rec
    c = COLLS.setdefault(coll, {})
    if kind == "put":
        c[doc["_id"]] = doc
    elif kind == "del":
        c.pop(doc, None)

def replay():
    if not os.path.exists(LOG_PATH):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail
            try:
                apply_mut(rec)
            except Exception:
                # a malformed record must never brick the boot: skip
                # it (the write it describes was rejected client-side)
                continue

def matches(d, flt):
    return all(d.get(k) == v for k, v in (flt or {}).items())

def dispatch(doc):
    if "find" in doc:
        coll = COLLS.get(doc["find"], {})
        batch = [d for d in coll.values()
                 if matches(d, doc.get("filter"))]
        limit = doc.get("limit") or 0
        if limit:
            batch = batch[:limit]
        return {"ok": 1, "cursor": {"id": 0, "firstBatch": batch}}
    if "update" in doc:
        coll = COLLS.setdefault(doc["update"], {})
        n = modified = 0
        for i, u in enumerate(doc["updates"]):
            q, new = u["q"], u["u"]
            if "_id" not in new:
                # validate BEFORE log_append: a durable record that
                # apply_mut cannot replay would brick every restart
                return {"ok": 1, "n": n, "writeErrors": [
                    {"index": i, "code": 9,
                     "errmsg": "replacement document needs _id"}]}
            hits = [d for d in coll.values() if matches(d, q)]
            if hits:
                # replacement semantics: one doc replaced (first
                # match), not one put per hit
                log_append(["put", doc["update"], new])
                apply_mut(["put", doc["update"], new])
                n += 1
                modified += 1
            elif u.get("upsert"):
                log_append(["put", doc["update"], new])
                apply_mut(["put", doc["update"], new])
                n += 1
        return {"ok": 1, "n": n, "nModified": modified}
    if "insert" in doc:
        coll = COLLS.setdefault(doc["insert"], {})
        for d in doc["documents"]:
            if d["_id"] in coll:
                return {"ok": 1, "n": 0, "writeErrors": [
                    {"index": 0, "code": 11000,
                     "errmsg": "duplicate key"}]}
            log_append(["put", doc["insert"], d])
            apply_mut(["put", doc["insert"], d])
        return {"ok": 1, "n": len(doc["documents"])}
    if "findAndModify" in doc:
        coll = COLLS.setdefault(doc["findAndModify"], {})
        docs = [d for d in coll.values()
                if matches(d, doc.get("query"))]
        for field, direction in reversed(list(
                (doc.get("sort") or {}).items())):
            docs.sort(key=lambda d: d.get(field),
                      reverse=direction < 0)
        if not docs:
            return {"ok": 1, "value": None}
        hit = docs[0]
        if doc.get("remove"):
            log_append(["del", doc["findAndModify"], hit["_id"]])
            apply_mut(["del", doc["findAndModify"], hit["_id"]])
        return {"ok": 1, "value": hit}
    if "replSetInitiate" in doc or "ping" in doc:
        return {"ok": 1}
    return {"ok": 0, "errmsg": "no such command"}

class Conn(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            hdr = self.rfile.read(16)
            if len(hdr) < 16:
                return
            length, rid, _, opcode = struct.unpack("<iiii", hdr)
            body = self.rfile.read(length - 16)
            if len(body) < length - 16 or opcode != 2013:
                return
            doc = bson_decode(body[5:])
            with LOCK:
                reply = dispatch(doc)
            out = struct.pack("<I", 0) + b"\x00" + bson_encode(reply)
            self.wfile.write(struct.pack(
                "<iiii", 16 + len(out), 0, rid, 2013) + out)
            self.wfile.flush()

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

replay()
print("minimongo serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Conn).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "mongo_ports")


#: the rocks-era build bucket (mongodb_rocks.clj:33-35); the rocksdb
#: storage engine ships in these debs, not the stock ones
ROCKS_DEB_URL = ("https://s3.amazonaws.com/parse-mongodb-builds/debs/"
                 "mongodb-org-server_{v}_amd64.deb")

STORAGE_ENGINES = ("wiredTiger", "rocksdb", "mmapv1")


class MongoDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """deb install + mongod --replSet daemon + replica-set initiation
    from the primary, issued over this module's own wire client
    (mongodb_rocks.clj:29-38 install; core.clj rs-initiate). The
    ``storage_engine`` axis is the whole point of the mongodb-rocks
    suite (its mongod.conf %ENGINE% template, :41-46): rocksdb
    engines install from the parse-mongodb-builds bucket."""

    def __init__(self, version: str = VERSION,
                 storage_engine: str = "wiredTiger"):
        if storage_engine not in STORAGE_ENGINES:
            raise ValueError(f"storage_engine {storage_engine!r} "
                             f"not in {STORAGE_ENGINES}")
        self.version = version
        self.storage_engine = storage_engine

    def _start(self, test, node):
        nodeutil.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": "/"},
            "mongod",
            "--replSet", REPL_SET,
            "--storageEngine", self.storage_engine,
            "--dbpath", DATA_DIR,
            "--port", str(PORT),
            "--bind_ip", "0.0.0.0",
            "--fork", "--logpath", LOGFILE,
            "--pidfilepath", PIDFILE)
        nodeutil.await_tcp_port(PORT, timeout_s=120)

    def setup(self, test, node):
        url = (ROCKS_DEB_URL if self.storage_engine == "rocksdb"
               else DEB_URL)
        with control.su():
            # atomic node-local download cache: a partial wget must
            # not poison later setups
            deb = nodeutil.cached_wget(url.format(v=self.version))
            control.exec_("dpkg", "-i", "--force-confnew", deb)
            control.exec_("mkdir", "-p", DATA_DIR,
                          "/var/log/mongodb")
        self._start(test, node)
        if node == test["nodes"][0]:
            # the primary initiates the replica set over the wire
            try:
                conn = MongoConn("127.0.0.1", PORT, timeout=30)
                try:
                    conn.cmd({"replSetInitiate": {
                        "_id": REPL_SET,
                        "members": [{"_id": i, "host": f"{n}:{PORT}"}
                                    for i, n in
                                    enumerate(test["nodes"])]},
                        "$db": "admin"})
                except MongoError:
                    pass  # already initiated (re-setup after teardown)
                finally:
                    conn.close()
            except OSError as e:
                # scripted/dummy remotes have no live daemon to dial;
                # on a real cluster await_tcp_port already proved the
                # port, so log loudly rather than kill the setup
                import logging
                logging.getLogger(__name__).warning(
                    "replSetInitiate connection failed: %s", e)

    def teardown(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("mongod")
        with control.su():
            control.exec_("rm", "-rf", DATA_DIR, LOGFILE)

    def start(self, test, node):
        self._start(test, node)
        return "started"

    def kill(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("mongod")
        return "killed"

    def log_files(self, test, node):
        return [LOGFILE]


class MiniMongoDB(miniserver.MiniServerDB):
    """LIVE in-repo OP_MSG servers (fsync'd mutation log, crash-safe
    replay) — the same promotion consul/zookeeper got: the real wire
    client and DB automation run against killable processes in CI."""

    script = "minimongo.py"
    src = MINIMONGO_SRC
    pidfile = "minimongo.pid"
    logfile = "minimongo.log"
    data_files = ("minimongo.jsonl",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


# -- client -----------------------------------------------------------------

class MongoClient(jclient.Client):
    """Document-CAS register client (document_cas.clj:50-82): one
    document per key in jepsen.registers; cas = conditional update,
    nModified decides. `addr_fn` maps a node to (host, port) — tests
    point it at the stub; `write_concern` rides every update."""

    DB_NAME = "jepsen"
    COLL = "registers"

    def __init__(self, addr_fn=None, write_concern: str = "majority",
                 timeout: float = 5.0):
        self.addr_fn = addr_fn or (lambda test, node: (node, PORT))
        self.write_concern = write_concern
        self.timeout = timeout
        self.node: Optional[str] = None
        self.conn: Optional[MongoConn] = None

    def open(self, test, node):
        c = type(self)(self.addr_fn, self.write_concern, self.timeout)
        c.node = node
        return c

    def _conn(self, test) -> MongoConn:
        if self.conn is None:
            host, port = self.addr_fn(test, self.node)
            self.conn = MongoConn(host, port, self.timeout)
        return self.conn

    def _update(self, test, q: dict, u: dict, upsert: bool) -> dict:
        return self._conn(test).cmd({
            "update": self.COLL, "$db": self.DB_NAME,
            "updates": [{"q": q, "u": u, "upsert": upsert}],
            "writeConcern": {"w": self.write_concern}})

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"mongodb wants [k v] tuples, got {kv!r}")
        k, v = kv
        f = op["f"]
        if f not in ("read", "write", "cas"):
            raise ValueError(f"unknown op {f!r}")
        try:
            if f == "read":
                reply = self._conn(test).cmd({
                    "find": self.COLL, "$db": self.DB_NAME,
                    "filter": {"_id": int(k)}, "limit": 1,
                    "$readPreference": {"mode": "primary"}})
                batch = reply["cursor"]["firstBatch"]
                cur = batch[0]["value"] if batch else None
                return {**op, "type": "ok", "value": tuple_(k, cur)}
            if f == "write":
                self._update(test, {"_id": int(k)},
                             {"_id": int(k), "value": v}, upsert=True)
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                reply = self._update(
                    test, {"_id": int(k), "value": old},
                    {"_id": int(k), "value": new}, upsert=False)
                # Decide on the matched count n (getN): when old == new the
                # update matches but modifies 0 docs, yet the CAS *won*
                # (document_cas.clj getN discipline).  nModified only as a
                # fallback for ancient servers that omit n.
                n = reply.get("n", reply.get("nModified", 0))
                if n not in (0, 1):
                    raise MongoError(f"cas touched {n} documents")
                return {**op, "type": "ok" if n == 1 else "fail"}
        except (OSError, ConnectionError, MongoError, KeyError) as e:
            if self.conn is not None:
                self.conn.close()
                self.conn = None
            # reads never applied anything -> definite fail; writes
            # and cas may have applied -> indefinite info
            # (document_cas.clj:51-52 error discipline)
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


class LoggerClient(MongoClient):
    """The mongodb-rocks logger queue (mongodb_rocks.clj:87-146):
    writes insert timestamped payload documents; deletes
    find-and-modify the OLDEST by time out (sort {time: 1}, remove).
    The payload is trimmed from the reference's 100 KiB to keep CI
    wire traffic sane; the shape is identical."""

    COLL = "logger"
    PAYLOAD = "x" * 4096

    def invoke(self, test, op):
        f = op["f"]
        try:
            if f == "write":
                self._conn(test).cmd({
                    "insert": self.COLL, "$db": self.DB_NAME,
                    "documents": [{"_id": str(op["value"]),
                                   "time": int(op["time_ms"]),
                                   "payload": self.PAYLOAD}],
                    "writeConcern": {"w": self.write_concern}})
                return {**op, "type": "ok"}
            if f == "delete":
                reply = self._conn(test).cmd({
                    "findAndModify": self.COLL,
                    "$db": self.DB_NAME,
                    "query": {}, "sort": {"time": 1},
                    "remove": True})
                doc = reply.get("value")
                if doc is None:
                    return {**op, "type": "fail"}
                return {**op, "type": "ok", "value": doc["_id"]}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, MongoError, KeyError) as e:
            if self.conn is not None:
                self.conn.close()
                self.conn = None
            return {**op, "type": "info", "error": str(e)[:200]}


def _logger_workload(options):
    """mongodb_rocks.clj:131-146: 2:1 write/delete mix, latency
    checker."""
    counter = iter(range(10 ** 9))
    clock = iter(range(10 ** 12))

    def write(test, ctx):
        return {"f": "write", "value": f"t-{next(counter)}",
                "time_ms": next(clock)}

    def delete(test, ctx):
        return {"f": "delete", "value": None}

    return {
        "client": LoggerClient(
            write_concern=options.get("write_concern")
                          or "majority"),
        "checker": jchecker.perf(),
        "generator": gen.clients(gen.mix([write, write, delete])),
    }


def mongodb_test(options: dict) -> dict:
    """Register workload (the document_cas suite shape);
    ``workload=logger`` swaps in the mongodb-rocks queue;
    ``os=smartos`` runs the mongodb-smartos path (SmartOS setup +
    ipfilter partitions). ``server=mini`` (default) runs LIVE in-repo
    OP_MSG servers under a kill nemesis; ``server=deb`` is the real
    replica-set automation under partition-random-halves. The register
    checker's device lane runs on `options["device"]` (default the
    card), resolved here, so that a missing card raises before any node
    is set up."""
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    which = options.get("workload") or "register"
    if which == "logger":
        w = _logger_workload(options)
        client = w["client"]
    elif which == "register":
        w = linearizable_register.workload(
            {"nodes": nodes,
             "concurrency": options["concurrency"],
             "per_key_limit": options.get("per_key_limit") or 100,
             "algorithm": "competition",
             "device": resolve_device(options.get("device"))})
        client = MongoClient(
            write_concern=options.get("write_concern") or "majority")
    else:
        raise ValueError(f"unknown workload {which!r}")
    if mode == "mini":
        db: jdb.DB = MiniMongoDB()
        client.addr_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, test["nodes"][0]))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "mongo-cluster"),
            "ssh": {"dummy?": False},
        }
        nemesis = jnemesis.node_start_stopper(
            lambda ns: [ns[0]],
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node))
    elif mode == "deb":
        db = MongoDB(options.get("version") or VERSION,
                     options.get("storage_engine") or "wiredTiger")
        if (options.get("os") or "debian") == "smartos":
            # mongodb-smartos path: pkgin setup + ipfilter partitions
            os_setup, net = SmartOS(), jnet.ipfilter()
        else:
            os_setup, net = Debian(), jnet.iptables()
        extra = {"ssh": options.get("ssh") or {}, "os": os_setup,
                 "net": net}
        nemesis = jnemesis.partition_random_halves()
    else:
        raise ValueError(f"unknown server mode {mode!r}")
    engine = (db.storage_engine if isinstance(db, MongoDB)
              else "mini")
    version = db.version if isinstance(db, MongoDB) else VERSION
    interval = options.get("nemesis_interval") or (
        3.0 if mode == "mini" else 10.0)
    return {
        "name": options.get("name")
                or f"mongodb-{which}-{engine}-{version}",
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
        "generator": gen.time_limit(
            options.get("time_limit") or 30,
            gen.nemesis(
                gen.cycle([gen.sleep(interval),
                           {"type": "info", "f": "start"},
                           gen.sleep(interval),
                           {"type": "info", "f": "stop"}]),
                w["generator"])),
        **extra,
    }


MONGODB_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Where to write results"),
    cli.Opt("version", metavar="VERSION", default=VERSION,
            help="mongodb-org-server deb version"),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo OP_MSG servers) or deb (real "
                 "replica set on --ssh nodes)"),
    cli.Opt("sandbox", metavar="DIR", default="mongo-cluster"),
    cli.Opt("workload", metavar="NAME", default="register",
            help="register (document-cas) or logger (the "
                 "mongodb-rocks queue)"),
    cli.Opt("storage_engine", metavar="ENGINE", default="wiredTiger",
            help=f"one of {', '.join(STORAGE_ENGINES)} "
                 "(rocksdb = the mongodb-rocks variant)"),
    cli.Opt("os", metavar="OS", default="debian",
            help="debian or smartos (the mongodb-smartos "
                 "ipfilter path)"),
    cli.Opt("write_concern", metavar="W", default="majority",
            help="write concern for updates (majority, 1, ...)"),
    cli.Opt("per_key_limit", metavar="N", default=100, parse=int,
            help="Ops per key"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=None,
            parse=float,
            help="Seconds between fault start/stop (default: 3 in "
                 "mini mode, 10 in deb mode)"),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's kernels run (default: the "
                 "card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": mongodb_test,
                           "opt_spec": MONGODB_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
