"""Hazelcast test suite — the in-memory-data-grid family exemplar
(hazelcast/src/jepsen/hazelcast.clj, 821 LoC; also standing for
ignite, the other JVM data grid the reference tests the same way).

The reference suite is a tour of distributed PRIMITIVES rather than a
database: atomic longs as unique-ID generators (hazelcast.clj:146-160
— the famously broken pre-CP ones), CP compare-and-set longs
(:190-209), queues (:270-296), fenced locks whose acquisitions carry
a monotonic fencing token (:333-371), and maps CAS-replaced to build
sets (:451-520). All are replicated here as workloads:

- ``unique-ids`` — incrementAndGet across clients, unique-ids checker.
- ``cas-long``   — get/set/compareAndSet on one atomic long, checked
  linearizable against the CAS-register model.
- ``queue``      — offer/poll/drain with total-queue multiset
  accounting (enqueues must never vanish).
- ``lock``       — tryLock returns a FENCE; linearizable against the
  mutex model PLUS fence monotonicity (each successful acquisition's
  fence must exceed every earlier one — the Chubby/fencing-token
  argument the reference's fenced-lock client logs:333-345).
- ``map-set``    — unique adds CAS-replaced into one map entry
  (`replace(k, old, new)`), set checkers.

Everything on the wire is a FROM-SCRATCH binary frame protocol in the
shape of Hazelcast's Open Client Protocol: little-endian frames of
`length u32 | message-type u16 | correlation-id i64 | JSON payload`,
one request/response pair per correlation id. ``mini`` mode (default)
runs LIVE in-repo servers persisting longs/queues/maps in an fsync'd
op log; LOCK STATE IS DELIBERATELY VOLATILE — a kill -9 frees every
held lock on restart, which is exactly the anomaly family the
reference found (its lock tests fail; tests here prove the violation
deterministically and keep the CI lock suite fault-free). ``jar``
mode emits the real automation (openjdk + server jar + tcp-ip member
XML, hazelcast.clj:57-98), command-assertion tested.

The port's copy of `jepsen_tpu/dbs/hazelcast.py`. Its own choices: the
mini servers listen from `MINI_BASE_PORT` 31700 (the reference's from
28700, so that both packages' servers can run on one host at once; below
Linux's ephemeral range, 32768-60999; `jar` mode keeps Hazelcast's `PORT`
5701); `--device` on `test` and `test-all`, passed to the checks of
`DEVICE_WORKLOADS` (the `cas-long` register's and the `lock` mutex's
competition races, whose device lane runs the WGL chunk kernels), default
the card: a missing card raises before any node is set up, `--device cpu`
runs their plain PyTorch versions (the other workloads' checks, and the
lock's fences, run on the host and take no device); the store root
`store/torch`. `MINIHZ_SRC` is the reference's, byte for byte, its lock
state as volatile.

    python -m jepsen_tpu_torch.dbs.hazelcast test --nodes h1 \
        --workload lock --time-limit 3 --device cpu
"""

from __future__ import annotations

import json
import socket
import struct
import sys
import uuid

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..ledger import BASE_DIR
from ..models import cas_register, mutex
from ..os_setup import Debian
from ..util import resolve_device
from . import miniserver, retryclient

VERSION = "3.12.1"  # reference era (hazelcast.clj project deps)
PORT = 5701
MINI_BASE_PORT = 31700

# message types (simplified Open Client Protocol ids)
LONG_ADD_AND_GET = 0x0601
LONG_GET = 0x0603
LONG_SET = 0x0604
LONG_CAS = 0x0605
QUEUE_OFFER = 0x0301
QUEUE_POLL = 0x0302
LOCK_TRY = 0x0701
LOCK_UNLOCK = 0x0702
MAP_GET = 0x0101
MAP_PUT_IF_ABSENT = 0x0102
MAP_REPLACE = 0x0103

INVALID_FENCE = 0


class HzError(Exception):
    pass


def encode_frame(msg_type: int, correlation: int, payload: dict) -> bytes:
    body = json.dumps(payload).encode()
    return struct.pack("<IHq", len(body) + 10, msg_type,
                       correlation) + body


def read_frame(rf) -> tuple[int, int, dict]:
    hdr = rf.read(4)
    if len(hdr) < 4:
        raise ConnectionError("short frame length")
    n = struct.unpack("<I", hdr)[0]
    raw = rf.read(n)
    if len(raw) < n:
        raise ConnectionError("short frame body")
    msg_type, correlation = struct.unpack("<Hq", raw[:10])
    return msg_type, correlation, json.loads(raw[10:])


class HzConn:
    """One client connection; `session` identifies this client as a
    lock owner (the protocol's client uuid)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.rf = self.sock.makefile("rb")
        self.correlation = 0
        self.session = str(uuid.uuid4())

    def request(self, msg_type: int, payload: dict) -> dict:
        self.correlation += 1
        self.sock.sendall(encode_frame(msg_type, self.correlation,
                                       payload))
        _, corr, resp = read_frame(self.rf)
        if corr != self.correlation:
            raise ConnectionError("correlation mismatch")
        if "err" in resp:
            raise HzError(resp["err"])
        return resp

    # -- primitives --
    def add_and_get(self, name: str, delta: int) -> int:
        return self.request(LONG_ADD_AND_GET,
                            {"name": name, "delta": delta})["value"]

    def long_get(self, name: str) -> int:
        return self.request(LONG_GET, {"name": name})["value"]

    def long_set(self, name: str, value: int) -> None:
        self.request(LONG_SET, {"name": name, "value": value})

    def long_cas(self, name: str, old: int, new: int) -> bool:
        return self.request(LONG_CAS, {"name": name, "old": old,
                                       "new": new})["value"]

    def offer(self, name: str, value) -> None:
        self.request(QUEUE_OFFER, {"name": name, "value": value})

    def poll(self, name: str):
        return self.request(QUEUE_POLL, {"name": name})["value"]

    def try_lock(self, name: str) -> int:
        """The fence on success, INVALID_FENCE when held elsewhere
        (tryLockAndGetFence, hazelcast.clj:334-338)."""
        return self.request(LOCK_TRY, {"name": name,
                                       "session": self.session})["value"]

    def unlock(self, name: str) -> None:
        self.request(LOCK_UNLOCK, {"name": name,
                                   "session": self.session})

    def map_get(self, name: str, key: str):
        return self.request(MAP_GET, {"name": name,
                                      "key": key})["value"]

    def map_put_if_absent(self, name: str, key: str, value) -> bool:
        return self.request(MAP_PUT_IF_ABSENT,
                            {"name": name, "key": key,
                             "value": value})["value"]

    def map_replace(self, name: str, key: str, old, new) -> bool:
        return self.request(MAP_REPLACE,
                            {"name": name, "key": key, "old": old,
                             "new": new})["value"]

    def close(self):
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


# -- the LIVE mini server -----------------------------------------------------

MINIHZ_SRC = r'''
import argparse, json, os, socketserver, struct, threading
from collections import deque

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

LOG_PATH = os.path.join(args.dir, "minihz.jsonl")
LOCK = threading.Lock()
LONGS, QUEUES, MAPS = {}, {}, {}
# locks are DELIBERATELY volatile: a kill -9 frees every held lock,
# the anomaly family the reference's lock tests exposed
LOCKS, FENCE = {}, [0]

def replay():
    if not os.path.exists(LOG_PATH):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail
            apply_logged(rec)

def apply_logged(rec):
    k = rec["op"]
    if k == "long":
        LONGS[rec["name"]] = rec["value"]
    elif k == "offer":
        QUEUES.setdefault(rec["name"], deque()).append(rec["value"])
    elif k == "poll":
        q = QUEUES.get(rec["name"])
        if q:
            q.popleft()
    elif k == "map":
        MAPS.setdefault(rec["name"], {})[rec["key"]] = rec["value"]

def persist(rec):
    with open(LOG_PATH, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
        os.fsync(fh.fileno())

def apply(msg_type, p):
    name = p["name"]
    if msg_type == 0x0601:  # addAndGet
        v = LONGS.get(name, 0) + p["delta"]
        LONGS[name] = v
        persist({"op": "long", "name": name, "value": v})
        return {"value": v}
    if msg_type == 0x0603:
        return {"value": LONGS.get(name, 0)}
    if msg_type == 0x0604:
        LONGS[name] = p["value"]
        persist({"op": "long", "name": name, "value": p["value"]})
        return {"value": None}
    if msg_type == 0x0605:  # compareAndSet
        if LONGS.get(name, 0) == p["old"]:
            LONGS[name] = p["new"]
            persist({"op": "long", "name": name, "value": p["new"]})
            return {"value": True}
        return {"value": False}
    if msg_type == 0x0301:  # offer
        QUEUES.setdefault(name, deque()).append(p["value"])
        persist({"op": "offer", "name": name, "value": p["value"]})
        return {"value": True}
    if msg_type == 0x0302:  # poll
        q = QUEUES.get(name)
        if not q:
            return {"value": None}
        v = q.popleft()
        # removal is persisted AFTER the reply reaches the client
        # (the deferred hook below): a crash in between redelivers
        # the element (at-least-once) instead of losing an
        # acknowledged enqueue forever
        return {"value": v}, {"op": "poll", "name": name}
    if msg_type == 0x0701:  # tryLock -> fence or 0
        if LOCKS.get(name) is None:
            FENCE[0] += 1
            LOCKS[name] = p["session"]
            return {"value": FENCE[0]}
        return {"value": 0}
    if msg_type == 0x0702:  # unlock
        if LOCKS.get(name) != p["session"]:
            return {"err": "not-lock-owner"}
        LOCKS[name] = None
        return {"value": None}
    if msg_type == 0x0101:  # map get
        return {"value": MAPS.get(name, {}).get(p["key"])}
    if msg_type == 0x0102:  # putIfAbsent
        m = MAPS.setdefault(name, {})
        if p["key"] in m:
            return {"value": False}
        m[p["key"]] = p["value"]
        persist({"op": "map", "name": name, "key": p["key"],
                 "value": p["value"]})
        return {"value": True}
    if msg_type == 0x0103:  # replace(k, old, new)
        m = MAPS.setdefault(name, {})
        if m.get(p["key"]) == p["old"]:
            m[p["key"]] = p["new"]
            persist({"op": "map", "name": name, "key": p["key"],
                     "value": p["new"]})
            return {"value": True}
        return {"value": False}
    return {"err": "unsupported message type %d" % msg_type}

class Conn(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            hdr = self.rfile.read(4)
            if len(hdr) < 4:
                return
            n = struct.unpack("<I", hdr)[0]
            raw = self.rfile.read(n)
            if len(raw) < n:
                return
            msg_type, corr = struct.unpack("<Hq", raw[:10])
            p = json.loads(raw[10:])
            after = None
            with LOCK:
                try:
                    out = apply(msg_type, p)
                    if isinstance(out, tuple):
                        out, after = out  # deferred log record
                except Exception as e:
                    out = {"err": str(e)[:150]}
            body = json.dumps(out).encode()
            self.wfile.write(struct.pack("<IHq", len(body) + 10,
                                         msg_type, corr) + body)
            self.wfile.flush()
            if after is not None:
                with LOCK:
                    persist(after)

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

replay()
print("minihz serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Conn).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "hazelcast_ports")


class MiniHzDB(miniserver.MiniServerDB):
    script = "minihz.py"
    src = MINIHZ_SRC
    pidfile = "minihz.pid"
    logfile = "minihz.out"
    data_files = ("minihz.jsonl",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


class HazelcastDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real automation (hazelcast.clj install!:69-75, start!:77-89):
    openjdk + server jar + tcp-ip member XML, java daemon."""

    DIR = "/opt/hazelcast"

    @staticmethod
    def config(test: dict, node: str) -> str:
        members = "\n".join(
            f"        <member>{n}</member>" for n in test["nodes"])
        return ("<hazelcast>\n  <network>\n"
                f"    <port>{PORT}</port>\n    <join>\n"
                "      <multicast enabled=\"false\"/>\n"
                "      <tcp-ip enabled=\"true\">\n"
                f"{members}\n      </tcp-ip>\n    </join>\n"
                "  </network>\n</hazelcast>\n")

    def setup(self, test, node):
        with control.su():
            control.exec_("apt-get", "install", "-y",
                          "openjdk-11-jre-headless")
            control.exec_("mkdir", "-p", self.DIR)
            nodeutil.write_file(self.config(test, node),
                                f"{self.DIR}/hazelcast.xml")
        self.start(test, node)

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf",
                          control.lit(f"{self.DIR}/*.log"))

    def start(self, test, node):
        nodeutil.start_daemon(
            {"logfile": f"{self.DIR}/server.log",
             "pidfile": f"{self.DIR}/server.pid",
             "chdir": self.DIR},
            "java",
            f"-Dhazelcast.config={self.DIR}/hazelcast.xml",
            "-jar", f"{self.DIR}/hazelcast-{VERSION}.jar")
        nodeutil.await_tcp_port(PORT, timeout_s=120)
        return "started"

    def kill(self, test, node):
        nodeutil.stop_daemon(f"{self.DIR}/server.pid")
        nodeutil.grepkill("hazelcast")
        return "killed"

    def log_files(self, test, node):
        return [f"{self.DIR}/server.log"]


# -- clients ------------------------------------------------------------------

class _HzBase(retryclient.RetryClient):
    default_port = PORT
    retry_excs = (OSError,)

    def _connect(self, host, port) -> HzConn:
        return HzConn(host, port, timeout=self.timeout)

    def _errmap(self, op, e):
        self._drop()
        t = "fail" if op["f"] in ("read",) else "info"
        return {**op, "type": t, "error": str(e)[:200]}


class HzIdClient(_HzBase):
    """unique-ids over incrementAndGet (hazelcast.clj:146-160)."""

    def invoke(self, test, op):
        try:
            v = self._conn(test).add_and_get("jepsen.atomic-long", 1)
            return {**op, "type": "ok", "value": v}
        except (OSError, ConnectionError, HzError) as e:
            return self._errmap(op, e)


class HzCasLongClient(_HzBase):
    """cp-cas-long (hazelcast.clj:190-209): one linearizable long."""

    NAME = "jepsen.cas-long"

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                return {**op, "type": "ok",
                        "value": conn.long_get(self.NAME)}
            if f == "write":
                conn.long_set(self.NAME, int(op["value"]))
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = op["value"]
                won = conn.long_cas(self.NAME, int(old), int(new))
                return {**op, "type": "ok" if won else "fail"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, HzError) as e:
            return self._errmap(op, e)


class HzQueueClient(_HzBase):
    """offer/poll/drain (hazelcast.clj:270-296)."""

    NAME = "jepsen.queue"

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "enqueue":
                conn.offer(self.NAME, int(op["value"]))
                return {**op, "type": "ok"}
            if f == "dequeue":
                v = conn.poll(self.NAME)
                if v is None:
                    return {**op, "type": "fail", "error": "empty"}
                return {**op, "type": "ok", "value": v}
            if f == "drain":
                out = []
                while True:
                    v = conn.poll(self.NAME)
                    if v is None:
                        return {**op, "type": "ok", "value": out}
                    out.append(v)
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, HzError) as e:
            self._drop()
            if f == "drain":
                return {**op, "type": "info", "error": str(e)[:200]}
            t = "fail" if f == "dequeue" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class HzLockClient(_HzBase):
    """Fenced lock (hazelcast.clj:333-371): acquire = tryLock
    returning a fence (fail on INVALID_FENCE), release = unlock
    (not-lock-owner = definite fail)."""

    NAME = "jepsen.lock"

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "acquire":
                fence = conn.try_lock(self.NAME)
                if fence == INVALID_FENCE:
                    return {**op, "type": "fail", "error": "held"}
                return {**op, "type": "ok", "value": fence}
            if f == "release":
                try:
                    conn.unlock(self.NAME)
                except HzError as e:
                    if "not-lock-owner" in str(e):
                        return {**op, "type": "fail",
                                "error": "not-lock-owner"}
                    raise
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, HzError) as e:
            self._drop()
            t = "fail" if f == "acquire" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class HzMapSetClient(_HzBase):
    """Set-as-CAS'd-map-entry (hazelcast.clj:451-520): adds replace
    the sorted list under one key, retrying on contention."""

    NAME = "jepsen.map"
    KEY = "hi"

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                cur = conn.map_get(self.NAME, self.KEY)
                return {**op, "type": "ok",
                        "value": sorted(cur or [])}
            if f == "add":
                e = int(op["value"])
                for _ in range(16):
                    cur = conn.map_get(self.NAME, self.KEY)
                    if cur is None:
                        if conn.map_put_if_absent(self.NAME,
                                                  self.KEY, [e]):
                            return {**op, "type": "ok"}
                        continue
                    new = sorted(set(cur) | {e})
                    if conn.map_replace(self.NAME, self.KEY, cur,
                                        new):
                        return {**op, "type": "ok"}
                return {**op, "type": "fail",
                        "error": "cas retries exhausted"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, HzError) as e:
            return self._errmap(op, e)


# -- checkers -----------------------------------------------------------------

class FenceChecker(jchecker.Checker):
    """Fencing tokens must be monotonic: each successful acquisition's
    fence exceeds every earlier one (the reason fenced locks exist —
    hazelcast.clj's fence bookkeeping:321-345)."""

    def check(self, test, history, opts=None):
        fences = [(op.index, op.value) for op in history
                  if op.f == "acquire" and op.is_ok
                  and isinstance(op.value, int)]
        errors = [
            {"index": i2, "fence": f2, "after-fence": f1}
            for (i1, f1), (i2, f2) in zip(fences, fences[1:])
            if f2 <= f1
        ]
        return {"valid?": not errors,
                "acquisition-count": len(fences),
                "errors": errors[:10]}


# -- workloads ----------------------------------------------------------------

def _w_unique_ids(options):
    def generate(test, ctx):
        return {"f": "generate", "value": None}

    return {"client": HzIdClient(),
            "checker": jchecker.unique_ids(),
            "generator": gen.clients(generate)}


def _w_cas_long(options):
    def r(test, ctx):
        return {"f": "read", "value": None}

    def w(test, ctx):
        return {"f": "write", "value": gen.RNG.randrange(5)}

    def cas(test, ctx):
        return {"f": "cas", "value": [gen.RNG.randrange(5),
                                      gen.RNG.randrange(5)]}

    return {"client": HzCasLongClient(),
            "checker": jchecker.linearizable(
                cas_register(0), algorithm="competition",
                device=options.get("device")),
            "generator": gen.clients(
                gen.stagger(0.02, gen.mix([r, w, cas])))}


def _w_queue(options):
    counter = iter(range(10 ** 9))

    def enq(test, ctx):
        return {"f": "enqueue", "value": next(counter)}

    def deq(test, ctx):
        return {"f": "dequeue", "value": None}

    time_limit = options.get("time_limit") or 10
    return {
        "client": HzQueueClient(),
        "checker": jchecker.total_queue(),
        "generator": gen.phases(
            gen.time_limit(max(1, time_limit - 3),
                           gen.clients(
                               gen.stagger(0.01, gen.mix([enq, deq])))),
            gen.clients(gen.each_thread(gen.once(
                lambda test, ctx: {"f": "drain", "value": None})))),
        "wrap_time": False,
    }


def _w_lock(options):
    return {"client": HzLockClient(),
            "checker": jchecker.compose({
                "mutex": jchecker.linearizable(
                    mutex(), algorithm="competition",
                    device=options.get("device")),
                "fences": FenceChecker(),
            }),
            "generator": gen.clients(gen.stagger(0.02, gen.mix(
                [gen.repeat({"f": "acquire", "value": None}),
                 gen.repeat({"f": "release", "value": None})]))),
            # locks are sessions: process faults WOULD break them
            # (proven in tests); the fault-free tier checks the
            # protocol itself
            "nemesis_override": jnemesis.Noop()}


def _w_map_set(options):
    from ..workloads import sets
    w = sets.workload({"time_limit":
                       max(1, (options.get("time_limit") or 10) - 3)})
    return {**w, "client": HzMapSetClient(), "wrap_time": False}


WORKLOADS = {
    "unique-ids": _w_unique_ids,
    "cas-long": _w_cas_long,
    "queue": _w_queue,
    "lock": _w_lock,
    "map-set": _w_map_set,
}

#: the workloads whose checks run kernels: the long register's and the
#: lock's mutex competition races (their device lane)
DEVICE_WORKLOADS = ("cas-long", "lock")


def hazelcast_test(options: dict) -> dict:
    """The checks of `DEVICE_WORKLOADS` run their kernels on
    `options["device"]` (default the card), resolved here, so that a
    missing card raises before any node is set up."""
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    which = options.get("workload") or "cas-long"
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
        db: jdb.DB = MiniHzDB()
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, test["nodes"][0]))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "hazelcast-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "jar":
        db = HazelcastDB()
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    nemesis = w.get("nemesis_override") or \
        jnemesis.node_start_stopper(
            retryclient.kill_targets(mode),
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node))
    workload_gen = retryclient.standard_generator(
        w, nemesis, options.get("nemesis_interval") or 3.0,
        options.get("time_limit") or 10)
    return {
        "name": options.get("name") or f"hazelcast-{which}-{mode}",
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
        **{k: v for k, v in w.items()
           if k not in ("checker", "generator", "client",
                        "wrap_time", "nemesis_override")},
        **extra,
    }


def hazelcast_tests(options: dict):
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
        opts["name"] = f"{options.get('name') or 'hazelcast'}-{name}"
        yield hazelcast_test(opts)


HAZELCAST_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo frame-protocol servers) or jar "
                 "(real hazelcast on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("sandbox", metavar="DIR", default="hazelcast-cluster"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the cas-long / lock checks' kernels run (default: "
                 "the card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": hazelcast_test,
                           "opt_spec": HAZELCAST_OPTS}),
    **cli.test_all_cmd({"tests_fn": hazelcast_tests,
                        "opt_spec": HAZELCAST_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
