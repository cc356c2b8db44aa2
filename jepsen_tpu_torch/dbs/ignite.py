"""Apache Ignite test suite (ignite/src/jepsen/ignite{,.bank,
.register,.nemesis}.clj + runner.clj).

Hazelcast covers the data-grid family's *primitives*; ignite's suite
is the family's *cache/transaction* exemplar, and its substance is
the CONFIGURATION LATTICE the reference's runner sweeps
(runner.clj:34-76 × ignite.clj:152-176): every workload runs under a
cache config (atomicity TRANSACTIONAL/ATOMIC, mode
PARTITIONED/REPLICATED, backups, readFromBackup,
writeSynchronizationMode) and a transaction config (concurrency
PESSIMISTIC/OPTIMISTIC × isolation READ_COMMITTED/REPEATABLE_READ/
SERIALIZABLE). This module keeps that lattice: configs ride the test
map, the mini server IMPLEMENTS the two concurrency models (entry
locks with deadlock-timeout for PESSIMISTIC — ignite's
TransactionTimeoutException; version validation at commit for
OPTIMISTIC SERIALIZABLE — TransactionOptimisticException), and
``ignite_tests`` expands the same combinatorial matrix the runner
does.

Workloads:

- ``register`` (register.clj:17-62) — independent-keyed cache
  get/put/replace(k, old, new), checked linearizable against the CAS
  register model.
- ``bank`` (bank.clj:24-131) — transfers inside explicit txns started
  with the test's transaction config; reads are transactional getAll.
  Conserved-total bank checker.

The wire is a FROM-SCRATCH binary protocol in the shape of Ignite's
thin-client protocol: a version handshake, then little-endian frames
`length u32 | op u16 | request-id i64 | JSON payload`. ``mini`` mode
(default) runs LIVE in-repo servers; the ``pds`` axis is real — with
persistence off, a kill -9 loses the grid's data, exactly what the
reference's persistence toggle governs (ignite.clj:115-121 template
``##pds##``). ``zip`` mode emits the real automation (jdk8 + binary
zip + discovery-address XML + activation, ignite.clj:69-150),
command-assertion tested.

The port's copy of `jepsen_tpu/dbs/ignite.py`. Its own choices: the mini
grid servers listen from `MINI_BASE_PORT` 31750 (the reference's from
28900, so that both packages' servers can run on one host at once; below
Linux's ephemeral range, 32768-60999; `zip` mode keeps the thin client's
`PORT` 10800); `--device` on `test` and `test-all`, passed to the
`register` workload's competition race, whose device lane runs the WGL
chunk kernels (default the card: a missing card raises before any node is
set up, `--device cpu` runs their plain PyTorch versions; the bank's check
runs on the host and takes no device); the store root `store/torch`.
`MINIIGNITE_SRC` is the reference's, byte for byte.

    python -m jepsen_tpu_torch.dbs.ignite test --nodes i1 \
        --workload register --time-limit 8 --device cpu
"""

from __future__ import annotations

import json
import socket
import struct
import sys
from typing import Optional

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from .. import net as jnet
from ..control import localexec, nodeutil
from ..independent import KV, tuple_
from ..ledger import BASE_DIR
from ..os_setup import Debian
from ..util import resolve_device
from . import miniserver, retryclient

VERSION = "2.7.0"  # reference era (ignite/project.clj)
PORT = 10800       # thin client port
MINI_BASE_PORT = 31750

# thin-protocol op codes (simplified)
OP_HANDSHAKE = 1
OP_CACHE_GET = 1000
OP_CACHE_PUT = 1001
OP_CACHE_REPLACE_IF_EQUALS = 1010
OP_CACHE_GET_ALL = 1003
OP_TX_START = 6000
OP_TX_COMMIT = 6001
OP_TX_ROLLBACK = 6002

CACHE_ATOMICITY = ("TRANSACTIONAL", "ATOMIC")
CACHE_MODES = ("PARTITIONED", "REPLICATED")
WRITE_SYNC_MODES = ("FULL_SYNC", "PRIMARY_SYNC", "FULL_ASYNC")
TX_CONCURRENCY = ("PESSIMISTIC", "OPTIMISTIC")
TX_ISOLATION = ("READ_COMMITTED", "REPEATABLE_READ", "SERIALIZABLE")


class IgniteError(Exception):
    pass


class TxConflict(IgniteError):
    """OPTIMISTIC SERIALIZABLE validation failure or PESSIMISTIC
    lock-wait timeout — aborted, retryable."""


def cache_config(options: dict, name: str) -> dict:
    """The reference's get-cache-config (ignite.clj:152-161)."""
    cfg = {
        "name": name,
        "atomicity": options.get("cache_atomicity") or "TRANSACTIONAL",
        "mode": options.get("cache_mode") or "PARTITIONED",
        "backups": int(options.get("backups") or 1),
        "read_from_backup": bool(options.get("read_from_backup",
                                             True)),
        "write_sync": options.get("write_sync") or "FULL_SYNC",
    }
    if cfg["atomicity"] not in CACHE_ATOMICITY:
        raise ValueError(f"bad atomicity {cfg['atomicity']!r}")
    if cfg["mode"] not in CACHE_MODES:
        raise ValueError(f"bad cache mode {cfg['mode']!r}")
    if cfg["write_sync"] not in WRITE_SYNC_MODES:
        raise ValueError(f"bad write sync {cfg['write_sync']!r}")
    return cfg


def transaction_config(options: dict) -> dict:
    """get-transaction-config (ignite.clj:163-166)."""
    cfg = {"concurrency": options.get("tx_concurrency")
                          or "PESSIMISTIC",
           "isolation": options.get("tx_isolation")
                        or "REPEATABLE_READ"}
    if cfg["concurrency"] not in TX_CONCURRENCY:
        raise ValueError(f"bad tx concurrency {cfg['concurrency']!r}")
    if cfg["isolation"] not in TX_ISOLATION:
        raise ValueError(f"bad tx isolation {cfg['isolation']!r}")
    return cfg


# -- wire client -------------------------------------------------------------

class IgniteConn:
    """One thin-client connection: version handshake, then
    request/response frames; at most one open transaction."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.rf = self.sock.makefile("rb")
        self.req_id = 0
        self._handshake()

    def _send_frame(self, op: int, payload: dict):
        body = json.dumps(payload).encode()
        self.sock.sendall(struct.pack("<IHq", len(body) + 10, op,
                                      self.req_id) + body)

    def _read_frame(self) -> tuple[int, dict]:
        hdr = self.rf.read(4)
        if len(hdr) < 4:
            raise ConnectionError("short frame length")
        n = struct.unpack("<I", hdr)[0]
        raw = self.rf.read(n)
        if len(raw) < n:
            raise ConnectionError("short frame body")
        _, rid = struct.unpack("<Hq", raw[:10])
        return rid, json.loads(raw[10:])

    def _handshake(self):
        self._send_frame(OP_HANDSHAKE, {"version": [2, 7, 0],
                                        "client": "thin"})
        _, resp = self._read_frame()
        if not resp.get("success"):
            raise IgniteError(f"handshake refused: {resp}")

    def request(self, op: int, payload: dict) -> dict:
        self.req_id += 1
        self._send_frame(op, payload)
        rid, resp = self._read_frame()
        if rid != self.req_id:
            raise ConnectionError("request-id mismatch")
        if "err" in resp:
            if resp.get("conflict"):
                raise TxConflict(resp["err"])
            raise IgniteError(resp["err"])
        return resp

    # -- cache ops (tx=None means implicit single-op txn) --
    def get(self, cache: str, key, tx: Optional[int] = None):
        return self.request(OP_CACHE_GET, {"cache": cache, "key": key,
                                           "tx": tx})["value"]

    def get_all(self, cache: str, keys: list,
                tx: Optional[int] = None) -> dict:
        return self.request(OP_CACHE_GET_ALL,
                            {"cache": cache, "keys": keys,
                             "tx": tx})["value"]

    def put(self, cache: str, key, value, tx: Optional[int] = None):
        self.request(OP_CACHE_PUT, {"cache": cache, "key": key,
                                    "value": value, "tx": tx})

    def replace(self, cache: str, key, old, new) -> bool:
        return self.request(OP_CACHE_REPLACE_IF_EQUALS,
                            {"cache": cache, "key": key, "old": old,
                             "new": new})["value"]

    def tx_start(self, concurrency: str, isolation: str) -> int:
        return self.request(OP_TX_START,
                            {"concurrency": concurrency,
                             "isolation": isolation})["tx"]

    def tx_commit(self, tx: int):
        self.request(OP_TX_COMMIT, {"tx": tx})

    def tx_rollback(self, tx: int):
        self.request(OP_TX_ROLLBACK, {"tx": tx})

    def close(self):
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


# -- the LIVE mini server ----------------------------------------------------

MINIIGNITE_SRC = r'''
import argparse, json, os, socketserver, struct, threading, time

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
p.add_argument("--pds", default="true")
args = p.parse_args()

PDS = args.pds == "true"
LOG_PATH = os.path.join(args.dir, "miniignite.jsonl")
GIANT = threading.Lock()          # guards CACHES/VERSIONS/TXNS maps
CACHES = {}                        # cache -> {key: value}
VERSIONS = {}                      # cache -> {key: int}
ENTRY_LOCKS = {}                   # (cache, key) -> tx id holding it
LOCK_FREED = threading.Condition(GIANT)
TXNS = {}                          # tx id -> state dict
NEXT_TX = [1]
LOCK_WAIT_S = 3.0                  # deadlock resolution by timeout

def persist(writes):
    if not PDS:
        return
    rec = json.dumps([[c, k, v] for (c, k), v in writes.items()])
    with open(LOG_PATH, "a") as fh:
        fh.write(rec + "\n")
        fh.flush()
        os.fsync(fh.fileno())

def replay():
    if not (PDS and os.path.exists(LOG_PATH)):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                rows = json.loads(line)
            except ValueError:
                break  # torn tail
            for c, k, v in rows:
                CACHES.setdefault(c, {})[k] = v
                vs = VERSIONS.setdefault(c, {})
                vs[k] = vs.get(k, 0) + 1

def cache(c):
    return CACHES.setdefault(c, {})

def version(c, k):
    return VERSIONS.setdefault(c, {}).get(k, 0)

def bump(c, k):
    vs = VERSIONS.setdefault(c, {})
    vs[k] = vs.get(k, 0) + 1

def acquire(txid, c, k):
    """PESSIMISTIC entry lock; GIANT held. Timeout = deadlock abort
    (TransactionTimeoutException)."""
    tx = TXNS[txid]
    if (c, k) in tx["locks"]:
        return
    deadline = time.monotonic() + LOCK_WAIT_S
    while ENTRY_LOCKS.get((c, k)) not in (None, txid):
        rest = deadline - time.monotonic()
        if rest <= 0:
            raise Conflict("lock wait timeout on %s[%r]" % (c, k))
        LOCK_FREED.wait(rest)
    ENTRY_LOCKS[(c, k)] = txid
    tx["locks"].add((c, k))

def release(txid):
    tx = TXNS.pop(txid, None)
    if tx is None:
        return
    for ck in tx["locks"]:
        if ENTRY_LOCKS.get(ck) == txid:
            del ENTRY_LOCKS[ck]
    LOCK_FREED.notify_all()

class Conflict(Exception):
    pass

def tx_get(txid, c, k):
    tx = TXNS[txid]
    if (c, k) in tx["writes"]:
        return tx["writes"][(c, k)]
    if tx["concurrency"] == "PESSIMISTIC" and \
            tx["isolation"] != "READ_COMMITTED":
        acquire(txid, c, k)
    if tx["isolation"] != "READ_COMMITTED":
        if (c, k) not in tx["reads"]:
            tx["reads"][(c, k)] = version(c, k)
    return cache(c).get(k)

def tx_put(txid, c, k, v):
    tx = TXNS[txid]
    if tx["concurrency"] == "PESSIMISTIC":
        acquire(txid, c, k)
    else:
        tx["reads"].setdefault((c, k), version(c, k))
    tx["writes"][(c, k)] = v

def tx_commit(txid):
    tx = TXNS[txid]
    if tx["concurrency"] == "OPTIMISTIC" and \
            tx["isolation"] == "SERIALIZABLE":
        for (c, k), seen in tx["reads"].items():
            if version(c, k) != seen:
                release(txid)
                raise Conflict("optimistic validation failed on "
                               "%s[%r]" % (c, k))
    for (c, k), v in tx["writes"].items():
        cache(c)[k] = v
        bump(c, k)
    persist(tx["writes"])
    release(txid)

class Conn(socketserver.StreamRequestHandler):
    def send_frame(self, op, rid, payload):
        body = json.dumps(payload).encode()
        self.wfile.write(struct.pack("<IHq", len(body) + 10, op, rid)
                         + body)
        self.wfile.flush()

    def read_frame(self):
        hdr = self.rfile.read(4)
        if len(hdr) < 4:
            return None
        n = struct.unpack("<I", hdr)[0]
        raw = self.rfile.read(n)
        if len(raw) < n:
            return None
        op, rid = struct.unpack("<Hq", raw[:10])
        return op, rid, json.loads(raw[10:])

    def handle(self):
        self.my_txns = set()
        frame = self.read_frame()
        if frame is None or frame[0] != 1:
            return
        self.send_frame(1, frame[1], {"success": True,
                                      "version": [2, 7, 0]})
        try:
            while True:
                frame = self.read_frame()
                if frame is None:
                    return
                op, rid, q = frame
                try:
                    with GIANT:
                        resp = self.dispatch(op, q)
                except Conflict as e:
                    resp = {"err": str(e), "conflict": True}
                except Exception as e:
                    resp = {"err": "%s: %s" % (type(e).__name__, e)}
                self.send_frame(op, rid, resp)
        finally:
            with GIANT:
                for txid in list(self.my_txns):
                    release(txid)

    def dispatch(self, op, q):
        if op == 6000:  # TX_START
            txid = NEXT_TX[0]
            NEXT_TX[0] += 1
            TXNS[txid] = {"concurrency": q["concurrency"],
                          "isolation": q["isolation"],
                          "reads": {}, "writes": {}, "locks": set()}
            self.my_txns.add(txid)
            return {"tx": txid}
        if op == 6001:  # TX_COMMIT
            if q["tx"] not in TXNS:
                raise Conflict("no such transaction")
            tx_commit(q["tx"])
            self.my_txns.discard(q["tx"])
            return {}
        if op == 6002:  # TX_ROLLBACK
            release(q["tx"])
            self.my_txns.discard(q["tx"])
            return {}
        c, tx = q["cache"], q.get("tx")
        if tx is not None and tx not in TXNS:
            raise Conflict("no such transaction")
        if op == 1000:  # GET
            if tx is None:
                return {"value": cache(c).get(q["key"])}
            return {"value": tx_get(tx, c, q["key"])}
        if op == 1003:  # GET_ALL
            if tx is None:
                vals = {k: cache(c).get(k) for k in q["keys"]}
            else:
                vals = {k: tx_get(tx, c, k) for k in q["keys"]}
            return {"value": vals}
        if op == 1001:  # PUT
            if tx is None:
                cache(c)[q["key"]] = q["value"]
                bump(c, q["key"])
                persist({(c, q["key"]): q["value"]})
            else:
                tx_put(tx, c, q["key"], q["value"])
            return {}
        if op == 1010:  # REPLACE_IF_EQUALS (atomic, non-tx)
            cur = cache(c).get(q["key"])
            if cur != q["old"]:
                return {"value": False}
            cache(c)[q["key"]] = q["new"]
            bump(c, q["key"])
            persist({(c, q["key"]): q["new"]})
            return {"value": True}
        raise ValueError("unknown op %d" % op)

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

replay()
print("miniignite serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Conn).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "ignite_ports")


class MiniIgniteDB(miniserver.MiniServerDB):
    script = "miniignite.py"
    src = MINIIGNITE_SRC
    pidfile = "miniignite.pid"
    logfile = "miniignite.log"
    data_files = ("miniignite.jsonl",)

    def __init__(self, pds: bool = True):
        self.pds = pds

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", ".", "--pds",
                "true" if self.pds else "false"]


SERVER_DIR = "/opt/ignite/"
LOGFILE = SERVER_DIR + "node.log"


def server_xml(test: dict, client_mode: bool, pds: bool) -> str:
    """The discovery/persistence config the reference templates
    (ignite.clj:108-121): static IP finder over every node's
    47500..47509 discovery range."""
    addrs = "\n".join(f"    <value>{n}:47500..47509</value>"
                      for n in test["nodes"])
    return (f"<igniteConfiguration clientMode=\"{str(client_mode).lower()}\""
            f" persistenceEnabled=\"{str(pds).lower()}\">\n"
            f"  <discoveryAddresses>\n{addrs}\n"
            f"  </discoveryAddresses>\n</igniteConfiguration>\n")


class IgniteDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real grid automation (ignite.clj:69-150): jdk8 + binary zip,
    per-node server XML, ignite.sh start, topology-snapshot await,
    control.sh activation; nuke on teardown."""

    def __init__(self, version: str = VERSION, pds: bool = True):
        self.version = version
        self.pds = pds

    def zip_url(self) -> str:
        return (f"https://archive.apache.org/dist/ignite/"
                f"{self.version}/apache-ignite-{self.version}-bin.zip")

    def setup(self, test, node):
        with control.su():
            control.exec_("apt-get", "install", "-y",
                          "openjdk-8-jre-headless")
            nodeutil.install_archive(self.zip_url(), SERVER_DIR)
            nodeutil.meh(control.exec_, "adduser",
                         "--disabled-password", "--gecos", "",
                         "ignite")
            control.exec_("chown", "-R", "ignite:ignite", SERVER_DIR)
        # config + daemon as the ignite user (ignite.clj:131-135
        # c/sudo user): the dir is ignite-owned after the chown
        with control.sudo_user("ignite"):
            nodeutil.write_file(
                server_xml(test, False, self.pds),
                f"{SERVER_DIR}server-ignite-{node}.xml")
        self.start(test, node)
        # await-cluster-started (ignite.clj:78-87): the topology
        # snapshot line must show every server, then activate
        n = len(test["nodes"])
        control.exec_(
            "bash", "-c",
            f"for i in $(seq 60); do egrep -q "
            f"'Topology snapshot \\[.*servers={n},' {LOGFILE} "
            f"&& exit 0; sleep 3; done; exit 1")
        with control.cd(SERVER_DIR):
            control.exec_("bin/control.sh", "--activate",
                          "--host", node)

    def teardown(self, test, node):
        with control.su():
            # grepkill, NOT pkill -f: the remote wrapper's own
            # command line matches -f patterns (nodeutil.grepkill)
            nodeutil.meh(nodeutil.grepkill,
                         "org.apache.ignite.startup.cmdline."
                         "CommandLineStartup")
            control.exec_("rm", "-rf", SERVER_DIR)

    def start(self, test, node):
        with control.sudo_user("ignite"), control.cd(SERVER_DIR):
            control.exec_(
                "bin/ignite.sh",
                f"{SERVER_DIR}server-ignite-{node}.xml", "-v",
                control.lit(f">>{LOGFILE} 2>&1 &"))
        return "started"

    def kill(self, test, node):
        with control.su():
            nodeutil.meh(nodeutil.grepkill,
                         "org.apache.ignite.startup.cmdline."
                         "CommandLineStartup")
        return "killed"

    def log_files(self, test, node):
        return [LOGFILE]


# -- clients -----------------------------------------------------------------

class _IgniteBase(retryclient.RetryClient):
    """Shared connect-retry plumbing; a mid-handshake refusal counts
    as the restart window too."""

    retry_excs = (OSError, IgniteError)
    default_port = PORT

    def _connect(self, host: str, port: int) -> IgniteConn:
        return IgniteConn(host, port, timeout=self.timeout)


class IgniteRegisterClient(_IgniteBase):
    """register.clj:17-47: cache get/put/replace over independent
    [k v] keys."""

    CACHE = "REGISTER"

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, v = kv
        f = op["f"]
        try:
            conn = self._conn(test)
            key = f"k{k}"
            if f == "read":
                return {**op, "type": "ok",
                        "value": tuple_(k, conn.get(self.CACHE, key))}
            if f == "write":
                conn.put(self.CACHE, key, int(v))
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                okd = conn.replace(self.CACHE, key, int(old),
                                   int(new))
                return {**op, "type": "ok" if okd else "fail"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, IgniteError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class IgniteBankClient(_IgniteBase):
    """bank.clj:67-109: transactional transfers/reads under the
    test's transaction config; conflicts (optimistic validation,
    pessimistic lock timeouts) map to fail — the txn did not apply."""

    CACHE = "ACCOUNTS"

    def setup(self, test):
        conn = self._conn(test)
        accounts = test["accounts"]
        total = test["total-amount"]
        per, rem = divmod(total, len(accounts))
        tx = conn.tx_start("PESSIMISTIC", "REPEATABLE_READ")
        for i, a in enumerate(accounts):
            if conn.get(self.CACHE, f"a{a}", tx=tx) is None:
                conn.put(self.CACHE, f"a{a}",
                         per + (1 if i < rem else 0), tx=tx)
        conn.tx_commit(tx)

    def invoke(self, test, op):
        f = op["f"]
        tc = test["tx_config"]
        try:
            conn = self._conn(test)
            if f == "read":
                tx = conn.tx_start(tc["concurrency"],
                                   tc["isolation"])
                try:
                    vals = conn.get_all(
                        self.CACHE,
                        [f"a{a}" for a in test["accounts"]], tx=tx)
                    conn.tx_commit(tx)
                except TxConflict as e:
                    # roll back, or the server keeps the tx's
                    # partially-acquired entry locks alive
                    try:
                        conn.tx_rollback(tx)
                    except (OSError, IgniteError):
                        self._drop()
                    return {**op, "type": "fail",
                            "error": str(e)[:200]}
                return {**op, "type": "ok",
                        "value": {a: vals.get(f"a{a}")
                                  for a in test["accounts"]}}
            if f == "transfer":
                t = op["value"]
                src, dst, amt = t["from"], t["to"], t["amount"]
                tx = conn.tx_start(tc["concurrency"],
                                   tc["isolation"])
                try:
                    b1 = (conn.get(self.CACHE, f"a{src}", tx=tx)
                          or 0) - amt
                    b2 = (conn.get(self.CACHE, f"a{dst}", tx=tx)
                          or 0) + amt
                    if b1 < 0 or b2 < 0:
                        conn.tx_rollback(tx)
                        return {**op, "type": "fail"}
                    conn.put(self.CACHE, f"a{src}", b1, tx=tx)
                    conn.put(self.CACHE, f"a{dst}", b2, tx=tx)
                    conn.tx_commit(tx)
                except TxConflict as e:
                    try:
                        conn.tx_rollback(tx)
                    except (OSError, IgniteError):
                        self._drop()
                    return {**op, "type": "fail",
                            "error": str(e)[:200]}
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, IgniteError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


# -- workloads / test map ----------------------------------------------------

def _w_register(options):
    from ..workloads import linearizable_register
    w = linearizable_register.workload(
        {"nodes": options["nodes"],
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 100,
         "algorithm": "competition",
         "device": options.get("device")})
    return {**w, "client": IgniteRegisterClient()}


def _w_bank(options):
    from ..workloads import bank
    w = bank.workload(options)
    return {**w, "client": IgniteBankClient()}


WORKLOADS = {"register": _w_register, "bank": _w_bank}

#: the workloads whose checks run kernels: the register's competition race
#: (its device lane)
DEVICE_WORKLOADS = ("register",)


def ignite_test(options: dict) -> dict:
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

    pds = options.get("pds", True)
    cache_cfg = cache_config(options,
                             "ACCOUNTS" if which == "bank"
                             else "REGISTER")
    tx_cfg = transaction_config(options)
    client = w["client"]
    if mode == "mini":
        db: jdb.DB = MiniIgniteDB(pds=pds)
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, node))
        client.pin_primary = True
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "ignite-grid"),
            "ssh": {"dummy?": False},
        }
    elif mode == "zip":
        db = IgniteDB(options.get("version") or VERSION, pds=pds)
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    # ignite/nemesis.clj: kill-node or partition-random-halves
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
            lambda ns: [ns[0]],
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node))

    interval = options.get("nemesis_interval") or 5.0
    time_limit = options.get("time_limit") or 10
    # ignite.clj:168-176 generator: stagger + 5 s/1 s fault cycle
    workload_gen = gen.time_limit(
        time_limit,
        gen.nemesis(
            gen.cycle([gen.sleep(interval),
                       {"type": "info", "f": "start"},
                       gen.sleep(1.0),
                       {"type": "info", "f": "stop"}]),
            w["generator"]))
    pass_extra = {k: v for k, v in w.items()
                  if k not in ("checker", "generator", "client")}
    return {
        "name": options.get("name")
                or f"ignite-{which}-{tx_cfg['concurrency'].lower()}"
                   f"-{tx_cfg['isolation'].lower()}-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "cache_config": cache_cfg,
        "tx_config": tx_cfg,
        "pds": pds,
        "nemesis": nemesis,
        "checker": jchecker.compose({
            which: w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": workload_gen,
        **extra,
        **pass_extra,
    }


def ignite_tests(options: dict):
    """The runner's combinatorial matrix (runner.clj:34-76): workload
    × tx concurrency × isolation (transactional caches only). Where the
    sweep holds a workload of `DEVICE_WORKLOADS`, the device is resolved
    before the first test is made, so that a missing card raises before
    any node is set up."""
    which = options.get("workload")
    workloads = [which] if which else sorted(WORKLOADS)
    if any(n in DEVICE_WORKLOADS for n in workloads):
        options = {**options,
                   "device": resolve_device(options.get("device"))}
    for name in workloads:
        for conc in TX_CONCURRENCY:
            for iso in TX_ISOLATION:
                if name == "register" and (conc, iso) != (
                        "PESSIMISTIC", "REPEATABLE_READ"):
                    continue  # register is non-transactional
                opts = dict(options, workload=name,
                            tx_concurrency=conc, tx_isolation=iso)
                opts["name"] = (f"{options.get('name') or 'ignite'}-"
                                f"{name}-{conc.lower()}-{iso.lower()}")
                yield ignite_test(opts)


IGNITE_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo grid servers) or zip (real "
                 "apache-ignite on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("cache_atomicity", metavar="MODE", default="TRANSACTIONAL"),
    cli.Opt("cache_mode", metavar="MODE", default="PARTITIONED"),
    cli.Opt("backups", metavar="N", default=1, parse=int),
    cli.Opt("write_sync", metavar="MODE", default="FULL_SYNC"),
    cli.Opt("tx_concurrency", metavar="MODE", default="PESSIMISTIC"),
    cli.Opt("tx_isolation", metavar="MODE", default="REPEATABLE_READ"),
    cli.Opt("pds", metavar="BOOL", default=True,
            parse=lambda s: s not in ("0", "false", "no")),
    cli.Opt("nemesis", metavar="KIND", default="kill",
            help="kill (node-start-stopper) or partition"),
    cli.Opt("sandbox", metavar="DIR", default="ignite-grid"),
    cli.Opt("version", metavar="V", default=VERSION),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=5.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's kernels run (default: the "
                 "card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": ignite_test,
                           "opt_spec": IGNITE_OPTS}),
    **cli.test_all_cmd({"tests_fn": ignite_tests,
                        "opt_spec": IGNITE_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
