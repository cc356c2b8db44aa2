"""Aerospike test suite — the record-store family exemplar
(aerospike/src/aerospike/{core,support,cas_register,counter,set}.clj,
7 files / 1,262 LoC; the one reference suite that ships a TLA+ spec,
aerospike/spec/aerospike.tla — mirrored in the JAX package by
`jepsen_tpu/dbs/spec/aerospike_gen.tla`, exhaustively explored in CI).

Everything on the wire is a FROM-SCRATCH subset of the Aerospike
binary message protocol (the pgwire/BSON/RESP/AMQP/MySQL/SSH
discipline): 8-byte proto header (version 2, type 3 = AS_MSG, 48-bit
big-endian size), a 22-byte message header (info flags, result code,
GENERATION, field/op counts), namespace/set/key fields, and bin
operations (READ / WRITE / INCR) carrying typed values.

The suite's defining semantic is **generation CAS** — Aerospike's
optimistic concurrency: every record carries a generation counter,
and a write flagged EXPECT_GEN_EQUAL commits only if the record's
generation still matches the one the client fetched
(support.clj cas!: fetch -> transform -> write-with-generation;
GENERATION_ERROR otherwise). All three workloads ride it:

- ``cas-register`` — independent linearizable registers
  (cas_register.clj:44-104): read = fetch bin, cas = fetch + verify
  + write-with-gen ("skipping cas" when the read value mismatches),
  write = plain put.
- ``counter``      — INCR ops against one record with reads
  (counter.clj:43-78), `checker.counter` bounds.
- ``set``          — unique adds CAS-appended to one record's
  comma-list bin, final read, set checkers (set.clj).

``mini`` mode (default) runs LIVE in-repo servers speaking the
binary protocol with an fsync'd op log (kill -9 recovery) over
localexec; ``deb`` emits the real automation: local .deb install,
mesh-heartbeat aerospike.conf, service start / killall -9 asd
(support.clj:228-309), command-assertion tested.

The port's copy of `jepsen_tpu/dbs/aerospike.py`. Its own choices: the
mini servers listen from `MINI_BASE_PORT` 31650 (the reference's from
27400, so that both packages' servers can run on one host at once; below
Linux's ephemeral range, 32768-60999; `deb` mode keeps Aerospike's `PORT`
3000); `--device` on `test` and `test-all`, passed to the `cas-register`
workload's competition race, whose device lane runs the WGL chunk kernels
there (default the card: a missing card raises before any node is set up,
`--device cpu` runs their plain PyTorch versions; the counter's and the
set's checks run on the host and take no device); the store root
`store/torch`. `MINIAERO_SRC` is the reference's, byte for byte; the
port copies no `.tla` file.

    python -m jepsen_tpu_torch.dbs.aerospike test --nodes a1 \
        --workload cas-register --time-limit 3 --nemesis-interval 1 \
        --device cpu
"""

from __future__ import annotations

import struct
import sys
from typing import Optional

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

NAMESPACE = "jepsen"   # s/ans (support.clj)
MINI_BASE_PORT = 31650
PORT = 3000

# proto header
PROTO_VERSION = 2
MSG_TYPE = 3           # AS_MSG

# info1 / info2 flags
INFO1_READ = 0x01
INFO2_WRITE = 0x01
INFO2_GENERATION = 0x02   # commit only if generation matches

# result codes
OK = 0
NOT_FOUND = 2
GENERATION_ERROR = 3

# field types
FIELD_NAMESPACE = 0
FIELD_SET = 1
FIELD_KEY = 2

# bin op types
OP_READ = 1
OP_WRITE = 2
OP_INCR = 5

# bin data types
T_INT = 1
T_STR = 3


class AeroError(Exception):
    def __init__(self, code: int, msg: str = ""):
        self.code = code
        super().__init__(f"result {code} {msg}".strip())


def _enc_field(ftype: int, data: bytes) -> bytes:
    return struct.pack("!IB", len(data) + 1, ftype) + data


def _enc_op(op: int, name: str, value) -> bytes:
    nb = name.encode()
    if value is None:
        payload = b""
        dt = 0
    elif isinstance(value, int):
        payload = struct.pack("!q", value)
        dt = T_INT
    else:
        payload = str(value).encode()
        dt = T_STR
    body = struct.pack("!BBBB", op, dt, 0, len(nb)) + nb + payload
    return struct.pack("!I", len(body)) + body


def encode_msg(info1: int, info2: int, generation: int,
               fields: list, ops: list) -> bytes:
    """One AS_MSG request: proto header + 22-byte message header +
    fields + ops."""
    body = struct.pack("!BBBBBBIIIHH",
                       22, info1, info2, 0, 0, 0,
                       generation, 0, 1000,
                       len(fields), len(ops))
    body += b"".join(fields) + b"".join(ops)
    size = len(body)
    return struct.pack("!BB", PROTO_VERSION, MSG_TYPE) \
        + size.to_bytes(6, "big") + body


def decode_msg(raw: bytes) -> tuple[int, int, dict]:
    """(result_code, generation, bins) from an AS_MSG reply body."""
    (hsz, _i1, _i2, _i3, _u, result, generation, _ttl, _txn,
     n_fields, n_ops) = struct.unpack("!BBBBBBIIIHH", raw[:22])
    i = hsz
    for _ in range(n_fields):
        fsz = struct.unpack("!I", raw[i:i + 4])[0]
        i += 4 + fsz
    bins = {}
    for _ in range(n_ops):
        osz = struct.unpack("!I", raw[i:i + 4])[0]
        op, dt, _ver, nlen = struct.unpack("!BBBB", raw[i + 4:i + 8])
        name = raw[i + 8:i + 8 + nlen].decode()
        payload = raw[i + 8 + nlen:i + 4 + osz]
        if dt == T_INT:
            bins[name] = struct.unpack("!q", payload)[0]
        elif dt == T_STR:
            bins[name] = payload.decode()
        else:
            bins[name] = None
        i += 4 + osz
    return result, generation, bins


class AeroConn:
    """One blocking binary-protocol connection."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        import socket
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.rf = self.sock.makefile("rb")

    def request(self, info1: int, info2: int, generation: int,
                set_name: str, key: str,
                ops: list) -> tuple[int, int, dict]:
        fields = [_enc_field(FIELD_NAMESPACE, NAMESPACE.encode()),
                  _enc_field(FIELD_SET, set_name.encode()),
                  _enc_field(FIELD_KEY, key.encode())]
        self.sock.sendall(encode_msg(info1, info2, generation,
                                     fields, ops))
        hdr = self.rf.read(8)
        if len(hdr) < 8:
            raise ConnectionError("short proto header")
        size = int.from_bytes(hdr[2:8], "big")
        body = self.rf.read(size)
        if len(body) < size:
            raise ConnectionError("short message body")
        return decode_msg(body)

    # -- the support.clj client verbs --
    def fetch(self, set_name: str, key: str) -> Optional[tuple]:
        """(generation, bins) or None when absent (s/fetch)."""
        code, generation, bins = self.request(
            INFO1_READ, 0, 0, set_name, key, [_enc_op(OP_READ, "", None)])
        if code == NOT_FOUND:
            return None
        if code != OK:
            raise AeroError(code)
        return generation, bins

    def put(self, set_name: str, key: str, bins: dict,
            expect_gen: Optional[int] = None) -> None:
        """Plain write, or generation-CAS when expect_gen is given
        (s/put! / s/cas! write phase)."""
        info2 = INFO2_WRITE
        generation = 0
        if expect_gen is not None:
            info2 |= INFO2_GENERATION
            generation = expect_gen
        code, _, _ = self.request(
            0, info2, generation, set_name, key,
            [_enc_op(OP_WRITE, n, v) for n, v in bins.items()])
        if code != OK:
            raise AeroError(code)

    def add(self, set_name: str, key: str, bin_name: str,
            delta: int) -> None:
        """Server-side increment (s/add!)."""
        code, _, _ = self.request(
            0, INFO2_WRITE, 0, set_name, key,
            [_enc_op(OP_INCR, bin_name, delta)])
        if code != OK:
            raise AeroError(code)

    def close(self):
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


# -- the LIVE mini server -----------------------------------------------------

MINIAERO_SRC = r'''
import argparse, json, os, socketserver, struct, threading

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

LOG_PATH = os.path.join(args.dir, "miniaero.log.jsonl")
RECORDS, LOCK = {}, threading.Lock()   # (set,key) -> [generation, bins]

T_INT, T_STR = 1, 3
OK, NOT_FOUND, GENERATION_ERROR = 0, 2, 3

def replay():
    if not os.path.exists(LOG_PATH):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail after a crash
            RECORDS[(rec["s"], rec["k"])] = [rec["g"], rec["b"]]

def persist(s, k, g, bins):
    with open(LOG_PATH, "a") as fh:
        fh.write(json.dumps({"s": s, "k": k, "g": g, "b": bins})
                 + "\n")
        fh.flush()
        os.fsync(fh.fileno())

def enc_op(op, name, value):
    nb = name.encode()
    if value is None:
        payload, dt = b"", 0
    elif isinstance(value, int):
        payload, dt = struct.pack("!q", value), T_INT
    else:
        payload, dt = str(value).encode(), T_STR
    body = struct.pack("!BBBB", op, dt, 0, len(nb)) + nb + payload
    return struct.pack("!I", len(body)) + body

def reply(result, generation, bins):
    ops = b"".join(enc_op(1, n, v) for n, v in bins.items())
    body = struct.pack("!BBBBBBIIIHH", 22, 0, 0, 0, 0, result,
                       generation, 0, 0, 0, len(bins)) + ops
    return struct.pack("!BB", 2, 3) + len(body).to_bytes(6, "big") \
        + body

class Conn(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            hdr = self.rfile.read(8)
            if len(hdr) < 8:
                return
            size = int.from_bytes(hdr[2:8], "big")
            raw = self.rfile.read(size)
            if len(raw) < size:
                return
            self.wfile.write(self.apply(raw))
            self.wfile.flush()

    def apply(self, raw):
        (hsz, info1, info2, _i3, _u, _res, generation, _ttl, _txn,
         n_fields, n_ops) = struct.unpack("!BBBBBBIIIHH", raw[:22])
        i = hsz
        fields = {}
        for _ in range(n_fields):
            fsz = struct.unpack("!I", raw[i:i + 4])[0]
            fields[raw[i + 4]] = raw[i + 5:i + 4 + fsz]
            i += 4 + fsz
        ops = []
        for _ in range(n_ops):
            osz = struct.unpack("!I", raw[i:i + 4])[0]
            op, dt, _v, nlen = struct.unpack("!BBBB", raw[i+4:i+8])
            name = raw[i + 8:i + 8 + nlen].decode()
            payload = raw[i + 8 + nlen:i + 4 + osz]
            if dt == T_INT:
                val = struct.unpack("!q", payload)[0]
            elif dt == T_STR:
                val = payload.decode()
            else:
                val = None
            ops.append((op, name, val))
            i += 4 + osz
        key = (fields.get(1, b"").decode(),
               fields.get(2, b"").decode())
        with LOCK:
            rec = RECORDS.get(key)
            if info2 & 0x01:  # WRITE
                if info2 & 0x02:  # EXPECT_GEN_EQUAL: the CAS
                    # a missing record has generation 0, so
                    # expect_gen=0 is an atomic create-if-absent
                    cur_gen = rec[0] if rec else 0
                    if cur_gen != generation:
                        return reply(GENERATION_ERROR, cur_gen, {})
                if rec is None:
                    rec = RECORDS[key] = [0, {}]
                for op, name, val in ops:
                    if op == 5:  # INCR
                        rec[1][name] = int(rec[1].get(name, 0)) \
                            + int(val)
                    else:        # WRITE
                        rec[1][name] = val
                rec[0] += 1
                persist(key[0], key[1], rec[0], rec[1])
                return reply(OK, rec[0], {})
            # READ
            if rec is None:
                return reply(NOT_FOUND, 0, {})
            return reply(OK, rec[0], rec[1])

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

replay()
print("miniaero serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Conn).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "aerospike_ports")


class MiniAeroDB(miniserver.MiniServerDB):
    script = "miniaero.py"
    src = MINIAERO_SRC
    pidfile = "miniaero.pid"
    logfile = "miniaero.out"
    data_files = ("miniaero.log.jsonl",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


class AerospikeDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real automation (support.clj install!:228-253,
    configure!:257-277, start!:284, kill via killall -9 asd:309):
    local .debs, mesh-heartbeat config, service lifecycle."""

    def setup(self, test, node):
        with control.su():
            control.exec_("dpkg", "-i", "--force-confnew",
                          control.lit("/tmp/jepsen/packages/"
                                      "aerospike-server-*.deb"))
            control.exec_("dpkg", "-i", "--force-confnew",
                          control.lit("/tmp/jepsen/packages/"
                                      "aerospike-tools-*.deb"))
            nodeutil.write_file(self.conf(test, node),
                                "/etc/aerospike/aerospike.conf")
            control.exec_("service", "aerospike", "start")
        nodeutil.await_tcp_port(PORT, timeout_s=60)

    @staticmethod
    def conf(test: dict, node: str) -> str:
        """Mesh-heartbeat cluster config (support.clj configure! and
        resources/aerospike.conf)."""
        mesh = "\n".join(
            f"    mesh-seed-address-port {n} 3002"
            for n in test["nodes"])
        return (f"service {{\n  user root\n  group root\n"
                f"  paxos-single-replica-limit 1\n}}\n"
                f"network {{\n  service {{ address any\n"
                f"    port {PORT} }}\n"
                f"  heartbeat {{ mode mesh\n    address {node}\n"
                f"    port 3002\n{mesh}\n"
                f"    interval 150\n    timeout 10 }}\n}}\n"
                f"namespace {NAMESPACE} {{\n"
                f"  replication-factor 3\n"
                f"  memory-size 1G\n"
                f"  storage-engine device {{\n"
                f"    file /opt/aerospike/data/{NAMESPACE}.dat\n"
                f"    filesize 1G\n  }}\n}}\n")

    def teardown(self, test, node):
        self.kill(test, node)
        with control.su():
            control.exec_("rm", "-rf",
                          control.lit("/opt/aerospike/data/*"))

    def start(self, test, node):
        with control.su():
            control.exec_("service", "aerospike", "start")
        return "started"

    def kill(self, test, node):
        with control.su():
            nodeutil.meh(control.exec_, "service", "aerospike",
                         "stop")
            nodeutil.grepkill("asd")
        return "killed"

    def log_files(self, test, node):
        return ["/var/log/aerospike/aerospike.log"]


# -- clients ------------------------------------------------------------------

class _AeroBase(retryclient.RetryClient):
    """Connection plumbing + with-errors discipline (support.clj
    with-errors: reads fail definite, mutations info on
    timeouts/connection loss)."""

    default_port = PORT

    def _connect(self, host, port) -> AeroConn:
        return AeroConn(host, port, timeout=self.timeout)


class AeroCasRegisterClient(_AeroBase):
    """cas_register.clj:44-77 over generation CAS. Values ride [k v]
    independent tuples; records live in set "cats"."""

    SET = "cats"

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"wants [k v] tuples, got {kv!r}")
        k, v = kv
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                rec = conn.fetch(self.SET, str(k))
                cur = rec[1].get("value") if rec else None
                return {**op, "type": "ok", "value": tuple_(k, cur)}
            if f == "write":
                conn.put(self.SET, str(k), {"value": int(v)})
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                rec = conn.fetch(self.SET, str(k))
                if rec is None or rec[1].get("value") != old:
                    # "skipping cas" (cas_register.clj:63-66)
                    return {**op, "type": "fail",
                            "error": "skipping cas"}
                try:
                    conn.put(self.SET, str(k), {"value": int(new)},
                             expect_gen=rec[0])
                except AeroError as e:
                    if e.code == GENERATION_ERROR:
                        return {**op, "type": "fail",
                                "error": "generation mismatch"}
                    raise
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, AeroError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class AeroCounterClient(_AeroBase):
    """counter.clj:43-60: INCR adds, bin reads."""

    SET = "counters"
    KEY = "pounce"

    def setup(self, test):
        conn = self._conn(test)
        rec = conn.fetch(self.SET, self.KEY)
        if rec is None:
            conn.put(self.SET, self.KEY, {"value": 0})

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                rec = conn.fetch(self.SET, self.KEY)
                val = int(rec[1].get("value", 0)) if rec else 0
                return {**op, "type": "ok", "value": val}
            if f == "add":
                conn.add(self.SET, self.KEY, "value",
                         int(op["value"]))
                return {**op, "type": "ok"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, AeroError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


class AeroSetClient(_AeroBase):
    """set.clj: unique adds CAS-appended into one record's
    comma-list bin — every add rides the generation check, so a
    racing add retries rather than silently clobbering."""

    SET = "sets"
    KEY = "all"

    def invoke(self, test, op):
        f = op["f"]
        try:
            conn = self._conn(test)
            if f == "read":
                rec = conn.fetch(self.SET, self.KEY)
                raw = rec[1].get("value") if rec else None
                vals = (sorted(int(x) for x in str(raw).split(","))
                        if raw else [])
                return {**op, "type": "ok", "value": vals}
            if f == "add":
                e = int(op["value"])
                for _ in range(16):
                    rec = conn.fetch(self.SET, self.KEY)
                    try:
                        if rec is None:
                            conn.put(self.SET, self.KEY,
                                     {"value": str(e)},
                                     expect_gen=0)
                        else:
                            conn.put(
                                self.SET, self.KEY,
                                {"value":
                                 f"{rec[1].get('value')},{e}"},
                                expect_gen=rec[0])
                        return {**op, "type": "ok"}
                    except AeroError as err:
                        if err.code != GENERATION_ERROR:
                            raise
                        continue  # contended: refetch and retry
                return {**op, "type": "fail",
                        "error": "cas retries exhausted"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, AeroError) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


# -- workloads ----------------------------------------------------------------

def _w_cas_register(options):
    from ..workloads import linearizable_register
    w = linearizable_register.workload(
        {"nodes": options["nodes"],
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("per_key_limit") or 100,
         "algorithm": "competition",
         "device": options.get("device")})
    return {**w, "client": AeroCasRegisterClient()}


def _w_counter(options):
    def add(test, ctx):
        return {"f": "add", "value": 1}

    def read(test, ctx):
        return {"f": "read", "value": None}

    return {"client": AeroCounterClient(),
            "checker": jchecker.counter(),
            "generator": gen.clients(
                gen.mix([add] * 9 + [read]))}


def _w_set(options):
    from ..workloads import sets
    w = sets.workload({"time_limit":
                       max(1, (options.get("time_limit") or 10) - 3)})
    return {**w, "client": AeroSetClient(), "wrap_time": False}


WORKLOADS = {"cas-register": _w_cas_register, "counter": _w_counter,
             "set": _w_set}

#: the workloads whose checks run kernels: the register's competition race
#: (its device lane)
DEVICE_WORKLOADS = ("cas-register",)


def aerospike_test(options: dict) -> dict:
    """The checks of `DEVICE_WORKLOADS` run their kernels on
    `options["device"]` (default the card), resolved here, so that a
    missing card raises before any node is set up."""
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    which = options.get("workload") or "cas-register"
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
        db: jdb.DB = MiniAeroDB()
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, test["nodes"][0]))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "aerospike-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "deb":
        db = AerospikeDB()
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    nemesis = jnemesis.node_start_stopper(
        retryclient.kill_targets(mode),
        lambda test, node: db.kill(test, node),
        lambda test, node: db.start(test, node))
    workload_gen = retryclient.standard_generator(
        w, nemesis, options.get("nemesis_interval") or 3.0,
        options.get("time_limit") or 10)
    pass_extra = {k: v for k, v in w.items()
                  if k not in ("checker", "generator", "client",
                               "wrap_time")}
    return {
        "name": options.get("name") or f"aerospike-{which}-{mode}",
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
        **pass_extra,
    }


def aerospike_tests(options: dict):
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
        opts["name"] = f"{options.get('name') or 'aerospike'}-{name}"
        yield aerospike_test(opts)


AEROSPIKE_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo binary-protocol servers) or "
                 "deb (real aerospike .debs on --ssh nodes)"),
    cli.Opt("workload", metavar="NAME", default=None,
            help=f"one of {', '.join(sorted(WORKLOADS))}"),
    cli.Opt("per_key_limit", metavar="N", default=100, parse=int),
    cli.Opt("sandbox", metavar="DIR", default="aerospike-cluster"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the cas-register check's kernels run (default: "
                 "the card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": aerospike_test,
                           "opt_spec": AEROSPIKE_OPTS}),
    **cli.test_all_cmd({"tests_fn": aerospike_tests,
                        "opt_spec": AEROSPIKE_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
