"""RabbitMQ test suite — the reference's queue-workload exemplar
(rabbitmq/src/jepsen/rabbitmq.clj:1-255): a durable queue driven by
enqueue-with-publisher-confirms / basic.get dequeues / drain, accounted
by the total-queue checker, plus the famous distributed-semaphore
workload (an unacked message as a mutex) checked linearizable.

Everything on the wire is a from-scratch AMQP 0-9-1 SUBSET — the same
discipline as the pgwire/BSON/RESP codecs in this package: protocol
header, method/header/body frames, connection.start/tune/open,
channel.open, confirm.select, queue.declare/purge, basic.publish (+
content header/body), basic.ack both directions (server->client IS the
publisher confirm), basic.get/get-ok/get-empty, basic.reject.

Two server modes (the disque pattern):

- ``deb`` — real-rabbit automation: deb install, erlang cookie,
  rabbitmqctl join_cluster from the primary, ha-policy mirroring
  (rabbitmq.clj:24-100), command-assertion tested.
- ``mini`` (default) — a LIVE in-repo AMQP server per node speaking
  the same subset: publisher confirms are sent only after the message
  is fsync'd to an AOF (the durability contract `:persistent true`
  buys), unacked deliveries are requeued on connection loss or
  reject — so kill -9 redelivers instead of losing. ``--volatile``
  confirms WITHOUT persisting: kill -9 then drops acknowledged
  messages, which total-queue must catch (the reference found exactly
  this class of loss in rabbit's mirrored queues).

The port's copy of `jepsen_tpu/dbs/rabbitmq.py`. Its own choices: the
mini brokers listen from `MINI_BASE_PORT` 31050 (the reference's from
23500, so that both packages' clusters can run on one host at once;
below Linux's ephemeral range, 32768-60999; `deb` mode keeps AMQP's
5672); `--device`, passed to the semaphore workload's mutex check, a
competition race whose device lane runs the WGL chunk kernels there
(default the card: a missing card raises before any node is set up,
`--device cpu` runs the plain PyTorch versions; the queue workload's
`total_queue` runs on the host and takes no device); the store root
`store/torch`.

    python -m jepsen_tpu_torch.dbs.rabbitmq test --nodes r1 \
        --workload semaphore --concurrency 3 --device cpu --time-limit 5
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import models
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..ledger import BASE_DIR
from ..os_setup import Debian
from ..util import resolve_device
from . import miniserver

VERSION = "3.5.6"  # rabbitmq.clj:27
DEB_URL = ("http://www.rabbitmq.com/releases/rabbitmq-server/"
           "v{v}/rabbitmq-server_{v}-1_all.deb")
QUEUE = "jepsen.queue"
SEM_QUEUE = "jepsen.semaphore"

MINI_BASE_PORT = 31050
MINI_PIDFILE = "minirabbit.pid"
MINI_LOGFILE = "minirabbit.log"

# -- AMQP 0-9-1 subset codec -------------------------------------------------
# One source of truth for both sides of the wire: exec'd into this
# module for the client, spliced into the mini server's uploaded
# source (miniserver.build_src style).

AMQP_COMMON_SRC = r'''
import struct as _struct

FRAME_METHOD, FRAME_HEADER, FRAME_BODY = 1, 2, 3
FRAME_END = 0xCE


def enc_shortstr(s):
    b = s.encode()
    if len(b) > 255:
        raise ValueError("shortstr too long")
    return bytes([len(b)]) + b


def enc_longstr(b):
    if isinstance(b, str):
        b = b.encode()
    return _struct.pack(">I", len(b)) + b


def enc_method(cls, mid, args=b""):
    return _struct.pack(">HH", cls, mid) + args


def write_frame(wf, ftype, channel, payload):
    wf.write(_struct.pack(">BHI", ftype, channel, len(payload))
             + payload + bytes([FRAME_END]))
    wf.flush()


def read_frame(rf):
    hdr = rf.read(7)
    if len(hdr) < 7:
        return None
    ftype, channel, size = _struct.unpack(">BHI", hdr)
    payload = rf.read(size)
    if len(payload) < size or rf.read(1) != bytes([FRAME_END]):
        raise ValueError("torn AMQP frame")
    return ftype, channel, payload


class Args:
    """Cursor over a method payload."""

    def __init__(self, b, off=0):
        self.b = b
        self.i = off

    def octet(self):
        v = self.b[self.i]
        self.i += 1
        return v

    def short(self):
        v = _struct.unpack_from(">H", self.b, self.i)[0]
        self.i += 2
        return v

    def long(self):
        v = _struct.unpack_from(">I", self.b, self.i)[0]
        self.i += 4
        return v

    def longlong(self):
        v = _struct.unpack_from(">Q", self.b, self.i)[0]
        self.i += 8
        return v

    def shortstr(self):
        n = self.b[self.i]
        v = self.b[self.i + 1:self.i + 1 + n].decode()
        self.i += 1 + n
        return v

    def longstr(self):
        n = _struct.unpack_from(">I", self.b, self.i)[0]
        v = self.b[self.i + 4:self.i + 4 + n]
        self.i += 4 + n
        return v

    def table(self):
        # skipped wholesale: the subset never reads table contents
        n = _struct.unpack_from(">I", self.b, self.i)[0]
        self.i += 4 + n
        return {}
'''

exec(AMQP_COMMON_SRC, globals())  # client side of the shared codec


class AmqpError(Exception):
    pass


class RabbitConn:
    """One blocking AMQP connection with a single channel (the
    reference opens a channel per op; one long-lived channel plus
    reopen-on-error covers the same surface)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        import socket
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.rf = self.sock.makefile("rb")
        self.wf = self.sock.makefile("wb")
        self.publish_seq = 0
        self.confirms = False
        self._handshake()

    # -- protocol bring-up --
    def _handshake(self):
        self.wf.write(b"AMQP\x00\x00\x09\x01")
        self.wf.flush()
        cls, mid, _ = self._expect_method(10, 10)  # connection.start
        self._send_method(0, 10, 11,               # start-ok
                          _struct.pack(">I", 0)    # empty client-props
                          + enc_shortstr("PLAIN")
                          + enc_longstr(b"\x00guest\x00guest")
                          + enc_shortstr("en_US"))
        cls, mid, args = self._expect_method(10, 30)  # tune
        a = Args(args)
        chan_max, frame_max, heartbeat = a.short(), a.long(), a.short()
        self._send_method(0, 10, 31,               # tune-ok
                          _struct.pack(">HIH", chan_max, frame_max, 0))
        self._send_method(0, 10, 40,               # connection.open
                          enc_shortstr("/") + enc_shortstr("") + b"\x00")
        self._expect_method(10, 41)                # open-ok
        self._send_method(1, 20, 10, enc_shortstr(""))  # channel.open
        self._expect_method(20, 11)                # open-ok

    def _send_method(self, channel, cls, mid, args=b""):
        write_frame(self.wf, FRAME_METHOD, channel,
                    enc_method(cls, mid, args))

    def _read_method(self):
        while True:
            fr = read_frame(self.rf)
            if fr is None:
                raise AmqpError("connection closed")
            ftype, channel, payload = fr
            if ftype == FRAME_METHOD:
                cls, mid = _struct.unpack_from(">HH", payload)
                return cls, mid, payload[4:]
            # heartbeats / stray content frames: skip

    def _expect_method(self, cls, mid):
        c, m, args = self._read_method()
        if (c, m) != (cls, mid):
            raise AmqpError(f"expected {cls}.{mid}, got {c}.{m}")
        return c, m, args

    # -- operations --
    def confirm_select(self):
        self._send_method(1, 85, 10, b"\x00")  # confirm.select
        self._expect_method(85, 11)
        self.confirms = True
        self.publish_seq = 0

    def queue_declare(self, queue: str, durable: bool = True):
        bits = 0b00010 if durable else 0  # passive,durable,excl,auto,nowait
        self._send_method(1, 50, 10,
                          _struct.pack(">H", 0) + enc_shortstr(queue)
                          + bytes([bits]) + _struct.pack(">I", 0))
        _, _, args = self._expect_method(50, 11)
        a = Args(args)
        a.shortstr()
        return a.long()  # message count

    def queue_purge(self, queue: str):
        self._send_method(1, 50, 30,
                          _struct.pack(">H", 0) + enc_shortstr(queue)
                          + b"\x00")
        self._expect_method(50, 31)

    def publish(self, queue: str, body: bytes,
                wait_confirm: bool = True) -> bool:
        """basic.publish to the default exchange + content frames;
        with confirms on, block for the broker's basic.ack/nack
        (rabbitmq.clj:155-165 wait-for-confirms). Returns acked?"""
        self._send_method(1, 60, 40,
                          _struct.pack(">H", 0) + enc_shortstr("")
                          + enc_shortstr(queue) + bytes([0]))
        # content header: class 60, weight 0, body size, delivery-mode
        # 2 (persistent) -> property flag bit 12
        hdr = _struct.pack(">HHQH", 60, 0, len(body), 1 << 12) \
            + bytes([2])
        write_frame(self.wf, FRAME_HEADER, 1, hdr)
        write_frame(self.wf, FRAME_BODY, 1, body)
        self.publish_seq += 1
        if not (self.confirms and wait_confirm):
            return True
        cls, mid, args = self._read_method()
        if (cls, mid) == (60, 80):    # basic.ack
            return True
        if (cls, mid) == (60, 120):   # basic.nack
            return False
        raise AmqpError(f"expected confirm, got {cls}.{mid}")

    def get(self, queue: str, no_ack: bool = False):
        """basic.get: (delivery_tag, body) or None when empty."""
        self._send_method(1, 60, 70,
                          _struct.pack(">H", 0) + enc_shortstr(queue)
                          + bytes([1 if no_ack else 0]))
        cls, mid, args = self._read_method()
        if (cls, mid) == (60, 72):    # get-empty
            return None
        if (cls, mid) != (60, 71):    # get-ok
            raise AmqpError(f"expected get-ok, got {cls}.{mid}")
        a = Args(args)
        tag = a.longlong()
        a.octet()       # redelivered
        a.shortstr()    # exchange
        a.shortstr()    # routing key
        a.long()        # message count
        fr = read_frame(self.rf)    # content header
        if fr is None or fr[0] != FRAME_HEADER:
            raise AmqpError("expected content header")
        size = _struct.unpack_from(">Q", fr[2], 4)[0]
        body = b""
        while len(body) < size:
            fr = read_frame(self.rf)
            if fr is None or fr[0] != FRAME_BODY:
                raise AmqpError("expected content body")
            body += fr[2]
        return tag, body

    def ack(self, tag: int):
        self._send_method(1, 60, 80, _struct.pack(">Q", tag) + b"\x00")

    def reject(self, tag: int, requeue: bool = True):
        self._send_method(1, 60, 90,
                          _struct.pack(">Q", tag)
                          + bytes([1 if requeue else 0]))

    def close(self):
        try:
            self.rf.close()
            self.wf.close()
            self.sock.close()
        except OSError:
            pass


# -- the LIVE mini broker ---------------------------------------------------

MINIRABBIT_SRC = r'''
import argparse, base64, os, socketserver, threading

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
p.add_argument("--volatile", action="store_true")
p.add_argument("--seed-semaphore", default=None,
               help="queue to seed with ONE message on a fresh boot "
                    "(atomic server-side: no client seeding race)")
args = p.parse_args()

AOF = os.path.join(args.dir, "rabbit.aof")
LOCK = threading.Lock()
QUEUES = {}     # name -> list of (mid, body)
MSEQ = [0]

__AMQP_COMMON__

def persist(line):
    if args.volatile:
        return
    with open(AOF, "ab") as fh:
        fh.write(line.encode() + b"\n")
        fh.flush()
        os.fsync(fh.fileno())

def replay():
    if args.volatile or not os.path.exists(AOF):
        return
    pubs, acked = {}, set()
    order = []
    with open(AOF, "rb") as fh:
        for raw in fh:
            parts = raw.decode("utf-8", "replace").split()
            if len(parts) >= 4 and parts[0] == "P":
                try:
                    body = base64.b64decode(parts[3])
                except Exception:
                    continue  # torn tail
                pubs[int(parts[1])] = (parts[2], body)
                order.append(int(parts[1]))
            elif len(parts) >= 2 and parts[0] == "A":
                acked.add(int(parts[1]))
    for mid in order:
        if mid not in acked:
            q, body = pubs[mid]
            QUEUES.setdefault(q, []).append((mid, body))
    if order:
        MSEQ[0] = max(order) + 1

class Conn(socketserver.StreamRequestHandler):
    def setup(self):
        super().setup()
        self.unacked = {}   # delivery tag -> (queue, mid, body)
        self.dtag = 0
        self.pseq = 0
        self.confirms = False
        self.pending_pub = None  # (queue,) awaiting header+body

    def send_method(self, channel, cls, mid, margs=b""):
        write_frame(self.wfile, FRAME_METHOD, channel,
                    enc_method(cls, mid, margs))

    def handle(self):
        if self.rfile.read(8) != b"AMQP\x00\x00\x09\x01":
            return
        self.send_method(0, 10, 10,      # connection.start
                         bytes([0, 9]) + _struct.pack(">I", 0)
                         + enc_longstr(b"PLAIN")
                         + enc_longstr(b"en_US"))
        try:
            while True:
                fr = read_frame(self.rfile)
                if fr is None:
                    return
                ftype, channel, payload = fr
                if ftype == FRAME_METHOD:
                    cls, mid = _struct.unpack_from(">HH", payload)
                    if not self.on_method(channel, cls, mid,
                                          payload[4:]):
                        return
                elif ftype == FRAME_HEADER and self.pending_pub:
                    self.body_size = _struct.unpack_from(
                        ">Q", payload, 4)[0]
                    self.body = b""
                    if self.body_size == 0:
                        self.finish_publish()
                elif ftype == FRAME_BODY and self.pending_pub:
                    self.body += payload
                    if len(self.body) >= self.body_size:
                        self.finish_publish()
        except (ValueError, OSError):
            return
        finally:
            with LOCK:  # requeue this connection's unacked deliveries
                for q, mid, body in self.unacked.values():
                    QUEUES.setdefault(q, []).insert(0, (mid, body))

    def finish_publish(self):
        q = self.pending_pub
        self.pending_pub = None
        with LOCK:
            mid = MSEQ[0]
            MSEQ[0] += 1
            persist("P %d %s %s" % (
                mid, q, base64.b64encode(self.body).decode()))
            QUEUES.setdefault(q, []).append((mid, self.body))
        self.pseq += 1
        if self.confirms:   # confirm AFTER the fsync: the contract
            self.send_method(1, 60, 80,
                             _struct.pack(">Q", self.pseq) + b"\x00")

    def on_method(self, channel, cls, mid, margs):
        a = Args(margs)
        if (cls, mid) == (10, 11):      # start-ok
            self.send_method(0, 10, 30,
                             _struct.pack(">HIH", 0, 131072, 0))
        elif (cls, mid) == (10, 31):    # tune-ok
            pass
        elif (cls, mid) == (10, 40):    # connection.open
            self.send_method(0, 10, 41, enc_shortstr(""))
        elif (cls, mid) == (20, 10):    # channel.open
            self.send_method(channel, 20, 11, enc_longstr(b""))
        elif (cls, mid) == (85, 10):    # confirm.select
            self.confirms = True
            self.pseq = 0
            self.send_method(channel, 85, 11)
        elif (cls, mid) == (50, 10):    # queue.declare
            a.short()
            q = a.shortstr()
            with LOCK:
                QUEUES.setdefault(q, [])
                n = len(QUEUES[q])
            self.send_method(channel, 50, 11,
                             enc_shortstr(q)
                             + _struct.pack(">II", n, 0))
        elif (cls, mid) == (50, 30):    # queue.purge
            a.short()
            q = a.shortstr()
            with LOCK:
                n = len(QUEUES.get(q, []))
                QUEUES[q] = []
            self.send_method(channel, 50, 31, _struct.pack(">I", n))
        elif (cls, mid) == (60, 40):    # basic.publish
            a.short()
            a.shortstr()                # exchange
            self.pending_pub = a.shortstr()  # routing key == queue
        elif (cls, mid) == (60, 70):    # basic.get
            a.short()
            q = a.shortstr()
            no_ack = a.octet()
            with LOCK:
                items = QUEUES.setdefault(q, [])
                item = items.pop(0) if items else None
                if item is not None and not no_ack:
                    self.dtag += 1
                    self.unacked[self.dtag] = (q, item[0], item[1])
            if item is None:
                self.send_method(channel, 60, 72, enc_shortstr(""))
            else:
                mid_, body = item
                self.send_method(channel, 60, 71,
                                 _struct.pack(">Q", self.dtag)
                                 + b"\x00" + enc_shortstr("")
                                 + enc_shortstr(q)
                                 + _struct.pack(">I", 0))
                write_frame(self.wfile, FRAME_HEADER, channel,
                            _struct.pack(">HHQH", 60, 0, len(body), 0))
                write_frame(self.wfile, FRAME_BODY, channel, body)
        elif (cls, mid) == (60, 80):    # basic.ack (client)
            tag = a.longlong()
            with LOCK:
                got = self.unacked.pop(tag, None)
                if got is not None:
                    persist("A %d" % got[1])
        elif (cls, mid) == (60, 90):    # basic.reject
            tag = a.longlong()
            requeue = a.octet()
            with LOCK:
                got = self.unacked.pop(tag, None)
                if got is not None and requeue:
                    QUEUES.setdefault(got[0], []).insert(
                        0, (got[1], got[2]))
                elif got is not None:
                    persist("A %d" % got[1])  # dead-lettered == gone
        elif (cls, mid) == (10, 50):    # connection.close
            self.send_method(0, 10, 51)
            return False
        return True

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

fresh = not (args.volatile or os.path.exists(AOF))
replay()
if args.seed_semaphore and fresh:
    mid = MSEQ[0]
    MSEQ[0] += 1
    persist("P %d %s %s" % (mid, args.seed_semaphore,
                            base64.b64encode(b"sem").decode()))
    QUEUES.setdefault(args.seed_semaphore, []).append((mid, b"sem"))
print("minirabbit serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Conn).serve_forever()
'''

MINIRABBIT_SRC = MINIRABBIT_SRC.replace("__AMQP_COMMON__",
                                        AMQP_COMMON_SRC)


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "rabbitmq_ports")


class MiniRabbitDB(miniserver.MiniServerDB):
    script = "minirabbit.py"
    src = MINIRABBIT_SRC
    pidfile = MINI_PIDFILE
    logfile = MINI_LOGFILE
    data_files = ("rabbit.aof",)

    def __init__(self, volatile: bool = False,
                 seed_semaphore: Optional[str] = None):
        self.volatile = volatile
        self.seed_semaphore = seed_semaphore

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", ".",
                *(["--volatile"] if self.volatile else []),
                *(["--seed-semaphore", self.seed_semaphore]
                  if self.seed_semaphore else [])]


class RabbitDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real-rabbit automation (rabbitmq.clj:24-100): deb install,
    shared erlang cookie, join_cluster from the primary, ha-mirroring
    policy; teardown nukes mnesia."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        with control.su():
            deb = nodeutil.cached_wget(DEB_URL.format(v=self.version))
            control.exec_("apt-get", "install", "-y", "erlang-nox")
            control.exec_("dpkg", "-i", deb)
            control.exec_("service", "rabbitmq-server", "stop")
            control.exec_("bash", "-c",
                          "echo jepsen-rabbitmq > "
                          "/var/lib/rabbitmq/.erlang.cookie")
            control.exec_("chmod", "600",
                          "/var/lib/rabbitmq/.erlang.cookie")
            control.exec_("service", "rabbitmq-server", "start")
            primary = test["nodes"][0]
            if node != primary:
                control.exec_("rabbitmqctl", "stop_app")
                control.exec_("rabbitmqctl", "join_cluster",
                              f"rabbit@{primary}")
                control.exec_("rabbitmqctl", "start_app")
            control.exec_("rabbitmqctl", "set_policy", "ha-maj",
                          "jepsen.",
                          '{"ha-mode": "exactly", "ha-params": 3, '
                          '"ha-sync-mode": "automatic"}')

    def teardown(self, test, node):
        with control.su():
            control.exec_("bash", "-c",
                          "killall -9 beam.smp epmd || true")
            control.exec_("rm", "-rf", "/var/lib/rabbitmq/mnesia/")
            control.exec_("service", "rabbitmq-server", "stop")

    def start(self, test, node):
        with control.su():
            control.exec_("service", "rabbitmq-server", "start")
        return "started"

    def kill(self, test, node):
        with control.su():
            control.exec_("bash", "-c",
                          "killall -9 beam.smp epmd || true")
        return "killed"

    def log_files(self, test, node):
        return ["/var/log/rabbitmq/rabbit.log"]


# -- clients ----------------------------------------------------------------

class RabbitQueueClient(jclient.Client):
    """enqueue (publish + wait-for-confirms) / dequeue (basic.get +
    ack) / drain (rabbitmq.clj:105-173). Once get returns a body the
    element counts as dequeued regardless of the ack round — an
    applied-but-unconfirmed ack must not surface as false loss; an
    unapplied one merely redelivers (duplicates are total-queue-legal)."""

    def __init__(self, port_fn=None, timeout: float = 5.0):
        self.port_fn = port_fn or (lambda test, node: (node, 5672))
        self.timeout = timeout
        self.node: Optional[str] = None
        self.conn: Optional[RabbitConn] = None

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout)
        c.node = node
        return c

    def _conn(self, test) -> RabbitConn:
        if self.conn is None:
            host, port = self.port_fn(test, self.node)
            self.conn = RabbitConn(host, port, self.timeout)
            self.conn.queue_declare(QUEUE)
            self.conn.confirm_select()
        return self.conn

    def _drop(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def _dequeue_once(self, test):
        conn = self._conn(test)
        got = conn.get(QUEUE, no_ack=False)
        if got is None:
            return None
        tag, body = got
        try:
            conn.ack(tag)
        except (OSError, AmqpError):
            self._drop()
        return int(body)

    def invoke(self, test, op):
        f = op["f"]
        try:
            if f == "enqueue":
                acked = self._conn(test).publish(
                    QUEUE, str(op["value"]).encode())
                return {**op, "type": "ok" if acked else "fail"}
            if f == "dequeue":
                v = self._dequeue_once(test)
                if v is None:
                    return {**op, "type": "fail", "error": "empty"}
                return {**op, "type": "ok", "value": v}
            if f == "drain":
                drained: list = []
                deadline = time.monotonic() + 15.0
                empty_since = None
                while time.monotonic() < deadline:
                    try:
                        v = self._dequeue_once(test)
                    except (OSError, ConnectionError, AmqpError) as e:
                        self._drop()
                        return {**op, "type": "info", "value": drained,
                                "error": str(e)[:200]}
                    now = time.monotonic()
                    if v is not None:
                        drained.append(v)
                        empty_since = None
                        continue
                    if empty_since is None:
                        empty_since = now
                    elif now - empty_since > 1.5:
                        return {**op, "type": "ok", "value": drained}
                    time.sleep(0.15)
                return {**op, "type": "info", "value": drained,
                        "error": "drain timeout"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, AmqpError) as e:
            self._drop()
            t = "fail" if f == "dequeue" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def close(self, test):
        self._drop()


class RabbitSemaphoreClient(jclient.Client):
    """The distributed-semaphore workload (rabbitmq.clj:177-255): ONE
    message in jepsen.semaphore; acquire = basic.get WITHOUT ack
    (holding the unacked delivery IS holding the mutex), release =
    basic.reject with requeue. Checked linearizable against the mutex
    model. The single token is seeded SERVER-side at broker boot
    (--seed-semaphore): client-side seeding would race (two seeders
    -> two tokens -> mutual exclusion silently broken), and in mini
    mode every client pins the one broker that holds the token."""

    def __init__(self, port_fn=None, timeout: float = 5.0):
        self.port_fn = port_fn or (lambda test, node: (node, 5672))
        self.timeout = timeout
        self.node: Optional[str] = None
        self.conn: Optional[RabbitConn] = None
        self.tag: Optional[int] = None

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout)
        c.node = node
        return c

    def _conn(self, test) -> RabbitConn:
        if self.conn is None:
            host, port = self.port_fn(test, self.node)
            self.conn = RabbitConn(host, port, self.timeout)
            self.conn.queue_declare(SEM_QUEUE)
        return self.conn

    def invoke(self, test, op):
        f = op["f"]
        try:
            if f == "acquire":
                if self.tag is not None:
                    return {**op, "type": "fail",
                            "error": "already-held"}
                got = self._conn(test).get(SEM_QUEUE, no_ack=False)
                if got is None:
                    return {**op, "type": "fail"}
                self.tag = got[0]
                return {**op, "type": "ok"}
            if f == "release":
                if self.tag is None:
                    return {**op, "type": "fail",
                            "error": "not-held"}
                tag, self.tag = self.tag, None
                try:
                    self._conn(test).reject(tag, requeue=True)
                    return {**op, "type": "ok"}
                except (OSError, AmqpError):
                    # losing the connection requeues the unacked
                    # delivery server-side: released either way
                    if self.conn is not None:
                        self.conn.close()
                        self.conn = None
                    return {**op, "type": "ok",
                            "error": "channel-closed"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, AmqpError) as e:
            # a dropped connection releases any held delivery
            if self.conn is not None:
                self.conn.close()
                self.conn = None
            self.tag = None
            t = "fail" if f == "acquire" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


# -- test maps ---------------------------------------------------------------

def queue_gen():
    counter = iter(range(10**9))

    def enqueue(test, ctx):
        return {"f": "enqueue", "value": next(counter)}

    def dequeue(test, ctx):
        return {"f": "dequeue", "value": None}

    return gen.mix([enqueue, dequeue])


def semaphore_gen():
    return gen.mix([gen.repeat({"f": "acquire", "value": None}),
                    gen.repeat({"f": "release", "value": None})])


def rabbitmq_test(options: dict) -> dict:
    """Queue workload (default) or the semaphore mutex, under a
    kill/restart nemesis — the reference's suite shape. The semaphore's
    mutex check races its device lane on `options["device"]` (default
    the card), resolved here, so that a missing card raises before any
    node is set up."""
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    workload = options.get("workload") or "queue"
    volatile = bool(options.get("volatile"))
    device = resolve_device(options.get("device")) \
        if workload == "semaphore" else None

    def port_fn(test, node):
        return ("127.0.0.1", mini_node_port(test, node)) \
            if mode == "mini" else (node, 5672)

    def sem_port_fn(test, node):
        # ONE logical semaphore: every worker drives the broker that
        # holds the single seeded token (nodes[0] in mini mode; a real
        # cluster mirrors the queue, so any node works there)
        return port_fn(test, test["nodes"][0]) if mode == "mini" \
            else (node, 5672)

    if mode == "mini":
        db: jdb.DB = MiniRabbitDB(
            volatile=volatile,
            seed_semaphore=(SEM_QUEUE if workload == "semaphore"
                            else None))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "rabbitmq-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "deb":
        db = RabbitDB(options.get("version") or VERSION)
        extra = {"ssh": options.get("ssh") or {}, "os": Debian()}
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    interval = options.get("nemesis_interval") or 5.0
    time_limit = options.get("time_limit") or 30

    if workload == "queue":
        client: jclient.Client = RabbitQueueClient(port_fn=port_fn)
        checker = jchecker.compose({
            "queue": jchecker.total_queue(),
            "exceptions": jchecker.unhandled_exceptions(),
        })
        main = gen.time_limit(
            time_limit,
            gen.nemesis(
                gen.cycle([gen.sleep(interval),
                           {"type": "info", "f": "start"},
                           gen.sleep(interval),
                           {"type": "info", "f": "stop"}]),
                queue_gen()))
        generator = gen.phases(
            main,
            gen.nemesis(gen.once(
                lambda test, ctx: {"type": "info", "f": "stop"})),
            gen.sleep(1.0),
            gen.clients(gen.each_thread(gen.once(
                lambda test, ctx: {"f": "drain", "value": None}))))
    elif workload == "semaphore":
        client = RabbitSemaphoreClient(port_fn=sem_port_fn)
        checker = jchecker.compose({
            "mutex": jchecker.linearizable(models.mutex(),
                                           time_limit=60, device=device),
            "exceptions": jchecker.unhandled_exceptions(),
        })
        generator = gen.time_limit(
            time_limit, gen.clients(semaphore_gen()))
    else:
        raise ValueError(f"unknown workload {workload!r}")

    return {
        "name": options.get("name") or f"rabbitmq-{workload}-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "nemesis": jnemesis.node_start_stopper(
            lambda ns: [gen.RNG.choice(ns)],
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node)),
        "checker": checker,
        "generator": generator,
        **extra,
    }


RABBITMQ_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Where to write results"),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (default: live in-repo AMQP brokers over "
                 "localexec) or deb (real rabbitmq-server on your "
                 "--ssh cluster)"),
    cli.Opt("workload", metavar="W", default="queue",
            help="queue (total-queue accounting) or semaphore "
                 "(unacked-delivery mutex, checked linearizable)"),
    cli.Opt("sandbox", metavar="DIR", default="rabbitmq-cluster",
            help="Node sandbox dir for the localexec remote"),
    cli.Opt("volatile", default=False,
            help="mini brokers confirm WITHOUT persisting: kill -9 "
                 "then loses acknowledged messages (the checker must "
                 "catch it)"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=5.0,
            parse=float),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the semaphore's mutex check runs its kernels "
                 "(default: the card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": rabbitmq_test,
                           "opt_spec": RABBITMQ_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
