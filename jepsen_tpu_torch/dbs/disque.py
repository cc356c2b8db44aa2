"""Disque test suite — the reference's queue-safety exemplar
(disque/src/jepsen/disque.clj:1-321): enqueue/dequeue/drain over
antirez's redis-derived job queue, checked by the total-queue
multiset accounting ("what goes in must come out").

Two server modes (the redis-suite pattern):

- ``source`` — clone-and-make real disque on SSH/docker nodes
  (disque.clj:39-53 install!), daemon with pidfile/logfile.
- ``mini`` (the default) — a LIVE in-repo
  mini-disque subprocess per node: a real RESP2 server implementing
  the job-queue core (ADDJOB / GETJOB / ACKJOB with at-least-once
  redelivery after a retry window) over an fsync'd AOF, so kill -9
  redelivers unacked jobs instead of losing them. CI drives
  install -> real-TCP workload -> kill/restart nemesis -> AOF
  replay -> total-queue checker against live processes;
  ``--volatile`` drops the AOF so the checker demonstrably catches
  the resulting lost jobs.

The wire client reuses the redis suite's from-scratch RESP2 codec —
disque speaks the same protocol (that is why the reference's client
is a Jedis derivative).

The port's copy of `jepsen_tpu/dbs/disque.py`. Its own choices: the mini
servers listen from `MINI_BASE_PORT` 30950 (the reference's from 22700,
so that both packages' clusters can run on one host at once; below
Linux's ephemeral range, 32768-60999, where a client retrying a down
server's port could connect to itself and hold the port; `source` mode
keeps stock disque's `PORT` 7711); the store root `store/torch`. Its
check, `total_queue`, runs on the host, as the reference's does.

    python -m jepsen_tpu_torch.dbs.disque test --nodes q1,q2 --time-limit 6
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..ledger import BASE_DIR
from ..os_setup import Debian
from . import miniserver
from .redis import RedisConn, RedisError

GIT_SHA = "f00dd0704128707f7a5effccd5837d796f2c01e3"  # disque.clj:300
DIR = "/opt/disque"
PORT = 7711
PIDFILE = "/var/run/disque.pid"
LOGFILE = "/var/lib/disque/log"

MINI_BASE_PORT = 30950
MINI_PIDFILE = "minidisque.pid"
MINI_LOGFILE = "minidisque.log"
QUEUE = "jepsen"

# A real RESP2 job-queue server. Jobs are at-least-once: GETJOB moves
# a job into an in-flight set with a redelivery deadline; an unacked
# job whose deadline passes is eligible again (disque's RETRY
# semantics, scaled down). The AOF records ADDJOB/ACKJOB; replay
# rebuilds pending = added - acked, so a kill -9 redelivers in-flight
# jobs instead of losing them. --volatile skips the AOF: acknowledged
# enqueues then vanish on kill, which total-queue must catch.
MINIDISQUE_SRC = r'''
import argparse, os, socketserver, threading, time

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
p.add_argument("--retry-ms", type=int, default=2000)
p.add_argument("--volatile", action="store_true")
args = p.parse_args()

AOF = os.path.join(args.dir, "disque.aof")
LOCK = threading.Lock()
PENDING = {}    # id -> body (ready to deliver)
INFLIGHT = {}   # id -> (body, redeliver_deadline)
ORDER = []      # delivery order (ids; may contain stale entries)
SEQ = [0]

__RESP_COMMON__

def persist(*cmd):
    if args.volatile:
        return
    with open(AOF, "ab") as fh:
        fh.write(enc_cmd(list(cmd)))
        fh.flush()
        os.fsync(fh.fileno())

def replay():
    if args.volatile or not os.path.exists(AOF):
        return
    acked = set()
    added = {}
    order = []
    with open(AOF, "rb") as fh:
        while True:
            try:
                cmd = read_resp(fh)
            except ValueError:
                break  # torn tail after a crash
            if cmd is None:
                break
            if cmd[0] == "ADDJOB":
                added[cmd[1]] = cmd[2]
                order.append(cmd[1])
            elif cmd[0] == "ACKJOB":
                acked.update(cmd[1:])
    for jid in order:
        if jid not in acked:
            PENDING[jid] = added[jid]
            ORDER.append(jid)
    if order:
        SEQ[0] = max(int(j.split("-")[1]) for j in added) + 1

def sweep():
    now = time.monotonic()
    for jid in list(INFLIGHT):
        body, deadline = INFLIGHT[jid]
        if now >= deadline:
            del INFLIGHT[jid]
            PENDING[jid] = body
            ORDER.append(jid)

class Handler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            try:
                cmd = read_resp(self.rfile)
            except ValueError:
                self.wfile.write(b"-ERR protocol error\r\n")
                return
            if cmd is None:
                return
            self.wfile.write(self.apply(cmd))
            self.wfile.flush()

    def apply(self, cmd):
        op = cmd[0].upper()
        with LOCK:
            if op == "PING":
                return b"+PONG\r\n"
            if op == "ADDJOB":
                # ADDJOB <queue> <body> <ms-timeout> [opts...]
                jid = "D-%d" % SEQ[0]
                SEQ[0] += 1
                persist("ADDJOB", jid, cmd[2])
                PENDING[jid] = cmd[2]
                ORDER.append(jid)
                return bulk(jid)
            if op == "GETJOB":
                # GETJOB [NOHANG] [TIMEOUT ms] FROM <queue>...
                sweep()
                while ORDER:
                    jid = ORDER.pop(0)
                    if jid not in PENDING:
                        continue  # stale entry (acked or re-queued)
                    body = PENDING.pop(jid)
                    INFLIGHT[jid] = (
                        body,
                        time.monotonic() + args.retry_ms / 1000.0)
                    return (b"*1\r\n*3\r\n" + bulk(QUEUE_NAME)
                            + bulk(jid) + bulk(body))
                return b"*-1\r\n"
            if op == "ACKJOB":
                n = 0
                for jid in cmd[1:]:
                    if jid in INFLIGHT or jid in PENDING:
                        INFLIGHT.pop(jid, None)
                        PENDING.pop(jid, None)
                        n += 1
                persist("ACKJOB", *cmd[1:])
                return b":%d\r\n" % n
            return b"-ERR unknown command '%s'\r\n" % op.encode()

QUEUE_NAME = "__QUEUE__"

class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

replay()
print("minidisque serving on", args.port, flush=True)
Server(("127.0.0.1", args.port), Handler).serve_forever()
'''

MINIDISQUE_SRC = miniserver.build_src(
    MINIDISQUE_SRC.replace("__QUEUE__", QUEUE))


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "disque_ports")


class MiniDisqueDB(miniserver.MiniServerDB):
    """Upload + daemon lifecycle for the in-repo mini-disque (shared
    with every mini server — miniserver.MiniServerDB; runs on any
    node with python3, which is what lets CI drive the suite against
    live processes)."""

    script = "minidisque.py"
    src = MINIDISQUE_SRC
    pidfile = MINI_PIDFILE
    logfile = MINI_LOGFILE
    data_files = ("disque.aof",)

    def __init__(self, volatile: bool = False, retry_ms: int = 2000):
        self.volatile = volatile
        self.retry_ms = retry_ms

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        extra = ["--volatile"] if self.volatile else []
        return ["--dir", ".", "--retry-ms", str(self.retry_ms),
                *extra]


class DisqueDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Real-disque automation (disque.clj:39-53,115-121): git clone +
    make, daemon with pidfile, data-dir wipe on teardown."""

    def __init__(self, version: str = GIT_SHA):
        self.version = version

    def _start(self, test, node):
        nodeutil.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
            f"{DIR}/src/disque-server",
            "--port", str(PORT), "--appendonly", "yes")
        nodeutil.await_tcp_port(PORT, timeout_s=60)

    def setup(self, test, node):
        with control.su():
            control.exec_("bash", "-c",
                          f"test -d {DIR} || git clone "
                          f"https://github.com/antirez/disque.git {DIR}")
            control.exec_("git", "-C", DIR, "reset", "--hard",
                          self.version)
            control.exec_("make", "-C", DIR, "-j2")
        self._start(test, node)

    def teardown(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("disque-server")
        with control.su():
            control.exec_("rm", "-rf", "/var/lib/disque", LOGFILE)

    def start(self, test, node):
        self._start(test, node)
        return "started"

    def kill(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("disque-server")
        return "killed"

    def log_files(self, test, node):
        return [LOGFILE]


class DisqueClient(jclient.Client):
    """enqueue / dequeue / drain over RESP (disque.clj:193-250).
    Dequeue GETJOBs then ACKJOBs — a connection error between the two
    leaves the job in-flight for redelivery, which is exactly the
    at-least-once behavior total-queue tolerates (duplicates counted,
    not invalid). Drain loops dequeues until the queue reports empty;
    its value is the list of drained elements
    (checker.expand_queue_drain_ops contract)."""

    def __init__(self, port_fn=None, timeout: float = 5.0):
        self.port_fn = port_fn or (lambda test, node: (node, PORT))
        self.timeout = timeout
        self.node: Optional[str] = None
        self.conn: Optional[RedisConn] = None

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout)
        c.node = node
        return c

    def _conn(self, test) -> RedisConn:
        if self.conn is None:
            host, port = self.port_fn(test, self.node)
            self.conn = RedisConn(host, port, self.timeout)
        return self.conn

    def _dequeue_once(self, test):
        """One GETJOB+ACKJOB round: the dequeued int, or None when
        the queue is (momentarily) empty.

        Error discipline matters for the accounting: a GETJOB failure
        propagates (safe either way — an undelivered job is untouched,
        a delivered-but-unread one redelivers after the retry window),
        but once GETJOB has returned a body the job counts as
        dequeued NO MATTER what the ACKJOB round does. An ack that was
        applied but whose reply was lost would otherwise surface as a
        false "lost" job (measured: ~1 per 9k ops under a 2 s kill
        cadence); an ack that never landed merely redelivers, and
        duplicates are tolerated by total-queue."""
        conn = self._conn(test)
        res = conn.cmd("GETJOB", "NOHANG", "FROM", QUEUE)
        if not res:
            return None
        _q, jid, body = res[0]
        try:
            conn.cmd("ACKJOB", jid)
        except (OSError, ConnectionError, RedisError):
            if self.conn is not None:
                self.conn.close()
                self.conn = None
        return int(body)

    def invoke(self, test, op):
        f = op["f"]
        try:
            if f == "enqueue":
                conn = self._conn(test)
                conn.cmd("ADDJOB", QUEUE, str(op["value"]), "100")
                return {**op, "type": "ok"}
            if f == "dequeue":
                v = self._dequeue_once(test)
                if v is None:
                    return {**op, "type": "fail"}
                return {**op, "type": "ok", "value": v}
            if f == "drain":
                # an empty GETJOB is NOT proof of an empty queue: a
                # job fetched-but-unacked by a worker that died sits
                # invisible in the redelivery window (at-least-once).
                # Empty only counts once it has PERSISTED past that
                # window. Failures mid-drain return :info WITH the
                # elements drained so far — they were acked off the
                # server and total-queue must account them (its
                # incomplete-drain handling downgrades any "lost"
                # verdict to unknown).
                drained: list = []
                deadline = time.monotonic() + 15.0
                empty_since = None
                while time.monotonic() < deadline:
                    try:
                        v = self._dequeue_once(test)
                    except (OSError, ConnectionError, RedisError) as e:
                        if self.conn is not None:
                            self.conn.close()
                            self.conn = None
                        return {**op, "type": "info", "value": drained,
                                "error": str(e)[:200]}
                    now = time.monotonic()
                    if v is not None:
                        drained.append(v)
                        empty_since = None
                        continue
                    if empty_since is None:
                        empty_since = now
                    elif now - empty_since > 2.5:
                        return {**op, "type": "ok", "value": drained}
                    time.sleep(0.2)
                return {**op, "type": "info", "value": drained,
                        "error": "drain timeout"}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, ConnectionError, RedisError) as e:
            if self.conn is not None:
                self.conn.close()
                self.conn = None
            t = "fail" if f == "dequeue" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


def queue_gen():
    """Mixed enqueue/dequeue stream: enqueues carry unique ints
    (gen/queue parity, disque.clj:303-305)."""
    counter = iter(range(10**9))

    def enqueue(test, ctx):
        return {"f": "enqueue", "value": next(counter)}

    def dequeue(test, ctx):
        return {"f": "dequeue", "value": None}

    return gen.mix([enqueue, dequeue])


def disque_test(options: dict) -> dict:
    """std-gen shape (disque.clj:274-292): main phase under the
    nemesis, nemesis stop, a settle window, then every thread drains
    once; total-queue accounting over the whole history."""
    nodes = options["nodes"]
    # static, documented default (the CLI always materializes an ssh
    # dict, so sniffing it would mis-route): --server source drives a
    # real cluster
    mode = options.get("server") or "mini"
    if mode == "mini":
        import logging
        logging.getLogger(__name__).info(
            "server=mini: running in-repo mini-disque servers over "
            "localexec (ssh/nodes are local names); pass "
            "--server source to drive a real cluster")
    volatile = bool(options.get("volatile"))
    if mode == "mini":
        db: jdb.DB = MiniDisqueDB(volatile=volatile)
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "disque-cluster"),
            "ssh": {"dummy?": False},
            "client": DisqueClient(
                port_fn=lambda test, node:
                    ("127.0.0.1", mini_node_port(test, node))),
        }
    elif mode == "source":
        db = DisqueDB(options.get("version") or GIT_SHA)
        extra = {
            "ssh": options.get("ssh") or {},
            "os": Debian(),
            "client": DisqueClient(),
        }
    else:
        raise ValueError(f"unknown server mode {mode!r}")
    interval = options.get("nemesis_interval") or 5.0
    time_limit = options.get("time_limit") or 30
    main = gen.time_limit(
        time_limit,
        gen.nemesis(
            gen.cycle([gen.sleep(interval),
                       {"type": "info", "f": "start"},
                       gen.sleep(interval),
                       {"type": "info", "f": "stop"}]),
            queue_gen()))
    return {
        "name": options.get("name") or f"disque-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "nemesis": jnemesis.node_start_stopper(
            lambda nodes: [gen.RNG.choice(nodes)],
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node)),
        "checker": jchecker.compose({
            "queue": jchecker.total_queue(),
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": gen.phases(
            main,
            # recover: make sure every node is back up before draining
            gen.nemesis(gen.once(
                lambda test, ctx: {"type": "info", "f": "stop"})),
            gen.sleep(1.0),
            gen.clients(gen.each_thread(gen.once(
                lambda test, ctx: {"f": "drain", "value": None})))),
        **extra,
    }


DISQUE_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Where to write results"),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (default: live in-repo job-queue servers over "
                 "localexec) or source (git clone + make real disque "
                 "on your --ssh cluster)"),
    cli.Opt("sandbox", metavar="DIR", default="disque-cluster",
            help="Node sandbox dir for the localexec remote"),
    cli.Opt("volatile", default=False,
            help="mini servers skip the AOF: kill -9 then loses "
                 "acknowledged jobs, which total-queue must catch"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=5.0,
            parse=float, help="Seconds between kill/restart cycles"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": disque_test,
                           "opt_spec": DISQUE_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
