"""RobustIRC test suite — the exactly-once-messaging family exemplar
(robustirc/src/jepsen/robustirc.clj, 217 LoC).

RobustIRC is IRC on raft: clients speak the *RobustSession* HTTP
protocol (create a session, POST raw IRC lines with a
ClientMessageId, GET the message stream), and the network
deduplicates by ClientMessageId so a client can RETRANSMIT a lost
POST without double-applying it — exactly-once IRC over lossy HTTP
(robustirc.clj post-message:108-121: the id is attached client-side
precisely so retries are safe).

The workload is the reference's topic-set (robustirc.clj:150-177):
adds set the channel topic (``TOPIC #jepsen :<n>``), the final read
streams every message, keeps the TOPIC lines, and extracts the
values — a set test whose transport is an IRC session. Where the
reference split strings by hand (its own ``XXX: use a proper IRC
parser`` comment at :137), this suite carries a real RFC-1459 line
parser (prefix / command / params / trailing) — from scratch, like
every other wire codec here.

``mini`` mode (default) runs LIVE in-repo robustsession servers:
HTTP endpoints, session auth, ClientMessageId dedup, and an fsync'd
message log that survives kill -9 — CI proves the exactly-once
property deterministically (same id posted twice lands once, and a
retransmit across a server restart lands once). ``go`` mode emits
the real automation (go get, singlenode bootstrap then -join
daemons, robustirc.clj:24-85), command-assertion tested.

The port's copy of `jepsen_tpu/dbs/robustirc.py`. Its own choices: the
RobustSession speaks HTTP through the port's `httpclient` (on
`http.client`; the reference's uses `requests`, which the card's machine
lacks), its session auth sent as each call's `X-Session-Auth` header;
the mini servers listen from `MINI_BASE_PORT` 32050 (the reference's
from 29500, so that both packages' servers can run on one host at once;
below Linux's ephemeral range, 32768-60999; `go` mode keeps RobustIRC's
`PORT` 13001); the store root `store/torch`. The set check runs on the
host, so the suite takes no `--device`. `MINIIRC_SRC` is the
reference's, byte for byte.

    python -m jepsen_tpu_torch.dbs.robustirc test --nodes i1 \
        --time-limit 8
"""

from __future__ import annotations

import json
import sys

from .. import checker as jchecker
from .. import cli, control, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..ledger import BASE_DIR
from ..os_setup import Debian
from . import httpclient, miniserver, retryclient

PORT = 13001
MINI_BASE_PORT = 32050
CHANNEL = "#jepsen"
NETWORK_PASSWORD = "secret"  # robustirc.clj:50


# -- RFC-1459 line grammar ----------------------------------------------------

def parse_irc(line: str) -> tuple:
    """(prefix, command, params, trailing) — the RFC-1459 message
    grammar the reference wished it had (robustirc.clj:137)."""
    prefix = None
    rest = line.rstrip("\r\n")
    if rest.startswith(":"):
        prefix, _, rest = rest[1:].partition(" ")
    rest, _, trailing = rest.partition(" :")
    parts = rest.split()
    if not parts:
        raise ValueError(f"empty IRC message {line!r}")
    return (prefix, parts[0].upper(), parts[1:],
            trailing if trailing else None)


def topic_value(line: str):
    """The integer from a ``TOPIC #jepsen :<n>`` line, or None."""
    try:
        _, command, params, trailing = parse_irc(line)
    except ValueError:
        return None
    if command != "TOPIC" or not params or params[0] != CHANNEL:
        return None
    try:
        return int(trailing)
    except (TypeError, ValueError):
        return None


# -- the RobustSession client -------------------------------------------------

class RobustSession:
    """create-session / post-message / read-all
    (robustirc.clj:103-135). Posts carry a ClientMessageId;
    `post` RETRANSMITS with the same id on connection errors —
    the dedup contract makes that safe."""

    def __init__(self, base_url: str, timeout: float = 5.0):
        self.base = base_url
        self.timeout = timeout
        self.http = httpclient.Session()
        r = self.http.post(f"{self.base}/robustirc/v1/session",
                           timeout=self.timeout)
        r.raise_for_status()
        body = r.json()
        self.sid = body["Sessionid"]
        self.auth = body["Sessionauth"]
        self._next_id = 0

    def new_message_id(self) -> int:
        self._next_id += 1
        return (hash((self.sid, self._next_id))
                & 0x7FFFFFFFFFFFFFFF)

    def post(self, irc_line: str, msg_id: int = None,
             retries: int = 3) -> None:
        if msg_id is None:
            msg_id = self.new_message_id()
        last = None
        for _ in range(retries + 1):
            try:
                r = self.http.post(
                    f"{self.base}/robustirc/v1/{self.sid}/message",
                    headers={"X-Session-Auth": self.auth},
                    json={"Data": irc_line,
                          "ClientMessageId": msg_id},
                    timeout=self.timeout)
                r.raise_for_status()
                return
            except httpclient.RequestException as e:
                last = e  # retransmit with the SAME id: dedup'd
        raise last

    def read_all(self) -> list:
        """Every message in the stream (lastseen=0.0,
        robustirc.clj:123-135)."""
        r = self.http.get(
            f"{self.base}/robustirc/v1/{self.sid}/messages",
            headers={"X-Session-Auth": self.auth},
            params={"lastseen": "0.0"},
            timeout=self.timeout)
        r.raise_for_status()
        return [json.loads(line) for line in r.text.splitlines()
                if line.strip()]

    def close(self):
        self.http.close()


# -- the LIVE mini server -----------------------------------------------------

MINIIRC_SRC = r'''
import argparse, json, os, threading, uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

LOG_PATH = os.path.join(args.dir, "miniirc.jsonl")
LOCK = threading.Lock()
SESSIONS = {}          # sid -> auth
MESSAGES = []          # ordered raw IRC lines
SEEN_IDS = set()       # ClientMessageId dedup: the whole point

def replay():
    if not os.path.exists(LOG_PATH):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail
            if rec["k"] == "session":
                SESSIONS[rec["sid"]] = rec["auth"]
            else:
                SEEN_IDS.add(rec["id"])
                MESSAGES.append(rec["data"])

def persist(rec):
    with open(LOG_PATH, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
        os.fsync(fh.fileno())

class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def reply(self, code, body=b"", ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def auth_sid(self, parts):
        sid = parts[2]  # robustirc/v1/<sid>/...
        with LOCK:
            auth = SESSIONS.get(sid)
        if auth is None:
            self.reply(404, b'{"error": "no such session"}')
            return None
        if self.headers.get("X-Session-Auth") != auth:
            self.reply(401, b'{"error": "bad auth"}')
            return None
        return sid

    def do_POST(self):
        parts = self.path.split("?")[0].strip("/").split("/")
        # robustirc/v1/session
        if parts[:3] == ["robustirc", "v1", "session"]:
            sid = uuid.uuid4().hex
            auth = uuid.uuid4().hex
            with LOCK:
                SESSIONS[sid] = auth
                persist({"k": "session", "sid": sid, "auth": auth})
            return self.reply(200, json.dumps(
                {"Sessionid": sid, "Sessionauth": auth}).encode())
        # robustirc/v1/<sid>/message
        if (len(parts) == 4 and parts[:2] == ["robustirc", "v1"]
                and parts[3] == "message"):
            if self.auth_sid(parts) is None:
                return
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n))
            mid = body["ClientMessageId"]
            with LOCK:
                if mid in SEEN_IDS:      # retransmit: exactly-once
                    return self.reply(200, b"{}")
                SEEN_IDS.add(mid)
                MESSAGES.append(body["Data"])
                persist({"k": "msg", "id": mid,
                         "data": body["Data"]})
            return self.reply(200, b"{}")
        self.reply(404, b'{"error": "bad path"}')

    def do_GET(self):
        parts = self.path.split("?")[0].strip("/").split("/")
        # robustirc/v1/<sid>/messages
        if (len(parts) == 4 and parts[:2] == ["robustirc", "v1"]
                and parts[3] == "messages"):
            if self.auth_sid(parts) is None:
                return
            with LOCK:
                lines = list(MESSAGES)
            body = "\n".join(json.dumps({"Data": d})
                             for d in lines).encode()
            return self.reply(200, body, "application/x-ndjson")
        self.reply(404, b'{"error": "bad path"}')

replay()
print("miniirc serving on", args.port, flush=True)
ThreadingHTTPServer(("127.0.0.1", args.port),
                    Handler).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "robustirc_ports")


class MiniIrcDB(miniserver.MiniServerDB):
    script = "miniirc.py"
    src = MINIIRC_SRC
    pidfile = "miniirc.pid"
    logfile = "miniirc.out"
    data_files = ("miniirc.jsonl",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


class RobustIrcDB(jdb.DB, jdb.LogFiles):
    """Real automation (robustirc.clj:24-85): go toolchain, go get,
    singlenode bootstrap on the primary, -join daemons on the
    rest."""

    GOPATH = "/root/gocode"

    def _daemon_cmd(self, test, node, bootstrap: bool) -> list:
        args = [f"{self.GOPATH}/bin/robustirc",
                f"-listen={node}:{PORT}",
                f"-network_password={NETWORK_PASSWORD}",
                "-network_name=jepsen"]
        if bootstrap:
            args.append("-singlenode")
        else:
            args.append(f"-join={test['nodes'][0]}:{PORT}")
        return args

    def setup(self, test, node):
        primary = test["nodes"][0]
        with control.su():
            control.exec_("apt-get", "install", "-y", "golang-go")
            control.exec_("env", f"GOPATH={self.GOPATH}", "go",
                          "get", "-u",
                          "github.com/robustirc/robustirc")
            control.exec_("mkdir", "-p", "/var/lib/robustirc")
            nodeutil.start_daemon(
                {"logfile": "/var/lib/robustirc/robustirc.log",
                 "pidfile": "/var/lib/robustirc/robustirc.pid",
                 "chdir": "/var/lib/robustirc"},
                *self._daemon_cmd(test, node, node == primary))
        nodeutil.await_tcp_port(PORT, timeout_s=60)

    def teardown(self, test, node):
        with control.su():
            nodeutil.stop_daemon("/var/lib/robustirc/robustirc.pid")
            nodeutil.grepkill("robustirc")
            control.exec_("rm", "-rf", "/var/lib/robustirc")

    def log_files(self, test, node):
        return ["/var/lib/robustirc/robustirc.log"]


# -- client -------------------------------------------------------------------

class IrcSetClient(retryclient.RetryClient):
    """Topic-set client (robustirc.clj SetClient:150-177): session
    setup runs the NICK/USER/JOIN handshake; add sets the topic,
    read streams everything and extracts topic values."""

    default_port = PORT

    def _connect(self, host, port) -> RobustSession:
        s = RobustSession(f"http://{host}:{port}",
                          timeout=self.timeout)
        nick = f"worker{abs(hash(self.node or 'n')) % 1000}"
        s.post(f"NICK {nick}")
        s.post("USER j j j j")
        s.post(f"JOIN {CHANNEL}")
        return s

    retry_excs = (OSError, httpclient.RequestException)

    def invoke(self, test, op):
        f = op["f"]
        try:
            session = self._conn(test)
            if f == "add":
                session.post(f"TOPIC {CHANNEL} :{int(op['value'])}")
                return {**op, "type": "ok"}
            if f == "read":
                msgs = session.read_all()
                vals = sorted({v for m in msgs
                               for v in [topic_value(m["Data"])]
                               if v is not None})
                return {**op, "type": "ok", "value": vals}
            raise ValueError(f"unknown op {f!r}")
        except (OSError, httpclient.RequestException) as e:
            self._drop()
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}


def robustirc_test(options: dict) -> dict:
    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    from ..workloads import sets
    w = sets.workload({"time_limit":
                       max(1, (options.get("time_limit") or 10) - 3)})
    w = {**w, "client": IrcSetClient(), "wrap_time": False}
    client = w["client"]

    if mode == "mini":
        db: jdb.DB = MiniIrcDB()
        client.port_fn = lambda test, node: (
            "127.0.0.1", mini_node_port(test, test["nodes"][0]))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "robustirc-cluster"),
            "ssh": {"dummy?": False},
        }
    elif mode == "go":
        db = RobustIrcDB()
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
    return {
        "name": options.get("name") or f"robustirc-set-{mode}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "nemesis": nemesis,
        "checker": jchecker.compose({
            "set": w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": workload_gen,
        **extra,
    }


ROBUSTIRC_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo robustsession servers) or go "
                 "(real robustirc via go get on --ssh nodes)"),
    cli.Opt("sandbox", metavar="DIR", default="robustirc-cluster"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": robustirc_test,
                           "opt_spec": ROBUSTIRC_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
