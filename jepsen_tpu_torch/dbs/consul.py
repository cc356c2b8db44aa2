"""Consul test suite — the HTTP-KV exemplar with INDEX-based CAS
(reference: consul/src/jepsen/consul.clj, consul/client.clj,
consul/db.clj).

Consul's KV API compares-and-sets on the key's ModifyIndex, not its
value — so the client's cas is the reference's two-step recipe
(client.clj:66-80): read the current value AND index, verify the
value matches, then PUT guarded by ``?cas=<index>``. A concurrent
write between the read and the guarded PUT bumps the index and the
CAS honestly fails — the pattern that makes this suite a distinct
wire contract from etcd's value-compare transactions.

DB automation follows consul/db.clj: release-zip install, one agent
per node (`-server`, primary bootstraps, the rest `-retry-join` the
primary), pidfile/logfile daemon, data-dir wipe. Two server modes:
``release`` drives that real-agent recipe on an SSH cluster;
``mini`` (the disque pattern) runs a LIVE in-repo HTTP KV server per
node — the same v1/kv wire contract (JSON array + ModifyIndex,
?cas=<index> guarded PUTs) over an fsync'd AOF — through the full
localexec DB automation, so CI executes install -> start -> kill -9 /
SIGSTOP -> recovery against real processes (VERDICT r3 #6); the
register workload rides the same independent-tuple machinery as
every KV suite.

The port's copy of `jepsen_tpu/dbs/consul.py`. Its own choices: the
client speaks HTTP through the port's `httpclient` (on `http.client`;
the reference's uses `requests`, which the card's machine lacks), its
`RequestException` classified as the reference classifies `requests`';
the mini servers listen from `MINI_BASE_PORT` 30750 (the reference's
from 24700, so that both packages' servers can run on one host at once;
below Linux's ephemeral range, 32768-60999, where a client retrying a
down server's port could connect to itself and hold the port);
`--device`, passed to the register checker's competition race, whose
device lane runs the WGL chunk kernels there (default the card: a
missing card raises before any node is set up, `--device cpu` runs
their plain PyTorch versions); the store root `store/torch`.

    python -m jepsen_tpu_torch.dbs.consul test --nodes c1,c2 \
        --server mini --device cpu --time-limit 6
"""

from __future__ import annotations

import base64
import sys
from typing import Callable, Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import net as jnet
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..independent import KV, tuple_
from . import node_for_key
from ..ledger import BASE_DIR
from ..os_setup import Debian
from ..util import resolve_device
from ..workloads import linearizable_register
from . import httpclient, miniserver

VERSION = "1.6.1"  # consul.clj:70
HTTP_PORT = 8500
DIR = "/opt"
BINARY = f"{DIR}/consul"
PIDFILE = "/var/run/consul.pid"
LOGFILE = "/var/log/consul.log"
DATA_DIR = "/var/lib/consul"


def zip_url(version: str) -> str:
    return (f"https://releases.hashicorp.com/consul/{version}/"
            f"consul_{version}_linux_amd64.zip")


MINI_BASE_PORT = 30750
MINI_PIDFILE = "miniconsul.pid"
MINI_LOGFILE = "miniconsul.log"

# A LIVE v1/kv server speaking the suite's exact wire subset: GET
# returns the JSON array with ModifyIndex (404 on missing), PUT honors
# ?cas=<index> against a global index, and every accepted write is
# fsync'd to an AOF before "true" goes out — so kill -9 keeps
# acknowledged writes and the index stream (a reused ModifyIndex after
# a crash would let stale CAS wins through).
MINICONSUL_SRC = r'''
import argparse, base64, json, os, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

AOF = os.path.join(args.dir, "consul.aof")
LOCK = threading.Lock()
DATA = {}       # key -> (value, modify_index)
INDEX = [0]

def persist(line):
    with open(AOF, "ab") as fh:
        fh.write(line.encode() + b"\n")
        fh.flush()
        os.fsync(fh.fileno())

def replay():
    if not os.path.exists(AOF):
        return
    with open(AOF) as fh:
        for raw in fh:
            parts = raw.split()
            if len(parts) != 4 or parts[0] != "S":
                continue
            try:
                idx = int(parts[1])
                val = base64.b64decode(parts[3]).decode()
            except ValueError:
                continue  # torn tail
            DATA[parts[2]] = (val, idx)
            INDEX[0] = max(INDEX[0], idx)

class H(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _reply(self, code, body):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Consul-Index", str(INDEX[0]))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        key = urlparse(self.path).path[len("/v1/kv/"):]
        with LOCK:
            ent = DATA.get(key)
            if ent is None:
                return self._reply(404, b"")
            val, idx = ent
            body = json.dumps([{"CreateIndex": idx,
                                "ModifyIndex": idx, "Key": key,
                                "Flags": 0,
                                "Value": base64.b64encode(
                                    str(val).encode()).decode()}])
        self._reply(200, body.encode())

    def do_PUT(self):
        parsed = urlparse(self.path)
        key = parsed.path[len("/v1/kv/"):]
        params = parse_qs(parsed.query, keep_blank_values=True)
        n = int(self.headers.get("Content-Length") or 0)
        val = self.rfile.read(n).decode()
        with LOCK:
            cur = DATA.get(key)
            if "cas" in params:
                want = int(params["cas"][0])
                have = cur[1] if cur else 0
                if want != have:
                    return self._reply(200, b"false")
            INDEX[0] += 1
            persist("S %d %s %s" % (
                INDEX[0], key,
                base64.b64encode(val.encode()).decode()))
            DATA[key] = (val, INDEX[0])
        self._reply(200, b"true")

replay()
print("miniconsul serving on", args.port, flush=True)
ThreadingHTTPServer(("127.0.0.1", args.port), H).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "consul_ports")


class MiniConsulDB(miniserver.MiniServerDB):
    script = "miniconsul.py"
    src = MINICONSUL_SRC
    pidfile = MINI_PIDFILE
    logfile = MINI_LOGFILE
    data_files = ("consul.aof",)

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


def kv_url(node: str) -> str:
    return f"http://{node}:{HTTP_PORT}/v1/kv/"


class ConsulDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """Agent lifecycle (consul/db.clj:23-60): the primary bootstraps,
    the rest retry-join it."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, test, node):
        from ..control import netinfo

        primary = test["nodes"][0]
        # consul requires real IPs for -bind / -retry-join (db.clj
        # resolves via net/ip); hostnames make the agent exit at boot
        args = ["agent", "-server", "-log-level", "debug",
                "-client", "0.0.0.0", "-bind", netinfo.ip(node),
                "-data-dir", DATA_DIR, "-node", node,
                "-retry-interval", "5s"]
        if node == primary:
            args.append("-bootstrap")
        else:
            args += ["-retry-join", netinfo.ip(primary)]
        nodeutil.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": DIR},
            BINARY, *args)
        nodeutil.await_tcp_port(HTTP_PORT, timeout_s=60)

    def setup(self, test, node):
        with control.su():
            nodeutil.install_archive(zip_url(self.version), DIR)
        self._start(test, node)

    def teardown(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("consul agent")
        with control.su():
            control.exec_("rm", "-rf", DATA_DIR, LOGFILE)

    def start(self, test, node):
        self._start(test, node)
        return "started"

    def kill(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("consul agent")
        return "killed"

    def log_files(self, test, node):
        return [LOGFILE]


class ConsulClient(jclient.Client):
    """Register client over the v1 KV HTTP API with index-CAS
    (client.clj:47-80 semantics). `base_url_fn` maps a node to its KV
    base URL — tests point it at stub servers; `consistency` adds the
    reference's query-param consistency mode ("consistent"/"stale")."""

    def __init__(self, base_url_fn: Optional[Callable] = None,
                 consistency: Optional[str] = None,
                 timeout: float = 5.0,
                 route_fn: Optional[Callable] = None):
        self.base_url_fn = base_url_fn or kv_url
        self.consistency = consistency
        self.timeout = timeout
        # route_fn(test, k) -> node owning key k: standalone-server
        # clusters (the mini mode) hash-shard keys so every client of
        # a key talks to ONE node — the arrangement under which
        # per-key linearizability is the right claim (dbs.node_for_key)
        self.route_fn = route_fn
        self.node: Optional[str] = None
        self.http = None
        self._test: Optional[dict] = None

    def open(self, test, node):
        c = type(self)(self.base_url_fn, self.consistency,
                       self.timeout, self.route_fn)
        c.node = node
        c._test = test
        c.http = httpclient.Session()
        return c

    def _params(self, extra: Optional[dict] = None) -> dict:
        p = dict(extra or {})
        if self.consistency:
            p[self.consistency] = ""
        return p

    def _base(self, k=None) -> str:
        node = self.node
        if self.route_fn is not None and k is not None \
                and self._test is not None:
            node = self.route_fn(self._test, k)
        return self.base_url_fn(node)

    def kv_get(self, key: str, k=None):
        """(value, modify_index): (None, 0) for a missing key."""
        http = self.http or httpclient
        r = http.get(self._base(k) + key,
                     params=self._params(), timeout=self.timeout)
        if r.status_code == 404:
            return None, 0
        r.raise_for_status()
        body = r.json()[0]
        raw = body.get("Value")
        val = (None if raw is None
               else base64.b64decode(raw).decode())
        return val, int(body["ModifyIndex"])

    def kv_put(self, key: str, value, cas: Optional[int] = None,
               k=None) -> bool:
        http = self.http or httpclient
        params = self._params({"cas": cas} if cas is not None else {})
        r = http.put(self._base(k) + key,
                     data=str(value), params=params,
                     timeout=self.timeout)
        r.raise_for_status()
        return r.text.strip() == "true"

    def kv_cas(self, key: str, old, new, k=None) -> bool:
        """The index-CAS recipe (client.clj:66-80): read value+index,
        value must match, then PUT ?cas=index."""
        val, index = self.kv_get(key, k=k)
        if val != str(old):
            return False
        return self.kv_put(key, new, cas=index, k=k)

    def invoke(self, test, op):
        kv = op["value"]
        if not isinstance(kv, KV):
            raise ValueError(f"consul wants [k v] tuples, got {kv!r}")
        k, v = kv
        key = f"jepsen/{k}"
        f = op["f"]
        try:
            if f == "read":
                val, _idx = self.kv_get(key, k=k)
                return {**op, "type": "ok",
                        "value": tuple_(k, None if val is None
                                        else int(val))}
            if f == "write":
                self.kv_put(key, v, k=k)
                return {**op, "type": "ok"}
            if f == "cas":
                old, new = v
                won = self.kv_cas(key, old, new, k=k)
                return {**op, "type": "ok" if won else "fail"}
            raise ValueError(f"unknown op {f!r}")
        except httpclient.RequestException as e:
            t = "fail" if f == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def close(self, test):
        if self.http is not None:
            self.http.close()


def consul_test(options: dict) -> dict:
    """Test map (consul.clj:23-60 shape). server=release: the real
    agent cluster under partition-random-halves; server=mini: LIVE
    per-node KV servers over localexec under a kill or pause nemesis
    (partitions need iptables, which the sandbox remote can't drive).
    The register checker's device lane runs on `options["device"]`
    (default the card), resolved here, so that a missing card raises
    before any node is set up."""
    options = {**options, "device": resolve_device(options.get("device"))}
    nodes = options["nodes"]
    mode = options.get("server") or "release"
    w = linearizable_register.workload(
        {"nodes": nodes,
         "concurrency": options["concurrency"],
         "per_key_limit": options.get("ops_per_key") or 200,
         "algorithm": "competition",
         "device": options["device"]})
    interval = options.get("nemesis_interval") or 10.0
    rate = options.get("rate") or 10.0

    if mode == "mini":
        db: jdb.DB = MiniConsulDB()
        fault = options.get("fault") or "kill"
        if fault == "kill":
            nemesis = jnemesis.node_start_stopper(
                lambda ns: [gen.RNG.choice(ns)],
                lambda test, node: db.kill(test, node),
                lambda test, node: db.start(test, node))
        elif fault == "pause":
            nemesis = jnemesis.node_start_stopper(
                lambda ns: [gen.RNG.choice(ns)],
                lambda test, node: db.pause(test, node),
                lambda test, node: db.resume(test, node))
        else:
            raise ValueError(f"unknown fault {fault!r}")
        ports = {n: MINI_BASE_PORT + i for i, n in enumerate(nodes)}
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "consul-cluster"),
            "ssh": {"dummy?": False},
            "client": ConsulClient(
                base_url_fn=lambda node: (
                    f"http://127.0.0.1:{ports[node]}/v1/kv/"),
                consistency=options.get("consistency"),
                route_fn=node_for_key),
            "nemesis": nemesis,
        }
    elif mode == "release":
        db = ConsulDB(options.get("version") or VERSION)
        extra = {
            "ssh": options.get("ssh") or {},
            "os": Debian(),
            "net": jnet.iptables(),
            "client": ConsulClient(
                consistency=options.get("consistency")),
            "nemesis": jnemesis.partition_random_halves(),
        }
    else:
        raise ValueError(f"unknown server mode {mode!r}")

    return {
        "name": options.get("name")
            or (f"consul-{mode}" if mode == "mini"
                else f"consul-{options.get('version') or VERSION}"),
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "checker": jchecker.compose({
            "register": w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": gen.time_limit(
            options.get("time_limit") or 30,
            gen.nemesis(
                gen.cycle([gen.sleep(interval),
                           {"type": "info", "f": "start"},
                           gen.sleep(interval),
                           {"type": "info", "f": "stop"}]),
                gen.stagger(1.0 / rate, w["generator"]))),
        **extra,
    }


CONSUL_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("server", metavar="MODE", default="release",
            help="release (real agents on your --ssh cluster) or "
                 "mini (live in-repo v1/kv servers over localexec)"),
    cli.Opt("fault", metavar="F", default="kill",
            help="mini-mode nemesis: kill (SIGKILL + restart) or "
                 "pause (SIGSTOP/SIGCONT)"),
    cli.Opt("sandbox", metavar="DIR", default="consul-cluster"),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Where to write results"),
    cli.Opt("version", metavar="VERSION", default=VERSION,
            help="consul release to install"),
    cli.Opt("consistency", metavar="LEVEL", default=None,
            help="KV consistency query param: consistent or stale "
                 "(empty = consul default)"),
    cli.Opt("rate", metavar="HZ", default=10.0, parse=float,
            help="Approximate requests/sec per thread"),
    cli.Opt("ops_per_key", metavar="N", default=200, parse=int,
            help="Max operations per key"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=10.0,
            parse=float,
            help="Seconds between partition start/stop"),
    cli.Opt("device", metavar="DEV", default=None,
            help="Where the register check's kernels run (default: the "
                 "card)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": consul_test,
                           "opt_spec": CONSUL_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
