"""Elasticsearch test suite — the search-engine family exemplar
(reference: elasticsearch/src/jepsen/elasticsearch/{core,sets,
dirty_read}.clj — the suite whose set workload famously exposed
inserted-document loss during partitions).

REST client over the document API (the reference drives the same
endpoints through elastisch): `set` adds index one document per
element (PUT /jepsen/number/<v> — the *typed* 1.x path; the pinned
1.5.0 era rejects the typeless ES 7+ /_doc surface), the final read
refreshes the index and scans it (_refresh + _search with a size
bound), and the set/set-full checkers account for every acknowledged
element.  The index is created up-front with an explicit mapping,
as sets.clj does, so dynamic-mapping races can't drop fields.
`dirty-read` semantics ride the same surface: a `read` of a single
document by id observes whether an acknowledged-but-unrefreshed
write is visible.

DB automation (core.clj shape): deb-package install, the service
started with a cluster config listing every node as a unicast host,
readiness = HTTP port + cluster-health wait. ``server=mini``
(default) runs LIVE in-repo REST servers — an fsync'd translog with
torn-tail replay, the refresh visibility gate for real (restart
reloads documents but nothing is searchable until the next
``_refresh``), and a ``--lossy-every`` axis that reproduces the
acknowledged-insert-loss counterexample against live processes.

The port's copy of `jepsen_tpu/dbs/elasticsearch.py`. Its own choices:
the client speaks HTTP through the port's `httpclient` (on
`http.client`; the reference's uses `requests`, which the card's
machine lacks), its `RequestException` classified as the reference
classifies `requests`'; the mini servers listen from `MINI_BASE_PORT`
30850 (the reference's from 28300, so that both packages' servers can
run on one host at once; below Linux's ephemeral range, 32768-60999,
where a client retrying a down server's port could connect to itself
and hold the port); the store root `store/torch`. Its checks (`set`,
`set-full`) reach no kernel, so it has no `--device`.

    python -m jepsen_tpu_torch.dbs.elasticsearch test --nodes e1 \
        --time-limit 8
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

from .. import checker as jchecker
from .. import cli, client as jclient, control, db as jdb
from .. import generator as gen
from .. import net as jnet
from .. import nemesis as jnemesis
from ..control import localexec, nodeutil
from ..ledger import BASE_DIR
from ..os_setup import Debian
from . import httpclient, miniserver

VERSION = "1.5.0"  # the era the reference tested (core.clj)
HTTP_PORT = 9200
DEB_URL = ("https://download.elastic.co/elasticsearch/elasticsearch/"
           "elasticsearch-{v}.deb")
PIDFILE = "/var/run/elasticsearch.pid"
LOGFILE = "/var/log/elasticsearch/elasticsearch.log"
DATA_DIR = "/var/lib/elasticsearch"
INDEX = "jepsen"
DOC_TYPE = "number"  # 1.x mapping type (sets.clj index-name/type)
INDEX_MAPPING = {
    "mappings": {DOC_TYPE: {"properties": {"num": {"type": "integer",
                                                   "store": True}}}}}


def base_url(node: str) -> str:
    return f"http://{node}:{HTTP_PORT}"


class ElasticsearchDB(jdb.DB, jdb.Process, jdb.LogFiles):
    """deb install + service daemon with unicast discovery over the
    test's nodes (core.clj install/configure shape)."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def _start(self, test, node):
        # ES 1.x array sysprops are BARE comma lists (brackets/quotes
        # would be taken literally and fail DNS); the framework's
        # start-stop-daemon writes the pidfile, so no -p here
        hosts = ",".join(test["nodes"])
        nodeutil.start_daemon(
            {"logfile": LOGFILE, "pidfile": PIDFILE, "chdir": "/"},
            "/usr/share/elasticsearch/bin/elasticsearch",
            "-Des.cluster.name=jepsen",
            f"-Des.node.name={node}",
            "-Des.discovery.zen.ping.multicast.enabled=false",
            f"-Des.discovery.zen.ping.unicast.hosts={hosts}",
            f"-Des.path.data={DATA_DIR}")
        nodeutil.await_tcp_port(HTTP_PORT, timeout_s=120)

    def setup(self, test, node):
        with control.su():
            deb = nodeutil.cached_wget(DEB_URL.format(v=self.version))
            control.exec_("dpkg", "-i", "--force-confnew", deb)
            control.exec_("mkdir", "-p", DATA_DIR,
                          "/var/log/elasticsearch")
        self._start(test, node)

    def teardown(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("elasticsearch")
        with control.su():
            control.exec_("rm", "-rf", DATA_DIR, LOGFILE)

    def start(self, test, node):
        self._start(test, node)
        return "started"

    def kill(self, test, node):
        nodeutil.stop_daemon(PIDFILE)
        nodeutil.grepkill("elasticsearch")
        return "killed"

    def log_files(self, test, node):
        return [LOGFILE]


class EsSetClient(jclient.Client):
    """Set workload over the document API (sets.clj CreateSetClient):
    add = create one document per element (definite on 2xx,
    indefinite on everything else); the final read refreshes then
    scans the index."""

    def __init__(self, base_url_fn: Optional[Callable] = None,
                 timeout: float = 5.0):
        self.base_url_fn = base_url_fn or base_url
        self.timeout = timeout
        self.node: Optional[str] = None
        self.http = None
        self._index_ok = False

    def open(self, test, node):
        c = type(self)(self.base_url_fn, self.timeout)
        c.node = node
        c.http = httpclient.Session()
        c._index_ok = False
        c._ensure_index()
        return c

    def _ensure_index(self):
        """Create the index with its explicit mapping (sets.clj
        create-index discipline). Retried from invoke() until it
        lands, so a node unreachable at open() — the window where
        an add would otherwise auto-create the index with dynamic
        mapping — can't silently void the mapping guarantee."""
        if self._index_ok:
            return
        try:
            # idempotent: 200 on create, IndexAlreadyExists on the
            # workers that lose the race — both fine, adds will land.
            # Any OTHER rejection means the explicit mapping was NOT
            # applied and dynamic mapping would silently take over, so
            # it must at least leave a trace.
            r = self.http.put(self._url(f"/{INDEX}"),
                              json=INDEX_MAPPING, timeout=self.timeout)
            if r.ok or "AlreadyExists" in r.text:
                self._index_ok = True
            else:
                import logging
                logging.getLogger(__name__).warning(
                    "index mapping rejected (http %s): %.200s",
                    r.status_code, r.text)
        except httpclient.RequestException:
            pass  # node unreachable now; retried on the next invoke

    def _url(self, path: str) -> str:
        return self.base_url_fn(self.node) + path

    def invoke(self, test, op):
        http = self.http or httpclient
        try:
            if op["f"] == "add":
                self._ensure_index()  # no-op once it has landed
                v = op["value"]
                r = http.put(self._url(f"/{INDEX}/{DOC_TYPE}/{int(v)}"),
                             json={"num": int(v)},
                             timeout=self.timeout)
                if r.status_code in (200, 201):
                    return {**op, "type": "ok"}
                return {**op, "type": "info",
                        "error": f"http {r.status_code}"}
            if op["f"] == "read":
                # refresh first: an unrefreshed search lawfully misses
                # acknowledged docs; AFTER refresh, a miss is loss
                # (sets.clj refreshes before its final read). A FAILED
                # refresh must fail the read — a stale scan reported
                # as ok would count acknowledged adds as lost.
                rr = http.post(self._url(f"/{INDEX}/_refresh"),
                               timeout=self.timeout)
                rr.raise_for_status()
                if rr.json().get("_shards", {}).get("failed", 0):
                    return {**op, "type": "fail",
                            "error": "refresh failed on some shards"}
                r = http.get(self._url(f"/{INDEX}/_search"),
                             params={"size": 100000},
                             timeout=self.timeout)
                r.raise_for_status()
                hits = r.json()["hits"]["hits"]
                return {**op, "type": "ok",
                        "value": sorted(h["_source"]["num"]
                                        for h in hits)}
            raise ValueError(f"unknown op {op['f']!r}")
        except httpclient.RequestException as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def close(self, test):
        if self.http is not None:
            self.http.close()


# -- the LIVE mini server ----------------------------------------------------

MINI_BASE_PORT = 30850

MINIES_SRC = r'''
import argparse, json, os, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
p.add_argument("--lossy-every", type=int, default=0,
               help="drop every Nth acknowledged doc (the famous "
                    "acked-then-lost partition bug, compressed)")
args = p.parse_args()

LOG_PATH = os.path.join(args.dir, "minies.jsonl")
LOCK = threading.Lock()
DOCS, INDICES, SEARCHABLE = {}, set(), set()
ACKED = [0]

def log_append(rec):
    with open(LOG_PATH, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
        os.fsync(fh.fileno())

def replay():
    if not os.path.exists(LOG_PATH):
        return
    with open(LOG_PATH) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail
            if rec[0] == "doc":
                DOCS[rec[1]] = rec[2]
            elif rec[0] == "index":
                INDICES.add(rec[1])
    # a restart reloads the translog but the segment view starts
    # cold: nothing is searchable until the next _refresh

class H(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _reply(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_PUT(self):
        parts = self.path.strip("/").split("/")
        n = int(self.headers.get("Content-Length") or 0)
        doc = json.loads(self.rfile.read(n) or b"{}")
        if len(parts) == 1:  # index creation with mapping
            with LOCK:
                if parts[0] in INDICES:
                    self._reply(400, {"error": "IndexAlreadyExists"})
                else:
                    INDICES.add(parts[0])
                    log_append(["index", parts[0]])
                    self._reply(200, {"acknowledged": True})
            return
        with LOCK:
            ACKED[0] += 1
            drop = (args.lossy_every
                    and ACKED[0] % args.lossy_every == 0)
            if not drop:
                log_append(["doc", parts[-1], doc])
                DOCS[parts[-1]] = doc
            self._reply(201, {"result": "created"})

    def do_POST(self):
        if self.path.endswith("/_refresh"):
            with LOCK:
                SEARCHABLE.clear()
                SEARCHABLE.update(DOCS)
            self._reply(200, {"_shards": {"failed": 0}})
            return
        self._reply(400, {"error": "unsupported"})

    def do_GET(self):
        if "/_search" in self.path:
            with LOCK:
                hits = [{"_id": k, "_source": DOCS[k]}
                        for k in sorted(SEARCHABLE) if k in DOCS]
            self._reply(200, {"hits": {"total": len(hits),
                                       "hits": hits}})
            return
        self._reply(404, {"found": False})

replay()
print("minies serving on", args.port, flush=True)
ThreadingHTTPServer(("127.0.0.1", args.port), H).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "es_ports")


class MiniEsDB(miniserver.MiniServerDB):
    """LIVE in-repo REST servers: fsync'd translog with torn-tail
    replay, the refresh visibility gate FOR REAL (a restart reloads
    documents but nothing is searchable until the next _refresh), and
    the --lossy-every counterexample axis."""

    script = "minies.py"
    src = MINIES_SRC
    pidfile = "minies.pid"
    logfile = "minies.log"
    data_files = ("minies.jsonl",)

    def __init__(self, lossy_every: int = 0):
        self.lossy_every = lossy_every

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        args = ["--dir", "."]
        if self.lossy_every:
            args += ["--lossy-every", str(self.lossy_every)]
        return args


def elasticsearch_test(options: dict) -> dict:
    """Set workload under partition-random-halves (sets.clj shape:
    adds for the time limit, HEAL the cluster, settle, then every
    thread reads the index back — final reads against a
    still-partitioned cluster would report false loss)."""
    from ..workloads import sets

    nodes = options["nodes"]
    mode = options.get("server") or "mini"
    client = EsSetClient()
    if mode == "mini":
        db: jdb.DB = MiniEsDB(int(options.get("lossy_every") or 0))
        # the primary holds the one logical store; honor es_ports
        # overrides the server side (node_port) also honors
        client.base_url_fn = lambda node, _test={"nodes": nodes,
                                                 **options}: (
            "http://127.0.0.1:%d"
            % mini_node_port(_test, nodes[0]))
        extra = {
            "remote": localexec.remote(options.get("sandbox")
                                       or "es-cluster"),
            "ssh": {"dummy?": False},
        }
        nemesis = jnemesis.node_start_stopper(
            lambda ns: [ns[0]],
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node))
    elif mode == "deb":
        db = ElasticsearchDB(options.get("version") or VERSION)
        extra = {"ssh": options.get("ssh") or {}, "os": Debian(),
                 "net": jnet.iptables()}
        nemesis = jnemesis.partition_random_halves()
    else:
        raise ValueError(f"unknown server mode {mode!r}")
    time_limit = options.get("time_limit") or 30
    w = sets.workload()  # checker only; phases built explicitly below
    interval = options.get("nemesis_interval") or (
        3.0 if mode == "mini" else 10.0)
    add_phase = gen.nemesis(
        gen.time_limit(time_limit,
                       gen.cycle([gen.sleep(interval),
                                  {"type": "info", "f": "start"},
                                  gen.sleep(interval),
                                  {"type": "info", "f": "stop"}])),
        gen.time_limit(max(1, time_limit - 2),
                       gen.clients(sets.adds())))
    return {
        "name": options.get("name")
                or f"elasticsearch-{mode}-{VERSION}",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": client,
        "nemesis": nemesis,
        **extra,
        "checker": jchecker.compose({
            "sets": w["checker"],
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": gen.phases(
            add_phase,
            # heal + settle BEFORE the final reads (sets.clj recovers
            # the cluster first)
            gen.nemesis(gen.once(
                lambda test, ctx: {"type": "info", "f": "stop"})),
            gen.sleep(2.0),
            gen.clients(gen.each_thread(gen.once(sets.final_read)))),
    }


ELASTICSEARCH_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Where to write results"),
    cli.Opt("version", metavar="VERSION", default=VERSION,
            help="elasticsearch deb version"),
    cli.Opt("server", metavar="MODE", default="mini",
            help="mini (live in-repo REST servers) or deb (real "
                 "elasticsearch on --ssh nodes)"),
    cli.Opt("sandbox", metavar="DIR", default="es-cluster"),
    cli.Opt("lossy_every", metavar="N", default=0, parse=int,
            help="mini servers drop every Nth acked doc (the "
                 "acked-then-lost counterexample)"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=None,
            parse=float,
            help="Seconds between fault start/stop (default: 3 in "
                 "mini mode, 10 in deb mode)"),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": elasticsearch_test,
                           "opt_spec": ELASTICSEARCH_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
