"""Chronos test suite — the reference's scheduler-family exemplar
(chronos/src/jepsen/chronos.clj + chronos/checker.clj): clients submit
periodic jobs, the scheduler fires runs, and the checker proves every
*target* execution window was satisfied by a distinct completed run.

The checker is this suite's soul (chronos/checker.clj): for a job
{name, start, count, interval, epsilon, duration} read at time R, the
targets that MUST have begun are `start + k*interval` for k < count
while target < R - epsilon - duration; each target's window is
[t, t + epsilon + EPSILON_FORGIVENESS]. A history is valid iff there
is an injective assignment of targets to distinct completed runs whose
start falls in the window. The reference throws a constraint solver
(loco) at this; with targets sorted by deadline, greedy
earliest-deadline-first matching over sorted run times is EXACT for
interval constraints (classic scheduling argument, and the reference's
own disjoint-job-solution relies on the same structure), so this
checker needs no solver. A set-full checker rides the same history:
job names are set elements (add-job = add, each read observes the
names that ever ran), giving stale/lost element analysis in anger.

The mini scheduler (CI, the disque/rabbit pattern): an in-repo HTTP
server per node — POST /jobs registers a job (fsync'd jobs AOF), a
scheduler thread fires runs at target times, recording run start/end
to an fsync'd run log; GET /runs returns them. kill -9 between a
run's start and end leaves an INCOMPLETE run (start, no end) exactly
like a real executor crash, and jobs persist across restarts while
missed windows stay missed — the anomaly the checker exists to catch.

The port's copy of `jepsen_tpu/dbs/chronos.py`. Its own choices: the
client speaks HTTP through the port's `httpclient` (on `http.client`;
the reference's uses `requests`, which the card's machine lacks), its
`RequestException` classified as the reference classifies `requests`'
(a failed read is :fail, a failed add-job :info); the mini schedulers
listen from `MINI_BASE_PORT` 30900 (the reference's from 24300, so that
both packages' clusters can run on one host at once; below Linux's
ephemeral range, 32768-60999); the store root `store/torch`. Its
checks run on the host, as the reference's do.

    python -m jepsen_tpu_torch.dbs.chronos test --nodes c1,c2 --time-limit 7
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from .. import checker as jchecker
from .. import cli, client as jclient, db as jdb
from .. import generator as gen
from .. import nemesis as jnemesis
from ..control import localexec
from ..history import History
from ..ledger import BASE_DIR
from . import httpclient, miniserver

EPSILON_FORGIVENESS = 0.5  # seconds; the reference forgives 5 s at
#                            minute-scale jobs — scaled to CI seconds

MINI_BASE_PORT = 30900
MINI_PIDFILE = "minichronos.pid"
MINI_LOGFILE = "minichronos.log"

MINICHRONOS_SRC = r'''
import argparse, json, os, threading, time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

p = argparse.ArgumentParser()
p.add_argument("--port", type=int, required=True)
p.add_argument("--dir", default=".")
args = p.parse_args()

JOBS_AOF = os.path.join(args.dir, "chronos-jobs.aof")
RUN_LOG = os.path.join(args.dir, "chronos-runs.log")
LOCK = threading.Lock()
JOBS = {}       # name -> job dict
FIRED = {}      # name -> set of fired target indices (NOT persisted:
#                 a restart does not resurrect missed windows)
RSEQ = [0]

def persist(path, line):
    with open(path, "ab") as fh:
        fh.write(line.encode() + b"\n")
        fh.flush()
        os.fsync(fh.fileno())

def replay():
    if os.path.exists(JOBS_AOF):
        with open(JOBS_AOF) as fh:
            for line in fh:
                try:
                    j = json.loads(line)
                except ValueError:
                    continue  # torn tail
                JOBS[j["name"]] = j
                FIRED[j["name"]] = set()
    # resume run ids past every recorded one: a reused rid would
    # OVERWRITE a pre-crash run in read_runs and fake a missed target
    if os.path.exists(RUN_LOG):
        with open(RUN_LOG) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) == 4 and parts[1].startswith("r"):
                    try:
                        RSEQ[0] = max(RSEQ[0], int(parts[1][1:]) + 1)
                    except ValueError:
                        pass
    # skip every target already due: missed-while-down stays missed
    now = time.time()
    for name, j in JOBS.items():
        for k in range(j["count"]):
            if j["start"] + k * j["interval"] <= now:
                FIRED[name].add(k)

def read_runs():
    runs = {}
    if os.path.exists(RUN_LOG):
        with open(RUN_LOG) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) != 4:
                    continue
                kind, rid, name, t = parts
                if kind == "S":
                    runs[rid] = {"name": name, "start": float(t),
                                 "end": None}
                elif kind == "E" and rid in runs:
                    runs[rid]["end"] = float(t)
    return list(runs.values())

def do_run(name, duration):
    with LOCK:
        rid = "r%d" % RSEQ[0]
        RSEQ[0] += 1
    persist(RUN_LOG, "S %s %s %.6f" % (rid, name, time.time()))
    time.sleep(duration)
    persist(RUN_LOG, "E %s %s %.6f" % (rid, name, time.time()))

def scheduler():
    while True:
        now = time.time()
        with LOCK:
            for name, j in JOBS.items():
                fired = FIRED.setdefault(name, set())
                for k in range(j["count"]):
                    t = j["start"] + k * j["interval"]
                    if t <= now and k not in fired:
                        fired.add(k)
                        threading.Thread(
                            target=do_run,
                            args=(name, j["duration"]),
                            daemon=True).start()
        time.sleep(0.04)

class H(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _reply(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        if self.path != "/jobs":
            return self._reply(404, {"error": "not found"})
        n = int(self.headers.get("Content-Length") or 0)
        try:
            j = json.loads(self.rfile.read(n))
            assert set(j) >= {"name", "start", "count", "interval",
                              "epsilon", "duration"}
        except (ValueError, AssertionError):
            return self._reply(400, {"error": "bad job"})
        with LOCK:
            # fsync BEFORE acking: an acked job survives kill -9
            persist(JOBS_AOF, json.dumps(j))
            JOBS[j["name"]] = j
            FIRED.setdefault(j["name"], set())
        self._reply(200, {"ok": True})

    def do_GET(self):
        if self.path == "/runs":
            return self._reply(200, {"runs": read_runs(),
                                     "now": time.time()})
        self._reply(404, {"error": "not found"})

replay()
threading.Thread(target=scheduler, daemon=True).start()
print("minichronos serving on", args.port, flush=True)
ThreadingHTTPServer(("127.0.0.1", args.port), H).serve_forever()
'''


def mini_node_port(test: dict, node: str) -> int:
    from . import node_port as _shared
    return _shared(test, node, MINI_BASE_PORT, "chronos_ports")


class MiniChronosDB(miniserver.MiniServerDB):
    script = "minichronos.py"
    src = MINICHRONOS_SRC
    pidfile = MINI_PIDFILE
    logfile = MINI_LOGFILE
    data_files = ("chronos-jobs.aof", "chronos-runs.log")

    def port(self, test, node):
        return mini_node_port(test, node)

    def extra_args(self, test, node):
        return ["--dir", "."]


# -- the checker ------------------------------------------------------------

def job_targets(read_time: float, job: dict) -> list:
    """[(start, deadline)] for every target that MUST have begun by
    read_time (chronos/checker.clj job->targets). The cutoff includes
    the forgiveness tail: a run may legally start as late as
    t + epsilon + EPSILON_FORGIVENESS, so a target only becomes
    demandable once read_time clears that PLUS the duration."""
    finish = (read_time - job["epsilon"] - EPSILON_FORGIVENESS
              - job["duration"])
    out = []
    for k in range(job["count"]):
        t = job["start"] + k * job["interval"]
        if t >= finish:
            break
        out.append((t, t + job["epsilon"] + EPSILON_FORGIVENESS))
    return out


def job_solution(read_time: float, job: dict, runs: list) -> dict:
    """Match targets to distinct completed runs. Greedy
    earliest-deadline-first over sorted run starts is exact here (each
    target admits an interval of run times; intervals sorted by
    deadline => greedy is optimal)."""
    targets = job_targets(read_time, job)
    complete = sorted((r for r in runs if r.get("end") is not None),
                      key=lambda r: r["start"])
    incomplete = [r for r in runs if r.get("end") is None]
    unmatched = list(complete)
    solution = []
    missing = []
    for (t0, t1) in sorted(targets, key=lambda tw: tw[1]):
        hit = next((r for r in unmatched if t0 <= r["start"] <= t1),
                   None)
        if hit is None:
            missing.append([t0, t1])
        else:
            unmatched.remove(hit)
            solution.append({"target": [t0, t1], "run": hit})
    return {"valid?": not missing,
            "job": job,
            "solution": solution,
            "missing-targets": missing,
            "extra": unmatched,
            "complete": len(complete),
            "incomplete": len(incomplete)}


class ChronosChecker(jchecker.Checker):
    """chronos/checker.clj solution: partition jobs and runs by name,
    solve each; valid iff every job's targets are satisfied."""

    def check(self, test, history: History, opts=None):
        jobs = []
        runs = []
        read_time = None
        seen = set()
        for op in history:
            if op.is_ok and op.f == "add-job":
                jobs.append(op.value)
            elif op.is_ok and op.f == "read":
                # nodes are independent schedulers: each read sees its
                # own node's runs, so the global run set is the UNION
                # of every final read (dedup by identity triple)
                for r in op.value["runs"]:
                    key = (str(r["name"]), r["start"], r.get("end"))
                    if key not in seen:
                        seen.add(key)
                        runs.append(r)
                t = op.value["now"]
                read_time = t if read_time is None \
                    else min(read_time, t)  # conservative cutoff
        if read_time is None:
            return {"valid?": "unknown",
                    "error": "no successful final read"}
        # the run log round-trips names as strings; job names may be
        # ints — normalize both sides to str for grouping
        by_name: dict = {}
        for r in runs:
            by_name.setdefault(str(r["name"]), []).append(r)
        solns = {str(j["name"]): job_solution(
                     read_time, j, by_name.get(str(j["name"]), []))
                 for j in jobs}
        return {"valid?": all(s["valid?"] for s in solns.values()),
                "job-count": len(jobs),
                "read-time": read_time,
                "jobs": solns,
                "extra-count": sum(len(s["extra"])
                                   for s in solns.values()),
                "incomplete-count": sum(s["incomplete"]
                                        for s in solns.values())}


def chronos_checker() -> jchecker.Checker:
    return ChronosChecker()


class _SetViewChecker(jchecker.Checker):
    """Adapt the scheduler history for set-full (the checker this
    suite exercises in anger): add-job acks add the job NAME; every
    read observes the set of names that ever ran. A job that was
    acknowledged but never ran surfaces as a lost element."""

    def __init__(self):
        self.inner = jchecker.set_full(linearizable=False)

    def check(self, test, history: History, opts=None):
        # union of every node's final read: see ChronosChecker
        union = sorted({str(r["name"]) for op in history
                        if op.is_ok and op.f == "read"
                        for r in op.value["runs"]})
        mapped = []
        for op in history:
            if op.f == "add-job":
                mapped.append(op.with_(f="add",
                                       value=str(op.value["name"])))
            elif op.f == "read":
                mapped.append(op.with_(
                    f="read", value=union if op.is_ok else None))
            else:
                mapped.append(op)
        return self.inner.check(test, History(mapped).index(), opts)


# -- client -----------------------------------------------------------------

class ChronosClient(jclient.Client):
    """add-job POSTs the job (definite on 2xx, indefinite otherwise);
    read GETs every recorded run plus the server's read time
    (chronos.clj:161-192 client)."""

    def __init__(self, port_fn=None, timeout: float = 5.0):
        self.port_fn = port_fn or (lambda test, node: (node, 4400))
        self.timeout = timeout
        self.node: Optional[str] = None
        self.http = None

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout)
        c.node = node
        c.http = httpclient.Session()
        return c

    def _url(self, test, path):
        host, port = self.port_fn(test, self.node)
        return f"http://{host}:{port}{path}"

    def invoke(self, test, op):
        http = self.http or httpclient
        try:
            if op["f"] == "add-job":
                r = http.post(self._url(test, "/jobs"),
                              json=op["value"], timeout=self.timeout)
                t = "ok" if r.status_code == 200 else "info"
                return {**op, "type": t}
            if op["f"] == "read":
                r = http.get(self._url(test, "/runs"),
                             timeout=self.timeout)
                r.raise_for_status()
                return {**op, "type": "ok", "value": r.json()}
            raise ValueError(f"unknown op {op['f']!r}")
        except httpclient.RequestException as e:
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": str(e)[:200]}

    def close(self, test):
        if self.http is not None:
            self.http.close()


def add_job_gen(head_start: float = 0.7):
    """Unique jobs with CI-scale timing (chronos.clj:194-217 add-job,
    scaled from minutes to seconds). Intervals exceed
    duration + epsilon + forgiveness so targets never overlap — the
    same disjointness the reference engineers for its solver."""
    counter = iter(range(1, 10**9))

    def op(test, ctx):
        i = next(counter)
        duration = 0.05 + (i % 3) * 0.05
        epsilon = 0.4
        interval = duration + epsilon + EPSILON_FORGIVENESS + 0.3
        return {"f": "add-job",
                "value": {"name": i,
                          "start": time.time() + head_start,
                          "count": 2 + (i % 3),
                          "duration": duration,
                          "epsilon": epsilon,
                          "interval": round(interval, 3)}}

    return op


def chronos_test(options: dict) -> dict:
    """add jobs for a while, let the schedule play out, then a final
    read on every thread; chronos solution + set-full checkers
    (chronos.clj:240-270 simple-test, CI-scaled)."""
    nodes = options["nodes"]
    time_limit = options.get("time_limit") or 8
    interval = options.get("nemesis_interval") or 3.0
    with_kills = bool(options.get("kills"))
    db = MiniChronosDB()

    def port_fn(test, node):
        return ("127.0.0.1", mini_node_port(test, node))

    # NB: gen.sleep is an op the worker naps through — a huge sleep
    # would pin the nemesis worker past every phase. No kills means NO
    # nemesis generator at all, not a sleeping one.
    add_phase_clients = gen.clients(gen.stagger(0.15, add_job_gen()))
    if with_kills:
        add_phase = gen.nemesis(
            gen.cycle([gen.sleep(interval),
                       {"type": "info", "f": "start"},
                       gen.sleep(max(0.5, interval / 3)),
                       {"type": "info", "f": "stop"}]),
            gen.stagger(0.15, add_job_gen()))
    else:
        add_phase = add_phase_clients

    return {
        "name": options.get("name") or "chronos-mini",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options["concurrency"],
        "db": db,
        "client": ChronosClient(port_fn=port_fn),
        "remote": localexec.remote(options.get("sandbox")
                                   or "chronos-cluster"),
        "ssh": {"dummy?": False},
        "nemesis": jnemesis.node_start_stopper(
            lambda ns: [gen.RNG.choice(ns)],
            lambda test, node: db.kill(test, node),
            lambda test, node: db.start(test, node)),
        "checker": jchecker.compose({
            "chronos": chronos_checker(),
            "set": _SetViewChecker(),
            "exceptions": jchecker.unhandled_exceptions(),
        }),
        "generator": gen.phases(
            gen.time_limit(min(time_limit / 3, 3.0), add_phase),
            # let every schedule play out (+ the nemesis recover)
            gen.nemesis(gen.once(
                lambda test, ctx: {"type": "info", "f": "stop"})),
            gen.sleep(time_limit * 2 / 3),
            gen.clients(gen.each_thread(gen.once(
                lambda test, ctx: {"f": "read", "value": None})))),
    }


CHRONOS_OPTS = [
    cli.Opt("name", metavar="NAME", default=None),
    cli.Opt("store_root", metavar="DIR", default=BASE_DIR),
    cli.Opt("sandbox", metavar="DIR", default="chronos-cluster"),
    cli.Opt("kills", default=False,
            help="kill/restart the scheduler mid-test (expect missed "
                 "windows: the checker should report them)"),
    cli.Opt("nemesis_interval", metavar="SECONDS", default=3.0,
            parse=float),
]

COMMANDS = {
    **cli.single_test_cmd({"test_fn": chronos_test,
                           "opt_spec": CHRONOS_OPTS}),
    **cli.serve_cmd(),
}

if __name__ == "__main__":
    sys.exit(cli.main(COMMANDS))
