"""The port's node utilities and their first users, held against the JAX
package: `control/nodeutil.py`, `control/netinfo.py`, `net.py`'s
`IPTables` and `IPFilter`, `os_setup.py`'s distributions, `db.Tcpdump`,
the fault injectors of `nemesis/__init__.py`, and the docker and kubectl
remotes (`control/dockerexec.py`, `k8s.py`: the argv each hands to
`subprocess.run`).

Each runs over a recording dummy remote of its own package that answers
a few commands from a script (a pidfile's pid, a directory listing, a
hosts file, a package list); the commands each issues, in order per
node, and what it returns equal the reference's under the same seeded
`random` state. Uploads are recorded by their bytes. Nothing here runs
a command on this machine: the root-only nemeses (`set_time`, the
clock scrambler, `IPTables`, the distributions) are checked only as
command text.
"""

import time

import pytest

import jepsen_tpu.control as ref_c
import jepsen_tpu.control.dummy as ref_dummy
import jepsen_tpu.db as ref_db
import jepsen_tpu.nemesis as ref_nem
import jepsen_tpu.net as ref_net
import jepsen_tpu.os_setup as ref_os
from jepsen_tpu.control import netinfo as ref_netinfo
from jepsen_tpu.control import nodeutil as ref_nodeutil
import jepsen_tpu_torch.control as port_c
import jepsen_tpu_torch.control.dummy as port_dummy
import jepsen_tpu_torch.db as port_db
import jepsen_tpu_torch.nemesis as port_nem
import jepsen_tpu_torch.net as port_net
import jepsen_tpu_torch.os_setup as port_os
from jepsen_tpu_torch.control import netinfo as port_netinfo
from jepsen_tpu_torch.control import nodeutil as port_nodeutil


class Pkg:
    def __init__(self, c, dummy, nodeutil, netinfo, net, os_, db, nem):
        self.c, self.dummy, self.nodeutil, self.netinfo = (c, dummy,
                                                           nodeutil, netinfo)
        self.net, self.os, self.db, self.nem = net, os_, db, nem


REF = Pkg(ref_c, ref_dummy, ref_nodeutil, ref_netinfo, ref_net, ref_os,
          ref_db, ref_nem)
PORT = Pkg(port_c, port_dummy, port_nodeutil, port_netinfo, port_net,
           port_os, port_db, port_nem)
NODES = ["n1", "n2", "n3", "n4", "n5"]
SEEDS = (0, 1, 2)


def default_script(cmd: str):
    """(out, exit) for a command: the answers a live node would give."""
    if "cat /etc/hosts" in cmd:
        return "127.0.0.1 localhost\n10.0.0.9 other\n", 0
    if "pkgin -p list" in cmd:
        return "curl-7.88;Command line tool\nunzip-6.0;Extract\n", 0
    if "cat " in cmd:
        return "4242\n", 0
    if "mktemp -d" in cmd:
        return "/tmp/jepsen-tmp-dir\n", 0
    if "mktemp" in cmd:
        return "/tmp/jepsen-tmp-file\n", 0
    if cmd.endswith("hostname"):
        return "node-host\n", 0
    if "ls " in cmd:
        return "alpha\nbeta\n", 0
    if ("test -f" in cmd or "dpkg -s" in cmd or "getent" in cmd
            or "ps -p" in cmd):
        return "", 1
    return "", 0


def recording_remote(pkg: Pkg, log: list, script=default_script):
    class Scripted(pkg.dummy.DummyRemote):
        def execute(self, context, action):
            cmd = action.get("cmd")
            self.log.append((self.host, cmd))
            out, code, *err = script(cmd)
            return {**action, "exit": code, "out": out,
                    "err": err[0] if err else "", "action": action}

        def upload(self, context, local_paths, remote_path, opts=None):
            paths = [local_paths] if isinstance(local_paths, str) \
                else list(local_paths)
            self.log.append((self.host, ("upload", [
                open(p, "rb").read() for p in paths], remote_path)))

    return Scripted(log)


def on_node(pkg: Pkg, fn, script=default_script, node="n1"):
    """fn(pkg) on one node of pkg's recording remote: (log, result or
    the exception's type and text)."""
    log: list = []
    with pkg.c.with_remote(recording_remote(pkg, log, script)):
        with pkg.c.on(node):
            try:
                out = fn(pkg)
            except Exception as e:  # noqa: BLE001 - compared below
                out = ("raised", type(e).__name__, str(e))
    return log, out


def same_on_node(fn, script=default_script, node="n1"):
    ref = on_node(REF, fn, script, node)
    port = on_node(PORT, fn, script, node)
    assert port == ref
    return port


def on_cluster(pkg: Pkg, fn, seed: int, nodes=NODES, script=default_script):
    """fn(pkg, test) with sessions to every node and the package's RNGs
    seeded: (each node's commands in order, the result)."""
    import jepsen_tpu.generator as ref_gen
    import jepsen_tpu_torch.generator as port_gen
    gen = ref_gen if pkg is REF else port_gen
    pkg.nem.RNG.seed(seed)
    gen.RNG.seed(seed)
    log: list = []
    rem = recording_remote(pkg, log, script)
    test = {"nodes": list(nodes),
            "sessions": {n: rem.connect({"host": n}) for n in nodes},
            "net": pkg.net.IPTables()}
    with pkg.c.with_remote(rem):
        try:
            out = fn(pkg, test)
        except Exception as e:  # noqa: BLE001 - compared below
            out = ("raised", type(e).__name__)
    per_node: dict = {}
    for host, cmd in log:
        per_node.setdefault(host, []).append(cmd)
    return per_node, out


def same_on_cluster(fn, seed: int, **kw):
    ref = on_cluster(REF, fn, seed, **kw)
    port = on_cluster(PORT, fn, seed, **kw)
    assert port == ref
    return port


# -- nodeutil -----------------------------------------------------------------

NODEUTIL_CALLS = {
    "meh": lambda p: (p.nodeutil.meh(lambda: 1 / 0),
                      p.nodeutil.meh(p.c.exec_, "echo", "hi")),
    "await_tcp_port": lambda p: p.nodeutil.await_tcp_port(
        7000, host="10.1.2.3", timeout_s=1),
    "file_exists": lambda p: p.nodeutil.file_exists("/var/lib/x y"),
    "is_file": lambda p: p.nodeutil.is_file("/etc/passwd"),
    "ls": lambda p: p.nodeutil.ls("/opt"),
    "ls_full": lambda p: p.nodeutil.ls_full("/opt"),
    "tmp_file": lambda p: p.nodeutil.tmp_file(".tar.gz"),
    "tmp_dir": lambda p: p.nodeutil.tmp_dir(),
    "write_file": lambda p: p.nodeutil.write_file("a b\n'q'\n", "/etc/f"),
    "wget": lambda p: p.nodeutil.wget("http://h/x/pkg.tgz?sig=1"),
    "wget_force": lambda p: p.nodeutil.wget("http://h/p.tgz", "out.tgz",
                                            force=True),
    "cached_wget": lambda p: p.nodeutil.cached_wget("http://h/big.tgz",
                                                    force=True),
    "install_archive_tar": lambda p: p.nodeutil.install_archive(
        "http://h/db-1.0.tar.gz", "/opt/db", user="db"),
    "install_archive_zip": lambda p: p.nodeutil.install_archive(
        "file:///srv/db.zip", "/opt/db"),
    "grepkill": lambda p: p.nodeutil.grepkill("toykv_server.py --port 1"),
    "grepkill_term": lambda p: p.nodeutil.grepkill("java", "TERM"),
    "signal": lambda p: p.nodeutil.signal("db", "STOP"),
    "start_daemon": lambda p: p.nodeutil.start_daemon(
        {"logfile": "/var/log/db.log", "pidfile": "/run/db.pid",
         "chdir": "/opt/db", "env": {"PORT": "99", "A": "b c"}},
        "/opt/db/bin/db", "--serve", "x y"),
    "start_daemon_foreground": lambda p: p.nodeutil.start_daemon(
        {"logfile": "l", "background?": False, "match-executable?": False,
         "match-process-name?": True, "process-name": "dbd",
         "pidfile": "p", "make-pidfile?": False},
        "/usr/bin/dbd"),
    "start_daemon_lit_chdir": lambda p: p.nodeutil.start_daemon(
        {"logfile": "server.log", "pidfile": "toykv.pid",
         "exec": "/usr/bin/python3", "chdir": p.c.lit("$PWD")},
        "/usr/bin/python3", "toykv_server.py", "--port", "31850"),
    "stop_daemon_pidfile": lambda p: p.nodeutil.stop_daemon("/run/db.pid"),
    "stop_daemon_name": lambda p: p.nodeutil.stop_daemon("dbd",
                                                         "/run/db.pid"),
    "daemon_running": lambda p: p.nodeutil.daemon_running("/run/db.pid"),
}


@pytest.mark.parametrize("call", list(NODEUTIL_CALLS))
def test_nodeutil_commands_match_reference(call):
    log, _ = same_on_node(NODEUTIL_CALLS[call])
    assert log, "issued no command"


def already_running(cmd):
    if "start-stop-daemon" in cmd:
        return "", 1
    return default_script(cmd)


def nothing_running(cmd):
    if cmd.endswith("cat /run/db.pid") or "ps -o" in cmd:
        return "", 1
    return default_script(cmd)


@pytest.mark.parametrize("script,call,want", [
    (already_running, "start_daemon", "already-running"),
    (default_script, "start_daemon", "started"),
    (default_script, "daemon_running", True),
    (nothing_running, "daemon_running", None),
], ids=["already-running", "started", "running", "no-pid"])
def test_daemon_outcomes_match_reference(script, call, want):
    _, out = same_on_node(NODEUTIL_CALLS[call], script)
    assert out == want


def test_stale_pid_is_not_running():
    def stale(cmd):
        return ("", 1) if "ps -o" in cmd else default_script(cmd)
    _, out = same_on_node(NODEUTIL_CALLS["daemon_running"], stale)
    assert out is False


# -- netinfo ------------------------------------------------------------------

def test_netinfo_matches_reference():
    def probe(p):
        return (p.netinfo.ip("localhost"), p.netinfo.ip("no-such-node.x"),
                p.netinfo.local_ip(), p.netinfo.control_ip())
    script = lambda cmd: ("10.0.0.7 10.0.0.8\n", 0) if "hostname -I" in cmd \
        else default_script(cmd)
    log, out = same_on_node(probe, script, node="localhost")
    assert out[0] == "127.0.0.1" and out[1] == "no-such-node.x"
    assert out[2] == "10.0.0.7"


# -- net ----------------------------------------------------------------------

NET_CALLS = {
    "iptables drop": lambda p, t: p.net.IPTables().drop(t, "n1", "n2"),
    "iptables heal": lambda p, t: p.net.IPTables().heal(t),
    "iptables slow": lambda p, t: p.net.IPTables().slow(
        t, {"mean": 120, "variance": 7, "distribution": "pareto"}),
    "iptables slow default": lambda p, t: p.net.IPTables().slow(t),
    "iptables flaky": lambda p, t: p.net.IPTables().flaky(t),
    "iptables fast": lambda p, t: p.net.IPTables().fast(t),
    "iptables drop_all": lambda p, t: p.net.drop_all(
        t, {"n1": {"n2", "n3"}, "n4": {"n5"}, "n2": set()}),
    "ipfilter drop": lambda p, t: p.net.IPFilter().drop(t, "n1", "n2"),
    "ipfilter heal": lambda p, t: p.net.IPFilter().heal(t),
    "ipfilter slow": lambda p, t: p.net.IPFilter().slow(t, {"mean": 5}),
    "ipfilter flaky": lambda p, t: p.net.IPFilter().flaky(t),
    "ipfilter fast": lambda p, t: p.net.IPFilter().fast(t),
}


@pytest.mark.parametrize("call", list(NET_CALLS))
def test_net_commands_match_reference(call):
    per_node, _ = same_on_cluster(NET_CALLS[call], 0)
    assert per_node


def test_iptables_fast_tolerates_only_a_missing_qdisc():
    def missing(cmd):
        if "qdisc del" in cmd:
            return "", 2, "RTNETLINK answers: No such file or directory\n"
        return default_script(cmd)

    def broken(cmd):
        return ("", 2, "permission denied") if "qdisc del" in cmd \
            else default_script(cmd)

    _, out = same_on_cluster(NET_CALLS["iptables fast"], 0, script=missing)
    assert out is None
    _, out = same_on_cluster(NET_CALLS["iptables fast"], 0, script=broken)
    assert out[:2] == ("raised", "NonzeroExit")


# -- os_setup -----------------------------------------------------------------

OS_CALLS = {
    "hostfile": lambda p, t: p.c.on_nodes(t, p.os.setup_hostfile),
    "debian": lambda p, t: p.c.on_nodes(
        t, lambda t2, n: p.os.Debian(["libfoo"]).setup(t2, n)),
    "debian install_jdk": lambda p, t: p.c.on_nodes(
        t, lambda t2, n: p.os.Debian().install_jdk()),
    "debian installed": lambda p, t: p.c.on_nodes(
        t, lambda t2, n: p.os.Debian().installed("curl")),
    "ubuntu": lambda p, t: p.c.on_nodes(
        t, lambda t2, n: p.os.Ubuntu().setup(t2, n)),
    "centos": lambda p, t: p.c.on_nodes(
        t, lambda t2, n: p.os.CentOS(["jq"]).setup(t2, n)),
    "smartos": lambda p, t: p.c.on_nodes(
        t, lambda t2, n: p.os.SmartOS(["gcc"]).setup(t2, n)),
    "smartos installed": lambda p, t: p.c.on_nodes(
        t, lambda t2, n: sorted(p.os.SmartOS().installed(
            ["curl", "wget", "unzip"]))),
}


@pytest.mark.parametrize("call", list(OS_CALLS))
def test_os_setup_commands_match_reference(call):
    per_node, out = same_on_cluster(OS_CALLS[call], 0, nodes=NODES[:3])
    assert set(per_node) == set(NODES[:3])


# -- db.Tcpdump ---------------------------------------------------------------

TCPDUMP_CALLS = {
    "setup ports": lambda p: p.db.tcpdump({"ports": [22, 8080]}).setup(
        {}, "n1"),
    "setup filter clients": lambda p: p.db.Tcpdump(
        {"clients_only": True, "filter": "tcp"}).setup({}, "n1"),
    "teardown": lambda p: p.db.Tcpdump().teardown({}, "n1"),
    "log_files": lambda p: p.db.Tcpdump().log_files({}, "n1"),
}


@pytest.mark.parametrize("call", list(TCPDUMP_CALLS))
def test_tcpdump_commands_match_reference(call):
    same_on_node(TCPDUMP_CALLS[call])


def test_tcpdump_is_a_log_files_db():
    td = port_db.tcpdump()
    assert isinstance(td, port_db.DB) and isinstance(td, port_db.LogFiles)
    assert td.log_files({}, "n1") == ["/tmp/jepsen/tcpdump/log",
                                      "/tmp/jepsen/tcpdump/tcpdump"]


# -- nemeses ------------------------------------------------------------------

def partition(make):
    def run(p, t):
        nem = make(p).setup(t)
        out = [nem.invoke(t, {"type": "info", "f": "start"}),
               nem.invoke(t, {"type": "info", "f": "stop"})]
        nem.teardown(t)
        return out, sorted(nem.fs())
    return run


NEMESIS_CALLS = {
    "partition_halves": partition(lambda p: p.nem.partition_halves()),
    "partition_random_halves": partition(
        lambda p: p.nem.partition_random_halves()),
    "partition_random_node": partition(
        lambda p: p.nem.partition_random_node()),
    "partition_majorities_ring": partition(
        lambda p: p.nem.partition_majorities_ring()),
    "partitioner_given_grudge": lambda p, t: p.nem.partitioner().invoke(
        t, {"type": "info", "f": "start",
            "value": {"n1": ["n3", "n2"], "n2": ["n1"]}}),
    "set_time": lambda p, t: p.c.on_nodes(
        t, lambda t2, n: p.nem.set_time(1_700_000_000.75)),
    "clock_scrambler": lambda p, t: (
        p.nem.clock_scrambler(30).invoke(t, {"type": "info",
                                             "f": "scramble-clock"}),
        p.nem.clock_scrambler(30).teardown(t)),
    "node_start_stopper": lambda p, t: [
        nem.invoke(t, {"type": "info", "f": f})
        for nem in [p.nem.node_start_stopper(
            lambda nodes: nodes[1:3],
            lambda test, node: p.c.exec_("service", "db", "stop")
            or f"stopped {node}",
            lambda test, node: p.c.exec_("service", "db", "start")
            or f"started {node}")]
        for f in ("start", "start", "stop", "stop")],
    "node_start_stopper_test_targeter": lambda p, t: p.nem.node_start_stopper(
        lambda test, nodes: test["nodes"][0], lambda test, node: node,
        lambda test, node: node).invoke(t, {"type": "info", "f": "start"}),
    "hammer_time": lambda p, t: [
        nem.invoke(t, {"type": "info", "f": f})
        for nem in [p.nem.hammer_time("java")] for f in ("start", "stop")],
    "truncate_file": lambda p, t: p.nem.truncate_file().invoke(
        t, {"type": "info", "f": "truncate",
            "value": {"n2": {"file": "/var/db/wal", "drop": 64},
                      "n4": {"file": "/var/db/x y", "drop": 1}}}),
}


@pytest.fixture
def frozen_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("call", list(NEMESIS_CALLS))
def test_nemesis_commands_and_grudges_match_reference(call, seed,
                                                      frozen_clock):
    per_node, out = same_on_cluster(NEMESIS_CALLS[call], seed)
    assert per_node or call == "node_start_stopper_test_targeter"


def test_partition_grudges_cover_every_node():
    for seed in SEEDS:
        _, ((start, _stop), fs) = same_on_cluster(
            NEMESIS_CALLS["partition_random_halves"], seed)
        kind, grudge = start["value"]
        assert kind == "isolated" and set(grudge) == set(NODES)
        assert fs == ["start", "stop"]


def test_partitioner_without_a_grudge_raises_as_the_reference():
    def run(p, t):
        try:
            p.nem.partitioner().invoke(t, {"type": "info", "f": "start"})
        except ValueError as e:
            return str(e)
    _, msg = same_on_cluster(run, 0)
    assert "grudge" in msg


# -- the docker and kubectl remotes -------------------------------------------

def container_argvs(mod, spec: dict) -> list:
    """The argv lists the remote of `mod` hands to `subprocess.run` for an
    exec (with and without stdin and sudo), an upload and a download."""
    import subprocess
    calls = []

    def run(argv, **kw):
        calls.append((list(argv), kw.get("input")))
        return subprocess.CompletedProcess(argv, 0, b"out", b"err")

    rem = mod.remote().connect(spec)
    real = mod.subprocess.run
    mod.subprocess.run = run
    try:
        out = [rem.execute({}, {"cmd": "echo hi"}),
               rem.execute({"sudo": "root"}, {"cmd": "cat", "in": "x y"})]
        rem.upload({}, ["/a/f1", "/a/f2"], "/dst")
        rem.download({}, "/etc/hosts", "/tmp/h")
    finally:
        mod.subprocess.run = real
    return calls, [(r["exit"], r["out"], r["err"], r["cmd"]) for r in out]


@pytest.mark.parametrize("name,spec", [
    ("dockerexec", {"host": "n1"}),
    ("k8s", {"host": "pod-1", "namespace": "jepsen"}),
    ("k8s", {"host": "pod-2"})])
def test_container_remotes_match_reference(name, spec):
    import importlib
    ref = container_argvs(importlib.import_module(
        f"jepsen_tpu.control.{name}"), spec)
    port = container_argvs(importlib.import_module(
        f"jepsen_tpu_torch.control.{name}"), spec)
    assert port == ref and len(ref[0]) == 5
