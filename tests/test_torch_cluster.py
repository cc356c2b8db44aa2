"""The port's harness for real nodes against live processes, held against
the JAX package.

The localexec remote (`jepsen_tpu_torch/control/localexec.py`): its
sandbox (commands run in the node's directory, absolute upload and
download paths rebased into it) and real processes, including a daemon
started, watched and stopped through `nodeutil` (`start-stop-daemon`,
pidfiles, `ps`). Then a short toykv register run under the kill/restart
nemesis, checked by the suite's own checker (the competition race, its
device lane on the CPU), whose history the JAX package's
`independent.checker(linearizable(algorithm="wgl"))` judges key by key
as the port did.
"""

import os
import socket
import time

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import independent as ref_independent
from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import control, core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control import localexec, nodeutil
from jepsen_tpu_torch.dbs import toykv
from jepsen_tpu_torch.independent import KV
from jepsen_tpu_torch.workloads import linearizable_register


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def test_localexec_sandboxing(tmp_path):
    """Commands are confined to the node dir; uploads/downloads rebase
    absolute paths into the sandbox."""
    rem = localexec.remote(str(tmp_path / "nodes"))
    s = rem.connect({"host": "n1"})
    out = s.execute({"dir": "/"}, {"cmd": "cd /; pwd"})
    assert out["out"].strip() == str(tmp_path / "nodes" / "n1")
    env = s.execute({}, {"cmd": "echo $JEPSEN_NODE $JEPSEN_NODE_DIR"})
    assert env["out"].split() == ["n1", str(tmp_path / "nodes" / "n1")]
    local = tmp_path / "f.txt"
    local.write_text("hello")
    s.upload({}, str(local), "/etc/f.txt")
    assert (tmp_path / "nodes" / "n1" / "etc" / "f.txt").read_text() == \
        "hello"
    s.download({}, "/etc/f.txt", str(tmp_path / "back.txt"))
    assert (tmp_path / "back.txt").read_text() == "hello"
    # another node sees nothing of n1's files
    s2 = rem.connect({"host": "n2"})
    assert s2.execute({}, {"cmd": "test -e etc/f.txt"})["exit"] == 1
    assert s.execute({}, {"cmd": "sleep 5", "timeout": 0.2})["exit"] == 124


def test_localexec_real_processes(tmp_path):
    """The control DSL drives real pids: a background process started
    through exec_ is visible and killable."""
    rem = localexec.remote(str(tmp_path / "nodes"))
    with control.with_remote(rem):
        with control.with_ssh({}):
            with control.on("n1"):
                control.exec_("bash", "-c",
                              "sleep 30 </dev/null >/dev/null 2>&1 & "
                              "echo $! > proc.pid")
                assert nodeutil.file_exists("proc.pid")
                pid = control.exec_("cat", "proc.pid").strip()
                assert pid.isdigit()
                control.exec_("kill", "-9", pid)


def _gone(pid: str, timeout_s: float = 10) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as fh:
                if fh.read().split(") ")[-1].startswith("Z"):
                    return True
        except FileNotFoundError:
            return True
        time.sleep(0.02)
    return False


def test_daemon_lifecycle_over_localexec(tmp_path):
    """nodeutil.start_daemon of a real `sleep` under start-stop-daemon,
    `daemon_running` True, a second start "already-running", then
    `stop_daemon` kills it and removes the pidfile (`daemon_running`
    None); a pidfile whose process died reads False."""
    sleep = "/bin/sleep" if os.path.exists("/bin/sleep") else "/usr/bin/sleep"
    rem = localexec.remote(str(tmp_path / "nodes"))
    opts = {"logfile": "sleep.log", "pidfile": "sleep.pid",
            "chdir": control.lit("$PWD")}
    with control.with_remote(rem), control.on("n1"):
        assert nodeutil.start_daemon(opts, sleep, "60") == "started"
        deadline = time.monotonic() + 10
        while not nodeutil.file_exists("sleep.pid"):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert nodeutil.daemon_running("sleep.pid") is True
        assert nodeutil.start_daemon(opts, sleep, "60") == "already-running"
        pid = control.exec_("cat", "sleep.pid").strip()
        nodeutil.stop_daemon("sleep.pid")
        assert _gone(pid)
        assert not nodeutil.file_exists("sleep.pid")
        assert nodeutil.daemon_running("sleep.pid") is None
        control.exec_("echo", "999999999", control.lit(">"), "stale.pid")
        assert nodeutil.daemon_running("stale.pid") is False
        log = control.exec_("cat", "sleep.log")
    assert "Jepsen starting" in log


def _ref_history(history) -> RefHistory:
    """The port's indexed history as the JAX package's, tuple values as
    its own tuples."""
    ops = []
    for op in history:
        d = op.to_dict()
        if isinstance(d["value"], KV):
            d["value"] = ref_independent.tuple_(d["value"].k, d["value"].v)
        ops.append(d)
    return RefHistory(ops)


def test_register_run_under_kill_is_judged_alike(tmp_path):
    """Two durable nodes, four workers, the kill/restart nemesis at 1 s
    and 2 s; the register workload's ops paced at ~150/s (so that the
    CPU device lane checks a few hundred ops). The suite's checker finds
    it valid, the nemesis really restarted a server, and the JAX
    package's oracle agrees with the port's verdict on every key."""
    nodes = ["a", "b"]
    test = toykv.toykv_test({
        "name": "toykv-register", "nodes": nodes, "concurrency": 4,
        "store_root": str(tmp_path / "store"),
        "sandbox": str(tmp_path / "cluster"), "time_limit": 3,
        "per_key_limit": 20, "nemesis_interval": 1.0, "device": "cpu"})
    test["toykv_ports"] = dict(zip(nodes, free_ports(len(nodes))))
    w = linearizable_register.workload({"nodes": nodes, "concurrency": 4,
                                        "per_key_limit": 20,
                                        "device": "cpu"})
    test["generator"] = gen.time_limit(3, gen.nemesis(
        gen.cycle([gen.sleep(1.0), {"type": "info", "f": "start"},
                   gen.sleep(1.0), {"type": "info", "f": "stop"}]),
        gen.stagger(1 / 150, w["generator"])))
    t = core.run(test)
    res = t["results"]
    assert res["valid?"] is True, res
    logs = "".join(open(os.path.join(t["store_dir"], n, "server.log")).read()
                   for n in nodes)
    assert logs.count("toykv serving on") >= 3
    port_keys = res["register"]["results"]
    assert port_keys and {r["linear"]["engine"] for r in port_keys.values()} \
        <= {"device", "oracle"}
    ref = ref_independent.checker(ref_checker.linearizable(
        ref_models.cas_register(), algorithm="wgl")).check(
            {"name": "toykv-register"}, _ref_history(t["history"]), {})
    assert ref["valid?"] == res["register"]["valid?"]
    assert {k: r["valid?"] for k, r in ref["results"].items()} == \
        {k: r["valid?"] for k, r in port_keys.items()}
