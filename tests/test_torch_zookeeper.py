"""The port's zookeeper suite (`jepsen_tpu_torch/dbs/zookeeper.py`), held
against the JAX package: the twins of `tests/test_zookeeper.py` (zoo.cfg
fragments, the DB's commands through the dummy remote, the zkCli-based
CAS client against a scripted remote, the full suite against it and
against live mini znode servers under kill -9 and SIGSTOP), and parity
cases: the DB's commands, the embedded server and the uploaded zkCli
stand-in equal to the reference's.

Also: the port's ports and store root are its own, the `device` option
reaches the `linear` checker, and a missing card raises before any node
is set up. The suites check on the CPU (`device="cpu"`).
"""

import ast
import os
import re
import threading

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import zookeeper as ref_zk
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import zookeeper as zk
from test_zookeeper import zk_get_output


class ZkStubRemote(DummyRemote):
    """The reference test's scripted znode (`tests/test_zookeeper.py`) on
    the port's dummy remote: zkCli.sh commands parsed out of the exec'd
    shell strings and applied to a shared versioned register."""

    state = {"value": None, "version": 0}
    lock = threading.Lock()

    def execute(self, context, action):
        super().execute(context, action)
        cmd = action.get("cmd", "")
        if "zkCli.sh" not in cmd:
            return {**action, "exit": 0, "out": "", "err": ""}
        m = re.search(r"zkCli\.sh -server \S+ [\"']?(create|get|set) "
                      r"(\S+)\s*(.*?)[\"']?$", cmd)
        assert m, cmd
        verb, _znode, rest = m.group(1), m.group(2), m.group(3).split()
        with self.lock:
            st = type(self).state
            if verb == "create":
                st["value"], st["version"] = int(rest[0]), 0
                return {**action, "exit": 0, "out": "Created", "err": ""}
            if verb == "get":
                return {**action, "exit": 0, "err": "",
                        "out": zk_get_output(st["value"], st["version"])}
            if verb == "set":
                new = int(rest[0])
                if len(rest) > 1:
                    if int(rest[1]) != st["version"]:
                        return {**action, "exit": 0, "err": "",
                                "out": "version No is not valid : "
                                       f"{rest[1]}"}
                st["value"] = new
                st["version"] += 1
                return {**action, "exit": 0, "err": "",
                        "out": zk_get_output(new, st["version"])}
        raise AssertionError(cmd)


# -- the twins of tests/test_zookeeper.py ---------------------------------

def test_zoo_cfg_fragments():
    test = {"nodes": ["n1", "n2", "n3"]}
    assert zk.node_ids(test) == {"n1": 0, "n2": 1, "n3": 2}
    frag = zk.zoo_cfg_servers(test)
    assert "server.0=n1:2888:3888" in frag
    assert "server.2=n3:2888:3888" in frag


def db_commands(ctl, remote_cls, mod) -> tuple:
    test = {"nodes": ["n1", "n2"]}
    log: list = []
    db = mod.ZkDB()
    with ctl.with_remote(remote_cls(log)):
        with ctl.on("n1"):
            db.setup(test, "n1")
            db.teardown(test, "n1")
    return log, db.log_files(test, "n1")


def test_db_setup_commands():
    log, files = db_commands(c, DummyRemote, zk)
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "zookeeperd=" in joined
    assert "service zookeeper start" in joined
    assert "/var/lib/zookeeper/version-*" in joined
    uploads = [x[1] for x in log if isinstance(x[1], tuple)
               and x[1][0] == "upload"]
    dests = [u[2] for u in uploads]
    assert f"{zk.CONF}/myid" in dests
    assert f"{zk.CONF}/zoo.cfg" in dests
    assert files == [zk.LOG]


def test_client_cas_semantics():
    ZkStubRemote.state = {"value": None, "version": 0}
    with c.with_remote(ZkStubRemote()):
        with c.on("n1"):
            cl = zk.ZkClient().open({}, "n1")
            cl.setup({})
            assert cl.invoke({}, {"f": "read", "value": None,
                                  "process": 0})["value"] == 0
            assert cl.invoke({}, {"f": "write", "value": 3,
                                  "process": 0})["type"] == "ok"
            ok = cl.invoke({}, {"f": "cas", "value": [3, 4],
                                "process": 0})
            fail = cl.invoke({}, {"f": "cas", "value": [3, 5],
                                  "process": 0})
            assert ok["type"] == "ok" and fail["type"] == "fail"
            assert cl.invoke({}, {"f": "read", "value": None,
                                  "process": 0})["value"] == 4


def test_full_suite_with_stub(tmp_path):
    ZkStubRemote.state = {"value": None, "version": 0}
    opts = {"nodes": ["n1", "n2"], "concurrency": 4, "time_limit": 4,
            "store_root": str(tmp_path / "store"), "device": "cpu"}
    t = zk.zk_test(opts)
    t["remote"] = ZkStubRemote()
    t["os"] = None
    t["db"] = None
    done = core.run(t)
    assert done["results"]["valid?"] is True
    assert done["results"]["linear"]["valid?"] is True
    completions = [op for op in done["history"]
                   if getattr(op, "type", None) in ("ok", "fail")]
    assert completions


def _mini(tmp_path, **kw):
    return {"time_limit": 6, "rate": 20.0, "nemesis_interval": 2.0,
            "server": "mini", "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


def test_mini_suite_live_kill(tmp_path):
    done = core.run(zk.zk_test(_mini(tmp_path, nodes=["z1", "z2"],
                                     concurrency=4, fault="kill")))
    res = done["results"]
    assert res["valid?"] is True, res
    assert res["linear"]["valid?"] is True


def test_mini_suite_live_pause(tmp_path):
    done = core.run(zk.zk_test(_mini(tmp_path, nodes=["z1"],
                                     concurrency=3, fault="pause")))
    res = done["results"]
    assert res["valid?"] is True, res


# -- parity and the port's own choices ---------------------------------------

def masked(log) -> list:
    """The command log, each upload's local temp file masked."""
    return [(n, ("upload", "<tmp>", *x[2:])
             if isinstance(x, tuple) and x[0] == "upload" else x)
            for n, x in log]


def test_db_commands_match_reference():
    log, files = db_commands(c, DummyRemote, zk)
    ref_log, ref_files = db_commands(ref_c, RefDummyRemote, ref_zk)
    assert masked(log) == masked(ref_log) and files == ref_files


@pytest.mark.parametrize("name", ("MINIZK_SRC", "ZKCLI_SRC"))
def test_server_and_cli_src_are_the_references(name):
    src = getattr(zk, name)
    assert src == getattr(ref_zk, name)
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "socket" in mods or "socketserver" in mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


def ephemeral_range() -> tuple:
    """Linux's range of ephemeral ports (the default where unreadable)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            lo, hi = fh.read().split()
        return int(lo), int(hi)
    except OSError:
        return 32768, 60999


def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert zk.MINI_BASE_PORT == 30800
    assert zk.MINI_BASE_PORT != ref_zk.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < zk.MINI_BASE_PORT and zk.MINI_BASE_PORT + 5 < lo
    test = {"nodes": ["z1", "z2"]}
    assert [zk.mini_node_port(test, n) for n in test["nodes"]] == \
        [zk.MINI_BASE_PORT, zk.MINI_BASE_PORT + 1]
    t = zk.zk_test(_mini(tmp_path, nodes=["z1", "z2"], concurrency=2))
    # every client drives the primary's server, on the port's base
    assert t["client"].addr_fn("z2") == ("127.0.0.1", zk.MINI_BASE_PORT)
    t = zk.zk_test({"nodes": ["z1"], "concurrency": 2, "server": "mini",
                    "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")


def test_device_reaches_the_checker(tmp_path):
    t = zk.zk_test(_mini(tmp_path, nodes=["z1"], concurrency=2))
    lin = t["checker"].checker_map["linear"]
    assert lin.device == torch.device("cpu")
    assert lin.algorithm == "competition"


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "release"):
        with pytest.raises(RuntimeError, match="CUDA"):
            zk.zk_test({**_mini(tmp_path, nodes=["z1"], concurrency=2),
                        "server": server, "device": None})
    assert not (tmp_path / "cluster").exists()
