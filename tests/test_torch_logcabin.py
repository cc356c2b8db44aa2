"""The port's logcabin suite (`jepsen_tpu_torch/dbs/logcabin.py`) held
against the JAX package: the twins of `tests/test_logcabin.py` (the
TreeOps-shaped CLI against the live tree server, the CAS-register suite
run over the control plane under the kill/restart nemesis, the scons
source recipe and its `Primary` hook through the dummy remote), and parity
cases: the server's and the CLI's sources byte for byte, the source recipe's
and the mini server's commands, the commands the client execs and what it
makes of each exit code, and the generated ops.

Also: the port's ports and store root are its own, the `device` option
reaches the `linear` check, and a missing card raises before any node is
set up. The suite checks on the CPU (`device="cpu"`).
"""

import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import generator as ref_gen
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import logcabin as ref_lc
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import logcabin as lc
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.models import cas_register
from test_torch_galera import dummy_log
from test_torch_sqlite import ephemeral_range

#: the twin fixture's server port, inside logcabin's block (31600-31649)
FIXTURE_PORT = 31640


@pytest.fixture()
def mini(tmp_path):
    srv_py = tmp_path / "minitree.py"
    srv_py.write_text(lc.MINITREE_SRC)
    cli_py = tmp_path / "treeops.py"
    cli_py.write_text(lc.TREEOPS_SRC)
    port = FIXTURE_PORT
    proc = subprocess.Popen(
        [sys.executable, str(srv_py), "--port", str(port),
         "--dir", str(tmp_path)], cwd=tmp_path)
    # wait for the port
    deadline = time.monotonic() + 10
    while True:
        r = subprocess.run(
            [sys.executable, str(cli_py), "--port", str(port),
             "read", "/jepsen"], capture_output=True, cwd=tmp_path)
        if r.returncode == 0:
            break
        assert time.monotonic() < deadline, "never up"
        time.sleep(0.1)
    yield cli_py, port, tmp_path
    proc.kill()
    proc.wait(timeout=10)


def _run(cli_py, port, *args, cwd):
    return subprocess.run(
        [sys.executable, str(cli_py), "--port", str(port), *args],
        capture_output=True, text=True, cwd=cwd)


def test_treeops_cli_semantics(mini):
    cli_py, port, path = mini
    # read missing -> null
    r = _run(cli_py, port, "read", "/jepsen", cwd=path)
    assert r.returncode == 0 and json.loads(r.stdout) is None
    # plain write then read
    assert _run(cli_py, port, "write", "/jepsen", "3",
                cwd=path).returncode == 0
    r = _run(cli_py, port, "read", "/jepsen", cwd=path)
    assert json.loads(r.stdout) == "3"
    # cas with matching condition wins
    assert _run(cli_py, port, "write", "/jepsen", "4",
                "--condition", "3", cwd=path).returncode == 0
    # cas with stale condition: exit 1, CONDITION_NOT_MET
    r = _run(cli_py, port, "write", "/jepsen", "9",
             "--condition", "3", cwd=path)
    assert r.returncode == 1
    assert "CONDITION_NOT_MET" in r.stdout
    r = _run(cli_py, port, "read", "/jepsen", cwd=path)
    assert json.loads(r.stdout) == "4"
    # dead server: exit 2
    r = _run(cli_py, 1, "read", "/jepsen", cwd=path)
    assert r.returncode == 2


def _options(tmp_path, **kw):
    return {"nodes": ["l1"], "concurrency": 4,
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


def test_full_suite_live(tmp_path):
    done = core.run(lc.logcabin_test(_options(tmp_path)))
    res = done["results"]
    assert res["valid?"] is True, res
    assert res["linear"]["valid?"] is True
    # the control-plane CLI transport genuinely carried ops (one
    # subprocess per op: the CLI-semantics test covers both cas outcomes)
    h = done["history"]
    assert any(op.f == "write" and op.is_ok for op in h)
    assert any(op.f == "cas" and (op.is_ok or op.is_fail) for op in h)


def test_source_commands():
    log: list = []
    db = lc.LogCabinDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
    joined = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "scons" in joined
    assert "logcabin.git" in joined
    assert "--bootstrap" in joined          # primary bootstraps
    # membership reconfiguration happens in the Primary hook, AFTER every
    # node's setup (daemons listening) — never during setup
    assert "/root/Reconfigure -c" not in joined
    log2: list = []
    with c.with_remote(DummyRemote(log2)):
        with c.on("n1"):
            db.setup_primary(test, "n1")
    prim = "\n".join(x[1] for x in log2 if isinstance(x[1], str))
    assert "/root/Reconfigure -c" in prim
    assert "n1:5254,n2:5254,n3:5254" in prim
    ups = [x[1] for x in log if isinstance(x[1], tuple)
           and x[1][0] == "upload"]
    assert any("logcabin.conf" in str(u[2]) for u in ups)
    # joiners: no bootstrap, no reconfigure
    log.clear()
    with c.with_remote(DummyRemote(log)):
        with c.on("n2"):
            db.setup(test, "n2")
    joiner = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "--bootstrap" not in joiner
    # the binary is still installed, but never RUN on a joiner
    assert "/root/Reconfigure -c" not in joiner


# -- parity with the reference ------------------------------------------------

def src_imports(src: str) -> set:
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    return mods


@pytest.mark.parametrize("name", ["MINITREE_SRC", "TREEOPS_SRC"])
def test_sources_are_the_references_and_import_neither_package(name):
    src = getattr(lc, name)
    assert src == getattr(ref_lc, name)
    mods = src_imports(src)
    assert "json" in mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


def test_constants_match_reference():
    for name in ("PORT", "TREE_PATH"):
        assert getattr(lc, name) == getattr(ref_lc, name), name
    for name in ("script", "pidfile", "logfile", "data_files"):
        assert getattr(lc.MiniTreeDB, name) == getattr(ref_lc.MiniTreeDB,
                                                        name), name


def source_steps(mod):
    db = mod.LogCabinDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    steps = [(n, (lambda n=n: db.setup(test, n))) for n in ("n1", "n2")]
    steps += [("n1", lambda: db.setup_primary(test, "n1")),
              ("n2", lambda: db.teardown(test, "n2"))]
    return steps, db.primaries(test), db.log_files(test, "n1")


def test_source_commands_match_reference():
    steps, prim, files = source_steps(lc)
    ref_steps, ref_prim, ref_files = source_steps(ref_lc)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert (prim, files) == (ref_prim, ref_files)


def test_mini_db_commands_match_reference():
    """The mini tree server's lifecycle and the CLI it uploads: the same
    commands on the same ports."""
    def steps(mod):
        db = mod.MiniTreeDB()
        test = {"nodes": ["l1", "l2"], "logcabin_ports": {"l1": 40000,
                                                          "l2": 40001}}
        return [("l2", (lambda f=f: getattr(db, f)(test, "l2")))
                for f in ("setup", "kill", "start", "pause", "resume",
                          "teardown")]
    assert dummy_log(c, DummyRemote, steps(lc)) == \
        dummy_log(ref_c, RefDummyRemote, steps(ref_lc))


def scripted(remote_cls, replies: list):
    """A dummy remote whose i-th command answers replies[i] (exit code,
    stdout)."""
    class Scripted(remote_cls):
        def execute(self, context, action):
            out = super().execute(context, action)
            code, text = replies[len(self.log) - 1]
            return {**out, "exit": code, "out": text}
    return Scripted


REPLIES = ((0, '"3"\n'), (0, "null\n"), (2, ""), (0, ""), (2, ""), (0, ""),
           (1, 'CONDITION_NOT_MET "2"\n'), (2, "connection error"))
OPS = (("read", None), ("read", None), ("read", None), ("write", 3),
       ("write", 4), ("cas", [3, 4]), ("cas", [1, 2]), ("cas", [2, 0]))


def client_session(ctl, remote_cls, mod) -> tuple:
    """The client's completions of OPS against scripted replies, and the
    commands it exec'd."""
    log: list = []
    cl = mod.TreeOpsClient(port_fn=lambda test, node: 40000).open({}, "l1")
    out = []
    with ctl.with_remote(scripted(remote_cls, list(REPLIES))(log)):
        for f, v in OPS:
            out.append(cl.invoke({}, {"type": "invoke", "f": f, "value": v,
                                      "process": 0}))
    return out, log


def test_client_commands_and_completions_match_reference():
    got = client_session(c, DummyRemote, lc)
    assert got == client_session(ref_c, RefDummyRemote, ref_lc)
    types = [o["type"] for o in got[0]]
    assert types == ["ok", "ok", "fail", "ok", "info", "ok", "fail", "info"]
    assert [o["value"] for o in got[0][:2]] == [3, None]
    assert all("python3 -S treeops.py --port 40000" in cmd
               for _, cmd in got[1])


def logcabin_ops(mod, g_mod, tl, n: int = 60) -> list:
    """The first `n` invocations of the suite's op mix (the generator
    seeded, every op completing ok at once): (process, f, value)."""
    g_mod.RNG.seed(26)
    return [(o["process"], o["f"], o.get("value"))
            for o in tl.simulate(
                g_mod.limit(n, g_mod.clients(
                    g_mod.mix([mod._r, mod._w, mod._cas]))),
                lambda ctx, inv: {**inv, "type": "ok"}, None, None)
            if o["type"] == "invoke"]


def test_generated_ops_match_reference():
    got = logcabin_ops(lc, gen, testlib)
    assert got == logcabin_ops(ref_lc, ref_gen, ref_testlib)
    assert {f for _, f, _ in got} == {"read", "write", "cas"}
    assert len(got) == 60


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert lc.MINI_BASE_PORT == 31600
    assert lc.MINI_BASE_PORT != ref_lc.MINI_BASE_PORT
    # below the ephemeral range, clear of the reference's bases
    # (21850-30680), with room for five nodes and the twin fixture
    lo, _ = ephemeral_range()
    assert 30680 < lc.MINI_BASE_PORT and lc.MINI_BASE_PORT + 50 <= lo
    assert lc.MINI_BASE_PORT + 5 <= FIXTURE_PORT < lc.MINI_BASE_PORT + 50
    test = {"nodes": ["l1", "l2"]}
    assert [lc.mini_node_port(test, n) for n in test["nodes"]] == \
        [lc.MINI_BASE_PORT, lc.MINI_BASE_PORT + 1]
    assert lc.mini_node_port({**test, "logcabin_ports": {"l2": 4000}},
                             "l2") == 4000
    t = lc.logcabin_test(_options(tmp_path))
    assert t["store_root"] == str(tmp_path / "store")
    assert t["db"].port(t, "l1") == lc.MINI_BASE_PORT
    assert t["client"].port_fn(t, "l1") == lc.MINI_BASE_PORT
    t = lc.logcabin_test({"nodes": ["l1"], "concurrency": 2,
                          "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")


def test_device_reaches_the_checker(tmp_path):
    for server in ("mini", "source"):
        t = lc.logcabin_test({**_options(tmp_path), "server": server})
        lin = t["checker"].checker_map["linear"]
        assert lin.device == torch.device("cpu")
        assert lin.algorithm == "competition"
        assert lin.model == cas_register(None)


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "source"):
        with pytest.raises(RuntimeError, match="CUDA"):
            lc.logcabin_test({**_options(tmp_path), "server": server,
                              "device": None})
    assert not (tmp_path / "cluster").exists()
