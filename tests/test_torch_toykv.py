"""The port's toykv suite (`jepsen_tpu_torch/dbs/toykv.py`) end to end
against live server processes over the localexec remote, held against
the JAX package's verdicts on the same scenarios (`tests/test_toykv.py`):
the set workload's durability under kill -9 (volatile: acknowledged adds
lost, False; durable: True), the test-all sweep, the sequential
workload's trailing-nil catch of a volatile node, the full register
suite and the CLI (both slow, as their reference twins). Each run gets
free ports through `toykv_ports` and checks on the CPU (`device="cpu"`).

Also: the uploaded server program imports no module of either package,
the port's ports and store root are its own, and a missing card raises
before any node is set up.
"""

import ast
import os
import socket

import pytest
import torch

from jepsen_tpu.dbs import toykv as ref_toykv
from jepsen_tpu_torch import checker as jchecker
from jepsen_tpu_torch import cli, control, core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control import localexec
from jepsen_tpu_torch.dbs import toykv
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.workloads.sequential import checker as seq_checker
from jepsen_tpu_torch.workloads.sequential import subkeys


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def options(tmp_path, **kw):
    return {
        "name": kw.pop("name", "toykv-it"),
        "nodes": kw.pop("nodes", ["a", "b"]),
        "concurrency": kw.pop("concurrency", 4),
        "store_root": str(tmp_path / "store"),
        "sandbox": str(tmp_path / "cluster"),
        "time_limit": kw.pop("time_limit", 6),
        "per_key_limit": 12,
        "nemesis_interval": kw.pop("nemesis_interval", 2.5),
        "device": "cpu",
        **kw,
    }


def with_ports(test: dict) -> dict:
    test["toykv_ports"] = dict(zip(test["nodes"],
                                   free_ports(len(test["nodes"]))))
    return test


def test_server_src_imports_neither_package():
    mods = set()
    for node in ast.walk(ast.parse(toykv.SERVER_SRC)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods and not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax",
                                "torch"}
    assert toykv.SERVER_SRC == ref_toykv.SERVER_SRC


def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert toykv.BASE_PORT != ref_toykv.BASE_PORT
    test = {"nodes": ["a", "b", "c"]}
    assert [toykv.node_port(test, n) for n in test["nodes"]] == \
        [toykv.BASE_PORT + i for i in range(3)]
    assert toykv.node_port({**test, "toykv_ports": {"b": 4000}}, "b") == 4000
    # sharding as the reference's, within one process (hash(str(k)))
    for k in range(50):
        assert toykv.node_for_key(test, k) == ref_toykv.node_for_key(test, k)
    t = toykv.toykv_test({"nodes": ["a"], "concurrency": 2,
                          "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        toykv.toykv_test({**options(tmp_path), "device": None})
    assert not (tmp_path / "cluster").exists()


@pytest.mark.parametrize("volatile,expect", [(True, False),
                                             (False, True)])
def test_set_durability_under_kill(tmp_path, volatile, expect):
    """Add elements, kill -9 the server, restart, read back: the
    volatile server forgets acknowledged adds (invalid, lost-count > 0),
    the durable one replays its fsync'd log (valid)."""
    opts = options(tmp_path, name=f"toykv-dur-{volatile}", nodes=["a"],
                   concurrency=2)
    db = toykv.ToyKVDB(volatile=volatile)
    test = with_ports(toykv.toykv_test(opts))
    test["db"] = db
    test["client"] = toykv.ToyKVSetClient()
    test["nemesis"] = toykv.kill_restart_nemesis(db)
    test["checker"] = jchecker.set_checker()
    counter = iter(range(1000))
    test["generator"] = gen.phases(
        gen.clients([gen.limit(10, lambda t, c: {
            "f": "add", "value": next(counter)})]),
        gen.nemesis([
            gen.once({"type": "info", "f": "start", "value": ["a"]}),
            gen.once({"type": "info", "f": "stop", "value": ["a"]})]),
        gen.clients([gen.limit(3, lambda t, c: {
            "f": "read", "value": None})]),
    )
    t = core.run(test)
    assert t["results"]["valid?"] is expect
    if volatile:
        assert t["results"]["lost-count"] > 0


def test_tests_fn_sweep(tmp_path):
    """toykv_tests yields the durability x cadence sweep for test-all,
    named as the reference's, without running anything."""
    opts = options(tmp_path, name="sweep")
    tests = list(toykv.toykv_tests(opts))
    assert len(tests) == 4
    names = [t["name"] for t in tests]
    assert names == ["sweep-nem2.5", "sweep-nem1.25",
                     "sweep-volatile-nem2.5", "sweep-volatile-nem1.25"]
    assert names == [t["name"] for t in ref_toykv.toykv_tests(
        {k: v for k, v in opts.items() if k != "device"})]
    assert [t["db"].volatile for t in tests] == [False, False, True, True]


def test_sequential_catches_volatile_loss(tmp_path):
    """Write a key whose first subkey lives on a different (volatile)
    node than its last; kill -9 and restart that node; the reversed read
    then sees the later subkey without the earlier one: trailing nil."""
    nodes = ["a", "b"]
    test = {"nodes": nodes, "key_count": 3,
            "store_root": str(tmp_path / "store"), "sessions": None,
            "toykv_ports": dict(zip(nodes, free_ports(2)))}
    db = toykv.ToyKVDB(volatile=True)
    remote = localexec.remote(str(tmp_path / "cluster"))
    sessions = {n: remote.connect({"host": n}) for n in nodes}
    test["sessions"] = sessions
    key = next(k for k in range(50)
               if toykv.node_for_key(test, subkeys(3, k)[0])
               != toykv.node_for_key(test, subkeys(3, k)[2]))
    first_node = toykv.node_for_key(test, subkeys(3, key)[0])
    try:
        for n in nodes:
            with control.with_session(n, sessions[n]):
                db.setup(test, n)
        cl = toykv.ToyKVSeqClient().open(test, nodes[0])
        w = cl.invoke(test, {"f": "write", "value": key, "process": 0})
        assert w["type"] == "ok"
        with control.with_session(first_node, sessions[first_node]):
            db.kill(test, first_node)
            db.start(test, first_node)
        r = cl.invoke(test, {"f": "read", "value": [key, []],
                             "process": 0})
        if r["type"] != "ok":
            # the first read may die on the stale socket to the restarted
            # node; the retry opens a fresh connection
            r = cl.invoke(test, {"f": "read", "value": [key, []],
                                 "process": 0})
        assert r["type"] == "ok"
        ops = [{"index": 0, "type": "invoke", "f": "write",
                "value": key, "process": 0, "time": 0},
               {"index": 1, "type": "ok", "f": "write", "value": key,
                "process": 0, "time": 1},
               {"index": 2, "type": "invoke", "f": "read",
                "value": [key, []], "process": 0, "time": 2},
               {"index": 3, **{k2: v for k2, v in r.items()
                               if k2 != "index"}, "time": 3}]
        res = seq_checker().check(test, History(ops).index(), {})
        assert res["valid?"] is False, res
        assert res["bad-count"] >= 1
    finally:
        for n in nodes:
            with control.with_session(n, sessions[n]):
                try:
                    db.teardown(test, n)
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass


def test_sequential_workload_live(tmp_path):
    """Ordered subkey inserts sharded across nodes stay sequentially
    consistent on a durable cluster under the kill/restart nemesis."""
    opts = options(tmp_path, name="toykv-seq", workload="sequential",
                   time_limit=5, nemesis_interval=2.0)
    t = core.run(with_ports(toykv.toykv_test(opts)))
    assert t["results"]["valid?"] is True
    seq = t["results"]["sequential"]
    assert seq["bad-count"] == 0
    assert seq["all-count"] + seq["some-count"] + seq["none-count"] > 0


@pytest.mark.slow  # the twin of tests/test_toykv.py::test_full_suite_valid
def test_full_suite_valid(tmp_path):
    """A durable cluster under a kill/restart nemesis stays linearizable;
    every node's log is snarfed and the nemesis really restarted."""
    t = core.run(with_ports(toykv.toykv_test(options(tmp_path))))
    assert t["results"]["valid?"] is True
    run_dir = t["store_dir"]
    logs = "".join(open(os.path.join(run_dir, n, "server.log")).read()
                   for n in ("a", "b"))
    assert logs.count("toykv serving on") >= 3


@pytest.mark.slow  # the twin of tests/test_toykv.py::test_cli_entry
def test_cli_entry(tmp_path):
    """The suite's CLI main end to end with exit-code semantics."""
    rc = cli.run_cli(toykv.COMMANDS, [
        "test", "--nodes", "a,b", "--concurrency", "4",
        "--time-limit", "5", "--nemesis-interval", "2", "--device", "cpu",
        "--store-root", str(tmp_path / "store"),
        "--sandbox", str(tmp_path / "cluster")])
    assert rc == 0
