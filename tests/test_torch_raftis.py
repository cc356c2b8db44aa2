"""The port's raftis suite (`jepsen_tpu_torch/dbs/raftis.py`), on the port's
redis, held against the JAX package: the twins of `tests/test_raftis.py`
(the definite / indefinite error taxonomy, the initial-cluster string, the
register suite live under the kill/restart nemesis, the floyd tarball
recipe through the dummy remote), and parity cases: the taxonomy on the
reference test's errors and on refused and reset connections, the tarball
recipe's and the mini server's commands, the generated ops, and one live
register history judged by both packages' `wgl` oracles.

Also: the port's ports and store root are its own, the `device` option
reaches the `linear` check, and a missing card raises before any node is
set up. The suite checks on the CPU (`device="cpu"`).
"""

import builtins
import os

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import checker as ref_checker
from jepsen_tpu import generator as ref_gen
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import raftis as ref_ra
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu_torch import checker, core, store
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import raftis as ra
from jepsen_tpu_torch.dbs import redis
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import cas_register
from test_torch_galera import dummy_log, ref_history
from test_torch_sqlite import ephemeral_range


class Boom:
    """A connection whose every command raises `exc`."""

    def __init__(self, exc):
        self.exc = exc

    def cmd(self, *a):
        raise self.exc

    def close(self):
        pass


def test_error_taxonomy():
    client = ra.RaftisClient()
    for msg, expect in [
        ("ERR write InComplete: no leader node!", "fail"),
        ("socket closed", "fail"),
        ("ERR some transient storm", "info"),
    ]:
        client.conn = Boom(ra.RedisError(msg))
        out = client.invoke({}, {"f": "write", "value": 1})
        assert out["type"] == expect, (msg, out)
    # reads always definite
    client.conn = Boom(ra.RedisError("ERR some transient storm"))
    out = client.invoke({}, {"f": "read", "value": None})
    assert out["type"] == "fail"


def test_initial_cluster():
    assert ra.initial_cluster({"nodes": ["a", "b"]}) == "a:8901,b:8901"


def _options(tmp_path, **kw):
    return {"nodes": ["r1"], "concurrency": 4,
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


def test_full_suite_live(tmp_path):
    done = core.run(ra.raftis_test(_options(tmp_path)))
    res = done["results"]
    assert res["valid?"] is True, res
    assert res["linear"]["valid?"] is True
    # the register actually moved
    assert any(op.f == "write" and op.is_ok for op in done["history"])


def test_tarball_commands():
    log: list = []
    db = ra.RaftisDB()
    test = {"nodes": ["n1", "n2"], "force_reinstall": True}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
    joined = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "/opt/raftis" in joined
    assert "PikaLabs/floyd" in ra.tarball_url(ra.VERSION)
    # positional daemon args: cluster, node, raft port, data, client
    assert "n1:8901,n2:8901 n1 8901 data 6379" in joined


# -- parity with the reference ------------------------------------------------

ERRORS = (
    ("RedisError", "ERR write InComplete: no leader node!"),
    ("RedisError", "socket closed"),
    ("RedisError", "ERR some transient storm"),
    ("ConnectionRefusedError", "[Errno 111] Connection refused"),
    ("ConnectionResetError", "[Errno 104] Connection reset by peer"),
    ("BrokenPipeError", "[Errno 32] Broken pipe"),
    ("TimeoutError", "timed out"),
)


def taxonomy(mod, kind: str, msg: str) -> list:
    """Each op's completion when the connection raises `kind(msg)` (the
    module's `RedisError`, or a builtin), and whether the client dropped
    the connection."""
    exc = getattr(mod if kind == "RedisError" else builtins, kind)
    out = []
    for f, v in (("write", 3), ("read", None)):
        cl = mod.RaftisClient().open({}, "r1")
        cl.conn = Boom(exc(msg))
        out.append((cl.invoke({}, {"type": "invoke", "f": f, "value": v,
                                   "process": 0}), cl.conn is None))
    return out


@pytest.mark.parametrize("kind,msg", ERRORS, ids=[e[0] + ":" + e[1][:12]
                                                  for e in ERRORS])
def test_error_taxonomy_matches_reference(kind, msg):
    got = taxonomy(ra, kind, msg)
    assert got == taxonomy(ref_ra, kind, msg)
    assert got[1][0]["type"] == "fail"      # reads always definite


def test_constants_match_reference():
    for name in ("VERSION", "DIR", "RAFT_PORT", "CLIENT_PORT",
                 "DEFINITE_WRITE_ERRORS"):
        assert getattr(ra, name) == getattr(ref_ra, name), name
    assert ra.tarball_url("v1.2") == ref_ra.tarball_url("v1.2")
    for n in range(1, 6):
        test = {"nodes": [f"n{i}" for i in range(n)]}
        assert ra.initial_cluster(test) == ref_ra.initial_cluster(test)


def raftis_db_steps(mod):
    db = mod.RaftisDB()
    test = {"nodes": ["n1", "n2", "n3"], "force_reinstall": True}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in ("n1", "n3") for f in ("setup", "teardown")], \
        db.log_files(test, "n1")


def test_tarball_commands_match_reference():
    steps, files = raftis_db_steps(ra)
    ref_steps, ref_files = raftis_db_steps(ref_ra)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert files == ref_files


def test_mini_db_commands_match_reference():
    """The mini server's lifecycle: the reference's mini-redis commands,
    on raftis's own ports (the reference's read redis's)."""
    def steps(db, test):
        return [("r2", (lambda f=f: getattr(db, f)(test, "r2")))
                for f in ("setup", "kill", "start", "pause", "resume",
                          "teardown")]
    base = 40000
    test = {"nodes": ["r1", "r2"], "raftis_ports": {"r1": base,
                                                    "r2": base + 1}}
    ref_test = {"nodes": ["r1", "r2"], "redis_ports": {"r1": base,
                                                       "r2": base + 1}}
    db = ra.MiniRaftisDB()
    assert dummy_log(c, DummyRemote, steps(db, test)) == \
        dummy_log(ref_c, RefDummyRemote,
                  steps(ref_ra.MiniRedisDB(), ref_test))
    assert db.log_files(test, "r2") == \
        ref_ra.MiniRedisDB().log_files(ref_test, "r2")


def raftis_ops(mod, g_mod, tl, n: int = 60) -> list:
    """The first `n` invocations of the suite's op mix (the generator
    seeded, every op completing ok at once): (process, f, value)."""
    g_mod.RNG.seed(26)
    return [(o["process"], o["f"], o.get("value"))
            for o in tl.simulate(
                g_mod.limit(n, g_mod.clients(g_mod.mix([mod._r, mod._w]))),
                lambda ctx, inv: {**inv, "type": "ok"}, None, None)
            if o["type"] == "invoke"]


def test_generated_ops_match_reference():
    got = raftis_ops(ra, gen, testlib)
    assert got == raftis_ops(ref_ra, ref_gen, ref_testlib)
    assert {f for _, f, _ in got} == {"read", "write"}
    assert len(got) == 60


@pytest.fixture(scope="module")
def register_run(tmp_path_factory):
    """A live register run (the reference test's one mini node and 4
    workers, for 3 s with the kill/restart every 1 s so that a restart
    falls inside the run), its generator seeded, judged by the port's host
    `wgl` oracle (the suite's competition race with `device="cpu"` is
    `test_full_suite_live`'s)."""
    gen.RNG.seed(26)
    test = ra.raftis_test(_options(tmp_path_factory.mktemp("raftis"),
                                   time_limit=3, nemesis_interval=1.0))
    test["checker"] = checker.compose({"linear": checker.linearizable(
        cas_register(None), algorithm="wgl", device="cpu")})
    return test, core.run(test)


def test_live_register_history_matches_reference(register_run):
    """The live register history, read back from the store, judged by the
    port's `wgl` oracle and by the reference's: equal verdicts, True,
    equal to the run's own; a kill landed in the run."""
    test, done = register_run
    stored = store.load_latest(test["store_root"])
    hist = History(stored["history"]).index()
    assert [o.to_dict() for o in hist] == \
        [o.to_dict() for o in done["history"]]
    port = checker.linearizable(cas_register(None), algorithm="wgl",
                                device="cpu").check({}, hist, {})
    ref = ref_checker.linearizable(ref_cas_register(None),
                                   algorithm="wgl").check(
        {}, ref_history(hist), {})
    assert port["valid?"] is ref["valid?"] is True
    assert done["results"]["linear"]["valid?"] is True
    assert any(o.process == "nemesis" and o.value == {"r1": "killed"}
               for o in hist)
    assert any(o.f == "write" and o.is_ok for o in hist)


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert ra.MINI_BASE_PORT == 31450
    # the reference's mini mode runs on redis's ports; the port's on its own
    # block, clear of the port's redis and the reference's bases
    # (21850-30680), below the ephemeral range
    assert ra.MINI_BASE_PORT != redis.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < ra.MINI_BASE_PORT and ra.MINI_BASE_PORT + 50 <= lo
    test = {"nodes": ["r1", "r2"]}
    assert [ra.mini_node_port(test, n) for n in test["nodes"]] == \
        [ra.MINI_BASE_PORT, ra.MINI_BASE_PORT + 1]
    assert ra.mini_node_port({**test, "raftis_ports": {"r2": 4000}},
                             "r2") == 4000
    t = ra.raftis_test(_options(tmp_path))
    assert t["store_root"] == str(tmp_path / "store")
    assert isinstance(t["db"], ra.MiniRaftisDB)
    assert t["db"].port(t, "r1") == ra.MINI_BASE_PORT
    # every worker drives the primary's server, on raftis's base
    assert t["client"].port_fn(t, "r1") == ("127.0.0.1", ra.MINI_BASE_PORT)
    t = ra.raftis_test({"nodes": ["r1"], "concurrency": 2, "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")


def test_device_reaches_the_checker(tmp_path):
    for server in ("mini", "tarball"):
        t = ra.raftis_test({**_options(tmp_path), "server": server})
        lin = t["checker"].checker_map["linear"]
        assert lin.device == torch.device("cpu")
        assert lin.algorithm == "competition"
        assert lin.model == cas_register(None)


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "tarball"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ra.raftis_test({**_options(tmp_path), "server": server,
                            "device": None})
    assert not (tmp_path / "cluster").exists()
