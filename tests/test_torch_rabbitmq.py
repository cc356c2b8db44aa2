"""The port's rabbitmq suite (`jepsen_tpu_torch/dbs/rabbitmq.py`), held
against the JAX package: the twins of `tests/test_rabbitmq.py` (the AMQP
0-9-1 subset against the live mini broker: handshake, confirms after
fsync, get/ack, unacked requeue, reject; AOF crash recovery; the volatile
loss counterexample; both workloads against live brokers; the real
broker's command recipe), and parity cases: the embedded broker and the
shared codec equal to the reference's, the DB's commands, the generated
ops, and the mutex check's verdicts on the same semaphore histories
(valid, and with a double acquire) equal to the reference's.

Also: the port's ports and store root are its own, the `device` option
reaches the semaphore's mutex check, and a missing card raises before
any node is set up. The suites check on the CPU (`device="cpu"`).
"""

import ast
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import generator as ref_gen
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import rabbitmq as ref_rmq
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import checker as jchecker
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import rabbitmq as rmq
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, invoke, ok
from test_torch_sqlite import ephemeral_range

FIXTURE_PORT = 31090
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def mini(tmp_path):
    srv_py = tmp_path / "minirabbit.py"
    srv_py.write_text(rmq.MINIRABBIT_SRC)
    port = FIXTURE_PORT
    state = {"proc": None}

    def start(*extra):
        state["proc"] = subprocess.Popen(
            [sys.executable, str(srv_py), "--port", str(port),
             "--dir", str(tmp_path), *extra],
            cwd=tmp_path)
        deadline = time.monotonic() + 10
        while True:
            try:
                return rmq.RabbitConn("127.0.0.1", port, timeout=2)
            except OSError:
                assert time.monotonic() < deadline, "broker never up"
                time.sleep(0.1)

    yield start, state, port
    if state["proc"] is not None:
        state["proc"].kill()
        state["proc"].wait(timeout=10)


# -- the twins of tests/test_rabbitmq.py --------------------------------------

def test_publish_confirm_get_ack(mini):
    start, state, _ = mini
    conn = start()
    conn.queue_declare("q")
    conn.confirm_select()
    assert conn.publish("q", b"7") is True  # confirmed post-fsync
    tag, body = conn.get("q")
    assert body == b"7"
    conn.ack(tag)
    assert conn.get("q") is None
    conn.close()


def test_unacked_delivery_requeues_on_close(mini):
    start, state, port = mini
    c1 = start()
    c1.queue_declare("q")
    c1.confirm_select()
    c1.publish("q", b"42")
    tag, body = c1.get("q")  # held, never acked
    assert body == b"42"
    c2 = rmq.RabbitConn("127.0.0.1", port, timeout=2)
    c2.queue_declare("q")
    assert c2.get("q") is None  # invisible while held
    c1.close()                  # dropping the holder requeues
    time.sleep(0.2)
    tag2, body2 = c2.get("q")
    assert body2 == b"42"
    c2.close()


def test_reject_requeue_is_release(mini):
    start, _, port = mini
    conn = start()
    conn.queue_declare("q")
    conn.confirm_select()
    conn.publish("q", b"sem")
    tag, _ = conn.get("q")
    assert conn.get("q") is None     # held
    conn.reject(tag, requeue=True)   # release
    time.sleep(0.1)
    tag2, body = conn.get("q")
    assert body == b"sem"
    conn.close()


def test_aof_survives_kill(mini):
    start, state, port = mini
    conn = start()
    conn.queue_declare("q")
    conn.confirm_select()
    conn.publish("q", b"1")
    conn.publish("q", b"2")
    tag, body = conn.get("q")
    conn.ack(tag)  # ack exactly one
    conn.close()
    time.sleep(0.1)
    state["proc"].send_signal(signal.SIGKILL)
    state["proc"].wait(timeout=10)
    conn = start()
    conn.queue_declare("q")
    got = []
    while True:
        item = conn.get("q")
        if item is None:
            break
        got.append(item[1])
        conn.ack(item[0])
    conn.close()
    # exactly the un-acked message survives the crash
    assert got == ([b"2"] if body == b"1" else [b"1"])


def test_volatile_confirms_then_loses(mini):
    """--volatile: confirms come back but nothing persists — kill -9
    loses acknowledged messages, the loss the checker must catch."""
    start, state, _ = mini
    conn = start("--volatile")
    conn.queue_declare("q")
    conn.confirm_select()
    hist = []
    for i in range(5):
        hist.append(invoke(0, "enqueue", i))
        assert conn.publish("q", str(i).encode()) is True
        hist.append(ok(0, "enqueue", i))
    conn.close()
    state["proc"].send_signal(signal.SIGKILL)
    state["proc"].wait(timeout=10)
    conn = start("--volatile")
    conn.queue_declare("q")
    assert conn.get("q") is None  # everything forgotten
    conn.close()
    hist.append(invoke(1, "drain", None))
    hist.append(ok(1, "drain", []))
    res = jchecker.total_queue().check({}, History(hist).index(), {})
    assert res["valid?"] is False and res["lost-count"] == 5


def _options(tmp_path, **kw):
    return {"nodes": kw.pop("nodes", ["r1", "r2"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 6),
            "nemesis_interval": kw.pop("nemesis_interval", 2.0),
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


def test_full_queue_suite_live_mini(tmp_path):
    """enqueue-with-confirms under kill -9, recover, drain: total-queue
    accounts every acknowledged element, against live brokers."""
    done = core.run(rmq.rabbitmq_test(_options(tmp_path)))
    q = done["results"]["queue"]
    assert done["results"]["valid?"] is True, q
    assert q["attempt-count"] > 0
    assert q["lost-count"] == 0 and q["unexpected-count"] == 0


def test_full_semaphore_suite_live_mini(tmp_path):
    """The unacked-delivery mutex, checked linearizable against the
    mutex model over live brokers. One node: a single semaphore."""
    done = core.run(rmq.rabbitmq_test(_options(
        tmp_path, nodes=["r1"], workload="semaphore", concurrency=3,
        time_limit=5)))
    m = done["results"]["mutex"]
    assert done["results"]["valid?"] is True, m
    assert m["valid?"] is True


def db_commands(ctl, remote_cls, mod) -> tuple:
    log: list = []
    db = mod.RabbitDB()
    test = {"nodes": ["n1", "n2"]}
    with ctl.with_remote(remote_cls(log)):
        for node in test["nodes"]:
            with ctl.on(node):
                db.setup(test, node)
                db.kill(test, node)
                db.start(test, node)
                db.teardown(test, node)
    return log, db.log_files(test, "n2")


def test_db_setup_commands():
    """Real-rabbit automation emits the reference's command recipe
    (cookie, join_cluster from the primary, ha policy)."""
    log: list = []
    db = rmq.RabbitDB()
    test = {"nodes": ["n1", "n2"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n2"):
            db.setup(test, "n2")
            db.teardown(test, "n2")
    joined = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "erlang.cookie" in joined
    assert "join_cluster" in joined and "rabbit@n1" in joined
    assert "set_policy" in joined and "ha-maj" in joined
    assert "mnesia" in joined


# -- parity with the reference ------------------------------------------------

def imports_of(src: str) -> set:
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    return mods


@pytest.mark.parametrize("name", ("MINIRABBIT_SRC", "AMQP_COMMON_SRC"))
def test_broker_and_codec_src_are_the_references(name):
    src = getattr(rmq, name)
    assert src == getattr(ref_rmq, name)
    assert not imports_of(src) & {"jepsen_tpu", "jepsen_tpu_torch", "jax",
                                  "torch"}


@pytest.mark.parametrize("args", (
    ("enc_shortstr", "jepsen.queue"), ("enc_longstr", b"\x00body"),
    ("enc_longstr", "text"), ("enc_method", 60, 40, b"\x01\x02")))
def test_codec_bytes_match_reference(args):
    name, *a = args
    assert getattr(rmq, name)(*a) == getattr(ref_rmq, name)(*a)


def test_db_commands_match_reference():
    log, files = db_commands(c, DummyRemote, rmq)
    ref_log, ref_files = db_commands(ref_c, RefDummyRemote, ref_rmq)
    assert log == ref_log and files == ref_files


@pytest.mark.parametrize("which", ("queue_gen", "semaphore_gen"))
def test_generated_ops_match_reference(which):
    def ops(mod, g_mod, tl):
        g_mod.RNG.seed(3)
        return [(o["f"], o["value"]) for o in
                tl.quick(g_mod.limit(40, g_mod.clients(
                    getattr(mod, which)())))]

    got = ops(rmq, gen, testlib)
    assert got == ops(ref_rmq, ref_gen, ref_testlib)
    assert len({f for f, _ in got}) == 2


def semaphore_history(double: bool) -> list:
    """Three processes taking the one token in turn, failed acquires
    while it is held, one crashed release; with `double`, process 2
    acquires while process 0 holds it."""
    seq = [(0, "acquire", "ok"), (1, "acquire", "fail"),
           (0, "release", "ok"), (1, "acquire", "ok"),
           (2, "acquire", "ok" if double else "fail"),
           (1, "release", "info"), (2, "acquire", "fail"),
           (0, "acquire", "fail")]
    ops = []
    for p, f, t in seq:
        ops.append({"type": "invoke", "process": p, "f": f, "value": None})
        ops.append({"type": t, "process": p, "f": f, "value": None})
    return ops


@pytest.mark.parametrize("double", (False, True), ids=("valid", "double"))
def test_mutex_verdicts_match_reference(tmp_path, double):
    opts = _options(tmp_path, nodes=["r1"], workload="semaphore",
                    concurrency=3)
    chk = rmq.rabbitmq_test(opts)["checker"].checker_map["mutex"]
    ref_chk = ref_rmq.rabbitmq_test(opts)["checker"].checker_map["mutex"]
    ops = semaphore_history(double)
    got = chk.check({}, History(ops).index(), {})
    want = ref_chk.check({}, RefHistory(ops).index(), {})
    assert got["valid?"] is (not double) and want["valid?"] is (not double)
    for how in ("cuda-wgl", "wgl"):
        one = jchecker.linearizable(chk.model, algorithm=how,
                                    device="cpu").check(
            {}, History(ops).index(), {})
        assert one["valid?"] is want["valid?"], how


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert rmq.MINI_BASE_PORT == 31050
    assert rmq.MINI_BASE_PORT != ref_rmq.MINI_BASE_PORT
    lo, _ = ephemeral_range()
    assert 30680 < rmq.MINI_BASE_PORT and rmq.MINI_BASE_PORT + 5 < lo
    assert rmq.MINI_BASE_PORT + 5 <= FIXTURE_PORT < lo
    test = {"nodes": ["r1", "r2"]}
    assert [rmq.mini_node_port(test, n) for n in test["nodes"]] == \
        [rmq.MINI_BASE_PORT, rmq.MINI_BASE_PORT + 1]
    t = rmq.rabbitmq_test({"nodes": ["r1", "r2"], "concurrency": 2})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["client"].port_fn(t, "r2") == ("127.0.0.1",
                                            rmq.MINI_BASE_PORT + 1)
    t = rmq.rabbitmq_test({"nodes": ["r1", "r2"], "concurrency": 2,
                           "workload": "semaphore", "device": "cpu"})
    # every semaphore client drives the broker that holds the token
    assert t["client"].port_fn(t, "r2") == ("127.0.0.1", rmq.MINI_BASE_PORT)


def test_device_reaches_the_checker(tmp_path):
    t = rmq.rabbitmq_test(_options(tmp_path, nodes=["r1"],
                                   workload="semaphore"))
    m = t["checker"].checker_map["mutex"]
    assert m.device == torch.device("cpu")
    assert m.algorithm == "competition" and m.time_limit == 60


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "deb"):
        with pytest.raises(RuntimeError, match="CUDA"):
            rmq.rabbitmq_test({**_options(tmp_path, nodes=["r1"],
                                          workload="semaphore"),
                               "server": server, "device": None})
    assert not (tmp_path / "cluster").exists()
    # the queue's total-queue check takes no device: no card is needed
    t = rmq.rabbitmq_test({**_options(tmp_path), "device": None})
    assert "mutex" not in t["checker"].checker_map


def test_cli_semaphore_run_on_the_cpu(tmp_path):
    """`python -m jepsen_tpu_torch.dbs.rabbitmq test --workload semaphore
    ... --device cpu` exits 0 with the suite valid; without `--device`
    and without a card it exits 255 before any node is set up."""
    args = [sys.executable, "-m", "jepsen_tpu_torch.dbs.rabbitmq", "test",
            "--nodes", "r1", "--workload", "semaphore", "--concurrency",
            "3", "--time-limit", "3", "--store-root",
            str(tmp_path / "store"), "--sandbox", str(tmp_path / "cluster")]
    env = {**os.environ, "PYTHONPATH": REPO}
    done = subprocess.run(args + ["--device", "cpu"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "'valid?': True" in done.stderr + done.stdout
    if not torch.cuda.is_available():
        sandbox = tmp_path / "cluster2"
        done = subprocess.run(args[:-2] + ["--sandbox", str(sandbox)],
                              cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=300)
        assert done.returncode == 255 and "CUDA" in done.stderr
        assert not sandbox.exists()
