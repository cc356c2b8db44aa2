"""The port's `core.run` lifecycle with the dummy remote and in-process
fakes: the cases of `tests/test_core.py` on `jepsen_tpu_torch.core`,
the history checked by `linearizable(cas_register(),
algorithm="cuda-wgl", device="cpu")` (the `test` command's checker).

Every completed run's history must get the same verdict from the JAX
package's host "wgl" oracle. Beside those: a run with crashing clients,
one with a nemesis generator, one with a `trace.TracedClient`; the
ambient defaults (`fleet`, `ledger`, `devices`, `watchdog`) and the root
logging handlers as they were after a run that raised; the `kind="run"`
ledger record with the reference's keys; the status mirror's last
snapshot; and the run dir read back by the reference's `store`.
"""

import json
import logging
import os

import pytest
import torch

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import core as ref_core
from jepsen_tpu import fakes as ref_fakes
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import history as ref_h
from jepsen_tpu import ledger as ref_ledger
from jepsen_tpu import store as ref_store
from jepsen_tpu import trace as ref_trace
from jepsen_tpu.models import core as ref_models
from jepsen_tpu_torch import checker, core, devices, fakes, fleet, ledger
from jepsen_tpu_torch import client as jclient
from jepsen_tpu_torch import db as jdb
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import models, net as jnet, os_setup, store, trace
from jepsen_tpu_torch import watchdog

# intra-op threads only contend with the other test workers
torch.set_num_threads(1)


class RecordingDB(jdb.DB, jdb.Primary, jdb.LogFiles):
    def __init__(self):
        self.events = []

    def setup(self, test, node):
        self.events.append(("setup", node))

    def teardown(self, test, node):
        self.events.append(("teardown", node))

    def setup_primary(self, test, node):
        self.events.append(("setup-primary", node))

    def primaries(self, test):
        return [test["nodes"][0]]

    def log_files(self, test, node):
        return []


class RecordingOS(os_setup.OS):
    def __init__(self):
        self.events = []

    def setup(self, test, node):
        self.events.append(("os-setup", node))

    def teardown(self, test, node):
        self.events.append(("os-teardown", node))


def cas_mix(g):
    return g.mix([
        g.repeat(lambda: {"f": "read"}),
        g.repeat(lambda: {"f": "write", "value": g.RNG.randrange(5)}),
        g.repeat(lambda: {"f": "cas", "value": [g.RNG.randrange(5),
                                                g.RNG.randrange(5)]})])


def base_test(tmp_path, **kw):
    return {
        "name": "cas-demo",
        "store_root": str(tmp_path / "store"),
        "nodes": ["n1", "n2", "n3"],
        "concurrency": 3,
        "ssh": {"dummy?": True},
        "os": RecordingOS(),
        "db": RecordingDB(),
        "net": jnet.noop(),
        "client": fakes.AtomClient(fakes.SharedRegister()),
        "nemesis": fakes.NoopNemesis(),
        "checker": checker.linearizable(models.cas_register(),
                                        algorithm="cuda-wgl", device="cpu"),
        "generator": gen.limit(30, gen.clients(cas_mix(gen))),
        **kw,
    }


def oracle_verdict(history):
    """The JAX package's host oracle on the port's history."""
    h = ref_h.History([op.to_dict() for op in history]).index()
    return ref_checker.linearizable(ref_models.cas_register(),
                                    algorithm="wgl").check({}, h, {})[
        "valid?"]


def assert_oracle_agrees(res):
    assert res["results"]["valid?"] == oracle_verdict(res["history"])


def test_full_run_valid(tmp_path):
    t = base_test(tmp_path)
    res = core.run(t)
    assert res["results"]["valid?"] is True
    assert res["results"]["algorithm"] == "cuda-wgl"
    assert len(res["history"]) == 60
    assert_oracle_agrees(res)
    db_events = t["db"].events
    assert ("setup", "n1") in db_events
    assert ("setup-primary", "n1") in db_events
    assert db_events.index(("teardown", "n1")) < db_events.index(
        ("setup", "n1"))
    assert ("os-setup", "n2") in t["os"].events
    assert ("os-teardown", "n3") in t["os"].events
    runs = os.listdir(os.path.join(t["store_root"], "cas-demo"))
    assert any(r != "latest" for r in runs)
    latest = store.latest(t["store_root"])
    for f in ("test.jepsen", "results.json", "jepsen.log", "history.jsonl"):
        assert os.path.exists(os.path.join(latest, f)), f


def test_run_detects_lying_client(tmp_path):
    class LyingClient(jclient.Client):
        def open(self, test, node):
            return self

        def invoke(self, test, op):
            if op["f"] == "read":
                return {**op, "type": "ok", "value": 99}
            return {**op, "type": "ok"}

    t = base_test(tmp_path, client=LyingClient(), name="liar")
    res = core.run(t)
    assert res["results"]["valid?"] is False
    assert_oracle_agrees(res)
    assert os.path.exists(os.path.join(store.latest(t["store_root"]),
                                       "linear.svg"))


def test_setup_failed_retries(tmp_path):
    class FlakyDB(RecordingDB):
        def __init__(self):
            super().__init__()
            self.failures = 2

        def setup(self, test, node):
            super().setup(test, node)
            if node == "n1" and self.failures > 0:
                self.failures -= 1
                raise jdb.SetupFailed("not yet")

    t = base_test(tmp_path, db=FlakyDB(), name="flaky")
    res = core.run(t)
    assert res["results"]["valid?"] is True
    assert_oracle_agrees(res)
    assert [e for e in t["db"].events if e == ("setup", "n1")] == \
        [("setup", "n1")] * jdb.CYCLE_TRIES


class DoomedDB(RecordingDB):
    def setup(self, test, node):
        raise jdb.SetupFailed("never")


def test_setup_failed_exhausts(tmp_path):
    t = base_test(tmp_path, db=DoomedDB(), name="doomed")
    with pytest.raises(jdb.SetupFailed):
        core.run(t)


def test_client_lifecycle_called(tmp_path):
    meta = []
    t = base_test(tmp_path, client=fakes.AtomClient(fakes.SharedRegister(),
                                                    meta),
                  name="lifecycle")
    res = core.run(t)
    assert_oracle_agrees(res)
    assert "open" in meta and "setup" in meta
    assert "teardown" in meta and "close" in meta


class ExplodingDB(RecordingDB):
    def setup(self, test, node):
        if node == "n2":
            raise RuntimeError("disk on fire")


def test_interesting_exception_propagates(tmp_path):
    """Exceptions from DB setup beat broken-barrier noise
    (core_test.clj:43-60 analog)."""
    t = base_test(tmp_path, db=ExplodingDB(), name="explode")
    with pytest.raises(RuntimeError, match="disk on fire"):
        core.run(t)


def test_crashing_clients(tmp_path):
    """A client that crashes now and then: its ops complete `info`, each
    crash retires the process, and the verdict is the oracle's."""
    class Crashy(fakes.AtomClient):
        def open(self, test, node):
            return Crashy(self.state, self.meta_log)

        def invoke(self, test, op):
            res = super().invoke(test, op)
            if op["f"] != "read" and gen.RNG.random() < 0.3:
                raise RuntimeError("connection reset")
            return res

    with gen.with_seed(11):
        res = core.run(base_test(tmp_path, name="crashy",
                                 client=Crashy(fakes.SharedRegister())))
    h = res["history"]
    infos = [op for op in h if op.type == "info"]
    assert infos and all("connection reset" in op.extra["exception"]
                         for op in infos)
    assert len({op.process for op in h}) > 3
    assert res["results"]["valid?"] is True
    assert_oracle_agrees(res)


class InfoNemesis(fakes.NoopNemesis):
    def invoke(self, test, op):
        return {**op, "type": "info", "value": "partitioned"}


def test_nemesis_generator(tmp_path):
    """Nemesis ops (process "nemesis") ride the history to the checker,
    which leaves them out of the search, as the oracle does; the live
    status records the nemesis window."""
    g = gen.clients(gen.limit(30, cas_mix(gen)),
                    gen.limit(4, gen.cycle([{"f": "start-partition"},
                                            {"f": "stop-partition"}])))
    t = base_test(tmp_path, name="nemesis", nemesis=InfoNemesis(),
                  generator=g)
    res = core.run(t)
    nem = [op for op in res["history"] if op.process == "nemesis"]
    assert len(nem) == 8
    assert res["results"]["valid?"] is True
    assert_oracle_agrees(res)
    snap = fleet.read_status_file(t["store_root"])
    assert snap["nemesis"]["f"] in ("start-partition", "stop-partition")


def _ambient():
    return (fleet.get_default(), ledger.get_default(), devices.get_default(),
            watchdog.get_default(), list(logging.getLogger().handlers))


@pytest.mark.parametrize("db", [DoomedDB, ExplodingDB])
def test_ambient_defaults_restored_after_a_raising_run(tmp_path, db):
    before = _ambient()
    with pytest.raises(Exception):
        core.run(base_test(tmp_path, db=db(), name="raises"))
    after = _ambient()
    assert after[:4] == before[:4]
    assert all(a is b for a, b in zip(after[:4], before[:4]))
    assert after[4] == before[4]   # no jepsen.log handler leaked
    assert store._log_handler is None
    snap = fleet.read_status_file(str(tmp_path / "store"))
    assert snap["active"] is False and snap["phase"] == "done"


def test_run_record_status_mirror_and_reference_store(tmp_path):
    """The `kind="run"` record has the reference's keys (a run of the
    JAX package's `core.run` over the same test shape, beside it), the
    status mirror's last snapshot counts the history's ops, and the
    reference's `store` reads the port's run dir."""
    t = base_test(tmp_path, name="record")
    res = core.run(t)
    ref_t = {**t, "store_root": str(tmp_path / "ref-store"),
             "os": None, "db": None, "net": None,
             "client": ref_fakes.AtomClient(ref_fakes.SharedRegister()),
             "nemesis": ref_fakes.NoopNemesis(),
             "checker": ref_checker.linearizable(ref_models.cas_register(),
                                                 algorithm="wgl"),
             "generator": ref_gen.limit(30, ref_gen.clients(
                 cas_mix(ref_gen)))}
    ref_res = ref_core.run(ref_t)
    got = ledger.Ledger(t["store_root"]).query(kind="run")
    want = ref_ledger.Ledger(ref_t["store_root"]).query(kind="run")
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    assert set(got[0]["artifacts"]) == set(want[0]["artifacts"])
    assert got[0]["verdict"] is True and got[0]["ops"] == 60
    assert got[0]["artifacts"]["dir"] == os.path.relpath(
        store.latest(t["store_root"]), t["store_root"])
    # the device search's admission gate banks a `kind="preflight"`
    # record too; the reference's host "wgl" has no gate
    kinds = [r["kind"] for r in ledger.Ledger(t["store_root"]).query()]
    assert [k for k in kinds if k != "preflight"] == \
        [r["kind"] for r in ref_ledger.Ledger(ref_t["store_root"]).query()]
    assert kinds == ["preflight", "checker", "run"]
    snap = fleet.read_status_file(t["store_root"])
    ref_snap = json.load(open(os.path.join(ref_t["store_root"],
                                           "current-status.json")))
    assert set(snap) - {"hbm"} == set(ref_snap) - {"hbm"}
    inv = sum(op.type == "invoke" for op in res["history"])
    assert snap["ops"] == {"invoked": inv,
                           "completed": len(res["history"]) - inv}
    assert snap["ops"] == ref_snap["ops"]
    assert snap["active"] is False and snap["valid?"] is True
    loaded = ref_store.load_latest(t["store_root"])
    assert loaded["name"] == "record"
    assert loaded["results"]["valid?"] is True
    # the history is saved before the analysis indexes it (save_1)
    assert [o.to_dict() for o in ref_h.History(loaded["history"]).index()] \
        == [o.to_dict() for o in ref_h.History(
            [op.to_dict() for op in res["history"]])]
    assert ref_res["results"]["valid?"] is True


def test_traced_client_exports_spans(tmp_path):
    """A test map's tracer and `trace.TracedClient`: every op carries its
    span, `trace.jsonl` and `trace.perfetto.json` land in the run dir,
    and the run record names them, with the reference's keys."""
    tracer = trace.Tracer(sampled=True)
    t = base_test(tmp_path, name="traced", tracer=tracer,
                  client=trace.TracedClient(
                      fakes.AtomClient(fakes.SharedRegister()), tracer))
    res = core.run(t)
    assert res["results"]["valid?"] is True
    assert_oracle_agrees(res)
    oks = [op for op in res["history"] if op.type != "invoke"]
    assert all(op.to_dict().get("span") for op in oks)
    run_dir = store.latest(t["store_root"])
    with open(os.path.join(run_dir, "trace.jsonl")) as fh:
        names = {json.loads(ln)["name"] for ln in fh}
    assert "check linearizable" in names
    assert any(n.startswith("invoke ") for n in names)
    with open(os.path.join(run_dir, "trace.perfetto.json")) as fh:
        assert json.load(fh)["traceEvents"]
    rec = ledger.Ledger(t["store_root"]).query(kind="run")[0]
    ref_tracer = ref_trace.Tracer(sampled=True)
    ref_t = {**t, "store_root": str(tmp_path / "ref-store"),
             "os": None, "db": None, "tracer": ref_tracer,
             "client": ref_trace.TracedClient(ref_fakes.AtomClient(
                 ref_fakes.SharedRegister()), ref_tracer),
             "nemesis": ref_fakes.NoopNemesis(),
             "checker": ref_checker.linearizable(ref_models.cas_register(),
                                                 algorithm="wgl"),
             "generator": ref_gen.limit(6, ref_gen.clients(
                 cas_mix(ref_gen)))}
    ref_core.run(ref_t)
    want = ref_ledger.Ledger(ref_t["store_root"]).query(kind="run")[0]
    assert set(rec["artifacts"]) == set(want["artifacts"]) == \
        {"dir", "trace", "perfetto"}


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_demo_run_on_card(tmp_path, cuda_device):
    """`core.run` of the demo map with `device=None` (the card) at ~500
    invocations: True, and `wgl32_chunk` launched."""
    from jepsen_tpu_torch.__main__ import demo_test
    from jepsen_tpu_torch.ops import wgl32

    t = demo_test({"name": "card", "store_root": str(tmp_path),
                   "nodes": ["n1", "n2", "n3", "n4", "n5"],
                   "concurrency": 10, "time_limit": 2, "rate": 250.0})
    before = wgl32.chunk.launches
    res = core.run(t)
    invokes = sum(op.type == "invoke" for op in res["history"])
    assert invokes > 250
    assert res["results"]["valid?"] is True
    assert res["results"]["platform"] == "cuda"
    assert wgl32.chunk.launches > before
    # the port's host oracle: the JAX package does not run on the card
    assert checker.linearizable(models.cas_register(), algorithm="wgl",
                                device="cpu").check(
        {}, res["history"], {})["valid?"] is True
