"""The port's Elle checkers against the JAX package's, end to end.

The same synthetic histories (300 txns: valid, list-append with
`corrupt_p=0.25`, rw-register with `stale_p=0.2`) go through
`jepsen_tpu.elle.{append,wr}.check` and the port's twins with
`device="cpu"`, for every cycle backend: host, trim, packed, auto,
device, and the port's "cuda" against the reference's "tpu" (the dense
closure; engine names map "cuda" <-> "tpu"). Verdict, anomaly types,
the anomalies themselves, the violated models, the cycle engine and the
closure's occupancy (`iters_run`, `iter_reach`, `core_sizes`) must be
equal. The host modules the port copied (synth generators,
`History.pairs`, the route, the lint gate) are held against theirs.
"""

import random
import re

import numpy as np
import pytest
import torch

from jepsen_tpu import history as jh
from jepsen_tpu import synth as jsynth
from jepsen_tpu.analysis import history_lint as jlint
from jepsen_tpu.elle import append as jappend
from jepsen_tpu.elle import wr as jwr
from jepsen_tpu.ops import route as jroute
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch.analysis import history_lint as tlint
from jepsen_tpu_torch.elle import append as tappend
from jepsen_tpu_torch.elle import graph as tgraph
from jepsen_tpu_torch.elle import tpu as ttpu
from jepsen_tpu_torch.elle import wr as twr
from jepsen_tpu_torch.ops import route as troute

torch.set_num_threads(1)

BACKENDS = [("host", "host"), ("trim", "trim"), ("packed", "packed"),
            ("auto", "auto"), ("device", "device"), ("tpu", "cuda")]
HISTORIES = {
    "append-valid": ("append", dict(corrupt_p=0.0)),
    "append-corrupt": ("append", dict(corrupt_p=0.25)),
    "wr-valid": ("wr", dict(stale_p=0.0)),
    "wr-stale": ("wr", dict(stale_p=0.2)),
}
_HIST: dict = {}


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


def history(name):
    if name not in _HIST:
        kind, kw = HISTORIES[name]
        gen = (jsynth.list_append_history if kind == "append"
               else jsynth.wr_register_history)
        _HIST[name] = gen(300, seed=5, **kw)
    return _HIST[name]


def run_ref(name, jb):
    kind, _ = HISTORIES[name]
    h = history(name)
    if kind == "append":
        return jappend.check(h, cycle_backend=jb,
                             additional_graphs=("realtime",))
    return jwr.check(h, cycle_backend=jb, linearizable_keys=True,
                     additional_graphs=("realtime",))


def run_port(name, tb):
    kind, _ = HISTORIES[name]
    h = to_port(history(name))
    if kind == "append":
        return tappend.check(h, cycle_backend=tb, device="cpu",
                             additional_graphs=("realtime",))
    return twr.check(h, cycle_backend=tb, device="cpu",
                     linearizable_keys=True, additional_graphs=("realtime",))


def run(name, jb, tb):
    return run_ref(name, jb), run_port(name, tb)


_ADDR = re.compile(r"<object object at 0x[0-9a-f]+>")


def _anomalies(res):
    # the reference's cyclic-versions text prints its INIT sentinel
    # object, whose address differs per process
    return _ADDR.sub("<INIT>", repr(res["anomalies"]))


@pytest.mark.parametrize("backend", BACKENDS, ids=[b[1] for b in BACKENDS])
@pytest.mark.parametrize("name", list(HISTORIES))
def test_check_matches_jax(name, backend):
    jres, tres = run(name, *backend)
    for k in ("valid?", "anomaly-types", "not",
              "unchecked-anomaly-types"):
        assert jres.get(k) == tres.get(k), k
    assert _anomalies(jres) == _anomalies(tres)
    engine = jres.get("cycle-engine")
    assert tres.get("cycle-engine") == ("cuda" if engine == "tpu"
                                        else engine)
    ju, tu = jres.get("cycle-util") or {}, tres.get("cycle-util") or {}
    for k in ("kernel", "n_pad", "iters", "iters_run", "iter_reach",
              "converged_at", "core_sizes", "reach_density"):
        assert ju.get(k) == tu.get(k), k
    expect = {"append-valid": True, "wr-valid": True}.get(name, False)
    assert tres["valid?"] is expect


@pytest.mark.parametrize("gen,kw", [
    ("list_append_history", dict(corrupt_p=0.25)),
    ("list_append_history", dict(crash_p=0.2, n_procs=3)),
    ("wr_register_history", dict(stale_p=0.2)),
    ("wr_register_history", dict(key_count=2, max_txn_length=6)),
])
def test_synth_histories_match_jax(gen, kw):
    a = getattr(tsynth, gen)(300, seed=5, **kw)
    b = getattr(jsynth, gen)(300, seed=5, **kw)
    assert [o.to_dict() for o in a] == [o.to_dict() for o in b]


def test_pairs_match_jax():
    h = jsynth.list_append_history(200, seed=3, crash_p=0.1)
    ops = [o.to_dict() for o in h]
    # a completion with no pending invocation pairs with None
    ops.append({"type": "info", "f": "txn", "process": 99, "value": None,
                "index": len(ops), "time": 10**6})
    jp = jh.History(ops).pairs()
    tp = th.History(ops).pairs()
    assert [(a.to_dict(), b and b.to_dict()) for a, b in jp] == \
        [(a.to_dict(), b and b.to_dict()) for a, b in tp]


def test_elle_gate_rules_match_jax():
    assert tlint.ELLE_GATE_RULES == jlint.ELLE_GATE_RULES
    ops = [o.to_dict() for o in jsynth.list_append_history(40, seed=1)]
    ops[5]["time"] = -7                       # H004
    ops[9]["index"] = ops[8]["index"]         # H005
    ops[12]["time"] = 0                       # H003
    jres = jappend.check(jh.History(ops), cycle_backend="host")
    tres = tappend.check(th.History(ops), cycle_backend="host")
    assert tres["valid?"] == jres["valid?"] == "unknown"
    assert tres["anomalies"] == jres["anomalies"]


def test_route_matches_jax():
    rng = random.Random(0)
    for _ in range(200):
        kw = dict(n=rng.choice([10, 300, 383, 384, 5000, 16385, 40000]),
                  e=rng.randrange(0, 60000), rw_edges=rng.randrange(0, 6000),
                  accel=rng.random() < 0.5, device_ok=rng.random() < 0.9,
                  n_shards=rng.choice([0, 2]))
        assert troute.elle_cycle_route(**kw)[0] == \
            jroute.elle_cycle_route(**kw)[0], kw


def test_random_graphs_every_engine_agrees_with_host():
    rng = np.random.default_rng(11)
    for n, e in ((3, 8), (40, 100), (90, 120), (150, 500)):
        g = tgraph.DepGraph()
        for i in range(n):
            g.add_node(i)
        types = rng.choice([tgraph.WW, tgraph.WR, tgraph.RW,
                            tgraph.REALTIME, tgraph.PROCESS], e)
        for s, d, t in zip(rng.integers(0, n, e), rng.integers(0, n, e),
                           types):
            g.add_edge(int(s), int(d), int(t))
        host = ttpu.standard_cycle_search(g, backend="host")
        for b in ("cuda", "packed", "trim"):
            res = ttpu.standard_cycle_search(g, backend=b, device="cpu")
            for q in ("G0", "G1c", "G-single", "G2"):
                assert (res[q] is None) == (host[q] is None), (n, b, q)


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = to_port(history("append-valid"))
    with pytest.raises(RuntimeError):
        tappend.check(h, additional_graphs=("realtime",))
    # the host oracle needs no device
    assert tappend.check(h, cycle_backend="host")["valid?"] is True


def test_sharded_backend_is_not_ported():
    """The sharded backend is ported now (tests/test_torch_elle_sharded.py):
    on one device it yields fewer than 2 word shards and falls back to
    the packed closure, as the reference's does; "tpu" stays unknown."""
    g = tgraph.DepGraph()
    g.add_edge(0, 1, tgraph.WW)
    res = ttpu.standard_cycle_search(g, backend="sharded", device="cpu")
    assert res["engine"] == "device" and res["util"]["kernel"] == "packed"
    assert not any(res[q] for q in ("G0", "G1c", "G-single", "G2"))
    with pytest.raises(ValueError, match="unknown backend"):
        ttpu.standard_cycle_search(g, backend="tpu", device="cpu")


def _forced_packed_over_capacity(name, monkeypatch):
    """A forced "packed" closure past a capacity cut to 100 txns, in both
    packages, with one word shard (the port's one-device list; the
    reference's `JEPSEN_TPU_ELLE_SHARDS` pin, set for the reference's call
    alone: the port does not read it), so the sharded remedy cannot hold
    it either: the preflight gate answers before the graph build."""
    from jepsen_tpu.elle import tpu as jtpu
    monkeypatch.setattr(ttpu, "PACKED_MAX_N", 100)
    monkeypatch.setattr(jtpu, "PACKED_MAX_N", 100)
    with monkeypatch.context() as m:
        m.setenv("JEPSEN_TPU_ELLE_SHARDS", "1")
        want = run_ref(name, "packed")
    got = run_port(name, "packed")
    for res in (want, got):
        assert res["valid?"] == "unknown"
        assert res["anomaly-types"] == ["preflight"]
        assert res["preflight"]["verdict"] == "infeasible"
        assert [r["rule"] for r in res["preflight"]["rules"]] == ["P002"]
    assert got["preflight"]["kernel"] == want["preflight"]["kernel"]
    assert "cycle-engine" not in got


def test_forced_packed_over_capacity_answers_preflight(monkeypatch):
    _forced_packed_over_capacity("append-corrupt", monkeypatch)


def test_forced_packed_over_capacity_answers_preflight_wr(monkeypatch):
    _forced_packed_over_capacity("wr-stale", monkeypatch)


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "packed", "trim", "device"])
@pytest.mark.parametrize("name", list(HISTORIES))
def test_check_on_card_matches_host(cuda_device, name, backend):
    kind, _ = HISTORIES[name]
    h = to_port(history(name))
    check, kw = ((tappend.check, {}) if kind == "append"
                 else (twr.check, {"linearizable_keys": True}))
    host = check(h, additional_graphs=("realtime",), cycle_backend="host",
                 **kw)
    res = check(h, additional_graphs=("realtime",), cycle_backend=backend,
                **kw)
    assert res["valid?"] == host["valid?"]
    assert res["anomaly-types"] == host["anomaly-types"]
    assert res["cycle-engine"] == backend
    # the card's occupancy equals the plain versions' on the CPU ("device"
    # picks the dense bf16 closure on the card, the trim on the CPU)
    ref = check(h, additional_graphs=("realtime",),
                cycle_backend="cuda" if backend == "device" else backend,
                device="cpu", **kw)
    for k in ("iters_run", "iter_reach", "core_sizes"):
        assert res["cycle-util"].get(k) == ref["cycle-util"].get(k), k
