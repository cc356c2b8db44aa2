"""The port's cycle workload packages (`workloads/cycle_append.py`,
`cycle_wr.py`, `cycle.py`), held against the JAX package: the twins of
`tests/test_workload_cycle.py` (the Checker protocol, anomaly expansion,
the elle/ directory dumps, and an end-to-end run of generated txns
against an in-memory store), and seeded generated histories (valid ones
and ones with corrupted or stale reads) through both packages'
checkers, whose verdicts and anomaly types must be equal.

The port's checkers take its `device` option; these run them with
`device="cpu"` (their plain PyTorch versions), the JAX side on its CPU
pin from `tests/conftest.py`.
"""

import json
import os

import pytest

from jepsen_tpu import synth as ref_synth
from jepsen_tpu.elle.graph import DepGraph as RefDepGraph
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.workloads import cycle as ref_cycle
from jepsen_tpu.workloads import cycle_append as ref_cycle_append
from jepsen_tpu.workloads import cycle_wr as ref_cycle_wr
from jepsen_tpu_torch import synth
from jepsen_tpu_torch.elle.append import AppendGen
from jepsen_tpu_torch.elle.graph import WW, DepGraph
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.workloads import cycle, cycle_append, cycle_wr

CPU = "cpu"


def txn(typ, mops, process=0, time=0):
    return Op(type=typ, f="txn", process=process, value=mops, time=time)


def hist(*ops):
    h = History()
    for i, op in enumerate(ops):
        h.append(op.with_(index=i, time=op.time or i))
    return h


# -- the twins of tests/test_workload_cycle.py ---------------------------------

def test_generic_cycle_checker():
    def analyze(history):
        g = DepGraph()
        g.add_edge(0, 1, WW, None)
        g.add_edge(1, 0, WW, None)
        return g

    res = cycle.checker(analyze).check({}, History(), {})
    assert res["valid?"] is False
    assert res["cycles"][0]["cycle"][0] == res["cycles"][0]["cycle"][-1]

    def analyze_ok(history):
        return DepGraph()

    assert cycle.checker(analyze_ok).check({}, History(), {})["valid?"] \
        is True


def test_append_checker_valid():
    h = hist(
        txn("ok", [["append", "x", 1]]),
        txn("ok", [["r", "x", [1]]]),
    )
    res = cycle_append.checker(device=CPU).check({}, h, {})
    assert res["valid?"] is True


def test_append_checker_detects_and_dumps(tmp_path):
    h = hist(
        txn("fail", [["append", "x", 1]]),
        txn("ok", [["r", "x", [1]]]),
    )
    test = {"name": "t", "start_time": "20260729T000000",
            "store_root": str(tmp_path)}
    res = cycle_append.checker(device=CPU).check(test, h, {})
    assert res["valid?"] is False
    d = os.path.join(str(tmp_path), "t", "20260729T000000", "elle")
    files = os.listdir(d)
    assert "G1a.json" in files
    with open(os.path.join(d, "G1a.json")) as fh:
        cases = json.load(fh)
    assert cases[0]["key"] == "x"
    # the browsable text tree: one .txt per anomaly with a case block +
    # explanation
    assert "G1a.txt" in files
    with open(os.path.join(d, "G1a.txt")) as fh:
        txt = fh.read()
    assert "G1a — 1 case(s)" in txt
    assert "case 0" in txt


def test_anomaly_expansion():
    assert "G1a" in cycle_append._expand(("G1",))
    assert "G-single" in cycle_append._expand(("G2",))
    assert "internal" in cycle_append._expand(())


def test_wr_checker():
    h = hist(
        txn("ok", [["w", "x", 1], ["w", "y", 1]]),
        txn("ok", [["r", "x", None], ["r", "y", 1]]),
    )
    res = cycle_wr.checker(device=CPU).check({}, h, {})
    assert res["valid?"] is False
    assert "G-single" in res["anomaly-types"]


def test_workload_bundles():
    w = cycle_append.workload(seed=5)
    assert callable(w["generator"])
    assert hasattr(w["checker"], "check")
    w2 = cycle_wr.workload(seed=5, linearizable_keys=True)
    assert w2["checker"].linearizable_keys


def test_end_to_end_generated_history_is_valid():
    """Txns from the generator applied serially to a real in-memory
    list store must check out clean: the checker's false-positive
    guard."""
    g = AppendGen(key_count=3, max_writes_per_key=8, seed=11)
    state: dict = {}
    h = History()
    idx = 0
    for t in range(60):
        mops = g.txn()
        done = []
        for f, k, v in mops:
            if f == "append":
                state.setdefault(k, []).append(v)
                done.append([f, k, v])
            else:
                done.append([f, k, list(state.get(k, []))])
        h.append(Op(type="invoke", f="txn", process=t % 4, value=mops,
                    time=idx, index=idx))
        idx += 1
        h.append(Op(type="ok", f="txn", process=t % 4, value=done,
                    time=idx, index=idx))
        idx += 1
    res = cycle_append.checker(device=CPU).check({}, h, {})
    assert res["valid?"] is True, res
    # serial application is even strictly serializable
    rt = cycle_append.checker(additional_graphs=("realtime",), device=CPU) \
        .check({}, h, {})
    assert rt["valid?"] is True, rt


# -- the device option -------------------------------------------------------

def test_the_device_reaches_elle():
    """`device` rides from the workload to `elle.*.check`: "cpu" routes
    the cycle search to the CPU's engines (the route says why)."""
    h = synth.list_append_history(120, seed=3)
    res = cycle_append.workload(device=CPU)["checker"].check({}, h, {})
    assert res["valid?"] is True and res["cycle-route-reason"]
    w = cycle_wr.workload(device=CPU, linearizable_keys=True)
    assert w["checker"].device == CPU
    assert cycle_append.AppendChecker().device is None


# -- parity: seeded histories through both packages --------------------------

def pair(make, make_ref, **kw):
    """The same seeded history from each package's generator (equal op
    for op)."""
    port, ref = make(**kw), make_ref(**kw)
    assert [o.to_dict() for o in port] == [o.to_dict() for o in ref]
    return port, ref


def verdict(res) -> tuple:
    return res["valid?"], res["anomaly-types"]


APPEND_CASES = [dict(n_txns=200, seed=s, corrupt_p=p)
                for s in (1, 2) for p in (0.0, 0.05)]
WR_CASES = [dict(n_txns=200, seed=s, stale_p=p)
            for s in (1, 2) for p in (0.0, 0.05)]


@pytest.mark.parametrize("graphs", [(), ("realtime",)])
@pytest.mark.parametrize("kw", APPEND_CASES, ids=str)
def test_append_verdicts_match_reference(kw, graphs):
    h, rh = pair(synth.list_append_history, ref_synth.list_append_history,
                 **kw)
    port = cycle_append.checker(("G0", "G1", "G2"), graphs,
                                device=CPU).check({}, h, {})
    ref = ref_cycle_append.checker(("G0", "G1", "G2"), graphs).check(
        {}, rh, {})
    assert verdict(port) == verdict(ref)
    if kw["corrupt_p"]:
        assert port["valid?"] is not True


@pytest.mark.parametrize("opts", [{}, {"linearizable_keys": True},
                                  {"sequential_keys": True,
                                   "additional_graphs": ("realtime",)}],
                         ids=str)
@pytest.mark.parametrize("kw", WR_CASES, ids=str)
def test_wr_verdicts_match_reference(kw, opts):
    h, rh = pair(synth.wr_register_history, ref_synth.wr_register_history,
                 **kw)
    port = cycle_wr.checker(device=CPU, **opts).check({}, h, {})
    ref = ref_cycle_wr.checker(**opts).check({}, rh, {})
    assert verdict(port) == verdict(ref)


def test_dumps_match_reference(tmp_path):
    """The elle/ files of an invalid history hold what the reference's
    do."""
    kw = dict(n_txns=200, seed=2, corrupt_p=0.05)
    h, rh = pair(synth.list_append_history, ref_synth.list_append_history,
                 **kw)
    out = {}
    for name, chk, hh in (
            ("port", cycle_append.checker(device=CPU), h),
            ("ref", ref_cycle_append.checker(), rh)):
        test = {"name": "t", "start_time": "20260729T000000",
                "store_root": str(tmp_path / name)}
        assert chk.check(test, hh, {})["valid?"] is False
        d = tmp_path / name / "t" / "20260729T000000" / "elle"
        out[name] = {f: (d / f).read_text() for f in sorted(os.listdir(d))}
    assert out["port"] == out["ref"] and out["port"]


@pytest.mark.parametrize("edges", [[(0, 1, WW), (1, 2, WW), (2, 0, WW)],
                                   [(0, 1, WW), (1, 2, WW)], []])
def test_cycle_checker_matches_reference(edges):
    def analyze(graph_cls):
        def run(history):
            g = graph_cls()
            for a, b, t in edges:
                g.add_edge(a, b, t, None)
            return g
        return run

    port = cycle.checker(analyze(DepGraph)).check({}, History(), {})
    ref = ref_cycle.checker(analyze(RefDepGraph)).check({}, RefHistory(),
                                                        {})
    assert port == ref
