"""The checker's and the fan-outs' run-ledger records and trace spans,
against the JAX package's.

A named top-level `linearizable(...).check` banks one `kind="checker"`
record whose summary fields equal the reference's, and a per-key check
(opts carry `history_key`) banks none. Both fan-outs bank one
`kind="independent"` record with the reference's `keys`, `failures`,
`engine` and `model`. The test map's tracer gets a "check linearizable"
root span that parents the engine spans, as in the reference, and the
live status follows the phases. All comparisons are exact.
"""

import random

import pytest
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import ledger as jledger
from jepsen_tpu import synth as jsynth
from jepsen_tpu import trace as jtrace
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.parallel import default_mesh
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import fleet as tfleet
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import ledger as tledger
from jepsen_tpu_torch import trace as ttrace
from jepsen_tpu_torch.models import core as tmodels

# intra-op threads only contend with the other test workers
torch.set_num_threads(1)

# what a record carries that differs run to run
VOLATILE = ("id", "t", "wall_s")


def histories(seed=3, n_ops=120, lie_p=0.0):
    j = jsynth.cas_register_history(n_ops, n_procs=4, seed=seed,
                                    lie_p=lie_p)
    return j, th.History([th.Op.from_dict(o.to_dict()) for o in j])


def records(led, kind):
    return [{k: v for k, v in r.items() if k not in VOLATILE}
            for r in led.query(kind=kind)]


@pytest.mark.parametrize("lie_p", [0.0, 0.03], ids=["valid", "invalid"])
def test_named_check_banks_the_references_checker_record(tmp_path, lie_p):
    jhist, thist = histories(lie_p=lie_p)
    test = {"name": "lin-record"}
    jled = jledger.Ledger(str(tmp_path / "j"))
    tled = tledger.Ledger(str(tmp_path / "t"))
    with jledger.use(jled):
        jr = jchecker.linearizable(jmodels.cas_register(),
                                   algorithm="wgl").check(test, jhist, {})
    with tledger.use(tled):
        tr = tchecker.linearizable(tmodels.cas_register(),
                                   algorithm="wgl").check(test, thist, {})
    assert tr["valid?"] == jr["valid?"] == (lie_p == 0.0)
    want, got = records(jled, "checker"), records(tled, "checker")
    assert len(got) == 1
    assert got == want
    assert got[0]["algorithm"] == "wgl"
    assert got[0]["model"] == "CASRegister"
    assert tled.query(kind="checker")[0]["wall_s"] >= 0


def test_device_check_banks_a_checker_and_a_preflight_record(tmp_path):
    _, thist = histories()
    tled = tledger.Ledger(str(tmp_path))
    with tledger.use(tled):
        tr = tchecker.linearizable(tmodels.cas_register(),
                                   algorithm="cuda-wgl",
                                   device="cpu").check({"name": "dev"},
                                                       thist, {})
    assert tr["valid?"] is True
    [rec] = tled.query(kind="checker")
    assert (rec["name"], rec["algorithm"], rec["verdict"]) == (
        "dev", "cuda-wgl", True)
    assert rec["shapes"]["configs_explored"] == tr["configs_explored"]
    assert [r["name"] for r in tled.query(kind="preflight")] == ["dev"]


@pytest.mark.parametrize("test,opts", [
    ({"name": "per-key"}, {"history_key": 3}), ({}, {})],
    ids=["per-key", "unnamed"])
def test_no_record_for_a_per_key_or_unnamed_check(tmp_path, test, opts):
    jhist, thist = histories()
    jled = jledger.Ledger(str(tmp_path / "j"))
    tled = tledger.Ledger(str(tmp_path / "t"))
    with jledger.use(jled):
        jchecker.linearizable(jmodels.cas_register(),
                              algorithm="wgl").check(test, jhist, opts)
    with tledger.use(tled):
        tchecker.linearizable(tmodels.cas_register(),
                              algorithm="wgl").check(test, thist, opts)
    assert tled.query() == [] == jled.query()


def multikey(pkg_h, pkg_synth, pkg_ind, n_keys=4, bad=(), seed=7):
    """Interleaved per-key cas-register histories with tuple values."""
    rng = random.Random(seed)
    streams = []
    for k in range(n_keys):
        sub = pkg_synth.cas_register_history(
            24, n_procs=3, seed=100 + k, lie_p=0.2 if k in bad else 0.0)
        streams.append((k, list(sub)))
    hist = pkg_h.History()
    while any(ops for _, ops in streams):
        k, ops = rng.choice([s for s in streams if s[1]])
        op = ops.pop(0)
        hist.append(op.with_(process=(op.process, k),
                             value=pkg_ind.tuple_(k, op.value)))
    return hist.index()


def _fanout_fields(rec):
    return {k: rec.get(k) for k in ("kind", "name", "keys", "failures",
                                    "engine", "model", "verdict")}


@pytest.mark.parametrize("bad", [(), (1, 3)], ids=["valid", "two-bad"])
def test_host_fanout_banks_the_references_record(tmp_path, bad):
    from jepsen_tpu_torch import synth as tsynth
    j = multikey(jh, jsynth, jind, bad=bad)
    t = multikey(th, tsynth, tind, bad=bad)
    jled = jledger.Ledger(str(tmp_path / "j"))
    tled = tledger.Ledger(str(tmp_path / "t"))
    with jledger.use(jled):
        jr = jind.checker(jchecker.linearizable(
            jmodels.cas_register(), algorithm="wgl")).check(
                {"name": "fan"}, j, {})
    with tledger.use(tled):
        tr = tind.checker(tchecker.linearizable(
            tmodels.cas_register(), algorithm="wgl")).check(
                {"name": "fan"}, t, {})
    assert sorted(tr["failures"]) == sorted(jr["failures"]) == list(bad)
    [want] = jled.query(kind="independent")
    [got] = tled.query(kind="independent")
    assert _fanout_fields(got) == _fanout_fields(want)
    assert got["keys"] == 4 and got["failures"] == len(bad)
    # the per-key checks bank no checker record of their own
    assert tled.query(kind="checker") == [] == jled.query(kind="checker")


def test_device_fanout_banks_the_references_record(tmp_path):
    from jepsen_tpu_torch import synth as tsynth
    bad = (0, 2)
    j = multikey(jh, jsynth, jind, n_keys=3, bad=bad)
    t = multikey(th, tsynth, tind, n_keys=3, bad=bad)
    jled = jledger.Ledger(str(tmp_path / "j"))
    tled = tledger.Ledger(str(tmp_path / "t"))
    with jledger.use(jled):
        jind.tpu_checker(jmodels.cas_register(),
                         mesh=default_mesh(n_devices=1)).check(
                             {"name": "fan-dev"}, j, {})
    status = tfleet.RunStatus()
    with tledger.use(tled), tfleet.use(status):
        tr = tind.cuda_checker(tmodels.cas_register(),
                               device="cpu").check({"name": "fan-dev"},
                                                   t, {})
    assert sorted(tr["failures"]) == list(bad)
    [want] = jled.query(kind="independent")
    [got] = tled.query(kind="independent")
    assert _fanout_fields(got) == _fanout_fields(want)
    assert (got["engine"], got["model"], got["keys"], got["failures"]) == (
        "device-mesh", "CASRegister", 3, 2)
    assert status.snapshot()["phase"] == "independent-check"


def _tree(tracer):
    by = {s.span_id: s for s in tracer.spans}
    return sorted({(s.name, by[s.parent_id].name if s.parent_id in by
                    else None) for s in tracer.spans}, key=str)


@pytest.mark.parametrize("lie_p", [0.0, 0.03], ids=["valid", "invalid"])
def test_root_span_parents_the_engine_spans(lie_p):
    jhist, thist = histories(lie_p=lie_p)
    jt, tt = jtrace.Tracer(), ttrace.Tracer()
    jchecker.linearizable(jmodels.cas_register(),
                          algorithm="tpu-wgl").check({"tracer": jt},
                                                     jhist, {})
    tchecker.linearizable(tmodels.cas_register(), algorithm="cuda-wgl",
                          device="cpu").check({"tracer": tt}, thist, {})
    got = _tree(tt)
    assert got == _tree(jt)
    assert ("check linearizable", None) in got
    assert ("encode", "check linearizable") in got
    assert ("host-poll", "compile") in got
    assert (("enrich", "check linearizable") in got) == (lie_p > 0)
    [root] = [s for s in tt.spans if s.parent_id is None]
    assert root.attrs == {"algorithm": "cuda-wgl"}
    assert {s.trace_id for s in tt.spans} == {root.trace_id}


def test_the_race_nests_under_the_root_span():
    jhist, thist = histories(seed=5)
    jt, tt = jtrace.Tracer(), ttrace.Tracer()
    jchecker.linearizable(jmodels.cas_register()).check({"tracer": jt},
                                                        jhist, {})
    tchecker.linearizable(tmodels.cas_register(), device="cpu").check(
        {"tracer": tt}, thist, {})
    # the lanes' own inner spans depend on which lane wins first
    fixed = {("check linearizable", None),
             ("history-lint", "check linearizable"),
             ("preflight", "check linearizable"),
             ("oracle-race", "check linearizable"),
             ("engine device", "oracle-race"),
             ("engine oracle", "oracle-race")}
    assert fixed <= set(_tree(tt))
    assert fixed <= set(_tree(jt))
    assert {n for n, _ in _tree(tt)} - {n for n, _ in _tree(jt)} <= {
        "encode", "compile", "host-poll", "enrich"}


def test_status_follows_the_phases():
    _, thist = histories()
    tt = ttrace.Tracer()
    status = tfleet.RunStatus()
    seen = []
    tt.add_listener(lambda ev, sp: seen.append(
        status.snapshot()["phase"]))
    with tfleet.use(status):
        tchecker.linearizable(tmodels.cas_register(), algorithm="cuda-wgl",
                              device="cpu").check({"tracer": tt}, thist, {})
    assert "check linearizable" in seen and "encode" in seen
    assert status.snapshot()["phase"] == "analyze"
