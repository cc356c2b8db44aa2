"""The port's SLO engine (`jepsen_tpu_torch/slo.py`) against the JAX
package's.

Both `Engine`s read the same seeded `kind="service-request"` ledger
records (each from its own package's `Ledger`) and give the same report:
objectives, windows, burn rates, budgets, the multi-window alert, and
`compact_report`. Publishing lands the same `slo` series points and
counters, the same `kind="slo"` ledger record (id and time masked) and
the same fleet fault; `snapshot`, `last_report`, `_reset`,
`evaluate_store`, the env-scaled objectives and `Objective.good` /
`value` agree. Pure host code.
"""

import numpy as np
import pytest

from jepsen_tpu import ledger as jledger
from jepsen_tpu import metrics as jmetrics
from jepsen_tpu import slo as jslo
from jepsen_tpu_torch import ledger as tledger
from jepsen_tpu_torch import metrics as tmetrics
from jepsen_tpu_torch import slo as tslo

NOW = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _isolate():
    jslo._reset()
    tslo._reset()
    yield
    jslo._reset()
    tslo._reset()


def _records(mix: str, n: int = 60, seed: int = 3):
    """Seeded service-request records over the last 10 minutes:
    "healthy" (fast, decided), "slow" (warm walls past 1 s), "down"
    (undecided), each with admission rejections mixed in."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        age = float(rng.uniform(0, 590))
        warm = bool(i % 3)
        wall = float(rng.uniform(0.05, 0.5))
        verdict = True
        if mix == "slow":
            wall = float(rng.uniform(1.2, 3.0))
        if mix == "down" and i % 2:
            verdict = "unknown"
        cause = None
        if i % 11 == 0:
            cause = ("preflight", "quota", "shed")[i % 3]
            verdict = "unknown"
        out.append({"kind": "service-request", "name": "service:x",
                    "t": NOW - age, "verdict": verdict, "cause": cause,
                    "warm_hit": warm, "wall_s": round(wall, 4),
                    "phases": {"queue_wait_s": round(wall / 4, 6)},
                    "tenant": "t"})
    return out


def _ledgers(tmp_path, recs):
    j = jledger.Ledger(str(tmp_path / "j"))
    t = tledger.Ledger(str(tmp_path / "t"))
    for r in recs:
        j.record(dict(r))
        t.record(dict(r))
    return j, t


@pytest.mark.parametrize("mix", ["healthy", "slow", "down", "empty"])
@pytest.mark.parametrize("windows", [None, (30.0, 120.0, 600.0)])
def test_report_matches_reference(tmp_path, mix, windows):
    recs = [] if mix == "empty" else _records(mix)
    j, t = _ledgers(tmp_path, recs)
    ej = jslo.Engine(ledger=j, windows_s=windows)
    et = tslo.Engine(ledger=t, windows_s=windows)
    assert len(et.records(NOW)) == len(ej.records(NOW)) == len(recs)
    a, b = ej.evaluate(now=NOW), et.evaluate(now=NOW)
    assert a == b
    assert tslo.compact_report(b) == jslo.compact_report(a)
    if mix == "slow":
        assert "warm-p50" in [x["objective"] for x in b["alerts"]]
    if mix == "down":
        assert "availability" in [x["objective"] for x in b["alerts"]]
    if mix == "empty":
        assert b["met"] is None and b["alerts"] == []


@pytest.mark.parametrize("mix", ["healthy", "slow"])
def test_publish_matches_reference(tmp_path, mix):
    j, t = _ledgers(tmp_path, _records(mix))
    rj, rt = jmetrics.Registry(), tmetrics.Registry()
    a = jslo.Engine(ledger=j).evaluate_and_publish(now=NOW, mx=rj)
    b = tslo.Engine(ledger=t).evaluate_and_publish(now=NOW, mx=rt)
    assert a == b

    def bare(points):
        return [{k: v for k, v in p.items() if k != "t"} for p in points]
    for name in ("slo", "fleet_faults"):
        assert bare(rt.series(name).points) == bare(rj.series(name).points)
    for name in ("slo_evaluations_total", "slo_burn_alerts_total"):
        assert rt.counter(name).samples() == rj.counter(name).samples()
    sj, = j.query(kind="slo")
    st, = t.query(kind="slo")
    assert {k: v for k, v in st.items() if k not in ("id", "t")} == \
        {k: v for k, v in sj.items() if k not in ("id", "t")}
    assert tslo.snapshot() == jslo.snapshot()
    assert tslo.last_report() == b
    tslo._reset()
    assert tslo.snapshot() == {"checked": 0, "alerts_total": 0,
                               "burning": [], "last": None}


def test_evaluate_store_and_objectives_match_reference(tmp_path,
                                                       monkeypatch):
    j, t = _ledgers(tmp_path, _records("healthy"))
    a = jslo.evaluate_store(str(tmp_path / "j"), windows_s=(1e12,))
    b = tslo.evaluate_store(str(tmp_path / "t"), windows_s=(1e12,))
    assert {k: v for k, v in a.items() if k != "t"} == \
        {k: v for k, v in b.items() if k != "t"}
    assert b["requests"] == 60
    # an evaluate_store is read-only: no ledger record, no snapshot
    assert t.query(kind="slo") == [] and tslo.snapshot()["checked"] == 0
    monkeypatch.setenv("JEPSEN_TPU_SLO_WARM_P50_S", "0.25")
    monkeypatch.setenv("JEPSEN_TPU_SLO_AVAILABILITY", "junk")
    monkeypatch.setenv("JEPSEN_TPU_SLO_WINDOWS", "600,60")
    monkeypatch.setenv("JEPSEN_TPU_SLO_BURN_X", "3")
    assert [o.__dict__ for o in tslo.default_objectives()] == \
        [o.__dict__ for o in jslo.default_objectives()]
    assert tslo.windows_from_env() == jslo.windows_from_env() == (60.0,
                                                                  600.0)
    assert tslo.burn_threshold() == jslo.burn_threshold() == 3.0
    for rec in _records("slow", n=12) + [{"cause": "shed"}, {}]:
        for oj, ot in zip(jslo.default_objectives(),
                          tslo.default_objectives()):
            assert ot.good(rec) == oj.good(rec)
            assert ot.value(rec) == oj.value(rec)
