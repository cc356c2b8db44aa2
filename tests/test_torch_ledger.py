"""The port's run ledger (`jepsen_tpu_torch/ledger.py`) against the JAX
package's.

The same records and result dicts go through both `Ledger`s, and these
agree once each record's `id` and `t` are masked: `summarize_result`,
`device_seconds`, `record` / `record_result` / `get`, `query` (every
filter), `aggregate`, `regressions`, `compact`, the ambient default
(`use`, `record`, `record_result`) and `NULL_LEDGER`. Pure host code:
no device, no kernel.
"""

import json

import numpy as np
import pytest

from jepsen_tpu import ledger as jledger
from jepsen_tpu_torch import ledger as tledger

T0 = 1_700_000_000.0


def _results():
    """Result dicts of every shape the checkers return: a WGL search
    with telemetry, util and hbm blocks; an Elle check with a kernel
    wall; a fan-out with a fleet block; a host oracle; a stall."""
    rng = np.random.default_rng(13)
    chunks = [{"poll_s": float(x), "chunk": i}
              for i, x in enumerate(rng.uniform(0.001, 0.01, 5))]
    return {
        "wgl": {"valid?": True, "op_count": 200, "engine": "device",
                "platform": "cpu", "W": 12, "W_pad": 32, "K": 64,
                "configs_explored": 4096,
                "util": {"configs_per_s": 1000, "rounds": 40,
                         "frontier_fill": 0.5, "memo_hit_rate": 0.25,
                         "first_call_s": 0.01, "chunks": 5,
                         "backlog_peak": 3, "junk": 1,
                         "hbm": {"stats_available": False,
                                 "stats_unavailable": True}},
                "telemetry": {"chunks": chunks}},
        "elle": {"valid?": False, "cause": "G1c", "op_count": 300,
                 "engine": "trim",
                 "util": {"kernel_s": 0.0123, "rounds": 7}},
        "fanout": {"valid?": "unknown", "cause": "timeout",
                   "util": {"fleet": {"keys": 8, "device_count": 2,
                                      "faults": 0, "fallbacks": 1,
                                      "straggler_ratio": 1.5,
                                      "work_skew": 2.0, "other": 3}},
                   "hbm": {"stats_available": True,
                           "peak_measured": 1 << 20}},
        "host": {"valid?": True, "op_count": 12},
        "stall": {"valid?": "unknown", "cause": "stalled",
                  "stall": {"source": "wgl/cpu"}},
        "not-a-dict": None,
    }


@pytest.mark.parametrize("name", list(_results()))
def test_summarize_and_device_seconds_match_reference(name):
    res = _results()[name]
    assert tledger.summarize_result(res) == jledger.summarize_result(res)
    assert tledger.device_seconds(res) == jledger.device_seconds(res)


def _records():
    """Seeded run records over three names, two platforms, every
    verdict, spread over an hour."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(24):
        out.append({
            "t": T0 + 150.0 * i,
            "kind": ("service-request", "elle", "checker")[i % 3],
            "name": ("a", "b", "c")[i % 3],
            "model": ("cas-register", None, "mutex")[i % 3],
            "engine": ("device", "trim")[i % 2],
            "platform": ("cpu", "cuda")[(i // 3) % 2],
            "verdict": (True, False, "unknown")[(i // 2) % 3],
            "wall_s": round(float(rng.uniform(0.1, 2.0)), 4),
            "device_s": (round(float(rng.uniform(0, 1)), 6)
                         if i % 4 else None),
            "compiles": int(i % 3), "stalls": int(i % 5 == 0),
            "tenant": ("x", "y")[i % 2],
            "phases": {"search_s": 0.1 * i}})
    return out


def _mask(recs):
    return [{k: v for k, v in r.items() if k not in ("id", "t")}
            for r in recs]


@pytest.fixture
def both(tmp_path):
    j = jledger.Ledger(str(tmp_path / "j"))
    t = tledger.Ledger(str(tmp_path / "t"))
    for rec in _records():
        assert j.record(dict(rec)) is not None
        assert t.record(dict(rec)) is not None
    return j, t


def test_record_files_and_index_match_reference(both):
    j, t = both
    rj, rt = j.query(), t.query()
    assert len(rj) == len(rt) == 24
    assert _mask(rj) == _mask(rt)
    assert [r["t"] for r in rj] == [r["t"] for r in rt]
    for a, b in zip(rj, rt):
        full_a, full_b = j.get(a["id"]), t.get(b["id"])
        assert {k: v for k, v in full_a.items() if k != "id"} == \
            {k: v for k, v in full_b.items() if k != "id"}
    # the index line is the record file's content, one JSON line each
    with open(t.index_path) as fh:
        lines = [json.loads(x) for x in fh if x.strip()]
    assert _mask(lines) == _mask(rt)
    assert t.get("no-such-id") is None
    assert t.index_signature() is not None


FILTERS = [
    {}, {"kind": "elle"}, {"name": "b"}, {"model": "mutex"},
    {"engine": "trim"}, {"platform": "cuda"}, {"verdict": True},
    {"verdict": "unknown"}, {"since": T0 + 1000.0},
    {"until": T0 + 1000.0}, {"since": T0 + 600.0, "until": T0 + 2400.0},
    {"limit": 5}, {"limit": 5, "newest_first": True},
    {"kind": "service-request", "verdict": False, "newest_first": True},
]


@pytest.mark.parametrize("filters", FILTERS, ids=lambda f: json.dumps(f))
def test_query_and_aggregate_match_reference(both, filters):
    j, t = both
    assert _mask(t.query(**filters)) == _mask(j.query(**filters))
    agg = {k: v for k, v in filters.items()
           if k not in ("limit", "newest_first")}
    assert t.aggregate(**agg) == j.aggregate(**agg)


@pytest.mark.parametrize("threshold", [None, 1.2, 3.0])
def test_regressions_match_reference(both, threshold):
    j, t = both
    a, b = j.regressions(threshold=threshold), t.regressions(
        threshold=threshold)
    for g in list(a["groups"].values()) + list(b["groups"].values()):
        g.pop("latest_id")
    assert a == b
    assert t.regressions(metric="device_s") != {}


def test_regression_gate_matches_reference(monkeypatch):
    from jepsen_tpu import drift
    for env in (None, "2.5", "junk"):
        if env is None:
            monkeypatch.delenv("JEPSEN_TPU_BENCH_REGRESSION_X",
                               raising=False)
        else:
            monkeypatch.setenv("JEPSEN_TPU_BENCH_REGRESSION_X", env)
        assert tledger.regression_threshold() == \
            drift.regression_threshold()
        for latest, best in ((1.0, None), (1.0, 0.0), (2.0, 1.0),
                             (1.4, 1.0), (3.0, 1.0)):
            assert tledger.wall_regressed(latest, best) == \
                drift.wall_regressed(latest, best)


def test_compact_matches_reference(both):
    j, t = both
    assert _mask(tledger.compact(t.query(limit=8, newest_first=True))) == \
        _mask(jledger.compact(j.query(limit=8, newest_first=True)))
    assert tledger.compact(_records(), fields=("name", "tenant")) == \
        jledger.compact(_records(), fields=("name", "tenant"))


def test_record_result_and_ambient_default_match_reference(tmp_path):
    j = jledger.Ledger(str(tmp_path / "j"))
    t = tledger.Ledger(str(tmp_path / "t"))
    kw = dict(model="cas-register", engine="device", platform="cpu",
              artifacts={"trace": "r/trace.jsonl"}, extra={"tenant": "q"})
    for name, res in _results().items():
        with jledger.use(j):
            jledger.record_result("checker", name, res, 0.5, **kw)
        with tledger.use(t):
            tledger.record_result("checker", name, res, 0.5, **kw)
            assert tledger.get_default() is t
        assert tledger.get_default() is tledger.NULL_LEDGER
    with jledger.use(j):
        jledger.record({"kind": "note", "name": "n", "x": {1: 2}})
    with tledger.use(t):
        tledger.record({"kind": "note", "name": "n", "x": {1: 2}})
    # written within one second: the (t, id) order is the random ids'
    def key(r):
        return (r["kind"], r["name"])
    assert sorted(_mask(t.query()), key=key) == \
        sorted(_mask(j.query()), key=key)
    # the disabled default records nothing and never raises
    assert tledger.NULL_LEDGER.record({"kind": "x"}) is None
    assert tledger.record_result("k", "n", {"valid?": True}) is None
    assert tledger.Ledger(None).query() == []


def test_env_default_roots(monkeypatch, tmp_path):
    monkeypatch.setenv("JEPSEN_TPU_LEDGER", str(tmp_path))
    assert tledger._from_env().store_root == str(tmp_path)
    monkeypatch.setenv("JEPSEN_TPU_LEDGER", "1")
    # the port's own root, never the reference's ledger
    assert tledger._from_env().store_root == tledger.BASE_DIR
    assert tledger.BASE_DIR != "store"
    monkeypatch.setenv("JEPSEN_TPU_LEDGER", "0")
    assert tledger._from_env() is tledger.NULL_LEDGER
