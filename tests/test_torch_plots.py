"""The port's plot checkers against the JAX package's.

The data half is held equal to the reference on seeded histories with
nemesis ops and clock offsets: `plots.latency_points`,
`quantile_series`, `_nemesis_spans`, `occupancy.heatmap_points`,
`clock.history_datasets` and `short_node_names`. With matplotlib (this
machine has it) each checker writes the reference's file names; with
`_plt` hidden, as on a machine without matplotlib, each answers
`{"valid?": True}` and writes nothing. `linearizable(...,
algorithm="cuda-wgl", device="cpu")` under a metrics registry gives the
search-progress and occupancy-heatmap PNGs exactly when the reference's
"tpu-wgl" does, over equal heatmap points. Every comparison is exact.
"""

import os
import random

import pytest
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import metrics as jmetrics
from jepsen_tpu import occupancy as joccupancy
from jepsen_tpu import synth as jsynth
from jepsen_tpu.checker import clock as jclock
from jepsen_tpu.checker import plots as jplots
from jepsen_tpu.models import core as jmodels
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import metrics as tmetrics
from jepsen_tpu_torch import occupancy as toccupancy
from jepsen_tpu_torch.checker import clock as tclock
from jepsen_tpu_torch.checker import plots as tplots
from jepsen_tpu_torch.models import core as tmodels

# intra-op threads only contend with the other test workers
torch.set_num_threads(1)

NODES = ["n1.db.example.com", "n2.db.example.com", "n3.db.example.com"]


def seeded_history(seed: int, n_ops: int = 240, faults: int = 3) -> list:
    """A cas-register history as op dicts, with `faults` nemesis
    start/stop pairs (the last left open when `faults` is odd) and clock
    offsets on the nemesis completions, spread over ~100 s."""
    rng = random.Random(seed)
    ops = [o.to_dict() for o in jsynth.cas_register_history(
        n_ops, n_procs=4, seed=seed, crash_p=0.03)]
    span = max(o["time"] for o in ops) or 1
    for o in ops:  # stretch the run so that buckets of 10 and 30 s fill
        o["time"] = o["time"] * 100_000_000_000 // span
    out = list(ops)
    for i in range(faults):
        for f in ("start", "stop") if i < faults - 1 or faults % 2 == 0 \
                else ("start",):
            t = rng.randrange(1, 100_000_000_000)
            inv = {"type": "invoke", "process": "nemesis", "f": f,
                   "value": None, "time": t}
            done = {"type": "info", "process": "nemesis", "f": f,
                    "value": None, "time": t + 1_000_000,
                    "clock_offsets": {n: round(rng.uniform(-2, 2), 3)
                                      for n in NODES}}
            out += [inv, done]
    out.sort(key=lambda o: o["time"])
    return out


SEEDS = [1, 2, 7]


def _both(ops):
    from jepsen_tpu import history as jh
    return jh.History(ops), th.History(ops)


@pytest.mark.parametrize("seed", SEEDS)
def test_latency_points_match(seed):
    jhist, thist = _both(seeded_history(seed))
    want = jplots.latency_points(jhist)
    assert want and tplots.latency_points(thist) == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dt", [jplots.DT_QUANTILES, jplots.DT_RATE, 1.0])
def test_quantile_series_match(seed, dt):
    pts = [(p[2], p[3]) for p in
           jplots.latency_points(_both(seeded_history(seed))[0])]
    want = jplots.quantile_series(pts, dt)
    assert want and tplots.quantile_series(pts, dt) == want
    assert tplots.quantile_series([], dt) == jplots.quantile_series([], dt)


@pytest.mark.parametrize("faults", [0, 2, 3])
def test_nemesis_spans_match(faults):
    jhist, thist = _both(seeded_history(5, faults=faults))
    want = jplots._nemesis_spans(jhist)
    assert tplots._nemesis_spans(thist) == want
    assert bool(want) == bool(faults)


@pytest.mark.parametrize("seed", SEEDS)
def test_clock_datasets_match(seed):
    jhist, thist = _both(seeded_history(seed))
    want = jclock.history_datasets(jhist)
    assert set(want) == set(NODES)
    assert tclock.history_datasets(thist) == want


@pytest.mark.parametrize("nodes", [
    NODES, ["n1"], [], ["a.x.com", "b.y.com"], ["n1.a", "n1.b", "n2.a"],
    ["x.c", "y.c", "z.c"]])
def test_short_node_names_match(nodes):
    assert tclock.short_node_names(nodes) == jclock.short_node_names(nodes)


def test_heatmap_points_match():
    rng = random.Random(3)
    rounds = [{"round": r, "fill": rng.random(), "wall_s": r * 0.01}
              for r in range(1, 40)] + [{"round": None, "fill": 0.5},
                                         {"round": 40, "fill": None}]
    for lane in (0, 3):
        assert toccupancy.heatmap_points(rounds, lane) == \
            joccupancy.heatmap_points(rounds, lane)


def _files(root):
    return sorted(f for _, _, fs in os.walk(root) for f in fs)


def _test_map(root, name="plots"):
    return {"name": name, "start_time": "20260101T000000",
            "store_root": str(root)}


def _plot_checkers(mod):
    return mod.compose({"perf": mod.perf(), "clock": mod.clock_plot()})


@pytest.mark.parametrize("seed", SEEDS)
def test_checkers_write_the_references_files(tmp_path, seed):
    jhist, thist = _both(seeded_history(seed))
    want = _plot_checkers(jchecker).check(_test_map(tmp_path / "j"),
                                          jhist, {})
    got = _plot_checkers(tchecker).check(_test_map(tmp_path / "t"),
                                         thist, {})
    assert got == want
    names = _files(tmp_path / "j")
    assert names == ["clock-skew.png", "latency-quantiles.png",
                     "latency-raw.png", "rate.png"]
    assert _files(tmp_path / "t") == names
    for f in names:
        assert os.path.getsize(os.path.join(
            tmp_path / "t", "plots", "20260101T000000", f)) > 0


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib hidden from the port, as on the card's machine."""
    monkeypatch.setattr(tplots, "_plt", lambda: None)
    monkeypatch.setattr(tclock, "_plt", lambda: None)


@pytest.mark.parametrize("checker", ["latency_graph", "rate_graph", "perf",
                                     "clock_plot"])
def test_without_matplotlib_nothing_is_written(tmp_path, no_matplotlib,
                                               checker):
    _, thist = _both(seeded_history(2))
    res = getattr(tchecker, checker)().check(_test_map(tmp_path), thist, {})
    assert res["valid?"] is True
    assert not any(k.endswith("-png") for k in res)
    assert _files(tmp_path) == []


def test_drawers_without_matplotlib_return_none(tmp_path, no_matplotlib):
    _, thist = _both(seeded_history(2))
    test = _test_map(tmp_path)
    chunks = [{"wall_s": 0.1 * i, "frontier": i, "backlog": 0,
               "explored": 10 * i, "explored_delta": 10, "poll_s": 0.1,
               "memo_hit_rate": 0.5} for i in range(1, 4)]
    pts = [{"round": r, "lane": 0, "fill": 0.5} for r in range(5)]
    report = {"rounds": [{"round": 1, "value": 1.0},
                         {"round": 2, "value": 1.1}]}
    assert tplots.point_graph(test, thist) is None
    assert tplots.quantiles_graph(test, thist) is None
    assert tplots.rate_graph(test, thist) is None
    assert tclock.plot(test, thist) is None
    assert tplots.search_progress_graph(test, chunks) is None
    assert tplots.occupancy_heatmap(test, pts) is None
    out = str(tmp_path / "b" / "bench-trajectory.png")
    assert tplots.bench_trajectory_graph(report, out) is None
    assert _files(tmp_path) == []
    # with matplotlib the same calls draw
    assert jplots.bench_trajectory_graph(report, out) == out


def test_bench_trajectory_and_heatmap_files(tmp_path):
    report = {"rounds": [{"round": 1, "value": 1.0, "platform": "gpu",
                          "configs": {"a": 1.0}},
                         {"round": 2, "value": 1.2, "platform": "gpu",
                          "configs": {"a": 2.0}}],
              "regressions": ["a"], "headline": {"regressed": False}}
    out = str(tmp_path / "t" / "bench-trajectory.png")
    assert tplots.bench_trajectory_graph(report, out) == out
    assert os.path.getsize(out) > 0
    assert tplots.bench_trajectory_graph({"rounds": report["rounds"][:1]},
                                         out + "2") is None
    pts = [{"round": r, "lane": la, "fill": (r * la % 7) / 7, "device": la % 2}
           for r in range(6) for la in range(4)]
    hp = str(tmp_path / "t" / "occupancy-heatmap.png")
    events = [{"round": 2, "event": "rebucket", "from_K": 2, "to_K": 16},
              {"round": 4, "event": "steal"}]
    assert tplots.occupancy_heatmap(None, pts, out_path=hp,
                                    events=events) == hp
    assert os.path.getsize(hp) > 0


def _linearizable_pair(tmp_path, hist_ops, with_metrics=True, name="lin"):
    """The reference's "tpu-wgl" and the port's "cuda-wgl" on the CPU,
    each under its own package's metrics registry when `with_metrics`."""
    jhist, thist = _both(hist_ops)
    jt, tt = (_test_map(tmp_path / d, name) for d in ("j", "t"))
    if not name:
        jt.pop("name"), tt.pop("name")
    jreg, treg = jmetrics.Registry(), tmetrics.Registry()
    if with_metrics:
        with jmetrics.use(jreg):
            a = jchecker.linearizable(jmodels.cas_register(),
                                      algorithm="tpu-wgl").check(jt, jhist,
                                                                 {})
        with tmetrics.use(treg):
            b = tchecker.linearizable(tmodels.cas_register(),
                                      algorithm="cuda-wgl",
                                      device="cpu").check(tt, thist, {})
    else:
        a = jchecker.linearizable(jmodels.cas_register(),
                                  algorithm="tpu-wgl").check(jt, jhist, {})
        b = tchecker.linearizable(tmodels.cas_register(),
                                  algorithm="cuda-wgl",
                                  device="cpu").check(tt, thist, {})
    return a, b


def _pngs(res):
    return sorted(k for k in res if k.endswith("-png"))


@pytest.mark.parametrize("case", ["valid", "invalid", "no-metrics",
                                  "no-name"])
def test_linearizable_panels_match_the_reference(tmp_path, case):
    lie = 0.03 if case == "invalid" else 0.0
    ops = [o.to_dict() for o in jsynth.cas_register_history(
        200, n_procs=4, seed=8 if lie else 3, crash_p=0.02, lie_p=lie)]
    a, b = _linearizable_pair(tmp_path, ops,
                              with_metrics=case != "no-metrics",
                              name="" if case == "no-name" else "lin")
    assert a["valid?"] == b["valid?"]
    assert _pngs(b) == _pngs(a)
    if case in ("valid", "invalid"):
        assert _pngs(b) == ["occupancy-heatmap-png", "search-progress-png"]
        for k in _pngs(b):
            assert os.path.basename(b[k]) == os.path.basename(a[k])
            assert os.path.getsize(b[k]) > 0
        assert toccupancy.heatmap_points(b["occupancy"]["rounds"]) == \
            joccupancy.heatmap_points(a["occupancy"]["rounds"])
    else:
        assert _pngs(b) == []


def test_linearizable_without_matplotlib_keeps_its_verdict(tmp_path,
                                                          no_matplotlib):
    ops = [o.to_dict() for o in jsynth.cas_register_history(
        200, n_procs=4, seed=3)]
    a, b = _linearizable_pair(tmp_path, ops)
    assert b["valid?"] is True and a["valid?"] is True
    assert _pngs(b) == [] and _pngs(a)
    assert b["occupancy"]["rounds"]
    assert _files(tmp_path / "t") == []
