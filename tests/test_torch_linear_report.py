"""The port's counterexample SVG (`checker/linear_report.py`) against the
JAX package's.

For seeded invalid cas-register and register histories, the host
oracle's analysis renders byte for byte the same `linear.svg` in both
packages, with and without a failing op and a device-search footer, and
windowed past `MAX_OPS`. `render_analysis` writes under the
`subdirectory` opt, returns None for an unnamed test and never raises;
`linearizable(...).check` names the file in "counterexample-svg" on a
False verdict, as the reference's does.
"""

import os

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import history as jh
from jepsen_tpu import synth as jsynth
from jepsen_tpu.checker import linear_report as jreport
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import wgl_ref as jref
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch.checker import linear_report as treport
from jepsen_tpu_torch.models import core as tmodels
from jepsen_tpu_torch.ops import wgl_ref as tref

# (model name, n_ops, seed, lie_p, fs); every one is invalid
CASES = [("cas", 120, 8, 0.03, None), ("cas", 400, 3, 0.02, None),
         ("register", 150, 11, 0.04, ("read", "write")),
         ("register", 300, 4, 0.03, ("read", "write"))]
MODELS = {"cas": (jmodels.cas_register, tmodels.cas_register),
          "register": (jmodels.register, tmodels.register)}


def histories(n_ops, seed, lie_p, fs, crash_p=0.03):
    kw = {"fs": fs} if fs else {}
    jhist = jsynth.cas_register_history(n_ops, n_procs=5, seed=seed,
                                        crash_p=crash_p, lie_p=lie_p,
                                        **kw).index()
    thist = th.History([th.Op.from_dict(o.to_dict()) for o in jhist])
    return jhist, thist


def analyses(model, n_ops, seed, lie_p, fs, crash_p=0.03):
    jm, tm = MODELS[model]
    jhist, thist = histories(n_ops, seed, lie_p, fs, crash_p)
    ja = jref.check(jm(), jh.strip_nemesis(jhist))
    ta = tref.check(tm(), th.strip_nemesis(thist))
    assert ja["valid?"] is False and ta["valid?"] is False
    return jhist, thist, ja, ta


IDS = [f"{m}-{n}-{s}" for m, n, s, _, _ in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_render_matches_the_reference(case):
    jhist, thist, ja, ta = analyses(*case)
    ja["algorithm"] = ta["algorithm"] = "wgl"
    got = treport.render(thist, ta)
    assert got is not None and got.startswith("<svg")
    assert got == jreport.render(jhist, ja)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_render_with_a_failing_op_and_a_footer(case):
    """The highlighted op and the device-search footer, on one analysis
    handed to both renderers."""
    jhist, thist, ja, _ = analyses(*case)
    bad = ja["configs"][0]["pending"][0]
    analysis = {**ja, "algorithm": "cuda-wgl", "op": bad,
                "wall_s": 0.0123, "util": {"rounds": 54,
                                           "memo_hit_rate": 0.6218}}
    got = treport.render(thist, analysis)
    assert got == jreport.render(jhist, analysis)
    assert "No configuration could linearize" in got
    assert "device search: " in got


def test_render_windows_a_long_history():
    jhist, thist, ja, ta = analyses("cas", 2000, 9, 0.004, None, 0.0)
    assert len(thist) > 2 * treport.MAX_OPS
    analysis = {**ja, "op": ja["configs"][0]["pending"][0]}
    got = treport.render(thist, analysis)
    assert got == jreport.render(jhist, analysis)
    assert got.count("<rect") <= treport.MAX_OPS


def test_nothing_to_draw():
    assert treport.render(th.History(), {}) is None
    assert jreport.render(jh.History(), {}) is None


def test_render_analysis_writes_under_the_subdirectory(tmp_path):
    jhist, thist, ja, ta = analyses(*CASES[0])
    test = {"name": "lin", "start_time": "20260101T000000",
            "store_root": str(tmp_path)}
    opts = {"subdirectory": ["independent", "7"]}
    p = treport.render_analysis(test, thist, ta, opts)
    assert p == os.path.join(str(tmp_path), "lin", "20260101T000000",
                             "independent", "7", "linear.svg")
    jp = jreport.render_analysis({**test, "store_root": str(tmp_path / "j")},
                                 jhist, ja, opts)
    assert open(p).read() == open(jp).read()
    # an unnamed test renders nothing and returns None
    assert treport.render_analysis({"store_root": str(tmp_path)}, thist,
                                   ta) is None


def test_render_analysis_never_raises(tmp_path):
    test = {"name": "lin", "start_time": "t", "store_root": str(tmp_path)}
    assert treport.render_analysis(test, object(), {}) is None


def test_checker_names_the_counterexample(tmp_path):
    """A False verdict of `linearizable(...).check` on a named test
    writes linear.svg into the run's directory in both packages, the
    same bytes for the oracle's analysis."""
    jhist, thist = histories(150, 11, 0.04, ("read", "write"))
    out = {}
    for name, mod, model, h in (
            ("reference", jchecker, jmodels.register(), jhist),
            ("port", tchecker, tmodels.register(), thist)):
        test = {"name": "lin", "start_time": "20260101T000000",
                "store_root": str(tmp_path / name)}
        res = mod.linearizable(model, algorithm="wgl").check(test, h, {})
        assert res["valid?"] is False
        out[name] = open(res["counterexample-svg"], "rb").read()
    assert out["port"] == out["reference"]
    # unnamed: no file, no key
    res = tchecker.linearizable(tmodels.register(), algorithm="wgl").check(
        {}, thist, {})
    assert res["valid?"] is False and "counterexample-svg" not in res
