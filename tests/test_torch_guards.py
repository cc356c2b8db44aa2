"""The port's compile guard (`jepsen_tpu_torch/analysis/guards.py`).

The reference's `TestGuards` semantics (tests/test_analysis.py): a
budget that is exceeded raises, an in-flight exception is not masked,
`note_transfer` costs nothing without a guard, guards nest. A "compile"
here is an nvcc build, a `ctypes` load or an entry point's first bind
(`ops/_native.py`); `nvcc` and `ctypes.CDLL` are stubbed, so that the
three hooks run on a machine without a toolkit.

Transfer parity: the same history through the reference's `wgl.check`
under its `CompileGuard` and the port's `wgl.check(device="cpu")` under
the port's gives equal h2d and d2h counts (one const upload, one poll a
chunk). Elle's counts are equal too, apart from the port's per-squaring
count reads ("elle-square-counts"), one a squaring: `iters_run` of
them.
"""

import ctypes

import pytest
import torch

from jepsen_tpu import synth as jsynth
from jepsen_tpu.analysis import guards as jguards
from jepsen_tpu.elle import append as jappend
from jepsen_tpu.elle import wr as jwr
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch.analysis import guards
from jepsen_tpu_torch.elle import append as tappend
from jepsen_tpu_torch.elle import wr as twr
from jepsen_tpu_torch.models import core as tmodels
from jepsen_tpu_torch.ops import _native
from jepsen_tpu_torch.ops import wgl as twgl

torch.set_num_threads(1)


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


# --- nvcc and ctypes stubbed -------------------------------------------------

class _FakeProc:
    """An `nvcc` run that writes its output file and reports ptxas."""

    def __init__(self, cmd, **_kw):
        self.out = cmd[cmd.index("-o") + 1]
        self.returncode = 0

    def communicate(self):
        with open(self.out, "wb") as fh:
            fh.write(b"\0")
        return "", "ptxas info: 0 registers"


class _FakeFn:
    def __call__(self, *args):
        return 0 if args else 7


class _FakeLib:
    def __getattr__(self, name):
        fn = _FakeFn()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def stubbed(tmp_path, monkeypatch):
    """_native with nothing built or bound, `nvcc` and `ctypes.CDLL`
    stubbed."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setattr(_native, "_CONSTANTS", {})
    monkeypatch.setattr(_native, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_native.subprocess, "Popen", _FakeProc)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: _FakeLib())
    return _native


def _sources():
    return len(list(_native.CSRC.glob("*.cu")))


def test_first_launch_counts_builds_load_and_bind(stubbed):
    with guards.CompileGuard(name="cold") as g:
        _native.launch("wgl_frontier_migrate", (0, 0), (1, 2, 2, 4), 0)
    # build_all builds every source that is not on disk, at once
    assert (g.builds, g.loads, g.binds) == (_sources(), 1, 1)
    assert g.compiles == _sources() + 2
    rep = g.report()
    assert {"name", "compiles", "compile_s", "d2h", "d2h_bytes", "h2d",
            "h2d_bytes", "wall_s", "budgets", "builds", "loads",
            "binds"} <= set(rep)
    # the bound launch path reports nothing
    with guards.CompileGuard(max_compiles=0, name="warm") as g:
        _native.launch("wgl_frontier_migrate", (0, 0), (1, 2, 2, 4), 0)
    assert g.compiles == 0


def test_budget_exceeded_raises(stubbed):
    with pytest.raises(guards.BudgetExceeded):
        with guards.CompileGuard(max_compiles=0, name="t2"):
            _native.launch("wgl_lane_reset", (0,), (), 0)


def test_a_constant_counts_its_load(stubbed):
    _native.build_all()
    with guards.CompileGuard() as g:
        assert _native.constant("wgln_chunk_grid_ctl_words") == 7
        _native.constant("wgln_chunk_grid_ctl_words")
    assert (g.builds, g.loads, g.binds) == (0, 1, 0)


def test_inflight_exception_not_masked(stubbed):
    with pytest.raises(KeyError):
        with guards.CompileGuard(max_compiles=0, name="t3"):
            _native.launch("wgl_lane_reset", (0,), (), 0)
            raise KeyError("original")


def test_note_hooks_zero_cost_when_inactive():
    assert not guards._ACTIVE
    guards.note_transfer("d2h", 1234)  # must not raise
    guards.note_compile("bind", 0.1)


def test_guards_nest_and_budget_transfers():
    with guards.CompileGuard(name="outer") as outer:
        guards.note_transfer("h2d", 64, what="x")
        with pytest.raises(guards.BudgetExceeded):
            with guards.CompileGuard(max_d2h=0, name="inner") as inner:
                guards.note_transfer("d2h", 44, what="y")
        guards.note_compile("load", 0.5)
    assert (outer.h2d, outer.d2h, outer.loads) == (1, 1, 1)
    assert (inner.h2d, inner.d2h, inner.loads) == (0, 1, 0)
    assert outer.transfers == {"h2d:x": 1, "d2h:y": 1}
    rep = outer.report()
    assert rep["h2d_bytes"] == 64 and rep["d2h_bytes"] == 44
    assert rep["compile_s"] == 0.5
    with pytest.raises(ValueError):
        with guards.CompileGuard():
            guards.note_compile("link")


def test_no_recompile_sugar():
    g = guards.assert_no_recompile("n")
    assert g.max_compiles == 0 and g.name == "n"


# --- transfer parity with the reference ------------------------------------

WGL = {
    "narrow-valid": lambda s: s.cas_register_history(300, n_procs=4, seed=3,
                                                     crash_p=0.01),
    "narrow-invalid": lambda s: s.cas_register_history(
        120, n_procs=5, seed=8, crash_p=0.05, lie_p=0.03),
    "wide-valid": lambda s: s.adversarial_wave_history(
        4, width=8, span=3, seed=5, invalid=False),
}


@pytest.mark.parametrize("name", list(WGL))
def test_wgl_transfer_counts_match_the_reference(name):
    hist = WGL[name](jsynth)
    with jguards.CompileGuard() as jg:
        want = jwgl.check(jmodels.cas_register(), hist)
    with guards.CompileGuard() as g:
        got = twgl.check(tmodels.cas_register(), to_port(hist), device="cpu")
    assert got["valid?"] == want["valid?"]
    assert (g.h2d, g.d2h) == (jg.h2d, jg.d2h), (g.report(), jg.report())
    assert g.h2d == 1 and g.d2h == got["util"]["chunks"]
    assert g.transfers == {"h2d:wgl-consts": 1,
                           "d2h:wgl-poll": got["util"]["chunks"]}


ELLE = [("append", "packed"), ("wr", "packed"), ("append", "trim"),
        ("wr", "trim")]


@pytest.mark.parametrize("kind,backend", ELLE)
def test_elle_transfer_counts_match_the_reference(kind, backend):
    gen = "list_append_history" if kind == "append" else \
        "wr_register_history"
    hist = getattr(jsynth, gen)(120, n_procs=4, seed=5)
    jm, tm = (jappend, tappend) if kind == "append" else (jwr, twr)
    with jguards.CompileGuard() as jg:
        want = jm.check(hist, additional_graphs=("realtime",),
                        cycle_backend=backend)
    with guards.CompileGuard() as g:
        got = tm.check(to_port(hist), additional_graphs=("realtime",),
                       cycle_backend=backend, device="cpu")
    assert got["valid?"] == want["valid?"]
    reads = g.transfers.get("d2h:elle-square-counts", 0)
    assert g.h2d == jg.h2d == 1
    assert g.d2h - reads == jg.d2h == 1
    # one count read a squaring; the trim reads none
    iters = got["cycle-util"]["iters_run"] if backend == "packed" else 0
    assert reads == iters
    if backend == "packed":
        assert reads >= 1
