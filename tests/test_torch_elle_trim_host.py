"""The host trim (`csrc/elle_trim_host.cpp`): Elle's trim on one host core.

CPU tensors run the trim fixpoint on this kernel (`elle.tpu.trim`), the
port's counterpart of the JAX package's trim compiled for the CPU
(`_compiled_trim`). It is held, tolerance zero on the live planes, every
counts row (the 64-row clamp included) and the body count, against

  * the plain spec `trim_ref` and the JAX `make_trim_kernel` (jitted on
    the CPU) on the parity corpora of `test_torch_elle_trim`: builder
    graphs with realtime and process jumps, chains past the counts rows,
    8192 process segments, and drawn graphs with every jump on and off;
  * the JAX trim alone at full size: the 3k list-append and rw-register
    graphs, realtime thresholds on and off;
  * the reference's Elle checks through the checker: a 3k history takes
    the device route and the trim on both, with one host call and no
    `trim_ref`.

Then the build: no fallback without a compiler, the compile guard's
kinds, two threads calling at once, the kernel's own index check.
"""

import functools
import threading

import numpy as np
import pytest
import torch

import test_torch_elle_trim as TT
from jepsen_tpu import synth as jsynth
from jepsen_tpu.elle import append as jappend
from jepsen_tpu.elle import wr as jwr
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch.analysis import guards
from jepsen_tpu_torch.elle import append as tappend
from jepsen_tpu_torch.elle import build as tbuild
from jepsen_tpu_torch.elle import tpu as ttpu
from jepsen_tpu_torch.elle import wr as twr
from jepsen_tpu_torch.ops import _native, aot

torch.set_num_threads(1)


def host_trim(t):
    return TT.port_trim(t, fn=ttpu.trim)


def plain(t):
    return tuple(x if isinstance(x, int) else x.numpy()
                 for x in TT.port_trim(t))


def same_three_ways(t):
    got = host_trim(t)
    TT.assert_same(got, plain(t))
    TT.assert_same(got, TT.jax_trim(t))
    return got


@pytest.mark.parametrize("name", list(TT.CASES))
def test_host_trim_matches_trim_ref_and_jax(name):
    same_three_ways(ttpu.trim_inputs(TT.CASES[name]()))


def test_host_trim_with_many_processes():
    t = TT.many_processes()
    assert t["p_pad"] > ttpu.TRIM_SMEM_PROCS
    same_three_ways(t)


def test_host_trim_runs_past_the_counts_rows():
    """A chain loses its two ends a peel: its fixpoint runs past the 64
    counts rows, whose last row then holds the last body's counts."""
    t = ttpu.trim_inputs(TT.CASES["chain-300"]())
    live, counts, bodies = same_three_ways(t)
    assert bodies > ttpu.TRIM_COUNTS_ROWS and not live.any()
    assert counts[-1].tolist() == [0, 0, 0]


JUMPS = [(True, False), (True, True), (False, True), (False, False)]


@pytest.mark.parametrize("jumps", JUMPS,
                         ids=lambda j: f"rt{j[0]:d}-proc{j[1]:d}")
@pytest.mark.parametrize("seed", range(6))
def test_host_trim_on_drawn_graphs(seed, jumps):
    """Drawn inputs: out-lists not the mirror of the in-lists, inverted
    intervals, absent events (tied pool extremes), repeated chain
    positions; realtime and process chains each on and off."""
    same_three_ways(TT.random_trim_inputs(seed, 2 + 25 * seed, 8, 4,
                                          *jumps))


# --- full size, against JAX alone -------------------------------------------

@functools.lru_cache(maxsize=None)
def big_inputs(kind):
    h = (tsynth.list_append_history if kind == "append"
         else tsynth.wr_register_history)(3000, seed=3)
    if kind == "append":
        g = tbuild.build_append(h, *TT._split(h),
                                additional_graphs=("realtime",)).tensors
    else:
        g = tbuild.build_wr(h, *TT._split(h), linearizable_keys=True,
                            additional_graphs=("realtime",)).tensors
    return ttpu.trim_inputs(g)


@pytest.mark.parametrize("use_rt", [True, False], ids=["rt", "no-rt"])
@pytest.mark.parametrize("kind", ["append", "wr"])
def test_host_trim_at_3k_matches_jax(kind, use_rt):
    t = big_inputs(kind)
    assert t["n_pad"] == 4096 and t["use_rt"]
    t = dict(t, use_rt=use_rt)
    live, _, bodies = host_trim(t)
    TT.assert_same((live, _, bodies), TT.jax_trim(t))
    assert bodies > 1


# --- through the checker ------------------------------------------------------

def _no_plain(*a, **k):
    raise AssertionError("trim_ref ran on the main path")


@pytest.mark.parametrize("kind", ["append", "wr"])
def test_cpu_check_runs_the_host_trim(kind, monkeypatch):
    """A 3k Elle check with device="cpu" routes to the device and the
    trim, as the reference's on XLA-cpu does: one host call, no
    `trim_ref`, the reference's verdict and iterations."""
    tgen, jgen, tcheck, jcheck = {
        "append": (tsynth.list_append_history, jsynth.list_append_history,
                   tappend.check, jappend.check),
        "wr": (tsynth.wr_register_history, jsynth.wr_register_history,
               twr.check, jwr.check)}[kind]
    monkeypatch.setattr(ttpu, "trim_ref", _no_plain)
    calls, launches = ttpu.trim.host_calls, ttpu.trim.launches
    got = tcheck(tgen(3000, seed=3), device="cpu", cycle_backend="auto")
    assert ttpu.trim.host_calls == calls + 1
    assert ttpu.trim.launches == launches
    want = jcheck(jgen(3000, seed=3), cycle_backend="auto")
    assert got["cycle-engine"] == want["cycle-engine"] == "device"
    gu, wu = got["cycle-util"], want["cycle-util"]
    assert gu["kernel"] == wu["kernel"] == "trim"
    assert got["valid?"] == want["valid?"]
    assert got["anomaly-types"] == want["anomaly-types"]
    for k in ("iters_run", "iter_reach", "core_sizes", "n_pad"):
        assert gu[k] == wu[k], k


# --- the build ------------------------------------------------------------------

def _fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no host entry point bound."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_LIBS", {})


def test_no_host_compiler_raises_and_nothing_falls_back(monkeypatch,
                                                        tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(ttpu, "trim_ref", _no_plain)
    t = ttpu.trim_inputs(TT.CASES["wr-stale"]())
    calls = ttpu.trim.host_calls
    with pytest.raises(RuntimeError, match="host C\\+\\+ compiler"):
        host_trim(t)
    assert ttpu.trim.host_calls == calls


def test_host_build_and_load_are_compiles_of_their_own_kind(monkeypatch,
                                                            tmp_path):
    """The first host trim builds its own source alone, loads and binds
    it (no nvcc build, no CUDA load); a warm one compiles nothing."""
    _fresh_build(monkeypatch, tmp_path)
    t = ttpu.trim_inputs(TT.CASES["append-process"]())
    with guards.CompileGuard(name="cold") as g:
        host_trim(t)
    rep = g.report()
    assert (rep["host_builds"], rep["host_loads"], rep["binds"]) == (1, 1, 1)
    assert (rep["builds"], rep["loads"]) == (0, 0)
    assert [p.name.split("-")[0] for p in tmp_path.glob("*.so")] == [
        "libelle_trim_host"]
    with guards.CompileGuard(max_compiles=0, name="warm"):
        host_trim(t)


def test_two_threads_at_once_get_equal_results():
    """The kernel keeps no state between calls: two Python threads
    calling it at once (the GIL released) each get the sequential
    result."""
    t = big_inputs("append")
    want = host_trim(t)
    start = threading.Barrier(2)
    out = [None, None]

    def run(k):
        start.wait()
        out[k] = host_trim(t)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for got in out:
        assert got[2] == want[2]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_refuses_an_index_out_of_range():
    """Past the wrapper's checks the kernel checks its own indices and
    names the fault."""
    t = ttpu.trim_inputs(TT.CASES["wr-valid"]())
    ins = [torch.from_numpy(np.ascontiguousarray(a)) for a in t["arrays"]]
    ins[0] = ins[0].clone()
    ins[0][0, 0] = t["n_pad"]
    ins[1] = ins[1].clone()
    ins[1][0, 0, :] = True
    S = len(ttpu.SUBSETS)
    outs = [torch.empty_like(ins[8]),
            torch.empty((ttpu.TRIM_COUNTS_ROWS, S), dtype=torch.int32),
            torch.empty((), dtype=torch.int32)]
    with pytest.raises(ValueError, match="index outside"):
        host_trim(dict(t, arrays=tuple(x.numpy() for x in ins)))
    with pytest.raises(RuntimeError, match="neighbor index outside"):
        _native.host_call("elle_trim_host", [x.data_ptr() for x in ins + outs],
                          (t["n_pad"], t["d_in"], t["d_out"], S, t["p_pad"],
                           int(t["use_rt"]), int(t["use_proc"]),
                           ttpu.TRIM_COUNTS_ROWS))


def test_cold_sources_ignore_the_host_trim(monkeypatch, tmp_path):
    """The host trim is no nvcc module: bound, it leaves the card's trim
    cold (P003 bills only nvcc builds)."""
    _fresh_build(monkeypatch, tmp_path)
    host_trim(ttpu.trim_inputs(TT.CASES["cycle-120"]()))
    assert "elle_trim_host" in _native._LIBS
    assert _native.cold_sources(["elle_trim"]) == ["elle_trim"]


def test_cpu_warm_builds_the_host_trim(monkeypatch, tmp_path):
    """The Elle warm on the CPU runs the host trim once (its build, load
    and bind); the check it warms then compiles nothing."""
    _fresh_build(monkeypatch, tmp_path)
    h = tsynth.list_append_history(120, n_procs=4, seed=5)
    g = tbuild.build_append(h, *TT._split(h),
                            additional_graphs=("realtime",)).tensors
    calls, launches = ttpu.trim.host_calls, ttpu.trim.launches
    with guards.CompileGuard(name="warm") as gd:
        aot.precompile_elle_closure(ttpu.shape_bucket_for(g), ("trim",),
                                    device="cpu")
    assert (gd.report()["host_builds"], ttpu.trim.host_calls,
            ttpu.trim.launches) == (1, calls + 1, launches)
    with guards.CompileGuard(max_compiles=0, name="warmed"):
        res = tappend.check(h, additional_graphs=("realtime",),
                            cycle_backend="trim", device="cpu")
    assert res["cycle-engine"] == "trim" and ttpu.trim.host_calls == calls + 2
