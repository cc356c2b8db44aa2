"""The host kernel (`csrc/wgl_host.cpp`): the WGL chunk on one host core.

CPU tensors run the narrow and wide chunks, single and lane-batched, on
this kernel (`wgl32.chunk`, `wgln.chunk` and their `chunk_batched`), the
port's counterpart of the JAX package's host build of the same jitted
chunk (`platform="cpu"`). It is held, tolerance zero on every carry leaf
and on the summary, against

  * the plain spec `chunk_ref` / `chunk_batched_ref`, on the same
    carry, chunk after chunk;
  * the JAX package's `chunk_fn` (`accel=False, depth=1`), `pack` on and
    off, and its lane-batched forms, each chunk from JAX's carry.

The corpora are the parity files' (`test_torch_wgl32`, `test_torch_wgln`,
`test_torch_batched`): at K 2, 16 and 64, narrow and wide (L 2 and 3),
across several chunks, with a backlog that overflows and searches that
end False. Then the cancel word a race sets (the kernel ends a chunk
after the round it reads it in), the build (no fallback without a
compiler, the compile guard's kinds, processes building at once).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_batched as TB
import test_torch_wgl32 as T32
import test_torch_wgln as TN
from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu_torch.analysis import guards
from jepsen_tpu_torch.ops import _native
from jepsen_tpu_torch.ops import wgl32 as tw
from jepsen_tpu_torch.ops import wgln as tn

torch.set_num_threads(1)

KS = [2, 16, 64]
REPO = Path(__file__).resolve().parents[1]


def _same(a_carry, a_summary, b_carry, b_summary, what):
    assert torch.equal(a_summary, b_summary), f"{what}: summary"
    for i, (a, b) in enumerate(zip(a_carry, b_carry)):
        assert torch.equal(a, b), f"{what}: leaf {i}"


def _clone(carry):
    return tuple(t.clone() for t in carry)


# --- the narrow chunk -------------------------------------------------------

def _narrow_run(name, K, n_chunks=T32.N_CHUNKS):
    """The host chunk and `chunk_ref` from one start, chunk after chunk;
    returns the summaries."""
    enc = T32._encoded(name)
    consts = tw.consts_from_numpy(*T32._np_consts(enc), device="cpu")
    kw = dict(K=K, W=T32.W, ic=T32.IC, H=T32.H, B=T32.B, chunk=T32.CHUNK,
              probes=T32.PROBES)
    host = tw.init_carry(K, tw.row_words(T32.IC), T32.H, T32.B, 0, "cpu")
    ref = _clone(host)
    out = []
    for step in range(n_chunks):
        host, hs = tw.chunk(consts, host, **kw)
        ref, rs = tw.chunk_ref(consts, ref, **kw)
        _same(host, hs, ref, rs, f"{name} K={K} chunk {step}")
        out.append(hs.numpy())
        if hs[1] or hs[0] == 0:
            break
    return out


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("name", T32.NAMES)
def test_narrow_host_chunk_matches_chunk_ref(name, K):
    _narrow_run(name, K)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("name", T32.NAMES)
def test_narrow_host_chunk_matches_jax_chunk_fn(name, K):
    enc = T32._encoded(name)
    consts_j = T32._jax_consts(enc)
    consts_t = tw.consts_from_numpy(*T32._np_consts(enc), device="cpu")
    init_fn, _ = T32._jax_chunk(K, False, name)
    carry = init_fn(0)
    for step in range(T32.N_CHUNKS):
        leaves = [np.asarray(x) for x in carry]
        port, port_summary = tw.chunk(
            consts_t, tw.carry_from_numpy(leaves, "cpu"), K=K, W=T32.W,
            ic=T32.IC, H=T32.H, B=T32.B, chunk=T32.CHUNK, probes=T32.PROBES)
        for pack in (False, True):
            _, chunk_jit = T32._jax_chunk(K, pack, name)
            out = chunk_jit(consts_j, tuple(jnp.asarray(x) for x in leaves))
            T32._assert_same(port, port_summary, *out,
                             f"{name} K={K} pack={pack} chunk {step}")
        carry, summary = out
        s = np.asarray(summary)
        if s[1] or s[0] == 0:
            break


def test_narrow_corpora_reach_overflow_a_false_end_and_several_chunks():
    """The host runs above reach a backlog overflow, a search that
    exhausts without a linearization (a False verdict) and searches
    that span every chunk."""
    spans = _narrow_run("cas", 2)
    assert len(spans) == T32.N_CHUNKS and spans[-1][10] > 0   # spill
    invalid = _narrow_run("cas-invalid", 16)[-1]
    assert invalid[0] == 0 and not invalid[1] and invalid[3]  # exhausted
    overflow = _narrow_run("register", 16)[-1]
    assert overflow[2]                                         # overflow


# --- the wide chunk ---------------------------------------------------------

WIDE_CASES = [("L2", "wave-4x10"), ("L2", "wave-3x12"), ("L2", "wave-valid"),
              ("L3", "long-tail")]


def _wide_run(layout, name, K, cap=TN.ROOMY):
    L, ic, _, _ = TN.LAYOUTS[layout]
    H, B = cap
    enc = TN._encoded(layout, name)
    consts = tw.consts_from_numpy(*TN._np_consts(enc, ic), device="cpu")
    kw = dict(K=K, L=L, ic=ic, H=H, B=B, chunk=TN.CHUNK, probes=TN.PROBES)
    host = tn.init_carry(K, L, ic, H, B, 0, "cpu")
    ref = _clone(host)
    out = []
    for step in range(TN.N_CHUNKS):
        host, hs = tn.chunk(consts, host, **kw)
        ref, rs = tn.chunk_ref(consts, ref, **kw)
        _same(host, hs, ref, rs, f"{layout}/{name} K={K} chunk {step}")
        out.append(hs.numpy())
        if hs[1] or hs[0] == 0:
            break
    return out


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("layout,name", WIDE_CASES)
def test_wide_host_chunk_matches_chunk_ref(layout, name, K):
    _wide_run(layout, name, K)


def test_wide_host_chunk_with_collisions_spill_and_overflow():
    spans = _wide_run("L2", "wave-4x10", 16, cap=TN.TIGHT)
    assert max(int(s[10]) for s in spans) > 0
    assert spans[-1][2]                                        # overflow


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("layout,name", WIDE_CASES)
def test_wide_host_chunk_matches_jax_chunk_fn(layout, name, K):
    L, ic, _, _ = TN.LAYOUTS[layout]
    H, B = TN.ROOMY
    enc = TN._encoded(layout, name)
    consts_j = TN._jax_consts(enc, ic)
    consts_t = tw.consts_from_numpy(*TN._np_consts(enc, ic), device="cpu")
    init_fn, _ = TN._jax_chunk(layout, K, False)
    carry = init_fn(0)
    for step in range(TN.N_CHUNKS):
        leaves = [np.asarray(x) for x in carry]
        port, port_summary = tn.chunk(
            consts_t, tw.carry_from_numpy(leaves, "cpu"), K=K, L=L, ic=ic,
            H=H, B=B, chunk=TN.CHUNK, probes=TN.PROBES)
        for pack in (False, True):
            _, chunk_jit = TN._jax_chunk(layout, K, pack)
            out = chunk_jit(consts_j, tuple(jnp.asarray(x) for x in leaves))
            TN._assert_same(port, port_summary, *out,
                            f"{layout}/{name} K={K} pack={pack} chunk {step}")
        carry, summary = out
        s = np.asarray(summary)
        if s[1] or s[0] == 0:
            break


def test_wide_invalid_wave_ends_false():
    """An invalid wave exhausts its search on the host without a
    backlog overflow (at K 512; narrower beams spill past B): a False
    end."""
    L, ic, _, _ = TN.LAYOUTS["L2"]
    H, B = TN.ROOMY
    enc = TN._encoded("L2", "wave-4x10")
    consts = tw.consts_from_numpy(*TN._np_consts(enc, ic), device="cpu")
    carry = tn.init_carry(512, L, ic, H, B, 0, "cpu")
    for _ in range(16):
        carry, s = tn.chunk(consts, carry, K=512, L=L, ic=ic, H=H, B=B,
                            chunk=TN.CHUNK, probes=TN.PROBES)
        if s[1] or s[0] == 0:
            break
    assert int(s[0]) == 0 and not s[1] and not s[2]


# --- the lane-batched chunks ------------------------------------------------

def _narrow_batched(c, k):
    p = TB.NARROW
    return tw.chunk_batched(c, k, K=p["K"], W=p["W"], ic=p["ic"], H=p["H"],
                            B=p["B"], chunk=p["chunk"], probes=TB.PROBES)


@pytest.mark.parametrize("form", ["vmap", "lanes"])
def test_narrow_host_chunk_batched_matches_jax(form):
    TB._run_parity("narrow", form, 0, _narrow_batched, 2, TB.MAX_CFG)


@pytest.mark.parametrize("L", [2, 3])
def test_wide_host_chunk_batched_matches_jax(L):
    p = TB.WIDE
    TB._run_parity("wide", "vmap", L, lambda c, k: tn.chunk_batched(
        c, k, K=p["K"], L=L, ic=p["ic"], H=p["H"], B=p["B"],
        chunk=p["chunk"], probes=TB.PROBES), 2, np.full(3, 10**6, np.int32))


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_host_chunk_batched_matches_chunk_batched_ref(kind):
    """Chunk after chunk from one start: every lane's leaves and the
    summary, the lanes that stop early frozen as the spec freezes them."""
    b = TB._batch(kind)
    if kind == "narrow":
        p, lanes = TB.NARROW, 4
        bc = tw.batch_consts_from_numpy(*TB._np_consts(b, p["ic"],
                                                       TB.MAX_CFG),
                                        device="cpu")
        kw = dict(K=p["K"], W=p["W"], ic=p["ic"], H=p["H"], B=p["B"],
                  chunk=p["chunk"], probes=TB.PROBES)
        start = tw.init_carry_batch(lanes, p["K"], tw.row_words(p["ic"]),
                                    p["H"], p["B"], 0, "cpu")
        host_fn, ref_fn = tw.chunk_batched, tw.chunk_batched_ref
    else:
        p, lanes = TB.WIDE, 3
        bc = tw.batch_consts_from_numpy(*TB._np_consts(b, p["ic"], 10**6),
                                        device="cpu")
        kw = dict(K=p["K"], L=2, ic=p["ic"], H=p["H"], B=p["B"],
                  chunk=p["chunk"], probes=TB.PROBES)
        start = tn.init_carry_batch(lanes, p["K"], 2, p["ic"], p["H"],
                                    p["B"], 0, "cpu")
        host_fn, ref_fn = tn.chunk_batched, tn.chunk_batched_ref
    host, ref = _clone(start), _clone(start)
    for step in range(3):
        host, hs = host_fn(bc, host, **kw)
        ref, rs = ref_fn(bc, ref, **kw)
        _same(host, hs, ref, rs, f"{kind} chunk {step}")


# --- the cancel word -------------------------------------------------------

def _cas_consts():
    enc = T32._encoded("cas")
    return tw.consts_from_numpy(*T32._np_consts(enc), device="cpu")


def test_a_set_cancel_word_ends_the_chunk_after_one_round():
    """A chunk whose cancel flag is already set runs one round and
    leaves every leaf as a one-round chunk of the spec does."""
    consts = _cas_consts()
    kw = dict(K=16, W=T32.W, ic=T32.IC, H=T32.H, B=T32.B, probes=T32.PROBES)
    start = tw.init_carry(16, tw.row_words(T32.IC), T32.H, T32.B, 0, "cpu")
    flag = tw.CancelFlag()
    flag.set()
    assert flag.is_set() and int(flag.word) == 1
    host, hs = tw.chunk(consts, _clone(start), chunk=T32.CHUNK,
                        cancel=flag, **kw)
    ref, rs = tw.chunk_ref(consts, _clone(start), chunk=1, **kw)
    assert int(hs[5]) == 1
    _same(host, hs, ref, rs, "cancelled")


def test_cancel_from_another_thread_ends_a_long_chunk_early():
    """The race's way: another thread sets the flag while the kernel
    runs a long chunk (the GIL released); the chunk ends within a round
    and its carry is the spec's for the rounds it ran."""
    import threading

    h = jsynth.cas_register_history(2000, n_procs=5, seed=42)
    enc = jencode.encode(jmodels.cas_register(), h)
    ic = 8
    consts = tw.consts_from_numpy(
        enc.inv, enc.ret, enc.opcode, enc.sufminret, enc.inv_info[:ic],
        enc.opcode_info[:ic], enc.table, enc.n_ok, enc.n_info, 10**8, "cpu")
    W = max(8, -(-enc.window_raw // 8) * 8)
    kw = dict(K=512, W=W, ic=ic, H=1 << 16, B=1 << 12, probes=4)
    start = tw.init_carry(512, tw.row_words(ic), 1 << 16, 1 << 12, 0, "cpu")
    flag = tw.CancelFlag()
    timer = threading.Timer(0.02, flag.set)
    timer.start()
    host, hs = tw.chunk(consts, _clone(start), chunk=100_000, cancel=flag,
                        **kw)
    timer.join()
    rounds = int(hs[5])
    assert 1 <= rounds < 100_000 and not hs[1] and hs[0] > 0
    ref, rs = tw.chunk_ref(consts, _clone(start), chunk=rounds, **kw)
    _same(host, hs, ref, rs, "cancelled by a thread")


# --- the build --------------------------------------------------------------

def _fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no host entry point bound."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_LIBS", {})


def test_no_host_compiler_raises_and_nothing_falls_back(monkeypatch,
                                                        tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    consts = _cas_consts()
    carry = tw.init_carry(2, tw.row_words(T32.IC), T32.H, T32.B, 0, "cpu")
    before = [t.clone() for t in carry]
    with pytest.raises(RuntimeError, match="host C\\+\\+ compiler"):
        tw.chunk(consts, carry, K=2, W=T32.W, ic=T32.IC, H=T32.H, B=T32.B,
                 chunk=T32.CHUNK, probes=T32.PROBES)
    assert all(torch.equal(a, b) for a, b in zip(carry, before))


def test_host_build_and_load_are_compiles_of_their_own_kind(monkeypatch,
                                                            tmp_path):
    """The first host chunk builds, loads and binds (no nvcc build, no
    CUDA load); a warm one compiles nothing."""
    _fresh_build(monkeypatch, tmp_path)
    consts = _cas_consts()
    kw = dict(K=2, W=T32.W, ic=T32.IC, H=T32.H, B=T32.B, chunk=4,
              probes=T32.PROBES)

    def carry():
        return tw.init_carry(2, tw.row_words(T32.IC), T32.H, T32.B, 0, "cpu")

    with guards.CompileGuard(name="cold") as g:
        tw.chunk(consts, carry(), **kw)
    rep = g.report()
    assert (rep["host_builds"], rep["host_loads"], rep["binds"]) == (1, 1, 1)
    assert (rep["builds"], rep["loads"]) == (0, 0)
    assert not list(tmp_path.glob("*.cu*")) and list(tmp_path.glob("*.so"))
    with guards.CompileGuard(max_compiles=0, name="warm"):
        tw.chunk(consts, carry(), **kw)


def test_processes_building_at_once_each_load_the_library(tmp_path):
    """Four processes build the host library into one empty directory at
    once; each loads a whole library, and one file is left."""
    code = ("import ctypes, sys; from pathlib import Path; "
            "from jepsen_tpu_torch.ops import _native as n; "
            "n.BUILD_DIR = Path(sys.argv[1]); n.build_host(); "
            "src = n.CSRC / 'wgl_host.cpp'; "
            "lib = ctypes.CDLL(str(n._host_lib_path(src))); "
            "lib.wgl_host_error_string.restype = ctypes.c_char_p; "
            "print(lib.wgl_host_error_string(1).decode())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert all(o.strip() == "bad arguments" for o, _ in outs)
    assert len(list(tmp_path.glob("libwgl_host-*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp*"))
