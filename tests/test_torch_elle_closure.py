"""Kernel-level parity of the port's Elle closures.

The same padded edge columns go through the JAX package's
`make_closure_kernel` (f32 on the CPU, jitted as `tests/test_elle_tpu.py`
runs it) and `make_packed_closure_kernel`, and through the port's
`closure_ref` and `packed_closure_ref`: labels, rw-query answers, the
per-squaring reach counts and the number of squarings run must be
bit-identical (tolerance zero: everything is 0/1 or an integer count).
The packed closure must also equal the dense one, as the reference's
kernels equal each other. Graphs are made with numpy from a seed and
padded into a few shared shapes so XLA:CPU compiles each kernel once
per shape. The `gpu` cases hold the CUDA kernels against their plain
versions on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.elle import tpu as jtpu
from jepsen_tpu_torch.elle import graph as tgraph
from jepsen_tpu_torch.elle import tpu as ttpu

torch.set_num_threads(1)

S = len(ttpu.SUBSETS)
# (n_pad, e_pad, q_pad) buckets shared by every case
SHAPES = {128: (128, 512, 256), 256: (256, 1024, 256)}
TYPES = (tgraph.WW, tgraph.WR, tgraph.RW, tgraph.REALTIME, tgraph.PROCESS)


def random_graph(seed, n, e):
    rng = np.random.default_rng(seed)
    g = tgraph.DepGraph()
    for i in range(n):
        g.add_node(i)
    for s, d, t in zip(rng.integers(0, n, e), rng.integers(0, n, e),
                       rng.choice(TYPES, e)):
        g.add_edge(int(s), int(d), int(t))
    return g


def path_graph(n, typ=tgraph.WW):
    """0 -> 1 -> ... -> n-1 plus one rw edge back: the closure needs
    every squaring to reach the far end."""
    g = tgraph.DepGraph()
    for i in range(n - 1):
        g.add_edge(i, i + 1, typ)
    g.add_edge(n - 1, 0, tgraph.RW)
    return g


def inputs(g, n_pad):
    """Padded numpy inputs of both kernels, as `cycle_queries` builds
    them, at the shared bucket of n_pad."""
    _, n, src, dst, w, q_src, q_dst, _ = ttpu._graph_arrays(
        g, ttpu.SUBSETS, tgraph.RW)
    _, e_pad, q_pad = SHAPES[n_pad]
    assert n + 2 <= n_pad and len(src) <= e_pad and len(q_src) <= q_pad
    w_p = np.zeros((S, e_pad), np.float32)
    w_p[:, :w.shape[1]] = w
    return dict(src=ttpu._pad(src, e_pad, 0), dst=ttpu._pad(dst, e_pad, 0),
                w=w_p, q_src=ttpu._pad(q_src, q_pad, n_pad - 1),
                q_dst=ttpu._pad(q_dst, q_pad, n_pad - 2),
                r0=ttpu.packed_r0(src, dst, w, n_pad))


def iters_for(n_pad):
    return max(1, math.ceil(math.log2(n_pad)))


_JIT: dict = {}


def jax_dense(n_pad, a):
    if ("dense", n_pad) not in _JIT:
        _JIT["dense", n_pad] = jax.jit(jtpu.make_closure_kernel(
            n_pad, S, iters_for(n_pad), jnp.float32))
    out = _JIT["dense", n_pad](a["src"], a["dst"], a["w"], a["q_src"],
                               a["q_dst"])
    return tuple(np.asarray(x) for x in out)


def jax_packed(n_pad, a):
    if ("packed", n_pad) not in _JIT:
        _JIT["packed", n_pad] = jax.jit(jtpu.make_packed_closure_kernel(
            n_pad, S, iters_for(n_pad)))
    out = _JIT["packed", n_pad](a["r0"], a["q_src"], a["q_dst"])
    return tuple(np.asarray(x) for x in out)


def port_dense(n_pad, a, fn=ttpu.closure_ref, device="cpu"):
    t = {k: torch.from_numpy(a[k]).to(device)
         for k in ("src", "dst", "w", "q_src", "q_dst")}
    return fn(t["src"], t["dst"], t["w"], t["q_src"], t["q_dst"],
              n_pad=n_pad, iters=iters_for(n_pad))


def port_packed(n_pad, a, fn=ttpu.packed_closure_ref, device="cpu"):
    return fn(torch.from_numpy(a["r0"].view(np.int32)).to(device),
              torch.from_numpy(a["q_src"]).to(device),
              torch.from_numpy(a["q_dst"]).to(device),
              n_pad=n_pad, iters=iters_for(n_pad))


def assert_same(port, ref):
    labels, closed, counts, iters_run = port
    j_labels, j_closed, j_counts, j_iters = ref
    assert int(iters_run) == int(j_iters)
    np.testing.assert_array_equal(labels.cpu().numpy(), j_labels)
    np.testing.assert_array_equal(closed.cpu().numpy(), j_closed)
    # rows past iters_run are zero in both
    np.testing.assert_array_equal(counts.cpu().numpy(), j_counts)


CASES = [("random", 128, lambda: random_graph(0, 60, 150)),
         ("random", 128, lambda: random_graph(1, 120, 90)),
         ("random", 256, lambda: random_graph(2, 250, 700)),
         ("random", 256, lambda: random_graph(3, 200, 250)),
         ("random", 256, lambda: random_graph(4, 5, 12)),
         ("empty", 128, lambda: random_graph(5, 1, 0)),
         ("no-rw", 256, lambda: path_graph(120, tgraph.WR)),
         ("path", 256, lambda: path_graph(250))]
IDS = [f"{name}-{i}" for i, (name, _, _) in enumerate(CASES)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_closure_ref_matches_jax(case):
    _, n_pad, make = case
    a = inputs(make(), n_pad)
    assert_same(port_dense(n_pad, a), jax_dense(n_pad, a))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_packed_closure_ref_matches_jax(case):
    _, n_pad, make = case
    a = inputs(make(), n_pad)
    ref = jax_packed(n_pad, a)
    assert_same(port_packed(n_pad, a), ref)
    # and the two closures are one function
    assert_same(port_dense(n_pad, a), ref)


def test_path_runs_every_squaring():
    a = inputs(path_graph(250), 256)
    _, _, counts, iters_run = port_dense(256, a)
    assert iters_run == iters_for(256) == 8
    # the widest subset's reach grows at every squaring
    widest = counts[:, -1].tolist()
    assert widest == sorted(set(widest))


def test_bits_round_trip():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2**32, size=(3, 64, 2), dtype=np.uint64)
    r = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    bits = ttpu.unpack_bits(r)
    assert bits.shape == (3, 64, 64)
    assert bool(bits[0, 0, 5]) == bool((int(words[0, 0, 0]) >> 5) & 1)
    assert torch.equal(ttpu.pack_bits(bits), r)


def test_cpu_tensors_take_the_plain_version():
    a = inputs(random_graph(0, 60, 150), 128)
    before = (ttpu.closure.launches, ttpu.packed_closure.launches)
    assert_same(port_dense(128, a, fn=ttpu.closure), jax_dense(128, a))
    assert_same(port_packed(128, a, fn=ttpu.packed_closure),
                jax_packed(128, a))
    assert (ttpu.closure.launches, ttpu.packed_closure.launches) == before


def test_wrappers_refuse_other_devices():
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ttpu.closure(z, z, z, z, z, n_pad=128, iters=7)
    with pytest.raises(ValueError):
        ttpu.packed_closure(z, z, z, n_pad=128, iters=7)
    # indices a kernel dereferences are checked before any launch
    idx = torch.tensor([0, 5, 127], dtype=torch.int32)
    ttpu._check_range("t", idx, 128)
    for bad in (128, -1):
        with pytest.raises(ValueError):
            ttpu._check_range("t", torch.cat([idx, idx.new_tensor([bad])]),
                              128)


def test_native_table_binds_every_entry_point():
    """Every `extern "C" int` entry point under csrc/ is in
    `_native.KERNELS` with its source and its pointer and int counts,
    and every one that takes nothing (an exported size) in
    `_native.CONSTANTS` with its source."""
    import re
    from pathlib import Path

    from jepsen_tpu_torch.ops import _native

    # the WGL kernels take their parameters from an argument-list macro
    macros = {m: body.replace("\\", " ") for m, body in re.findall(
        r"#define (WGL_\w+_ARGS)((?:.*\\\n)*.*)",
        (Path(_native.CSRC) / "wgl_common.cuh").read_text())}
    assert set(macros) == {"WGL_CHUNK_ARGS", "WGL_BATCHED_ARGS"}
    found, sizes = {}, {}
    for src in sorted(Path(_native.CSRC).glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            if not params.strip():
                sizes[name] = src.stem
                continue
            found[name] = src.stem
            stem, n_ptrs, n_ints = _native.KERNELS[name]
            assert stem == src.stem
            for macro, body in macros.items():
                params = params.replace(macro, body)
            args = [a.strip() for a in params.split(",")]
            assert args[-1].replace(" ", "") == "void*stream"
            assert sum("*" in a for a in args[:-1]) == n_ptrs, name
            assert sum("*" not in a for a in args[:-1]) == n_ints, name
    assert found.keys() == _native.KERNELS.keys()
    assert sizes == _native.CONSTANTS



def test_dense_square_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(12)
    r = torch.from_numpy((rng.random((S, 128, 128)) < 0.05)
                         .astype(np.float32))
    cnt, want_cnt = (torch.full((S,), 7, dtype=torch.int32)
                     for _ in range(2))
    before = ttpu.closure.launches
    got = ttpu.dense_square(r, cnt)
    want = ttpu.dense_square_ref(r, want_cnt)
    assert ttpu.closure.launches == before
    assert torch.equal(got, want) and torch.equal(cnt, want_cnt)
    with pytest.raises(ValueError):
        ttpu.dense_square(r.to("meta"), cnt.to("meta"))


class _NoLock:
    def __enter__(self):
        raise AssertionError("the launch fast path took the lock")

    def __exit__(self, *exc):
        return False


def test_launch_fast_path_is_a_table_lookup(monkeypatch):
    """A bound entry point launches from `_native._LIBS` alone: no
    lock, the argument counts checked, ints handed to ctypes as given,
    and a nonzero return code raised with the library's error text."""
    from jepsen_tpu_torch.ops import _native

    calls = []

    def fn(*args):
        calls.append(args)
        return calls[-1][-2]   # the last int plays the return code

    def err(rc):
        return f"error {rc}".encode()

    monkeypatch.setattr(_native, "_LIBS",
                        {"elle_closure_square": (fn, err, 3, 2)})
    monkeypatch.setattr(_native, "_LOCK", _NoLock())
    _native.launch("elle_closure_square", (1, 2, 3), (np.int64(3), 0), 99)
    assert calls == [(1, 2, 3, np.int64(3), 0, 99)]
    with pytest.raises(ValueError):
        _native.launch("elle_closure_square", (1, 2), (3, 0), 99)
    with pytest.raises(ValueError):
        _native.launch("elle_closure_square", (1, 2, 3), (3,), 99)
    with pytest.raises(RuntimeError, match=r"error 700 \(cuda 700\)"):
        _native.launch("elle_closure_square", (1, 2, 3), (3, 700), 99)
    assert len(calls) == 2


def test_launch_helpers_take_a_device_or_its_index():
    from jepsen_tpu_torch import util

    assert util._index(3) == 3
    assert util._index(torch.device("cuda", 2)) == 2

# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernels_match_plain_on_card(cuda_device, case):
    _, n_pad, make = case
    a = inputs(make(), n_pad)
    ref = tuple(x if isinstance(x, int) else x.cpu().numpy()
                for x in port_dense(n_pad, a))
    launches = ttpu.closure.launches
    got = port_dense(n_pad, a, fn=ttpu.closure, device=cuda_device)
    torch.cuda.synchronize()
    assert ttpu.closure.launches == launches + got[3] + 1
    assert_same(got, ref)
    launches = ttpu.packed_closure.launches
    got = port_packed(n_pad, a, fn=ttpu.packed_closure, device=cuda_device)
    torch.cuda.synchronize()
    assert ttpu.packed_closure.launches == launches + got[3] + 1
    assert_same(got, ref)



def random_reach(seed, n_pad, density):
    """A (S, n_pad, n_pad) 0/1 float32 reach with ones at `density`,
    made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    r = np.zeros((S, n_pad, n_pad), np.float32)
    for s in range(S):
        r[s] = rng.random((n_pad, n_pad), dtype=np.float32) < density
    return torch.from_numpy(r)


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.001, 0.3])
@pytest.mark.parametrize("n_pad", [128, 384, 4096, 8320])
def test_dense_square_matches_plain_on_card(cuda_device, n_pad, density):
    """The wgmma squaring against `dense_square_ref` (f32): every entry
    of the output and every subset's count, at one tile, an odd tile
    count (3), the 3k main path's n_pad and the largest the route
    takes."""
    r = random_reach(n_pad + int(density * 1000), n_pad, density).to(
        cuda_device)
    want_cnt = torch.zeros(S, dtype=torch.int32, device=cuda_device)
    want = ttpu.dense_square_ref(r, want_cnt)
    cnt = torch.zeros(S, dtype=torch.int32, device=cuda_device)
    before = ttpu.closure.launches
    got = ttpu.dense_square(r.to(torch.bfloat16), cnt)
    torch.cuda.synchronize()
    assert ttpu.closure.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == r.shape
    assert torch.equal(got.float(), want)
    assert torch.equal(cnt, want_cnt)


@pytest.mark.gpu
def test_closure_chain_matches_ref_on_card(cuda_device):
    """Three squarings through `closure` against `closure_ref`: the
    reach after each squaring and every output."""
    a = inputs(random_graph(9, 250, 400), 256)
    keep, bad = [], []
    got = port_dense(256, a, fn=lambda *x, **kw: ttpu.closure(
        *x, **dict(kw, iters=3), on_square=lambda i, r: keep.append(
            r.clone())), device=cuda_device)
    ref = port_dense(256, a, fn=lambda *x, **kw: ttpu.closure_ref(
        *x, **dict(kw, iters=3), on_square=lambda i, r: bad.append(i) if
        not torch.equal(r > 0, keep[i].cpu() != 0) else None))
    assert len(keep) == got[3] == ref[3] and not bad
    for x, y in zip(got[:3], ref[:3]):
        assert torch.equal(x.cpu(), y)


@pytest.mark.gpu
def test_launch_helpers_on_card(cuda_device):
    from jepsen_tpu_torch import util

    dev = torch.device("cuda", torch.cuda.current_device())
    assert util.raw_stream(dev) == torch.cuda.current_stream(dev).cuda_stream
    s = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(s):
        assert util.raw_stream(dev) == s.cuda_stream
    with util.on_device(dev):
        assert torch.cuda.current_device() == dev.index
