"""Chunk-level parity of the PyTorch/CUDA port's wgl32 search.

The same consts and carry go through the JAX package's `chunk_fn`
(`_build_search32(accel=False, depth=1)`, with `pack` on and off) and
the port's `chunk_ref`; the summary and every carry leaf (frontier,
backlog, memo table, flags, stats, ring) must be bit-identical —
tolerance zero, everything is integer. Each case runs several chunks of
`CHUNK` rounds, feeding JAX's output carry back into both, so it covers
a search that continues across chunks; the small memo table and
backlog force slot collisions, full probe windows, spill, refill and
backlog overflow.

Every corpus is padded into one shared (n_pad, ic, S, O) shape so
XLA:CPU compiles each (K, pack) pair once. The `gpu` case holds the
CUDA kernel against `chunk_ref` on the card, on the same corpora.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import adapt as jadapt
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.ops.wgl32 import _build_search32
from jepsen_tpu_torch.ops import adapt as tadapt
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wgl32 as tw

# the parity corpora are small: intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

W, IC = 24, 16          # materialized window and info slots
H, B = 1 << 12, 64      # small memo table and backlog
CHUNK = 64              # rounds per chunk: searches span several chunks
N_CHUNKS = 3
PROBES = 4
BUCKET = {"n_pad": 192, "ic_pad": 32, "S": 16, "O": 32}


def _corpora():
    reg = jsynth.cas_register_history(150, n_procs=4, seed=11,
                                      crash_p=0.04, fs=("read", "write"))
    return {
        "register": (jmodels.register(), reg),
        "cas": (jmodels.cas_register(),
                jsynth.cas_register_history(150, n_procs=5, seed=3,
                                            crash_p=0.05)),
        "cas-invalid": (jmodels.cas_register(),
                        jsynth.cas_register_history(120, n_procs=5, seed=8,
                                                    crash_p=0.05,
                                                    lie_p=0.03)),
        "mutex": (jmodels.mutex(), jsynth.mutex_history(120, seed=5)),
    }


_ENC: dict = {}


def _encoded(name):
    if name not in _ENC:
        model, hist = _corpora()[name]
        enc = jwgl._apply_bucket(jencode.encode(model, hist), BUCKET)
        assert enc.window_raw <= W and enc.n_info <= IC
        assert twgl._packable(enc)   # pack=True is legal on every corpus
        assert (len(enc.inv), enc.table.shape) == (
            BUCKET["n_pad"], (BUCKET["S"], BUCKET["O"]))
        _ENC[name] = enc
    return _ENC[name]


_JIT: dict = {}


def _jax_chunk(K, pack):
    if (K, pack) not in _JIT:
        init_fn, chunk_fn = _build_search32(
            BUCKET["n_pad"], IC, BUCKET["S"], BUCKET["O"], K, H, B, CHUNK,
            PROBES, W=W, accel=False, depth=1, pack=pack)
        _JIT[(K, pack)] = (init_fn, jax.jit(chunk_fn))
    return _JIT[(K, pack)]


def _np_consts(enc):
    return (enc.inv, enc.ret, enc.opcode, enc.sufminret, enc.inv_info[:IC],
            enc.opcode_info[:IC], enc.table, enc.n_ok, enc.n_info, 10**8)


def _jax_consts(enc):
    a = _np_consts(enc)
    return tuple(jnp.asarray(x) for x in a[:7]) + tuple(
        jnp.int32(x) for x in a[7:])


def _assert_same(port_carry, port_summary, jax_out, jax_summary, what):
    np.testing.assert_array_equal(port_summary.cpu().numpy(),
                                  np.asarray(jax_summary),
                                  err_msg=f"{what}: summary")
    for i, (a, b) in enumerate(zip(tw.carry_to_numpy(port_carry), jax_out)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("K", [2, 16, 512])
@pytest.mark.parametrize("name", ["register", "cas", "cas-invalid",
                                  "mutex"])
def test_chunk_ref_matches_jax_chunk_fn(name, K):
    enc = _encoded(name)
    consts_j = _jax_consts(enc)
    consts_t = tw.consts_from_numpy(*_np_consts(enc), device="cpu")
    init_fn, _ = _jax_chunk(K, False)
    carry = init_fn(0)
    n_chunks = 1 if K == 512 else N_CHUNKS
    for step in range(n_chunks):
        leaves = [np.asarray(x) for x in carry]
        port, port_summary = tw.chunk_ref(
            consts_t, tw.carry_from_numpy(leaves, "cpu"), K=K, W=W, ic=IC,
            H=H, B=B, chunk=CHUNK, probes=PROBES)
        outs = {}
        for pack in (False, True):
            _, chunk_jit = _jax_chunk(K, pack)
            outs[pack] = chunk_jit(consts_j, tuple(jnp.asarray(x)
                                                   for x in leaves))
            _assert_same(port, port_summary, *outs[pack],
                         f"{name} K={K} pack={pack} chunk {step}")
        carry, summary = outs[False]
        s = np.asarray(summary)
        if s[1] or s[0] == 0:   # found, or the frontier is exhausted
            break


def test_corpora_cover_spill_overflow_and_multichunk():
    """The parity corpora reach every path of the round: a search
    spanning several chunks, backlog spill, and backlog overflow."""
    enc = _encoded("cas-invalid")
    init_fn, chunk_jit = _jax_chunk(2, False)
    consts_j = _jax_consts(enc)
    carry = init_fn(0)
    bk_peak = 0
    for _ in range(N_CHUNKS):
        carry, summary = chunk_jit(consts_j, carry)
        s = np.asarray(summary)
        bk_peak = max(bk_peak, int(s[10]))
    assert int(s[9]) == N_CHUNKS * CHUNK   # rounds_total: every chunk full
    assert bk_peak > 0
    _, chunk16 = _jax_chunk(16, False)
    _, summary = chunk16(consts_j, _jax_chunk(16, False)[0](0))
    assert bool(np.asarray(summary)[2])      # overflow flag


def test_init_carry_matches_jax():
    init_fn, _ = _jax_chunk(16, False)
    want = [np.asarray(x) for x in init_fn(3)]
    got = tw.carry_to_numpy(tw.init_carry(16, tw.row_words(IC), H, B, 3,
                                          "cpu"))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_carry_roundtrip_is_bit_exact():
    init_fn, chunk_jit = _jax_chunk(16, False)
    out, _ = chunk_jit(_jax_consts(_encoded("cas")), init_fn(0))
    leaves = [np.asarray(x) for x in out]
    back = tw.carry_to_numpy(tw.carry_from_numpy(leaves, "cpu"))
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k_new", [64, 4])
def test_migrate_frontier_matches_jax(k_new):
    init_fn, chunk_jit = _jax_chunk(16, False)
    out, _ = chunk_jit(_jax_consts(_encoded("mutex")), init_fn(0))
    leaves = [np.asarray(x) for x in out]
    want = jadapt.migrate_frontier(tuple(jnp.asarray(x) for x in leaves),
                                   k_new)
    got = tadapt.migrate_frontier(tw.carry_from_numpy(leaves, "cpu"), k_new)
    for a, b in zip(tw.carry_to_numpy(got), want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_wrapper_uses_chunk_ref_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    enc = _encoded("cas")
    consts = tw.consts_from_numpy(*_np_consts(enc), device="cpu")
    before = tw.chunk.launches
    c1, s1 = tw.chunk(consts, tw.init_carry(2, tw.row_words(IC), H, B, 0,
                                            "cpu"),
                      K=2, W=W, ic=IC, H=H, B=B, chunk=CHUNK, probes=PROBES)
    c2, s2 = tw.chunk_ref(consts, tw.init_carry(2, tw.row_words(IC), H, B,
                                                0, "cpu"),
                          K=2, W=W, ic=IC, H=H, B=B, chunk=CHUNK,
                          probes=PROBES)
    assert tw.chunk.launches == before
    assert torch.equal(s1, s2)
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))


def test_launch_checks_reject_bad_inputs():
    """The wrapper's checks before a launch (they run on any device)."""
    enc = _encoded("cas")
    consts = tw.consts_from_numpy(*_np_consts(enc), device="cpu")
    kw = dict(K=2, W=W, ic=IC, H=H, B=B, chunk=CHUNK, probes=PROBES)
    good = tw.init_carry(2, tw.row_words(IC), H, B, 0, "cpu")
    tw._check_launch(consts, good, **kw)
    bad_cases = [
        (good, dict(kw, W=33)),
        (good, dict(kw, H=H - 1)),
        (good, dict(kw, probes=0)),
        (good, dict(kw, K=4)),                       # fr is (2, C)
        (good[:1] + (good[1].to(torch.int64),) + good[2:], kw),
        (good[:4] + (good[4].t().contiguous().t(),) + good[5:], kw),
    ]
    for carry, args in bad_cases:
        with pytest.raises(ValueError):
            tw._check_launch(consts, carry, **args)


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("K", [2, 16, 512])
@pytest.mark.parametrize("name", ["register", "cas", "cas-invalid",
                                  "mutex"])
def test_kernel_matches_chunk_ref_on_card(cuda_device, name, K):
    enc = _encoded(name)
    consts = tw.consts_from_numpy(*_np_consts(enc), device=cuda_device)
    carry = tw.init_carry(K, tw.row_words(IC), H, B, 0, cuda_device)
    for step in range(N_CHUNKS):
        ref_in = tuple(t.clone() for t in carry)
        launches = tw.chunk.launches
        carry, summary = tw.chunk(consts, carry, K=K, W=W, ic=IC, H=H, B=B,
                                  chunk=CHUNK, probes=PROBES)
        torch.cuda.synchronize()
        assert tw.chunk.launches == launches + 1
        ref, ref_summary = tw.chunk_ref(consts, ref_in, K=K, W=W, ic=IC,
                                        H=H, B=B, chunk=CHUNK,
                                        probes=PROBES)
        assert torch.equal(summary, ref_summary), (name, K, step)
        for i, (a, b) in enumerate(zip(carry, ref)):
            assert torch.equal(a, b), (name, K, step, i)
        if int(summary[1]) or int(summary[0]) == 0:
            break
