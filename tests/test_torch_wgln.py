"""Chunk-level parity of the PyTorch/CUDA port's wide-window search.

The same consts and carry go through the JAX package's `chunk_fn`
(`_build_searchN(accel=False, compact=False)`, with `pack` on and off)
and the port's `wgln.chunk_ref`; the summary and every carry leaf
(frontier, backlog, memo table, flags, stats, ring) must be
bit-identical: tolerance zero, everything is integer. Each case runs
several chunks, feeding JAX's output carry back into both, so it covers
a search that continues from its carry.

Three window layouts, each with its corpora padded into one shared
(n_pad, ic, S, O) shape so XLA:CPU compiles once per (layout, K, pack):

  * L=2 (W=64), 8 info slots: adversarial waves, valid and invalid;
    also run with a small memo table and backlog that force slot
    collisions, full probe windows, spill, refill and overflow;
  * L=3 (W=96): a long tail (`long_tail_history(120, seed=3)`);
  * L=8 (W=256), 48 info slots (two info words): a crash-heavy
    cas-register history with more than 32 crashed ops.

The `gpu` case holds the CUDA kernel against `chunk_ref` on the card,
on the same corpora.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu.ops.wgln import _build_searchN
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wgl32 as tw
from jepsen_tpu_torch.ops import wgln as tn

# the parity corpora are small: intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

CHUNK = 32              # rounds per chunk: searches span several chunks
N_CHUNKS = 3
PROBES = 4
K_BOTTOM = 32           # the CPU ladder's bottom bucket (derive_plan)

# layout -> (L, IC, bucket, {corpus: (model, history)})
LAYOUTS = {
    "L2": (2, 8, {"n_pad": 64, "ic_pad": 32, "S": 48, "O": 48}, lambda: {
        "wave-4x10": jsynth.adversarial_wave_history(4, width=10, span=4,
                                                     seed=3),
        "wave-3x12": jsynth.adversarial_wave_history(3, width=12, span=3,
                                                     seed=1),
        "wave-valid": jsynth.adversarial_wave_history(3, width=11, span=3,
                                                      seed=2, invalid=False),
    }),
    "L3": (3, 8, {"n_pad": 128, "ic_pad": 32, "S": 16, "O": 16}, lambda: {
        "long-tail": jsynth.long_tail_history(120, seed=3),
    }),
    "L8": (8, 48, {"n_pad": 384, "ic_pad": 64, "S": 16, "O": 32}, lambda: {
        "cas-crashy": jsynth.cas_register_history(600, n_procs=40, seed=1,
                                                  crash_p=0.1),
    }),
}
# memo table and backlog: roomy, and small enough to collide and spill
ROOMY = (1 << 16, 4096)
TIGHT = (1 << 10, 64)

_ENC: dict = {}


def _encoded(layout, name):
    if (layout, name) not in _ENC:
        L, ic, bucket, corpora = LAYOUTS[layout]
        enc = jwgl._apply_bucket(
            jencode.encode(jmodels.cas_register(), corpora()[name]), bucket)
        assert enc.window_raw <= 32 * L and enc.n_info <= ic
        assert twgl._packable(enc)   # pack=True is legal on every corpus
        assert (len(enc.inv), len(enc.inv_info), enc.table.shape) == (
            bucket["n_pad"], bucket["ic_pad"], (bucket["S"], bucket["O"]))
        _ENC[(layout, name)] = enc
    return _ENC[(layout, name)]


_JIT: dict = {}


def _jax_chunk(layout, K, pack, cap=ROOMY):
    key = (layout, K, pack, cap)
    if key not in _JIT:
        L, ic, bucket, _ = LAYOUTS[layout]
        H, B = cap
        init_fn, chunk_fn = _build_searchN(
            bucket["n_pad"], ic, bucket["S"], bucket["O"], K, H, B, CHUNK,
            PROBES, 32 * L, L, accel=False, compact=False, pack=pack)
        _JIT[key] = (init_fn, jax.jit(chunk_fn))
    return _JIT[key]


def _np_consts(enc, ic):
    return (enc.inv, enc.ret, enc.opcode, enc.sufminret, enc.inv_info[:ic],
            enc.opcode_info[:ic], enc.table, enc.n_ok, enc.n_info, 10**8)


def _jax_consts(enc, ic):
    a = _np_consts(enc, ic)
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


def _parity(layout, name, K, packs, cap=ROOMY):
    """Run up to N_CHUNKS chunks through JAX (each `pack`) and the port
    from the same carry; returns the JAX summaries."""
    L, ic, _, _ = LAYOUTS[layout]
    H, B = cap
    enc = _encoded(layout, name)
    consts_j = _jax_consts(enc, ic)
    consts_t = tw.consts_from_numpy(*_np_consts(enc, ic), device="cpu")
    init_fn, _ = _jax_chunk(layout, K, packs[0], cap)
    carry = init_fn(0)
    summaries = []
    for step in range(N_CHUNKS):
        leaves = [np.asarray(x) for x in carry]
        port, port_summary = tn.chunk_ref(
            consts_t, tw.carry_from_numpy(leaves, "cpu"), K=K, L=L, ic=ic,
            H=H, B=B, chunk=CHUNK, probes=PROBES)
        for pack in packs:
            _, chunk_jit = _jax_chunk(layout, K, pack, cap)
            out = chunk_jit(consts_j, tuple(jnp.asarray(x) for x in leaves))
            _assert_same(port, port_summary, *out,
                         f"{layout}/{name} K={K} pack={pack} chunk {step}")
        carry, summary = out
        s = np.asarray(summary)
        summaries.append(s)
        if s[1] or s[0] == 0:   # found, or the frontier is exhausted
            break
    return summaries


CASES = [("L2", "wave-4x10"), ("L2", "wave-3x12"), ("L2", "wave-valid"),
         ("L3", "long-tail"), ("L8", "cas-crashy")]


@pytest.mark.parametrize("layout,name", CASES)
def test_chunk_ref_matches_jax_chunk_fn(layout, name):
    _parity(layout, name, K_BOTTOM, (False, True))


@pytest.mark.parametrize("name", ["wave-4x10", "wave-valid"])
def test_chunk_ref_matches_jax_at_top_bucket(name):
    _parity("L2", name, 512, (False,))


def test_chunk_ref_matches_jax_with_collisions_spill_and_overflow():
    """A small memo table and backlog: full probe windows, spill,
    refill and backlog overflow, across chunks."""
    summaries = _parity("L2", "wave-4x10", K_BOTTOM, (False,), cap=TIGHT)
    assert len(summaries) == N_CHUNKS
    assert max(int(s[10]) for s in summaries) > 0     # backlog used
    assert bool(summaries[-1][2])                      # overflow flag


def test_corpora_cover_the_layouts():
    """The corpora reach what the layouts are for: windows past 32
    slots, a lane count of 8, two info words, and searches that span
    several chunks."""
    assert _encoded("L2", "wave-4x10").window_raw > 32
    assert _encoded("L3", "long-tail").window_raw > 64
    crashy = _encoded("L8", "cas-crashy")
    assert crashy.window_raw > 128 and crashy.n_info > 32
    init_fn, chunk_jit = _jax_chunk("L2", K_BOTTOM, False)
    s = np.asarray(chunk_jit(_jax_consts(_encoded("L2", "wave-4x10"), 8),
                             init_fn(0))[1])
    assert int(s[9]) == CHUNK and int(s[0]) > 0    # a full chunk, not done


def test_init_carry_matches_jax():
    init_fn, _ = _jax_chunk("L3", K_BOTTOM, False)
    want = [np.asarray(x) for x in init_fn(5)]
    H, B = ROOMY
    got = tw.carry_to_numpy(tn.init_carry(K_BOTTOM, 3, 8, H, B, 5, "cpu"))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_row_words_matches_jax_layout():
    for L, ic, C in ((2, 8, 5), (3, 32, 6), (8, 48, 12), (32, 256, 42)):
        assert tn.row_words(L, ic) == C


def test_wrapper_uses_chunk_ref_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    enc = _encoded("L2", "wave-3x12")
    consts = tw.consts_from_numpy(*_np_consts(enc, 8), device="cpu")
    H, B = ROOMY
    kw = dict(K=K_BOTTOM, L=2, ic=8, H=H, B=B, chunk=CHUNK, probes=PROBES)
    before = tn.chunk.launches
    c1, s1 = tn.chunk(consts, tn.init_carry(K_BOTTOM, 2, 8, H, B, 0, "cpu"),
                      **kw)
    c2, s2 = tn.chunk_ref(consts,
                          tn.init_carry(K_BOTTOM, 2, 8, H, B, 0, "cpu"), **kw)
    assert tn.chunk.launches == before
    assert torch.equal(s1, s2)
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))


def test_launch_checks_reject_bad_inputs():
    """The wrapper's checks before a launch (they run on any device)."""
    enc = _encoded("L2", "wave-3x12")
    consts = tw.consts_from_numpy(*_np_consts(enc, 8), device="cpu")
    H, B = ROOMY
    kw = dict(K=4, L=2, ic=8, H=H, B=B, chunk=CHUNK, probes=PROBES)
    good = tn.init_carry(4, 2, 8, H, B, 0, "cpu")
    tn._check_launch(consts, good, **kw)
    bad_cases = [
        (good, dict(kw, L=1)),
        (good, dict(kw, L=33)),
        (good, dict(kw, L=3)),                       # rows are 5 words
        (good, dict(kw, H=H - 1)),
        (good, dict(kw, ic=9)),                      # info tables hold 8
        (good[:2] + (good[2][:, :4].contiguous(),) + good[3:], kw),
        (good[:1] + (good[1].to(torch.int64),) + good[2:], kw),
    ]
    for carry, args in bad_cases:
        with pytest.raises(ValueError):
            tn._check_launch(consts, carry, **args)


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [ROOMY, TIGHT], ids=["roomy", "tight"])
@pytest.mark.parametrize("K", [K_BOTTOM, 512])
@pytest.mark.parametrize("layout,name", CASES)
def test_kernel_matches_chunk_ref_on_card(cuda_device, layout, name, K, cap):
    L, ic, _, _ = LAYOUTS[layout]
    H, B = cap
    enc = _encoded(layout, name)
    consts = tw.consts_from_numpy(*_np_consts(enc, ic), device=cuda_device)
    carry = tn.init_carry(K, L, ic, H, B, 0, cuda_device)
    kw = dict(K=K, L=L, ic=ic, H=H, B=B, chunk=CHUNK, probes=PROBES)
    for step in range(N_CHUNKS):
        ref_in = tuple(t.clone() for t in carry)
        launches = tn.chunk.launches
        carry, summary = tn.chunk(consts, carry, **kw)
        torch.cuda.synchronize()
        assert tn.chunk.launches == launches + 1
        ref, ref_summary = tn.chunk_ref(consts, ref_in, **kw)
        assert torch.equal(summary, ref_summary), (name, K, step)
        for i, (a, b) in enumerate(zip(carry, ref)):
            assert torch.equal(a, b), (name, K, step, i)
        if int(summary[1]) or int(summary[0]) == 0:
            break
