"""The tensor-core squaring of the port's packed and sharded Elle
closures (`csrc/elle_bitmm.cuh`) and its plain versions.

On the CPU: the kernel path's plain helpers against numpy (the bit
transpose and the tile flags at n_pad 128, 384 and 1024, over seeds),
the product through the transpose with its tile skipping (`bitmm_ref`)
against `packed_square_ref` and `sharded_square_ref` at 1, 2 and 4
shards (a one-word block included), bit for bit with its counts, and
whole closures squared through `bitmm_ref` against the JAX package's
`make_packed_closure_kernel` (labels, rw answers, counts, squarings:
tolerance zero, everything is 0/1 or an integer count).

The `gpu` cases hold `elle_packed_square` and `elle_sharded_square` bit
for bit, outputs and counts, against `packed_square_ref` and
`sharded_square_ref` at densities 0 to 1 and n_pad 128 to 16384, the
kernels' scratch against the plain transpose and flags, and a whole
closure chain against `packed_closure_ref`.
"""

import jax
import numpy as np
import pytest
import torch

from jepsen_tpu.elle import tpu as jtpu
from jepsen_tpu_torch.elle import graph as tgraph
from jepsen_tpu_torch.elle import tpu as ttpu

torch.set_num_threads(1)

S = len(ttpu.SUBSETS)
TYPES = (tgraph.WW, tgraph.WR, tgraph.RW, tgraph.REALTIME, tgraph.PROCESS)


def words_np(seed, shape, density):
    """uint32 words of the given shape whose bits are set at `density`,
    made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    bits = rng.random(shape + (32,)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(
        np.uint32)[..., 0]


def as_i32(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def unpack_np(words):
    """(..., w) uint32 -> (..., 32 w) bools, bit b of word v at 32 v + b."""
    b = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return b.astype(bool)


def pack_np(bits):
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)


def reach(seed, n_pad, density):
    """An (S, n_pad, n_pad / 32) packed reach; density "upper" is an
    upper-triangular reach at 0.5, so whole tiles hold no bit."""
    if density == "upper":
        rng = np.random.default_rng(seed)
        bits = (rng.random((S, n_pad, n_pad)) < 0.5) & np.triu(
            np.ones((n_pad, n_pad), bool))[None]
        return as_i32(pack_np(bits))
    return as_i32(words_np(seed, (S, n_pad, n_pad // 32), density))


def popcounts(x):
    return torch.tensor([int(np.unpackbits(
        x[s].numpy().view(np.uint8)).sum()) for s in range(x.shape[0])],
        dtype=torch.int32)


def flags_of(a, t):
    return (ttpu.tile_flags_ref(a, ttpu.BITMM_ROWS),
            ttpu.tile_flags_ref(t, ttpu.BITMM_COLS))


def bitmm(a, b, cnt):
    """The plain product through the transpose: `bitmm_ref` over B's bit
    transpose and both flag planes."""
    t = ttpu.bit_transpose_ref(b)
    return ttpu.bitmm_ref(a, t, *flags_of(a, t), cnt)


# --- the plain helpers against numpy -----------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_pad,w", [(128, 4), (128, 1), (384, 12), (384, 3),
                                     (1024, 32), (1024, 8)])
def test_bit_transpose_ref_matches_numpy(n_pad, w, seed):
    b = words_np(seed, (S, n_pad, w), 0.3)
    want = pack_np(np.ascontiguousarray(unpack_np(b).transpose(0, 2, 1)))
    got = ttpu.bit_transpose_ref(as_i32(b))
    assert got.shape == (S, 32 * w, n_pad // 32) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rows", [ttpu.BITMM_ROWS, ttpu.BITMM_COLS])
@pytest.mark.parametrize("n_pad", [128, 384, 1024])
def test_tile_flags_ref_matches_numpy(n_pad, rows, seed):
    """Sparse words (one in 4000 bits set, so some tiles are empty) and a
    plane whose edge cuts its last tiles."""
    W = n_pad // 32
    x = words_np(seed, (S, n_pad, W), 2.5e-4)
    got = ttpu.tile_flags_ref(as_i32(x), rows)
    kc = ttpu.BITMM_K_WORDS
    want = np.zeros((S, -(-n_pad // rows), -(-W // kc)), np.uint8)
    for s in range(S):
        for r in range(want.shape[1]):
            for k in range(want.shape[2]):
                want[s, r, k] = x[s, r * rows:(r + 1) * rows,
                                  k * kc:(k + 1) * kc].any()
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() or n_pad == 128


@pytest.mark.parametrize("n_pad,w", [(2048, 64), (2048, 16), (384, 3)])
def test_transpose_flags_are_source_tiles(n_pad, w):
    """A tile of the transpose (256 rows x 32 words) holds a bit exactly
    when the source's 1024 rows x 8 words behind it do:
    `bitmm_flags_ref` reads the T flags off B without transposing."""
    a = as_i32(words_np(5, (S, n_pad, n_pad // 32), 2e-6))
    b = as_i32(words_np(6, (S, n_pad, w), 2e-6))
    t = ttpu.bit_transpose_ref(b)
    fa, fb = ttpu.bitmm_flags_ref(a, b)
    assert torch.equal(fa, ttpu.tile_flags_ref(a, ttpu.BITMM_ROWS))
    assert torch.equal(fb, ttpu.tile_flags_ref(t, ttpu.BITMM_COLS))
    assert 0 < int(fb.sum()) < fb.numel() or n_pad == 384


def test_bitmm_steps_counts_the_flagged_stages():
    """`occupancy.bitmm_steps` against a count stage by stage: rows x the
    columns inside the output x the k bits inside the plane, for every
    stage both flags set, at a plane the edges cut (n_pad 1152: a last
    k stage of 128 bits; 96 output columns)."""
    from jepsen_tpu_torch import occupancy

    rng = np.random.default_rng(4)
    n_pad, n_cols = 1152, 96
    fa = rng.random((S, n_pad // 128, 2)) < 0.5
    fb = rng.random((S, 1, 2)) < 0.7
    want = 0
    for s in range(S):
        for i in range(fa.shape[1]):
            for k in range(2):
                if fa[s, i, k] and fb[s, 0, k]:
                    want += 128 * n_cols * (1024 if k == 0 else 128)
    assert occupancy.bitmm_steps(fa, fb, n_pad=n_pad, n_cols=n_cols) == want
    cost = occupancy.packed_square_cost(S, n_pad, 5, steps=want)
    assert cost["tc_ops"] == 2 * want and cost["ops"] == 5 * n_pad // 32


# --- the product through the transpose ------------------------------------------

DENSITIES = [0.0, 1e-3, 0.05, 0.5, 1.0, "upper"]


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n_pad", [128, 384, 1024])
def test_bitmm_ref_equals_packed_square_ref(n_pad, density):
    r = reach(n_pad, n_pad, density)
    want_cnt = torch.zeros(S, dtype=torch.int32)
    want = ttpu.packed_square_ref(r, want_cnt)
    cnt = torch.full((S,), -1, dtype=torch.int32)
    got = bitmm(r, r, cnt)
    assert torch.equal(got, want)
    assert torch.equal(cnt, want_cnt)
    assert torch.equal(cnt, popcounts(want))


@pytest.mark.parametrize("density", [1e-3, 0.05, "upper"])
@pytest.mark.parametrize("ns", [1, 2, 4])
@pytest.mark.parametrize("n_pad", [128, 384, 1024])
def test_bitmm_ref_equals_sharded_square_ref(n_pad, ns, density):
    """Each shard's block through its own transpose (32 w_loc rows; one
    word a shard at n_pad 128 over 4 shards)."""
    full = reach(n_pad + ns, n_pad, density)
    for k, blk in enumerate(ttpu.shard_blocks(full, ns)):
        want_cnt = torch.zeros(S, dtype=torch.int32)
        want = ttpu.sharded_square_ref(full, blk, want_cnt)
        cnt = torch.zeros(S, dtype=torch.int32)
        got = bitmm(full, blk, cnt)
        assert got.shape == blk.shape
        assert torch.equal(got, want), k
        assert torch.equal(cnt, want_cnt), k


def test_skipped_tiles_are_exactly_the_empty_ones():
    """`bitmm_ref` with every flag set equals it with the real flags:
    a skipped stage holds only zero terms (two k stages at n_pad 2048:
    the upper reach's lower rows have no bit in the first)."""
    r = reach(3, 2048, "upper")
    t = ttpu.bit_transpose_ref(r)
    fa, fb = flags_of(r, t)
    assert 0 < int(fa.sum()) < fa.numel()
    c1, c2 = (torch.zeros(S, dtype=torch.int32) for _ in range(2))
    assert torch.equal(ttpu.bitmm_ref(r, t, fa, fb, c1),
                       ttpu.bitmm_ref(r, t, torch.ones_like(fa),
                                      torch.ones_like(fb), c2))
    assert torch.equal(c1, c2)


# --- whole closures against the JAX package -------------------------------------

def random_graph(seed, n, e):
    rng = np.random.default_rng(seed)
    g = tgraph.DepGraph()
    for i in range(n):
        g.add_node(i)
    for s, d, t in zip(rng.integers(0, n, e), rng.integers(0, n, e),
                       rng.choice(TYPES, e)):
        g.add_edge(int(s), int(d), int(t))
    return g


_JIT: dict = {}


def jax_packed(a):
    n_pad, iters = a["n_pad"], a["iters"]
    if n_pad not in _JIT:
        _JIT[n_pad] = jax.jit(jtpu.make_packed_closure_kernel(n_pad, S,
                                                              iters))
    r0, q_src, q_dst = a["args"]
    out = _JIT[n_pad](r0.view(np.uint32), q_src, q_dst)
    return tuple(np.asarray(x) for x in out)


def bitmm_closure(a, n_shards):
    """The packed closure squared through `bitmm_ref`, the reach cut into
    `n_shards` column blocks, each block against the gathered reach."""
    r0, q_src, q_dst = (torch.from_numpy(x) for x in a["args"])

    def square(r, cnt):
        parts = torch.zeros((n_shards, S), dtype=torch.int32)
        out = torch.cat([bitmm(r, blk, parts[k]) for k, blk in
                         enumerate(ttpu.shard_blocks(r, n_shards))], dim=2)
        cnt.copy_(parts.sum(dim=0, dtype=torch.int32))
        return out

    reach_, counts, iters_run = ttpu._squarings(r0, a["iters"], square)
    labels, closed = ttpu.packed_labels_ref(reach_, q_src, q_dst)
    return labels, closed, counts, iters_run


@pytest.mark.parametrize("ns", [1, 2, 4])
@pytest.mark.parametrize("n,e", [(100, 300), (255, 800)])
def test_bitmm_closure_matches_jax(n, e, ns):
    """n 100 pads to 128 (one word a shard at 4 shards), 255 to 384 (a
    k stage and an output tile that the plane's edge cuts)."""
    a = ttpu.closure_inputs(random_graph(n + e, n, e), packed=True)
    assert a["n_pad"] == (128 if n == 100 else 384)
    labels, closed, counts, iters_run = bitmm_closure(a, ns)
    j_labels, j_closed, j_counts, j_iters = jax_packed(a)
    assert int(iters_run) == int(j_iters)
    np.testing.assert_array_equal(labels.numpy(), j_labels)
    np.testing.assert_array_equal(closed.numpy(), j_closed)
    np.testing.assert_array_equal(counts.numpy(), j_counts)


def test_scratch_shapes():
    t, fa, fb = ttpu.bitmm_scratch(S, 384, 3, "cpu")
    assert t.shape == (S, 96, 12) and t.dtype == torch.int32
    assert fa.shape == (S, 3, 1) and fa.dtype == torch.uint8
    assert fb.shape == (S, 1, 1) and fb.dtype == torch.uint8
    t, fa, fb = ttpu.bitmm_scratch(S, 16384, 512, "cpu")
    assert t.shape == (S, 16384, 512)
    assert fa.shape == (S, 128, 16) and fb.shape == (S, 64, 16)


def test_packed_square_on_the_cpu_is_the_plain_version():
    r = reach(1, 128, 0.05)
    before = ttpu.packed_closure.launches
    cnt, want_cnt = (torch.zeros(S, dtype=torch.int32) for _ in range(2))
    assert torch.equal(ttpu.packed_square(r, cnt),
                       ttpu.packed_square_ref(r, want_cnt))
    assert torch.equal(cnt, want_cnt)
    assert ttpu.packed_closure.launches == before


@pytest.mark.parametrize("wrong", ["n_pad", "width", "dtype", "count",
                                   "strided"])
def test_a_wrong_scratch_raises(wrong):
    """Both wrappers hold a caller's scratch to `bitmm_scratch`'s shapes
    before they launch anything (the kernel writes it unchecked), on
    the CPU as on the card."""
    r = reach(2, 384, 0.05)
    blk = ttpu.shard_blocks(r, 4)[1]
    cnt = torch.zeros(S, dtype=torch.int32)
    for w, call in ((12, lambda sc: ttpu.packed_square(r, cnt, sc)),
                    (3, lambda sc: ttpu.sharded_square(r, blk, cnt,
                                                       scratch=sc))):
        good = ttpu.bitmm_scratch(S, 384, w, "cpu")
        bad = {"n_pad": ttpu.bitmm_scratch(S, 256, w, "cpu"),
               "width": ttpu.bitmm_scratch(S, 384, w - 1, "cpu"),
               "dtype": (good[0].to(torch.int64),) + good[1:],
               "count": good[:2],
               "strided": (good[0].transpose(1, 2).contiguous()
                           .transpose(1, 2),) + good[1:]}[wrong]
        with pytest.raises(ValueError, match="scratch"):
            call(bad)
        call(good)


# --- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_reach(seed, n_pad, density, dev):
    """A packed reach made on the card from a seeded generator (numpy
    would take minutes at n_pad 16384); "upper" as in `reach`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty((S, n_pad, n_pad // 32), dtype=torch.int32, device=dev)
    for s in range(S):
        p = 0.5 if density == "upper" else density
        bits = torch.rand((n_pad, n_pad), generator=gen, device=dev) < p
        if density == "upper":
            bits = torch.triu(bits)
        out[s] = ttpu.pack_bits(bits)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n_pad", [128, 384, 4096, 16384])
def test_packed_square_matches_plain_on_card(cuda_device, n_pad, density):
    r = card_reach(n_pad, n_pad, density, cuda_device)
    want_cnt = torch.zeros(S, dtype=torch.int32, device=cuda_device)
    want = ttpu.packed_square_ref(r, want_cnt)
    cnt = torch.zeros(S, dtype=torch.int32, device=cuda_device)
    scratch = ttpu.bitmm_scratch(S, n_pad, n_pad // 32, cuda_device)
    before = ttpu.packed_closure.launches
    got = ttpu.packed_square(r, cnt, scratch)
    torch.cuda.synchronize()
    assert ttpu.packed_closure.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(cnt, want_cnt)
    # the kernel's own flags, and its transpose on the flagged tiles of
    # T (a tile without a bit is never written, nor read)
    t, fa, fb = scratch
    t_ref = ttpu.bit_transpose_ref(r)
    assert torch.equal(fa, ttpu.tile_flags_ref(r, ttpu.BITMM_ROWS))
    assert torch.equal(fb, ttpu.tile_flags_ref(t_ref, ttpu.BITMM_COLS))
    on = fb.bool().repeat_interleave(ttpu.BITMM_COLS, dim=1)[:, :n_pad] \
        .repeat_interleave(ttpu.BITMM_K_WORDS, dim=2)[..., :n_pad // 32]
    assert torch.equal(t[on], t_ref[on])


@pytest.mark.gpu
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("ns", [1, 2, 4])
@pytest.mark.parametrize("n_pad", [128, 384, 4096, 16384])
def test_sharded_square_matches_plain_on_card(cuda_device, n_pad, ns,
                                              density):
    full = card_reach(n_pad + ns, n_pad, density, cuda_device)
    for k, blk in enumerate(ttpu.shard_blocks(full, ns)):
        want_cnt = torch.zeros(S, dtype=torch.int32, device=cuda_device)
        want = ttpu.sharded_square_ref(full, blk, want_cnt)
        cnt = torch.zeros(S, dtype=torch.int32, device=cuda_device)
        before = ttpu.sharded_square.launches
        got = ttpu.sharded_square(full, blk, cnt)
        torch.cuda.synchronize()
        assert ttpu.sharded_square.launches == before + 1
        assert torch.equal(got, want), k
        assert torch.equal(cnt, want_cnt), k


@pytest.mark.gpu
@pytest.mark.parametrize("n,e", [(900, 2000), (3000, 9000)])
def test_packed_closure_chain_matches_ref_on_card(cuda_device, n, e):
    """Every squaring of `packed_closure` against `packed_closure_ref`
    and every output, n_pad 1024 and 4096."""
    a = ttpu.closure_inputs(random_graph(n, n, e), packed=True)
    r0, q_src, q_dst = (torch.from_numpy(x).to(cuda_device)
                        for x in a["args"])
    kw = dict(n_pad=a["n_pad"], iters=a["iters"])
    keep, bad = [], []
    got = ttpu.packed_closure(r0, q_src, q_dst, **kw,
                              on_square=lambda i, r: keep.append(r.clone()))
    ref = ttpu.packed_closure_ref(
        r0, q_src, q_dst, **kw, on_square=lambda i, r: bad.append(i) if
        not torch.equal(r, keep[i]) else None)
    assert len(keep) == got[3] == ref[3] > 1 and not bad
    for x, y in zip(got[:3], ref[:3]):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("density", [1e-5, "upper"])
def test_squarings_past_32_k_stages_on_card(cuda_device, density):
    """n_pad 33024 has 33 k stages: the product reads the flags of
    stages past the first 32 as it reaches them (the sharded closure's
    sizes past 32768 txns), packed and one shard of 4."""
    n_pad = 33024
    r = card_reach(7, n_pad, density, cuda_device)
    want_cnt = torch.zeros(S, dtype=torch.int32, device=cuda_device)
    want = ttpu.packed_square_ref(r, want_cnt)
    cnt = torch.zeros(S, dtype=torch.int32, device=cuda_device)
    assert torch.equal(ttpu.packed_square(r, cnt), want)
    assert torch.equal(cnt, want_cnt)
    blk = ttpu.shard_blocks(r, 4)[3]
    cnt = torch.zeros(S, dtype=torch.int32, device=cuda_device)
    got = ttpu.sharded_square(r, blk, cnt)
    assert torch.equal(got, want[..., 3 * blk.shape[-1]:])
    assert torch.equal(cnt, ttpu._popcount32(
        got.to(torch.int64) & 0xFFFFFFFF).sum(dim=(1, 2)).to(torch.int32))
