"""The bool-window WGL chunk (`jepsen_tpu_torch/ops/wgl_bool.py`,
reached through `ops/wgl._build_search` / `_compiled_search`) against
the JAX package's `ops/wgl._compiled_search`, the jitted `chunk_fn`.

The same encoding (the JAX package's `encode`, consts in
`aot._wgl_consts_spec` order) goes through both chunks from the same
start; after every chunk, until the search stops, all 13 carry leaves
must be bit-identical (windows and info masks as bools, the memo table
as uint32 words). Four inputs: a 200-op cas-register history with
crashes (info successors), a wide wave history (W 64), a memo table of
64 slots (probes that find no empty slot) and an 8-row backlog
(overflow). The `gpu` cases hold the `wgl_chunk` kernel against the
plain chunk on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import cas_register
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wgl_bool

torch.set_num_threads(1)

PROBES = 4
_ENC: dict = {}

# name -> (history, K, H, B, chunk, max_cfg)
CASES = {
    "cas-crashes": (lambda: jsynth.cas_register_history(
        200, n_procs=5, seed=4, crash_p=0.05), 16, 1 << 12, 4096, 4, 10**8),
    "wave-w64": (lambda: jsynth.adversarial_wave_history(
        4, width=10, span=4, seed=3, invalid=False), 32, 1 << 14, 4096, 8,
        10**8),
    "tiny-table": (lambda: jsynth.cas_register_history(
        200, n_procs=5, seed=4, crash_p=0.05), 16, 64, 4096, 16, 3000),
    "tiny-backlog": (lambda: jsynth.cas_register_history(
        200, n_procs=5, seed=4, crash_p=0.05), 4, 1 << 12, 8, 16, 10**8),
}


def _encoded(name):
    if name not in _ENC:
        _ENC[name] = jencode.encode(cas_register(), CASES[name][0]())
    return _ENC[name]


def _arrays(enc):
    return (enc.inv, enc.ret, enc.opcode, enc.sufminret, enc.inv_info,
            enc.opcode_info, enc.table)


def _shape(enc, K, H, B, chunk):
    S, O = enc.table.shape
    return (len(enc.inv), len(enc.inv_info), enc.window, S, O, K, H, B,
            chunk, PROBES)


def _verdict(leaves):
    flags, fr_cnt = leaves[wgl_bool.FLAGS], int(leaves[wgl_bool.FR_CNT])
    if flags[0]:
        return True
    if fr_cnt == 0:
        return "unknown" if flags[1] else False
    return "unknown"


def _run_both(name):
    """Every chunk through the JAX package and the port from the same
    carry, compared leaf by leaf; returns the final leaves."""
    _, K, H, B, chunk, max_cfg = CASES[name]
    enc = _encoded(name)
    arrays = _arrays(enc)
    consts_j = tuple(jnp.asarray(a) for a in arrays) + (
        jnp.int32(enc.n_ok), jnp.int32(enc.n_info), jnp.int32(max_cfg))
    consts_t = wgl_bool.consts_from_numpy(*arrays, enc.n_ok, enc.n_info,
                                          max_cfg, device="cpu")
    shape = _shape(enc, K, H, B, chunk)
    init_j, chunk_j = jwgl._compiled_search(*shape)
    init_t, chunk_t = twgl._build_search(*shape)
    carry_j, carry_t = init_j(0), init_t(0, device="cpu")
    leaves = None
    for step in range(400):
        carry_j = chunk_j(consts_j, carry_j)
        # copies: the next call donates the JAX carry's buffers
        leaves = [np.array(x) for x in carry_j]
        got = chunk_t(consts_t, carry_t)
        assert got is carry_t
        for i, (a, b) in enumerate(zip(wgl_bool.carry_to_numpy(carry_t),
                                       leaves)):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, i)
            np.testing.assert_array_equal(
                a, b, err_msg=f"{name}: chunk {step}, leaf {i}")
        stats = leaves[wgl_bool.STATS]
        if (leaves[wgl_bool.FLAGS][0] or int(leaves[wgl_bool.FR_CNT]) == 0
                or stats[0] >= max_cfg):
            return leaves, step + 1
    raise AssertionError(f"{name}: the search did not stop")


def test_init_carry_matches_jax_init_fn():
    enc = _encoded("cas-crashes")
    shape = _shape(enc, 16, 1 << 12, 4096, 4)
    init_j, _ = jwgl._build_search(*shape)
    init_t, _ = twgl._build_search(*shape)
    for i, (a, b) in enumerate(zip(
            wgl_bool.carry_to_numpy(init_t(3, device="cpu")), init_j(3))):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def test_crashes_bit_identical_every_chunk():
    leaves, chunks = _run_both("cas-crashes")
    assert chunks > 2
    assert _verdict(leaves) is True
    # info successors ran: some frontier or backlog row took an info op
    assert leaves[wgl_bool.BK_INFO].any() or leaves[wgl_bool.FR_INFO].any()
    hist = CASES["cas-crashes"][0]()
    assert jwgl.check(cas_register(), hist)["valid?"] is True


def test_wide_window_bit_identical_every_chunk():
    enc = _encoded("wave-w64")
    assert enc.window == 64 and enc.window_raw > 32
    leaves, chunks = _run_both("wave-w64")
    assert chunks > 2
    assert _verdict(leaves) is True
    hist = CASES["wave-w64"][0]()
    assert jwgl.check(cas_register(), hist)["valid?"] is True


def test_full_table_bit_identical_every_chunk():
    """64 memo slots: probes run out of empty slots and the rows that
    could not insert survive as new; the config budget stops it."""
    leaves, _ = _run_both("tiny-table")
    table = leaves[wgl_bool.TABLE]
    assert int((table[:, 0] != 0).sum()) == 64
    ref, _ = _run_both("cas-crashes")
    # re-exploration: fewer memo hits for more configs than the roomy run
    assert leaves[wgl_bool.STATS][3] < ref[wgl_bool.STATS][3]


def test_overflow_bit_identical_every_chunk():
    """An 8-row backlog overflows; the exhausted frontier then answers
    "unknown" in both packages."""
    leaves, _ = _run_both("tiny-backlog")
    assert leaves[wgl_bool.FLAGS][1]
    assert _verdict(leaves) == "unknown"


@pytest.mark.parametrize("W,ic,probes", [(40, 32, 4), (32, 8, 4),
                                         (2048, 32, 4), (32, 288, 4),
                                         (32, 32, 9)])
def test_check_launch_refuses_what_the_kernel_does_not_take(W, ic, probes):
    consts = (torch.zeros(64, dtype=torch.int32),) * 3 + (
        torch.zeros(65, dtype=torch.int32),
        torch.zeros(ic, dtype=torch.int32),
        torch.zeros(ic, dtype=torch.int32),
        torch.zeros((4, 4), dtype=torch.int32), 1, 0, 100)
    carry = wgl_bool.init_carry(4, W, ic, 64, 8, 0, "cpu")
    with pytest.raises(ValueError):
        wgl_bool.check_launch(consts, carry, K=4, W=W, ic=ic, H=64, B=8,
                              chunk=4, probes=probes)


def test_check_launch_takes_a_plain_shape():
    enc = _encoded("cas-crashes")
    consts = wgl_bool.consts_from_numpy(*_arrays(enc), enc.n_ok,
                                        enc.n_info, 100, device="cpu")
    carry = wgl_bool.init_carry(16, enc.window, len(enc.inv_info), 64, 8, 0,
                                "cpu")
    wgl_bool.check_launch(consts, carry, K=16, W=enc.window,
                          ic=len(enc.inv_info), H=64, B=8, chunk=4, probes=4)
    assert wgl_bool.sort_rows(16, 32, 32) == 1024
    assert wgl_bool.sort_rows(2, 32, 32) == 128


# --- the kernel's explorer order -------------------------------------------

_ONES = 0xFFFFFFFF


def kernel_order(sig, explore):
    """The order `csrc/wgl_chunk.cu` gives a round's explorers: the rows
    that explore with a signature other than all ones, by (s0, s1, s2,
    r); then, if an all-ones explorer comes before every other row that
    is not in that list, that one. Returns (rows by sorted position, the
    kernel's adjacent-duplicate flags, its duplicate count)."""
    s0, s1, s2 = (np.asarray(x, np.int64) for x in sig)
    ex = np.asarray(explore, bool)
    ones = ex & (s0 == _ONES) & (s1 == _ONES) & (s2 == _ONES)
    reg = ex & ~ones
    rows = np.flatnonzero(reg)
    rows = rows[np.lexsort((rows, s2[rows], s1[rows], s0[rows]))]
    others, ones_rows = np.flatnonzero(~reg), np.flatnonzero(ones)
    tail = len(ones_rows) > 0 and ones_rows[0] == others[0]
    listed = np.concatenate([rows, ones_rows[:1] if tail else []]).astype(
        np.int64)
    key = np.stack([s0[listed], s1[listed], s2[listed]], 1)
    same = np.zeros(len(listed), bool)
    same[1:] = (key[1:] == key[:-1]).all(1)
    return listed, same, int(same.sum()) + len(ones_rows) - int(tail)


def full_sort(sig, explore):
    """The reference's order: every row, stably by (s0, s1, s2) (as
    `chunk_ref`'s three stable sorts); its adjacent duplicates among the
    explorers and the unique explorers."""
    s0, s1, s2 = (np.asarray(x, np.int64) for x in sig)
    ex = np.asarray(explore, bool)
    perm = np.lexsort((s2, s1, s0))
    key = np.stack([s0[perm], s1[perm], s2[perm]], 1)
    samep = np.zeros(len(perm), bool)
    samep[1:] = (key[1:] == key[:-1]).all(1)
    return perm, ex[perm] & ~samep, int((ex[perm] & samep).sum())


def assert_ranks_agree(sig, explore):
    listed, same, dup = kernel_order(sig, explore)
    perm, uniq, ref_dup = full_sort(sig, explore)
    n = len(listed)
    # an explorer's rank in the list is its position in the full sort
    np.testing.assert_array_equal(perm[:n], listed)
    np.testing.assert_array_equal(uniq[:n], ~same)
    assert not uniq[n:].any()   # every explorer past the list is a dup
    assert dup == ref_dup
    return n


def _round_keys(name, chunks):
    _, K, H, B, chunk, max_cfg = CASES[name]
    enc = _encoded(name)
    consts = wgl_bool.consts_from_numpy(*_arrays(enc), enc.n_ok, enc.n_info,
                                        max_cfg, device="cpu")
    carry = wgl_bool.init_carry(K, enc.window, len(enc.inv_info), H, B, 0,
                                "cpu")
    seen = []
    for _ in range(chunks):
        wgl_bool.chunk_ref(consts, carry, K=K, W=enc.window,
                           ic=len(enc.inv_info), H=H, B=B, chunk=chunk,
                           probes=PROBES,
                           on_keys=lambda sig, ex: seen.append(
                               ([x.numpy().copy() for x in sig],
                                ex.numpy().copy())))
    return seen


@pytest.mark.parametrize("name", ["cas-crashes", "wave-w64"])
def test_explorer_rank_is_the_full_sort_position(name):
    rounds = _round_keys(name, 3)
    assert rounds
    explorers = 0
    for sig, ex in rounds:
        explorers += assert_ranks_agree(sig, ex)
        # the same round with its first explorer's signature all ones:
        # a tail row of its own, kept only when no other row precedes it
        first = np.flatnonzero(ex)
        if len(first):
            forced = [x.copy() for x in sig]
            for x in forced:
                x[first[0]] = _ONES
            assert_ranks_agree(forced, ex)
    assert explorers > 0


@pytest.mark.parametrize("ones_at,plain_at,want_tail", [
    ([10, 12], [11], True),       # kept, the second a duplicate
    ([0], [], True),              # the first row
    ([5, 6], [], True),           # every row before it explores
    ([12], [3], False),           # a row before it does not explore
    ([], [], False)])
def test_all_ones_explorers_sort_into_the_tail(ones_at, plain_at, want_tail):
    rng = np.random.default_rng(5)
    R = 64
    sig = [rng.integers(0, 2**32 - 1, R, dtype=np.int64) | (i == 0)
           for i in range(3)]
    sig[0][7] = sig[0][8]         # one real duplicate pair
    sig[1][7], sig[2][7] = sig[1][8], sig[2][8]
    ex = np.ones(R, bool)
    ex[plain_at] = False
    ex[40:] = False
    for x in sig:
        x[~ex] = _ONES
        x[ones_at] = _ONES
    listed, _, _ = kernel_order(sig, ex)
    assert (len(ones_at) > 0 and listed[-1] == ones_at[0]) == want_tail
    assert_ranks_agree(sig, ex)


@pytest.mark.parametrize("K,W,ic", [(2, 32, 32), (64, 32, 32),
                                    (256, 96, 32), (16, 1024, 256)])
def test_scratch_words_cover_the_layout(K, W, ic):
    """`scratch_layout` is `csrc/wgl_chunk.cu`'s: the keys first (16-byte
    aligned) with room for every row of the round, the probe state and
    slot by sorted position, both packed frontiers and the min-rets,
    back to back; `scratch_words` is its end."""
    lay = wgl_bool.scratch_layout(K, W, ic)
    R, rp = K * (W + ic), wgl_bool.sort_rows(K, W, ic)
    cw = 2 + W // 32 + ic // 32
    want = {"keys": 4 * rp, "state": rp, "slot": rp, "cur": K * cw,
            "nxt": K * cw, "minret": K}
    off = 0
    for name, words in want.items():
        assert lay[name] == (off, words), name
        off += words
    assert off == wgl_bool.scratch_words(K, W, ic)
    assert rp >= R and rp & (rp - 1) == 0 and rp < 2 * R


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_chunk_on_card(cuda_device, name):
    _, K, H, B, chunk, max_cfg = CASES[name]
    enc = _encoded(name)
    consts = wgl_bool.consts_from_numpy(*_arrays(enc), enc.n_ok, enc.n_info,
                                        max_cfg, device=cuda_device)
    shape = _shape(enc, K, H, B, chunk)
    init_fn, chunk_k = twgl._compiled_search(*shape)
    _, chunk_p = twgl._build_search(*shape)
    carry = init_fn(0, device=cuda_device)
    before = wgl_bool.chunk.launches
    for step in range(400):
        ref = chunk_p(consts, tuple(t.clone() for t in carry))
        chunk_k(consts, carry)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(carry, ref)):
            assert torch.equal(a, b), (name, step, i)
        if bool(carry[wgl_bool.FLAGS][0]) or int(carry[wgl_bool.FR_CNT]) == 0 \
                or int(carry[wgl_bool.STATS][0]) >= max_cfg:
            break
    assert wgl_bool.chunk.launches == before + step + 1


# name -> (history, K, H, B, rounds a chunk, chunks, max_cfg, the explorer
# counts a round must reach: (least, most) over the rounds run)
CARD_CASES = {
    # the headline's bucket: at most 32 explorers, one warp a round
    "narrow-k2": (lambda: jsynth.cas_register_history(
        2000, n_procs=5, seed=42, crash_p=0.002), 2, 1 << 16, 1 << 12, 512,
        2, 10**8, (0, 32)),
    # the 16-wave: sorts in shared memory, then in device scratch
    "wave-k256": (lambda: jsynth.adversarial_wave_history(
        16, width=14, span=5, seed=7), 256, 1 << 20, 1 << 16, 16, 1, 10**8,
        (33, 4096)),
    "wave-k2048": (lambda: jsynth.adversarial_wave_history(
        16, width=14, span=5, seed=7), 2048, 1 << 22, 1 << 18, 8, 2, 10**8,
        (4097, 1 << 20)),
    # a roomy table: the claims of the block's rounds settle in probe 0
    "roomy-k64": (lambda: jsynth.adversarial_wave_history(
        16, width=14, span=5, seed=7), 64, 1 << 20, 1 << 16, 16, 1, 10**8,
        (33, 4096)),
    # tiny tables: claims of one round collide on a slot, then fill it
    # (one warp, then the block's shared map)
    "tiny-h16": (lambda: jsynth.cas_register_history(
        200, n_procs=5, seed=4, crash_p=0.05), 16, 16, 4096, 16, 4, 3000,
        (0, 64)),
    "tiny-h64-k64": (lambda: jsynth.adversarial_wave_history(
        16, width=14, span=5, seed=7), 64, 64, 4096, 16, 2, 10**8,
        (33, 4096)),
    # a full 1024-slot table and a 256-row backlog that overflows
    "full-table": (lambda: jsynth.adversarial_wave_history(
        16, width=14, span=5, seed=7), 64, 1024, 256, 24, 1, 10**8,
        (0, 4096)),
}
_CARD_ENC: dict = {}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_paths_match_plain_chunk_on_card(cuda_device, name):
    """Each of the kernel's paths (one warp at <= 32 explorers, the
    shared sort, the device-scratch sort and probe, tiny and full
    tables, an overflowing backlog) against `chunk_ref` on the card, bit
    for bit on every carry leaf after every chunk; the plain chunk's
    keys show the round sizes each case was built to reach."""
    hist, K, H, B, rounds, chunks, max_cfg, (lo, hi) = CARD_CASES[name]
    if name not in _CARD_ENC:
        _CARD_ENC[name] = jencode.encode(cas_register(), hist())
    enc = _CARD_ENC[name]
    W, ic = enc.window, len(enc.inv_info)
    consts = wgl_bool.consts_from_numpy(*_arrays(enc), enc.n_ok, enc.n_info,
                                        max_cfg, device=cuda_device)
    carry = wgl_bool.init_carry(K, W, ic, H, B, 0, cuda_device)
    n_ex = []
    for step in range(chunks):
        ref = tuple(t.clone() for t in carry)
        wgl_bool.chunk_ref(consts, ref, K=K, W=W, ic=ic, H=H, B=B,
                           chunk=rounds, probes=PROBES,
                           on_keys=lambda sig, ex: n_ex.append(len(
                               kernel_order([x.cpu().numpy() for x in sig],
                                            ex.cpu().numpy())[0])))
        before = wgl_bool.chunk.launches
        wgl_bool.chunk(consts, carry, K=K, W=W, ic=ic, H=H, B=B,
                       chunk=rounds, probes=PROBES)
        torch.cuda.synchronize()
        assert wgl_bool.chunk.launches == before + 1
        for i, (a, b) in enumerate(zip(carry, ref)):
            assert torch.equal(a, b), (name, step, i)
        if bool(carry[wgl_bool.FLAGS][0]) or int(carry[wgl_bool.FR_CNT]) == 0:
            break
    assert n_ex and lo <= max(n_ex) <= hi, (name, max(n_ex))
    if name == "full-table":
        flags = carry[wgl_bool.FLAGS].tolist()
        assert flags[1] and int((carry[wgl_bool.TABLE][:, 0] != 0).sum()) == H
