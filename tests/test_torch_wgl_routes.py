"""The launch forms of the port's WGL chunk kernels and the shape rules
that pick them.

`csrc/wgl_common.cuh` runs the chunk loop in three forms: one CTA a
search with the round's scratch in device memory ("global"), one CTA a
search with the round in shared memory ("shared"), and a cooperative
grid of CTAs on one wide search ("grid"). The wrappers pick one by
shape alone: `wgl32.block_form` (the one-CTA forms: shared where the
round fits in a block's shared memory, a warp multiple of R threads) for
the narrow kernels and every lane-batched kernel, `wgln.solo_form` (the
grid form from `wgln.GRID_MIN_ROWS` successor rows, or where one CTA
would keep the round in device memory) for the solo wide kernel.

On the CPU the rules are checked at the main paths' buckets (the
16-wave, the long tail, the mesh's ladder, the headline), against the
block's shared-memory limit, and the grid form's row split is checked
to tile a round in order. The `gpu` cases hold every form, forced
through the launchers, bit for bit against `chunk_ref` /
`chunk_batched_ref` on every carry leaf and the summary (tolerance
zero: everything is integer), at the wide corpora's shapes, at K=2048
and with a 2^10 table and a 64-row backlog (overflow), and the narrow
shared form solo and batched at K 2, 16 and 64.
"""

import threading

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import synth
from jepsen_tpu_torch.models import cas_register, mutex, register
from jepsen_tpu_torch.ops import encode, wgl, wgl32, wgln

BLOCK_SMEM = 232_448        # bytes of shared memory one H100 block may use


def _R(K, W, ic):
    return K * (W + ic)


# --- the rules, on the CPU -------------------------------------------------

# (K, L, ic): the 16-wave's ladder (W 96, ic 8) and the long tail's
# (W 672, ic 8), derive_plan's buckets on the card
@pytest.mark.parametrize("K,L,ic", [(256, 3, 8), (2048, 3, 8), (4096, 3, 8),
                                    (256, 21, 8), (2048, 21, 8),
                                    (4096, 21, 8)])
def test_wave_and_long_tail_buckets_take_the_grid_form(K, L, ic):
    f = wgln.solo_form(K, L, ic)
    R = _R(K, 32 * L, ic)
    assert R >= wgln.GRID_MIN_ROWS
    assert (f.name, f.threads, f.smem) == ("grid", 1024, 0)
    assert f.blocks == -(-R // 1024)


# the smallest wide corpora of test_torch_wgln.py: K 32 at L 2, ic 8
# (2304 rows)
def test_smallest_wide_corpora_take_one_cta():
    f = wgln.solo_form(32, 2, 8)
    assert _R(32, 64, 8) < wgln.GRID_MIN_ROWS
    assert (f.name, f.threads, f.blocks) == ("shared", 1024, 0)
    assert f.smem == wgl32.shared_bytes(32, 64, 8, wgln.row_words(2, 8))


# (K, W, ic, threads): the mesh fan-out's ladder (W 32, ic 16) and the
# headline's buckets (W 24, ic 16)
NARROW_BUCKETS = [(2, 32, 16, 96), (16, 32, 16, 768), (64, 32, 16, 1024),
                  (2, 24, 16, 96), (16, 24, 16, 640), (64, 24, 16, 1024)]


@pytest.mark.parametrize("K,W,ic,threads", NARROW_BUCKETS)
def test_narrow_buckets_take_the_shared_form(K, W, ic, threads):
    C = wgl32.row_words(ic)
    f = wgl32.block_form(K, W, ic, C)
    assert (f.name, f.threads, f.blocks) == ("shared", threads, 0)
    assert f.smem == 4 * (_R(K, W, ic) * (C + 5) + K + 2 * K * C)
    assert f.smem + wgl32.SMEM_STATIC <= BLOCK_SMEM


def test_mesh_top_bucket_shared_bytes():
    """K 64 at W 32, ic 16: 3072 rows of 4 words, 112,896 bytes."""
    assert wgl32.block_form(64, 32, 16, 4).smem == 112_896


def test_headline_top_bucket_keeps_global_scratch():
    f = wgl32.block_form(512, 24, 16, wgl32.row_words(16))
    assert (f.name, f.threads, f.blocks, f.smem) == ("global", 1024, 0, 0)
    assert wgl32.shared_bytes(512, 24, 16, 4) > BLOCK_SMEM


@pytest.mark.parametrize("ic", [1, 8, 16, 32, 48, 256])
def test_chosen_forms_fit_a_block(ic):
    """Every form either rule picks, at every bucket and width the
    kernels take: shared bytes within a block's limit beside the static
    state, a warp multiple of threads, at most 1024."""
    for K in (1, 2, 3, 16, 31, 64, 100, 128, 256, 512, 2048, 4096):
        for W in (1, 7, 24, 32):
            C = wgl32.row_words(ic)
            forms = [wgl32.block_form(K, W, ic, C)]
            for L in (2, 3, 8, 21, 32):
                forms += [wgln.solo_form(K, L, ic),
                          wgl32.block_form(K, 32 * L, ic,
                                           wgln.row_words(L, ic))]
            for f in forms:
                assert f.name in ("global", "shared", "grid")
                assert f.smem + wgl32.SMEM_STATIC <= BLOCK_SMEM
                assert f.threads % 32 == 0 and 32 <= f.threads <= 1024
                assert (f.smem > 0) == (f.name == "shared")
                assert (f.blocks > 0) == (f.name == "grid")


def test_one_cta_threads_cover_the_rows():
    for K, W, ic in ((1, 1, 1), (2, 24, 16), (3, 5, 2), (40, 32, 8)):
        f = wgl32.block_form(K, W, ic, wgl32.row_words(ic))
        R = _R(K, W, ic)
        assert f.threads == min(1024, -(-R // 32) * 32)


def test_solo_form_crossover_is_a_row_count():
    """Below GRID_MIN_ROWS one CTA where the round fits in shared
    memory, at it and above the grid, at every width."""
    ic = 8
    for L in (2, 3, 8):
        per_parent = 32 * L + ic
        k_grid = -(-wgln.GRID_MIN_ROWS // per_parent)
        assert wgln.solo_form(k_grid, L, ic).name == "grid"
        below = wgln.solo_form(k_grid - 1, L, ic)
        assert below == wgl32.block_form(k_grid - 1, 32 * L, ic,
                                         wgln.row_words(L, ic))
        assert below.name == "shared"


# (K, form) on the long tail's width (L 21, ic 8): one CTA in shared
# memory at K 1 and 2 (680 and 1360 rows); from K 3 (2040 rows) one CTA
# would hold the round in device memory, and the grid takes it below
# GRID_MIN_ROWS (measured: 61.94 against the grid's 44.11 us a round)
@pytest.mark.parametrize("K,form", [(1, "shared"), (2, "shared"),
                                    (3, "grid"), (4, "grid"), (6, "grid")])
def test_long_tail_small_buckets(K, form):
    f = wgln.solo_form(K, 21, 8)
    assert f.name == form
    if form == "grid":
        assert f.blocks == -(-_R(K, 672, 8) // 1024)
        assert wgl32.block_form(K, 672, 8, wgln.row_words(21, 8)).name == \
            "global"


@pytest.mark.parametrize("R", [3072, 8193, 26_624, 212_992, 425_984,
                               2_785_280])
def test_grid_row_ranges_tile_the_round(R):
    """Block b of G owns [b R / G, (b + 1) R / G) (the split of
    `grid_chunk_body` in csrc/wgl_common.cuh; the `gpu` cases hold the
    kernel's own against `chunk_ref`): every G from 1 to 132 tiles
    [0, R) contiguously, in order, each block some rows."""
    for G in range(1, 133):
        ranges = [(b * R // G, (b + 1) * R // G) for b in range(G)]
        assert ranges[0][0] == 0 and ranges[-1][1] == R
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2
        assert all(lo < hi for lo, hi in ranges)
        sizes = [hi - lo for lo, hi in ranges]
        assert max(sizes) - min(sizes) <= 1


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CHUNK, N_CHUNKS, PROBES = 32, 3, 4
ROOMY = (1 << 16, 4096)
TIGHT = (1 << 10, 64)

# the wide corpora of test_torch_wgln.py: (L, ic, history)
WIDE = {
    "wave-4x10": (2, 8, lambda: synth.adversarial_wave_history(
        4, width=10, span=4, seed=3)),
    "long-tail": (3, 8, lambda: synth.long_tail_history(120, seed=3)),
    "cas-crashy": (8, 48, lambda: synth.cas_register_history(
        600, n_procs=40, seed=1, crash_p=0.1)),
}


def _consts(enc, ic, device, max_cfg=10**8):
    return wgl32.consts_from_numpy(
        enc.inv, enc.ret, enc.opcode, enc.sufminret, enc.inv_info[:ic],
        enc.opcode_info[:ic], enc.table, enc.n_ok, enc.n_info, max_cfg,
        device)


def _same(got, got_summary, ref, ref_summary, what):
    assert torch.equal(got_summary, ref_summary), what
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), (what, i)


def _wide_forms(K, L, ic):
    """Every form the solo wide kernel can run at (K, L, ic)."""
    W, C = 32 * L, wgln.row_words(L, ic)
    forms = [wgl32.Form("global", wgl32.block_form(K, W, ic, C).threads),
             wgl32.Form("grid", 1024, -(-_R(K, W, ic) // 1024))]
    f = wgl32.block_form(K, W, ic, C)
    if f.name == "shared":
        forms.append(f)
    return forms


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [ROOMY, TIGHT], ids=["roomy", "tight"])
@pytest.mark.parametrize("K", [32, 2048])
@pytest.mark.parametrize("name", list(WIDE))
def test_each_wide_form_matches_chunk_ref_on_card(cuda_device, name, K, cap):
    L, ic, hist = WIDE[name]
    H, B = cap
    consts = _consts(encode.encode(cas_register(), hist()), ic, cuda_device)
    kw = dict(K=K, L=L, ic=ic, H=H, B=B, chunk=CHUNK, probes=PROBES)
    for form in _wide_forms(K, L, ic):
        carry = wgln.init_carry(K, L, ic, H, B, 0, cuda_device)
        for step in range(N_CHUNKS):
            ref_in = tuple(t.clone() for t in carry)
            summary = wgl32.launch("wgln_chunk", consts, carry, K=K, W=32 * L,
                                   L=L, ic=ic, H=H, B=B, rounds=CHUNK,
                                   probes=PROBES, form=form)
            torch.cuda.synchronize()
            ref, ref_summary = wgln.chunk_ref(consts, ref_in, **kw)
            _same(carry, summary, ref, ref_summary, (name, K, form, step))
            if int(summary[1]) or int(summary[0]) == 0:
                break
        if (name, K, cap) == ("wave-4x10", 32, TIGHT):
            assert int(summary[2]) == 1, "the 64-row backlog overflows"


def test_wide_forms_cover_every_form():
    """The forced forms of the card case include all three at K 32."""
    assert {f.name for f in _wide_forms(32, 2, 8)} == {"global", "shared",
                                                       "grid"}


BUCKET = {"n_pad": 192, "ic_pad": 32, "S": 16, "O": 32}
NARROW_W, NARROW_IC = 24, 16


def _narrow_encs():
    hists = [(register(), synth.cas_register_history(
                 150, n_procs=4, seed=11, crash_p=0.04, fs=("read", "write"))),
             (cas_register(), synth.cas_register_history(
                 150, n_procs=5, seed=3, crash_p=0.05)),
             (cas_register(), synth.cas_register_history(
                 120, n_procs=5, seed=8, crash_p=0.05, lie_p=0.03)),
             (mutex(), synth.mutex_history(120, seed=5))]
    return [wgl._apply_bucket(encode.encode(m, h), BUCKET) for m, h in hists]


@pytest.mark.gpu
@pytest.mark.parametrize("K", [2, 16, 64])
def test_narrow_shared_form_solo_matches_chunk_ref_on_card(cuda_device, K):
    H, B = TIGHT
    C = wgl32.row_words(NARROW_IC)
    shared = wgl32.block_form(K, NARROW_W, NARROW_IC, C)
    assert shared.name == "shared"
    kw = dict(K=K, W=NARROW_W, ic=NARROW_IC, H=H, B=B, chunk=64,
              probes=PROBES)
    for enc in _narrow_encs():
        consts = _consts(enc, NARROW_IC, cuda_device)
        for form in (shared, wgl32.Form("global", shared.threads),
                     wgl32.Form("global", 1024)):
            carry = wgl32.init_carry(K, C, H, B, 0, cuda_device)
            for step in range(N_CHUNKS):
                ref_in = tuple(t.clone() for t in carry)
                summary = wgl32.launch("wgl32_chunk", consts, carry, L=1,
                                       rounds=64, form=form,
                                       **{k: v for k, v in kw.items()
                                          if k != "chunk"})
                torch.cuda.synchronize()
                ref, ref_summary = wgl32.chunk_ref(consts, ref_in, **kw)
                _same(carry, summary, ref, ref_summary, (K, form, step))
                if int(summary[1]) or int(summary[0]) == 0:
                    break


@pytest.mark.gpu
@pytest.mark.parametrize("K", [2, 16, 64])
def test_narrow_shared_form_batched_matches_plain_on_card(cuda_device, K):
    H, B = TIGHT
    C = wgl32.row_words(NARROW_IC)
    encs = _narrow_encs()
    cols = [np.stack([getattr(e, f) for e in encs])
            for f in ("inv", "ret", "opcode", "sufminret")]
    consts = wgl32.batch_consts_from_numpy(
        *cols, np.stack([e.inv_info[:NARROW_IC] for e in encs]),
        np.stack([e.opcode_info[:NARROW_IC] for e in encs]),
        np.stack([e.table for e in encs]), [e.n_ok for e in encs],
        [e.n_info for e in encs], 10**8, cuda_device)
    kw = dict(K=K, W=NARROW_W, ic=NARROW_IC, H=H, B=B, chunk=64,
              probes=PROBES)
    shared = wgl32.block_form(K, NARROW_W, NARROW_IC, C)
    for form in (shared, wgl32.Form("global", shared.threads)):
        carry = wgl32.init_carry_batch(len(encs), K, C, H, B, 0, cuda_device)
        for step in range(N_CHUNKS):
            ref_in = tuple(t.clone() for t in carry)
            summary = wgl32.launch_batched(
                "wgl32_chunk_batched", consts, carry, K=K, W=NARROW_W, L=1,
                ic=NARROW_IC, H=H, B=B, rounds=64, probes=PROBES, form=form)
            torch.cuda.synchronize()
            ref, ref_summary = wgl32.chunk_batched_ref(consts, ref_in, **kw)
            _same(carry, summary, ref, ref_summary, (K, form, step))
    # the wrapper takes the shared form by itself
    before = wgl32.chunk_batched.launches
    carry = wgl32.init_carry_batch(len(encs), K, C, H, B, 0, cuda_device)
    ref_in = tuple(t.clone() for t in carry)
    got, summary = wgl32.chunk_batched(consts, carry, **kw)
    ref, ref_summary = wgl32.chunk_batched_ref(consts, ref_in, **kw)
    assert wgl32.chunk_batched.launches == before + 1
    _same(got, summary, ref, ref_summary, (K, "wrapper"))


def _narrow_launch(consts, carry, K, form, rounds=8):
    H, B = TIGHT
    return wgl32.launch("wgl32_chunk", consts, carry, K=K, W=NARROW_W, L=1,
                        ic=NARROW_IC, H=H, B=B, rounds=rounds, probes=PROBES,
                        form=form)


@pytest.mark.gpu
def test_shared_forms_of_two_sizes_on_two_threads_on_card(cuda_device):
    """Two threads launch the narrow shared form at K 2 and K 64 at the
    same time, each on a stream of its own, 200 times each: every launch
    equals `chunk_ref` (one launch's shared bytes never limit
    another's)."""
    H, B = TIGHT
    C = wgl32.row_words(NARROW_IC)
    consts = _consts(_narrow_encs()[1], NARROW_IC, cuda_device)
    want = {}
    for K in (2, 64):
        start = wgl32.init_carry(K, C, H, B, 0, cuda_device)
        want[K] = (start, *wgl32.chunk_ref(
            consts, tuple(t.clone() for t in start), K=K, W=NARROW_W,
            ic=NARROW_IC, H=H, B=B, chunk=8, probes=PROBES))
    errors = []
    together = threading.Barrier(2)

    def worker(K):
        try:
            start, ref, ref_summary = want[K]
            form = wgl32.block_form(K, NARROW_W, NARROW_IC, C)
            assert form.name == "shared"
            stream = torch.cuda.Stream(cuda_device)
            outs = []
            together.wait()
            with torch.cuda.stream(stream):
                for _ in range(200):
                    carry = tuple(t.clone() for t in start)
                    outs.append((carry, _narrow_launch(consts, carry, K,
                                                       form)))
            stream.synchronize()
            for carry, summary in outs:
                _same(carry, summary, ref, ref_summary, K)
        except BaseException as e:          # raised below, in the test
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(K,)) for K in want]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


@pytest.mark.gpu
def test_shared_form_at_the_rules_limit_on_card(cuda_device):
    """The shared form with every byte `block_form` may give it
    (SMEM_BLOCK_MAX - SMEM_STATIC) launches and equals `chunk_ref`, solo
    and batched (the kernels' static shared state fits the rule's
    margin); a block's whole opt-in limit is refused, and raises."""
    H, B = TIGHT
    K = 2
    C = wgl32.row_words(NARROW_IC)
    threads = wgl32.block_form(K, NARROW_W, NARROW_IC, C).threads
    most = wgl32.SMEM_BLOCK_MAX - wgl32.SMEM_STATIC
    encs = _narrow_encs()
    kw = dict(K=K, W=NARROW_W, ic=NARROW_IC, H=H, B=B, chunk=8,
              probes=PROBES)
    consts = _consts(encs[1], NARROW_IC, cuda_device)
    start = wgl32.init_carry(K, C, H, B, 0, cuda_device)
    carry = tuple(t.clone() for t in start)
    summary = _narrow_launch(consts, carry, K,
                             wgl32.Form("shared", threads, 0, most))
    ref, ref_summary = wgl32.chunk_ref(consts, start, **kw)
    _same(carry, summary, ref, ref_summary, "solo")
    with pytest.raises(RuntimeError, match="wgl32_chunk launch failed"):
        _narrow_launch(consts, wgl32.init_carry(K, C, H, B, 0, cuda_device),
                       K, wgl32.Form("shared", threads, 0,
                                     wgl32.SMEM_BLOCK_MAX))

    cols = [np.stack([getattr(e, f) for e in encs])
            for f in ("inv", "ret", "opcode", "sufminret")]
    bconsts = wgl32.batch_consts_from_numpy(
        *cols, np.stack([e.inv_info[:NARROW_IC] for e in encs]),
        np.stack([e.opcode_info[:NARROW_IC] for e in encs]),
        np.stack([e.table for e in encs]), [e.n_ok for e in encs],
        [e.n_info for e in encs], 10**8, cuda_device)
    start = wgl32.init_carry_batch(len(encs), K, C, H, B, 0, cuda_device)
    carry = tuple(t.clone() for t in start)
    summary = wgl32.launch_batched(
        "wgl32_chunk_batched", bconsts, carry, K=K, W=NARROW_W, L=1,
        ic=NARROW_IC, H=H, B=B, rounds=8, probes=PROBES,
        form=wgl32.Form("shared", threads, 0, most))
    ref, ref_summary = wgl32.chunk_batched_ref(bconsts, start, **kw)
    _same(carry, summary, ref, ref_summary, "batched")


def test_form_ints_round_trip():
    """Each chunk entry point's form ints read back as the form; the
    narrow and batched entry points have no grid form."""
    forms = [wgl32.Form("global", 96), wgl32.Form("shared", 640, 0, 48_000),
             wgl32.Form("grid", 1024, 26)]
    for name, fields in wgl32.FORM_FIELDS.items():
        for f in forms:
            if f.name == "grid" and "blocks" not in fields:
                with pytest.raises(ValueError, match="no grid form"):
                    wgl32.form_ints(name, f)
                continue
            ints = wgl32.form_ints(name, f)
            assert len(ints) == len(fields)
            assert wgl32.form_of(name, [7, 7] + ints) == f
