"""The cluster form of the wide lane-batched WGL chunk
(`wgln_chunk_batched`, `csrc/wgl_common.cuh`: one thread-block cluster
of g CTAs a lane) and the shape rule that picks it
(`wgln.batched_form`).

On the CPU: the rule, with the card's SM count and cluster capacities
given as arguments (one CTA a lane where the lanes fill the card or a
lane's round is short and fits in shared memory; else g a power of two
up to 16 with lanes x g <= SMs and every lane's cluster resident at
once), the main paths' shapes, the form's round trip through
`wgl32.form_ints` / `form_of`, and `launch_batched` refusing a cluster
of 0, 3 or 32 CTAs before any launch.

The `gpu` cases hold the cluster form, forced at g 2, 4, 8 and 16 (16
where the card holds such a cluster), bit for bit against
`wgln.chunk_batched_ref` on every carry leaf and on the summary
(tolerance zero: everything is integer) over three chunks, at L 2 and
3, on a batch whose lanes stop at different rounds (valid and invalid
waves of different widths and spans, one lane with a small config
budget, one dummy padded lane with n_ok 0), with the plan's memo table
and backlog and with a tight one (a 2^10 table and a 32-row backlog:
collisions, spill and overflow). This file imports no JAX: the parity
with the JAX package is `tests/test_torch_batched.py`'s.
"""

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import synth
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import encode, wgl32, wgln
from jepsen_tpu_torch.parallel import batched

H100_SMS = 132
# clusters of g 1024-thread CTAs an H100 80GB HBM3 holds at once
# (cudaOccupancyMaxActiveClusters, read by wgln.card_shape on the card)
CAPACITY = {2: 66, 4: 30, 8: 15, 16: 7}


def _R(K, L, ic):
    return K * (32 * L + ic)


# --- the rule, on the CPU ----------------------------------------------------

@pytest.mark.parametrize("lanes", [67, 100, 132, 140, 400])
def test_lanes_that_fill_the_card_keep_one_cta(lanes):
    """No cluster of 2 fits beside the other lanes: one CTA a lane, in
    `block_form`, at the fan-out waves' bucket (K 1024, L 2, ic 8)."""
    f = wgln.batched_form(lanes, 1024, 2, 8, sms=H100_SMS,
                          capacity=CAPACITY)
    assert f == wgl32.block_form(1024, 64, 8, wgln.row_words(2, 8))
    assert f.name == "global"


@pytest.mark.parametrize("K,L,ic", [(16, 2, 8), (32, 2, 8), (16, 3, 8),
                                    (1, 21, 8), (2, 21, 8)])
def test_short_shared_rounds_keep_one_cta(K, L, ic):
    """A lane's round below CLUSTER_MIN_ROWS that fits in shared memory
    stays one CTA a lane, however idle the card."""
    assert _R(K, L, ic) < wgln.CLUSTER_MIN_ROWS
    f = wgln.batched_form(2, K, L, ic, sms=H100_SMS, capacity=CAPACITY)
    assert f == wgl32.block_form(K, 32 * L, ic, wgln.row_words(L, ic))
    assert f.name == "shared"


@pytest.mark.parametrize("sms", [16, 40, 66, 132, 144])
@pytest.mark.parametrize("lanes", [1, 2, 3, 4, 8, 9, 16, 33, 64])
def test_cluster_size_is_the_largest_that_fits(lanes, sms):
    """g is a power of two from 2 to 16 with lanes x g <= SMs, and the
    next power of two would not fit; no g >= 2 fitting gives one CTA
    (a card that holds any cluster whole)."""
    K, L, ic = 1024, 2, 8
    f = wgln.batched_form(lanes, K, L, ic, sms=sms,
                          capacity={g: sms // g for g in (2, 4, 8, 16)})
    if lanes * 2 > sms:
        assert f.name == "global"
        return
    g = f.blocks
    assert (f.name, f.threads, f.smem) == ("cluster", 1024, 0)
    assert g in (2, 4, 8, 16) and lanes * g <= sms
    assert g == 16 or lanes * 2 * g > sms


def test_cluster_size_keeps_every_lane_resident():
    """With the card's capacities given, every lane's cluster is
    resident at once: 8 lanes take g 8 where the card holds only 7
    clusters of 16."""
    f = wgln.batched_form(8, 1024, 2, 8, sms=H100_SMS, capacity=CAPACITY)
    assert (f.name, f.blocks) == ("cluster", 8)
    f = wgln.batched_form(7, 1024, 2, 8, sms=H100_SMS, capacity=CAPACITY)
    assert (f.name, f.blocks) == ("cluster", 16)
    f = wgln.batched_form(8, 1024, 2, 8, sms=H100_SMS,
                          capacity={2: 0, 4: 0, 8: 0, 16: 0})
    assert f.name == "global"


def test_cluster_size_does_not_follow_the_row_count():
    """A short round still takes the largest resident cluster (measured:
    2 lanes at 4608 rows, g 4 24.06, g 8 18.66, g 16 17.31 us a round):
    the long tail's K 3 (2040 rows, past shared memory) and the mesh
    waves' K 64 at L 2 (4608 rows) take g 16 at 2 lanes."""
    f = wgln.batched_form(2, 3, 21, 8, sms=H100_SMS, capacity=CAPACITY)
    assert (f.name, f.blocks) == ("cluster", 16)
    assert wgl32.block_form(3, 672, 8, wgln.row_words(21, 8)).name == \
        "global"
    f = wgln.batched_form(2, 64, 2, 8, sms=H100_SMS, capacity=CAPACITY)
    assert _R(64, 2, 8) == 4608
    assert (f.name, f.blocks) == ("cluster", 16)


def test_main_path_shapes():
    """The fan-out waves (8 lanes, K 1024, L 2, ic 8: 73,728 rows a
    lane) take g 8 on an H100 that holds 7 clusters of 16 (g 16 on a
    card that held 8); the mesh waves' lanes (2 a shard) g 16."""
    assert _R(1024, 2, 8) == 73_728
    assert wgln.batched_form(8, 1024, 2, 8, sms=H100_SMS,
                             capacity={**CAPACITY, 16: 8}).blocks == 16
    assert wgln.batched_form(8, 1024, 2, 8, sms=H100_SMS,
                             capacity=CAPACITY).blocks == 8
    assert wgln.batched_form(2, 1024, 2, 8, sms=H100_SMS,
                             capacity=CAPACITY).blocks == 16


@pytest.mark.parametrize("ic", [8, 32, 48])
def test_every_picked_form_is_launchable(ic):
    """Every form the rule picks passes the launch's form check."""
    for lanes in (1, 2, 5, 8, 31, 66, 67, 140):
        for K in (1, 2, 3, 16, 64, 256, 1024, 4096):
            for L in (2, 3, 8, 21, 32):
                f = wgln.batched_form(lanes, K, L, ic, sms=H100_SMS,
                                      capacity=CAPACITY)
                ints = wgl32.form_ints("wgln_chunk_batched", f)
                assert wgl32.form_of("wgln_chunk_batched", ints) == f
                if f.name == "cluster":
                    assert lanes <= CAPACITY[f.blocks]


@pytest.mark.parametrize("g", [2, 4, 8, 16])
def test_cluster_form_round_trip(g):
    f = wgl32.Form("cluster", 1024, g)
    ints = wgl32.form_ints("wgln_chunk_batched", f)
    assert ints == [1024, g, 0]
    assert wgl32.form_of("wgln_chunk_batched", [7, 7] + ints) == f
    for name in ("wgl32_chunk", "wgln_chunk", "wgl32_chunk_batched"):
        with pytest.raises(ValueError, match="no cluster form"):
            wgl32.form_ints(name, f)


def _wide_batch(L, lanes_pad=6):
    """Five wave keys whose windows fit W = 32 L, of different widths
    and spans, valid and invalid, padded with a dummy lane (n_ok 0)."""
    specs = ([(4, 10, 4), (3, 12, 3), (5, 8, 5), (4, 9, 4), (3, 11, 3)]
             if L == 2 else
             [(8, 14, 6), (6, 12, 6), (7, 10, 7), (6, 13, 6), (7, 11, 7)])
    hists = [synth.adversarial_wave_history(n, width=w, span=s, seed=i,
                                            invalid=i % 2 == 0)
             for i, (n, w, s) in enumerate(specs)]
    encs = [encode.encode(cas_register(), h) for h in hists]
    b = batched.encode_batch(encs, batch_pad=lanes_pad)
    assert 32 * (L - 1) < b.window <= 32 * L
    return b


def test_wide_batch_has_a_dummy_lane():
    for L in (2, 3):
        b = _wide_batch(L)
        assert b.inv.shape[0] == 6 and int(b.n_ok[-1]) == 0


@pytest.mark.parametrize("g", [0, 3, 32])
def test_launch_refuses_a_bad_cluster_before_any_launch(g, monkeypatch):
    """A cluster of 0, 3 or 32 CTAs is refused by the form check, before
    scratch is made or the library is reached."""
    from jepsen_tpu_torch.ops import _native

    def no_launch(*a, **kw):
        raise AssertionError("launched")

    monkeypatch.setattr(_native, "launch", no_launch)
    monkeypatch.setattr(_native, "constant", no_launch)
    b = _wide_batch(2)
    K, L, ic, H, B = 16, 2, 8, 1 << 10, 64
    consts = batched.batch_consts(b, {"ic": ic}, 10**6, "cpu")
    carry = wgln.init_carry_batch(b.inv.shape[0], K, L, ic, H, B, 0, "cpu")
    with pytest.raises(ValueError, match="cluster"):
        wgl32.launch_batched("wgln_chunk_batched", consts, carry, K=K,
                             W=32 * L, L=L, ic=ic, H=H, B=B, rounds=4,
                             probes=4, form=wgl32.Form("cluster", 1024, g))
    # nor does the narrow kernel take a cluster, or the wide one a grid
    with pytest.raises(ValueError, match="no grid form"):
        wgl32.launch_batched("wgln_chunk_batched", consts, carry, K=K,
                             W=32 * L, L=L, ic=ic, H=H, B=B, rounds=4,
                             probes=4, form=wgl32.Form("grid", 1024, 4))


def test_cluster_control_words_match_the_kernel_source():
    """`wgl32.CLUSTER_CTL_WORDS` (the launch's and the admission bill's
    count) is the kernel's kClusterCtlWords: the control header and one
    new-row count per CTA of the largest cluster."""
    import re
    from pathlib import Path

    from jepsen_tpu_torch.ops import _native

    src = (Path(_native.CSRC) / "wgl_common.cuh").read_text()
    blocks = int(re.search(r"kCtlBlocks = (\d+)", src).group(1))
    most = int(re.search(r"kMaxClusterBlocks = (\d+)", src).group(1))
    assert "kClusterCtlWords = kCtlBlocks + kMaxClusterBlocks" in src
    assert most == wgl32.MAX_CLUSTER
    assert wgl32.CLUSTER_CTL_WORDS == blocks + most


def test_batched_wide_bill_holds_the_cluster_launch():
    """The lane-batched wide bill covers what a cluster launch holds:
    every lane's carry and its scratch with its control words."""
    from jepsen_tpu_torch import occupancy

    lanes, K, L, ic, H, B = 8, 256, 2, 8, 1 << 12, 1 << 10
    carry = wgln.init_carry_batch(lanes, K, L, ic, H, B, 0, "cpu")
    scratch = wgl32.scratch_words(K, 32 * L, ic, wgln.row_words(L, ic))
    held = (sum(t.numel() * t.element_size() for t in carry)
            + 4 * lanes * (scratch + wgl32.CLUSTER_CTL_WORDS))
    bill = occupancy.wgl_state_bytes("wgln", K=K, W_eff=32 * L, ic_eff=ic,
                                     L=L, H=H, B=B, n_pad=128, S=4, O=4,
                                     lanes=lanes)
    assert held <= bill


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_batch(L, tight, dev):
    """(consts, start carry, kw) of the wide batch on `dev`: the plan's
    K, H and B (or a 2^10 table and a 32-row backlog when `tight`), lane
    3 stopped by a budget of 150 configs."""
    b = _wide_batch(L)
    plan = batched.vmap_plan(b, b.window, 16)
    assert plan["L"] == L
    max_cfg = np.full(b.inv.shape[0], 10**6, np.int32)
    max_cfg[3] = 150
    consts = batched.batch_consts(b, plan, max_cfg, dev)
    K = 64
    H, B = ((1 << 10, 32) if tight else (plan["H"], plan["B"]))
    kw = dict(K=K, L=L, ic=plan["ic"], H=H, B=B, chunk=16,
              probes=plan["probes"])
    carry = wgln.init_carry_batch(b.inv.shape[0], K, L, plan["ic"], H, B, 0,
                                  dev)
    return consts, carry, kw


def _cluster_vs_plain(consts, carry, kw, form, n_chunks=3):
    """`n_chunks` chunks in `form` against `chunk_batched_ref` from the
    same carry each time; returns the rounds each lane ran."""
    rounds = []
    for step in range(n_chunks):
        ref_in = tuple(t.clone() for t in carry)
        summary = wgl32.launch_batched(
            "wgln_chunk_batched", consts, carry, K=kw["K"], W=32 * kw["L"],
            L=kw["L"], ic=kw["ic"], H=kw["H"], B=kw["B"],
            rounds=kw["chunk"], probes=kw["probes"], form=form)
        torch.cuda.synchronize()
        ref, ref_summary = wgln.chunk_batched_ref(consts, ref_in, **kw)
        assert torch.equal(summary, ref_summary), step
        for i, (a, b) in enumerate(zip(carry, ref)):
            assert torch.equal(a, b), (step, i)
        rounds.append(summary[:, 9].tolist())
    return rounds


@pytest.mark.gpu
@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("L", [2, 3])
@pytest.mark.parametrize("g", [2, 4, 8, 16])
def test_cluster_form_matches_plain_on_card(cuda_device, g, L, tight):
    _, cap = wgln.card_shape(cuda_device)
    if cap[g] < 1:
        pytest.skip(f"the card holds no cluster of {g} CTAs")
    consts, carry, kw = _card_batch(L, tight, cuda_device)
    rounds = _cluster_vs_plain(consts, carry, kw,
                               wgl32.Form("cluster", 1024, g))
    # the lanes stop at different rounds, the dummy lane after its first
    assert len({r for step in rounds for r in step}) > 1
    assert rounds[0][-1] == 1
    if tight:  # the backlog overflowed on some lane
        assert bool(carry[wgl32.FLAGS][:, 1].any())


@pytest.mark.gpu
def test_cluster_and_one_cta_forms_agree_on_card(cuda_device):
    """The cluster form at every g the card takes against one CTA a
    lane, from the same start: every carry leaf and summary equal."""
    consts, start, kw = _card_batch(2, False, cuda_device)
    one = wgl32.block_form(kw["K"], 64, kw["ic"],
                           wgln.row_words(2, kw["ic"]))
    _, cap = wgln.card_shape(cuda_device)
    outs = []
    for form in [one] + [wgl32.Form("cluster", 1024, g) for g in (2, 4, 8,
                                                                  16)
                         if cap[g] >= 1]:
        carry = tuple(t.clone() for t in start)
        s = wgl32.launch_batched(
            "wgln_chunk_batched", consts, carry, K=kw["K"], W=64, L=2,
            ic=kw["ic"], H=kw["H"], B=kw["B"], rounds=kw["chunk"],
            probes=kw["probes"], form=form)
        torch.cuda.synchronize()
        outs.append((s, carry))
    for s, carry in outs[1:]:
        assert torch.equal(s, outs[0][0])
        for a, b in zip(carry, outs[0][1]):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_chunk_batched_takes_the_cluster_form_on_card(cuda_device,
                                                      monkeypatch):
    """At a cluster shape the wrapper launches the cluster form (read
    from the launch's ints) and counts one launch."""
    from jepsen_tpu_torch.ops import _native

    sms, cap = wgln.card_shape(cuda_device)
    seen = []
    launch = _native.launch

    def spy(name, ptrs, ints, stream):
        if name == "wgln_chunk_batched":
            seen.append(wgl32.form_of(name, ints))
        return launch(name, ptrs, ints, stream)

    monkeypatch.setattr(_native, "launch", spy)
    consts, carry, kw = _card_batch(2, False, cuda_device)
    want = wgln.batched_form(consts.lanes, kw["K"], 2, kw["ic"], sms=sms,
                             capacity=cap)
    assert want.name == "cluster"
    ref_in = tuple(t.clone() for t in carry)
    before = wgln.chunk_batched.launches
    carry, summary = wgln.chunk_batched(consts, carry, **kw)
    torch.cuda.synchronize()
    assert wgln.chunk_batched.launches == before + 1 and seen == [want]
    ref, ref_summary = wgln.chunk_batched_ref(consts, ref_in, **kw)
    assert torch.equal(summary, ref_summary)
    for a, b in zip(carry, ref):
        assert torch.equal(a, b)
