"""Lane-batched WGL parity of the PyTorch/CUDA port.

The same padded batch of keys (the JAX package's `encode_batch`) goes
through the JAX package's lane-batched chunks — `jit(vmap(chunk_fn))`
(`_compiled_batched`) and, for the narrow kernel, `chunk_fn_batched`
(`_raw_batched(..., batched=True)`) — and the port's
`chunk_batched_ref`; the summary and every carry leaf must be
bit-identical (tolerance zero, everything is integer). The narrow batch
holds four lanes with different n_ok/n_info: one finds a linearization
in the first chunk, one in the second, one exhausts its search, one hits
its max_cfg; two chunks run. The wide batch runs at L 2 and 3.

`check_batched(device="cpu")` must give the JAX package's
`check_batched` on a one-device mesh (`default_mesh(n_devices=1)`,
which pins its vmap path and its lane count) the same verdicts, K,
W_pad, per-key configs_explored and rounds, for the vmap, stream and
auto strategies. The `gpu` cases hold the two batched kernels against
their plain versions on the card, one at more lanes than the card has
SMs.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.parallel import batched as jbatched
from jepsen_tpu.parallel import check_batched as jcheck_batched
from jepsen_tpu.parallel import default_mesh
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch.models import core as tmodels
from jepsen_tpu_torch.ops import encode as tencode
from jepsen_tpu_torch.ops import wgl32 as tw
from jepsen_tpu_torch.ops import wgln as tn
from jepsen_tpu_torch.parallel import batched as tbatched
from jepsen_tpu_torch.parallel import check_batched as tcheck_batched

# the parity batches are small: intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

PROBES = 4
NARROW = dict(W=16, ic=8, K=4, H=1 << 10, B=64, chunk=32)
WIDE = dict(ic=8, K=16, H=1 << 12, B=256, chunk=16)
# per-lane budgets: the last lane stops at its max_cfg
MAX_CFG = np.array([10**6, 10**6, 10**6, 150], np.int32)


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


def _narrow_hists():
    return [jsynth.cas_register_history(
        40 + 20 * i, n_procs=3 + i % 2, seed=i, crash_p=0.05 * (i % 3),
        lie_p=0.1 if i == 2 else 0.0) for i in range(4)]


def _wide_hists():
    # width 10, span 4: window 41 (> 32, the wide branch)
    return [jsynth.adversarial_wave_history(4, width=10, span=4, seed=s,
                                            invalid=(s % 2 == 0))
            for s in range(3)]


_BATCH: dict = {}


def _batch(kind):
    if kind not in _BATCH:
        hists = _narrow_hists() if kind == "narrow" else _wide_hists()
        encs = [jencode.encode(jmodels.cas_register(), h) for h in hists]
        _BATCH[kind] = jbatched.encode_batch(encs)
    return _BATCH[kind]


def _np_consts(b, ic, max_cfg):
    return (b.inv, b.ret, b.opcode, b.sufminret, b.inv_info[:, :ic],
            b.opcode_info[:, :ic], b.table, b.n_ok, b.n_info, max_cfg)


_JIT: dict = {}


def _jax_fns(kind, form, L=0):
    """(init, chunk) of the JAX package: `form` "vmap" is
    `_compiled_batched`, "lanes" the narrow `chunk_fn_batched`."""
    key = (kind, form, L)
    if key not in _JIT:
        b = _batch(kind)
        p = NARROW if kind == "narrow" else dict(WIDE, W=32 * L)
        args = (b.n_pad, p["ic"], p["W"], b.table_s, b.table_o, p["K"],
                p["H"], p["B"], p["chunk"], PROBES)
        if form == "vmap":
            _JIT[key] = jbatched._compiled_batched(*args, L=L)
        else:
            init_fn, chunk_fn = jbatched._raw_batched(*args, batched=True)
            _JIT[key] = (jax.vmap(init_fn), jax.jit(chunk_fn))
    return _JIT[key]


def _assert_same(port_carry, port_summary, jax_out, jax_summary, what):
    np.testing.assert_array_equal(port_summary.numpy(),
                                  np.asarray(jax_summary),
                                  err_msg=f"{what}: summary")
    for i, (a, b) in enumerate(zip(tw.carry_batch_to_numpy(port_carry),
                                   jax_out)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: leaf {i}")


def _run_parity(kind, form, L, port_chunk, n_chunks, max_cfg):
    b = _batch(kind)
    p = NARROW if kind == "narrow" else WIDE
    cn = _np_consts(b, p["ic"], max_cfg)
    consts_j = tuple(jnp.asarray(x) for x in cn)
    consts_t = tw.batch_consts_from_numpy(*cn, device="cpu")
    vinit, vchunk = _jax_fns(kind, form, L)
    carry = vinit(jnp.zeros(b.inv.shape[0], jnp.int32))
    summaries = []
    for step in range(n_chunks):
        leaves = [np.asarray(x) for x in carry]
        port, port_summary = port_chunk(consts_t,
                                        tw.carry_from_numpy(leaves, "cpu"))
        carry, summary = vchunk(consts_j, tuple(jnp.asarray(x)
                                                for x in leaves))
        _assert_same(port, port_summary, carry, summary,
                     f"{kind} {form} L={L} chunk {step}")
        summaries.append(np.asarray(summary))
    return summaries


@pytest.mark.parametrize("form", ["vmap", "lanes"])
def test_wgl32_chunk_batched_ref_matches_jax(form):
    p = NARROW
    summaries = _run_parity(
        "narrow", form, 0, lambda c, k: tw.chunk_batched_ref(
            c, k, K=p["K"], W=p["W"], ic=p["ic"], H=p["H"], B=p["B"],
            chunk=p["chunk"], probes=PROBES), 2, MAX_CFG)
    first, second = summaries
    # the batch covers the lane endings the halt masks must freeze
    assert first[0, 1] and not first[1, 1] and second[1, 1]  # found
    assert first[2, 0] == 0 and not first[2, 1]               # exhausted
    assert first[3, 4] < MAX_CFG[3] <= second[3, 4]           # budget
    assert second[3, 0] > 0 and second[3, 5] < NARROW["chunk"]
    assert len(set(_batch("narrow").n_info)) > 1
    assert second[0, 4 + 1] == 0   # a stopped lane runs no round


@pytest.mark.parametrize("L", [2, 3])
def test_wgln_chunk_batched_ref_matches_jax(L):
    p = WIDE
    _run_parity("wide", "vmap", L, lambda c, k: tn.chunk_batched_ref(
        c, k, K=p["K"], L=L, ic=p["ic"], H=p["H"], B=p["B"],
        chunk=p["chunk"], probes=PROBES), 2,
        np.full(3, 10**6, np.int32))


def test_init_carry_batch_matches_jax():
    b = _batch("narrow")
    p = NARROW
    vinit, _ = _jax_fns("narrow", "vmap")
    want = vinit(jnp.zeros(4, jnp.int32))
    got = tw.init_carry_batch(4, p["K"], tw.row_words(p["ic"]), p["H"],
                              p["B"], 0, "cpu")
    for a, w in zip(tw.carry_batch_to_numpy(got), want):
        assert a.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(a, np.asarray(w))
    assert b.inv.shape[0] == 4


def test_batch_consts_lane_equals_single_consts():
    b = _batch("narrow")
    cn = _np_consts(b, NARROW["ic"], MAX_CFG)
    bc = tw.batch_consts_from_numpy(*cn, device="cpu")
    for i in range(4):
        one = tw.consts_from_numpy(*(a[i] for a in cn), device="cpu")
        lane = bc.lane(i)
        for f in ("meta", "tk", "iinv", "iopc"):
            assert torch.equal(getattr(lane, f), getattr(one, f)), (i, f)
        for f in ("n_pad", "S", "n_ok", "n_info", "max_cfg"):
            assert getattr(lane, f) == getattr(one, f), (i, f)


def test_wrappers_run_the_host_kernels_on_cpu():
    """On CPU tensors both batched wrappers run the host kernels
    (`wgl32_host_chunk_batched`, `wgln_host_chunk_batched`), equal to
    their plain versions, and launch no CUDA kernel."""
    p = NARROW
    b = _batch("narrow")
    bc = tw.batch_consts_from_numpy(*_np_consts(b, p["ic"], MAX_CFG),
                                    device="cpu")
    kw = dict(K=p["K"], W=p["W"], ic=p["ic"], H=p["H"], B=p["B"],
              chunk=p["chunk"], probes=PROBES)
    start = tw.init_carry_batch(4, p["K"], tw.row_words(p["ic"]), p["H"],
                                p["B"], 0, "cpu")
    before = (tw.chunk_batched.launches, tn.chunk_batched.launches)
    calls = (tw.chunk_batched.host_calls, tn.chunk_batched.host_calls)
    c1, s1 = tw.chunk_batched(bc, tuple(t.clone() for t in start), **kw)
    c2, s2 = tw.chunk_batched_ref(bc, tuple(t.clone() for t in start), **kw)
    assert torch.equal(s1, s2)
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))
    w = WIDE
    wb = _batch("wide")
    wc = tw.batch_consts_from_numpy(
        *_np_consts(wb, w["ic"], 10**6), device="cpu")
    wkw = dict(K=w["K"], L=2, ic=w["ic"], H=w["H"], B=w["B"],
               chunk=w["chunk"], probes=PROBES)
    wstart = tn.init_carry_batch(3, w["K"], 2, w["ic"], w["H"], w["B"], 0,
                                 "cpu")
    d1, t1 = tn.chunk_batched(wc, tuple(t.clone() for t in wstart), **wkw)
    d2, t2 = tn.chunk_batched_ref(wc, tuple(t.clone() for t in wstart),
                                  **wkw)
    assert torch.equal(t1, t2)
    assert all(torch.equal(a, b) for a, b in zip(d1, d2))
    assert (tw.chunk_batched.launches, tn.chunk_batched.launches) == before
    assert (tw.chunk_batched.host_calls, tn.chunk_batched.host_calls) == (
        calls[0] + 1, calls[1] + 1)


def test_tally_counts_the_const_entries_the_lanes_reach():
    """A tally (the bounds' data-dependent counts) leaves the search as
    it is, sums the lanes' own tallies, and charges no more const bytes
    than the whole tables: a lane that stops early reaches only the meta
    rows its windows cover."""
    p = NARROW
    b = _batch("narrow")
    bc = tw.batch_consts_from_numpy(*_np_consts(b, p["ic"], MAX_CFG),
                                    device="cpu")
    kw = dict(K=p["K"], W=p["W"], ic=p["ic"], H=p["H"], B=p["B"],
              chunk=p["chunk"], probes=PROBES)
    start = tw.init_carry_batch(4, p["K"], tw.row_words(p["ic"]), p["H"],
                                p["B"], 0, "cpu")
    tally: dict = {}
    c1, s1 = tw.chunk_batched_ref(bc, tuple(t.clone() for t in start),
                                  tally=tally, **kw)
    c2, s2 = tw.chunk_batched_ref(bc, tuple(t.clone() for t in start), **kw)
    assert torch.equal(s1, s2)
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))
    lanes = []
    for i in range(4):
        one: dict = {}
        tw.chunk_ref(bc.lane(i), tuple(t[i].clone() for t in start),
                     tally=one, **kw)
        lanes.append(one)
    for k in ("probed", "const_bytes"):
        assert tally[k] == sum(t[k] for t in lanes), k
    whole = 4 * (bc.meta[0].numel() + bc.tk[0].numel()
                 + bc.iinv[0].numel() + bc.iopc[0].numel())
    for i, t in enumerate(lanes):
        assert 0 < t["const_bytes"] <= whole, i
        # meta rows up to the lane's largest base (summary stats[2])
        # plus its window, and at most every transition and info slot
        rows = min(int(s1[i, 6]) + p["W"], b.n_pad) + 1
        assert t["const_bytes"] <= 16 * rows + 4 * (
            bc.tk[0].numel() + 2 * int(b.n_info[i])), i


def test_batched_launch_checks_reject_bad_inputs():
    """The batched wrapper's checks before a launch (they run on any
    device)."""
    p = NARROW
    b = _batch("narrow")
    bc = tw.batch_consts_from_numpy(*_np_consts(b, p["ic"], MAX_CFG),
                                    device="cpu")
    kw = dict(K=p["K"], W=p["W"], ic=p["ic"], H=p["H"], B=p["B"],
              chunk=p["chunk"], probes=PROBES, lanes=4)
    good = tw.init_carry_batch(4, p["K"], tw.row_words(p["ic"]), p["H"],
                               p["B"], 0, "cpu")
    tw._check_launch(bc, good, **kw)
    three = tw.init_carry_batch(3, p["K"], tw.row_words(p["ic"]), p["H"],
                                p["B"], 0, "cpu")
    short = tw.BatchConsts(**{**bc.__dict__, "max_cfg": bc.max_cfg[:3]})
    bad_cases = [
        (bc, good, dict(kw, W=33)),
        (bc, good, dict(kw, H=p["H"] // 2)),
        (bc, three, kw),                                    # lanes 3 != 4
        (bc, good[:4] + (good[4].to(torch.int64),) + good[5:], kw),
        (short, good, kw),                                  # max_cfg (3,)
        (bc, good, dict(kw, ic=16)),                        # iinv (4, 8)
    ]
    for consts, carry, args in bad_cases:
        with pytest.raises(ValueError):
            tw._check_launch(consts, carry, **args)


# --- the host side: buckets, batches, capacities ---------------------------

def _encs(hists):
    return ([jencode.encode(jmodels.cas_register(), h) for h in hists],
            [tencode.encode(tmodels.cas_register(), to_port(h))
             for h in hists])


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_shared_shape_bucket_matches_jax(kind):
    hists = _narrow_hists() if kind == "narrow" else _wide_hists()
    je, te = _encs(hists)
    assert tbatched.shared_shape_bucket(te) == \
        jbatched.shared_shape_bucket(je)
    assert tbatched.shared_shape_bucket([]) is None


def test_apply_bucket_matches_jax():
    """A streamed key padded into its group's shared bucket equals the
    JAX package's padding of it."""
    from jepsen_tpu.ops import wgl as jwgl
    from jepsen_tpu_torch.ops import wgl as twgl
    je, te = _encs(_mixed_hists())
    bucket = jbatched.shared_shape_bucket(je)
    for a, b in zip(je, te):
        want, got = jwgl._apply_bucket(a, bucket), twgl._apply_bucket(b, bucket)
        for f in ("inv", "ret", "opcode", "sufminret", "inv_info",
                  "opcode_info", "table"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)


@pytest.mark.parametrize("kind", ["narrow", "mixed"])
def test_encode_batch_matches_jax(kind):
    hists = _narrow_hists()
    if kind == "mixed":
        hists = _mixed_hists() + _wide_hists()[:1]
    je, te = _encs(hists)
    want = jbatched.encode_batch(je)
    got = tbatched.encode_batch(te)
    for f in want.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("bk,W,n_pad,L", [
    (1, 8, 64, 0), (4, 16, 128, 0), (100, 32, 1536, 0), (300, 32, 4096, 0),
    (8, 96, 256, 3), (2, 64, 64, 2), (64, 1024, 2048, 32)])
def test_batch_capacities_match_jax(bk, W, n_pad, L):
    assert tbatched._batch_capacities(bk, W, n_pad, L) == \
        jbatched._batch_capacities(bk, W, n_pad, L)


# --- check_batched against the JAX package's ------------------------------

def _compare(jr, tr, what):
    for i, (a, b) in enumerate(zip(jr, tr)):
        for k in ("valid?", "K", "W", "W_pad", "configs_explored",
                  "op_count", "cause", "max_linearized", "batch_keys"):
            assert a.get(k) == b.get(k), (what, i, k, a.get(k), b.get(k))
        assert (a.get("util") or {}).get("rounds") == \
            (b.get("util") or {}).get("rounds"), (what, i)
        assert a.get("occupancy") == b.get("occupancy"), (what, i)


def _mixed_hists():
    return [jsynth.cas_register_history(
        30 + 10 * s, n_procs=3, seed=s, crash_p=0.05,
        lie_p=0.08 if s % 3 == 0 else 0.0) for s in range(6)]


@pytest.mark.parametrize("strategy", ["vmap", "stream", "auto", "mesh"])
def test_check_batched_matches_jax(strategy):
    hists = _mixed_hists()
    # the JAX package's own single-device decision: an explicit
    # one-device mesh pins its vmap path; "stream" streams
    jstrategy = "stream" if strategy == "stream" else "vmap"
    jr = jcheck_batched(jmodels.cas_register(), hists,
                        oracle_fallback=False, strategy=jstrategy,
                        mesh=default_mesh(n_devices=1))
    tr = tcheck_batched(tmodels.cas_register(),
                        [to_port(h) for h in hists], oracle_fallback=False,
                        strategy=strategy, device="cpu")
    _compare(jr, tr, strategy)
    assert [r["valid?"] for r in tr].count(False) >= 1
    engines = {r["shard"]["engine"] for r in tr}
    assert engines == ({"device"} if strategy == "stream"
                       else {"device-vmap"})


def test_check_batched_wide_vmap_matches_jax():
    hists = _wide_hists()[:2]
    jr = jcheck_batched(jmodels.cas_register(), hists,
                        oracle_fallback=False, strategy="vmap", chunk=64,
                        mesh=default_mesh(n_devices=1))
    tr = tcheck_batched(tmodels.cas_register(),
                        [to_port(h) for h in hists], oracle_fallback=False,
                        strategy="vmap", chunk=64, device="cpu")
    _compare(jr, tr, "wide")
    assert all(r["W_pad"] == 64 for r in tr)
    assert [r["valid?"] for r in tr] == [False, True]


def test_check_batched_auto_streams_long_keys_on_cpu():
    """On the CPU, "auto" streams when a key has more than 512 ok ops
    (the reference's host rule); each streamed key equals the JAX
    package's streamed key."""
    hists = [jsynth.cas_register_history(1100, n_procs=3, seed=4),
             jsynth.cas_register_history(60, n_procs=3, seed=5,
                                         lie_p=0.1)]
    jr = jcheck_batched(jmodels.cas_register(), hists,
                        oracle_fallback=False, strategy="stream")
    tr = tcheck_batched(tmodels.cas_register(),
                        [to_port(h) for h in hists], oracle_fallback=False,
                        strategy="auto", device="cpu")
    _compare(jr, tr, "auto-stream")
    assert tr[0]["op_count"] > 512
    assert [r["shard"]["engine"] for r in tr] == ["device", "device"]


def test_check_batched_host_decided_keys():
    """Keys with no ok op are True on the host; the rest are lanes."""
    from jepsen_tpu import history as jh
    hists = [jh.History(),
             jsynth.cas_register_history(20, seed=1),
             jh.History([jh.invoke(0, "read", None), jh.ok(0, "read", 7)])]
    jr = jcheck_batched(jmodels.cas_register(), hists, strategy="vmap",
                        mesh=default_mesh(n_devices=1))
    tr = tcheck_batched(tmodels.cas_register(), [to_port(h) for h in hists],
                        strategy="vmap", device="cpu")
    assert [r["valid?"] for r in tr] == [r["valid?"] for r in jr] == \
        [True, True, False]
    assert tr[0]["shard"]["engine"] == "host"
    assert tr[1]["shard"]["key_index"] == 1


def test_check_batched_oracle_decides_device_unknowns():
    """A lane stopped by its config budget is "unknown" on the device
    and decided by the host oracle with oracle_fallback."""
    hists = [to_port(h) for h in _mixed_hists()[:4]]
    raw = tcheck_batched(tmodels.cas_register(), hists, max_configs=40,
                         oracle_fallback=False, strategy="vmap",
                         device="cpu")
    assert any(r.get("cause") == "config-limit" for r in raw)
    res = tcheck_batched(tmodels.cas_register(), hists, max_configs=40,
                         strategy="vmap", device="cpu")
    for r0, r in zip(raw, res):
        if r0["valid?"] == "unknown":
            assert r["engine"] == "oracle-fallback"
            assert r["device_cause"] == "config-limit"
            assert r["valid?"] in (True, False)


def test_check_batched_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcheck_batched(tmodels.cas_register(),
                       [to_port(h) for h in _mixed_hists()[:2]])
    with pytest.raises(ValueError, match="strategy"):
        tcheck_batched(tmodels.cas_register(), [], strategy="pmap",
                       device="cpu")


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_vs_plain(kernel, plain, consts, carry, n_chunks, **kw):
    for step in range(n_chunks):
        ref_in = tuple(t.clone() for t in carry)
        launches = kernel.launches
        carry, summary = kernel(consts, carry, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == launches + 1
        ref, ref_summary = plain(consts, ref_in, **kw)
        assert torch.equal(summary, ref_summary), step
        for i, (a, b) in enumerate(zip(carry, ref)):
            assert torch.equal(a, b), (step, i)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [4, 140])
def test_wgl32_chunk_batched_kernel_matches_plain_on_card(cuda_device,
                                                         lanes):
    """The narrow batch, tiled to `lanes` lanes (140 > 132 SMs: more
    than one wave), kernel against `chunk_batched_ref`."""
    p = NARROW
    b = _batch("narrow")
    idx = np.arange(lanes) % 4
    cn = tuple(np.asarray(a)[idx] for a in _np_consts(b, p["ic"], MAX_CFG))
    consts = tw.batch_consts_from_numpy(*cn, device=cuda_device)
    carry = tw.init_carry_batch(lanes, p["K"], tw.row_words(p["ic"]),
                                p["H"], p["B"], 0, cuda_device)
    _card_vs_plain(tw.chunk_batched, tw.chunk_batched_ref, consts, carry, 2,
                   K=p["K"], W=p["W"], ic=p["ic"], H=p["H"], B=p["B"],
                   chunk=p["chunk"], probes=PROBES)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [2, 3])
def test_wgln_chunk_batched_kernel_matches_plain_on_card(cuda_device, L):
    p = WIDE
    b = _batch("wide")
    consts = tw.batch_consts_from_numpy(*_np_consts(b, p["ic"], 10**6),
                                        device=cuda_device)
    carry = tn.init_carry_batch(3, p["K"], L, p["ic"], p["H"], p["B"], 0,
                                cuda_device)
    _card_vs_plain(tn.chunk_batched, tn.chunk_batched_ref, consts, carry, 2,
                   K=p["K"], L=L, ic=p["ic"], H=p["H"], B=p["B"],
                   chunk=p["chunk"], probes=PROBES)


@pytest.mark.gpu
def test_check_batched_on_card_matches_cpu(cuda_device):
    hists = [to_port(h) for h in _mixed_hists()]
    cpu = tcheck_batched(tmodels.cas_register(), hists,
                         oracle_fallback=False, strategy="vmap", device="cpu")
    before = tw.chunk_batched.launches
    card = tcheck_batched(tmodels.cas_register(), hists,
                          oracle_fallback=False, strategy="vmap")
    assert tw.chunk_batched.launches > before
    for a, b in zip(cpu, card):
        assert (a["valid?"], a["configs_explored"], a["util"]["rounds"]) == \
            (b["valid?"], b["configs_explored"], b["util"]["rounds"])
