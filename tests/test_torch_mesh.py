"""The mesh lane scheduler of the PyTorch/CUDA port against the JAX
package's.

The port's "mesh" is a list of devices; here it is `["cpu"] * n`, and
the JAX side runs on the conftest's fake 8-device CPU mesh
(`default_mesh(n_devices=n)`). Held exactly, with no tolerance (every
value is an integer):

  * `reset_lanes_ref` against the JAX `_reset_fn()` and
    `migrate_frontier_batch` against the JAX `_migrate_fn(k)` (up, down
    and no-op), bit for bit on every carry leaf, narrow and wide;
  * `_GroupRun`'s pack/unpack round trip, a reload after a retire, and
    its LPT and block queues;
  * `check_mesh(steal=False)` at 2 and 4 devices: every key's verdict,
    configs_explored, rounds, K, shard and slot, and the run's
    rebuckets and final K; with stealing on, the verdicts, and under
    `assign="block"` the idle-pull events;
  * `check_batched`'s routing ("auto" takes the mesh for 4 or more keys
    on 2 or more devices and degrades with one), its vmap path over two
    devices, `check_streamed`'s worker pool over two devices, and
    `encode_batch(batch_pad=)`.

The `gpu` cases hold the `wgl_lane_reset` and `wgl_frontier_migrate`
kernels against their plain versions on the card: the reset with its
mask by value (1, 4, 64 lanes) and by index (65, 100), unmasked lanes
untouched, its launch count, and a wrong leaf raising before any launch.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jepsen_tpu import fleet as jfleet
from jepsen_tpu import independent as jind
from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.parallel import batched as jbatched
from jepsen_tpu.parallel import check_batched as jcheck_batched
from jepsen_tpu.parallel import default_mesh
from jepsen_tpu.parallel import mesh as jmesh
from jepsen_tpu_torch import fleet as tfleet
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import util as tutil
from jepsen_tpu_torch.models import core as tmodels
from jepsen_tpu_torch.ops import adapt as tadapt
from jepsen_tpu_torch.ops import encode as tencode
from jepsen_tpu_torch.ops import wgl32 as tw
from jepsen_tpu_torch.parallel import batched as tbatched
from jepsen_tpu_torch.parallel import check_batched as tcheck_batched
from jepsen_tpu_torch.parallel import mesh as tmesh

# intra-op threads only contend with the other test workers
torch.set_num_threads(1)


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


def _keys():
    """Seven valid keys of 60-150 ops and one invalid one (key 3)."""
    return [jsynth.cas_register_history(
        60 + 15 * s, n_procs=3, seed=s, crash_p=0.03,
        lie_p=0.1 if s == 3 else 0.0) for s in range(8)]


def _waves():
    # width 10, span 4: window 41 (> 32, the wide group)
    return [jsynth.adversarial_wave_history(4, width=10, span=4, seed=s,
                                            invalid=(s % 2 == 0))
            for s in range(4)]


def _encs(hists):
    return ([jencode.encode(jmodels.cas_register(), h) for h in hists],
            [tencode.encode(tmodels.cas_register(), to_port(h))
             for h in hists])


# --- the carry programs -------------------------------------------------------

def _jax_init(L):
    """The JAX package's batched init at small shapes: (init fn, K, C,
    mst_col)."""
    W, ic, K, H, B = (32 * L if L else 16), 8, 8, 1 << 8, 32
    init_fn, _ = jbatched._raw_batched(64, ic, W, 4, 4, K, H, B, 16, 4, L=L)
    C = (2 + L + 1) if L else tw.row_words(ic)
    return jax.vmap(init_fn), K, C, (1 + L if L else 2)


def _random_carry(rng, init, lanes):
    """A carry of random leaves with the init tree's shapes and dtypes."""
    out = []
    for leaf in init(jnp.zeros(lanes, jnp.int32)):
        a = np.asarray(leaf)
        if a.dtype == bool:
            out.append(rng.random(a.shape) < 0.5)
        else:
            out.append(rng.integers(-2**31, 2**31, a.shape,
                                    dtype=np.int64).astype(np.int32)
                       .view(a.dtype))
    return out


def _same_leaves(port_carry, jax_leaves, what):
    for i, (a, b) in enumerate(zip(tw.carry_batch_to_numpy(port_carry),
                                   jax_leaves)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("L", [0, 2])
def test_reset_lanes_ref_matches_jax_reset_fn(L):
    rng = np.random.default_rng(L)
    init, K, C, mst_col = _jax_init(L)
    lanes = 5
    leaves = _random_carry(rng, init, lanes)
    mask = np.array([True, False, True, True, False])
    want = jmesh._reset_fn()(tuple(jnp.asarray(x) for x in leaves),
                             init(jnp.zeros(lanes, jnp.int32)),
                             jnp.asarray(mask))
    port = tw.carry_from_numpy(leaves, "cpu")
    got = tmesh.reset_lanes_ref(port, mask, mst_col=mst_col)
    assert got is port   # in place
    _same_leaves(got, want, f"reset L={L}")
    # the wrapper takes the plain version on the CPU and launches nothing
    port2 = tw.carry_from_numpy(leaves, "cpu")
    before = tmesh.reset_lanes.launches
    tmesh.reset_lanes(port2, torch.as_tensor(mask), mst_col=mst_col)
    assert tmesh.reset_lanes.launches == before
    _same_leaves(port2, want, f"reset wrapper L={L}")
    # a nonzero model state lands in row 0 of the reset lanes only
    port3 = tw.carry_from_numpy(leaves, "cpu")
    tmesh.reset_lanes_ref(port3, mask, mst_col=mst_col, mstate0=3)
    assert (port3[tw.FR][mask, 0, mst_col] == 3).all()
    assert torch.equal(port3[tw.FR][~mask], port[tw.FR][~mask])


@pytest.mark.parametrize("L", [0, 2])
@pytest.mark.parametrize("k_new", [32, 4, 8])   # up, down, no-op
def test_migrate_frontier_batch_matches_jax_migrate_fn(L, k_new):
    rng = np.random.default_rng(10 + L)
    init, K, C, _ = _jax_init(L)
    leaves = _random_carry(rng, init, 3)
    want = jmesh._migrate_fn(k_new)(tuple(jnp.asarray(x) for x in leaves))
    port = tw.carry_from_numpy(leaves, "cpu")
    before = tmesh.migrate_lanes.launches
    got = tmesh.migrate_lanes(port, k_new)
    assert tmesh.migrate_lanes.launches == before
    _same_leaves(got, want, f"migrate L={L} to {k_new}")
    assert got[0].shape == (3, k_new, C)
    assert all(a is b for a, b in zip(got[1:], port[1:]))
    if k_new == K:
        assert tadapt.migrate_frontier_batch(port, k_new) is port


# --- lane packing and queues ----------------------------------------------------

def _group(mod, encs, devices, **kw):
    kw.setdefault("chunk", 64)
    kw.setdefault("lanes_per_device", 1)
    kw.setdefault("assign", "lpt")
    kw.setdefault("deadline", None)
    kw.setdefault("max_configs", 2**20)
    kw.setdefault("oracle_fallback", False)
    kw.setdefault("key_indices", None)
    kw.setdefault("group", "narrow")
    return mod._GroupRun(encs, list(range(len(encs))), devices, **kw)


def test_pack_unpack_roundtrip_and_reload():
    m = tmodels.cas_register()
    encs = [tencode.encode(m, to_port(jsynth.cas_register_history(
        20 + 8 * i, n_procs=3, seed=i))) for i in range(3)]
    gr = _group(tmesh, encs, ["cpu"] * 8)
    for sl, e in enumerate(encs):
        gr.load_slot(sl, e)
        back = gr.unpack_slot(sl)
        real = int((np.asarray(e.inv) < tencode.INF).sum())
        for f, g in (("inv", "inv"), ("ret", "ret"), ("opcode", "opcode")):
            np.testing.assert_array_equal(back[f], getattr(e, g)[:real])
        assert (back["n_ok"], back["n_info"]) == (e.n_ok, e.n_info)
    gr.clear_slot(0)
    assert gr.unpack_slot(0)["n_ok"] == 0 and (gr.c_inv[0] == tencode.INF).all()
    # a slot reused for a smaller key keeps none of the old rows
    big, small = (tencode.encode(m, to_port(jsynth.cas_register_history(
        n, seed=s))) for n, s in ((60, 1), (16, 2)))
    gr.load_slot(1, big)
    gr.load_slot(1, small)
    real = int((np.asarray(small.inv) < tencode.INF).sum())
    np.testing.assert_array_equal(gr.unpack_slot(1)["inv"], small.inv[:real])
    # shard consts are the slots' block, as BatchConsts
    bc = gr.shard_consts(1)
    assert bc.lanes == 1 and int(bc.n_ok[0]) == small.n_ok


@pytest.mark.parametrize("assign", ["lpt", "block"])
def test_queues_match_jax(assign):
    hists = [jsynth.cas_register_history(16 + 8 * (i % 5), n_procs=3,
                                         seed=i) for i in range(16)]
    je, te = _encs(hists)
    jg = _group(jmesh, je, default_mesh(), assign=assign)
    tg = _group(tmesh, te, ["cpu"] * 8, assign=assign)
    assert [list(q) for q in tg.queues] == [list(q) for q in jg.queues]
    assert tg.params == {k: v for k, v in jg.params.items() if k != "accel"}
    assert tg.labels == ["cpu"] + [f"cpu#{k}" for k in range(1, 8)]


# --- check_mesh against the JAX package's ---------------------------------------

KEY_FIELDS = ("valid?", "configs_explored", "K", "W", "W_pad", "op_count",
              "max_linearized", "mesh")


def _compare_keys(jr, tr, what):
    assert len(jr) == len(tr)
    for i, (a, b) in enumerate(zip(jr, tr)):
        for k in KEY_FIELDS:
            assert a.get(k) == b.get(k), (what, i, k, a.get(k), b.get(k))
        assert a["util"]["rounds"] == b["util"]["rounds"], (what, i)
        assert b["shard"]["engine"] == "device-mesh"


def _mesh_pair(hists, n, **kw):
    je, te = _encs(hists)
    jr = jmesh.check_mesh(jmodels.cas_register(), hists, encs=je,
                          mesh=default_mesh(n_devices=n),
                          oracle_fallback=False, **kw)
    jsum = jmesh.last_summary()
    tr = tmesh.check_mesh(tmodels.cas_register(),
                          [to_port(h) for h in hists], encs=te,
                          devices=["cpu"] * n, oracle_fallback=False, **kw)
    return jr, jsum, tr, tmesh.last_summary()


@pytest.mark.parametrize("n", [2, 4])
def test_check_mesh_no_steal_matches_jax(n):
    jr, jsum, tr, tsum = _mesh_pair(_keys(), n, steal=False,
                                    lanes_per_device=1, chunk=32)
    _compare_keys(jr, tr, f"mesh n={n}")
    assert [r["valid?"] for r in tr].count(False) == 1
    for k in ("rebuckets", "steals", "n_devices", "keys"):
        assert tsum[k] == jsum[k], k
    assert [g["K_final"] for g in tsum["groups"]] == \
        [g["K_final"] for g in jsum["groups"]]
    # every slot was refilled (8 keys through n single-lane slots), each
    # refill reset its lane
    assert tsum["refills"] == 8 - n and tsum["resets"] >= 1
    assert tsum["polls"] >= 2 and tsum["steals"] == 0


def test_check_mesh_wide_group_matches_jax():
    hists = _keys()[:3] + _waves()
    jr, jsum, tr, tsum = _mesh_pair(hists, 2, steal=False,
                                    lanes_per_device=2, chunk=32)
    _compare_keys(jr, tr, "mesh narrow + wide")
    assert [g["group"] for g in tsum["groups"]] == ["narrow", "wide"]
    assert [g["K_final"] for g in tsum["groups"]] == \
        [g["K_final"] for g in jsum["groups"]]
    assert tsum["rebuckets"] == jsum["rebuckets"]


def _no_skew_plans(monkeypatch):
    # work-skew steals follow wall clocks; with them off, only the
    # idle pull (which reads queues and slots) moves keys
    monkeypatch.setattr(jfleet, "steal_plan", lambda *a, **k: None)
    monkeypatch.setattr(tfleet, "steal_plan", lambda *a, **k: None)


def test_check_mesh_idle_pull_matches_jax(monkeypatch):
    _no_skew_plans(monkeypatch)
    # block queues: shard 0 gets four short keys, shard 1 four long ones
    hists = [jsynth.cas_register_history(16, n_procs=3, seed=s)
             for s in range(4)] + _keys()[4:]
    jr, jsum, tr, tsum = _mesh_pair(hists, 2, steal=True, assign="block",
                                    lanes_per_device=1, chunk=16)
    assert [r["valid?"] for r in tr] == [r["valid?"] for r in jr]

    def idle(summary):
        return [{k: e.get(k) for k in ("poll", "round", "from_shard",
                                       "to_shard", "keys")}
                for g in summary["groups"] for e in g["events"]
                if e.get("reason") == "idle"]
    assert idle(tsum) == idle(jsum)
    assert idle(tsum), "the block queues must starve one shard"
    _compare_keys(jr, tr, "idle pull")
    mine = [p for p in tfleet.sched_events("mesh_sched")
            if p.get("reason") == "idle"]
    assert mine and mine[-1]["keys"] == idle(tsum)[-1]["keys"]


def test_check_mesh_steal_verdicts_match_jax():
    hists = _keys()
    jr, _, tr, tsum = _mesh_pair(hists, 2, steal=True, lanes_per_device=1,
                                 chunk=16)
    assert [r["valid?"] for r in tr] == [r["valid?"] for r in jr]
    assert sum(v["keys"] for v in tsum["per_shard"].values()) == len(hists)


def test_check_mesh_degrades_below_two():
    _, te = _encs(_keys()[:4])
    hists = [to_port(h) for h in _keys()[:4]]
    assert tmesh.check_mesh(tmodels.cas_register(), hists, encs=te,
                            devices=["cpu"]) is None
    assert tmesh.check_mesh(tmodels.cas_register(), hists[:1],
                            encs=te[:1], devices=["cpu"] * 2) is None


# --- check_batched, check_streamed, encode_batch ----------------------------------

def test_check_batched_auto_routes_to_the_mesh():
    hists = [to_port(h) for h in _keys()[:5]]
    two = tcheck_batched(tmodels.cas_register(), hists,
                         oracle_fallback=False, devices=["cpu"] * 2)
    assert {r["shard"]["engine"] for r in two} == {"device-mesh"}
    assert {r["shard"]["device"] for r in two} == {"cpu", "cpu#1"}
    one = tcheck_batched(tmodels.cas_register(), hists,
                         oracle_fallback=False, devices=["cpu"])
    assert {r["shard"]["engine"] for r in one} == {"device-vmap"}
    forced = tcheck_batched(tmodels.cas_register(), hists,
                            oracle_fallback=False, strategy="mesh",
                            device="cpu")
    assert {r["shard"]["engine"] for r in forced} == {"device-vmap"}
    for a, b in zip(two, one):
        assert a["valid?"] == b["valid?"]


def test_check_batched_mesh_strategy_matches_jax():
    # 5 keys over 2 devices: 3 slots a shard hold them all, so no key
    # waits in a queue and stealing (on by default) has nothing to move
    hists = _keys()[:5]
    jr = jcheck_batched(jmodels.cas_register(), hists,
                        oracle_fallback=False, strategy="mesh",
                        mesh=default_mesh(n_devices=2))
    tr = tcheck_batched(tmodels.cas_register(), [to_port(h) for h in hists],
                        oracle_fallback=False, strategy="mesh",
                        devices=["cpu"] * 2)
    _compare_keys(jr, tr, "check_batched mesh")
    assert [r["shard"]["key_index"] for r in tr] == list(range(5))


def test_check_batched_vmap_over_two_devices_matches_jax():
    hists = _keys()[:5]
    jr = jcheck_batched(jmodels.cas_register(), hists,
                        oracle_fallback=False, strategy="vmap",
                        mesh=default_mesh(n_devices=2))
    tr = tcheck_batched(tmodels.cas_register(), [to_port(h) for h in hists],
                        oracle_fallback=False, strategy="vmap",
                        devices=["cpu"] * 2)
    for i, (a, b) in enumerate(zip(jr, tr)):
        for k in ("valid?", "K", "W_pad", "configs_explored", "batch_keys"):
            assert a.get(k) == b.get(k), (i, k)
        assert a["util"]["rounds"] == b["util"]["rounds"], i
        assert b["shard"]["device_index"] == a["shard"]["device_index"]
    # 5 keys padded to 6 lanes: three a device
    assert [r["shard"]["device"] for r in tr] == \
        ["cpu"] * 3 + ["cpu#1"] * 2


def test_check_streamed_pool_matches_jax(monkeypatch):
    hists = _keys()[:5]
    je, te = _encs(hists)
    jr = jbatched.check_streamed(jmodels.cas_register(), hists, encs=je,
                                 race=False, oracle_fallback=False)
    # one forced rebalance, then the real gate (as the JAX package's
    # streamed-pool test does)
    calls = []
    real_plan = tfleet.steal_plan

    def once(pending, walls, skew_x=tfleet.REBUCKET_SKEW_X):
        for dev, keys in pending.items():
            if keys and not calls:
                calls.append(dev)
                return {"from": dev, "to": [d for d in pending
                                            if d != dev][0],
                        "keys": [keys[0][1]], "est_moved": float(keys[0][0]),
                        "skew_before": 9.9}
        return real_plan(pending, walls, skew_x)

    monkeypatch.setattr(tfleet, "steal_plan", once)
    tr = tbatched.check_streamed(tmodels.cas_register(),
                                 [to_port(h) for h in hists], encs=te,
                                 oracle_fallback=False, devices=["cpu"] * 2)
    for i, (a, b) in enumerate(zip(jr, tr)):
        assert (a["valid?"], a["configs_explored"]) == \
            (b["valid?"], b["configs_explored"]), i
    assert {r["shard"]["device"] for r in tr} <= {"cpu", "cpu#1"}
    assert calls and any(p.get("skew_before") == 9.9
                         for p in tfleet.sched_events("fleet_sched"))


def test_encode_batch_pad_matches_jax():
    je, te = _encs(_keys()[:5])
    for pad in (1, 2, 4):
        want = jbatched.encode_batch(je, batch_pad=pad)
        got = tbatched.encode_batch(te, batch_pad=pad)
        for f in want.__dataclass_fields__:
            a, b = getattr(got, f), getattr(want, f)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f"{pad} {f}")
            else:
                assert a == b, (pad, f)


def test_cuda_checker_over_devices_matches_jax_tpu_checker():
    from test_torch_independent import multikey_history
    jh_ = multikey_history("jax", n_keys=5, ops_per_key=30, bad_keys=(2,))
    th_ = multikey_history("port", n_keys=5, ops_per_key=30, bad_keys=(2,))
    # the JAX checker's mesh scheduler runs on every device (a named
    # mesh would pin its vmap path): eight, as the port's list here
    jres = jind.tpu_checker(jmodels.cas_register()).check({}, jh_, {})
    tres = tind.cuda_checker(tmodels.cas_register(),
                             devices=["cpu"] * 8).check({}, th_, {})
    assert tres["valid?"] == jres["valid?"] is False
    assert sorted(tres["failures"]) == sorted(jres["failures"])
    for k, r in tres["results"].items():
        assert r["shard"]["engine"] == "device-mesh"
        assert r["configs_explored"] == \
            jres["results"][k]["configs_explored"], k


def test_default_devices_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tutil.default_devices()
    with pytest.raises(RuntimeError, match="CUDA"):
        tind.cuda_checker(tmodels.cas_register()).check(
            {}, th.History(), {})
    assert tmesh.word_shard_count(64) == 1


_BAD_LEAVES = [
    (tw.TABLE, lambda t: t[:-1].contiguous()),                  # shape
    (tw.STATS, lambda t: t.to(torch.int64)),                   # dtype
    (tw.BK, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
    (tw.FR_CNT, lambda t: t.reshape(1, -1)),                   # rank
]


def test_reset_block_checks_each_carry_once():
    # the wrapper's argument block (csrc/wgl_lanes.cu's layout): the
    # leaves' pointers and the carry's shapes, made once a carry and
    # found again by the leaves' identities; a wrong leaf raises
    carry = tw.init_carry_batch(4, 8, 4, 1 << 8, 32, 0, "cpu")
    blk = tmesh._reset_block(carry)
    assert blk.shape == (tmesh.RESET_WORDS,) and blk.dtype == np.int64
    assert blk[:8].tolist() == [t.data_ptr() for t in carry]
    assert blk[11:16].tolist() == [8, 4, 32, 1 << 8,
                                   tw.RING_ROWS * tw.RING_COLS]
    assert tmesh._reset_block(carry) is blk
    other = tuple(t.clone() for t in carry)
    assert tmesh._reset_block(other) is not blk
    for leaf, bad in _BAD_LEAVES:
        wrong = list(carry)
        wrong[leaf] = bad(carry[leaf])
        with pytest.raises(ValueError):
            tmesh._reset_block(tuple(wrong))


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("L", [0, 2])
def test_lane_kernels_match_plain_on_card(cuda_device, L):
    rng = np.random.default_rng(20 + L)
    init, K, C, mst_col = _jax_init(L)
    lanes = 7
    leaves = _random_carry(rng, init, lanes)
    mask = np.array([1, 0, 1, 1, 0, 0, 1], bool)
    card = tw.carry_from_numpy(leaves, cuda_device)
    ref = tw.carry_from_numpy(leaves, cuda_device)
    before = tmesh.reset_lanes.launches
    tmesh.reset_lanes(card, mask, mst_col=mst_col, mstate0=5)
    torch.cuda.synchronize()
    assert tmesh.reset_lanes.launches == before + 1
    tmesh.reset_lanes_ref(ref, mask, mst_col=mst_col, mstate0=5)
    for i, (a, b) in enumerate(zip(card, ref)):
        assert torch.equal(a, b), i
    for k_new in (4 * K, K // 2):
        before = tmesh.migrate_lanes.launches
        got = tmesh.migrate_lanes(card, k_new)
        torch.cuda.synchronize()
        assert tmesh.migrate_lanes.launches == before + 1
        want = tadapt.migrate_frontier_batch(card, k_new)
        assert torch.equal(got[0], want[0]), k_new


def _reset_case(dev, lanes, seed, K=8, C=4, H=1 << 10, B=32):
    """A random lane-batched carry on `dev` and a random mask with at
    least one lane set (made with numpy from `seed`)."""
    rng = np.random.default_rng(seed)
    leaves = [rng.integers(-2**31, 2**31, a.shape, dtype=np.int64)
              .astype(np.int32) for a in tw.carry_batch_to_numpy(
                  tw.init_carry_batch(lanes, K, C, H, B, 0, "cpu"))]
    mask = rng.random(lanes) < 0.4
    mask[rng.integers(lanes)] = True
    return tw.carry_from_numpy(leaves, dev), mask


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 4, 64, 65, 100])
def test_reset_kernel_by_mask_and_by_index_on_card(cuda_device, lanes):
    # <= MASK_BITS lanes pass the mask by value, more pass the masked
    # lanes' indices on the card: both equal reset_lanes_ref bit for bit,
    # and the unmasked lanes keep every word
    assert (lanes <= tmesh.MASK_BITS) == (lanes <= 64)
    card, mask = _reset_case(cuda_device, lanes, seed=lanes)
    before = [t.clone() for t in card]
    ref = tuple(t.clone() for t in card)
    launches = tmesh.reset_lanes.launches
    tmesh.reset_lanes(card, mask, mst_col=2, mstate0=7)
    torch.cuda.synchronize()
    assert tmesh.reset_lanes.launches == launches + 1
    tmesh.reset_lanes_ref(ref, mask, mst_col=2, mstate0=7)
    keep = torch.as_tensor(~mask, device=cuda_device)
    for i, (a, b, old) in enumerate(zip(card, ref, before)):
        assert torch.equal(a, b), i
        assert torch.equal(a[keep], old[keep]), i
    # every lane masked, at the highest bit of the by-value words too
    every = np.ones(lanes, bool)
    tmesh.reset_lanes(card, every, mst_col=2)
    tmesh.reset_lanes_ref(ref, every, mst_col=2)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(card, ref)):
        assert torch.equal(a, b), i


@pytest.mark.gpu
def test_reset_kernel_counts_and_checks_on_card(cuda_device):
    card, mask = _reset_case(cuda_device, 4, seed=3)
    launches = tmesh.reset_lanes.launches
    # an empty mask launches nothing and changes nothing
    before = [t.clone() for t in card]
    tmesh.reset_lanes(card, np.zeros(4, bool), mst_col=2)
    torch.cuda.synchronize()
    assert tmesh.reset_lanes.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(card, before))
    # one launch a call with a lane set
    for _ in range(3):
        tmesh.reset_lanes(card, mask, mst_col=2)
    assert tmesh.reset_lanes.launches == launches + 3
    # a wrong leaf raises before any launch, whatever was checked before
    bad_cases = _BAD_LEAVES + [(tw.FLAGS, lambda t: t.cpu())]  # device
    for leaf, bad in bad_cases:
        wrong = list(card)
        wrong[leaf] = bad(card[leaf])
        with pytest.raises(ValueError):
            tmesh.reset_lanes(tuple(wrong), mask, mst_col=2)
    with pytest.raises(ValueError):
        tmesh.reset_lanes(card, mask, mst_col=card[tw.FR].shape[2])
    with pytest.raises(ValueError):
        tmesh.reset_lanes(card, mask[:3], mst_col=2)
    torch.cuda.synchronize()
    assert tmesh.reset_lanes.launches == launches + 3


@pytest.mark.gpu
def test_check_mesh_on_card_matches_cpu(cuda_device):
    hists = [to_port(h) for h in _keys()]
    _, te = _encs(_keys())
    kw = dict(steal=False, lanes_per_device=1, chunk=32,
              oracle_fallback=False)
    cpu = tmesh.check_mesh(tmodels.cas_register(), hists, encs=te,
                           devices=["cpu"] * 2, **kw)
    launches = tw.chunk_batched.launches
    card = tmesh.check_mesh(tmodels.cas_register(), hists, encs=te,
                            devices=[cuda_device] * 2, **kw)
    assert tw.chunk_batched.launches > launches
    assert tmesh.reset_lanes.launches >= 1
    for a, b in zip(cpu, card):
        for k in ("valid?", "configs_explored", "K", "mesh"):
            assert a[k] == b[k], k


# (lanes, k_old, k_new, C): the six migrations chip_smoke.py times (the
# fan-out's 100 lanes and its mesh shard's 4, one ladder step each way;
# 8 wide lanes), and one whose lanes' kept runs and strides are not
# multiples of 4 words (k_old C = 15)
MIGRATIONS = [(100, 16, 64, 4), (100, 64, 16, 4), (4, 16, 64, 4),
              (4, 64, 16, 4), (8, 512, 1024, 5), (8, 1024, 512, 5),
              (7, 3, 10, 5), (7, 10, 3, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,k_old,k_new,C", MIGRATIONS)
def test_migrate_lanes_matches_plain_on_card(cuda_device, lanes, k_old,
                                             k_new, C):
    rng = np.random.default_rng(lanes * 10007 + k_old * 31 + k_new)
    fr = torch.from_numpy(rng.integers(-2**31, 2**31, (lanes, k_old, C),
                                       dtype=np.int64).astype(np.int32))
    carry = (fr.to(cuda_device), torch.ones(lanes, dtype=torch.int32,
                                            device=cuda_device))
    before = tmesh.migrate_lanes.launches
    got = tmesh.migrate_lanes(carry, k_new)
    torch.cuda.synchronize()
    assert tmesh.migrate_lanes.launches == before + 1
    want = tadapt.migrate_frontier_batch(carry, k_new)
    assert got[0].shape == (lanes, k_new, C)
    assert torch.equal(got[0], want[0])
    assert got[1] is carry[1]
