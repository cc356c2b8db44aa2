"""The word-column-sharded Elle closure of the PyTorch/CUDA port against
the JAX package's.

The same packed seed goes through the JAX package's
`make_sharded_closure_kernel` (under `shard_map` on the conftest's fake
8-device CPU mesh, as `tests/test_elle_sharded.py` runs it) and the
port's `sharded_closure_ref` over `n_shards` column blocks; labels,
rw-query answers, the per-squaring reach counts and the number of
squarings must be bit-identical to each other and to the port's packed
closure (tolerance zero: everything is 0/1 or an integer count). The
port's device list here is `["cpu"] * n`. Also: the cross-shard cycle of
the JAX package's sharded tests, capacity, `word_shard_count`, and the
sharded backend of `standard_cycle_search` and `elle.append.check`
against the JAX package's verdicts. The `gpu` cases hold the
`elle_sharded_square` kernel and the sharded closure against their plain
versions and the packed kernel on the card.
"""

import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from jepsen_tpu import synth as jsynth
from jepsen_tpu.elle import append as jappend
from jepsen_tpu.elle import graph as jgraph
from jepsen_tpu.elle import tpu as jtpu
from jepsen_tpu.parallel import mesh as jmesh
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch.elle import append as tappend
from jepsen_tpu_torch.elle import graph as tgraph
from jepsen_tpu_torch.elle import tpu as ttpu
from jepsen_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

TYPES = (tgraph.WW, tgraph.WR, tgraph.RW, tgraph.REALTIME, tgraph.PROCESS)


def graphs(seed, n, e):
    """The same random DepGraph in both packages."""
    rng = np.random.default_rng(seed)
    jg, tg = jgraph.DepGraph(), tgraph.DepGraph()
    for i in range(n):
        jg.add_node(i)
        tg.add_node(i)
    for s, d, t in zip(rng.integers(0, n, e), rng.integers(0, n, e),
                       rng.choice(TYPES, e)):
        jg.add_edge(int(s), int(d), int(t))
        tg.add_edge(int(s), int(d), int(t))
    return jg, tg


def cross_shard_graphs():
    """The JAX package's cross-shard case: a 2-cycle between word
    columns 0 and 5 of W 8, and acyclic low -> high filler."""
    jg, tg = jgraph.DepGraph(), tgraph.DepGraph()
    n = 200
    for g in (jg, tg):
        for i in range(n):
            g.add_node(i)
        g.add_edge(5, 190, tgraph.WW)
        g.add_edge(190, 5, tgraph.RW)
    rng = random.Random(0)
    for _ in range(300):
        a, b = sorted(rng.sample(range(n), 2))
        t = rng.choice([tgraph.WW, tgraph.WR, tgraph.REALTIME])
        jg.add_edge(a, b, t)
        tg.add_edge(a, b, t)
    return jg, tg


def jax_sharded_raw(args, n_pad, iters, n_shards):
    """The JAX package's sharded kernel on the port's padded inputs:
    (labels, closed, counts, iters_run) as numpy."""
    r0, q_src, q_dst = args
    kernel, mesh, _ = jtpu._compiled_sharded(n_pad, len(q_src),
                                             r0.shape[0], iters, n_shards)
    out = kernel(jax.device_put(r0.view(np.uint32), NamedSharding(
        mesh, PartitionSpec(None, None, "words"))),
        jax.device_put(q_src, NamedSharding(mesh, PartitionSpec())),
        jax.device_put(q_dst, NamedSharding(mesh, PartitionSpec())))
    labels, closed, counts, iters_run = (np.asarray(x) for x in out)
    return labels, closed, counts, int(iters_run)


def same_outputs(got, want, what):
    for name, a, b in zip(("labels", "closed", "counts"), got[:3], want[:3]):
        a = a.numpy() if torch.is_tensor(a) else a
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      np.asarray(b).astype(np.int64),
                                      err_msg=f"{what}: {name}")
    assert int(got[3]) == int(want[3]), what


@pytest.mark.parametrize("seed,n,e", [(0, 170, 900), (1, 100, 60),
                                      (2, 240, 1500)])
def test_sharded_closure_ref_matches_jax_and_packed(seed, n, e):
    _, tg = graphs(seed, n, e)
    a = ttpu.closure_inputs(tg, packed=True)
    n_pad, iters = a["n_pad"], a["iters"]
    r0, q_src, q_dst = (torch.from_numpy(x) for x in a["args"])
    packed = ttpu.packed_closure_ref(r0, q_src, q_dst, n_pad=n_pad,
                                     iters=iters)
    for ns in (1, 2, 4):
        blocks = ttpu.shard_blocks(r0, ns)
        assert all(b.shape[-1] == n_pad // 32 // ns for b in blocks)
        seen = []
        got = ttpu.sharded_closure_ref(
            blocks, q_src, q_dst, n_pad=n_pad, iters=iters,
            on_square=lambda i, bl: seen.append(i))
        want = jax_sharded_raw(a["args"], n_pad, iters, ns)
        same_outputs(got, want, f"seed {seed} vs JAX, {ns} shards")
        same_outputs(got, [x.numpy() for x in packed[:3]] + [packed[3]],
                     f"seed {seed} vs packed, {ns} shards")
        assert seen == list(range(int(got[3])))
        # the seed blocks are not modified
        assert torch.equal(torch.cat(blocks, dim=2), r0)
    # the wrappers take the plain versions on CPU blocks
    before = ttpu.sharded_square.launches
    via = ttpu.sharded_closure(ttpu.shard_blocks(r0, 2), q_src, q_dst,
                               n_pad=n_pad, iters=iters)
    blk = ttpu.shard_blocks(r0, 4)[1]
    c1, c2 = torch.zeros(3, dtype=torch.int32), torch.zeros(3,
                                                            dtype=torch.int32)
    assert torch.equal(ttpu.sharded_square(r0, blk, c1),
                       ttpu.sharded_square_ref(r0, blk, c2))
    assert torch.equal(c1, c2)
    assert ttpu.sharded_square.launches == before
    same_outputs(via, [x.numpy() for x in packed[:3]] + [packed[3]],
                 "wrapper on CPU blocks")


def test_cross_shard_cycle_converges_like_unsharded():
    jg, tg = cross_shard_graphs()
    r_pk = ttpu.cycle_queries_packed(tg, device="cpu")
    r_sh = ttpu.cycle_queries_sharded(tg, n_shards=8, devices=["cpu"] * 8)
    j_sh = jtpu.cycle_queries_sharded(jg, n_shards=8)
    assert r_sh["util"]["kernel"] == "sharded"
    assert r_sh["util"]["n_shards"] == 8 and r_sh["util"]["shard_words"] == 1
    assert r_sh["util"]["devices"][1] == "cpu#1"
    for r in (r_pk, j_sh):
        for i in range(len(ttpu.SUBSETS)):
            assert set(map(tuple, r["sccs"][i])) == \
                set(map(tuple, r_sh["sccs"][i]))
        np.testing.assert_array_equal(np.asarray(r["rw_closed"]),
                                      r_sh["rw_closed"])
        assert r["rw_edges"] == r_sh["rw_edges"]
        assert r["util"]["iters_run"] == r_sh["util"]["iters_run"]
        assert r["util"]["iter_reach"] == r_sh["util"]["iter_reach"]
    assert any({5, 190} <= set(c) for c in r_sh["sccs"][2])


def test_sharded_capacity_and_shard_counts():
    _, tg = graphs(3, 16, 40)
    assert ttpu.cycle_queries_sharded(tg, max_n=8, devices=["cpu"] * 2) \
        is None
    # one device: no shards unless named, then one shard on it
    assert ttpu.cycle_queries_sharded(tg, device="cpu") is None
    one = ttpu.cycle_queries_sharded(tg, n_shards=1, device="cpu")
    assert one["util"]["n_shards"] == 1
    # W = 4 at n_pad 128: 8 devices give 4 shards
    four = ttpu.cycle_queries_sharded(tg, devices=["cpu"] * 8)
    assert four["util"]["n_shards"] == 4
    with pytest.raises(ValueError, match="shards over"):
        ttpu.cycle_queries_sharded(tg, n_shards=4, devices=["cpu"] * 2)


@pytest.mark.parametrize("w", [1, 4, 6, 8, 12, 512, 4096])
@pytest.mark.parametrize("nd", [1, 2, 3, 4, 8])
def test_word_shard_count_matches_jax(w, nd):
    assert tmesh.word_shard_count(w, nd) == jmesh.word_shard_count(w, nd)


@pytest.mark.parametrize("seed", [4, 5])
def test_standard_cycle_search_sharded_matches_jax(seed):
    jg, tg = graphs(seed, 150, 500)
    want = jtpu.standard_cycle_search(jg, backend="sharded")
    got = ttpu.standard_cycle_search(tg, backend="sharded", device="cpu",
                                     devices=["cpu"] * 8)
    assert got["engine"] == want["engine"] == "sharded"
    assert got["util"]["n_shards"] == want["util"]["n_shards"]
    for q in ("G0", "G1c", "G-single", "G2"):
        assert (got[q] is None) == (want[q] is None), q
    assert any(got[q] for q in ("G0", "G1c", "G-single", "G2"))
    # fewer than 2 shards: packed, and the engine says so
    one = ttpu.standard_cycle_search(tg, backend="sharded", device="cpu")
    assert one["engine"] == "device" and one["util"]["kernel"] == "packed"
    assert "fallback" in one["util"]["select"]


def test_append_check_sharded_matches_jax():
    h = jsynth.list_append_history(300, seed=3, corrupt_p=0.02)
    want = jappend.check(h, additional_graphs=("realtime",),
                         cycle_backend="sharded")
    th_ = th.History([th.Op.from_dict(o.to_dict()) for o in h])
    got = tappend.check(th_, additional_graphs=("realtime",),
                        cycle_backend="sharded", devices=["cpu"] * 2)
    assert got["valid?"] == want["valid?"]
    assert got["anomaly-types"] == want["anomaly-types"]
    assert got["cycle-engine"] == "sharded"
    assert got["cycle-util"]["n_shards"] == 2
    valid = tappend.check(th.History([th.Op.from_dict(o.to_dict()) for o in
                                      jsynth.list_append_history(200,
                                                                 seed=4)]),
                          additional_graphs=("realtime",),
                          cycle_backend="sharded", devices=["cpu"] * 4)
    assert valid["valid?"] is True and valid["cycle-engine"] == "sharded"


def test_auto_route_takes_no_shards_on_the_cpu():
    _, tg = graphs(6, 500, 3000)
    res = ttpu.standard_cycle_search(tg, backend="auto", device="cpu",
                                     devices=["cpu"] * 8)
    assert res["engine"] in ("device", "host")
    assert "shard" not in res.get("route_reason", "")


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("ns", [1, 2, 4, 8])
def test_sharded_square_kernel_matches_plain_on_card(cuda_device, ns):
    _, tg = graphs(7, 240, 1500)
    a = ttpu.closure_inputs(tg, packed=True)
    n_pad, iters = a["n_pad"], a["iters"]
    r0, q_src, q_dst = (torch.from_numpy(x).to(cuda_device)
                        for x in a["args"])
    blocks = ttpu.shard_blocks(r0, ns)
    keep, bad = [], []
    before = ttpu.sharded_square.launches
    labels_before = ttpu.packed_closure.launches
    got = ttpu.sharded_closure(
        blocks, q_src, q_dst, n_pad=n_pad, iters=iters,
        on_square=lambda i, bl: keep.append([b.clone() for b in bl]))
    torch.cuda.synchronize()
    assert ttpu.sharded_square.launches == before + ns * int(got[3])
    assert ttpu.packed_closure.launches == labels_before + 1
    ref = ttpu.sharded_closure_ref(
        blocks, q_src, q_dst, n_pad=n_pad, iters=iters,
        on_square=lambda i, bl: bad.extend(
            k for k, (x, y) in enumerate(zip(bl, keep[i]))
            if not torch.equal(x, y)))
    assert not bad
    packed = ttpu.packed_closure(r0, q_src, q_dst, n_pad=n_pad, iters=iters)
    for want in (ref, packed):
        for x, y in zip(got[:2], want[:2]):
            assert torch.equal(x.cpu(), y.cpu())
        assert torch.equal(got[2].cpu(), want[2].cpu())
        assert got[3] == want[3]
