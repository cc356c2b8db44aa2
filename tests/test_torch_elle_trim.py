"""Kernel-level parity of the port's Elle trim.

The same padded inputs (`elle.tpu.trim_inputs`, the port's copy of the
reference's preparation) go through the JAX package's `make_trim_kernel`
(jitted on the CPU) and the port's `trim_ref`: the live cores, the
per-body counts (with the 64-row clamp) and the body count must be
identical (tolerance zero, everything is boolean or integer). Builder
graphs come from synthetic list-append and rw-register histories with
realtime and process jumps; generic graphs from DepGraphs, one a chain
long enough to run past the 64 counts rows. The `gpu` case holds the
CUDA kernel against `trim_ref` on the card.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from jepsen_tpu.elle import tpu as jtpu
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch.elle import build as tbuild
from jepsen_tpu_torch.elle import graph as tgraph
from jepsen_tpu_torch.elle import tpu as ttpu

torch.set_num_threads(1)


def _split(h):
    oks = [op for op in h if op.is_ok and op.f in ("txn", None) and op.value]
    infos = [op for op in h
             if op.is_info and op.f in ("txn", None) and op.value]
    return oks, infos


def append_graph(n, seed, corrupt_p=0.0, graphs=("realtime",)):
    h = tsynth.list_append_history(n, n_procs=5, seed=seed,
                                   corrupt_p=corrupt_p)
    return tbuild.build_append(h, *_split(h),
                               additional_graphs=graphs).tensors


def wr_graph(n, seed, stale_p=0.0):
    h = tsynth.wr_register_history(n, n_procs=5, seed=seed, stale_p=stale_p)
    return tbuild.build_wr(h, *_split(h), linearizable_keys=True,
                           additional_graphs=("realtime", "process")).tensors


def chain(n, typ=tgraph.WW, back=None):
    g = tgraph.DepGraph()
    for i in range(n - 1):
        g.add_edge(i, i + 1, typ)
    if back is not None:
        g.add_edge(n - 1, 0, back)
    return g


CASES = {
    "append-valid": lambda: append_graph(200, 3),
    "append-corrupt": lambda: append_graph(200, 4, corrupt_p=0.25),
    "append-process": lambda: append_graph(200, 5, corrupt_p=0.05,
                                           graphs=("realtime", "process")),
    "wr-valid": lambda: wr_graph(200, 6),
    "wr-stale": lambda: wr_graph(200, 7, stale_p=0.2),
    "chain-300": lambda: chain(300),
    "cycle-120": lambda: chain(120, back=tgraph.RW),
}


_JIT: dict = {}


def jax_trim(t):
    key = (t["n_pad"], t["d_in"], t["d_out"], t["p_pad"], t["use_rt"],
           t["use_proc"])
    if key not in _JIT:
        _JIT[key] = jax.jit(jtpu.make_trim_kernel(
            t["n_pad"], t["d_in"], t["d_out"], len(ttpu.SUBSETS),
            t["p_pad"], t["use_rt"], t["use_proc"]))
    return tuple(np.asarray(x) for x in _JIT[key](*t["arrays"]))


def port_trim(t, fn=ttpu.trim_ref, device="cpu"):
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for a in t["arrays"]]
    return fn(*ins, p_pad=t["p_pad"], use_rt=t["use_rt"],
              use_proc=t["use_proc"])


def assert_same(port, ref):
    live, counts, bodies = port
    j_live, j_counts, j_bodies = ref
    assert int(bodies) == int(j_bodies)
    np.testing.assert_array_equal(live.cpu().numpy(), j_live)
    np.testing.assert_array_equal(counts.cpu().numpy(), j_counts)


@pytest.mark.parametrize("name", list(CASES))
def test_trim_ref_matches_jax(name):
    t = ttpu.trim_inputs(CASES[name]())
    assert_same(port_trim(t), jax_trim(t))


def test_the_corpora_cover_the_jumps_and_the_clamp():
    t = ttpu.trim_inputs(CASES["append-process"]())
    assert t["use_rt"] and t["use_proc"]
    live, _, _ = port_trim(t)
    assert live.any()                      # a nonempty core
    t = ttpu.trim_inputs(CASES["chain-300"]())
    assert not (t["use_rt"] or t["use_proc"])
    live, counts, bodies = port_trim(t)
    # a chain loses its two ends per peel: past the 64 counts rows
    assert bodies > ttpu.TRIM_COUNTS_ROWS and not live.any()
    assert counts[-1].tolist() == [0, 0, 0]


def test_trim_search_matches_jax_search():
    g = CASES["append-corrupt"]()
    jres = jtpu.trim_cycle_search(g)
    tres = ttpu.trim_cycle_search(g, device="cpu")
    for k in ("G0", "G1c", "G-single", "G2"):
        assert jres[k] == tres[k], k
    for k in ("n_pad", "d_in", "d_out", "edges", "iters_run", "iter_reach",
              "core_sizes", "jumps"):
        assert jres["util"][k] == tres["util"][k], k


def many_processes():
    """Trim inputs with 8192 process segments, past the kernel's
    shared-memory segment arrays (4096): a builder graph's arrays with
    its process columns replaced by numpy draws from a seed."""
    t = ttpu.trim_inputs(CASES["append-process"]())
    rng = np.random.default_rng(17)
    n_pad = t["n_pad"]
    arrays = list(t["arrays"])
    arrays[6] = rng.integers(0, 40, n_pad).astype(np.int32) * 200   # proc
    arrays[7] = rng.integers(-1, 6, n_pad).astype(np.int32)         # ppos
    return dict(t, arrays=tuple(arrays), p_pad=8192, use_proc=True)


def test_trim_ref_matches_jax_with_many_processes():
    t = many_processes()
    assert_same(port_trim(t), jax_trim(t))


# --- the kernel's peel, modelled in numpy ---------------------------------

def _transpose(neigh, mask):
    """For each source j, the nodes whose list names j: one entry a
    masked slot (CSR: starts, entries), as the kernel's prologue builds
    it from a histogram, a scan and a fill."""
    n_pad = neigh.shape[0]
    rows, slots = np.nonzero(mask)
    src = neigh[rows, slots]
    order = np.argsort(src, kind="stable")
    starts = np.searchsorted(src[order], np.arange(n_pad + 1))
    return starts, rows[order]


class _Pointers:
    """The realtime pool's extremum as `csrc/elle_trim.cu` keeps it: by
    monotone pointers over the rows sorted by (key, index), the first
    two pool members; where every row holds `big` (no member, or the
    first member's value is big), (big, 0, big). The pool only shrinks,
    so neither pointer ever moves back."""

    def __init__(self, key):
        self.order = np.lexsort((np.arange(len(key)), key))
        self.at = [0, 1]

    def ext(self, pool, vals, big):
        order = self.order
        first = self.at[0]
        while first < len(order) and not pool[order[first]]:
            first += 1
        second = max(self.at[1], first + 1)
        while second < len(order) and not pool[order[second]]:
            second += 1
        self.at = [first, second]
        if first == len(order) or vals[order[first]] == big:
            return (big, 0, big)
        sec = vals[order[second]] if second < len(order) else big
        return (vals[order[first]], int(order[first]), sec)


def counter_trim(t):
    """The trim as `csrc/elle_trim.cu` computes it, in numpy: per subset
    the counts of live masked neighbors and the transposed lists; a peel
    reads has_in / has_out from the counts, the process segments from
    the live nodes, the realtime thresholds by pointers over the
    pre-sorted rows; the nodes that die decrement the counts of the nodes that list them.
    Returns (live, counts, bodies) as the reference does, and the slots
    the deaths walked per subset."""
    (in_neigh, in_mask, out_neigh, out_mask, inv, comp, proc, ppos,
     live0) = [np.asarray(a) for a in t["arrays"]]
    n_pad, S = live0.shape
    rows = ttpu.TRIM_COUNTS_ROWS
    big = ttpu._BIGI
    inv64, comp64 = inv.astype(np.int64), comp.astype(np.int64)
    inverted = comp64 < inv64
    use_rt, use_proc, p_pad = t["use_rt"], t["use_proc"], t["p_pad"]
    live_out = np.zeros_like(live0)
    per_counts, bodies, walked = [], [], []
    for s in range(S):
        live = live0[:, s].copy()
        im, om = in_mask[:, :, s], out_mask[:, :, s]
        cin = (im & live[in_neigh]).sum(1)
        cout = (om & live[out_neigh]).sum(1)
        tin, tout = _transpose(in_neigh, im), _transpose(out_neigh, om)
        ptr_c, ptr_i = _Pointers(comp64), _Pointers(-inv64)
        walk = 0
        cs, prev = [], None
        for _ in range(n_pad):
            for _ in range(2):
                hi, ho = cin > 0, cout > 0
                if use_proc:
                    mn = np.full(p_pad, np.iinfo(np.int64).max)
                    mx = np.full(p_pad, np.iinfo(np.int64).min)
                    np.minimum.at(mn, proc[live], ppos[live])
                    np.maximum.at(mx, proc[live], ppos[live])
                    hi = hi | (ppos > mn[proc])
                    ho = ho | ((ppos < mx[proc]) & (ppos >= 0))
                hi, ho = hi & live, ho & live
                if use_rt:
                    pool_in = live & (hi | inverted)
                    pool_out = live & (ho | inverted)
                    e_in = ptr_c.ext(pool_in, comp64, big)
                    e_out = ptr_i.ext(pool_out, inv64, -big)
                    idx = np.arange(n_pad)
                    hi = hi | (inv64 > np.where(idx == e_in[1], e_in[2],
                                                e_in[0]))
                    ho = ho | (comp64 < np.where(idx == e_out[1], e_out[2],
                                                 e_out[0]))
                died = np.flatnonzero(live & ~(hi & ho))
                for j in died:
                    a0, a1 = tin[0][j], tin[0][j + 1]
                    b0, b1 = tout[0][j], tout[0][j + 1]
                    np.subtract.at(cin, tin[1][a0:a1], 1)
                    np.subtract.at(cout, tout[1][b0:b1], 1)
                    walk += (a1 - a0) + (b1 - b0)
                live[died] = False
                # the counts stay those of the live neighbors
                assert (cin == (im & live[in_neigh]).sum(1)).all()
                assert (cout == (om & live[out_neigh]).sum(1)).all()
            c = int(live.sum())
            cs.append(c)
            if c == prev:
                break
            prev = c
        live_out[:, s] = live
        per_counts.append(cs)
        bodies.append(len(cs))
        walked.append(walk)
    total = max(bodies)
    counts = np.zeros((rows, S), np.int32)
    for s in range(S):
        cs = per_counts[s] + [per_counts[s][-1]] * (total - bodies[s])
        for i, c in enumerate(cs):
            counts[min(i, rows - 1), s] = c
    return (torch.from_numpy(live_out), torch.from_numpy(counts), total,
            walked)


def random_trim_inputs(seed, n, d_in, d_out, use_rt, use_proc, p_pad=8):
    """Trim inputs drawn from a seed: random padded lists (out_neigh not
    the mirror of in_neigh), masks per subset, events on a small range
    (ties, about a fifth of the rows inverted: completion before
    invocation, and a tenth absent: the clipped extremes), process
    segments and chain positions with repeats."""
    rng = np.random.default_rng(seed)
    n_pad, S = 128, len(ttpu.SUBSETS)
    in_neigh = rng.integers(0, n, (n_pad, d_in)).astype(np.int32)
    out_neigh = rng.integers(0, n, (n_pad, d_out)).astype(np.int32)
    in_mask = rng.random((n_pad, d_in, S)) < 0.25
    out_mask = rng.random((n_pad, d_out, S)) < 0.25
    in_mask[n:] = out_mask[n:] = False
    inv = rng.integers(0, 40, n_pad).astype(np.int32)
    comp = (inv + rng.integers(-8, 30, n_pad)).astype(np.int32)
    # absent events, as trim_inputs clips them: the pools' extremes tie
    comp[rng.random(n_pad) < 0.1] = ttpu._BIGI
    inv[rng.random(n_pad) < 0.1] = -ttpu._BIGI
    if not use_rt:
        inv[:] = -ttpu._BIGI
        comp[:] = ttpu._BIGI
    proc = rng.integers(0, p_pad, n_pad).astype(np.int32)
    ppos = rng.integers(-1, 6, n_pad).astype(np.int32)
    live0 = np.zeros((n_pad, S), bool)
    live0[:n] = True
    return {"arrays": (in_neigh, in_mask, out_neigh, out_mask, inv, comp,
                       proc, ppos, live0),
            "n_pad": n_pad, "d_in": d_in, "d_out": d_out, "p_pad": p_pad,
            "use_rt": use_rt, "use_proc": use_proc}


def _same_as_ref(t):
    live, counts, bodies, walked = counter_trim(t)
    ref = port_trim(t)
    assert_same((live, counts, bodies), jax_trim(t))
    assert_same((live, counts, bodies),
                tuple(x if isinstance(x, int) else x.numpy() for x in ref))
    return walked


@pytest.mark.parametrize("name", list(CASES))
def test_counter_peel_matches_trim_ref_and_jax(name):
    _same_as_ref(ttpu.trim_inputs(CASES[name]()))


def test_counter_peel_with_many_processes():
    _same_as_ref(many_processes())


@settings(max_examples=20, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(2, 128),
       degrees=st.sampled_from([(4, 4), (4, 8), (8, 4)]),
       jumps=st.sampled_from([(True, False), (True, True), (False, True),
                              (False, False)]))
def test_counter_peel_on_drawn_graphs(seed, n, degrees, jumps):
    _same_as_ref(random_trim_inputs(seed, n, *degrees, *jumps))


def test_deaths_walk_few_slots():
    """Only the nodes that die walk their lists: over the fixpoint of
    the 200-txn append history each subset walks at most its masked
    slots, once each."""
    t = ttpu.trim_inputs(CASES["append-valid"]())
    walked = _same_as_ref(t)
    in_mask, out_mask = t["arrays"][1], t["arrays"][3]
    for s, w in enumerate(walked):
        assert 0 < w <= int(in_mask[:, :, s].sum() + out_mask[:, :, s].sum())


def test_scratch_holds_the_transposes():
    """The wrapper's scratch has room for every masked slot of both
    lists in every subset, the lists' ends, and the segment buffers
    past the kernel's shared ones."""
    t = many_processes()
    in_mask, out_mask = t["arrays"][1], t["arrays"][3]
    n_pad, S = t["n_pad"], len(ttpu.SUBSETS)
    slots = int(in_mask.any(2).sum() + out_mask.any(2).sum())
    for s in range(S):
        assert in_mask[:, :, s].sum() + out_mask[:, :, s].sum() <= slots
    # [ticket, bodies] padded to 4 words; per subset the sort keys
    # (2 n_pad words), the ends (2 n_pad), the orders (2 n_pad), the
    # uint16 entries in an even word count, the segment buffers
    per = 6 * n_pad + -(-slots // 4) * 2
    words = ttpu.trim_scratch_words(n_pad, slots, S, t["p_pad"], True)
    assert words == 4 + S * (per + 4 * t["p_pad"])
    assert t["p_pad"] > ttpu.TRIM_SMEM_PROCS
    assert ttpu.trim_scratch_words(n_pad, slots, S, 8, True) == 4 + S * per
    assert 2 * (per - 6 * n_pad) >= slots and per % 2 == 0


@pytest.mark.parametrize("name", ["append-process", "wr-stale",
                                  "chain-300"])
def test_shape_buckets_match_jax(name):
    g = CASES[name]()
    jb, tb = jtpu.shape_bucket_for(g), ttpu.shape_bucket_for(g)
    assert {k: jb[k] for k in ("n", "trim", "dense")} == tb
    t = ttpu.trim_inputs(g)
    assert tb["trim"] == (t["n_pad"], t["d_in"], t["d_out"], t["p_pad"],
                          t["use_rt"], t["use_proc"])


def test_cpu_tensors_run_the_host_trim():
    """CPU tensors run the host kernel (`csrc/elle_trim_host.cpp`): one
    host call, no card launch."""
    t = ttpu.trim_inputs(CASES["wr-stale"]())
    launches, calls = ttpu.trim.launches, ttpu.trim.host_calls
    assert_same(port_trim(t, fn=ttpu.trim), jax_trim(t))
    assert ttpu.trim.host_calls == calls + 1
    assert ttpu.trim.launches == launches


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_trim_ref_on_card(cuda_device, name):
    t = ttpu.trim_inputs(CASES[name]())
    ref = port_trim(t)
    launches = ttpu.trim.launches
    got = port_trim(t, fn=ttpu.trim, device=cuda_device)
    torch.cuda.synchronize()
    assert ttpu.trim.launches == launches + 1
    assert_same(got, tuple(x if isinstance(x, int) else x.numpy()
                           for x in ref))


@pytest.mark.gpu
def test_kernel_matches_trim_ref_with_many_processes(cuda_device):
    t = many_processes()
    ref = port_trim(t)
    got = port_trim(t, fn=ttpu.trim, device=cuda_device)
    torch.cuda.synchronize()
    assert_same(got, tuple(x if isinstance(x, int) else x.numpy()
                           for x in ref))


def _big_graph(kind, n):
    h = (tsynth.list_append_history if kind == "append"
         else tsynth.wr_register_history)(n, n_procs=5, seed=7)
    if kind == "append":
        return tbuild.build_append(h, *_split(h),
                                   additional_graphs=("realtime",)).tensors
    return tbuild.build_wr(h, *_split(h), linearizable_keys=True,
                           additional_graphs=("realtime",)).tensors


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n", [("append", 3000), ("wr", 3000),
                                    ("append", 10000)])
@pytest.mark.parametrize("use_proc", [False, True])
@pytest.mark.parametrize("use_rt", [True, False])
def test_kernel_at_the_smoke_shapes_on_card(cuda_device, kind, n, use_proc,
                                            use_rt):
    """The chip smoke's forced-trim shapes (n_pad 4096 and 16384), as
    built and with process chains drawn onto them, with the realtime
    thresholds on (as built) and off (the path of every history that is
    not analytic), against `trim_ref`. Each case launches several times:
    a peel's barrier alone orders its count reads before the deaths'
    decrements, so every launch equals `trim_ref`, count rows and bodies
    too."""
    t = ttpu.trim_inputs(_big_graph(kind, n))
    assert t["use_rt"] and not t["use_proc"]
    t = dict(t, use_rt=use_rt)
    if use_proc:
        rng = np.random.default_rng(n)
        arrays = list(t["arrays"])
        arrays[6] = rng.integers(0, 5, t["n_pad"]).astype(np.int32)
        arrays[7] = rng.integers(-1, t["n_pad"] // 5,
                                 t["n_pad"]).astype(np.int32)
        t = dict(t, arrays=tuple(arrays), use_proc=True)
    ref = tuple(x if isinstance(x, int) else x.cpu().numpy()
                for x in port_trim(t, device=cuda_device))
    for _ in range(4):
        got = port_trim(t, fn=ttpu.trim, device=cuda_device)
        torch.cuda.synchronize()
        assert_same(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(8))
def test_kernel_on_drawn_graphs_on_card(cuda_device, seed):
    """Drawn inputs (out-lists not the mirror of the in-lists, inverted
    intervals, repeated chain positions), every jump combination."""
    jumps = [(True, False), (True, True), (False, True), (False, False)]
    t = random_trim_inputs(seed, 20 + 13 * seed, 8, 4, *jumps[seed % 4])
    ref = port_trim(t)
    got = port_trim(t, fn=ttpu.trim, device=cuda_device)
    torch.cuda.synchronize()
    assert_same(got, tuple(x if isinstance(x, int) else x.numpy()
                           for x in ref))
