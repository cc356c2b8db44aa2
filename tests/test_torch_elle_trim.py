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


@pytest.mark.parametrize("name", ["append-process", "wr-stale",
                                  "chain-300"])
def test_shape_buckets_match_jax(name):
    g = CASES[name]()
    jb, tb = jtpu.shape_bucket_for(g), ttpu.shape_bucket_for(g)
    assert {k: jb[k] for k in ("n", "trim", "dense")} == tb
    t = ttpu.trim_inputs(g)
    assert tb["trim"] == (t["n_pad"], t["d_in"], t["d_out"], t["p_pad"],
                          t["use_rt"], t["use_proc"])


def test_cpu_tensors_take_the_plain_version():
    t = ttpu.trim_inputs(CASES["wr-stale"]())
    before = ttpu.trim.launches
    assert_same(port_trim(t, fn=ttpu.trim), jax_trim(t))
    assert ttpu.trim.launches == before


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
