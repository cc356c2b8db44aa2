"""The port's admission plane (`jepsen_tpu_torch/analysis/preflight.py`)
against the JAX package's (`jepsen_tpu/analysis/preflight.py`).

Each case of `tests/test_preflight.py` that needs no jax lowering runs
on the same inputs through both packages, on the CPU (the reference on
its 8 virtual CPU devices, the port on `devices=["cpu"] * 8` where the
shard count matters): the verdict, the fired rule ids, the plan's
static fields (kernel, buckets, capacities, widths), the Elle kernel
and capacity and the sharded per-shard bytes must agree. Where the
memory budget decides, both run under the same
`JEPSEN_TPU_PREFLIGHT_MEM_BUDGET`. The port's four gate sites (the
checker, the Elle checkers, both fan-out paths and the mesh) are held
to the reference's reject shape and scoping. P003 counts nvcc modules
where the reference counts XLA executables: it has tests of its own.
"""

import numpy as np
import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import synth as jsynth
from jepsen_tpu.analysis import preflight as jpf
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import info as jinfo
from jepsen_tpu.history import invoke as jinvoke
from jepsen_tpu.history import ok as jok
from jepsen_tpu.models import cas_register as jcas
from jepsen_tpu.ops.encode import encode as jencode
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import occupancy
from jepsen_tpu_torch.analysis import preflight as tpf
from jepsen_tpu_torch.models import cas_register as tcas
from jepsen_tpu_torch.ops import _native
from jepsen_tpu_torch.ops import wgl32, wgln
from jepsen_tpu_torch.ops.encode import encode as tencode

CPU8 = ["cpu"] * 8
BUDGET = "JEPSEN_TPU_PREFLIGHT_MEM_BUDGET"


def port(h):
    return th.History([th.Op.from_dict(o.to_dict()) for o in h])


def J(ops):
    return JHistory(ops).index()


def rule_ids(rep):
    return [r["rule"] for r in rep["rules"]]


def same_wgl_plan(want, got):
    for k in ("verdict", "engine", "kernel", "buckets", "adaptive"):
        assert got.get(k) == want.get(k), k
    assert rule_ids(got) == rule_ids(want)
    for k in ("n_ok", "n_info", "W_raw", "W", "n_pad", "ic_pad"):
        assert got["shapes"][k] == want["shapes"][k], k
    for a, b in zip(want.get("plan", []), got.get("plan", [])):
        for k in ("kernel", "K", "H", "B", "W_eff", "ic_eff", "chunk",
                  "succ_rows"):
            assert b[k] == a[k], k
        assert b["hbm_bytes"] >= a["hbm_bytes"]


@pytest.fixture(scope="module")
def hist_2k():
    return jsynth.cas_register_history(2000, n_procs=5, seed=42,
                                       crash_p=0.002)


@pytest.fixture(scope="module")
def fanout_hists():
    hists = [jsynth.cas_register_history(60, n_procs=3, seed=s)
             for s in range(2)]
    hists.append(jsynth.cas_register_history(400, n_procs=40, seed=9))
    return hists


# ---------------------------------------------------------------------------
# plan enumeration (WGL)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"adaptive": False}, {"frontier": 8}],
                         ids=["ladder", "legacy", "pinned"])
def test_wgl_plan_matches_reference(hist_2k, kw):
    want = jpf.plan_wgl(jcas(), hist_2k, **kw)
    got = tpf.plan_wgl(tcas(), port(hist_2k), platform="cpu", **kw)
    same_wgl_plan(want, got)
    assert got["pack"] == want["pack"]
    assert got["hbm"]["budget_bytes"] == want["hbm"]["budget_bytes"]


def test_wide_window_plans_wgln_ladder():
    h = jsynth.adversarial_wave_history(8, width=14, span=5, seed=7)
    want = jpf.plan_wgl(jcas(), h)
    got = tpf.plan_wgl(tcas(), port(h), platform="cpu")
    same_wgl_plan(want, got)
    assert got["kernel"] == "wgln" and len(got["buckets"]) >= 2


def test_probe_matches_encoded_shapes(hist_2k):
    cheap = tpf.plan_wgl(tcas(), port(hist_2k), platform="cpu")
    full = tpf.plan_wgl(enc=tencode(tcas(), port(hist_2k)), platform="cpu")
    ref = jpf.plan_wgl(enc=jencode(jcas(), hist_2k))
    same_wgl_plan(ref, full)
    for k in ("n_ok", "n_info", "W_raw", "n_pad", "ic_pad"):
        assert cheap["shapes"][k] == full["shapes"][k], k
    assert cheap["buckets"] == full["buckets"]


def _window_overflow():
    ops = [jinvoke(99, "read", None, time=0)]
    t = 1
    for i in range(1100):
        p = i % 4
        ops.append(jinvoke(p, "write", 1, time=t)); t += 1
        ops.append(jok(p, "write", 1, time=t)); t += 1
    ops.append(jok(99, "read", None, time=t))
    return J(ops)


def _info_cap():
    ops = []
    t = 0
    for i in range(300):
        ops.append(jinvoke(i, "write", 1, time=t)); t += 1
        ops.append(jinfo(i, "write", 1, time=t)); t += 1
    return J(ops)


def _serial():
    ops = []
    t = 0
    for i in range(100):
        ops.append(jinvoke(0, "write", i % 5, time=t)); t += 1
        ops.append(jok(0, "write", i % 5, time=t)); t += 1
    return J(ops)


@pytest.mark.parametrize("make,kw,rules", [
    (_window_overflow, {}, ["P004"]),
    (_info_cap, {}, None),
    (_serial, {"adaptive": False}, None),
], ids=["p004-window", "p004-info-cap", "p005-sparse-beam"])
def test_rules_match_reference(make, kw, rules):
    h = make()
    want = jpf.plan_wgl(jcas(), h, **kw)
    got = tpf.plan_wgl(tcas(), port(h), platform="cpu", **kw)
    assert got["verdict"] == want["verdict"] == "degrade"
    assert rule_ids(got) == rule_ids(want)
    assert got["engine"] == want["engine"]
    if rules:
        assert rule_ids(got) == rules
    # degrade admits: the gate stays open in both
    assert tpf.gate_wgl(tcas(), port(h), where="test",
                        platform="cpu") is None
    assert jpf.gate_wgl(jcas(), h, where="test") is None


def test_p001_tiny_budget_rejects(hist_2k, monkeypatch):
    monkeypatch.setenv(BUDGET, "1000")
    want = jpf.plan_wgl(jcas(), hist_2k)
    got = tpf.plan_wgl(tcas(), port(hist_2k), platform="cpu")
    assert got["verdict"] == want["verdict"] == "infeasible"
    assert rule_ids(got) == rule_ids(want)
    bad_j = jpf.gate_wgl(jcas(), hist_2k, where="test")
    bad_t = tpf.gate_wgl(tcas(), port(hist_2k), where="test",
                         platform="cpu")
    assert set(bad_t) == set(bad_j)
    assert set(bad_t["preflight"]) == set(bad_j["preflight"])
    assert bad_t["valid?"] == "unknown" and bad_t["cause"] == "preflight"
    assert bad_t["rules"] == bad_j["rules"] == ["P001"]
    assert bad_t["op_count"] == bad_j["op_count"]


def test_verdict_precedence():
    inf = tpf._rule("P001", "x")
    deg = tpf._rule("P005", "y", suggestion="z")
    assert tpf._verdict([deg, inf])[0] == "infeasible"
    assert tpf._verdict([deg]) == ("degrade", "z")
    assert tpf._verdict([]) == ("feasible", None)
    assert tpf.RULES == jpf.RULES
    assert tpf.INFEASIBLE_RULES == jpf.INFEASIBLE_RULES


def test_budget_precedence(monkeypatch):
    monkeypatch.delenv(BUDGET, raising=False)
    assert tpf.device_memory_budget("cpu") == tpf.HOST_PLAN_BUDGET_BYTES
    assert tpf.device_memory_budget(devices=["cpu"]) == \
        jpf.device_memory_budget("cpu")
    monkeypatch.setenv(BUDGET, "1e6")
    assert tpf.device_memory_budget("cpu") == 1_000_000


# ---------------------------------------------------------------------------
# P003: the kernel modules nvcc would build (the port's own count)
# ---------------------------------------------------------------------------

def test_p003_counts_unbuilt_kernel_modules(hist_2k, tmp_path, monkeypatch):
    """A plan for the card counts the kernel sources not yet built or
    loaded; under a compile budget of 0 that is P003, a degrade."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_LIBS", {})
    rep = tpf.plan_wgl(tcas(), port(hist_2k), platform="cuda",
                       compile_budget=0)
    assert rep["compiles"]["cold"] == ["wgl32_chunk"]
    assert rule_ids(rep) == ["P003"] and rep["verdict"] == "degrade"
    assert "build" in rep["suggestion"]
    # once the library is on disk nothing is left to build
    _native._lib_path(_native.CSRC / "wgl32_chunk.cu").touch()
    rep = tpf.plan_wgl(tcas(), port(hist_2k), platform="cuda",
                       compile_budget=0)
    assert rep["compiles"]["cold"] == [] and rep["verdict"] == "feasible"


def test_p003_suggests_the_warm_path(hist_2k, tmp_path, monkeypatch):
    """P003 names the warm path, as the reference's does: the ladder's
    warm for one check, the mesh plan's warm for the fan-out."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setenv(BUDGET, str(1 << 40))
    want = jpf.plan_wgl(jcas(), hist_2k, compile_budget=0)
    got = tpf.plan_wgl(tcas(), port(hist_2k), platform="cuda",
                       compile_budget=0)
    for rep in (want, got):
        (p003,) = [r for r in rep["rules"] if r["rule"] == "P003"]
        assert "aot.precompile_wgl_ladder(...)" in p003["suggestion"]
    hists = [jsynth.cas_register_history(60, n_procs=3, seed=s)
             for s in range(6)]
    jencs, tencs = _encs(hists)
    want = jpf.plan_mesh(jencs, n_devices=2, lanes_per_device=4,
                         compile_budget=0)
    got = tpf.plan_mesh(tencs, n_devices=2, lanes_per_device=4,
                        platform="cuda", compile_budget=0)
    (jp003,) = [r for r in want["rules"] if r["rule"] == "P003"]
    (tp003,) = [r for r in got["rules"] if r["rule"] == "P003"]
    assert "aot.precompile_mesh_plan(shape_bucket" in jp003["suggestion"]
    assert tp003["suggestion"] == ("warm the mesh plan first: "
                                   "aot.precompile_mesh_plan(shape_bucket, "
                                   "devices)")


def test_p003_never_fires_for_the_cpu(hist_2k):
    rep = tpf.plan_wgl(tcas(), port(hist_2k), platform="cpu",
                       compile_budget=0)
    assert rep["compiles"]["cold_max"] == 0
    assert "P003" not in rule_ids(rep)


def test_cold_sources_maps_entry_points_to_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_LIBS", {})
    assert _native.cold_sources(["wgl32_chunk", "wgl32_chunk_batched",
                                 "wgl_chunk"]) == ["wgl32_chunk",
                                                   "wgl_chunk"]


# ---------------------------------------------------------------------------
# the bill against the port's own buffers
# ---------------------------------------------------------------------------

def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("kern,K,W,ic,L", [("wgl32", 64, 32, 8, 0),
                                           ("wgln", 32, 96, 16, 3)])
def test_state_bytes_cover_the_carry_and_scratch(kern, K, W, ic, L):
    H, B, n_pad, S, O = 1 << 12, 256, 192, 7, 5
    if kern == "wgl32":
        C = wgl32.row_words(ic)
        carry = wgl32.init_carry(K, C, H, B, 0, "cpu")
    else:
        C = wgln.row_words(L, ic)
        carry = wgln.init_carry(K, L, ic, H, B, 0, "cpu")
    held = (_nbytes(carry) + wgl32.scratch_words(K, W, ic, C) * 4
            + (n_pad + 1) * 16 + S * O * 4 + 2 * ic * 4)
    bill = occupancy.wgl_state_bytes(kern, K=K, W_eff=W, ic_eff=ic, L=L,
                                     H=H, B=B, n_pad=n_pad, S=S, O=O)
    # the allocator's rounding: at most 512 B and 1 MiB a buffer
    assert held <= bill <= held + 2 * (11 + 512 * 7) * 4 + 14 * (2**20 + 512)


def test_alloc_bytes_rounds_as_the_caching_allocator_may():
    assert occupancy.alloc_bytes(0) == 0
    assert occupancy.alloc_bytes(1) == 512
    assert occupancy.alloc_bytes(2**20) == 2**20
    assert occupancy.alloc_bytes(2**20 + 1) == 2**20 + 512 + 2**20


def test_lower_attaches_the_analytic_node_cost(hist_2k):
    enc = tencode(tcas(), port(hist_2k))
    rep = tpf.plan_wgl(enc=enc, platform="cpu", lower=True)
    for node in rep["plan"]:
        cost = node["cost"]
        assert cost["bytes_accessed"] == node["succ_rows"] * 4 * 16
        assert cost["state_bytes"] <= node["hbm_bytes"]
    warm = tpf.plan_wgl(tcas(), port(hist_2k), platform="cpu",
                        lower="warm")
    assert [n.get("cost") for n in warm["plan"]] == \
        [n["cost"] for n in rep["plan"]]


# ---------------------------------------------------------------------------
# Elle plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,backend,jkw,tkw", [
    (40_000, "auto", {}, {"devices": CPU8}),
    (100_000, "packed", {}, {"devices": CPU8}),
    (1_000_000, "packed", {}, {"devices": CPU8}),
    (10_000, "tpu", {}, {"devices": CPU8}),
    (2000, "auto", {"edges": 8000, "rw_edges": 2000}, {"devices": CPU8}),
    (300, "device", {}, {"devices": CPU8}),
    (100_000, "packed", {}, {"devices": ["cpu"]}),
], ids=["auto-host", "dense-100k", "dense-1m", "bf16-forced", "auto-small",
        "device", "one-shard"])
def test_elle_plan_matches_reference(n, backend, jkw, tkw, monkeypatch):
    with monkeypatch.context() as m:
        if tkw["devices"] == ["cpu"]:
            # the reference's one-shard fleet is its pin, which the port
            # does not read
            m.setenv("JEPSEN_TPU_ELLE_SHARDS", "1")
        want = jpf.plan_elle(n_txns=n, backend=backend, **jkw)
    got = tpf.plan_elle(n_txns=n, backend="cuda" if backend == "tpu"
                        else backend, **jkw, **tkw)
    for k in ("verdict", "engine", "kernel"):
        assert got.get(k) == want.get(k), k
    assert rule_ids(got) == rule_ids(want)
    assert [p["kernel"] for p in got["plan"]] == \
        [p["kernel"] for p in want["plan"]]
    for a, b in zip(want["plan"], got["plan"]):
        for k in ("n_pad", "iters", "capacity", "n_shards",
                  "per_shard_bytes", "gather_bytes_per_iter"):
            assert b.get(k) == a.get(k), k
        # the port bills its own buffers, never less than the model
        assert b.get("hbm_bytes", 0) >= a.get("hbm_bytes", 0)
    if "hbm" in want:
        assert got["hbm"]["budget_bytes"] == want["hbm"]["budget_bytes"]
        assert got["hbm"]["peak_bytes"] >= want["hbm"]["peak_bytes"]


@pytest.mark.parametrize("platform", ["tpu", "cpu"])
def test_p006_and_p001_match_reference_under_one_budget(platform,
                                                         monkeypatch):
    """auto degrades (P006: the host engine is still in hand) where an
    explicit device backend rejects (P001), under the same budget; the
    reference's "tpu" platform is the port's "cuda"."""
    monkeypatch.setenv(BUDGET, "1e6")
    tplat = "cuda" if platform == "tpu" else "cpu"
    for backend in ("auto", "packed"):
        want = jpf.plan_elle(n_txns=2000, edges=8000, rw_edges=2000,
                             backend=backend, platform=platform)
        got = tpf.plan_elle(n_txns=2000, edges=8000, rw_edges=2000,
                            backend=backend, platform=tplat, devices=None)
        assert got["verdict"] == want["verdict"]
        assert rule_ids(got) == rule_ids(want)
        assert got["kernel"] == want["kernel"]


def test_closure_feasibility_oracle():
    for n in (2000, 500_000):
        want, _ = jpf.elle_closure_feasible(n)
        got, rep = tpf.elle_closure_feasible(n, devices=CPU8)
        assert got == want
    assert rep["verdict"] == "infeasible"


def test_sharded_bill_counts_every_shard_on_a_card():
    """A device list that repeats one card bills that card for all its
    shards; distinct entries (the reference's fleet) bill one each."""
    import torch
    cards = [torch.device("cuda", 0)] * 4
    one = tpf.plan_elle_sharded(n_txns=10_000, n_shards=4)
    four = tpf.plan_elle_sharded(n_txns=10_000, n_shards=4, devices=cards)
    ref = jpf.plan_elle_sharded(n_txns=10_000, n_shards=4)
    assert one["per_shard_bytes"] == ref["per_shard_bytes"]
    assert one["hbm_bytes"] >= ref["hbm_bytes"]
    assert four["shards_per_card"] == 4
    # four shards of a card: each its block, gather and two spares
    words = 3 * 16384 * 512 * 4
    assert four["hbm_bytes"] >= 4 * (words + 3 * words // 4)
    assert four["hbm_bytes"] > 4 * four["per_shard_bytes"]
    assert tpf._shards_per_card(CPU8, 8) == 1


@pytest.mark.parametrize("pin", ["1", "8"])
def test_shard_count_is_the_device_list_alone(pin, monkeypatch):
    """The plan's word shards are the caller's device list, as the
    engine's are: the reference's `JEPSEN_TPU_ELLE_SHARDS` pin moves
    neither the count nor the verdict of a forced packed closure past
    the packed cap (four shards hold it; one cannot)."""
    from jepsen_tpu_torch.elle import tpu as ttpu
    monkeypatch.setenv("JEPSEN_TPU_ELLE_SHARDS", pin)
    n = ttpu.PACKED_MAX_N + 8
    for devs, shards, verdict, kernel in (
            (["cpu"] * 4, 4, "degrade", "sharded"),
            (["cpu"], 1, "infeasible", "packed")):
        assert tpf.plan_elle_sharded(n_txns=n,
                                     devices=devs)["n_shards"] == shards
        rep = tpf.plan_elle(n_txns=n, backend="packed", devices=devs)
        assert (rep["verdict"], rep["kernel"]) == (verdict, kernel)
        assert rule_ids(rep) == ["P002"]


def test_append_check_rejects_oversized_dense_request():
    """Past even the sharded cap, a forced packed closure is rejected
    before the graph build by both checkers."""
    from jepsen_tpu.elle import append as jappend
    from jepsen_tpu.elle.tpu import SHARDED_MAX_N
    from jepsen_tpu_torch.elle import append as tappend
    n = SHARDED_MAX_N + 8
    ops = [{"type": "ok", "f": "txn", "process": 0, "time": i, "index": i,
            "value": [["append", 0, i]]} for i in range(n)]
    want = jappend.check(JHistory(ops), cycle_backend="packed")
    got = tappend.check(th.History(ops), cycle_backend="packed",
                        device="cpu")
    for res in (want, got):
        assert res["valid?"] == "unknown"
        assert res["anomaly-types"] == ["preflight"]
        assert res["preflight"]["verdict"] == "infeasible"
    assert set(got) == set(want)
    assert [r["rule"] for r in got["preflight"]["rules"]] == \
        [r["rule"] for r in want["preflight"]["rules"]]


def test_append_check_small_device_request_admitted():
    from jepsen_tpu_torch import synth as tsynth
    from jepsen_tpu_torch.elle import append as tappend
    h = tsynth.list_append_history(120, n_procs=3, seed=7)
    res = tappend.check(h, cycle_backend="trim", device="cpu")
    assert res["valid?"] in (True, False)


def test_elle_route_parity_vs_executed():
    from jepsen_tpu_torch import synth as tsynth
    from jepsen_tpu_torch.elle import build
    from jepsen_tpu_torch.elle import tpu as ttpu
    from jepsen_tpu_torch.elle.graph import RW
    h = tsynth.list_append_history(1500, n_procs=5, seed=7)
    oks = [op for op in h if op.is_ok and op.f in ("txn", None) and op.value]
    infos = [op for op in h
             if op.is_info and op.f in ("txn", None) and op.value]
    gt = build.build_append(h, oks, infos,
                            additional_graphs=("realtime",)).tensors
    edges = np.asarray(gt.edges)
    rw = int(np.sum(edges[:, 2] == RW)) if len(edges) else 0
    rep = tpf.plan_elle(n_txns=int(np.asarray(gt.nodes).shape[0]),
                        edges=int(len(edges)), rw_edges=rw, backend="auto",
                        devices=["cpu"])
    res = ttpu.standard_cycle_search(gt, backend="auto", device="cpu")
    assert tpf._engines_match(rep, res), (rep, res)


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

def _encs(hists):
    return ([jencode(jcas(), h) for h in hists],
            [tencode(tcas(), port(h)) for h in hists])


def _peaks(jencs, idx):
    return [jpf.plan_wgl(enc=jencs[i])["hbm"]["peak_bytes"] for i in idx]


def test_feasible_batch_passes():
    hists = [jsynth.cas_register_history(60, n_procs=3, seed=s)
             for s in range(3)]
    jencs, tencs = _encs(hists)
    assert jpf.gate_fanout(jcas(), hists, encs=jencs, where="t") is None
    assert tpf.gate_fanout(tcas(), [port(h) for h in hists], encs=tencs,
                           where="t", devices=["cpu"]) is None


def test_infeasible_bucket_rejects_whole_fanout(monkeypatch):
    monkeypatch.setenv(BUDGET, "1000")
    hists = [jsynth.cas_register_history(60, n_procs=3, seed=s)
             for s in range(2)]
    want = jpf.gate_fanout(jcas(), hists, where="t")
    got = tpf.gate_fanout(tcas(), [port(h) for h in hists], where="t",
                          devices=["cpu"])
    assert set(got) == set(want) == {0, 1}
    assert all(r["cause"] == "preflight" for r in got.values())


def test_rejection_scoped_to_infeasible_group(fanout_hists, monkeypatch):
    """Narrow and wide groups run separate kernels: a budget only the
    wide bucket blows rejects the wide key alone, in both packages."""
    jencs, tencs = _encs(fanout_hists)
    assert jencs[2].window_raw > 32
    narrow_pk, wide_pk = _peaks(jencs, (0, 2))
    assert wide_pk > 2 * narrow_pk
    monkeypatch.setenv(BUDGET, str((narrow_pk + wide_pk) // 2))
    want = jpf.gate_fanout(jcas(), fanout_hists, encs=jencs, where="t")
    got = tpf.gate_fanout(tcas(), [port(h) for h in fanout_hists],
                          encs=tencs, where="t", devices=["cpu"])
    assert set(got) == set(want) == {2}
    assert got[2]["rules"] == want[2]["rules"] == ["P001"]
    assert set(got[2]) == set(want[2])


def test_histories_only_gate_is_per_key(monkeypatch):
    small = jsynth.cas_register_history(60, n_procs=3, seed=1)
    big = jsynth.cas_register_history(400, n_procs=40, seed=9)
    spk = jpf.plan_wgl(jcas(), small)["hbm"]["peak_bytes"]
    bpk = jpf.plan_wgl(jcas(), big)["hbm"]["peak_bytes"]
    monkeypatch.setenv(BUDGET, str((spk + bpk) // 2))
    want = jpf.gate_fanout(jcas(), [small, big], where="t")
    got = tpf.gate_fanout(tcas(), [port(small), port(big)], where="t",
                          devices=["cpu"])
    assert set(got) == set(want) == {1}


def test_group_rejection_scoped_to_oversized_key(monkeypatch):
    hists = [jsynth.cas_register_history(60, n_procs=3, seed=s)
             for s in range(2)]
    hists.append(jsynth.cas_register_history(3000, n_procs=3, seed=9))
    jencs, tencs = _encs(hists)
    spk, bpk = _peaks(jencs, (0, 2))
    monkeypatch.setenv(BUDGET, str((spk + bpk) // 2))
    want = jpf.gate_fanout(jcas(), hists, encs=jencs, where="t")
    got = tpf.gate_fanout(tcas(), [port(h) for h in hists], encs=tencs,
                          where="t", devices=["cpu"])
    assert set(got) == set(want) == {2}


def test_batch_mode_bills_lanes_per_device(monkeypatch):
    h = jsynth.cas_register_history(60, n_procs=3, seed=1)
    jenc, tenc = jencode(jcas(), h), tencode(tcas(), port(h))
    one = jpf.plan_wgl(enc=jenc)["hbm"]["peak_bytes"]
    monkeypatch.setenv(BUDGET, str(one * 4))
    for mode, nd, rejected in (("group", 1, None), ("batch", 1, set(range(8))),
                               ("batch", 8, None)):
        want = jpf.gate_fanout(jcas(), [h] * 8, encs=[jenc] * 8, where="t",
                               mode=mode, n_devices=nd)
        got = tpf.gate_fanout(tcas(), [port(h)] * 8, encs=[tenc] * 8,
                              where="t", mode=mode, n_devices=nd,
                              devices=["cpu"] * nd)
        assert (None if want is None else set(want)) == rejected
        assert (None if got is None else set(got)) == rejected


def test_streamed_rejection_is_annotated_and_scoped(fanout_hists,
                                                    monkeypatch):
    """check_streamed rejects the wide key alone and annotates it like
    any other shard (engine "preflight"), so the key accounting closes;
    the admitted keys run."""
    from jepsen_tpu.parallel.batched import check_streamed as jstream
    from jepsen_tpu_torch.parallel.batched import check_streamed as tstream
    jencs, tencs = _encs(fanout_hists)
    npk, wpk = _peaks(jencs, (0, 2))
    monkeypatch.setenv(BUDGET, str((npk + wpk) // 2))
    want = jstream(jcas(), fanout_hists, time_limit=30, encs=jencs,
                   oracle_fallback=False)
    got = tstream(tcas(), [port(h) for h in fanout_hists], time_limit=30,
                  encs=tencs, oracle_fallback=False, device="cpu")
    assert [r["valid?"] for r in got] == [r["valid?"] for r in want]
    assert got[2]["cause"] == want[2]["cause"] == "preflight"
    assert got[2]["shard"]["engine"] == want[2]["shard"]["engine"]
    assert got[2]["op_count"] == want[2]["op_count"]


def test_rejected_key_decided_by_oracle_fallback(monkeypatch):
    from jepsen_tpu.parallel.batched import check_streamed as jstream
    from jepsen_tpu_torch.parallel.batched import check_streamed as tstream
    hists = [jsynth.cas_register_history(60, n_procs=3, seed=s)
             for s in range(2)]
    monkeypatch.setenv(BUDGET, "1000")
    want = jstream(jcas(), hists, time_limit=30)
    got = tstream(tcas(), [port(h) for h in hists], time_limit=30,
                  device="cpu")
    for res in (want, got):
        assert all(r["valid?"] is True for r in res)
        assert all(r.get("device_cause") == "preflight" for r in res)


def test_competition_decides_despite_infeasible_plan(monkeypatch):
    h = jsynth.cas_register_history(60, n_procs=3, seed=3)
    monkeypatch.setenv(BUDGET, "1000")
    want = jchecker.linearizable(jcas(), algorithm="competition",
                                 time_limit=30).check({}, h, {})
    got = tchecker.linearizable(tcas(), algorithm="competition",
                                time_limit=30,
                                device="cpu").check({}, port(h), {})
    for res in (want, got):
        assert res["valid?"] is True
        assert res["device_cause"] == "preflight"
        assert res["preflight"]["verdict"] == "infeasible"
    bad_j = jchecker.linearizable(jcas(), algorithm="tpu-wgl",
                                  time_limit=30).check({}, h, {})
    bad_t = tchecker.linearizable(tcas(), algorithm="cuda-wgl",
                                  time_limit=30,
                                  device="cpu").check({}, port(h), {})
    assert bad_t["valid?"] == bad_j["valid?"] == "unknown"
    assert bad_t["cause"] == bad_j["cause"] == "preflight"
    assert bad_t["algorithm"] == "cuda-wgl"
    assert set(bad_t) == set(bad_j)


def test_vmap_batch_degrades_to_streamed_scoped(fanout_hists, monkeypatch):
    """An infeasible lane-batched kernel degrades to the streamed path,
    whose group gate rejects only the wide key."""
    from jepsen_tpu.parallel import check_batched as jbatched
    from jepsen_tpu_torch.parallel import check_batched as tbatched
    jencs, _ = _encs(fanout_hists)
    npk, wpk = _peaks(jencs, (0, 2))
    monkeypatch.setenv(BUDGET, str((npk + wpk) // 2))
    want = jbatched(jcas(), fanout_hists, time_limit=30,
                    oracle_fallback=False)
    got = tbatched(tcas(), [port(h) for h in fanout_hists], time_limit=30,
                   oracle_fallback=False, device="cpu")
    assert [r["valid?"] for r in got] == [r["valid?"] for r in want] == \
        [True, True, "unknown"]
    assert got[2]["cause"] == want[2]["cause"] == "preflight"
    assert got[2]["op_count"] == want[2]["op_count"] == len(fanout_hists[2])


def test_check_batched_rejects_statically(monkeypatch):
    from jepsen_tpu.parallel import check_batched as jbatched
    from jepsen_tpu_torch.parallel import check_batched as tbatched
    monkeypatch.setenv(BUDGET, "1000")
    hists = [jsynth.cas_register_history(40, n_procs=3, seed=s)
             for s in range(2)]
    want = jbatched(jcas(), hists, time_limit=10, oracle_fallback=False)
    got = tbatched(tcas(), [port(h) for h in hists], time_limit=10,
                   oracle_fallback=False, device="cpu")
    for res in (want, got):
        assert all(r["valid?"] == "unknown" for r in res)
        assert all(r["cause"] == "preflight" for r in res)
        assert [r["op_count"] for r in res] == [len(h) for h in hists]


def test_mesh_plan_matches_reference(monkeypatch):
    hists = [jsynth.cas_register_history(60, n_procs=3, seed=s)
             for s in range(6)]
    jencs, tencs = _encs(hists)
    want = jpf.plan_mesh(jencs, n_devices=2, lanes_per_device=4)
    got = tpf.plan_mesh(tencs, n_devices=2, lanes_per_device=4,
                        devices=["cpu"] * 2)
    assert got["verdict"] == want["verdict"] == "feasible"
    assert [n["hbm_bytes"] for n in got["plan"]] == \
        [n["hbm_bytes"] for n in want["plan"]]
    monkeypatch.setenv(BUDGET, str(got["hbm"]["peak_bytes"] // 2))
    want = jpf.plan_mesh(jencs, n_devices=2, lanes_per_device=4)
    got = tpf.plan_mesh(tencs, n_devices=2, lanes_per_device=4,
                        devices=["cpu"] * 2)
    assert got["verdict"] == want["verdict"] == "infeasible"
    assert rule_ids(got) == rule_ids(want)


def test_mesh_gate_degrades_the_request(monkeypatch):
    """An infeasible mesh plan returns None from check_mesh (the caller
    takes its one-device decision) before any carry is made; through
    check_batched the keys still reach the oracle."""
    from jepsen_tpu_torch.parallel import check_batched as tbatched
    from jepsen_tpu_torch.parallel import mesh as tmesh
    hists = [port(jsynth.cas_register_history(60, n_procs=3, seed=s))
             for s in range(5)]
    tencs = [tencode(tcas(), h) for h in hists]
    monkeypatch.setenv(BUDGET, "1000")
    before = tpf.snapshot()["verdicts"].get("degrade", 0)
    assert tmesh.check_mesh(tcas(), hists, encs=tencs,
                            devices=["cpu"] * 2) is None
    assert tpf.snapshot()["verdicts"]["degrade"] > before
    res = tbatched(tcas(), hists, time_limit=30, strategy="mesh",
                   devices=["cpu"] * 2)
    assert all(r["valid?"] is True for r in res)
    assert all(r.get("device_cause") == "preflight" for r in res)


def test_snapshot_records_gate_decisions():
    tpf.gate_elle(100, backend="auto", where="status-test", devices=["cpu"])
    snap = tpf.snapshot()
    assert snap["checked"] >= 1
    assert isinstance(snap["verdicts"], dict)
    assert snap["recent"][-1]["where"] == "status-test"
    assert set(snap) == set(jpf.snapshot())


def test_compact_keeps_the_reference_keys(hist_2k, monkeypatch):
    monkeypatch.setenv(BUDGET, "1000")
    want = jpf.compact(jpf.plan_wgl(jcas(), hist_2k))
    got = tpf.compact(tpf.plan_wgl(tcas(), port(hist_2k), platform="cpu"))
    assert set(got) == set(want)
    assert got["rules"] == want["rules"]
    assert got["hbm_peak_bytes"] == want["hbm_peak_bytes"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_dense_100k(capsys):
    from jepsen_tpu_torch import __main__ as tmain
    rc = tmain.main(["preflight", "--config", "dense_100k", "--device",
                     "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    # one device yields one word shard: rejected, naming P002
    assert "infeasible" in out and "P002" in out


def test_cli_unknown_config():
    from jepsen_tpu_torch import __main__ as tmain
    assert tmain.main(["preflight", "--config", "nope"]) == 254


def test_cli_headline_executes_on_the_cpu(capsys):
    from jepsen_tpu_torch import __main__ as tmain
    rc = tmain.main(["preflight", "--headline", "--ops", "300", "--execute",
                     "--device", "cpu", "--json"])
    import json
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    ex = out["headline"]["executed"]
    assert ex["verdict"] is True and ex["kernel_match"]
    assert ex["buckets_subset"]
    assert ex["peak_bytes_measured"] is None  # no card: not measured


def test_elle_bills_the_packed_squaring_scratch():
    """The packed closure's bill holds the tensor-core squaring's
    scratch once (the bit transpose, one plane's bytes, and the A and T
    tile flags), the sharded bill each shard's (its block's transpose):
    pinned at the Elle append 10k shape, n_pad 16384."""
    import torch

    from jepsen_tpu_torch import occupancy as occ

    S, n = 3, 16384
    words = S * n * (n // 32) * 4
    assert occ.bitmm_scratch_bytes(S, n, n // 32) == [words, S * 128 * 16,
                                                      S * 64 * 16]
    assert occ.bitmm_scratch_bytes(S, n, n // 64) == [words // 2,
                                                      S * 128 * 16,
                                                      S * 32 * 16]
    # the queries (q 1000 pads to 1024) and the label pass's outputs
    rest = [4 * 1024, 4 * 1024, 4 * S * n, S * 1024, 4 * S]
    packed = [words] * 3 + [words, S * 128 * 16, S * 64 * 16] + rest
    got = occ.elle_closure_bytes("packed", S=S, n_pad=n, e=0, q=1000)
    assert got == sum(occ.alloc_bytes(b) for b in packed) == 407_065_088
    shard = ([words, words // 2, words // 2, words // 2, 4 * S,
              words // 2, S * 128 * 16, S * 32 * 16])
    got = occ.elle_closure_bytes("sharded", S=S, n_pad=n, e=0, q=1000,
                                 n_shards=2, shards_per_card=2)
    assert got == sum(occ.alloc_bytes(b) for b in 2 * shard + rest) \
        == 614_690_304
    # the plan the gate bills by carries it
    plan = tpf.plan_elle_sharded(n_txns=10_000, n_shards=2,
                                 devices=[torch.device("cuda", 0)] * 2)
    assert plan["hbm_bytes"] >= got - sum(occ.alloc_bytes(b) for b in rest)


_TRIM_GRAPHS: dict = {}


def _trim_graph(kind, n):
    """The built graph of the chip smoke's Elle histories (seed 7, 5
    processes, realtime edges), built once."""
    if (kind, n) not in _TRIM_GRAPHS:
        from jepsen_tpu_torch import synth as tsynth
        from jepsen_tpu_torch.elle import build as tbuild

        gen = (tsynth.list_append_history if kind == "append"
               else tsynth.wr_register_history)
        h = gen(n, n_procs=5, seed=7)
        oks = [op for op in h if op.is_ok and op.f in ("txn", None)
               and op.value]
        infos = [op for op in h if op.is_info and op.f in ("txn", None)
                 and op.value]
        if kind == "append":
            g = tbuild.build_append(h, oks, infos,
                                    additional_graphs=("realtime",))
        else:
            g = tbuild.build_wr(h, oks, infos, linearizable_keys=True,
                                additional_graphs=("realtime",))
        _TRIM_GRAPHS[kind, n] = g.tensors
    return _TRIM_GRAPHS[kind, n]


@pytest.mark.parametrize("kind,n", [("append", 3000), ("wr", 3000),
                                    ("append", 10000)])
def test_trim_bill_covers_the_wrappers_allocation(kind, n):
    """The trim plan's bill holds the trim's inputs on the card and what
    `elle.tpu.trim` allocates there (outputs, the kernel's scratch, the
    transposed lists sized by the masked slots, the slot count's
    transient) at the chip smoke's 3k and 10k shapes, whose largest
    degree bucket the mean degree does not show (wr 3k: 64), under the
    gate's estimated edge counts and under the built graph's own, in a
    plan for the card."""
    import torch

    from jepsen_tpu_torch.elle import tpu as ttpu
    from jepsen_tpu_torch.elle.graph import RW

    g = _trim_graph(kind, n)
    t = ttpu.trim_inputs(g)
    in_mask, out_mask = t["arrays"][1], t["arrays"][3]
    slots = int(in_mask.any(2).sum() + out_mask.any(2).sum())
    S = len(ttpu.SUBSETS)
    d_max = max(t["d_in"], t["d_out"])
    scratch = occupancy.trim_alloc_bytes(t["n_pad"], slots, S, t["p_pad"],
                                         t["use_proc"], d_max=d_max)
    assert scratch >= 4 * ttpu.trim_scratch_words(t["n_pad"], slots, S,
                                                  t["p_pad"], t["use_proc"])
    inputs = occupancy.trim_input_bytes(t["n_pad"], t["d_in"], t["d_out"], S)
    assert inputs >= sum(a.nbytes for a in t["arrays"])
    alloc = inputs + scratch
    edges = np.asarray(g.edges)
    n_nodes = int(np.asarray(g.nodes).shape[0])
    for kw in ({}, {"edges": len(edges),
                    "rw_edges": int((edges[:, 2] == RW).sum())}):
        rep = tpf.plan_elle(n_txns=n_nodes, backend="trim",
                            devices=[torch.device("cuda", 0)], **kw)
        (node,) = rep["plan"]
        assert node["kernel"] == "trim" and node["n_pad"] >= t["n_pad"]
        assert node["hbm_bytes"] >= alloc, (kw, node["hbm_bytes"], alloc)
