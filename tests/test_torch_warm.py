"""The port's warm plane against the JAX package's.

  * `service.bucket_for` gives the reference's key and bucket, and
    `mesh.plan_cache_key` the reference's registry key, string for
    string;
  * `aot.precompile_wgl_ladder` / `precompile_service_bucket`,
    `mesh.warm_plan` and `aot.precompile_elle_closure` warm the buckets
    (or kernels) the reference's warm compiles, for the same shape
    bucket (the reference's compiles are stubbed: their keys are what is
    compared);
  * a warmed check equals an unwarmed one key for key (`wgl.check`,
    `check_mesh`, Elle); a warmed `check_mesh` over a named device list
    starts from the pooled carry, which is bit for bit a fresh
    `init_carry_batch`;
  * the mesh plan registry's round trip and the device-count skip of
    `precompile_cached_mesh_plans` (the port of tests/test_mesh.py's
    registry case), on the port's own `fs_cache` root;
  * `python -m jepsen_tpu_torch.bench --device cpu` prints its line.

On the card (`-m gpu`): a zero-round launch of every chunk form equals
the plain version on every carry leaf; a pooled carry taken on a shard's
stream equals a fresh one; and in a fresh process an unwarmed first
check counts loads and binds where a warmed one counts none.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from jepsen_tpu import fs_cache as jfs_cache
from jepsen_tpu import service as jservice
from jepsen_tpu import synth as jsynth
from jepsen_tpu.elle import tpu as jtpu
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import adapt as jadapt
from jepsen_tpu.ops import aot as jaot
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.parallel import mesh as jmesh
from jepsen_tpu_torch import fs_cache
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import service
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch.elle import append as tappend
from jepsen_tpu_torch.elle import build as tbuild
from jepsen_tpu_torch.elle import tpu as ttpu
from jepsen_tpu_torch.models import core as tmodels
from jepsen_tpu_torch.ops import aot, wgl, wgl32, wgln
from jepsen_tpu_torch.ops import encode as tencode
from jepsen_tpu_torch.parallel import batched as tbatched
from jepsen_tpu_torch.parallel import mesh
from jepsen_tpu_torch.util import resolve_devices

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


HISTS = {
    "narrow": lambda s: s.cas_register_history(300, n_procs=4, seed=3,
                                               crash_p=0.01),
    "narrow-crashy": lambda s: s.cas_register_history(
        600, n_procs=12, seed=1, crash_p=0.1),
    "wide": lambda s: s.adversarial_wave_history(4, width=8, span=3, seed=5,
                                                 invalid=False),
}


def _encs(name):
    h = HISTS[name](jsynth)
    return (jencode.encode(jmodels.cas_register(), h),
            tencode.encode(tmodels.cas_register(), to_port(h)))


@pytest.mark.parametrize("name", list(HISTS))
def test_bucket_for_matches_the_reference(name):
    je, te = _encs(name)
    assert service.bucket_for(te) == jservice.bucket_for(je)


@pytest.mark.parametrize("name", list(HISTS))
@pytest.mark.parametrize("nd,lanes", [(8, 2), (2, 4), (1, 1)])
def test_plan_cache_key_matches_the_reference(name, nd, lanes):
    _, bucket = service.bucket_for(_encs(name)[1])
    kw = dict(n_devices=nd, lanes_per_device=lanes, axes=("keys",),
              model_name="cas")
    assert mesh.plan_cache_key(bucket, **kw) == \
        jmesh.plan_cache_key(bucket, **kw)


def _stub_ladder(**kw):
    return {k: None for k in kw["ladder"]}


@pytest.mark.parametrize("name", list(HISTS))
def test_service_bucket_warms_the_reference_ladder(name):
    _, bucket = service.bucket_for(_encs(name)[1])
    with mock.patch.object(jaot, "precompile_wgl_ladder", _stub_ladder):
        want = jaot.precompile_service_bucket(bucket)
    got = aot.precompile_service_bucket(bucket, device="cpu")
    assert list(got) == list(want)
    assert all(s >= 0 for s in got.values())


def test_wgl_ladder_keys_match_the_reference():
    kw = dict(n_pad=192, ic_pad=16, S=8, O=8, H=1 << 12, B=256, chunk=64,
              probes=4, W=24)
    want = jadapt.precompile_ladder(**kw, compile_now=False)
    assert list(aot.precompile_wgl_ladder(**kw, device="cpu")) == list(want)
    wide = dict(kw, W=64, L=2, ladder=(32, 256))
    assert list(aot.precompile_wgl_ladder(**wide, device="cpu")) == [32, 256]


@pytest.mark.parametrize("name", ["narrow", "wide"])
def test_warmed_check_equals_unwarmed(name):
    _, te = _encs(name)
    h = to_port(HISTS[name](jsynth))

    def key(res):
        return (res["valid?"], res.get("configs_explored"), res.get("K"),
                res["util"]["chunks"], res["util"]["rounds"])

    cold = wgl.check(tmodels.cas_register(), h, device="cpu")
    aot.precompile_service_bucket(service.bucket_for(te)[1], device="cpu")
    assert key(wgl.check(tmodels.cas_register(), h, device="cpu")) == \
        key(cold)


# --- the mesh warm plane -----------------------------------------------------

def _keys():
    return [jsynth.cas_register_history(
        60 + 15 * s, n_procs=3, seed=s, crash_p=0.03,
        lie_p=0.1 if s == 3 else 0.0) for s in range(6)]


def _mesh_bucket(hists):
    encs = [tencode.encode(tmodels.cas_register(), to_port(h))
            for h in hists]
    return encs, tbatched.shared_shape_bucket(encs)


MESH_KW = dict(lanes_per_device=2, steal=False, oracle_fallback=False,
               chunk=64)


def _mesh_key(res):
    return [(r["valid?"], r.get("configs_explored"), r.get("K"),
             r["util"]["rounds"], r["mesh"]) for r in res]


def test_warm_plan_keys_match_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(fs_cache, "DIR", str(tmp_path))
    _, bucket = _mesh_bucket(_keys())
    got = mesh.warm_plan(bucket, devices=["cpu"] * 2, lanes_per_device=2,
                         chunk=64, save=False)
    assert list(got) == list(jmesh.kernel_params(bucket, 4, 64)["ladder"])
    mesh.pool_clear()


def test_warmed_check_mesh_takes_the_pool_and_equals_unwarmed(tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(fs_cache, "DIR", str(tmp_path))
    hists = _keys()
    encs, bucket = _mesh_bucket(hists)
    ports = [to_port(h) for h in hists]
    devs = ["cpu"] * 2
    mesh.pool_clear()
    cold = mesh.check_mesh(tmodels.cas_register(), ports, encs=encs,
                           devices=devs, **MESH_KW)
    assert not mesh.last_summary()["groups"][0]["pool_hit"]
    mesh.pool_clear()
    aot.precompile_mesh_plan(bucket, devs, lanes_per_device=2, chunk=64,
                             model_name="cas")
    # the warm registered its plan in the port's own registry
    assert [p["model"] for p in fs_cache.list_data(("mesh-plan",))] == \
        ["cas"]
    warm = mesh.check_mesh(tmodels.cas_register(), ports, encs=encs,
                           devices=devs, **MESH_KW)
    assert mesh.last_summary()["groups"][0]["pool_hit"]
    assert _mesh_key(warm) == _mesh_key(cold)
    # a healthy run restocks the pool for the next one
    mesh.pool_settle()
    again = mesh.check_mesh(tmodels.cas_register(), ports, encs=encs,
                            devices=devs, **MESH_KW)
    assert mesh.last_summary()["groups"][0]["pool_hit"]
    assert _mesh_key(again) == _mesh_key(cold)
    mesh.pool_clear()


@pytest.mark.parametrize("wide", [False, True])
def test_pooled_carry_is_a_fresh_init_carry(tmp_path, monkeypatch, wide):
    monkeypatch.setattr(fs_cache, "DIR", str(tmp_path))
    hists = ([jsynth.adversarial_wave_history(4, width=10, span=4, seed=s)
              for s in range(4)] if wide else _keys())
    _, bucket = _mesh_bucket(hists)
    devs = [torch.device("cpu")] * 2
    mesh.pool_clear()
    mesh.warm_plan(bucket, devices=devs, lanes_per_device=2, chunk=64,
                   save=False)
    p = mesh.kernel_params(bucket, 4, 64)
    K = p["ladder"][0]
    entry = mesh._pool_take(mesh._pool_key(p, K, devs, 4))
    assert entry is not None and len(entry) == 2
    C = (wgln.row_words(p["L"], p["ic_pad"]) if p["L"]
         else wgl32.row_words(p["ic_pad"]))
    fresh = wgl32.init_carry_batch(2, K, C, p["H"], p["B"], 0, "cpu",
                                   mst_col=1 + p["L"] if p["L"] else 2)
    for d in range(2):
        carry = mesh._pool_adopt(entry, d, None)
        assert len(carry) == len(fresh)
        for a, b in zip(carry, fresh):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert mesh._pool_take(mesh._pool_key(p, K, devs, 4)) is None


def test_pool_holds_at_most_its_cap():
    mesh.pool_clear()
    for i in range(mesh._CARRY_POOL_CAP + 2):
        mesh._pool_stock(("k", i), lambda: [("carry", None)])
    assert len(mesh._CARRY_POOL) == mesh._CARRY_POOL_CAP
    mesh.pool_clear()


def test_plan_cache_registry_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setattr(fs_cache, "DIR", str(tmp_path))
    _, bucket = _mesh_bucket(_keys()[:4])
    key = mesh.plan_cache_key(bucket, n_devices=8, lanes_per_device=2,
                              axes=("keys",), model_name="cas")
    fs_cache.save_data(key, {"bucket": bucket, "n_devices": 8,
                             "lanes_per_device": 2, "axes": ["keys"],
                             "model": "cas", "chunk": 64})
    plans = fs_cache.list_data(("mesh-plan",))
    assert len(plans) == 1 and plans[0]["model"] == "cas"
    warmed = []
    devs = ["cpu"] * 8
    with mock.patch.object(mesh, "warm_plan",
                           lambda b, **kw: warmed.append(kw) or {2: 0.1}):
        out = aot.precompile_cached_mesh_plans(devs)
    assert len(out) == 1 and len(warmed) == 1
    assert warmed[0]["lanes_per_device"] == 2 and warmed[0]["chunk"] == 64
    fs_cache.save_data(
        mesh.plan_cache_key(bucket, n_devices=4, lanes_per_device=2,
                            axes=("keys",), model_name="x"),
        {"bucket": bucket, "n_devices": 4, "lanes_per_device": 2,
         "axes": ["keys"], "model": "x", "chunk": 64})
    with mock.patch.object(mesh, "warm_plan", lambda b, **kw: {2: 0.1}):
        out = aot.precompile_cached_mesh_plans(devs)
    assert len(out) == 1  # the 4-device plan was skipped
    # a warm that fails raises: nothing is passed over
    with mock.patch.object(mesh, "warm_plan",
                           mock.Mock(side_effect=RuntimeError("launch"))):
        with pytest.raises(RuntimeError):
            aot.precompile_cached_mesh_plans(devs)


def test_the_two_registries_never_mix():
    assert fs_cache.DIR != jfs_cache.DIR
    assert fs_cache.DIR.endswith(os.path.join(".jepsen_tpu_torch", "cache"))


def test_service_plan_registers_one_entry(tmp_path, monkeypatch):
    monkeypatch.setattr(fs_cache, "DIR", str(tmp_path))
    key, bucket = service.bucket_for(_encs("narrow")[1])
    out = aot.precompile_service_plan(bucket, bucket_key=key,
                                      model_name="cas", device="cpu")
    assert out["mesh"] is None and list(out["serial"]) == [2, 16, 64, 512]
    rec = fs_cache.load_data(("service-plan", "cas",
                              "-".join(str(k) for k in key)))
    assert rec["bucket"] == bucket and rec["mesh"] is None


def test_service_plan_warms_the_callers_mesh(tmp_path, monkeypatch):
    """`devices=` is the mesh half's list: a ["cpu"] * 2 service warms
    its lane-group plan over those two shards (the first visible cards
    would be none here) and registers `mesh` with n_devices 2."""
    monkeypatch.setattr(fs_cache, "DIR", str(tmp_path))
    key, bucket = service.bucket_for(_encs("narrow")[1])
    seen = []
    real = mesh.warm_plan

    def spy(b, **kw):
        seen.append([str(d) for d in resolve_devices(kw["devices"])])
        return real(b, **kw)
    with mock.patch.object(mesh, "warm_plan", spy):
        out = aot.precompile_service_plan(
            bucket, bucket_key=key, model_name="cas", device="cpu",
            devices=["cpu"] * 2,
            mesh_layout={"n_devices": 2, "lanes_per_device": 4,
                         "chunk": 1024})
    assert seen == [["cpu", "cpu"]] and out["mesh"]
    rec = fs_cache.load_data(("service-plan", "cas",
                              "-".join(str(k) for k in key)))
    assert rec["mesh"] == {"n_devices": 2, "lanes_per_device": 4,
                           "chunk": 1024, "axes": ["keys"]}
    mesh.pool_settle()
    mesh.pool_clear()


@pytest.mark.parametrize("devices", [None, ["cpu"]])
def test_service_plan_mesh_needs_a_mesh(tmp_path, monkeypatch, devices):
    """A mesh layout warms only the caller's list of 2 or more: with no
    list, or a list of one, it raises instead of skipping the mesh."""
    monkeypatch.setattr(fs_cache, "DIR", str(tmp_path))
    key, bucket = service.bucket_for(_encs("narrow")[1])
    with pytest.raises(ValueError, match="mesh"):
        aot.precompile_service_plan(
            bucket, bucket_key=key, model_name="cas", device="cpu",
            devices=devices,
            mesh_layout={"n_devices": 2, "lanes_per_device": 4,
                         "chunk": 1024})
    assert fs_cache.list_data(("service-plan",)) == []


# --- Elle --------------------------------------------------------------------

def _graph():
    h = tsynth.list_append_history(200, n_procs=5, seed=3)
    oks = [op for op in h if op.is_ok and op.f in ("txn", None) and op.value]
    infos = [op for op in h
             if op.is_info and op.f in ("txn", None) and op.value]
    return tbuild.build_append(h, oks, infos,
                               additional_graphs=("realtime",)).tensors


def _stub_elle():
    z = (None, 0.0)
    return (mock.patch.object(jtpu, "_compiled_trim", lambda *a: z),
            mock.patch.object(jtpu, "_compiled_packed", lambda *a: z),
            mock.patch.object(jtpu, "_compiled", lambda *a: z),
            mock.patch.object(jtpu, "_compiled_sharded",
                              lambda *a: (None, None, 0.0)))


@pytest.mark.parametrize("kernels", [None, ("trim", "bf16", "packed",
                                            "sharded")])
def test_elle_warm_keys_match_the_reference(kernels):
    g = _graph()
    bucket = ttpu.shape_bucket_for(g)
    assert bucket == {k: jtpu.shape_bucket_for(g)[k]
                      for k in ("n", "trim", "dense")}
    stubs = _stub_elle()
    for s in stubs:
        s.start()
    try:
        want = jaot.precompile_elle_closure(bucket, kernels)
    finally:
        for s in stubs:
            s.stop()
    got = aot.precompile_elle_closure(bucket, kernels,
                                      devices=["cpu"] * 2)
    assert list(got) == list(want)
    with pytest.raises(ValueError):
        aot.precompile_elle_closure(bucket, ("dense",), device="cpu")


@pytest.mark.parametrize("backend", ["packed", "trim"])
def test_warmed_elle_check_equals_unwarmed(backend):
    h = tsynth.list_append_history(120, n_procs=4, seed=5)

    def key(res):
        u = res.get("cycle-util") or {}
        return (res["valid?"], res.get("anomaly-types"), u.get("kernel"),
                u.get("iters_run"))

    cold = tappend.check(h, additional_graphs=("realtime",),
                         cycle_backend=backend, device="cpu")
    aot.precompile_elle_closure(ttpu.shape_bucket_for(_graph()), (backend,),
                                device="cpu")
    assert key(tappend.check(h, additional_graphs=("realtime",),
                             cycle_backend=backend, device="cpu")) == \
        key(cold)


# --- the bench ---------------------------------------------------------------

def test_bench_prints_its_line_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.bench", "--device", "cpu",
         "--ops", "200"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert {"metric", "value", "cold_s", "platform", "device_kind",
            "compiles", "d2h", "h2d", "configs"} <= set(line)
    assert line["metric"] == "cas_register_0k_wgl_wall_s"
    assert line["platform"] == "cpu" and line["verdict"] is True
    assert line["value"] > 0 and line["compiles"] == 0
    assert line["h2d"] == 1 and line["d2h"] >= 1
    (entry,) = line["configs"].values()
    assert entry["verdict"] is True and entry["K"] >= 1


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _zero_consts(lanes, n_pad, ic, S, O, device):
    z = np.zeros
    if lanes is None:
        return wgl32.consts_from_numpy(
            z(n_pad, np.int32), z(n_pad, np.int32), z(n_pad, np.int32),
            z(n_pad + 1, np.int32), z(ic, np.int32), z(ic, np.int32),
            z((S, O), np.int32), 0, 0, 0, device)
    return wgl32.batch_consts_from_numpy(
        z((lanes, n_pad), np.int32), z((lanes, n_pad), np.int32),
        z((lanes, n_pad), np.int32), z((lanes, n_pad + 1), np.int32),
        z((lanes, ic), np.int32), z((lanes, ic), np.int32),
        z((lanes, S, O), np.int32), 0, 0, 0, device)


def _same_leaves(got, got_s, ref, ref_s, what):
    assert torch.equal(got_s.cpu(), ref_s.cpu()), what
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a.cpu(), b.cpu()), (what, i)


# (K, W, ic, H, B): shared and global one-CTA forms narrow; shared,
# global and grid wide (L = W / 32)
ZERO_NARROW = [(2, 32, 32, 1 << 12, 256), (512, 32, 32, 1 << 12, 256)]
ZERO_WIDE = [(16, 64, 8, 1 << 12, 256), (512, 96, 16, 1 << 12, 256)]


@pytest.mark.gpu
def test_zero_round_launch_of_every_form_changes_nothing(cuda_device):
    n_pad, S, O = 192, 16, 32
    for K, W, ic, H, B in ZERO_NARROW:
        C = wgl32.row_words(ic)
        forms = [wgl32.block_form(K, W, ic, C),
                 wgl32.Form("global", wgl32.block_form(K, W, ic, C).threads)]
        for form in forms:
            consts = _zero_consts(None, n_pad, ic, S, O, cuda_device)
            carry = wgl32.init_carry(K, C, H, B, 0, cuda_device)
            ref_in = tuple(t.clone() for t in carry)
            s = wgl32.launch("wgl32_chunk", consts, carry, K=K, W=W, L=1,
                             ic=ic, H=H, B=B, rounds=1024, probes=4,
                             form=form)
            torch.cuda.synchronize()
            ref, ref_s = wgl32.chunk_ref(consts, ref_in, K=K, W=W, ic=ic,
                                         H=H, B=B, chunk=1024, probes=4)
            _same_leaves(carry, s, ref, ref_s, ("wgl32", K, form))
        for lanes_form in (None, wgl32.Form(
                "global", wgl32.block_form(K, W, ic, C).threads)):
            consts = _zero_consts(4, n_pad, ic, S, O, cuda_device)
            carry = wgl32.init_carry_batch(4, K, C, H, B, 0, cuda_device)
            ref_in = tuple(t.clone() for t in carry)
            s = wgl32.launch_batched("wgl32_chunk_batched", consts, carry,
                                     K=K, W=W, L=1, ic=ic, H=H, B=B,
                                     rounds=1024, probes=4, form=lanes_form)
            torch.cuda.synchronize()
            ref, ref_s = wgl32.chunk_batched_ref(consts, ref_in, K=K, W=W,
                                                 ic=ic, H=H, B=B, chunk=1024,
                                                 probes=4)
            _same_leaves(carry, s, ref, ref_s, ("batched", K, lanes_form))
    for K, W, ic, H, B in ZERO_WIDE:
        L, C = W // 32, wgln.row_words(W // 32, ic)
        one = wgl32.block_form(K, W, ic, C)
        forms = [one, wgl32.Form("global", one.threads),
                 wgl32.Form("grid", 1024, -(-K * (W + ic) // 1024))]
        for form in forms:
            consts = _zero_consts(None, n_pad, ic, S, O, cuda_device)
            carry = wgln.init_carry(K, L, ic, H, B, 0, cuda_device)
            ref_in = tuple(t.clone() for t in carry)
            s = wgl32.launch("wgln_chunk", consts, carry, K=K, W=W, L=L,
                             ic=ic, H=H, B=B, rounds=128, probes=4,
                             form=form)
            torch.cuda.synchronize()
            ref, ref_s = wgln.chunk_ref(consts, ref_in, K=K, L=L, ic=ic, H=H,
                                        B=B, chunk=128, probes=4)
            _same_leaves(carry, s, ref, ref_s, ("wgln", K, form))
        consts = _zero_consts(4, n_pad, ic, S, O, cuda_device)
        carry = wgln.init_carry_batch(4, K, L, ic, H, B, 0, cuda_device)
        ref_in = tuple(t.clone() for t in carry)
        s = wgl32.launch_batched("wgln_chunk_batched", consts, carry, K=K,
                                 W=W, L=L, ic=ic, H=H, B=B, rounds=128,
                                 probes=4)
        torch.cuda.synchronize()
        ref, ref_s = wgln.chunk_batched_ref(consts, ref_in, K=K, L=L, ic=ic,
                                            H=H, B=B, chunk=128, probes=4)
        _same_leaves(carry, s, ref, ref_s, ("wgln batched", K))


@pytest.mark.gpu
def test_pooled_carry_on_a_shard_stream_equals_fresh(cuda_device,
                                                     tmp_path, monkeypatch):
    monkeypatch.setattr(fs_cache, "DIR", str(tmp_path))
    _, bucket = _mesh_bucket(_keys())
    devs = resolve_devices([cuda_device] * 2)   # the pool keys by label
    mesh.pool_clear()
    mesh.warm_plan(bucket, devices=devs, lanes_per_device=2, chunk=64)
    p = mesh.kernel_params(bucket, 4, 64)
    K = p["ladder"][0]
    entry = mesh._pool_take(mesh._pool_key(p, K, devs, 4))
    assert entry is not None
    C = wgl32.row_words(p["ic_pad"])
    streams = [torch.cuda.Stream(device=cuda_device) for _ in devs]
    for d, st in enumerate(streams):
        with torch.cuda.stream(st):
            carry = mesh._pool_adopt(entry, d, st)
            got = tuple(t.clone() for t in carry)
            fresh = wgl32.init_carry_batch(2, K, C, p["H"], p["B"], 0,
                                           cuda_device)
        st.synchronize()
        for a, b in zip(got, fresh):
            assert torch.equal(a, b)


COUNT = """
import json, sys, torch
from jepsen_tpu_torch import checker, service, synth
from jepsen_tpu_torch.analysis import guards
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import aot, encode
h = synth.cas_register_history(2000, n_procs=5, seed=42, crash_p=0.002)
if sys.argv[1] == "warm":
    aot.precompile_service_bucket(
        service.bucket_for(encode.encode(cas_register(), h))[1])
with guards.CompileGuard() as g:
    res = checker.linearizable(cas_register(), algorithm="cuda-wgl").check(
        {}, h, {})
print(json.dumps(dict(g.report(), valid=res["valid?"],
                      chunks=res["util"]["chunks"])))
"""


@pytest.mark.gpu
def test_warm_counts_no_compile_in_a_fresh_process(cuda_device):
    out = {}
    for mode in ("cold", "warm"):
        proc = subprocess.run([sys.executable, "-c", COUNT, mode], cwd=REPO,
                              capture_output=True, text=True, timeout=600,
                              check=True)
        out[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    cold, warm = out["cold"], out["warm"]
    assert cold["valid"] is True and warm["valid"] is True
    assert cold["loads"] >= 1 and cold["binds"] >= 1
    assert warm["compiles"] == 0
    assert warm["h2d"] == 1 and warm["d2h"] == warm["chunks"]
