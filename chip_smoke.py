#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`jepsen_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel from `jepsen_tpu_torch/csrc/`, holds each
kernel bit for bit against its plain PyTorch version on the card at the
shapes the main path gives it, times both, drives the main path (the
10k-op cas-register headline through `checker.linearizable(...,
algorithm="cuda-wgl")`) with every launch counter set to 0 just before
and read just after, times the first check of a fresh process, checks
an invalid history against the host oracle,
and prints as its last lines the card, one JSON line of per-kernel
numbers and `{"ok": true, "device": {...}}`. Any failed check raises,
so the script exits non-zero and prints no result; so does a machine
without a card, or a directory without the package.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device-memory rate (data sheet)
HEADLINE = dict(n_ops=10000, n_procs=5, seed=42, crash_p=0.002)
INVALID = dict(n_ops=2000, n_procs=5, seed=9, lie_p=0.004)
SMALL = dict(W=24, ic=16, H=1 << 12, B=64, chunk=64, chunks=3)
REPO = Path(__file__).resolve().parent

# the first check of a fresh process, timed from the checker call (the
# CUDA context is made first and timed apart)
COLD = """
import json, time, torch
from jepsen_tpu_torch import checker, synth
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import wgl32
h = synth.cas_register_history(%(n_ops)d, n_procs=%(n_procs)d,
                               seed=%(seed)d, crash_p=%(crash_p)r)
t0 = time.monotonic()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
ctx = time.monotonic() - t0
t0 = time.monotonic()
res = checker.linearizable(cas_register(), algorithm="cuda-wgl").check(
    {}, h, {})
torch.cuda.synchronize()
print(json.dumps({"wall_s": time.monotonic() - t0, "context_s": ctx,
                  "valid": res["valid?"], "search_s": res["wall_s"],
                  "first_call_s": res["util"]["first_call_s"],
                  "launches": wgl32.chunk.launches}))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def same_carry(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def max_abs_err(a, b) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0 for x, y in zip(a, b))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import checker, synth
    from jepsen_tpu_torch.models import cas_register, mutex, register
    from jepsen_tpu_torch.ops import _native, adapt, encode, wgl, wgl32
    from jepsen_tpu_torch.ops import wgl_ref

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print("card:", card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.monotonic()
    builds = _native.build_all()
    print(f"build: {time.monotonic() - t0:.2f} s for {sorted(builds)}")
    for name, rec in builds.items():
        if rec is None:
            print(f"  {name}: already built")
        else:
            print(f"  {name}: nvcc {rec['seconds']:.2f} s\n{rec['ptxas']}")

    kern = wgl32.chunk

    def run_both(consts, carry, tally=None, **kw):
        """The kernel and the plain version on the same inputs; both
        timed; the kernel's result returned. `tally` goes to the plain
        version (its count of probed rows)."""
        ref_in = tuple(t.clone() for t in carry)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out, summary = kern(consts, carry, **kw)
        e1.record()
        torch.cuda.synchronize()
        t_ref = time.monotonic()
        ref, ref_summary = wgl32.chunk_ref(consts, ref_in, tally=tally, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t_ref) * 1e3
        err = max(max_abs_err(out, ref), max_abs_err([summary],
                                                    [ref_summary]))
        if not (same_carry(out, ref) and torch.equal(summary, ref_summary)):
            raise AssertionError(f"wgl32_chunk differs from chunk_ref "
                                 f"(max abs err {err}) at {kw}")
        return out, summary, e0.elapsed_time(e1), plain_ms, err

    # ---- 2. kernel against its plain version ------------------------------
    corpora = {
        "register": (register(), synth.cas_register_history(
            150, n_procs=4, seed=11, crash_p=0.04, fs=("read", "write"))),
        "cas": (cas_register(), synth.cas_register_history(
            150, n_procs=5, seed=3, crash_p=0.05)),
        "cas-invalid": (cas_register(), synth.cas_register_history(
            120, n_procs=5, seed=8, crash_p=0.05, lie_p=0.03)),
        "mutex": (mutex(), synth.mutex_history(120, seed=5)),
    }
    worst_err = 0
    s = SMALL
    for name, (model, hist) in corpora.items():
        enc = encode.encode(model, hist)
        consts = wgl32.consts_from_numpy(
            enc.inv, enc.ret, enc.opcode, enc.sufminret,
            enc.inv_info[:s["ic"]], enc.opcode_info[:s["ic"]], enc.table,
            enc.n_ok, enc.n_info, 10**8, dev)
        for K in (2, 16, 512):
            carry = wgl32.init_carry(K, wgl32.row_words(s["ic"]), s["H"],
                                     s["B"], 0, dev)
            for _ in range(s["chunks"]):
                carry, summary, _, _, err = run_both(
                    consts, carry, K=K, W=s["W"], ic=s["ic"], H=s["H"],
                    B=s["B"], chunk=s["chunk"], probes=4)
                worst_err = max(worst_err, err)
                if int(summary[1]) or int(summary[0]) == 0:
                    break
        want = wgl_ref.check(model, hist)["valid?"]
        got = wgl.check(model, hist, device=dev)["valid?"]
        if got != want:
            raise AssertionError(f"{name}: device {got} != oracle {want}")
        print(f"small corpus {name}: kernel == chunk_ref at K=2,16,512; "
              f"verdict {got} == oracle")

    # the headline's own shapes: its first chunk at K=2, then one chunk
    # after migrating the beam to K=512
    h = synth.cas_register_history(HEADLINE["n_ops"],
                                   n_procs=HEADLINE["n_procs"],
                                   seed=HEADLINE["seed"],
                                   crash_p=HEADLINE["crash_p"])
    enc = encode.encode(cas_register(), h)
    plan = wgl.derive_plan(window_raw=enc.window_raw,
                           ic_pad=len(enc.inv_info), n=enc.n_ok,
                           n_info=enc.n_info, accel=True)
    kw = dict(W=plan["W_eff"], ic=plan["ic_eff"], H=plan["H"], B=plan["B"],
              chunk=plan["chunk"], probes=plan["probes"])
    print("headline plan:", json.dumps({k: plan[k] for k in (
        "kern", "K", "H", "B", "W_eff", "ic_eff", "chunk", "ladder")}),
          f"n_ok={enc.n_ok} n_info={enc.n_info} window={enc.window_raw}")
    consts = wgl32.consts_from_numpy(
        enc.inv, enc.ret, enc.opcode, enc.sufminret,
        enc.inv_info[:kw["ic"]], enc.opcode_info[:kw["ic"]], enc.table,
        enc.n_ok, enc.n_info, 200_000_000, dev)
    C = wgl32.row_words(kw["ic"])
    start = wgl32.init_carry(plan["K"], C, kw["H"], kw["B"], 0, dev)
    tally: dict = {}
    carry, summary, first_ms, plain_ms, err = run_both(
        consts, tuple(t.clone() for t in start), tally=tally, K=plan["K"],
        **kw)
    worst_err = max(worst_err, err)
    sh = summary[:wgl32.SUMMARY_HEAD].tolist()
    rounds_k2, explored_k2, new_k2 = sh[4 + 5], sh[4], sh[4 + 4]
    print(f"headline chunk 1 (K={plan['K']}): {rounds_k2} rounds, kernel "
          f"{first_ms:.3f} ms, chunk_ref {plain_ms:.1f} ms, identical")
    wide = adapt.migrate_frontier(carry, 512)
    _, summary512, ms512, plain512, err = run_both(consts, wide, K=512, **kw)
    worst_err = max(worst_err, err)
    r512 = int(summary512[9]) - rounds_k2
    print(f"headline chunk 2 after migrate to K=512: {r512} rounds, kernel "
          f"{ms512:.3f} ms ({ms512 * 1e3 / max(r512, 1):.2f} us/round), "
          f"chunk_ref {plain512:.1f} ms, identical")

    # kernel time at the main path's first chunk: repeated from the
    # same start state (the clone sits outside the timed window)
    times = []
    for _ in range(5):
        c = tuple(t.clone() for t in start)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        kern(consts, c, K=plan["K"], **kw)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    kernel_ms = float(np.median(times))
    print(f"headline chunk 1 kernel times (ms): "
          f"{[round(t, 4) for t in times]}; median {kernel_ms:.4f} ms = "
          f"{kernel_ms * 1e3 / rounds_k2:.2f} us/round")
    # least bytes the chunk must move for this run's data: the consts
    # read once; per expanded config its row read; per successor that
    # goes to the memo table (legal, not a linearization: counted by
    # chunk_ref) one 16-byte slot read; per new config its row and its
    # memo entry written; the summary written
    consts_bytes = sum(t.numel() * 4 for t in (consts.meta, consts.tk,
                                               consts.iinv, consts.iopc))
    bytes_moved = (consts_bytes + explored_k2 * C * 4 + tally["probed"] * 16
                   + new_k2 * (C * 4 + 16) + summary.numel() * 4)
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"bound: {bytes_moved} bytes ({explored_k2} configs expanded, "
          f"{tally['probed']} successors probed, {new_k2} new) over "
          f"3.35 TB/s = {bound_ms:.6f} ms for {rounds_k2} rounds")

    # ---- 3. the main path ---------------------------------------------------
    # in this process, every count set to 0 just before and read just
    # after; CUDA events around each kernel launch
    events = []
    launch = _native.launch_wgl32_chunk

    def timed_launch(*a):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        launch(*a)
        e1.record()
        events.append((e0, e1))

    lin = checker.linearizable(cas_register(), algorithm="cuda-wgl")
    torch.cuda.reset_peak_memory_stats(dev)
    _native.launch_wgl32_chunk = timed_launch
    try:
        kern.launches = 0
        t0 = time.monotonic()
        res = lin.check({}, h, {})
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = kern.launches
    finally:
        _native.launch_wgl32_chunk = launch
    dev_ms = sum(a.elapsed_time(b) for a, b in events)
    u = res["util"]
    print(f"main path (after the comparisons above): valid? "
          f"{res['valid?']} wall {wall:.4f} s (search {res['wall_s']} s), "
          f"rounds {u['rounds']}, chunks {u['chunks']}, launches "
          f"{launches}, kernel {dev_ms:.3f} ms = "
          f"{dev_ms * 1e3 / u['rounds']:.2f} us/round, configs "
          f"{res['configs_explored']}, adapt "
          f"{u.get('adapt', {}).get('path')}, peak memory "
          f"{torch.cuda.max_memory_allocated(dev)} B")
    if res["valid?"] is not True or launches < 1:
        raise AssertionError(f"headline: {res['valid?']}, {launches} "
                             "launches")

    # the first check of a fresh process (the kernel library is built)
    cold = json.loads(subprocess.run(
        [sys.executable, "-c", COLD % HEADLINE], cwd=REPO,
        capture_output=True, text=True, check=True,
        timeout=300).stdout.strip().splitlines()[-1])
    print(f"main path, first check of a fresh process: valid? "
          f"{cold['valid']} wall {cold['wall_s']:.4f} s (search "
          f"{cold['search_s']} s, first chunk {cold['first_call_s']} s), "
          f"launches {cold['launches']}; CUDA context before it "
          f"{cold['context_s']:.3f} s")
    if cold["valid"] is not True or cold["launches"] < 1:
        raise AssertionError(f"fresh-process headline: {cold}")

    # ---- 4. an invalid history: device False == oracle False --------------
    bad = synth.cas_register_history(INVALID["n_ops"],
                                     n_procs=INVALID["n_procs"],
                                     seed=INVALID["seed"],
                                     lie_p=INVALID["lie_p"])
    t0 = time.monotonic()
    want = wgl_ref.check(cas_register(), bad, time_limit=30)
    t_oracle = time.monotonic() - t0
    t0 = time.monotonic()
    got = checker.linearizable(cas_register()).check({}, bad, {})
    t_dev = time.monotonic() - t0
    print(f"invalid history {INVALID}: oracle {want['valid?']} "
          f"({t_oracle:.2f} s), device {got['valid?']} ({t_dev:.2f} s, "
          f"{got.get('configs_explored')} configs, "
          f"{got.get('util', {}).get('rounds')} rounds)")
    if want["valid?"] is not False or got["valid?"] is not False:
        raise AssertionError("invalid history not decided False by both")

    print("card:", card_line())
    print(json.dumps({"kernels": [{
        "name": "wgl32_chunk", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/wgl32_chunk.cu",
        "replaces": "jepsen_tpu/ops/wgl32.py:725",
        "launches": launches, "max_abs_err": worst_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
