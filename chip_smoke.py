#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`jepsen_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel from `jepsen_tpu_torch/csrc/`, holds each
kernel bit for bit against its plain PyTorch version on the card at the
shapes the main paths give it, times both, and drives the two main
paths, each with every launch counter set to 0 just before and read
just after:

  * narrow windows: the 10k-op cas-register headline through
    `checker.linearizable(..., algorithm="cuda-wgl")` (`wgl32_chunk`),
    then the first check of a fresh process, and an invalid history
    against the host oracle;
  * wide windows: the 16-wave adversarial history (window 71, ~2.08M
    configs to exhaust) through the same checker (`wgln_chunk`).

Then the default checker (`algorithm="competition"`) decides a 900-op
long tail (window 657) and a 100k-op FIFO-queue history (queue-poly),
and the frontier migration of a ladder switch is timed. It prints as
its last lines the card, one JSON line of per-kernel numbers and
`{"ok": true, "device": {...}}`. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a card,
or a directory without the package.
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
WAVE = dict(n_waves=16, width=14, span=5, seed=7)
WAVE_CONFIGS = 2_084_641      # the JAX package's exhaustive count
LONG_TAIL = dict(n_quick=900, seed=7)
FIFO = dict(n_ops=100_000, n_procs=4, seed=7)
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
    from jepsen_tpu_torch.models import (cas_register, fifo_queue, mutex,
                                         register)
    from jepsen_tpu_torch.ops import _native, adapt, encode, wgl, wgl32
    from jepsen_tpu_torch.ops import wgl_ref, wgln

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

    def run_both(consts, carry, tally=None, mod=wgl32, **kw):
        """The kernel of `mod` (wgl32 or wgln) and its plain version on
        the same inputs; both timed; the kernel's result returned.
        `tally` goes to the plain version (its count of probed rows)."""
        ref_in = tuple(t.clone() for t in carry)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out, summary = mod.chunk(consts, carry, **kw)
        e1.record()
        torch.cuda.synchronize()
        t_ref = time.monotonic()
        ref, ref_summary = mod.chunk_ref(consts, ref_in, tally=tally, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t_ref) * 1e3
        err = max(max_abs_err(out, ref), max_abs_err([summary],
                                                    [ref_summary]))
        if not (same_carry(out, ref) and torch.equal(summary, ref_summary)):
            raise AssertionError(f"{mod.__name__} kernel differs from "
                                 f"chunk_ref (max abs err {err}) at {kw}")
        return out, summary, e0.elapsed_time(e1), plain_ms, err

    def bound_bytes(consts, summary, C, tally):
        """Least bytes a chunk must move for this run's data: the
        consts once; per expanded config its row read; per
        successor that goes to the memo table (legal, not a
        linearization: counted by chunk_ref) one 16-byte slot read; per
        new config its row and its memo entry written; the summary."""
        sh = summary[:wgl32.SUMMARY_HEAD].tolist()
        explored, new = sh[4], sh[4 + 4]
        consts_bytes = sum(t.numel() * 4 for t in (
            consts.meta, consts.tk, consts.iinv, consts.iopc))
        return (consts_bytes + explored * C * 4 + tally["probed"] * 16
                + new * (C * 4 + 16) + summary.numel() * 4)

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
        wgl32.chunk(consts, c, K=plan["K"], **kw)
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
    bytes_moved = bound_bytes(consts, summary, C, tally)
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"bound: {bytes_moved} bytes ({explored_k2} configs expanded, "
          f"{tally['probed']} successors probed, {new_k2} new) over "
          f"3.35 TB/s = {bound_ms:.6f} ms for {rounds_k2} rounds")

    # ---- 3. the wide kernel against its plain version -----------------------
    wide_corpora = {
        "wave-4x10": (2, 8, synth.adversarial_wave_history(
            4, width=10, span=4, seed=3)),
        "wave-valid": (2, 8, synth.adversarial_wave_history(
            3, width=11, span=3, seed=2, invalid=False)),
        "long-tail-120": (3, 8, synth.long_tail_history(120, seed=3)),
        "cas-crashy": (8, 48, synth.cas_register_history(
            600, n_procs=40, seed=1, crash_p=0.1)),
    }
    wide_err = 0
    for name, (L, ic, hist) in wide_corpora.items():
        enc = encode.encode(cas_register(), hist)
        consts = wgl32.consts_from_numpy(
            enc.inv, enc.ret, enc.opcode, enc.sufminret, enc.inv_info[:ic],
            enc.opcode_info[:ic], enc.table, enc.n_ok, enc.n_info, 10**8,
            dev)
        for K, (H, B) in ((32, (1 << 16, 4096)), (512, (1 << 16, 4096)),
                          (32, (1 << 10, 64))):
            carry = wgln.init_carry(K, L, ic, H, B, 0, dev)
            for _ in range(2):
                carry, summary, _, _, err = run_both(
                    consts, carry, mod=wgln, K=K, L=L, ic=ic, H=H, B=B,
                    chunk=32, probes=4)
                wide_err = max(wide_err, err)
                if int(summary[1]) or int(summary[0]) == 0:
                    break
        print(f"wide corpus {name} (L={L}, ic={ic}): wgln_chunk == "
              f"chunk_ref at K=32, 512 and with a 2^10 table, 64 backlog")

    # the 16-wave's own shapes: the plan's first chunk at K=256, one chunk
    # after migrating to K=2048 and one after migrating to K=4096
    wave = synth.adversarial_wave_history(
        WAVE["n_waves"], width=WAVE["width"], span=WAVE["span"],
        seed=WAVE["seed"])
    wenc = encode.encode(cas_register(), wave)
    wplan = wgl.derive_plan(window_raw=wenc.window_raw,
                            ic_pad=len(wenc.inv_info), n=wenc.n_ok,
                            n_info=wenc.n_info, accel=True)
    print("16-wave plan:", json.dumps({k: wplan[k] for k in (
        "kern", "K", "H", "B", "W_eff", "L", "ic_eff", "chunk", "ladder")}),
          f"n_ok={wenc.n_ok} n_info={wenc.n_info} window={wenc.window_raw}")
    wkw = dict(L=wplan["L"], ic=wplan["ic_eff"], H=wplan["H"], B=wplan["B"],
               chunk=wplan["chunk"], probes=wplan["probes"])
    wconsts = wgl32.consts_from_numpy(
        wenc.inv, wenc.ret, wenc.opcode, wenc.sufminret,
        wenc.inv_info[:wkw["ic"]], wenc.opcode_info[:wkw["ic"]], wenc.table,
        wenc.n_ok, wenc.n_info, 200_000_000, dev)
    wC = wgln.row_words(wkw["L"], wkw["ic"])
    wstart = wgln.init_carry(wplan["K"], wkw["L"], wkw["ic"], wkw["H"],
                             wkw["B"], 0, dev)
    wtally: dict = {}
    carry, wsummary, _, wplain_ms, err = run_both(
        wconsts, tuple(t.clone() for t in wstart), tally=wtally, mod=wgln,
        K=wplan["K"], **wkw)
    wide_err = max(wide_err, err)
    per_bucket = {}
    rounds_prev = int(wsummary[9])
    per_bucket[wplan["K"]] = (rounds_prev, None)
    # migrate_frontier of the 256 -> 2048 switch: CUDA events around it
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    mig_times = []
    for _ in range(5):
        e0.record()
        adapt.migrate_frontier(carry, 2048)
        e1.record()
        torch.cuda.synchronize()
        mig_times.append(e0.elapsed_time(e1))
    mig_ms = float(np.median(mig_times))
    mig_bytes = (wplan["K"] + 2048) * wC * 4
    mig_bound_ms = mig_bytes / HBM_BYTES_PER_S * 1e3
    print(f"migrate_frontier {wplan['K']} -> 2048 (C={wC}): "
          f"{[round(t, 4) for t in mig_times]} ms, median {mig_ms:.4f} ms; "
          f"bytes {mig_bytes} (read K*C*4 + write K'*C*4), bound "
          f"{mig_bound_ms:.6f} ms")
    for k_new in (2048, 4096):
        carry = adapt.migrate_frontier(carry, k_new)
        carry, s_k, ms_k, plain_k, err = run_both(wconsts, carry, mod=wgln,
                                                  K=k_new, **wkw)
        wide_err = max(wide_err, err)
        r_k = int(s_k[9]) - rounds_prev
        rounds_prev = int(s_k[9])
        per_bucket[k_new] = (r_k, ms_k)
        print(f"16-wave chunk at K={k_new}: {r_k} rounds, kernel {ms_k:.3f} "
              f"ms ({ms_k * 1e3 / max(r_k, 1):.2f} us/round), chunk_ref "
              f"{plain_k:.1f} ms, identical")
    # kernel time at the plan's first chunk, repeated from the same start
    # state (the clone sits outside the timed window)
    wtimes = []
    for _ in range(3):
        c = tuple(t.clone() for t in wstart)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        wgln.chunk(wconsts, c, K=wplan["K"], **wkw)
        e1.record()
        torch.cuda.synchronize()
        wtimes.append(e0.elapsed_time(e1))
    wkernel_ms = float(np.median(wtimes))
    r0 = per_bucket[wplan["K"]][0]
    per_bucket[wplan["K"]] = (r0, wkernel_ms)
    wbytes = bound_bytes(wconsts, wsummary, wC, wtally)
    wbound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    sh = wsummary[:wgl32.SUMMARY_HEAD].tolist()
    print(f"16-wave chunk 1 (K={wplan['K']}): {r0} rounds, kernel times (ms) "
          f"{[round(t, 4) for t in wtimes]}; median {wkernel_ms:.4f} ms = "
          f"{wkernel_ms * 1e3 / max(r0, 1):.2f} us/round; chunk_ref "
          f"{wplain_ms:.1f} ms; bound {wbytes} bytes ({sh[4]} configs "
          f"expanded, {wtally['probed']} successors probed, {sh[8]} new) "
          f"over 3.35 TB/s = {wbound_ms:.6f} ms")
    print("16-wave us/round by bucket:", json.dumps({
        str(k): round(ms * 1e3 / max(r, 1), 3) for k, (r, ms) in
        per_bucket.items()}))

    # one chunk of the 900-op long tail (window 657, L=21) at its plan
    tail = synth.long_tail_history(LONG_TAIL["n_quick"],
                                   seed=LONG_TAIL["seed"])
    tenc = encode.encode(cas_register(), tail)
    tplan = wgl.derive_plan(window_raw=tenc.window_raw,
                            ic_pad=len(tenc.inv_info), n=tenc.n_ok,
                            n_info=tenc.n_info, accel=True)
    tkw = dict(K=tplan["K"], L=tplan["L"], ic=tplan["ic_eff"], H=tplan["H"],
               B=tplan["B"], chunk=tplan["chunk"], probes=tplan["probes"])
    tconsts = wgl32.consts_from_numpy(
        tenc.inv, tenc.ret, tenc.opcode, tenc.sufminret,
        tenc.inv_info[:tkw["ic"]], tenc.opcode_info[:tkw["ic"]], tenc.table,
        tenc.n_ok, tenc.n_info, 200_000_000, dev)
    _, ts, tms, tplain, err = run_both(
        tconsts, wgln.init_carry(tkw["K"], tkw["L"], tkw["ic"], tkw["H"],
                                 tkw["B"], 0, dev), mod=wgln, **tkw)
    wide_err = max(wide_err, err)
    print(f"long tail {LONG_TAIL} chunk 1 (window {tenc.window_raw}, "
          f"{json.dumps(tkw)}): {int(ts[9])} rounds, kernel {tms:.3f} ms "
          f"({tms * 1e3 / max(int(ts[9]), 1):.2f} us/round), chunk_ref "
          f"{tplain:.1f} ms, identical")

    # ---- 4. the main paths ----------------------------------------------------
    # in this process, every count set to 0 just before a path and read
    # just after; CUDA events around each kernel launch
    events = []
    launch = _native.launch

    def timed_launch(name, *a):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        launch(name, *a)
        e1.record()
        events.append((name, e0, e1))

    def drive(lin, hist):
        """One check with both counts at 0 before it; returns (result,
        wall, launches by kernel, kernel ms by kernel, peak bytes)."""
        events.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _native.launch = timed_launch
        try:
            wgl32.chunk.launches = 0
            wgln.chunk.launches = 0
            t0 = time.monotonic()
            res = lin.check({}, hist, {})
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = {"wgl32_chunk": wgl32.chunk.launches,
                      "wgln_chunk": wgln.chunk.launches}
        finally:
            _native.launch = launch
        dev_ms = {k: sum(a.elapsed_time(b) for n, a, b in events if n == k)
                  for k in counts}
        return res, wall, counts, dev_ms, torch.cuda.max_memory_allocated(dev)

    lin = checker.linearizable(cas_register(), algorithm="cuda-wgl")
    res, wall, counts, dev_ms, peak = drive(lin, h)
    launches = counts["wgl32_chunk"]
    u = res["util"]
    print(f"main path, narrow (after the comparisons above): valid? "
          f"{res['valid?']} wall {wall:.4f} s (search {res['wall_s']} s), "
          f"rounds {u['rounds']}, chunks {u['chunks']}, launches "
          f"{counts}, kernel {dev_ms['wgl32_chunk']:.3f} ms = "
          f"{dev_ms['wgl32_chunk'] * 1e3 / u['rounds']:.2f} us/round, "
          f"configs {res['configs_explored']}, adapt "
          f"{u.get('adapt', {}).get('path')}, peak memory {peak} B")
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

    # an invalid history: device False == oracle False
    bad = synth.cas_register_history(INVALID["n_ops"],
                                     n_procs=INVALID["n_procs"],
                                     seed=INVALID["seed"],
                                     lie_p=INVALID["lie_p"])
    t0 = time.monotonic()
    want = wgl_ref.check(cas_register(), bad, time_limit=30)
    t_oracle = time.monotonic() - t0
    t0 = time.monotonic()
    got = checker.linearizable(cas_register(),
                               algorithm="cuda-wgl").check({}, bad, {})
    t_dev = time.monotonic() - t0
    print(f"invalid history {INVALID}: oracle {want['valid?']} "
          f"({t_oracle:.2f} s), device {got['valid?']} ({t_dev:.2f} s, "
          f"{got.get('configs_explored')} configs, "
          f"{got.get('util', {}).get('rounds')} rounds)")
    if want["valid?"] is not False or got["valid?"] is not False:
        raise AssertionError("invalid history not decided False by both")

    # the wide main path: the 16-wave, which only exhausting ~2.08M
    # configs decides
    res, wall, wcounts, wdev_ms, wpeak = drive(lin, wave)
    wlaunches = wcounts["wgln_chunk"]
    u = res["util"]
    total = res.get("configs_explored") or 0
    slack = max(64, int(WAVE_CONFIGS * 1e-3))
    print(f"main path, wide {WAVE}: valid? {res['valid?']} wall {wall:.4f} "
          f"s (search {res['wall_s']} s, the rest the oracle's "
          f"diagnostics), rounds {u['rounds']}, chunks {u['chunks']}, "
          f"launches {wcounts}, kernel {wdev_ms['wgln_chunk']:.3f} ms = "
          f"{wdev_ms['wgln_chunk'] * 1e3 / u['rounds']:.2f} us/round, "
          f"configs {total} (JAX package: {WAVE_CONFIGS}, slack {slack}), "
          f"memo hit rate {u['memo_hit_rate']}, backlog peak "
          f"{u['backlog_peak']}, adapt {u.get('adapt', {}).get('path')}, "
          f"peak memory {wpeak} B")
    if (res["valid?"] is not False or wlaunches < 1
            or abs(total - WAVE_CONFIGS) > slack):
        raise AssertionError(f"16-wave: {res['valid?']}, {wlaunches} "
                             f"launches, {total} configs")

    # ---- 5. the default checker (competition) -------------------------------
    res, wall, counts, _, _ = drive(checker.linearizable(cas_register()),
                                    tail)
    print(f"default checker, long tail {LONG_TAIL} (window "
          f"{tenc.window_raw}): valid? {res['valid?']} engine "
          f"{res.get('engine')} wall {wall:.4f} s, launches {counts}")
    if res["valid?"] is not True or res.get("algorithm") != "competition":
        raise AssertionError(f"long tail: {res}")
    fifo = synth.fifo_queue_history(FIFO["n_ops"], n_procs=FIFO["n_procs"],
                                    seed=FIFO["seed"])
    res, wall, counts, _, _ = drive(checker.linearizable(fifo_queue()),
                                    fifo)
    print(f"default checker, fifo queue {FIFO}: valid? {res['valid?']} "
          f"engine {res.get('engine')} wall {wall:.4f} s, launches {counts}")
    if res["valid?"] is not True or res.get("engine") != "queue-poly":
        raise AssertionError(f"fifo queue: {res}")

    print("card:", card_line())
    print(json.dumps({"kernels": [{
        "name": "wgl32_chunk", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/wgl32_chunk.cu",
        "replaces": "jepsen_tpu/ops/wgl32.py:725",
        "launches": launches, "max_abs_err": worst_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "wgln_chunk", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/wgln_chunk.cu",
        "replaces": "jepsen_tpu/ops/wgln.py:322",
        "launches": wlaunches, "max_abs_err": wide_err,
        "ms": wkernel_ms, "plain_ms": wplain_ms, "bound_ms": wbound_ms,
        "bound_by": "bytes", "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
