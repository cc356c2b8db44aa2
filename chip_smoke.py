#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`jepsen_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel from `jepsen_tpu_torch/csrc/`, holds each
kernel bit for bit against its plain PyTorch version on the card at the
shapes the main paths give it, times both, and drives the main paths,
each with every launch counter set to 0 just before and read just
after:

  * narrow windows: the 10k-op cas-register headline through
    `checker.linearizable(..., algorithm="cuda-wgl")` (`wgl32_chunk`),
    the same check with the telemetry and device planes (`metrics`,
    `watchdog`, `devices`) off and on in turns, its measured peak beside
    its `Peaks` row, one profiled check (a `torch.profiler` trace under
    build/), then the first check of a fresh process, and an invalid
    history against the host oracle;
  * wide windows: the 16-wave adversarial history (window 71, ~2.08M
    configs to exhaust) through the same checker (`wgln_chunk`).

Before those main paths, the WGL chunk's launch forms
(`csrc/wgl_common.cuh`: one CTA with the round in shared or device
memory, and the solo wide search's grid form) run against each other at
the same shapes in turns, every pair bit-identical: one CTA against the
grid on the 16-wave at K 16 to 2048 and on the long tail at K 1 to 256
(the crossover `wgln.solo_form` takes, at two widths), shared against
global scratch on the headline at
K 2 and 64; two grid chunks run on two streams of the card at once.
Every WGL launch prints the form it took.

Then the default checker (`algorithm="competition"`) decides a 900-op
long tail (window 657) and a 100k-op FIFO-queue history (queue-poly),
and the frontier migration of a ladder switch is timed. Then the
per-key fan-out:

  * narrow lanes (`wgl32_chunk_batched`): one tuple-valued history of
    100 keys x 2000-op cas-register through
    `independent.cuda_checker(cas_register())` (every key True; its
    first poll's shared form against global scratch, in turns), and a
    variant with four keys made invalid (failing keys == the host
    oracle's, the oracle run per key in a process pool);
  * wide lanes (`wgln_chunk_batched`): 8 adversarial-wave keys (window
    37) through `parallel.check_batched(strategy="vmap")`, every key
    False after the JAX package's config count;
  * stream: 3 keys through `check_batched`'s "auto" (fewer than 4 keys
    stream on the card, through `wgl32_chunk`, each racing the host
    oracle; each engine's end is timed per key), the same keys without
    the race, and in the shared shape bucket against their own plans.

Then the several-devices paths, every shard on this one card (the
device list `[card] * n`; each shard launches on its own stream):

  * the mesh lane scheduler's kernels against their plain versions
    (and a mesh poll's shared form against global scratch, in turns):
    `wgl_lane_reset` on a 100-lane narrow carry, the mesh fan-out's
    4-lane shard and an 8-lane wide one (device-only, as a call and its
    host path, beside `torch.where`), `wgl_frontier_migrate` up and
    down one ladder step (timed as a call and device-only, beside
    `F.pad` or a slice);
  * the 100 x 2k history, valid and invalid, through
    `independent.cuda_checker(cas_register(), devices=[card] * 2)`: the
    mesh scheduler, 2 shards x 4 lane slots refilled from the shards'
    queues (`wgl32_chunk_batched` per shard per poll, `wgl_lane_reset`
    for the refilled lanes, `wgl_frontier_migrate` at a ladder switch);
    every key's verdict equals the vmap path's, the failures the host
    oracle's;
  * 8 wave keys (4 valid, 4 invalid) through `parallel.mesh.check_mesh`
    with `assign="block"`, 2 shards x 2 slots, so that the idle pull
    moves a key (`wgln_chunk_batched`);
  * the 3 stream keys over `devices=[card] * 2` (one worker a shard).

Then Elle:

  * the dense closure (`elle_closure`): 3k-txn list-append and
    rw-register histories through `elle.append.check` /
    `elle.wr.check` with `cycle_backend="auto"` (bf16 at n_pad 4096),
    against the host oracle, plus two invalid histories; one squaring
    timed device-only and as a call at n_pad 4096 (the 3k main path's
    seed) and at 8320 (the dense route's largest, a random seed at the
    10k graph's density) beside the `torch.bmm` yardstick, both held
    bit for bit against the plain f32 squaring;
  * the packed closure (`elle_packed_closure`): a 10k-txn list-append
    history through the same call (n_pad 16384), then every squaring
    of its closure held against `packed_closure_ref`; the tensor
    cores' 1-bit and int8 rates (`elle_bitmm_rate`), each squaring's
    time beside its bound (the flagged tiles' tensor-core work at the
    measured 1-bit rate, the bytes) and, at the first and the last
    squaring, the kernel device-only beside the yardstick
    (`torch._int_mm` per subset and bf16 `torch.bmm` on the unpacked
    0/1 planes);
  * the trim (`elle_trim`): the 3k list-append and rw-register
    histories and the 10k list-append history with
    `cycle_backend="trim"`, each held against `trim_ref`, in µs a peel
    beside the chain's floor (the peels times one measured
    barrier-and-reduce step, `elle_trim_step_probe`);
  * the sharded closure (`elle_sharded_square`): every squaring of the
    10k closure with 1, 2 and 4 shards against `packed_square_ref`'s
    column blocks, the first at 2 shards timed beside its yardstick, then
    the 10k history with `cycle_backend="sharded"` over 2 and 4 shards
    of the card, bit-identical to the packed closure and equal to the
    host oracle's verdict (run in a background process from the start).

Then the bool-window WGL chunk (`wgl_chunk`, the reference's general
search, reached through `ops/wgl._compiled_search` as in the
reference): held bit for bit on every carry leaf against its plain
version at the headline's consts (K 64), the 16-wave's (K 256, W 96)
and with a full memo table and an overflowing backlog; its two
switchable forms (the one-warp round, the shared claim map) each timed
against a build without it on the same inputs, in turns, carries
identical; then driven to a verdict on the headline (True) and the
invalid narrow history (the host oracle's False) at `derive_plan`'s
first bucket.

Then the admission plane (`analysis/preflight.py`): for every main-path
shape above, the plan's predicted bytes against the peak the check
allocated on the card over what was allocated before it (each
main-path run reads `max_memory_allocated` after resetting it); a
rejection under a small `JEPSEN_TPU_PREFLIGHT_MEM_BUDGET` that launches
no kernel and allocates nothing; a 100k-txn forced bf16 closure
rejected (P002); and the parity block of `python -m jepsen_tpu_torch
preflight --headline --execute`, run in this process.

Then the warm plane (`ops/aot.py`, `analysis/guards.CompileGuard`):
fresh processes' first checks, cold, bound and warmed, in turns, and
`python -m jepsen_tpu_torch.bench`. Then the checker service
(`service.Service` behind `web.serve`, over `[card] * 2`): the headline
POSTed over HTTP and followed on its SSE stream, a warm same-bucket
request under `CompileGuard(max_compiles=0)`, a held batch of 4 served
as one mesh lane group, an Elle append 3k request, a preflight
rejection that launches nothing, a fresh process that answers warm after
`rewarm`, and the admission-to-verdict walls. Then the analysis path
(`analyze_phases`): the headline and an invalid history stored through
`store.Writer` in a temporary store and re-checked by `python -m
jepsen_tpu_torch analyze` in two fresh processes at once (exit 0 and 1,
each process's `kind="checker"` ledger record, `linear.svg` against the
render of the host oracle's analysis), and `core.analyze` of
`compose({indep: independent.cuda_checker over [card] * 2, stats,
exceptions})` over the invalid 100 x 2k fan-out (failures == the host
oracle's, one `kind="independent"` record, every key's results.json).

It prints as its last lines the card, one JSON line of per-kernel
numbers and
`{"ok": true, "device": {...}}`. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a card,
or a directory without the package.

    python3 chip_smoke.py --paths DIR

drives only the lane reset at its three shapes (device-only and as a
call), the headline, the 16-wave's search, the mesh fan-out (its reset
launches summed), the bool-window headline and the forced trim at Elle
append 3k and 10k through the package under DIR (this checkout, or an
older one unpacked beside it with `git archive`) and prints one JSON
line of verdicts,
walls, kernel times, µs a round and µs a peel: run it on both trees in
turns in one call to time a change against its parent.
"""

import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

HEADLINE = dict(n_ops=10000, n_procs=5, seed=42, crash_p=0.002)
INVALID = dict(n_ops=2000, n_procs=5, seed=9, lie_p=0.004)
SMALL = dict(W=24, ic=16, H=1 << 12, B=64, chunk=64, chunks=3)
WAVE = dict(n_waves=16, width=14, span=5, seed=7)
WAVE_CONFIGS = 2_084_641      # the JAX package's exhaustive count
LONG_TAIL = dict(n_quick=900, seed=7)
FIFO = dict(n_ops=100_000, n_procs=4, seed=7)
ELLE_3K = dict(n_txns=3000, n_procs=5, seed=7)
ELLE_10K = dict(n_txns=10000, n_procs=5, seed=7)
ELLE_STALE = dict(n_txns=3000, seed=7, stale_p=0.01)
ELLE_CORRUPT = dict(n_txns=3000, seed=7, corrupt_p=0.01)
ELLE_SMALL = dict(n_txns=300, seed=5)
FANOUT = dict(n_keys=100, n_ops=2000, n_procs=5, crash_p=0.002)
FANOUT_BAD = dict(keys=(7, 31, 58, 90), lie_p=0.01)
FANOUT_SHORT = 32           # rounds of the all-lanes kernel/plain check
FANOUT_FULL_LANES = 1       # lanes of the full-chunk kernel/plain check
HEADLINE_K512_ROUNDS = 1024   # rounds of the K=512 kernel/plain check
FANOUT_WAVE = dict(n_keys=8, n_waves=6, width=12, span=3, chunk=64)
# the JAX package's per-key exhaustive counts for the 8 wave keys
# (`check_batched(strategy="vmap", chunk=64)` on a one-device CPU mesh,
# K 1024, W 64)
FANOUT_WAVE_CONFIGS = [176023, 176019, 175945, 175939, 176025, 175943,
                       176012, 176061]
FANOUT_STREAM_KEYS = 3
MESH_SHARDS = 2               # shards of the mesh fan-out, all on the card
# wave keys through check_mesh: seeds < 4 valid, the rest invalid
MESH_WAVE = dict(n_keys=8, n_valid=4, lanes_per_device=2)
ELLE_SHARDS = (2, 4)          # shards of the sharded Elle main path
SHARD_CHECK = (1, 2, 4)       # shard counts of the sharded-square check
# wgl_chunk against its plain version: (consts, K, H, B, rounds); None
# takes derive_plan's first bucket. The first two are the main path's
# first launch on the headline and on the invalid history (K 2, its H, B
# and chunk); the last one fills a 1024-slot table and overflows a
# 256-row backlog.
BOOL_CHECKS = (("headline", None, None, None, None),
               ("invalid", None, None, None, None),
               ("headline", 64, None, None, 32),
               ("16-wave", 256, None, None, 16),
               ("16-wave", 64, 1024, 256, 24))
# wgl_chunk's forms a build can switch off, each timed against the
# default build in turns on BOOL_CHECKS rows: {label: (define, rows)}.
# The one-warp round stands in for the block's sort, dedup, probe and
# compaction at <= 32 explorers (the headline's first launch, K 2); the
# shared claim map for the claims through the slot's own word (K 64, the
# 16-wave's K 256 and the full table)
CHUNK_FORMS = {"one-warp round off": ("WGL_CHUNK_WARP_ROUND=0", (0,)),
               "claim map off": ("WGL_CHUNK_CLAIM_MAP=0", (2, 3, 4))}
# the lane reset's shapes (name, lanes, K, C, H, B, model-state column,
# the ladder step the migration takes from K): 100 narrow lanes at the
# vmap fan-out's capacities, the mesh fan-out's own 4-lane shard at its
# first bucket, 8 wide lanes at the waves' capacities
RESET_SHAPES = (("narrow 100 lanes", 100, 64, 4, 1 << 19, 1 << 14, 2, 16),
                ("narrow shard of the mesh fan-out", 4, 16, 4, 1 << 19,
                 1 << 14, 2, 64),
                ("wide 8 lanes", 8, 1024, 5, 1 << 19, 1 << 16, 3, 512))
SMALL_BUDGET = 1_000_000      # bytes: a budget every main path blows
RT = ("realtime",)
REPO = Path(__file__).resolve().parent

# the main run's verdicts the warm phases' fresh processes must repeat,
# and the mesh fan-out's shared shape bucket (with its key count)
MAIN_VERDICTS: dict = {}
MAIN_BUCKETS: dict = {}
# the invalid fan-out history, which the analysis phase re-checks
MAIN_HISTORIES: dict = {}

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


# a fresh process's first checks, warmed or not (`warm_phases`): argv[1]
# is the mode ("cold": nothing warmed; "bind": the headline's entry
# point bound, nothing launched; "warm": the warm plane first), argv[2]
# the paths ("headline", "mesh", "elle"), comma-separated; the CUDA
# context is made first and timed apart; every first check runs inside
# a CompileGuard (budget 0 when warmed). Prints one JSON line.
WARM = """
import json, os, sys, time, torch
sys.path.insert(0, %(repo)r)
import chip_smoke as cs
from jepsen_tpu_torch import checker, fs_cache, independent, service, synth
from jepsen_tpu_torch.analysis import guards
from jepsen_tpu_torch.elle import append, build, tpu as etpu
from jepsen_tpu_torch.history import strip_nemesis
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import _native, aot, encode
from jepsen_tpu_torch.parallel import batched, mesh
fs_cache.DIR = %(cache)r
mode, paths = sys.argv[1], sys.argv[2].split(",")
out = {"mode": mode}
t0 = time.monotonic()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
out["context_s"] = time.monotonic() - t0
out["module_loading"] = os.environ.get("CUDA_MODULE_LOADING")
dev = torch.device("cuda", 0)

def first(name, check, precompile):
    rec = {}
    if mode == "warm":
        t0 = time.monotonic()
        rec["warm"] = precompile()
        torch.cuda.synchronize()
        rec["warm_s"] = time.monotonic() - t0
    g = guards.CompileGuard(max_compiles=0 if mode == "warm" else None,
                            name=name + "-" + mode)
    with g:
        t0 = time.monotonic()
        res = check()
        torch.cuda.synchronize()
        rec["wall_s"] = time.monotonic() - t0
    rec["guard"] = g.report()
    rec["transfers"] = g.transfers
    out[name] = rec
    return rec, res

if "headline" in paths:
    h = synth.cas_register_history(**cs.HEADLINE)
    enc = encode.encode(cas_register(), h)
    if mode == "bind":
        _native._lib("wgl32_chunk")
    lin = checker.linearizable(cas_register(), algorithm="cuda-wgl")
    rec, res = first("headline", lambda: lin.check({}, h, {}),
                     lambda: aot.precompile_service_bucket(
                         service.bucket_for(enc)[1]))
    rec.update(valid=res["valid?"], chunks=res["util"]["chunks"],
               first_call_s=res["util"]["first_call_s"],
               bucket=service.bucket_for(enc)[1])
if "mesh" in paths:
    fan = cs.multikey_history(**cs.FANOUT)
    ks = independent.history_keys(fan)
    subs = [strip_nemesis(x) for x in independent.subhistories(fan, ks)]
    encs = [encode.encode(cas_register(), x) for x in subs]
    cards = [dev] * cs.MESH_SHARDS
    rec, res = first("mesh", lambda: mesh.check_mesh(
        cas_register(), subs, encs=encs, devices=cards),
        lambda: aot.precompile_mesh_plan(
            batched.shared_shape_bucket(encs), cards, n_keys=len(encs),
            model_name="cas-register"))
    summ = mesh.last_summary()
    rec.update(verdicts={str(k): r["valid?"] for k, r in zip(ks, res)},
               pool_hit=[g["pool_hit"] for g in summ["groups"]],
               polls=summ["polls"])
    mesh.pool_settle()
    rec["pool_bytes"] = sum(t.numel() * t.element_size()
                            for e in mesh._CARRY_POOL.values()
                            for carry, _ in e for t in carry)
if "elle" in paths:
    hists = {"elle append 3k": synth.list_append_history(**cs.ELLE_3K),
             "elle append 10k": synth.list_append_history(**cs.ELLE_10K)}
    buckets = {k: etpu.shape_bucket_for(build.build_append(
        x, *cs.split_txns(x), additional_graphs=cs.RT).tensors)
        for k, x in hists.items()} if mode == "warm" else {}
    for name, x in hists.items():
        rec, res = first(name, lambda: append.check(
            x, additional_graphs=cs.RT),
            lambda: aot.precompile_elle_closure(buckets[name]))
        rec.update(valid=res["valid?"], types=res["anomaly-types"],
                   kernel=(res.get("cycle-util") or {}).get("kernel"))
print(json.dumps(out))
"""

# a fresh process's service over the same plan registry (`service_phases`
# step 7): argv[1] the fs_cache root, argv[2] the store root, argv[3] the
# POST body's JSON file; `rewarm=True`, then one POST under a
# CompileGuard of budget 0. Prints one JSON line.
SERVICE_FRESH = """
import json, sys, time, torch, urllib.request
from jepsen_tpu_torch import fs_cache, service, web
from jepsen_tpu_torch.analysis import guards
fs_cache.DIR = sys.argv[1]
dev = torch.device("cuda", 0)
t0 = time.monotonic()
torch.zeros(1, device=dev)
torch.cuda.synchronize()
out = {"context_s": time.monotonic() - t0}
t0 = time.monotonic()
svc = service.Service(sys.argv[2], devices=[dev] * 2, workers=1,
                      rewarm=True, slo_every_s=3600.0)
out["rewarm_s"] = time.monotonic() - t0
out["rewarmed"] = sorted(service._key_str(k) for k in svc._warm)
server = web.serve(host="127.0.0.1", port=0, store_root=sys.argv[2],
                   service=svc)
import threading
th = threading.Thread(target=server.serve_forever, daemon=True)
th.start()
base = "http://127.0.0.1:%d" % server.server_port
body = open(sys.argv[3], "rb").read()
g = guards.CompileGuard(max_compiles=0, name="service-fresh")
with g:
    t0 = time.monotonic()
    req = urllib.request.Request(base + "/check", data=body,
                                 headers={"Content-Type": "application/json"})
    rid = json.loads(urllib.request.urlopen(req, timeout=60).read())["id"]
    urllib.request.urlopen(base + "/runs/%s/events?wait=120" % rid,
                           timeout=180).read()
    out["wall_s"] = time.monotonic() - t0
info = svc.get(rid)
out.update(guard=g.report(), verdict=info["verdict"],
           warm_hit=info["warm_hit"], cause=info.get("cause"),
           request_wall_s=info["wall_s"], phases=info["phases"])
server.shutdown()
server.server_close()
svc.close()
print(json.dumps(out))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def card_peak(name: str) -> float:
    """The card's peak `name` (a key of `jepsen_tpu_torch.occupancy.
    PEAKS`), by the card's name."""
    from jepsen_tpu_torch import occupancy
    return occupancy.peaks(torch.cuda.get_device_name(0))[0][name]


class GateLog:
    """The admission reports the port's own gates made inside the block,
    read from preflight's recent window (`preflight.snapshot`)."""

    def __enter__(self):
        from jepsen_tpu_torch.analysis import preflight
        self.n0 = preflight.snapshot()["checked"]
        self.reports: list = []
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.analysis import preflight
        snap = preflight.snapshot()
        self.new = snap["checked"] - self.n0
        self.reports = snap["recent"][-self.new:] if self.new else []
        return False


class Peaks:
    """Each main path's predicted bytes beside the peak it allocated on
    the card over its baseline, by shape. The prediction is the bill of
    the one admission report the path's own gate made while it ran
    (`GateLog`), so a gate that under-bills fails the run; `also` is a
    plan printed beside it (the Elle plan at the built graph's own edge
    counts, where the gate estimated them)."""
    rows: list = []

    @classmethod
    def add(cls, shape: str, gates: GateLog, measured: int,
            also: dict = None) -> None:
        if gates.new != 1 or len(gates.reports) != 1:
            raise AssertionError(f"preflight {shape}: {gates.new} gate "
                                 f"reports, want 1: {gates.reports}")
        rep = gates.reports[0]
        predicted = int(rep["hbm_peak_bytes"])
        cls.rows.append((shape, rep["verdict"], predicted, int(measured)))
        extra = (f"; at the built graph's edge counts "
                 f"{also['hbm']['peak_bytes']} B" if also else "")
        print(f"  preflight {shape} (gate {rep['where']}): verdict "
              f"{rep['verdict']}, predicted {predicted} B, measured peak "
              f"{measured} B (ratio {predicted / max(measured, 1):.4f})"
              f"{extra}", flush=True)


def counters() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from jepsen_tpu_torch.elle import tpu as etpu
    from jepsen_tpu_torch.ops import wgl32, wgl_bool, wgln
    from jepsen_tpu_torch.parallel import mesh
    return {"wgl32_chunk": wgl32.chunk, "wgln_chunk": wgln.chunk,
            "wgl_chunk": wgl_bool.chunk,
            "wgl32_chunk_batched": wgl32.chunk_batched,
            "wgln_chunk_batched": wgln.chunk_batched,
            "elle_closure": etpu.closure,
            "elle_packed_closure": etpu.packed_closure,
            "elle_trim": etpu.trim,
            "wgl_lane_reset": mesh.reset_lanes,
            "wgl_frontier_migrate": mesh.migrate_lanes,
            "elle_sharded_square": etpu.sharded_square}


def zero_counts() -> None:
    for w in counters().values():
        w.launches = 0


def read_counts() -> dict:
    return {k: w.launches for k, w in counters().items()}


# the WGL chunk entry points, whose ints end with their launch form
CHUNK_KERNELS = ("wgl32_chunk", "wgln_chunk", "wgl32_chunk_batched",
                 "wgln_chunk_batched")


def form_label(form) -> str:
    """The text of an `ops/wgl32.py::Form`."""
    if form.name == "grid":
        return f"grid (<= {form.blocks} blocks of {form.threads})"
    if form.name == "shared":
        return f"shared ({form.threads} threads, {form.smem} B)"
    return f"global ({form.threads} threads)"


def launch_form(name, ints):
    """The text of the form a launch of `name` took, read from its ints
    by `wgl32.form_of`; None for another kernel, or under `--paths` for
    a tree whose launches have no form."""
    from jepsen_tpu_torch.ops import wgl32
    if name not in getattr(wgl32, "FORM_FIELDS", ()):
        return None
    return form_label(wgl32.form_of(name, ints))


class Timed:
    """CUDA events around every kernel launch made inside the block,
    by C entry point (a `_native.KERNELS` name), and the form each WGL
    chunk launch took."""

    def __enter__(self):
        from jepsen_tpu_torch.ops import _native
        self.native, self.launch, self.events = _native, _native.launch, []
        self.forms: list = []

        def timed(name, *a):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            self.launch(name, *a)
            e1.record()
            self.events.append((name, e0, e1))
            form = launch_form(name, a[1])
            if form is not None:
                self.forms.append((name, form))

        _native.launch = timed
        return self

    def __exit__(self, *exc):
        self.native.launch = self.launch

    def ms(self, name) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for n, a, b in self.events if n == name]

    def form_counts(self, name) -> dict:
        """{form: launches} of kernel `name` inside the block."""
        out: dict = {}
        for n, f in self.forms:
            if n == name:
                out[f] = out.get(f, 0) + 1
        return out


def event_ms(fn, reps: int = 3) -> float:
    """Median device time of `fn()` over `reps` calls, after one warm
    call, with CUDA events around each."""
    fn()
    times = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def device_ms(fn, reps: int = 20, spin_cycles: int = 4_000_000) -> float:
    """Median device time of `fn()` over `reps` calls, after one warm
    call: each call is queued behind a spin kernel (`torch.cuda._sleep`,
    ~2 ms) so that the events around it bracket the device's work only,
    not the host's time to enqueue it. `fn` must not synchronise."""
    fn()
    times = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(spin_cycles)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def host_ms(fn, reps: int = 300, spin_cycles: int = 200_000_000) -> float:
    """Host milliseconds a call of `fn` takes while the card is busy (a
    spin kernel, `torch.cuda._sleep`, ahead of the calls, so that each
    launch only queues): the call's host path, after one warm call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def kernel_split(fn, reps: int = 5) -> dict:
    """Device microseconds a call of `fn` spends in each kernel (and
    memset), by name, from `torch.profiler` over `reps` calls after a
    warm one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]
            .strip()[:48]: round(e.device_time_total / reps, 1)
            for e in prof.key_averages() if e.device_time_total > 0}


def square_timing(r16, plain=None) -> dict:
    """One dense squaring of the bf16 reach `r16` on the card: the kernel
    (`elle.tpu.dense_square`) and the yardstick (`torch.bmm` in bf16,
    `> 0`, the count), each held bit for bit, outputs and counts, against
    `dense_square_ref` in f32, each timed device-only and as a call
    (median of 20), beside the bound (operations at the bf16 peak).
    `plain` also times `dense_square_ref` (call time)."""
    from jepsen_tpu_torch import occupancy
    from jepsen_tpu_torch.elle import tpu as etpu

    S, n = r16.shape[0], r16.shape[-1]
    r32 = r16.float()
    want_cnt = torch.zeros(S, dtype=torch.int32, device=r16.device)
    want = etpu.dense_square_ref(r32, want_cnt)
    cnt = torch.zeros(S, dtype=torch.int32, device=r16.device)
    got = etpu.dense_square(r16, cnt)
    lib = torch.bmm(r16, r16) > 0
    lib_cnt = lib.sum(dim=(1, 2), dtype=torch.int32)
    torch.cuda.synchronize()
    err = max(int((got.float() - want).abs().max()),
              int((lib.float() - want).abs().max()),
              max_abs_err([cnt, lib_cnt], [want_cnt, want_cnt]))
    if err:
        raise AssertionError(f"dense squaring at n_pad {n}: kernel or "
                             f"yardstick differ from dense_square_ref "
                             f"({err})")
    del want, got, lib
    out = {"n_pad": n, "err": err, "ones_out": int(want_cnt.sum())}
    c = torch.zeros(S, dtype=torch.int32, device=r16.device)

    def kernel():
        return etpu.dense_square(r16, c)

    def yardstick():
        return (torch.bmm(r16, r16) > 0).sum(dim=(1, 2), dtype=torch.int32)

    # in turns: kernel, yardstick, yardstick, kernel
    k1, l1 = device_ms(kernel), device_ms(yardstick)
    l2, k2 = device_ms(yardstick), device_ms(kernel)
    out.update(ms=float(np.median([k1, k2])),
               library_ms=float(np.median([l1, l2])),
               call_ms=event_ms(kernel, reps=20),
               library_call_ms=event_ms(yardstick, reps=20))
    if plain:
        out["plain_ms"] = event_ms(lambda: etpu.dense_square_ref(
            r32, want_cnt), reps=plain)
    dc = occupancy.dense_square_cost(S, n)
    ops = dc["flops"] / card_peak("bf16_flops")
    nbytes = dc["bytes_accessed"] / card_peak("hbm_bytes_per_s")
    out.update(bound_ms=max(ops, nbytes) * 1e3,
               bound_by="operations" if ops > nbytes else "bytes")
    print(f"  dense squaring at n_pad {n}: kernel == dense_square_ref and "
          f"the yardstick == it (outputs and counts, max abs err 0); "
          f"device-only kernel {k1:.4f} / {k2:.4f} ms, torch.bmm bf16 + "
          f"(> 0) + count {l1:.4f} / {l2:.4f} ms; as calls (host path "
          f"included) {out['call_ms']:.4f} / {out['library_call_ms']:.4f} "
          f"ms; bound {out['bound_ms']:.4f} ms ({out['bound_by']}: "
          f"{dc['flops']:.4e} flops at the bf16 peak); "
          f"{dc['flops'] / out['ms'] / 1e9:.1f} TFLOP/s", flush=True)
    del r32
    return out


# the launch forms timed against each other (csrc/wgl_common.cuh): the
# 16-wave's buckets (L 3) and the long tail's (L 21) for the solo wide
# crossover (one CTA against the grid), the headline's for global
# against shared scratch; rounds of each timed chunk
FORM_WAVE_K = (16, 24, 32, 40, 48, 64, 128, 256, 2048)
FORM_TAIL_K = (1, 2, 3, 4, 6, 8, 16, 256)
FORM_WAVE_ROUNDS = 64
FORM_NARROW = ((2, 1024), (64, 256))     # (K, rounds)


def form_turns(run, start, forms) -> tuple:
    """`run(carry, form)` (one launch, returns the summary) from clones
    of `start` in turns, the forms then the same reversed (a, b, b, a),
    CUDA events around each launch (the clone outside them); every
    output equals the first form's on every carry leaf and the summary.
    Returns ({form label: [ms, ms]}, rounds in the chunk, the first
    output (carry, summary))."""
    times: dict = {}
    first = None
    for f in list(forms) + list(reversed(forms)):
        c = tuple(t.clone() for t in start)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        summary = run(c, f)
        e1.record()
        torch.cuda.synchronize()
        times.setdefault(form_label(f), []).append(e0.elapsed_time(e1))
        if first is None:
            first = (c, summary)
        elif not (same_carry(c, first[0]) and torch.equal(summary, first[1])):
            raise AssertionError(f"form {form_label(f)} differs from "
                                 f"{form_label(forms[0])}")
    return times, int(first[1][..., 5].max()), first


def form_phases(dev, wconsts, wkw, wave_starts, hconsts, hkw, hstart,
                tconsts, tkw) -> None:
    """The launch forms against each other at the same shapes, in turns,
    every pair bit-identical: one CTA against the grid on the 16-wave at
    FORM_WAVE_K and on the long tail at FORM_TAIL_K (the solo wide
    crossover at two widths, `wgln.solo_form`'s rule); global against
    shared scratch (and the
    old 1024-thread block) on the headline at FORM_NARROW. Then two
    16-wave-shaped grid chunks (K 2048) on two streams of the card at
    once, each bit-identical to the chunk run alone."""
    from jepsen_tpu_torch.ops import wgl32, wgln

    print("launch forms, in turns (a, b, b, a), each pair bit-identical:",
          flush=True)

    def wide_run(consts, p, K, rounds):
        return lambda c, f: wgl32.launch(
            "wgln_chunk", consts, c, K=K, W=32 * p["L"], L=p["L"],
            ic=p["ic"], H=p["H"], B=p["B"], rounds=rounds,
            probes=p["probes"], form=f)

    def wide_forms(K, L, ic):
        W = 32 * L
        R = K * (W + ic)
        one = wgl32.block_form(K, W, ic, wgln.row_words(L, ic))
        return R, [one, wgl32.Form("grid", wgl32.MAX_THREADS, -(-R // 1024))]

    def us(ms, rounds):
        return float(np.mean(ms)) * 1e3 / max(rounds, 1)

    def crossover(what, consts, p, Ks, starts):
        """One CTA against the grid at each K of Ks on `consts`; returns
        {K: (start, grid form, first output, grid ms, rounds)}."""
        L, ic = p["L"], p["ic"]
        C = wgln.row_words(L, ic)
        rows, runs = [], {}
        for K in Ks:
            start = starts.get(K) or wgln.init_carry(K, L, ic, p["H"],
                                                     p["B"], 0, dev)
            R, forms = wide_forms(K, L, ic)
            times, rounds, first = form_turns(
                wide_run(consts, p, K, FORM_WAVE_ROUNDS), start, forms)
            one, grid = (times[form_label(f)] for f in forms)
            rows.append((R, us(one, rounds), us(grid, rounds)))
            print(f"  {what} K={K} (L {L}, C {C}, R {R}, R C {R * C}, "
                  f"{rounds} rounds): {form_label(forms[0])} "
                  f"{[round(x, 4) for x in one]} ms = {us(one, rounds):.2f} "
                  f"us/round; {form_label(forms[1])} "
                  f"{[round(x, 4) for x in grid]} ms = {us(grid, rounds):.2f}"
                  f" us/round; the rule takes "
                  f"{form_label(wgln.solo_form(K, L, ic))}", flush=True)
            runs[K] = (start, forms[1], first, float(np.mean(grid)), rounds)
        wins = [R for R, one, grid in rows if grid < one]
        loses = [R for R, one, grid in rows if grid >= one]
        print(f"  {what} crossover (L {L}): the grid wins at R {wins}, one "
              f"CTA at R {loses}; GRID_MIN_ROWS = {wgln.GRID_MIN_ROWS}",
              flush=True)
        return runs

    alone = crossover("16-wave", wconsts, wkw, FORM_WAVE_K,
                      wave_starts)[2048]
    crossover("long tail", tconsts, tkw, FORM_TAIL_K, {})

    C = wgl32.row_words(hkw["ic"])
    for K, rounds_k in FORM_NARROW:
        start = hstart if K == hstart[0].shape[0] else wgl32.init_carry(
            K, C, hkw["H"], hkw["B"], 0, dev)
        shared = wgl32.block_form(K, hkw["W"], hkw["ic"], C)
        forms = [shared, wgl32.Form("global", shared.threads),
                 wgl32.Form("global", wgl32.MAX_THREADS)]
        times, rounds, _ = form_turns(
            lambda c, f: wgl32.launch(
                "wgl32_chunk", hconsts, c, K=K, W=hkw["W"], L=1,
                ic=hkw["ic"], H=hkw["H"], B=hkw["B"], rounds=rounds_k,
                probes=hkw["probes"], form=f), start, forms)
        print(f"  headline K={K} ({rounds} rounds): "
              + "; ".join(f"{k} {[round(x, 4) for x in v]} ms = "
                          f"{us(v, rounds):.2f} us/round"
                          for k, v in times.items()), flush=True)

    # two grid chunks on two streams of the card at once, twice (the
    # first pair also fills each stream's allocator cache); the second
    # pair's time from the host clock, the launches queued behind a spin
    # kernel on each stream so that both start together
    start, grid, (want, want_summary), ms_alone, rounds = alone
    run = wide_run(wconsts, wkw, 2048, FORM_WAVE_ROUNDS)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for turn in range(2):
        a, b = (tuple(t.clone() for t in start) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = []
        for carry, st in zip((a, b), streams):
            with torch.cuda.stream(st):
                torch.cuda._sleep(1_000_000)
                outs.append(run(carry, grid))
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
        for carry, summary in zip((a, b), outs):
            if not (same_carry(carry, want)
                    and torch.equal(summary, want_summary)):
                raise AssertionError("a grid chunk on two streams differs "
                                     "from the chunk run alone")
    print(f"  two 16-wave grid chunks (K 2048, {rounds} rounds each) on two "
          f"streams at once, twice: both identical to the chunk alone each "
          f"time; the second pair {wall_ms:.3f} ms (host clock, a ~0.5 ms "
          f"spin before each included), {ms_alone:.3f} ms alone (events)",
          flush=True)


def same_carry(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def max_abs_err(a, b) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0 for x, y in zip(a, b))


def outputs_err(got, ref) -> int:
    """Max abs difference of two (labels, closed, counts, iters_run) or
    (live, counts, bodies) results; the trailing int is compared too."""
    err = abs(int(got[-1]) - int(ref[-1]))
    for a, b in zip(got[:-1], ref[:-1]):
        if a.shape != b.shape:
            raise AssertionError(f"shapes {a.shape} != {b.shape}")
        if a.numel():
            err = max(err, int((a.to(torch.int64)
                                - b.to(torch.int64)).abs().max()))
    return err


def split_txns(h):
    """A txn history's ok and info txns, as the Elle checkers split it."""
    return ([op for op in h if op.is_ok and op.value],
            [op for op in h if op.is_info and op.value])


def elle_graphs() -> dict:
    """The small Elle corpora: random DepGraphs (n 1..300), an empty and
    a no-rw graph, a 300-node path (every squaring) and a 300-node
    generic chain (past the trim's 64 counts rows), and the JAX tests'
    300-txn synthetic histories, valid and with anomalies."""
    from jepsen_tpu_torch import synth
    from jepsen_tpu_torch.elle import build
    from jepsen_tpu_torch.elle import graph as eg

    rng = np.random.default_rng(3)
    types = [eg.WW, eg.WR, eg.RW, eg.REALTIME, eg.PROCESS]
    graphs = {}
    for n in (1, 2, 7, 40, 120, 200, 300):
        g = eg.DepGraph()
        for i in range(n):
            g.add_node(i)
        e = int(rng.integers(0, 4 * n + 1))
        for a, b, t in zip(rng.integers(0, n, e), rng.integers(0, n, e),
                           rng.choice(types, e)):
            g.add_edge(int(a), int(b), int(t))
        graphs[f"random-{n}"] = g
    graphs["empty"] = eg.DepGraph()
    g = eg.DepGraph()
    for i in range(60):
        g.add_edge(i, (i + 1) % 60, eg.WR if i % 2 else eg.WW)
    graphs["no-rw"] = g
    for name, n, back in (("path-300", 300, eg.RW), ("chain-300", 300, None)):
        g = eg.DepGraph()
        for i in range(n - 1):
            g.add_edge(i, i + 1, eg.WW)
        if back is not None:
            g.add_edge(n - 1, 0, back)
        graphs[name] = g

    for p in (0.0, 0.25):
        h = synth.list_append_history(ELLE_SMALL["n_txns"],
                                      seed=ELLE_SMALL["seed"], corrupt_p=p)
        graphs[f"append-{p}"] = build.build_append(
            h, *split_txns(h), additional_graphs=RT).tensors
    for p in (0.0, 0.2):
        h = synth.wr_register_history(ELLE_SMALL["n_txns"],
                                      seed=ELLE_SMALL["seed"], stale_p=p)
        graphs[f"wr-{p}"] = build.build_wr(
            h, *split_txns(h), linearizable_keys=True,
            additional_graphs=("realtime", "process")).tensors
    return graphs


def on_card(arrays, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def run_closures(g, dev, iters=None, snaps=None):
    """The dense and packed kernels and their plain versions on `g`'s
    inputs on the card: (dense kernel out, dense err, packed err,
    packed-vs-dense err, plain dense seconds, inputs). With `snaps` the
    kernel's reach after every squaring is kept and the plain run's
    compared with it."""
    from jepsen_tpu_torch.elle import tpu as etpu

    a = etpu.closure_inputs(g)
    kw = dict(n_pad=a["n_pad"], iters=iters or a["iters"])
    ins = on_card(a["args"], dev)
    keep, bad = [], []
    got = etpu.closure(*ins, **kw,
                       on_square=lambda i, r: keep.append(r.clone()))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ref = etpu.closure_ref(
        *ins, **kw, on_square=lambda i, r: bad.append(i) if not
        torch.equal(r > 0, keep[i] != 0) else None)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    err = outputs_err(got, ref) + len(bad)
    p = on_card(etpu.closure_inputs(g, packed=True)["args"], dev)
    pgot = etpu.packed_closure(*p, **kw)
    pref = etpu.packed_closure_ref(*p, **kw)
    return (got, err, outputs_err(pgot, pref), outputs_err(pgot, got),
            plain_s, ins, a)


def run_trim(g, dev):
    """The trim kernel and trim_ref on `g`'s inputs on the card:
    (kernel out, err, plain seconds, inputs dict)."""
    from jepsen_tpu_torch.elle import tpu as etpu

    t = etpu.trim_inputs(g)
    ins = on_card(t["arrays"], dev)
    kw = dict(p_pad=t["p_pad"], use_rt=t["use_rt"], use_proc=t["use_proc"])
    got = etpu.trim(*ins, **kw)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ref = etpu.trim_ref(*ins, **kw)
    torch.cuda.synchronize()
    return got, outputs_err(got, ref), time.monotonic() - t0, t


def trim_peel_us(t, dev, use_rt: bool) -> tuple:
    """The trim kernel's µs a peel on `t = trim_inputs(g)` with the
    realtime thresholds on or off (off: the same inputs reach another
    fixpoint): the median of 3 launches after a warm one, CUDA events
    around each launch (`Timed`), every one of the 4 launches held
    against `trim_ref` with the same thresholds: (µs a peel, peels)."""
    from jepsen_tpu_torch.elle import tpu as etpu

    ins = on_card(t["arrays"], dev)
    kw = dict(p_pad=t["p_pad"], use_rt=use_rt, use_proc=t["use_proc"])
    ref = etpu.trim_ref(*ins, **kw)
    got = [etpu.trim(*ins, **kw)]
    with Timed() as tm:
        got += [etpu.trim(*ins, **kw) for _ in range(3)]
    errs = [outputs_err(g, ref) for g in got]
    if any(errs):
        raise AssertionError(f"elle trim (realtime {use_rt}) differs from "
                             f"trim_ref: max abs err by launch {errs}")
    peels = 2 * got[0][2]
    return float(np.median(tm.ms("elle_trim"))) * 1e3 / peels, peels


def elle_drive(check, hist, **kw):
    """One Elle check on the card, every count at 0 just before it and
    read just after: (result, wall, counts, Timed). The Timed also holds
    `build_s`, the host time of the graph build inside the check, and
    `peak`, the bytes the check allocated on the card at its peak over
    its baseline, and `gates`, the admission report of the check's own
    gate (`GateLog`)."""
    from jepsen_tpu_torch.elle import build

    originals = {n: getattr(build, n) for n in ("build_append", "build_wr")}

    def timed_build(fn):
        def run(*a, **k):
            t0 = time.monotonic()
            try:
                return fn(*a, **k)
            finally:
                t.build_s += time.monotonic() - t0
        return run

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with Timed() as t:
        t.build_s = 0.0
        for n, fn in originals.items():
            setattr(build, n, timed_build(fn))
        try:
            zero_counts()
            t0 = time.monotonic()
            with GateLog() as t.gates:
                res = check(hist, additional_graphs=RT, **kw)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = read_counts()
            t.peak = torch.cuda.max_memory_allocated() - before
        finally:
            for n, fn in originals.items():
                setattr(build, n, fn)
    return res, wall, counts, t


def elle_plan(gt, backend, devices) -> dict:
    """The preflight plan of a cycle search over the built graph `gt`,
    with its own node, edge and rw-edge counts."""
    from jepsen_tpu_torch.analysis import preflight
    from jepsen_tpu_torch.elle.graph import RW

    edges = np.asarray(gt.edges)
    rw = int(np.sum(edges[:, 2] == RW)) if len(edges) else 0
    return preflight.plan_elle(n_txns=int(np.asarray(gt.nodes).shape[0]),
                               edges=int(len(edges)), rw_edges=rw,
                               backend=backend, devices=devices)


def cycles(res) -> dict:
    return {k: [c["cycle"] for c in v] for k, v in res["anomalies"].items()
            if k in ("G0", "G1c", "G-single", "G2")}


def same_verdict(what, got, want, cycles_too=False) -> None:
    for k in ("valid?", "anomaly-types"):
        if got[k] != want[k]:
            raise AssertionError(f"{what}: {k} {got[k]} != {want[k]}")
    if cycles_too and cycles(got) != cycles(want):
        raise AssertionError(f"{what}: cycles {cycles(got)} != "
                             f"{cycles(want)}")


def elle_host_verdict(params: dict) -> dict:
    """The host oracle's verdict on a list-append history (in a worker
    process): valid? and anomaly-types."""
    from jepsen_tpu_torch import synth
    from jepsen_tpu_torch.elle import append
    t0 = time.monotonic()
    res = append.check(synth.list_append_history(**params),
                       additional_graphs=RT, cycle_backend="host")
    return {"valid?": res["valid?"], "anomaly-types": res["anomaly-types"],
            "seconds": time.monotonic() - t0}


def elle_phases(dev, host10, step_us: float) -> list:
    """Elle on the card: the small corpora, the 3k cells (dense closure
    and trim), the invalid histories, the 10k cell (packed closure), and
    the sharded closure over shards of the card (its verdict against
    `host10`, the future of `elle_host_verdict(ELLE_10K)`). Returns the
    four kernels' entries of the kernels line."""
    from jepsen_tpu_torch import occupancy, synth
    from jepsen_tpu_torch.elle import append, build, wr
    from jepsen_tpu_torch.elle import tpu as etpu

    S = len(etpu.SUBSETS)
    int_ops_per_s = card_peak("int32_ops")
    hbm = card_peak("hbm_bytes_per_s")

    # ---- small corpora: every kernel == its plain version ---------------
    errs = {"elle_closure": 0, "elle_packed_closure": 0, "elle_trim": 0}
    for name, g in elle_graphs().items():
        _, err, perr, pderr, _, _, _ = run_closures(g, dev)
        _, terr, _, _ = run_trim(g, dev)
        errs["elle_closure"] = max(errs["elle_closure"], err)
        errs["elle_packed_closure"] = max(errs["elle_packed_closure"], perr,
                                          pderr)
        errs["elle_trim"] = max(errs["elle_trim"], terr)
        if err or perr or pderr or terr:
            raise AssertionError(f"elle corpus {name}: dense {err}, packed "
                                 f"{perr}, packed vs dense {pderr}, trim "
                                 f"{terr}")
    print("elle small corpora: closure, packed closure and trim == their "
          "plain versions on every output (max abs err 0); packed == dense")

    builders = {
        "append": (append.check, {}, lambda h: build.build_append(
            h, *split_txns(h), additional_graphs=RT).tensors),
        "wr": (wr.check, {"linearizable_keys": True},
               lambda h: build.build_wr(
                   h, *split_txns(h), linearizable_keys=True,
                   additional_graphs=RT).tensors)}

    # ---- the 3k cells: auto -> dense bf16; forced trim ----------------------
    out = {}
    for kind, hist in (("append", synth.list_append_history(**ELLE_3K)),
                       ("wr", synth.wr_register_history(**ELLE_3K))):
        check, kw, builder = builders[kind]
        res, wall, counts, t = elle_drive(check, hist, cycle_backend="auto",
                                          **kw)
        u = res.get("cycle-util") or {}
        sq, lab = t.ms("elle_closure_square"), t.ms("elle_closure_labels")
        print(f"elle {kind} 3k, auto: valid? {res['valid?']} engine "
              f"{res.get('cycle-engine')} kernel {u.get('kernel')} n_pad "
              f"{u.get('n_pad')} iters_run {u.get('iters_run')} of "
              f"{u.get('iters')}, launches {counts}, wall {wall:.4f} s "
              f"(kernel_s {u.get('kernel_s')}), squarings (ms) "
              f"{[round(x, 4) for x in sq]}, label pass {sum(lab):.4f} ms")
        if (res.get("cycle-engine") != "device" or u.get("kernel") != "bf16"
                or res["valid?"] is not True or counts["elle_closure"] < 1):
            raise AssertionError(f"elle {kind} 3k auto: {res['valid?']} "
                                 f"{res.get('cycle-engine')} {u}")
        MAIN_VERDICTS[f"elle {kind} 3k"] = [res["valid?"],
                                            res["anomaly-types"]]
        t0 = time.monotonic()
        host = check(hist, additional_graphs=RT, cycle_backend="host", **kw)
        host_s = time.monotonic() - t0
        same_verdict(f"elle {kind} 3k auto vs host", res, host)
        gt = builder(hist)
        Peaks.add(f"elle {kind} 3k bf16", t.gates, t.peak,
                  elle_plan(gt, "auto", [dev]))
        dev_s = (sum(sq) + sum(lab)) / 1e3
        print(f"  wall split: build {t.build_s:.4f} s, kernels {dev_s:.4f} "
              f"s, the rest (lint, direct anomalies, host prep, copies) "
              f"{wall - t.build_s - dev_s:.4f} s; host oracle {host_s:.2f} "
              f"s, same verdict")

        got, err, perr, pderr, plain_s, ins, a = run_closures(gt, dev)
        if err or perr or pderr:
            raise AssertionError(f"elle {kind} 3k closures: dense {err}, "
                                 f"packed {perr}, packed vs dense {pderr}")
        errs["elle_closure"] = max(errs["elle_closure"], err)
        errs["elle_packed_closure"] = max(errs["elle_packed_closure"], perr,
                                          pderr)
        n_pad = a["n_pad"]
        print(f"  dense kernel == closure_ref after every one of "
              f"{got[3]} squarings and on every output; packed == dense at "
              f"n_pad {n_pad}; closure_ref {plain_s:.3f} s in all; the main "
              f"path's first squaring (its seed A|I):", flush=True)
        timing = square_timing(etpu.adjacency(*ins[:3], n_pad,
                                              torch.bfloat16), plain=3)

        rt_, wall_t, counts_t, tt = elle_drive(check, hist,
                                               cycle_backend="trim", **kw)
        same_verdict(f"elle {kind} 3k trim vs host", rt_, host)
        ut = rt_["cycle-util"]
        trim_ms = tt.ms("elle_trim")
        tgot, terr, tplain_s, ti = run_trim(gt, dev)
        if terr or rt_.get("cycle-engine") != "trim" or \
                counts_t["elle_trim"] < 1:
            raise AssertionError(f"elle {kind} 3k trim: err {terr}, "
                                 f"{rt_.get('cycle-engine')}, {counts_t}")
        errs["elle_trim"] = max(errs["elle_trim"], terr)
        Peaks.add(f"elle {kind} 3k trim", tt.gates, tt.peak,
                  elle_plan(gt, "trim", [dev]))
        rt_off = trim_peel_us(ti, dev, use_rt=False)
        rt_on = trim_peel_us(ti, dev, use_rt=True)
        print(f"  trim per peel, the same inputs with the realtime "
              f"thresholds on / off (each its own fixpoint, medians of 3 "
              f"launches, every launch == trim_ref): "
              f"{rt_on[0]:.3f} us ({rt_on[1]} peels) / {rt_off[0]:.3f} us "
              f"({rt_off[1]} peels)", flush=True)
        print(f"  trim on the card: valid? {rt_['valid?']} engine "
              f"{rt_['cycle-engine']} iters_run {ut['iters_run']} "
              f"({ut['iters_run'] // 2} bodies), launches {counts_t}, kernel "
              f"{trim_ms[0]:.4f} ms = "
              f"{trim_ms[0] * 1e3 / ut['iters_run']:.3f} us/peel (chain "
              f"floor {ut['iters_run'] * step_us / 1e3:.4f} ms), wall "
              f"{wall_t:.4f} s; == trim_ref ({tplain_s * 1e3:.1f} ms plain)")
        out[kind] = dict(res=res, counts=counts, sq=sq, lab=lab,
                         timing=timing,
                         n_pad=n_pad, trim_ms=trim_ms, trim_counts=counts_t,
                         trim_plain_ms=tplain_s * 1e3, trim_inputs=ti,
                         bodies=ut["iters_run"] // 2)

    # ---- invalid histories: device == host, G-single among them -------------
    for kind, hist in (
            ("wr", synth.wr_register_history(**ELLE_STALE)),
            ("append", synth.list_append_history(**ELLE_CORRUPT))):
        check, kw, _ = builders[kind]
        res, wall, counts, t = elle_drive(check, hist, cycle_backend="auto",
                                          **kw)
        host = check(hist, additional_graphs=RT, cycle_backend="host", **kw)
        print(f"elle invalid {kind}: device {res['valid?']} "
              f"{res['anomaly-types']} cycles {cycles(res)} (engine "
              f"{res.get('cycle-engine')}, kernel "
              f"{(res.get('cycle-util') or {}).get('kernel')}, {wall:.3f} s "
              f"(build {t.build_s:.3f} s), launches {counts}); host "
              f"{host['valid?']} "
              f"{host['anomaly-types']} cycles {cycles(host)}")
        same_verdict(f"elle invalid {kind}", res, host, cycles_too=True)
        if res["valid?"] is not False or "G-single" not in res[
                "anomaly-types"] or res.get("cycle-engine") != "device":
            raise AssertionError(f"elle invalid {kind}: {res['valid?']} "
                                 f"{res['anomaly-types']}")

    # ---- the 10k cell: auto -> packed; forced trim -------------------------
    h10 = synth.list_append_history(**ELLE_10K)
    res, wall, counts, t = elle_drive(append.check, h10, cycle_backend="auto")
    peak10, gates10 = t.peak, t.gates
    u = res.get("cycle-util") or {}
    psq, plab = t.ms("elle_packed_square"), t.ms("elle_packed_labels")
    print(f"elle append 10k, auto: valid? {res['valid?']} engine "
          f"{res.get('cycle-engine')} kernel {u.get('kernel')} n_pad "
          f"{u.get('n_pad')} iters_run {u.get('iters_run')}, launches "
          f"{counts}, wall {wall:.4f} s (build {t.build_s:.4f} s, kernel_s "
          f"{u.get('kernel_s')}), squarings (ms) "
          f"{[round(x, 3) for x in psq]}, label pass {sum(plab):.4f} ms")
    if (res.get("cycle-engine") != "device" or u.get("kernel") != "packed"
            or u.get("n_pad") != 16384 or res["valid?"] is not True
            or counts["elle_packed_closure"] < 1):
        raise AssertionError(f"elle append 10k auto: {res['valid?']} {u}")
    MAIN_VERDICTS["elle append 10k"] = [res["valid?"], res["anomaly-types"]]
    res_t, wall_t, counts_t, tt = elle_drive(append.check, h10,
                                             cycle_backend="trim")
    print(f"  forced trim on the card: valid? {res_t['valid?']} engine "
          f"{res_t.get('cycle-engine')} iters_run "
          f"{res_t['cycle-util']['iters_run']}, kernel "
          f"{tt.ms('elle_trim')[0]:.4f} ms, wall {wall_t:.4f} s")
    same_verdict("elle append 10k packed vs trim", res, res_t)
    gt = builders["append"][2](h10)
    _, terr10, tplain10_s, ti10 = run_trim(gt, dev)
    peels10 = res_t["cycle-util"]["iters_run"]
    t10_ms = tt.ms("elle_trim")[0]
    if terr10 or counts_t["elle_trim"] != 1 or \
            res_t.get("cycle-engine") != "trim":
        raise AssertionError(f"elle append 10k trim: err {terr10}, "
                             f"{res_t.get('cycle-engine')}, {counts_t}")
    errs["elle_trim"] = max(errs["elle_trim"], terr10)
    Peaks.add("elle append 10k trim", tt.gates, tt.peak,
              elle_plan(gt, "trim", [dev]))
    print(f"  trim kernel == trim_ref at n_pad {ti10['n_pad']} (live "
          f"planes, every count row, bodies; trim_ref {tplain10_s:.1f} s): "
          f"{peels10} peels, {t10_ms * 1e3 / peels10:.3f} us/peel, chain "
          f"floor {peels10} x {step_us:.4f} us = "
          f"{peels10 * step_us / 1e3:.4f} ms", flush=True)
    Peaks.add("elle append 10k packed", gates10, peak10,
              elle_plan(gt, "auto", [dev]))
    a = etpu.closure_inputs(gt, packed=True)
    p = on_card(a["args"], dev)
    n, W = a["n_pad"], a["n_pad"] // 32
    kw = dict(n_pad=n, iters=a["iters"])
    keep, bad = [], []
    got = etpu.packed_closure(*p, **kw,
                              on_square=lambda i, r: keep.append(r.clone()))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ref = etpu.packed_closure_ref(
        *p, **kw, on_square=lambda i, r: bad.append(i) if not
        torch.equal(r, keep[i]) else None)
    torch.cuda.synchronize()
    pref_s = time.monotonic() - t0
    perr = outputs_err(got, ref) + len(bad)
    if perr or got[3] != u.get("iters_run") or len(psq) != got[3]:
        raise AssertionError(f"elle append 10k packed: the kernel differs "
                             f"from the plain version ({perr}, squarings "
                             f"{bad}) or ran {got[3]} squarings against "
                             f"the main path's {u.get('iters_run')}")
    cnt = torch.zeros(S, dtype=torch.int32, device=dev)
    pplain_ms = event_ms(lambda: etpu.packed_square_ref(p[0], cnt), reps=1)
    print(f"  packed kernel == packed_closure_ref on every one of {got[3]} "
          f"squarings (reach and counts) and the label pass "
          f"({pref_s:.1f} s plain); one plain squaring {pplain_ms:.1f} ms",
          flush=True)
    errs["elle_packed_closure"] = max(errs["elle_packed_closure"], perr)

    # each squaring's bound: its bytes, the bitset read and written
    # once. Beside it, not in it: the kernel's own work, the stages of
    # its flagged tiles on the tensor cores at the card's 1-bit peak,
    # and the old bit walk's, one OR per set bit per word at the int32
    # peak
    rates = bitmm_rates(dev)
    b1_peak = card_peak("b1_ops")
    sq_in = [p[0]] + keep[:-1]          # each squaring's input
    p_rows = []
    for i, r in enumerate(sq_in):
        fa, fb = etpu.bitmm_flags_ref(r, r)
        steps = occupancy.bitmm_steps(fa.cpu().numpy(), fb.cpu().numpy(),
                                      n_pad=n, n_cols=n)
        ones_i = int(etpu._popcount32(r.to(torch.int64) & 0xFFFFFFFF).sum())
        pc = occupancy.packed_square_cost(S, n, ones_i, steps=steps)
        row = {"ms": psq[i], "tc_ms": pc["tc_ops"] / b1_peak * 1e3,
               "bytes_ms": pc["bytes_accessed"] / hbm * 1e3,
               "or_ms": pc["ops"] / int_ops_per_s * 1e3, "ones": ones_i,
               "stages": steps / (S * n ** 3)}
        row["bound_ms"] = row["bytes_ms"]
        p_rows.append(row)
        print(f"  squaring {i}: {row['ms']:.4f} ms (main path) against a "
              f"bound of {row['bound_ms']:.4f} ms (bytes); the kernel's "
              f"tensor-core work {row['tc_ms']:.4f} ms at the 1-bit peak "
              f"(its flagged stages, {100 * row['stages']:.1f}% of the "
              f"dense product's); the bit walk's {row['or_ms']:.4f} ms at "
              f"the int32 peak ({ones_i} set bits)", flush=True)
    del fa, fb
    # the yardstick and the kernel device-only, at the first and the
    # last squaring's input
    p_yard = []
    scratch = etpu.bitmm_scratch(S, n, W, dev)
    for i in (0, len(sq_in) - 1):
        r, c = sq_in[i], torch.zeros(S, dtype=torch.int32, device=dev)
        y = product_yardstick(r, r, keep[i], dev)
        y["kernel_ms"] = device_ms(lambda: etpu.packed_square(r, c, scratch),
                                   reps=10)
        y["split_us"] = kernel_split(lambda: etpu.packed_square(r, c,
                                                                scratch))
        p_yard.append(y)
        print(f"  squaring {i} device-only: kernel {y['kernel_ms']:.4f} ms "
              f"(us a call by kernel, torch.profiler: {y['split_us']}); "
              f"torch._int_mm x {S} {y['int_mm_ms']:.4f} ms "
              f"({y['int_mm_layout']}; all {y['int_mm_all']}), torch.bmm "
              f"bf16 {y['bmm_ms']:.4f} ms (the product alone on unpacked "
              f"0/1 planes; no unpack, threshold or pack)", flush=True)
    # the A flags two ways on the same product: set by the transpose when
    # A is B (the packed squaring's form), or by a flag pass of their own
    # (the sharded squaring's): sharded_square with the reach as its own
    # block, and with a copy of it, device-only, in turns
    for i in (0, len(sq_in) - 1):
        r, r2 = sq_in[i], sq_in[i].clone()
        c = torch.zeros(S, dtype=torch.int32, device=dev)
        calls = {"transpose": lambda: etpu.sharded_square(r, r, c,
                                                          scratch=scratch),
                 "flag pass": lambda: etpu.sharded_square(r, r2, c,
                                                          scratch=scratch)}
        for form, call in calls.items():
            if not torch.equal(call(), keep[i]):
                raise AssertionError(f"squaring {i} with the A flags by "
                                     f"the {form} differs")
        turns = {form: [] for form in calls}
        for form in ("transpose", "flag pass", "flag pass", "transpose"):
            turns[form].append(device_ms(calls[form], reps=10))
        print(f"  squaring {i}, the A flags set by the transpose against a "
              f"flag pass of their own (device-only ms, in turns): "
              f"{turns}", flush=True)
        del r2
    # every tile flagged: a random reach at density 0.5, the tensor
    # cores' own regime
    gen = torch.Generator(device=dev).manual_seed(n)
    rnd = torch.empty_like(p[0])
    for si in range(S):
        rnd[si] = etpu.pack_bits(torch.rand((n, n), generator=gen, device=dev)
                                < 0.5)
    c, want_cnt = (torch.zeros(S, dtype=torch.int32, device=dev)
                   for _ in range(2))
    rnd_err = max_abs_err([etpu.packed_square(rnd, c, scratch), c],
                          [etpu.packed_square_ref(rnd, want_cnt), want_cnt])
    if rnd_err:
        raise AssertionError(f"packed squaring of a dense random reach "
                             f"differs from packed_square_ref ({rnd_err})")
    errs["elle_packed_closure"] = max(errs["elle_packed_closure"], rnd_err)
    rnd_ms = device_ms(lambda: etpu.packed_square(rnd, c, scratch), reps=10)
    fa, fb = etpu.bitmm_flags_ref(rnd, rnd)
    rnd_ops = 2 * occupancy.bitmm_steps(fa.cpu().numpy(), fb.cpu().numpy(),
                                        n_pad=n, n_cols=n)
    print(f"  a dense squaring (a random reach at 0.5, every tile "
          f"flagged) == packed_square_ref: kernel {rnd_ms:.4f} ms "
          f"device-only, {rnd_ops / rnd_ms / 1e9:.1f} TOP/s "
          f"({100 * rnd_ops / (rnd_ms / 1e3) / b1_peak:.1f}% of the 1-bit "
          f"peak, {100 * rnd_ops / (rnd_ms / 1e3) / rates['b1_wgmma']:.1f}% "
          f"of the probe's reading)", flush=True)
    del scratch, got, ref, rnd, fa, fb

    # the dense route's largest shape, n_pad 8320 (8192 txns), on a
    # random seed A|I with the 10k graph's off-diagonal density
    n_nodes = int(np.asarray(gt.nodes).shape[0])
    seed_ones = int(etpu._popcount32(p[0].to(torch.int64)
                                     & 0xFFFFFFFF).sum())
    density = (seed_ones - S * a["n_pad"]) / (S * n_nodes * (n_nodes - 1))
    n_big = etpu._n_pad_for(etpu.DEFAULT_MAX_N)
    gen = torch.Generator(device=dev).manual_seed(8320)
    big = (torch.rand((S, n_big, n_big), generator=gen, device=dev)
           < density).to(torch.bfloat16)
    big.diagonal(dim1=1, dim2=2).fill_(1)
    print(f"elle dense squaring at the route's largest n_pad {n_big}: a "
          f"random seed at the 10k graph's density {density:.3e} "
          f"({seed_ones} ones in its packed seed over {n_nodes} nodes), "
          f"plus the identity", flush=True)
    big_timing = square_timing(big)
    del big

    # ---- the sharded closure: shards of this card ------------------------------
    # every squaring of the 10k closure at 1, 2 and 4 shards: each
    # shard's block against the matching column block of the packed
    # kernel's reach (== packed_square_ref's, checked above)
    s_err = 0
    for ns in SHARD_CHECK:
        w_loc = W // ns
        sc_ns = etpu.bitmm_scratch(S, n, w_loc, dev)
        times = []
        for i, r in enumerate(sq_in):
            for k, b in enumerate(etpu.shard_blocks(r, ns)):
                c = torch.zeros(S, dtype=torch.int32, device=dev)
                o = etpu.sharded_square(r, b, c, scratch=sc_ns)
                if i == 0:
                    c_t = torch.zeros_like(c)
                    times.append(device_ms(lambda: etpu.sharded_square(
                        r, b, c_t, scratch=sc_ns), reps=10))
                want_blk = keep[i][..., k * w_loc:(k + 1) * w_loc]
                want_cnt = etpu._popcount32(want_blk.to(torch.int64)
                                            & 0xFFFFFFFF).sum(dim=(1, 2))
                err = max(max_abs_err([o], [want_blk]),
                          max_abs_err([c], [want_cnt]))
                s_err = max(s_err, err)
                if err:
                    raise AssertionError(
                        f"elle_sharded_square, {ns} shards, squaring {i}, "
                        f"block {k}: max abs err {err}")
        print(f"elle_sharded_square == packed_square_ref's column blocks "
              f"on every one of {len(sq_in)} squarings (outputs and "
              f"counts), {ns} shard(s) of {w_loc} words on the card: the "
              f"first squaring's kernel ms per shard (device-only, warm) "
              f"{[round(x, 4) for x in times]}", flush=True)
        del sc_ns
    # the main path's shape: 2 shards, shard 0, the first squaring
    blk0 = etpu.shard_blocks(p[0], ELLE_SHARDS[0])[0]
    w_loc0 = blk0.shape[-1]
    c0 = torch.zeros(S, dtype=torch.int32, device=dev)
    sh_scratch = etpu.bitmm_scratch(S, n, w_loc0, dev)
    sh_ms = device_ms(lambda: etpu.sharded_square(p[0], blk0, c0,
                                                  scratch=sh_scratch))
    sh_call_ms = event_ms(lambda: etpu.sharded_square(p[0], blk0, c0))
    c1 = torch.zeros(S, dtype=torch.int32, device=dev)
    ref_blk = etpu.sharded_square_ref(p[0], blk0, c1)
    torch.cuda.synchronize()
    s_err = max(s_err, max_abs_err([etpu.sharded_square(
        p[0], blk0, torch.zeros(S, dtype=torch.int32, device=dev))],
        [ref_blk]))
    sh_plain_ms = event_ms(lambda: etpu.sharded_square_ref(p[0], blk0, c1),
                           reps=1)
    sh_yard = product_yardstick(p[0], blk0, keep[0][..., :w_loc0], dev)
    ones0 = int(etpu._popcount32(p[0].to(torch.int64) & 0xFFFFFFFF).sum())
    fa, fb = etpu.bitmm_flags_ref(p[0], blk0)
    sh_steps = occupancy.bitmm_steps(fa.cpu().numpy(), fb.cpu().numpy(),
                                     n_pad=n, n_cols=32 * w_loc0)
    sc = occupancy.sharded_square_cost(p[0].numel(), blk0.numel(), ones0,
                                       w_loc0, steps=sh_steps)
    sh_tc = sc["tc_ops"] / b1_peak
    sh_ops = sc["ops"] / int_ops_per_s
    sh_bytes = sc["bytes_accessed"] / hbm
    sh_bound = sh_bytes * 1e3
    print(f"  2 shards, shard 0, first squaring: kernel {sh_ms:.4f} ms "
          f"device-only ({sh_call_ms:.4f} ms as a call), "
          f"sharded_square_ref {sh_plain_ms:.1f} ms (== the kernel); "
          f"torch._int_mm x {S} {sh_yard['int_mm_ms']:.4f} ms "
          f"({sh_yard['int_mm_layout']}), torch.bmm bf16 "
          f"{sh_yard['bmm_ms']:.4f} ms (device-only, the product alone); "
          f"bound {sh_bound:.4f} ms (bytes: the gathered reach read, the "
          f"block read and written); the kernel's tensor-core work "
          f"{sh_tc * 1e3:.4f} ms at the 1-bit peak (its flagged stages); "
          f"the bit walk's ({ones0} set bits x {w_loc0} local words) "
          f"{sh_ops * 1e3:.4f} ms at the int32 peak", flush=True)
    del ref_blk, keep, sq_in, sh_scratch, fa, fb

    host = host10.result()
    print(f"elle append 10k, host oracle (background process): "
          f"{host['valid?']} {host['anomaly-types']} in "
          f"{host['seconds']:.1f} s", flush=True)
    same_verdict("elle append 10k packed vs host", res, host)
    qp = etpu.cycle_queries_packed(gt, device=dev)
    sh_counts = None
    for ns in ELLE_SHARDS:
        cards = [dev] * ns
        rs, wall_s, counts_s, ts = elle_drive(append.check, h10,
                                              cycle_backend="sharded",
                                              devices=cards)
        us = rs.get("cycle-util") or {}
        sq_ms = ts.ms("elle_sharded_square")
        print(f"elle append 10k, sharded over {ns} shards of the card: "
              f"valid? {rs['valid?']} engine {rs.get('cycle-engine')} "
              f"n_shards {us.get('n_shards')} shard words "
              f"{us.get('shard_words')} iters_run {us.get('iters_run')}, "
              f"launches {counts_s}, wall {wall_s:.4f} s (build "
              f"{ts.build_s:.4f} s, kernel_s {us.get('kernel_s')}), "
              f"squarings per shard (ms) {[round(x, 3) for x in sq_ms]}, "
              f"label pass {sum(ts.ms('elle_packed_labels')):.4f} ms",
              flush=True)
        same_verdict(f"elle append 10k sharded x{ns} vs host", rs, host)
        Peaks.add(f"elle append 10k sharded x{ns}", ts.gates, ts.peak,
                  elle_plan(gt, "sharded", cards))
        if (rs.get("cycle-engine") != "sharded" or us.get("n_shards") != ns
                or counts_s["elle_sharded_square"] < 1
                or us.get("iter_reach") != u.get("iter_reach")
                or us.get("iters_run") != u.get("iters_run")):
            raise AssertionError(f"elle sharded x{ns}: {us}, {counts_s}")
        if sh_counts is None:
            sh_counts = counts_s
        qs = etpu.cycle_queries_sharded(gt, devices=cards)
        same = (qs["sccs"] == qp["sccs"] and qs["rw_edges"] == qp["rw_edges"]
                and np.array_equal(qs["rw_closed"], qp["rw_closed"])
                and qs["util"]["iter_reach"] == qp["util"]["iter_reach"]
                and qs["util"]["iters_run"] == qp["util"]["iters_run"])
        print(f"  cycle_queries_sharded x{ns} == cycle_queries_packed: "
              f"sccs, rw_closed, iter_reach, iters_run {same}", flush=True)
        if not same:
            raise AssertionError(f"elle sharded x{ns} differs from packed")
    sharded_entry = {
        "name": "elle_sharded_square", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/elle_sharded.cu",
        "replaces": "jepsen_tpu/elle/tpu.py:627",
        "launches": sh_counts["elle_sharded_square"], "max_abs_err": s_err,
        "ms": sh_ms, "plain_ms": sh_plain_ms, "bound_ms": sh_bound,
        "bound_by": "bytes",
        "library_ms": sh_yard["int_mm_ms"]}

    # ---- bounds -------------------------------------------------------------
    # dense, per squaring: 2 S n^3 flops on the tensor cores; reach read
    # and written once (2 S n^2 bf16)
    d = out["append"]
    n = d["n_pad"]
    dc = occupancy.dense_square_cost(S, n)
    d_ops = dc["flops"] / card_peak("bf16_flops")
    d_bytes = dc["bytes_accessed"] / hbm
    d_bound = max(d_ops, d_bytes) * 1e3
    d_ms = d["timing"]["ms"]
    d_main_ms = float(np.median(d["sq"]))
    # packed, per squaring (mean over the run, `p_rows` above): the
    # bitset read and written once; beside it the kernel's tensor-core
    # work at the 1-bit peak and the bit walk's ORs at the int32 peak
    p_bound = float(np.mean([r["bound_ms"] for r in p_rows]))
    p_tc = float(np.mean([r["tc_ms"] for r in p_rows]))
    p_or = float(np.mean([r["or_ms"] for r in p_rows]))
    p_ms = float(np.mean(psq))
    # trim, one launch: each input read once and each output written
    # once, against the checks this run's live nodes need (trim_work)
    ti = d["trim_inputs"]
    t_bytes = occupancy.trim_bytes(ti["arrays"], ti["n_pad"], S) / hbm
    t_work = occupancy.trim_work(ti, dev)
    t_ops = t_work / int_ops_per_s
    t_bound = max(t_bytes, t_ops) * 1e3
    # for scale, not the bound: were every peel to re-read the padded
    # neighbor tables, masks and node arrays from device memory
    t_body_bytes = 2 * ti["n_pad"] * ((ti["d_in"] + ti["d_out"]) * (4 + S)
                                      + 16)
    print(f"elle bounds: dense {d_bound:.4f} ms per squaring (n_pad "
          f"{d['n_pad']}: {2 * S * d['n_pad'] ** 3:.3e} flops at 989 "
          f"TFLOP/s) against {d_ms:.4f} ms device-only ({d_main_ms:.4f} ms "
          f"median on the main path, the launch's host path inside the "
          f"events); at n_pad {big_timing['n_pad']} "
          f"{big_timing['bound_ms']:.4f} ms against {big_timing['ms']:.4f} "
          f"ms (yardstick {big_timing['library_ms']:.4f} ms); packed "
          f"{p_bound:.4f} ms per squaring, mean of {len(p_rows)} (bytes; "
          f"the kernel's tensor-core work {p_tc:.4f} ms mean at "
          f"{b1_peak / 1e12:.0f} TOP/s, the bit walk's {p_or:.4f} ms mean "
          f"at the int32 peak) against {p_ms:.4f} ms mean, the "
          f"torch._int_mm yardstick "
          f"{[round(y['int_mm_ms'], 4) for y in p_yard]} ms and bf16 "
          f"torch.bmm {[round(y['bmm_ms'], 4) for y in p_yard]} ms at the "
          f"first and last squaring; trim {t_bound:.6f} ms (bytes "
          f"{t_bytes * 1e3:.6f}, ops {t_ops * 1e3:.6f}: {t_work} checks of "
          f"live nodes' real slots and thresholds; re-read per body "
          f"{t_body_bytes} B x {d['bodies']} bodies = "
          f"{t_body_bytes * d['bodies'] / hbm * 1e3:.6f} ms; chain floor "
          f"{2 * d['bodies']} peels x {step_us:.4f} us = "
          f"{2 * d['bodies'] * step_us / 1e3:.4f} ms) "
          f"against {d['trim_ms'][0]:.4f} ms")
    return [{
        "name": "elle_closure", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/elle_closure.cu",
        "replaces": "jepsen_tpu/elle/tpu.py:115",
        "launches": d["counts"]["elle_closure"],
        "max_abs_err": max(errs["elle_closure"], d["timing"]["err"],
                           big_timing["err"]), "ms": d_ms,
        "plain_ms": d["timing"]["plain_ms"], "bound_ms": d_bound,
        "bound_by": "operations" if d_ops > d_bytes else "bytes",
        "library_ms": d["timing"]["library_ms"]}, {
        "name": "elle_packed_closure", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/elle_packed.cu",
        "replaces": "jepsen_tpu/elle/tpu.py:399",
        "launches": counts["elle_packed_closure"],
        "max_abs_err": errs["elle_packed_closure"], "ms": p_ms,
        "plain_ms": pplain_ms, "bound_ms": p_bound, "bound_by": "bytes",
        "library_ms": float(np.mean([y["int_mm_ms"] for y in p_yard]))}, {
        "name": "elle_trim", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/elle_trim.cu",
        "replaces": "jepsen_tpu/elle/tpu.py:899",
        "launches": d["trim_counts"]["elle_trim"],
        "max_abs_err": errs["elle_trim"], "ms": d["trim_ms"][0],
        "plain_ms": d["trim_plain_ms"], "bound_ms": t_bound,
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": None}, sharded_entry]


def bitmm_rates(dev, iters: int = 4000) -> dict:
    """The tensor cores' issue rates, in operations a second (2 a bit or
    int8 multiply-accumulate), from the rate probe `elle_bitmm_rate`
    (`csrc/elle_packed.cu`): every SM's blocks looping over one shared
    memory stage, timed with CUDA events after a warm launch. "b1_wgmma"
    is the packed squaring's own instruction (m64n256k256 .b1 AND/popc),
    "b1_mma_sync" the sm_80 form (m16n8k256, from registers), "s8_wgmma"
    int8's m64n256k32. The launches count on no wrapper."""
    from jepsen_tpu_torch.ops import _native
    from jepsen_tpu_torch.util import raw_stream

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    # variant, blocks, operations a block an iteration
    probes = {"b1_wgmma": (0, sms, 3 * 4 * 2 * 64 * 256 * 256),
              "b1_mma_sync": (1, 2 * sms, 16 * 8 * 2 * 16 * 8 * 256),
              "s8_wgmma": (2, sms, 3 * 4 * 2 * 64 * 256 * 32)}
    out = {}
    for name, (variant, blocks, ops) in probes.items():
        def run(n):
            _native.launch("elle_bitmm_rate", [sink.data_ptr()],
                           [variant, n, blocks], raw_stream(dev))
        run(10)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        run(iters)
        e1.record()
        torch.cuda.synchronize()
        out[name] = ops * blocks * iters / (e0.elapsed_time(e1) / 1e3)
    print(f"tensor-core rates (elle_bitmm_rate, {iters} iterations on "
          f"every SM): 1-bit AND/popc wgmma {out['b1_wgmma'] / 1e12:.1f} "
          f"TOP/s, 1-bit mma.sync {out['b1_mma_sync'] / 1e12:.1f}, int8 "
          f"wgmma {out['s8_wgmma'] / 1e12:.1f} (2 operations a "
          f"multiply-accumulate)", flush=True)
    return out


def product_yardstick(a, b, want, dev) -> dict:
    """The PyTorch calls that compute a packed squaring's product on the
    unpacked 0/1 planes of A (S, n, n/32 words) and B (S, n, w words):
    `torch._int_mm` per subset (int8 in, int32 counts; B row-major and
    column-major, the faster kept) and one bf16 `torch.bmm`, device-only
    (median of 5, in turns); unpacking and packing are not timed.
    `want` (the kernel's packed output on these inputs) is checked
    against the int8 counts' `> 0`."""
    from jepsen_tpu_torch.elle import tpu as etpu

    S = a.shape[0]
    a8 = [etpu.unpack_bits(a[s]).to(torch.int8) for s in range(S)]
    b8 = a8 if b is a else [etpu.unpack_bits(b[s]).to(torch.int8)
                            for s in range(S)]
    layouts = {"row-major B": b8,
               "column-major B": [x.t().contiguous().t() for x in b8]}
    int_mm = {}
    for name, bs in layouts.items():
        try:
            got = [torch._int_mm(x, y) for x, y in zip(a8, bs)]
        except RuntimeError as e:       # a layout this build refuses
            print(f"  torch._int_mm with {name}: {e}", flush=True)
            continue
        torch.cuda.synchronize()
        bad = sum(not torch.equal(etpu.pack_bits(g > 0), want[s])
                  for s, g in enumerate(got))
        if bad:
            raise AssertionError(f"torch._int_mm ({name}) differs from the "
                                 f"kernel on {bad} subsets")
        del got
        int_mm[name] = (lambda bs=bs: [torch._int_mm(x, y)
                                       for x, y in zip(a8, bs)])
    ab = torch.stack(a8).to(torch.bfloat16)
    bb = ab if b is a else torch.stack(b8).to(torch.bfloat16)

    def bmm():
        return torch.bmm(ab, bb)

    first = {k: device_ms(f, reps=5) for k, f in int_mm.items()}
    m1, m2 = device_ms(bmm, reps=5), device_ms(bmm, reps=5)
    both = {k: (first[k] + device_ms(f, reps=5)) / 2
            for k, f in reversed(list(int_mm.items()))}
    best = min(both, key=both.get)
    return {"int_mm_ms": both[best], "int_mm_layout": best,
            "int_mm_all": both, "bmm_ms": (m1 + m2) / 2}


def multikey_history(n_keys, n_ops, n_procs, crash_p, lie_keys=(),
                     lie_p=0.0, cache=None):
    """One tuple-valued history of `n_keys` cas-register keys (key k's
    ops from seed k), interleaved at random, with a nemesis marker at
    each end that every subhistory keeps; processes are (p, k). A
    `cache` dict keeps each key's generated ops for the next call."""
    import random

    from jepsen_tpu_torch import history as hist
    from jepsen_tpu_torch import independent, synth

    cache = {} if cache is None else cache

    def ops_of(k):
        lie = lie_p if k in lie_keys else 0.0
        if (k, lie) not in cache:
            cache[k, lie] = list(synth.cas_register_history(
                n_ops, n_procs=n_procs, seed=k, crash_p=crash_p, lie_p=lie))
        return cache[k, lie]

    rng = random.Random(7)
    out = hist.History()
    out.append(hist.info("nemesis", "start-partition", None))
    live = [[k, ops_of(k), 0] for k in range(n_keys)]
    while live:
        i = rng.randrange(len(live))
        k, ops, j = live[i]
        op = ops[j]
        out.append(op.with_(process=(op.process, k),
                            value=independent.tuple_(k, op.value)))
        live[i][2] += 1
        if j + 1 == len(ops):
            live.pop(i)
    out.append(hist.info("nemesis", "stop-partition", None))
    return out.index()


def oracle_verdict(ops: list):
    """The host oracle's verdict on one subhistory (op dicts), in a
    worker process."""
    from jepsen_tpu_torch import history as hist
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import wgl_ref
    h = hist.History(hist.Op.from_dict(d) for d in ops)
    return wgl_ref.check(cas_register(), h)["valid?"]


def lanes_of(consts, carry, idx):
    """The batch's lanes `idx` as a batch of their own (copies)."""
    from jepsen_tpu_torch.ops import wgl32
    i = torch.as_tensor(idx, device=consts.meta.device)
    sub = wgl32.BatchConsts(**{
        f: (v[i].contiguous() if torch.is_tensor(v) else v)
        for f, v in consts.__dict__.items()})
    return sub, tuple(t[i].contiguous() for t in carry)


def random_carry(lanes, K, C, H, B, dev, seed):
    """A lane-batched carry of the given shapes with random words in
    every leaf (made on the card from a seed)."""
    from jepsen_tpu_torch.ops import wgl32
    gen = torch.Generator(device=dev).manual_seed(seed)
    carry = wgl32.init_carry_batch(lanes, K, C, H, B, 0, dev)
    for t in carry:
        t.copy_(torch.randint(-2**31, 2**31 - 1, t.shape, generator=gen,
                              device=dev, dtype=torch.int32))
    return carry


def reset_turns(dev, mesh) -> list:
    """`wgl_lane_reset` (the wrapper `mesh.reset_lanes` of the package
    imported) at RESET_SHAPES, each carry random words made on the card
    from a seed and each mask drawn from one generator: held bit for bit
    against `reset_lanes_ref` on the same inputs, then the kernel, its
    plain version and `torch.where` over the leaves timed in three turns
    (kernel, library, plain; back; forth again), each turn the median of
    30 calls device-only (`device_ms`) and as a call (`event_ms`, the
    host path inside). Returns one row a shape: {name, lanes, masked,
    err, bytes, bound_ms, device: {which: ms}, call: {which: ms}}."""
    from jepsen_tpu_torch.ops import wgl32

    rng = np.random.default_rng(11)
    rows = []
    for name, lanes, K, C, H, B, mst, _ in RESET_SHAPES:
        carry = random_carry(lanes, K, C, H, B, dev, seed=lanes)
        mask = rng.random(lanes) < 0.5
        mask[0] = True
        ref = tuple(t.clone() for t in carry)
        mesh.reset_lanes(carry, mask, mst_col=mst)
        mesh.reset_lanes_ref(ref, mask, mst_col=mst)
        torch.cuda.synchronize()
        err = max_abs_err(carry, ref)
        if err or not same_carry(carry, ref):
            raise AssertionError(f"wgl_lane_reset differs from "
                                 f"reset_lanes_ref on {name} ({err})")
        init = wgl32.init_carry_batch(lanes, K, C, H, B, 0, dev)
        m_t = torch.as_tensor(mask, device=dev)
        fns = {"kernel": lambda: mesh.reset_lanes(carry, mask, mst_col=mst),
               "plain": lambda: mesh.reset_lanes_ref(ref, mask, mst_col=mst),
               "library": lambda: [torch.where(
                   m_t.view((-1,) + (1,) * (c.dim() - 1)), i, c)
                   for c, i in zip(carry, init)]}
        call, devt = {}, {}
        for order in (("kernel", "library", "plain"),
                      ("plain", "library", "kernel"),
                      ("kernel", "library", "plain")):
            for which in order:
                call.setdefault(which, []).append(
                    event_ms(fns[which], reps=30))
                devt.setdefault(which, []).append(
                    device_ms(fns[which], reps=30))
        call = {k: float(np.mean(v)) for k, v in call.items()}
        devt = {k: float(np.mean(v)) for k, v in devt.items()}
        host = host_ms(fns["kernel"])
        if lanes <= 64 and hasattr(mesh, "_reset_block"):
            ride_turns(mesh, carry, ref, mask, mst, name)
        lane_bytes = sum(t[0].numel() * 4 for t in carry)
        nbytes = int(mask.sum()) * lane_bytes + lanes * 4
        bound = nbytes / card_peak("hbm_bytes_per_s") * 1e3
        print(f"  wgl_lane_reset == reset_lanes_ref on {name} (K {K}, C "
              f"{C}, H {H}, B {B}; {int(mask.sum())} of {lanes} lanes "
              f"masked): device-only kernel {devt['kernel']:.4f} ms, plain "
              f"{devt['plain']:.4f} ms, torch.where over the leaves "
              f"{devt['library']:.4f} ms; as calls kernel "
              f"{call['kernel']:.4f} ms, plain {call['plain']:.4f} ms, "
              f"torch.where {call['library']:.4f} ms (medians of 30, three "
              f"turns averaged); the kernel's host path {host:.4f} ms a "
              f"call; bound {nbytes} bytes written = {bound:.6f} ms",
              flush=True)
        rows.append(dict(name=name, lanes=lanes, masked=int(mask.sum()),
                         err=err, bytes=nbytes, bound_ms=bound, device=devt,
                         call=call, host_ms=host))
        del init, ref, carry
    return rows


def ride_turns(mesh, carry, ref, mask, mst: int, name: str) -> None:
    """The alternative to the reset's mask by value, timed against it in
    turns (by value, ride, ride, by value; device-only and as a call,
    medians of 30): the masked lanes' indices ride the refilled shard's
    consts re-send, one more host-to-card copy beside it, and the kernel
    reads them on the card (its path for carries of more than 64
    lanes). Both held bit for bit against `reset_lanes_ref` first."""
    from jepsen_tpu_torch.ops import _native
    from jepsen_tpu_torch.util import raw_stream

    def ride():
        sel = torch.from_numpy(np.flatnonzero(mask).astype(np.int32)).to(
            carry[0].device)
        blk = mesh._reset_block(carry).copy()
        blk[8], blk[9], blk[10] = sel.data_ptr(), 0, len(sel)
        blk[16], blk[17] = mst, 0
        _native.launch("wgl_lane_reset", (blk.ctypes.data,), (),
                       raw_stream(carry[0].get_device()))

    ride()
    torch.cuda.synchronize()
    if not same_carry(carry, ref):
        raise AssertionError(f"wgl_lane_reset by index differs from "
                             f"reset_lanes_ref on {name}")
    fns = {"by value": lambda: mesh.reset_lanes(carry, mask, mst_col=mst),
           "ride": ride}
    call, devt = {}, {}
    for which in ("by value", "ride", "ride", "by value"):
        call.setdefault(which, []).append(event_ms(fns[which], reps=30))
        devt.setdefault(which, []).append(device_ms(fns[which], reps=30))
    print(f"  wgl_lane_reset on {name}, in turns by value / ride / ride / "
          f"by value: device-only {[round(x, 4) for x in devt['by value']]}"
          f" / {[round(x, 4) for x in devt['ride']]} ms, as calls "
          f"{[round(x, 4) for x in call['by value']]} / "
          f"{[round(x, 4) for x in call['ride']]} ms (the ride: the masked "
          f"lanes' indices copied to the card beside the consts re-send)",
          flush=True)


def lane_kernel_checks(dev, plan, wplan) -> list:
    """`wgl_lane_reset` and `wgl_frontier_migrate` against their plain
    versions on the card: the reset at RESET_SHAPES (`reset_turns`: a
    100-lane narrow carry at the fan-out's capacities, H 2^19, the mesh
    fan-out's own 4-lane shard carry, and an 8-lane wide carry at the
    waves' capacities, each with a random lane mask); the migration up
    and down one ladder step of each. Times from CUDA events; the
    library call is `torch.where` over the carry leaves for the reset
    and `torch.nn.functional.pad` or a slice for the migration. Both
    kernels, their plain versions and their library calls are timed two
    ways: as calls (events around the Python call on an idle card, so
    the host path is inside) and device-only (`device_ms`); the kernels
    line takes the device-only times. Returns the two kernels' entries
    of the kernels line (launches filled in by the caller)."""
    from jepsen_tpu_torch.ops import adapt, wgl32, wgln
    from jepsen_tpu_torch.parallel import mesh

    want = {"narrow 100 lanes": (plan["K"], wgl32.row_words(plan["ic"]),
                                 plan["H"], plan["B"], 2),
            "narrow shard of the mesh fan-out": (
                16, wgl32.row_words(plan["ic"]), plan["H"], plan["B"], 2),
            "wide 8 lanes": (wplan["K"],
                             wgln.row_words(wplan["L"], wplan["ic"]),
                             wplan["H"], wplan["B"], 1 + wplan["L"])}
    for name, _, K, C, H, B, mst, _ in RESET_SHAPES:
        if want[name] != (K, C, H, B, mst):
            raise AssertionError(f"RESET_SHAPES {name}: {(K, C, H, B, mst)}"
                                 f" != the main path's {want[name]}")
    rows = reset_turns(dev, mesh)
    r_err = max(r["err"] for r in rows)
    # the kernels line: the main path's shape, the mesh fan-out's shard
    shard = rows[1]
    out = {"reset": dict(ms=shard["device"]["kernel"],
                         plain_ms=shard["device"]["plain"],
                         library_ms=shard["device"]["library"],
                         bound_ms=shard["bound_ms"])}
    for name, lanes, K, C, H, B, mst, k_step in RESET_SHAPES:
        carry = random_carry(lanes, K, C, H, B, dev, seed=lanes)
        # the migration one ladder step up, then down
        lo, hi = sorted((K, k_step))
        m_err = 0
        for k_from, k_to in ((lo, hi), (hi, lo)):
            src = mesh.migrate_lanes(carry, k_from) if k_from != K else carry
            got = mesh.migrate_lanes(src, k_to)
            want = adapt.migrate_frontier_batch(src, k_to)
            torch.cuda.synchronize()
            m_err = max(m_err, max_abs_err(got[:1], want[:1]))
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"wgl_frontier_migrate {k_from} -> "
                                     f"{k_to} differs on {name}")
            fr = src[0]
            grow = k_to - k_from
            fns = {"kernel": lambda: mesh.migrate_lanes(src, k_to),
                   "plain": lambda: adapt.migrate_frontier_batch(src, k_to),
                   "library": (
                       (lambda: torch.nn.functional.pad(fr, (0, 0, 0, grow)))
                       if grow > 0 else (lambda: fr[:, :k_to].contiguous()))}
            # each way, in three turns: kernel, library, plain, then
            # back, then forth again
            call, devt = {}, {}
            for order in (("kernel", "library", "plain"),
                          ("plain", "library", "kernel"),
                          ("kernel", "library", "plain")):
                for which in order:
                    call.setdefault(which, []).append(
                        event_ms(fns[which], reps=30))
                    devt.setdefault(which, []).append(
                        device_ms(fns[which], reps=30))
            call = {k: float(np.mean(v)) for k, v in call.items()}
            devt = {k: float(np.mean(v)) for k, v in devt.items()}
            mbytes = lanes * (min(k_from, k_to) + k_to) * C * 4
            mbound = mbytes / card_peak("hbm_bytes_per_s") * 1e3
            lib = "F.pad" if grow > 0 else "slice"
            print(f"  wgl_frontier_migrate == migrate_frontier_batch "
                  f"{k_from} -> {k_to}: device-only kernel "
                  f"{devt['kernel']:.4f} ms, plain {devt['plain']:.4f} ms, "
                  f"{lib} {devt['library']:.4f} ms; as calls kernel "
                  f"{call['kernel']:.4f} ms, plain {call['plain']:.4f} ms, "
                  f"{lib} {call['library']:.4f} ms (medians of 30, three "
                  f"turns averaged); bound {mbytes} bytes (rows kept read, "
                  f"new frontier written) = {mbound:.6f} ms", flush=True)
            out.setdefault("migrate", dict(
                ms=devt["kernel"], plain_ms=devt["plain"],
                library_ms=devt["library"], bound_ms=mbound))
            out.setdefault("migrate_rows", []).append(
                (name, k_from, k_to, devt, call))
        out.setdefault("migrate_err", 0)
        out["migrate_err"] = max(out["migrate_err"], m_err)
        del carry
    rows = out["migrate_rows"]
    print(f"  wgl_frontier_migrate against its library call at all "
          f"{len(rows)} shapes: device-only time at or under it at "
          f"{sum(d['kernel'] <= d['library'] for *_, d, _ in rows)}, call "
          f"time at or under it at "
          f"{sum(c['kernel'] <= c['library'] for *_, c in rows)}", flush=True)
    return [{
        "name": "wgl_lane_reset", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/wgl_lanes.cu",
        "replaces": "jepsen_tpu/parallel/mesh.py:192",
        "launches": None, "max_abs_err": r_err, **out["reset"],
        "bound_by": "bytes"}, {
        "name": "wgl_frontier_migrate", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/wgl_lanes.cu",
        "replaces": "jepsen_tpu/parallel/mesh.py:209",
        "launches": None, "max_abs_err": out["migrate_err"],
        **out["migrate"], "bound_by": "bytes"}]


def fanout_phases(dev) -> list:
    """The per-key fan-out on the card: both lane-batched kernels against
    their plain versions at the main paths' shapes, then the main paths
    (narrow 100 x 2k through `independent.cuda_checker`, its invalid
    variant against the host oracle, wide waves through
    `check_batched`, and a 3-key stream), each with every count at 0
    just before it. Returns the two kernels' entries of the kernels
    line."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from jepsen_tpu_torch import independent, occupancy, synth
    from jepsen_tpu_torch.history import strip_nemesis
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import encode, wgl, wgl32, wgl_ref, wgln
    from jepsen_tpu_torch.parallel import batched

    def kernel_vs_plain(mod, consts, carry, tally=None, **kw):
        """The batched kernel of `mod` and its plain version from the
        same start; both timed with CUDA events; (summary, kernel ms,
        plain ms, err)."""
        ref_in = tuple(t.clone() for t in carry)
        torch.cuda.synchronize()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        e[0].record()
        out, summary = mod.chunk_batched(consts, carry, **kw)
        e[1].record()
        torch.cuda.synchronize()
        e[2].record()
        ref, ref_summary = mod.chunk_batched_ref(consts, ref_in, tally=tally,
                                                 **kw)
        e[3].record()
        torch.cuda.synchronize()
        err = max(max_abs_err(out, ref), max_abs_err([summary],
                                                    [ref_summary]))
        if err or not (same_carry(out, ref)
                       and torch.equal(summary, ref_summary)):
            raise AssertionError(f"{mod.__name__} batched kernel differs "
                                 f"from chunk_batched_ref (max abs err "
                                 f"{err}) at {kw}")
        return summary, e[0].elapsed_time(e[1]), e[2].elapsed_time(e[3]), err

    def kernel_ms(mod, consts, start, reps=3, **kw):
        """Median kernel time from `start` over `reps` launches (the
        clone sits outside the timed window)."""
        times = []
        for _ in range(reps):
            c = tuple(t.clone() for t in start)
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            mod.chunk_batched(consts, c, **kw)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times)), times

    def batched_forms(consts, start, rounds, what, *, K, W, ic, H, B,
                      probes):
        """The narrow batched kernel's shared form against global
        scratch at its thread count and at the old 1024, in turns."""
        C = wgl32.row_words(ic)
        shared = wgl32.block_form(K, W, ic, C)
        forms = [shared, wgl32.Form("global", shared.threads),
                 wgl32.Form("global", wgl32.MAX_THREADS)]
        times, r, _ = form_turns(
            lambda c, f: wgl32.launch_batched(
                "wgl32_chunk_batched", consts, c, K=K, W=W, L=1, ic=ic, H=H,
                B=B, rounds=rounds, probes=probes, form=f), start, forms)
        print(f"  {what} ({consts.lanes} lanes, K {K}, {r} rounds at most): "
              + "; ".join(f"{k} {[round(x, 4) for x in v]} ms"
                          for k, v in times.items()), flush=True)

    def plan_of(hists, chunk):
        encs = [encode.encode(cas_register(), x) for x in hists]
        batch = batched.encode_batch(encs)
        plan = batched.vmap_plan(batch, max(e.window_raw for e in encs),
                                 chunk)
        return encs, batch, plan

    # the host phases of a fan-out check, each timed by wrapping the
    # function the check calls by module attribute
    phases = {"lint": (independent, "_gate"),
              "split": (independent, "subhistories"),
              "encode": (batched, "encode"),
              "batch": (batched, "encode_batch"),
              "consts": (batched, "batch_consts"),
              "carry": (wgl32, "init_carry_batch")}

    def drive(fn):
        """One main-path call with every count at 0 just before it and
        read just after: (result, wall, counts, Timed, host seconds by
        phase, the peak bytes the call allocated over its baseline). The
        Timed's `gates` is the call's own admission report (`GateLog`)."""
        host = dict.fromkeys(phases, 0.0)
        originals = {k: getattr(m, a) for k, (m, a) in phases.items()}

        def timed(k):
            def run(*a, **kw):
                t0 = time.monotonic()
                try:
                    return originals[k](*a, **kw)
                finally:
                    host[k] += time.monotonic() - t0
            return run

        # a mesh run's pool restock fills off-thread: outside this window
        from jepsen_tpu_torch.parallel import mesh as _mesh
        _mesh.pool_settle()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with Timed() as t:
            for k, (m, a) in phases.items():
                setattr(m, a, timed(k))
            try:
                zero_counts()
                t0 = time.monotonic()
                with GateLog() as t.gates:
                    res = fn()
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                counts = read_counts()
            finally:
                for k, (m, a) in phases.items():
                    setattr(m, a, originals[k])
        return (res, wall, counts, t, host,
                torch.cuda.max_memory_allocated(dev) - before)

    def split_line(wall, host, kernel_ms):
        rest = wall - sum(host.values()) - sum(kernel_ms) / 1e3
        return (", ".join(f"{k} {v:.4f} s" for k, v in host.items())
                + f", kernels {sum(kernel_ms) / 1e3:.4f} s, the rest "
                f"(strip, poll loop, results, copies) {rest:.4f} s")

    # ---- narrow lanes: the main path's own batch and capacities ----------
    t0 = time.monotonic()
    key_ops: dict = {}
    h = multikey_history(**FANOUT, cache=key_ops)
    gen_s = time.monotonic() - t0
    subs = independent.subhistories(h, independent.history_keys(h))
    encs, batch, plan = plan_of([strip_nemesis(sub) for sub in subs], 1024)
    print(f"fan-out {FANOUT}: {len(h)} ops generated in {gen_s:.2f} s; "
          f"vmap plan {json.dumps(plan)}, n_pad {batch.n_pad}, window "
          f"{max(e.window_raw for e in encs)}, n_info max "
          f"{int(batch.n_info.max())}, S x O {batch.table_s} x "
          f"{batch.table_o}", flush=True)
    if plan["L"] or plan["K"] != 64 or batch.inv.shape[0] != FANOUT["n_keys"]:
        raise AssertionError(f"fan-out plan {plan}")
    kw = dict(K=plan["K"], W=plan["W"], ic=plan["ic"], H=plan["H"],
              B=plan["B"], probes=plan["probes"])
    C = wgl32.row_words(plan["ic"])
    consts = batched.batch_consts(batch, plan, 50_000_000, dev)
    start = wgl32.init_carry_batch(batch.inv.shape[0], plan["K"], C,
                                   plan["H"], plan["B"], 0, dev)
    tally: dict = {}
    short, _, n_plain_ms, n_err = kernel_vs_plain(
        wgl32, consts, tuple(t.clone() for t in start), tally=tally,
        chunk=FANOUT_SHORT, **kw)
    n_ms, n_times = kernel_ms(wgl32, consts, start, chunk=FANOUT_SHORT, **kw)
    n_bytes = occupancy.batched_chunk_bytes(short[:, :11].tolist(), C, tally,
                                            short.shape[0], short.numel())
    n_bound_ms = n_bytes / card_peak("hbm_bytes_per_s") * 1e3
    print(f"  wgl32_chunk_batched == chunk_batched_ref over {FANOUT_SHORT} "
          f"rounds of all {batch.inv.shape[0]} lanes: kernel "
          f"{[round(x, 4) for x in n_times]} ms, median {n_ms:.4f} ms, "
          f"plain {n_plain_ms:.1f} ms; bound {n_bytes} bytes "
          f"({tally['const_bytes']} of consts reached, "
          f"{int(short[:, 4].sum())} configs expanded, {tally['probed']} "
          f"successors probed, {int(short[:, 8].sum())} new) over 3.35 TB/s "
          f"= {n_bound_ms:.6f} ms", flush=True)
    idx = list(range(FANOUT_FULL_LANES))
    sub_c, sub_start = lanes_of(consts, start, idx)
    full, f_ms, f_plain_ms, err = kernel_vs_plain(wgl32, sub_c, sub_start,
                                                  chunk=1024, **kw)
    n_err = max(n_err, err)
    print(f"  == over a full 1024-round chunk of lanes {idx}: "
          f"{full[:, 9].tolist()} rounds, kernel {f_ms:.3f} ms, plain "
          f"{f_plain_ms:.1f} ms", flush=True)
    poll_ms, poll_times = kernel_ms(wgl32, consts, start, chunk=1024, **kw)
    print(f"  first poll of the main path (1024 rounds, all lanes, "
          f"{form_label(wgl32.block_form(plan['K'], plan['W'], plan['ic'], C))}"
          f"): {[round(x, 3) for x in poll_times]} ms, median "
          f"{poll_ms:.3f} ms", flush=True)
    batched_forms(consts, start, 1024, "vmap first poll", **kw)
    del start, sub_start

    # ---- wide lanes -------------------------------------------------------
    w = FANOUT_WAVE
    waves = [synth.adversarial_wave_history(w["n_waves"], width=w["width"],
                                            span=w["span"], seed=s)
             for s in range(w["n_keys"])]
    _, wbatch, wplan = plan_of(waves, w["chunk"])
    print(f"fan-out waves {w}: vmap plan {json.dumps(wplan)}", flush=True)
    if not wplan["L"]:
        raise AssertionError(f"waves plan {wplan}")
    wkw = dict(K=wplan["K"], L=wplan["L"], ic=wplan["ic"], H=wplan["H"],
               B=wplan["B"], probes=wplan["probes"], chunk=wplan["chunk"])
    wC = wgln.row_words(wplan["L"], wplan["ic"])
    wconsts = batched.batch_consts(wbatch, wplan, 50_000_000, dev)
    wstart = wgln.init_carry_batch(w["n_keys"], wplan["K"], wplan["L"],
                                   wplan["ic"], wplan["H"], wplan["B"], 0,
                                   dev)
    wtally: dict = {}
    carry = tuple(t.clone() for t in wstart)
    wsum, _, w_plain_ms, w_err = kernel_vs_plain(wgln, wconsts, carry,
                                                 tally=wtally, **wkw)
    wsum2, _, _, err = kernel_vs_plain(wgln, wconsts, carry, **wkw)
    w_err = max(w_err, err)
    w_ms, w_times = kernel_ms(wgln, wconsts, wstart, **wkw)
    w_bytes = occupancy.batched_chunk_bytes(wsum[:, :11].tolist(), wC,
                                            wtally, wsum.shape[0],
                                            wsum.numel())
    w_bound_ms = w_bytes / card_peak("hbm_bytes_per_s") * 1e3
    print(f"  wgln_chunk_batched == chunk_batched_ref over two polls of all "
          f"{w['n_keys']} lanes ({wsum[:, 9].tolist()} then "
          f"{wsum2[:, 9].tolist()} rounds); first poll kernel "
          f"{[round(x, 3) for x in w_times]} ms, median {w_ms:.3f} ms, plain "
          f"{w_plain_ms:.1f} ms; bound {w_bytes} bytes "
          f"({wtally['const_bytes']} of consts reached, "
          f"{int(wsum[:, 4].sum())} configs expanded, {wtally['probed']} "
          f"successors probed, {int(wsum[:, 8].sum())} new) = "
          f"{w_bound_ms:.6f} ms", flush=True)
    del wstart, carry

    # ---- main path, narrow: 100 keys through independent.cuda_checker ----
    res, wall, counts, t, host, peak = drive(
        lambda: independent.cuda_checker(cas_register()).check({}, h, {}))
    k_ms = t.ms("wgl32_chunk_batched")
    per_key = res["results"].values()
    rounds = [r["util"]["rounds"] for r in per_key]
    n_launches = counts["wgl32_chunk_batched"]
    print(f"main path, fan-out {FANOUT['n_keys']} keys x {FANOUT['n_ops']} "
          f"ops: valid? {res['valid?']} "
          f"({sum(r['valid?'] is True for r in per_key)} keys True) wall "
          f"{wall:.4f} s: {split_line(wall, host, k_ms)}; {n_launches} polls, "
          f"each one launch: {[round(x, 2) for x in k_ms]} ms; launches "
          f"{counts}; rounds per lane max {max(rounds)} min {min(rounds)}; "
          f"configs {sum(r['configs_explored'] for r in per_key)}; peak "
          f"memory {peak} B; forms {t.form_counts('wgl32_chunk_batched')}",
          flush=True)
    Peaks.add("fan-out vmap 100 x 2k", t.gates, peak)
    if (res["valid?"] is not True or n_launches < 1
            or len(res["results"]) != FANOUT["n_keys"]
            or any(r.get("engine") for r in res["results"].values())):
        raise AssertionError(f"fan-out: {res['valid?']}, {counts}")
    main_launches = n_launches
    vmap_verdicts = {k: r["valid?"] for k, r in res["results"].items()}

    bad = FANOUT_BAD
    hb = multikey_history(**FANOUT, lie_keys=bad["keys"], lie_p=bad["lie_p"],
                          cache=key_ops)
    res, wall, counts, t, host, _ = drive(
        lambda: independent.cuda_checker(cas_register()).check({}, hb, {}))
    bsubs = independent.subhistories(hb, independent.history_keys(hb))
    t0 = time.monotonic()
    workers = min(8, os.cpu_count() or 1)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as ex:
        oracle = list(ex.map(oracle_verdict,
                             [[o.to_dict() for o in sub] for sub in bsubs]))
    oracle_s = time.monotonic() - t0
    want = [k for k, v in zip(independent.history_keys(hb), oracle)
            if v is False]
    print(f"main path, fan-out with keys {bad['keys']} at lie_p "
          f"{bad['lie_p']}: valid? {res['valid?']} failures "
          f"{res['failures']} wall {wall:.4f} s "
          f"({split_line(wall, host, t.ms('wgl32_chunk_batched'))}; "
          f"{counts}); host oracle "
          f"failures {want} ({oracle_s:.1f} s on {workers} processes)",
          flush=True)
    if res["valid?"] is not False or sorted(res["failures"]) != want \
            or not want:
        raise AssertionError(f"fan-out invalid: {res['failures']} != {want}")
    MAIN_VERDICTS["fan-out invalid failures"] = want
    MAIN_HISTORIES["fan-out invalid"] = hb

    # ---- main path, wide --------------------------------------------------
    res, wall, counts, t, host, peak = drive(lambda: batched.check_batched(
        cas_register(), waves, strategy="vmap", oracle_fallback=False,
        chunk=w["chunk"]))
    wk_ms = t.ms("wgln_chunk_batched")
    got = [r["configs_explored"] for r in res]
    w_launches = counts["wgln_chunk_batched"]
    print(f"main path, wide fan-out: verdicts {[r['valid?'] for r in res]} "
          f"wall {wall:.4f} s ({split_line(wall, host, wk_ms)}; "
          f"{w_launches} polls: {[round(x, 2) for x in wk_ms]} ms, forms "
          f"{t.form_counts('wgln_chunk_batched')}), rounds "
          f"{[r['util']['rounds'] for r in res]}, configs {got} (JAX "
          f"package: {FANOUT_WAVE_CONFIGS}), launches {counts}, peak memory "
          f"{peak} B", flush=True)
    if (any(r["valid?"] is not False for r in res) or w_launches < 1
            or got != FANOUT_WAVE_CONFIGS):
        raise AssertionError(f"wide fan-out: {got}")

    # ---- stream: fewer than 4 keys stream on the card -----------------------
    # each engine of the per-key race is timed to its end by wrapping the
    # function the race calls: a key's race ends when the loser, stopped
    # at its next poll, has been joined
    few = [strip_nemesis(sub) for sub in subs[:FANOUT_STREAM_KEYS]]
    ends: list = []
    engines = {"device": (wgl, "check"), "oracle": (wgl_ref, "check")}
    originals = {k: getattr(m, a) for k, (m, a) in engines.items()}

    def ended(name):
        def run(*a, **kw):
            r = originals[name](*a, **kw)
            ends.append((name, time.monotonic(), r.get("valid?"),
                         r.get("cause"), r.get("configs_explored")))
            return r
        return run

    for k, (m, a) in engines.items():
        setattr(m, a, ended(k))
    try:
        t_race = time.monotonic()
        res, wall, counts, _, _, _ = drive(lambda: batched.check_batched(
            cas_register(), few))
    finally:
        for k, (m, a) in engines.items():
            setattr(m, a, originals[k])
    print(f"stream, {FANOUT_STREAM_KEYS} keys through check_batched auto: "
          f"verdicts {[r['valid?'] for r in res]} engines "
          f"{[r['shard']['engine'] for r in res]} wall {wall:.4f} s, "
          f"per key {[r['shard']['wall_s'] for r in res]} s, launches "
          f"{counts}", flush=True)
    print("  engine ends (name, s since the call, verdict, cause, configs): "
          + json.dumps([(n, round(t - t_race, 4), v, c, x)
                        for n, t, v, c, x in ends]), flush=True)
    joins = [round(t1 - t0, 4) for (n0, t0, *_), (n1, t1, *_)
             in zip(ends[::2], ends[1::2])]
    print(f"  per key, loser's end after the winner's verdict: {joins} s",
          flush=True)
    if (any(r["valid?"] is not True for r in res)
            or counts["wgl32_chunk"] < 1 or counts["wgl32_chunk_batched"]):
        raise AssertionError(f"stream: {counts}")
    # the same keys without the race against the host oracle
    res, wall, counts, t, _, _ = drive(lambda: batched.check_batched(
        cas_register(), few, strategy="stream", oracle_fallback=False))
    print(f"  the same without the race (oracle_fallback=False): verdicts "
          f"{[r['valid?'] for r in res]} wall {wall:.4f} s, kernels "
          f"{sum(t.ms('wgl32_chunk')) / 1e3:.4f} s, per key "
          f"{[r['shard']['wall_s'] for r in res]} s, launches {counts}",
          flush=True)
    if any(r["valid?"] is not True for r in res):
        raise AssertionError("stream without the race")
    # what the shared shape bucket costs on the card: the keys padded
    # into it (as the stream without the race runs them) against each on
    # its own plan
    fencs = [encode.encode(cas_register(), x) for x in few]
    bucket = batched.shared_shape_bucket(fencs)
    for name, sb in (("shared bucket", bucket), ("own plans", None)):
        res, wall, counts, t, _, _ = drive(lambda: [wgl.check(
            cas_register(), x, enc=e, shape_bucket=sb, device=dev)
            for x, e in zip(few, fencs)])
        if any(r["valid?"] is not True for r in res):
            raise AssertionError(f"stream keys on {name}")
        print(f"  {name}: W_pad {[r['W_pad'] for r in res]}, rounds "
              f"{[r['util']['rounds'] for r in res]}, configs "
              f"{[r['configs_explored'] for r in res]}, kernels "
              f"{sum(t.ms('wgl32_chunk')):.4f} ms in {counts['wgl32_chunk']} "
              f"launches, wall {wall:.4f} s", flush=True)

    # ---- the several-devices paths: every shard on this card ---------------
    from jepsen_tpu_torch.parallel import mesh
    print(f"several-devices paths: {MESH_SHARDS} shards and more, all on "
          f"the one card ({card_line()}), each shard on its own stream; no "
          "cross-card copy runs here", flush=True)
    lanes = lane_kernel_checks(dev, plan, wplan)
    cards = [dev] * MESH_SHARDS
    phases["shard consts"] = (mesh._GroupRun, "shard_consts")
    res, wall, counts, t, host, peak = drive(
        lambda: independent.cuda_checker(cas_register(),
                                         devices=cards).check({}, h, {}))
    summ = mesh.last_summary()
    per_key = res["results"]
    MAIN_VERDICTS["mesh"] = {str(k): r["valid?"] for k, r in per_key.items()}
    k_ms = {k: t.ms(k) for k in ("wgl32_chunk_batched", "wgl_lane_reset",
                                 "wgl_frontier_migrate")}
    kernel_s = [x for v in k_ms.values() for x in v]
    print(f"main path, mesh fan-out {FANOUT['n_keys']} keys x "
          f"{FANOUT['n_ops']} ops over {MESH_SHARDS} shards of the card: "
          f"valid? {res['valid?']} wall {wall:.4f} s: "
          f"{split_line(wall, host, kernel_s)} (kernel time summed over "
          f"the shards' streams); polls {summ['polls']}, refills "
          f"{summ['refills']}, resets {summ['resets']}, rebuckets "
          f"{summ['rebuckets']}, steals {summ['steals']}, K_final "
          f"{[g['K_final'] for g in summ['groups']]}, lanes per shard "
          f"{summ['groups'][0]['lanes_per_device']}, per shard "
          f"{json.dumps(summ['per_shard'])}, events "
          f"{json.dumps(summ['groups'][0]['events'][:8])}; launches "
          f"{counts}; chunk polls (ms) "
          f"{[round(x, 2) for x in k_ms['wgl32_chunk_batched'][:12]]}..., "
          f"resets (ms) {[round(x, 4) for x in k_ms['wgl_lane_reset'][:6]]}"
          f"..., all {len(k_ms['wgl_lane_reset'])} resets summed "
          f"{sum(k_ms['wgl_lane_reset']):.4f} ms, configs {sum(r['configs_explored'] for r in per_key.values())}"
          f"; peak memory {peak} B; summed polls "
          f"{sum(k_ms['wgl32_chunk_batched']):.3f} ms; forms "
          f"{t.form_counts('wgl32_chunk_batched')}", flush=True)
    Peaks.add(f"mesh fan-out {MESH_SHARDS} shards", t.gates, peak)
    verdicts = {k: r["valid?"] for k, r in per_key.items()}
    if (res["valid?"] is not True or verdicts != vmap_verdicts
            or counts["wgl32_chunk_batched"] < 1
            or counts["wgl_lane_reset"] < 1 or summ["refills"] < 1
            or any(r["shard"]["engine"] != "device-mesh"
                   for r in per_key.values())):
        raise AssertionError(f"mesh fan-out: {res['valid?']}, {counts}, "
                             f"{summ['refills']} refills")
    mesh_counts = counts
    # one poll of a shard, for its bound (PERF.md row 10a): 4 lanes (keys
    # 0-3) for 1024 rounds at the mesh's first bucket, the kernel held
    # against its plain version, whose tally counts the traffic
    kp = mesh.kernel_params(batched.shared_shape_bucket(encs),
                            MESH_SHARDS * mesh.lanes_for(len(encs),
                                                         MESH_SHARDS))
    MAIN_BUCKETS["mesh"] = (batched.shared_shape_bucket(encs), len(encs))
    mkw = dict(K=kp["ladder"][0], W=kp["W"], ic=kp["ic_pad"], H=kp["H"],
               B=kp["B"], probes=kp["probes"])
    mC = wgl32.row_words(mkw["ic"])
    mconsts = batched.batch_consts(batch, mkw, 50_000_000, dev, slice(0, 4))
    mtally: dict = {}
    msum, m_ms, m_plain_ms, err = kernel_vs_plain(
        wgl32, mconsts, wgl32.init_carry_batch(4, mkw["K"], mC, mkw["H"],
                                               mkw["B"], 0, dev),
        tally=mtally, chunk=kp["chunk"], **mkw)
    n_err = max(n_err, err)
    m_bytes = occupancy.batched_chunk_bytes(msum[:, :11].tolist(), mC, mtally,
                                            4, msum.numel())
    print(f"  one mesh poll (4 lanes, keys 0-3, {kp['chunk']} rounds at the "
          f"first bucket {json.dumps(mkw)}): wgl32_chunk_batched == "
          f"chunk_batched_ref, {msum[:, 9].tolist()} rounds, kernel "
          f"{m_ms:.3f} ms, plain {m_plain_ms:.1f} ms; bound {m_bytes} bytes "
          f"({mtally['const_bytes']} of consts reached, "
          f"{int(msum[:, 4].sum())} configs expanded, {mtally['probed']} "
          f"probed, {int(msum[:, 8].sum())} new) = "
          f"{m_bytes / card_peak('hbm_bytes_per_s') * 1e3:.6f} ms",
          flush=True)
    for K in (mkw["K"], kp["ladder"][-1]):
        batched_forms(mconsts, wgl32.init_carry_batch(
            4, K, mC, mkw["H"], mkw["B"], 0, dev), kp["chunk"],
            "mesh poll", **dict(mkw, K=K))
    res, wall, counts, t, host, _ = drive(
        lambda: independent.cuda_checker(cas_register(),
                                         devices=cards).check({}, hb, {}))
    summ = mesh.last_summary()
    print(f"main path, mesh fan-out with keys {bad['keys']} at lie_p "
          f"{bad['lie_p']}: valid? {res['valid?']} failures "
          f"{sorted(res['failures'])} (host oracle {want}) wall {wall:.4f} s "
          f"({split_line(wall, host, t.ms('wgl32_chunk_batched'))}); polls "
          f"{summ['polls']}, refills {summ['refills']}, rebuckets "
          f"{summ['rebuckets']}, steals {summ['steals']}; launches {counts}",
          flush=True)
    if res["valid?"] is not False or sorted(res["failures"]) != want:
        raise AssertionError(f"mesh fan-out invalid: {res['failures']} != "
                             f"{want}")

    # wave keys through check_mesh, block queues: shard 0 gets the valid
    # keys (one poll each), shard 1 the invalid ones (exhausted in ~180
    # rounds), so shard 0 idles while shard 1 still queues two
    mw = MESH_WAVE
    mwaves = [synth.adversarial_wave_history(
        w["n_waves"], width=w["width"], span=w["span"], seed=s,
        invalid=s >= mw["n_valid"]) for s in range(mw["n_keys"])]
    mencs = [encode.encode(cas_register(), x) for x in mwaves]
    res, wall, counts, t, _, peak = drive(lambda: mesh.check_mesh(
        cas_register(), mwaves, encs=mencs, devices=cards, assign="block",
        lanes_per_device=mw["lanes_per_device"], oracle_fallback=False))
    summ = mesh.last_summary()
    vm = batched.check_batched(cas_register(), mwaves, strategy="vmap",
                               oracle_fallback=False, chunk=w["chunk"],
                               devices=[dev])
    idle = [e for g in summ["groups"] for e in g["events"]
            if e.get("reason") == "idle"]
    print(f"main path, mesh waves {mw}: verdicts {[r['valid?'] for r in res]}"
          f" (vmap path {[r['valid?'] for r in vm]}), wall {wall:.4f} s, "
          f"polls {summ['polls']}, refills {summ['refills']}, rebuckets "
          f"{summ['rebuckets']}, steals {summ['steals']}, K_final "
          f"{[g['K_final'] for g in summ['groups']]}, events "
          f"{json.dumps(summ['groups'][0]['events'])}, rounds "
          f"{[r['util']['rounds'] for r in res]}, configs "
          f"{[r['configs_explored'] for r in res]}, shards "
          f"{[r['mesh']['shard'] for r in res]}; launches {counts}; "
          f"chunk polls (ms) "
          f"{[round(x, 2) for x in t.ms('wgln_chunk_batched')]}; peak memory "
          f"{peak} B; forms {t.form_counts('wgln_chunk_batched')}", flush=True)
    if ([r["valid?"] for r in res] != [r["valid?"] for r in vm]
            or not idle or counts["wgln_chunk_batched"] < 1
            or counts["wgl_lane_reset"] < 1):
        raise AssertionError(f"mesh waves: {counts}, idle pulls {idle}")
    wave_counts = counts

    # the stream keys over two shards of the card: one worker a shard
    res, wall, counts, _, _, _ = drive(lambda: batched.check_batched(
        cas_register(), few, devices=cards))
    print(f"stream over {MESH_SHARDS} shards of the card: verdicts "
          f"{[r['valid?'] for r in res]} engines "
          f"{[r['shard']['engine'] for r in res]} shards "
          f"{[r['shard']['device'] for r in res]} wall {wall:.4f} s, per key "
          f"{[r['shard']['wall_s'] for r in res]} s, launches {counts}",
          flush=True)
    if (any(r["valid?"] is not True for r in res)
            or counts["wgl32_chunk"] < 1
            or len({r["shard"]["device"] for r in res}) < 2):
        raise AssertionError(f"stream over shards: {counts}")

    lanes[0]["launches"] = mesh_counts["wgl_lane_reset"]
    # the ladder switch's migration: the fan-out's run when it switched,
    # else the waves'
    lanes[1]["launches"] = (mesh_counts["wgl_frontier_migrate"]
                            or wave_counts["wgl_frontier_migrate"])
    if lanes[1]["launches"] < 1:
        raise AssertionError("no ladder switch: wgl_frontier_migrate never "
                             "ran on a main path")
    return [{
        "name": "wgl32_chunk_batched", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/wgl32_chunk.cu",
        "replaces": "jepsen_tpu/parallel/batched.py:234",
        "launches": main_launches, "max_abs_err": n_err, "ms": n_ms,
        "plain_ms": n_plain_ms, "bound_ms": n_bound_ms, "bound_by": "bytes",
        "library_ms": None}, {
        "name": "wgln_chunk_batched", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/wgln_chunk.cu",
        "replaces": "jepsen_tpu/parallel/batched.py:234",
        "launches": w_launches, "max_abs_err": w_err, "ms": w_ms,
        "plain_ms": w_plain_ms, "bound_ms": w_bound_ms, "bound_by": "bytes",
        "library_ms": None}] + lanes


def bool_consts(hist, dev):
    """The bool-window chunk's encoding of `hist` and its consts on the
    card (max_cfg 2e8)."""
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import encode, wgl_bool

    enc = encode.encode(cas_register(), hist)
    return enc, wgl_bool.consts_from_numpy(
        enc.inv, enc.ret, enc.opcode, enc.sufminret, enc.inv_info,
        enc.opcode_info, enc.table, enc.n_ok, enc.n_info, 200_000_000,
        device=dev)


def bool_first_bucket(enc) -> dict:
    """derive_plan's first bucket, at the bool kernel's widths (the
    encoding's window and info slots, padded to 32)."""
    from jepsen_tpu_torch.ops import wgl

    p = wgl.derive_plan(window_raw=enc.window_raw,
                        ic_pad=len(enc.inv_info), n=enc.n_ok,
                        n_info=enc.n_info, accel=True)
    return {"K": p["K"], "H": p["H"], "B": p["B"], "chunk": p["chunk"],
            "probes": p["probes"], "W": enc.window,
            "ic": len(enc.inv_info)}


def bool_shape(enc, K, H, B, chunk, probes=4) -> tuple:
    """`ops/wgl._compiled_search`'s shape arguments."""
    S, O = enc.table.shape
    return (len(enc.inv), len(enc.inv_info), enc.window, S, O, K, H, B,
            chunk, probes)


def drive_bool(enc, consts, dev, max_chunks=64):
    """The bool-window search through `ops/wgl._compiled_search` at
    derive_plan's first bucket, chunk after chunk until it is found or
    the frontier empties: (the bucket, the final carry, the chunks)."""
    from jepsen_tpu_torch.ops import wgl, wgl_bool

    fb = bool_first_bucket(enc)
    init_fn, chunk_fn = wgl._compiled_search(*bool_shape(
        enc, fb["K"], fb["H"], fb["B"], fb["chunk"], fb["probes"]))
    carry = init_fn(0, device=dev)
    for chunks in range(1, max_chunks + 1):
        chunk_fn(consts, carry)
        if carry[wgl_bool.FLAGS].tolist()[0] or int(
                carry[wgl_bool.FR_CNT]) == 0:
            break
    return fb, carry, chunks


def barrier_step_us(dev, iters: int = 100_000) -> float:
    """One barrier-and-reduce step of a 1024-thread block, in µs: the
    probe `elle_trim_step_probe` (a warp sum, the partials in shared
    memory, a barrier, every warp summing them) at iters + 1 steps less
    at 1 step, over iters, CUDA events, the least of three each after a
    warm launch. A dependent chain of n peels or rounds takes at least n
    such steps: its floor, printed beside a bound, never in it."""
    from jepsen_tpu_torch.ops import _native
    from jepsen_tpu_torch.util import raw_stream

    sink = torch.zeros(1, dtype=torch.int32, device=dev)

    def ms(n):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        _native.launch("elle_trim_step_probe", [sink.data_ptr()], [n],
                       raw_stream(dev))
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    ms(1)
    step = (min(ms(iters + 1) for _ in range(3))
            - min(ms(1) for _ in range(3))) * 1e3 / iters
    print(f"barrier-and-reduce step (elle_trim_step_probe, 1024 threads): "
          f"{step:.4f} us", flush=True)
    return step


def bool_encs(dev) -> dict:
    """The bool-window chunk's consts on the card for BOOL_CHECKS: the
    headline, the invalid narrow history, the 16-wave."""
    from jepsen_tpu_torch import synth

    h = synth.cas_register_history(HEADLINE["n_ops"],
                                   n_procs=HEADLINE["n_procs"],
                                   seed=HEADLINE["seed"],
                                   crash_p=HEADLINE["crash_p"])
    bad = synth.cas_register_history(INVALID["n_ops"],
                                     n_procs=INVALID["n_procs"],
                                     seed=INVALID["seed"],
                                     lie_p=INVALID["lie_p"])
    return {"headline": bool_consts(h, dev), "invalid": bool_consts(bad, dev),
            "16-wave": bool_consts(synth.adversarial_wave_history(
                WAVE["n_waves"], width=WAVE["width"], span=WAVE["span"],
                seed=WAVE["seed"]), dev)}


def chunk_variants(defines) -> dict:
    """`csrc/wgl_chunk.cu` built once for each define (a form switched
    off), every nvcc started together, each library named after the
    default's (so an edited source rebuilds it) and bound as `_native`
    binds the default: {define: binding}."""
    import ctypes

    from jepsen_tpu_torch.ops import _native

    src = _native.CSRC / "wgl_chunk.cu"
    base = _native._lib_path(src)
    _, _, n_ptrs, n_ints = _native._lib("wgl_chunk")
    running = {}
    for d in defines:
        lib = base.with_name(f"{base.stem}-{d.split('=')[0].lower()}.so")
        proc = None if lib.exists() else subprocess.Popen(
            [_native._nvcc(), *_native.ARCH_FLAGS, *_native.NVCC_FLAGS,
             f"-D{d}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[d] = (lib, proc)
    out = {}
    for d, (lib, proc) in running.items():
        if proc is not None:
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc -D{d} wgl_chunk.cu: {err}")
        so = ctypes.CDLL(str(lib))
        fn = so.wgl_chunk
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        es = so.wgl_chunk_error_string
        es.argtypes, es.restype = [ctypes.c_int], ctypes.c_char_p
        out[d] = (fn, es, n_ptrs, n_ints)
    return out


def chunk_form_turns(dev, encs) -> dict:
    """Each of `wgl_chunk`'s switchable forms (CHUNK_FORMS) against the
    default build on the same inputs, in turns default / off / off /
    default, each turn the median of 3 launches from the search's start
    (CUDA events), every launch's carry identical to the default's:
    {(label, BOOL_CHECKS row): [ms of each turn]}."""
    from jepsen_tpu_torch.ops import _native, wgl, wgl_bool

    variants = chunk_variants([d for d, _ in CHUNK_FORMS.values()])
    default = _native._lib("wgl_chunk")
    out = {}
    for label, (define, rows) in CHUNK_FORMS.items():
        for i in rows:
            name, K, H, B, rounds = BOOL_CHECKS[i]
            enc, consts = encs[name]
            fb = bool_first_bucket(enc)
            K, H, B = K or fb["K"], H or fb["H"], B or fb["B"]
            rounds = rounds or fb["chunk"]
            init_fn, chunk_k = wgl._compiled_search(*bool_shape(
                enc, K, H, B, rounds, fb["probes"]))
            start = init_fn(0, device=dev)
            want, turns = None, []
            for off in (False, True, True, False):
                times = []
                _native._LIBS["wgl_chunk"] = variants[define] if off \
                    else default
                try:
                    for _ in range(3):
                        c = tuple(t.clone() for t in start)
                        torch.cuda.synchronize()
                        e0, e1 = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                        e0.record()
                        chunk_k(consts, c)
                        e1.record()
                        torch.cuda.synchronize()
                        times.append(e0.elapsed_time(e1))
                        if want is None:
                            want = c
                        elif not same_carry(c, want):
                            raise AssertionError(
                                f"wgl_chunk with {define}: the carry "
                                f"differs from the default build's on "
                                f"{name} K {K}")
                finally:
                    _native._LIBS["wgl_chunk"] = default
                turns.append(float(np.median(times)))
            n = max(int(want[wgl_bool.STATS][1]), 1)
            print(f"wgl_chunk forms in turns, {name} K {K} H {H} B {B}, "
                  f"{n} rounds: default / {label} / {label} / default "
                  f"{' / '.join(f'{x:.4f}' for x in turns)} ms = "
                  f"{' / '.join(f'{x * 1e3 / n:.2f}' for x in turns)} "
                  f"us/round; carries identical", flush=True)
            out[label, i] = turns
            del start, want
    return out


def bool_chunk_phases(dev, step_us: float) -> dict:
    """The bool-window chunk (`wgl_chunk`) on the card: held against its
    plain version (`wgl_bool.chunk_ref`) bit for bit on every carry leaf
    at BOOL_CHECKS, each from the search's start (the first two are the
    main path's first launch, whose times make the kernels line's row);
    then driven to a verdict through `ops/wgl._compiled_search` at
    `derive_plan`'s first bucket on the headline (True, beside the wgl32
    check's verdict) and the invalid narrow history (the host oracle's
    False), every count at 0 just before each drive. Returns its entry of
    the kernels line."""
    from jepsen_tpu_torch import occupancy, synth
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import wgl, wgl_bool, wgl_ref

    h = synth.cas_register_history(HEADLINE["n_ops"],
                                   n_procs=HEADLINE["n_procs"],
                                   seed=HEADLINE["seed"],
                                   crash_p=HEADLINE["crash_p"])
    bad = synth.cas_register_history(INVALID["n_ops"],
                                     n_procs=INVALID["n_procs"],
                                     seed=INVALID["seed"],
                                     lie_p=INVALID["lie_p"])
    encs = bool_encs(dev)
    err = 0
    row = None
    for name, K, H, B, rounds in BOOL_CHECKS:
        enc, consts = encs[name]
        fb = bool_first_bucket(enc)
        K, H, B = K or fb["K"], H or fb["H"], B or fb["B"]
        rounds = rounds or fb["chunk"]
        W, ic = enc.window, len(enc.inv_info)
        init_fn, chunk_k = wgl._compiled_search(*bool_shape(
            enc, K, H, B, rounds, fb["probes"]))
        start = init_fn(0, device=dev)
        carry = tuple(t.clone() for t in start)
        ref = tuple(t.clone() for t in start)
        torch.cuda.synchronize()
        chunk_k(consts, carry)
        torch.cuda.synchronize()
        tally: dict = {}
        t0 = time.monotonic()
        wgl_bool.chunk_ref(consts, ref, K=K, W=W, ic=ic, H=H, B=B,
                           chunk=rounds, probes=fb["probes"], tally=tally)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        e = max_abs_err(carry, ref)
        err = max(err, e)
        if e or not same_carry(carry, ref):
            raise AssertionError(f"wgl_chunk differs from chunk_ref on {name} "
                                 f"K={K} H={H} B={B} (max abs err {e})")
        times = []
        for _ in range(3):
            c = tuple(t.clone() for t in start)
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            chunk_k(consts, c)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
            del c
        k_ms = float(np.median(times))
        stats, flags = carry[wgl_bool.STATS].tolist(), carry[
            wgl_bool.FLAGS].tolist()
        used = int((carry[wgl_bool.TABLE][:, 0] != 0).sum())
        nbytes = occupancy.wgl_bool_chunk_bytes(
            explored=stats[0], new=stats[4], W=W, ic=ic, tally=tally)
        bound, by = occupancy.bound_ms(
            nbytes=nbytes, device_kind=torch.cuda.get_device_name(0))
        print(f"wgl_chunk == chunk_ref on every carry leaf, {name} consts "
              f"(W {W}, ic {ic}), K {K}, H {H}, B {B}, chunk {rounds}: "
              f"{stats[1]} rounds, "
              f"{stats[0]} configs, flags {flags}, backlog "
              f"{int(carry[wgl_bool.BK_CNT])}, table {used}/{H} slots; "
              f"kernel {[round(x, 4) for x in times]} ms, median {k_ms:.4f} "
              f"ms = {k_ms * 1e3 / max(stats[1], 1):.2f} us/round; plain "
              f"{plain_ms:.1f} ms; bound {nbytes} bytes "
              f"({tally['const_bytes']} of consts reached, {stats[0]} rows "
              f"read, {tally['probed']} probed, {stats[4]} new) = "
              f"{bound:.6f} ms; chain floor {stats[1]} rounds x "
              f"{step_us:.4f} us = {stats[1] * step_us / 1e3:.4f} ms",
              flush=True)
        if H < 1 << 12 and not (flags[1] and used == H):
            raise AssertionError(f"wgl_chunk full-table check: overflow "
                                 f"{flags[1]}, table {used}/{H}")
        if row is None:
            row = dict(ms=k_ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=by)
        del start, carry, ref

    chunk_form_turns(dev, encs)

    # ---- driven to a verdict through _compiled_search ---------------------
    def main_bool(name, enc, consts):
        torch.cuda.synchronize()
        with Timed() as t:
            zero_counts()
            t0 = time.monotonic()
            fb, carry, chunks = drive_bool(enc, consts, dev)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = read_counts()
        stats = carry[wgl_bool.STATS].tolist()
        flags = carry[wgl_bool.FLAGS].tolist()
        verdict = (True if flags[0] else "unknown"
                   if flags[1] or int(carry[wgl_bool.FR_CNT]) else False)
        k_ms = sum(t.ms("wgl_chunk"))
        print(f"main path, bool-window chunk, {name}: _compiled_search at "
              f"derive_plan's first bucket {json.dumps(fb)}: verdict "
              f"{verdict}, {stats[5]} rounds, {stats[0]} configs, {chunks} "
              f"chunks, kernel {k_ms:.3f} ms = "
              f"{k_ms * 1e3 / max(stats[5], 1):.2f} us/round (chain floor "
              f"{stats[5]} rounds x {step_us:.4f} us = "
              f"{stats[5] * step_us / 1e3:.3f} ms), wall {wall:.4f} s, "
              f"launches {counts}", flush=True)
        if counts["wgl_chunk"] != chunks:
            raise AssertionError(f"{name}: {counts} for {chunks} chunks")
        return verdict, counts

    enc, consts = encs["headline"]
    verdict, counts = main_bool("headline", enc, consts)
    ref = wgl.check(cas_register(), h, device=dev)
    print(f"  the wgl32 search of the same history: verdict "
          f"{ref['valid?']}, {ref['util']['rounds']} rounds, "
          f"{ref['configs_explored']} configs (the sorted order explores "
          f"other configs)", flush=True)
    if verdict is not True or ref["valid?"] is not True:
        raise AssertionError(f"bool-window headline: {verdict}")
    benc, bconsts = encs["invalid"]
    bverdict, _ = main_bool("invalid narrow history", benc, bconsts)
    want = wgl_ref.check(cas_register(), bad, time_limit=30)["valid?"]
    print(f"  host oracle: {want}", flush=True)
    if bverdict != want or want is not False:
        raise AssertionError(f"bool-window invalid: {bverdict} != {want}")
    return {"name": "wgl_chunk", "route": "cuda",
            "source": "jepsen_tpu_torch/csrc/wgl_chunk.cu",
            "replaces": "jepsen_tpu/ops/wgl.py:300",
            "launches": counts["wgl_chunk"], "max_abs_err": err, **row,
            "library_ms": None}


def planes_phases(dev, lin, hist, peak: int, bill: int) -> None:
    """The telemetry and device planes on the headline (the package's
    `metrics`, `watchdog` and `devices`): the check through `lin` with
    every plane off and with a metrics registry, a watchdog and a device
    monitor on, in turns (off, on, on, off, four times), every verdict
    True.
    Off, the result carries none of the planes' keys and nothing is
    recorded (the zero-cost contract); on, it carries `telemetry`,
    `occupancy` and `hbm`, whose `peak_measured` (the allocator's peak
    inside the search's window) is printed beside the headline's Peaks
    row (`peak`, over the check's baseline) and its gate's bill; no
    stall is declared. Then one `ops/wgl.check` with `profile_dir` under
    build/, whose Chrome trace must hold the chunk kernel's launches."""
    import contextlib
    import shutil

    from jepsen_tpu_torch import devices, metrics, watchdog
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import wgl

    keys = ("telemetry", "occupancy", "hbm")
    for mod in (metrics, watchdog, devices):
        if mod.get_default().enabled:
            raise AssertionError(f"{mod.__name__}: a plane is on by default")
    walls: dict = {"off": [], "on": []}
    on = None
    for which in ("off", "on", "on", "off") * 4:
        with contextlib.ExitStack() as planes:
            reg = wd = None
            if which == "on":
                reg = planes.enter_context(metrics.use(metrics.Registry()))
                wd = watchdog.Watchdog()
                planes.callback(wd.stop)
                planes.enter_context(watchdog.use(wd))
                planes.enter_context(devices.use(devices.DeviceMonitor()))
            torch.cuda.synchronize()
            t0 = time.monotonic()
            res = lin.check({}, hist, {})
            torch.cuda.synchronize()
            walls[which].append(time.monotonic() - t0)
        if res["valid?"] is not True:
            raise AssertionError(f"headline, planes {which}: {res['valid?']}")
        if which == "off" and any(k in res for k in keys):
            raise AssertionError(f"headline, planes off: {sorted(res)}")
        if which == "on":
            hbm = res.get("hbm") or {}
            if (not all(k in res for k in keys) or wd.stalls
                    or not hbm.get("stats_available")
                    or not hbm.get("peak_measured")
                    or hbm["peak_measured"] < peak
                    or not reg.series("wgl_chunks").points):
                raise AssertionError(f"headline, planes on: {sorted(res)}, "
                                     f"hbm {hbm}, stalls {wd.stalls}")
            on = (res, reg)
    off_s, on_s = (float(np.median(walls[k])) for k in ("off", "on"))
    res, reg = on
    occ = res["occupancy"]
    print(f"planes on the headline ({card_line()}), in turns off / on / on "
          f"/ off, four times: walls off {[round(x, 4) for x in walls['off']]} s, "
          f"on {[round(x, 4) for x in walls['on']]} s; medians off "
          f"{off_s:.4f} s, on {on_s:.4f} s, the planes' cost "
          f"{on_s - off_s:+.4f} s ({(on_s / off_s - 1) * 100:+.1f}%); on: "
          f"{len(res['telemetry']['chunks'])} chunk points, "
          f"{occ['rounds_seen']} of {occ['rounds_total']} rounds drained "
          f"({occ['rounds_dropped']} dropped past the ring), "
          f"{len(reg.instruments())} instruments, roofline "
          f"{occ['roofline']['bytes_per_round']:.1f} B a round "
          f"(achieved {occ['roofline']['achieved_frac']}); hbm "
          f"peak_measured {res['hbm']['peak_measured']} B (the allocator's "
          f"peak in the search's window, bytes in use), Peaks row "
          f"{peak} B over the check's baseline, preflight's bill {bill} B",
          flush=True)
    pdir = REPO / "build" / "torch_kernels" / "profile"
    shutil.rmtree(pdir, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = wgl.check(cas_register(), hist, device=dev, profile_dir=str(pdir))
    wall = time.monotonic() - t0
    traces = sorted(pdir.glob("*.json"))
    if res["valid?"] is not True or res.get("profile_dir") != str(pdir) \
            or len(traces) != 1:
        raise AssertionError(f"profiled headline: {res.get('profile_dir')}, "
                             f"{traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"
            and "chunk" in str(e.get("name"))]
    if not kern:
        raise AssertionError(f"profiled headline: no chunk kernel among "
                             f"{len(events)} trace events")
    print(f"profiled headline: wall {wall:.4f} s (search {res['wall_s']} "
          f"s), trace {traces[0].relative_to(REPO)} "
          f"({traces[0].stat().st_size} B, {len(events)} events, "
          f"{len(kern)} chunk kernels, "
          f"{sum(e.get('dur', 0) for e in kern) / 1e3:.3f} ms of them)",
          flush=True)


def preflight_phases(dev) -> None:
    """The admission plane on the card: every main path's predicted bytes
    against its measured peak (`Peaks`), a rejection under a small
    budget (no launch, no byte), a 100k forced bf16 closure rejected,
    and the CLI's `--headline --execute` parity block."""
    import contextlib
    import io
    import os

    from jepsen_tpu_torch import __main__ as cli
    from jepsen_tpu_torch import checker, synth
    from jepsen_tpu_torch.analysis import preflight
    from jepsen_tpu_torch.elle import append
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import check_batched

    print("preflight, predicted bytes against the peak each main path "
          "allocated on the card over its baseline:", flush=True)
    for shape, verdict, predicted, measured in Peaks.rows:
        print(f"  {shape}: {verdict}, predicted {predicted} B, measured "
              f"{measured} B, ratio {predicted / max(measured, 1):.4f}",
              flush=True)
    short = [r for r in Peaks.rows if r[3] > r[2] or r[1] == "infeasible"]
    if short or len(Peaks.rows) < 11:
        raise AssertionError(f"preflight under-billed or rejected: {short} "
                             f"({len(Peaks.rows)} shapes)")

    h = synth.cas_register_history(HEADLINE["n_ops"],
                                   n_procs=HEADLINE["n_procs"],
                                   seed=HEADLINE["seed"],
                                   crash_p=HEADLINE["crash_p"])
    keys = [synth.cas_register_history(200, n_procs=4, seed=s)
            for s in range(4)]
    a3 = synth.list_append_history(**ELLE_3K)
    os.environ["JEPSEN_TPU_PREFLIGHT_MEM_BUDGET"] = str(SMALL_BUDGET)
    try:
        for name, fn in (
                ("checker cuda-wgl", lambda: checker.linearizable(
                    cas_register(), algorithm="cuda-wgl").check({}, h, {})),
                ("fan-out vmap", lambda: check_batched(
                    cas_register(), keys, strategy="vmap",
                    oracle_fallback=False)),
                ("elle append packed", lambda: append.check(
                    a3, additional_graphs=RT, cycle_backend="packed"))):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            zero_counts()
            res = fn()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated(dev)
            counts = read_counts()
            one = res[0] if isinstance(res, list) else res
            cause = one.get("cause") or one.get("anomaly-types")
            rules = (one.get("rules") or [r["rule"] for r in
                                          one["preflight"]["rules"]])
            print(f"preflight rejection under a {SMALL_BUDGET} B budget, "
                  f"{name}: {cause}, rules {rules}, launches "
                  f"{sum(counts.values())}, memory_allocated {before} -> "
                  f"{after} B", flush=True)
            if (cause not in ("preflight", ["preflight"]) or "P001" not in rules
                    or sum(counts.values()) or after != before):
                raise AssertionError(f"preflight rejection {name}: {one}")
    finally:
        del os.environ["JEPSEN_TPU_PREFLIGHT_MEM_BUDGET"]

    rep = preflight.plan_elle(n_txns=100_000, backend="cuda", devices=[dev])
    print(f"preflight plan_elle(100k, backend='cuda'): {rep['verdict']} "
          f"{[r['rule'] for r in rep['rules']]} ({rep['rules'][0]['message']})",
          flush=True)
    if rep["verdict"] != "infeasible" or "P002" not in [
            r["rule"] for r in rep["rules"]]:
        raise AssertionError(f"100k bf16 closure: {rep['verdict']}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["preflight", "--headline", "--execute", "--json"])
    out = json.loads(buf.getvalue())["headline"]
    par = out["executed"]
    print(f"python -m jepsen_tpu_torch preflight --headline --execute: rc "
          f"{rc}, verdict {out['report']['verdict']}, kernel "
          f"{out['report']['kernel']}, buckets {out['report']['buckets']}; "
          f"executed {json.dumps(par)}", flush=True)
    if (rc or par["verdict"] is not True or not par["kernel_match"]
            or not par["buckets_subset"]
            or par["peak_bytes_measured"] > par["peak_bytes_predicted"]):
        raise AssertionError(f"preflight CLI parity: {par}")


WARM_TURNS = 3                          # fresh processes per mode


def zero_round_checks(dev) -> None:
    """The warm plane's zero-round launches against their plain versions,
    at every form its warms launch: each ladder bucket of the headline's
    and the 16-wave's service buckets (`aot.service_ladder`, through
    `wgl32.chunk` / `wgln.chunk`) and of the mesh fan-out's plan (one
    shard's 4 lanes, `wgl32.chunk_batched`); zero consts, a zero config
    budget, a fresh carry; every carry leaf and the summary equal."""
    from jepsen_tpu_torch import service, synth
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import aot, encode, wgl32, wgln
    from jepsen_tpu_torch.parallel import mesh

    def zeros(lanes, n_pad, ic, S, O):
        z = (lambda *sh: np.zeros(sh if lanes is None else (lanes,) + sh,
                                  np.int32))
        make = (wgl32.consts_from_numpy if lanes is None
                else wgl32.batch_consts_from_numpy)
        return make(z(n_pad), z(n_pad), z(n_pad), z(n_pad + 1), z(ic),
                    z(ic), z(S, O), 0, 0, 0, dev)

    def held(what, fn, ref, consts, carry, form, **kw):
        ref_in = tuple(t.clone() for t in carry)
        out, summary = fn(consts, carry, **kw)
        torch.cuda.synchronize()
        want, want_s = ref(consts, ref_in, **kw)
        if not (same_carry(out, want) and torch.equal(summary, want_s)):
            raise AssertionError(f"zero-round {what} K {kw['K']} "
                                 f"({form_label(form)}) differs from its "
                                 "plain version")
        return f"K {kw['K']} {form_label(form)}"

    hists = {"headline": synth.cas_register_history(
        HEADLINE["n_ops"], n_procs=HEADLINE["n_procs"],
        seed=HEADLINE["seed"], crash_p=HEADLINE["crash_p"]),
        "16-wave": synth.adversarial_wave_history(
            WAVE["n_waves"], width=WAVE["width"], span=WAVE["span"],
            seed=WAVE["seed"])}
    for name, hist in hists.items():
        lad = aot.service_ladder(service.bucket_for(
            encode.encode(cas_register(), hist))[1], device=dev)
        n_pad, ic, S, O, L = (lad[k] for k in ("n_pad", "ic_pad", "S", "O",
                                               "L"))
        kw = dict(ic=ic, H=lad["H"], B=lad["B"], chunk=lad["chunk"],
                  probes=lad["probes"])
        done = []
        for K in lad["ladder"]:
            consts = zeros(None, n_pad, ic, S, O)
            if L:
                done.append(held(name, wgln.chunk, wgln.chunk_ref, consts,
                                 wgln.init_carry(K, L, ic, lad["H"],
                                                 lad["B"], 0, dev),
                                 wgln.solo_form(K, L, ic), K=K, L=L, **kw))
            else:
                C = wgl32.row_words(ic)
                done.append(held(name, wgl32.chunk, wgl32.chunk_ref, consts,
                                 wgl32.init_carry(K, C, lad["H"], lad["B"],
                                                  0, dev),
                                 wgl32.block_form(K, lad["W"], ic, C), K=K,
                                 W=lad["W"], **kw))
        print(f"  zero-round {name} ladder == plain: {'; '.join(done)}",
              flush=True)
    bucket, n_keys = MAIN_BUCKETS["mesh"]
    s_d = mesh.lanes_for(n_keys, MESH_SHARDS)
    p = mesh.kernel_params(bucket, MESH_SHARDS * s_d)
    C = wgl32.row_words(p["ic_pad"])
    done = []
    for K in p["ladder"]:
        consts = zeros(s_d, p["n_pad"], p["ic_pad"], p["S"], p["O"])
        done.append(held("mesh", wgl32.chunk_batched,
                         wgl32.chunk_batched_ref, consts,
                         wgl32.init_carry_batch(s_d, K, C, p["H"], p["B"], 0,
                                                dev),
                         wgl32.block_form(K, p["W"], p["ic_pad"], C), K=K,
                         W=p["W"], ic=p["ic_pad"], H=p["H"], B=p["B"],
                         chunk=p["chunk"], probes=p["probes"]))
    print(f"  zero-round mesh shard ({s_d} lanes) ladder == plain: "
          f"{'; '.join(done)}", flush=True)


def warm_phases(dev, lin, hist) -> None:
    """The warm plane and the compile guard on the card. In this process,
    two steady re-checks of the headline inside `CompileGuard(
    max_compiles=0)` (one const upload and one poll a chunk each). Then
    fresh processes (`WARM`), in turns: the headline's first check
    unwarmed ("cold", whose guard must count a load and a bind), with
    only its entry point bound ("bind": bound but never launched) and
    after `aot.precompile_service_bucket` ("warm", guard budget 0: h2d
    1, d2h one a chunk); the first turn's cold and warm processes also
    run the mesh fan-out (`check_mesh` over 2 shards of the card, after
    `aot.precompile_mesh_plan` when warm: its starting carries from the
    pool) and Elle append 3k (bf16) and 10k (packed) (after
    `aot.precompile_elle_closure` when warm), each verdict equal to the
    main run's. Then `python -m jepsen_tpu_torch.bench` once. Any guard
    over its budget raises in its process, and the phase fails."""
    from jepsen_tpu_torch.analysis import guards

    print(f"warm plane ({card_line()}):", flush=True)
    zero_round_checks(dev)
    g = guards.CompileGuard(max_compiles=0, name="headline-steady")
    with g:
        chunks = 0
        for _ in range(2):
            res = lin.check({}, hist, {})
            chunks += res["util"]["chunks"]
    rep = g.report()
    print(f"  steady headline re-checks x2 in this process: {rep}, "
          f"transfers {g.transfers}", flush=True)
    if res["valid?"] is not True or rep["h2d"] != 2 or rep["d2h"] != chunks:
        raise AssertionError(f"steady re-checks: {rep}, {chunks} chunks")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cache = str(REPO / "build" / "torch_kernels" / "fs_cache")
    script = WARM % {"repo": str(REPO), "cache": cache}

    def fresh(mode, paths):
        proc = subprocess.run([sys.executable, "-c", script, mode,
                               ",".join(paths)], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"warm process {mode} {paths} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])

    walls: dict = {m: [] for m in ("cold", "bind", "warm")}
    t_all = time.monotonic()
    for turn in range(WARM_TURNS):
        order = ("cold", "bind", "warm") if turn % 2 == 0 else \
            ("warm", "bind", "cold")
        for mode in order:
            paths = ["headline"]
            if turn == 0 and mode != "bind":
                paths += ["mesh", "elle"]
            r = fresh(mode, paths)
            hl = r["headline"]
            gr = hl["guard"]
            walls[mode].append(hl["wall_s"])
            print(f"  turn {turn} {mode}: context {r['context_s']:.4f} s "
                  f"(CUDA_MODULE_LOADING {r['module_loading']}); headline "
                  f"first check {hl['wall_s']:.4f} s (first chunk "
                  f"{hl['first_call_s']} s, {hl['chunks']} chunks), guard "
                  f"builds {gr['builds']} loads {gr['loads']} binds "
                  f"{gr['binds']} compile_s {gr['compile_s']} h2d "
                  f"{gr['h2d']} d2h {gr['d2h']}"
                  + (f"; warm {hl['warm_s']:.4f} s, per bucket "
                     f"{hl['warm']}" if mode == "warm" else ""),
                  flush=True)
            if hl["valid"] is not True:
                raise AssertionError(f"warm headline {mode}: {hl}")
            if mode == "cold" and (gr["loads"] < 1 or gr["binds"] < 1):
                raise AssertionError(f"unwarmed headline counted no load "
                                     f"or bind: {gr}")
            if mode == "warm" and (gr["compiles"] or gr["h2d"] != 1
                                   or gr["d2h"] != hl["chunks"]):
                raise AssertionError(f"warmed headline: {gr}")
            if turn == 0 and mode == "warm":
                print(f"  headline's service bucket {hl['bucket']}",
                      flush=True)
            for name in ("mesh", "elle append 3k", "elle append 10k"):
                if name not in r:
                    continue
                x = r[name]
                xg = x["guard"]
                extra = ""
                if name == "mesh":
                    ok = x["verdicts"] == MAIN_VERDICTS["mesh"]
                    extra = (f"pool hit {x['pool_hit']}, polls {x['polls']}"
                             f", pool after the run {x['pool_bytes']} B")
                    if mode == "warm" and x["pool_hit"] != [True]:
                        raise AssertionError(f"warmed mesh: {x['pool_hit']}")
                else:
                    ok = [x["valid"], x["types"]] == MAIN_VERDICTS[name]
                    extra = f"kernel {x['kernel']}"
                if not ok:
                    raise AssertionError(f"{name} {mode}: verdicts differ "
                                         "from the main run's")
                if mode == "warm" and xg["compiles"]:
                    raise AssertionError(f"warmed {name}: {xg}")
                print(f"    {name} {mode}: first check {x['wall_s']:.4f} s, "
                      f"guard builds {xg['builds']} loads {xg['loads']} "
                      f"binds {xg['binds']} h2d {xg['h2d']} d2h {xg['d2h']} "
                      f"({x['transfers']}); {extra}"
                      + (f"; warm {x['warm_s']:.4f} s: {x['warm']}"
                         if mode == "warm" else ""), flush=True)
    print("  headline first-check walls (s), fresh processes in turns: "
          + json.dumps(walls), flush=True)
    proc = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    lines = proc.stdout.strip().splitlines()
    bench = json.loads(lines[-1]) if lines else {}
    print(f"  python -m jepsen_tpu_torch.bench (exit {proc.returncode}): "
          f"{json.dumps({k: v for k, v in bench.items() if k != 'configs'})}",
          flush=True)
    if (proc.returncode != 0 or len(lines) != 1
            or bench.get("metric") != "cas_register_10k_wgl_wall_s"
            or not bench.get("value", 0) > 0 or bench.get("compiles") != 0
            or bench.get("platform") != "gpu"):
        raise AssertionError(f"bench: exit {proc.returncode}, "
                             f"{proc.stderr[-2000:]}")
    print(f"  warm phases: {time.monotonic() - t_all:.1f} s", flush=True)

SERVICE_WARM_REQUESTS = 8              # warm same-bucket requests timed


def same_bucket_seeds(want_key, n: int, start: int,
                      lie_p: float = 0.0) -> list:
    """`n` (seed, history) pairs from `start` on whose headline-shaped
    histories (with `lie_p` of lying reads) land in the service bucket
    `want_key` (`service.bucket_for`)."""
    from jepsen_tpu_torch import service, synth
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import encode

    out = []
    seed = start
    while len(out) < n:
        h = synth.cas_register_history(
            HEADLINE["n_ops"], n_procs=HEADLINE["n_procs"], seed=seed,
            crash_p=HEADLINE["crash_p"], lie_p=lie_p)
        if service.bucket_for(encode.encode(cas_register(), h))[0] == \
                want_key:
            out.append((seed, h))
        seed += 1
        if seed > start + 200:
            raise AssertionError(f"no {n} seeds in the bucket {want_key}")
    return out


def service_phases(dev) -> dict:
    """The checker service on the card, through its HTTP front door:
    `web.serve(port=0)` over `Service(devices=[card] * 2, workers=1)`
    on an isolated plan registry and store. The headline POSTed and
    followed on `/runs/<id>/events` (cold); a second same-bucket history
    under `CompileGuard(max_compiles=0)` (warm: 0 builds, loads and
    binds); 4 same-bucket histories, one of them invalid (`INVALID`'s
    lie_p), held and released (one `mesh` batch of 4, each verdict equal
    to a direct `ops/wgl.check`, the invalid one False); an Elle
    append 3k request (verdict and anomaly types equal to a direct
    `elle.append.check`, `elle_closure` launched); a request the
    preflight gate rejects under `SMALL_BUDGET` (nothing launched); a
    fresh process that re-warms from the registry and answers warm
    (`SERVICE_FRESH`); then `SERVICE_WARM_REQUESTS` warm requests for
    the walls. Every count is set to 0 before the service is driven and
    read after it; the direct checks run before. A `service-error`
    cause or a `mesh-declined` degrade fails the phase. Returns the
    phase's launch counts."""
    import os
    import shutil
    import tempfile
    import threading
    import urllib.request

    from jepsen_tpu_torch import fs_cache, service, synth, web
    from jepsen_tpu_torch.analysis import guards
    from jepsen_tpu_torch.elle import append
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import encode, wgl
    from jepsen_tpu_torch.parallel import mesh

    print(f"service ({card_line()}):", flush=True)
    t_all = time.monotonic()
    head = synth.cas_register_history(
        HEADLINE["n_ops"], n_procs=HEADLINE["n_procs"],
        seed=HEADLINE["seed"], crash_p=HEADLINE["crash_p"])
    key = service.bucket_for(encode.encode(cas_register(), head))[0]
    seeds = same_bucket_seeds(key, 4 + SERVICE_WARM_REQUESTS,
                              HEADLINE["seed"] + 1)
    bad = same_bucket_seeds(key, 1, HEADLINE["seed"] + 1,
                            lie_p=INVALID["lie_p"])
    warm2, batch, walls = seeds[0], seeds[1:4] + bad, seeds[4:]
    # the comparisons, before the counts are zeroed
    direct = [wgl.check(cas_register(), h, device=dev)["valid?"]
              for _, h in batch]
    if direct[-1] is not False:
        raise AssertionError(f"seed {bad[0][0]} at lie_p "
                             f"{INVALID['lie_p']}: direct {direct[-1]}")
    elle_h = synth.list_append_history(**ELLE_3K)
    elle_want = append.check(elle_h)
    torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="service-", dir=str(REPO / "build" /
                                                      "torch_kernels"))
    prev_cache = fs_cache.DIR
    fs_cache.DIR = os.path.join(tmp, "fs_cache")
    store = os.path.join(tmp, "store")
    svc = service.Service(store, devices=[dev] * MESH_SHARDS, workers=1,
                          slo_every_s=3600.0)
    server = web.serve(host="127.0.0.1", port=0, store_root=store,
                       service=svc)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_port}"

    def body(h, **kw):
        return json.dumps({"model": "cas-register", **kw,
                           "history": [op.to_dict() for op in h]}).encode()

    def post(data) -> dict:
        req = urllib.request.Request(
            base + "/check", data=data,
            headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    def follow(rid) -> dict:
        """The run's SSE stream to its end: the last `done` event."""
        raw = urllib.request.urlopen(f"{base}/runs/{rid}/events?wait=300",
                                     timeout=360).read().decode()
        frames = [f.split("\n") for f in raw.split("\n\n") if f.strip()]
        names = [f[0][len("event: "):] for f in frames]
        if names[-1] != "end" or "done" not in names:
            raise AssertionError(f"SSE of {rid}: {names}")
        return json.loads(frames[names.index("done")][1][len("data: "):])

    def served(rid) -> dict:
        info = svc.get(rid)
        if str(info.get("cause") or "").startswith("service-error"):
            raise AssertionError(f"service error: {info}")
        return info

    out: dict = {}
    try:
        zero_counts()
        # 2. the headline, cold
        t0 = time.monotonic()
        rid = post(body(head, tenant="smoke"))["id"]
        done = follow(rid)
        cold_wall = time.monotonic() - t0
        cold = served(rid)
        print(f"  headline over HTTP (cold): verdict {cold['verdict']} "
              f"(main run True), warm_hit {cold['warm_hit']}, bucket "
              f"{cold['bucket']}, POST-to-done {cold_wall:.4f} s, service "
              f"wall {cold['wall_s']} s, phases {cold['phases']}",
              flush=True)
        if done["verdict"] != "true" or cold["verdict"] is not True \
                or cold["warm_hit"] is not False:
            raise AssertionError(f"cold headline: {cold}")
        # 3. a second history of the bucket, warm
        g = guards.CompileGuard(max_compiles=0, name="service-warm")
        with g:
            rid = post(body(warm2[1]))["id"]
            follow(rid)
        warm = served(rid)
        rep = g.report()
        print(f"  seed {warm2[0]} (same bucket, warm): verdict "
              f"{warm['verdict']}, warm_hit {warm['warm_hit']}, guard "
              f"builds {rep['builds']} loads {rep['loads']} binds "
              f"{rep['binds']} h2d {rep['h2d']} d2h {rep['d2h']}, service "
              f"wall {warm['wall_s']} s, phases {warm['phases']}",
              flush=True)
        if warm["verdict"] is not True or warm["warm_hit"] is not True \
                or rep["builds"] or rep["loads"] or rep["binds"]:
            raise AssertionError(f"warm request: {warm}, {rep}")
        # 4. four held histories: one mesh batch
        svc.hold(True)
        rids = [post(body(h))["id"] for _, h in batch]
        svc.hold(False)
        for r in rids:
            follow(r)
        infos = [served(r) for r in rids]
        bp = svc.mx.series("service_batch").points[-1]
        print(f"  held batch of {len(rids)} (seeds "
              f"{[s for s, _ in batch]}, the last at lie_p "
              f"{INVALID['lie_p']}): mode {bp['mode']} batch_n "
              f"{bp['batch_n']} rounds {bp['rounds']} shards {bp['shards']}"
              f"; verdicts {[i['verdict'] for i in infos]} (direct "
              f"{direct}); serve walls "
              f"{[i['serve_s'] for i in infos]} s", flush=True)
        if (bp["mode"] != "mesh" or bp["batch_n"] != len(batch)
                or [i["verdict"] for i in infos] != direct):
            raise AssertionError(f"mesh batch: {bp}, {infos}")
        # 5. Elle append 3k
        rid = post(json.dumps({"checker": "elle-append", "history": [
            op.to_dict() for op in elle_h]}).encode())["id"]
        follow(rid)
        ei = served(rid)
        with svc._lock:
            er = svc._runs[rid].result
        print(f"  elle append {ELLE_3K}: verdict {ei['verdict']} "
              f"anomalies {er.get('anomaly-types')} (direct "
              f"{elle_want['valid?']} {elle_want['anomaly-types']}), engine "
              f"{er.get('cycle-engine')}, kernel "
              f"{(er.get('cycle-util') or {}).get('kernel')}, service wall "
              f"{ei['wall_s']} s, phases {ei['phases']}", flush=True)
        if (ei["verdict"] != elle_want["valid?"]
                or er["anomaly-types"] != elle_want["anomaly-types"]):
            raise AssertionError(f"elle request: {ei}")
        # 6. a preflight rejection: nothing launched
        before = read_counts()
        prev_budget = os.environ.get("JEPSEN_TPU_PREFLIGHT_MEM_BUDGET")
        os.environ["JEPSEN_TPU_PREFLIGHT_MEM_BUDGET"] = str(SMALL_BUDGET)
        try:
            rej = post(body(head))
        finally:
            if prev_budget is None:
                del os.environ["JEPSEN_TPU_PREFLIGHT_MEM_BUDGET"]
            else:
                os.environ["JEPSEN_TPU_PREFLIGHT_MEM_BUDGET"] = prev_budget
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in read_counts().items()
                 if v != before[k]}
        print(f"  preflight rejection at a {SMALL_BUDGET} B budget: state "
              f"{rej['state']} cause {rej.get('cause')}, launches moved "
              f"{moved}", flush=True)
        if rej["state"] != "rejected" or rej.get("cause") != "preflight" \
                or moved:
            raise AssertionError(f"preflight rejection: {rej}, {moved}")
        # 8. warm requests for the walls
        for s, h in walls:
            rid = post(body(h))["id"]
            follow(rid)
            info = served(rid)
            if info["verdict"] is not True or not info["warm_hit"]:
                raise AssertionError(f"warm seed {s}: {info}")
        counts = read_counts()
        out["counts"] = counts
        print(f"  launches of the service phase: {counts}", flush=True)
        need = ("wgl32_chunk", "wgl32_chunk_batched", "wgl_lane_reset",
                "elle_closure")
        if any(counts[k] < 1 for k in need):
            raise AssertionError(f"service phase launched too little: "
                                 f"{counts}")
        for p in svc.mx.series("service_batch").points:
            if p["mode"] == "degrade" and p["cause"] == "mesh-declined":
                raise AssertionError(f"mesh declined: {p}")
        recs = svc.ledger.query(kind="service-request")
        warm_recs = [r for r in recs if r.get("warm_hit")
                     and r.get("checker") == "wgl" and r.get("batch_n") == 1]
        wl = sorted(r["wall_s"] for r in warm_recs)
        print("  walls (s): cold " + json.dumps(recs[0]["wall_s"])
              + f", warm p50 {wl[len(wl) // 2]} over {len(wl)} warm "
              f"requests {wl}", flush=True)
        for r in recs:
            ph = r.get("phases") or {}
            print(f"    {r.get('checker')} verdict {r.get('verdict')} "
                  f"warm {r.get('warm_hit')} batch {r.get('batch_n')}: "
                  f"wall_s {r.get('wall_s')} queue_wait_s "
                  f"{ph.get('queue_wait_s')} search_s {ph.get('search_s')} "
                  f"warm_s {ph.get('warm_s')} device_s {r.get('device_s')}",
                  flush=True)
        snap = {k: v for k, v in svc.snapshot().items() if k != "recent"}
        print(f"  snapshot: {json.dumps(snap)}", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
        svc.close()
        mesh.pool_settle()
        mesh.pool_clear()
        fs_cache.DIR = prev_cache
    # 7. a fresh process on the same registry, warm after rewarm
    body_path = os.path.join(tmp, "body.json")
    with open(body_path, "wb") as fh:
        fh.write(body(walls[0][1]))
    proc = subprocess.run(
        [sys.executable, "-c", SERVICE_FRESH, os.path.join(tmp, "fs_cache"),
         os.path.join(tmp, "store-fresh"), body_path], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"fresh service exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    gr = fresh["guard"]
    print(f"  fresh process after rewarm ({fresh['rewarm_s']:.4f} s, "
          f"plans {fresh['rewarmed']}): verdict {fresh['verdict']} "
          f"warm_hit {fresh['warm_hit']}, POST-to-done "
          f"{fresh['wall_s']:.4f} s, service wall "
          f"{fresh['request_wall_s']} s, guard builds {gr['builds']} loads "
          f"{gr['loads']} binds {gr['binds']} compiles {gr['compiles']}; "
          f"phases {fresh['phases']}", flush=True)
    if (fresh["verdict"] is not True or fresh["warm_hit"] is not True
            or gr["compiles"] or str(fresh.get("cause") or "").startswith(
                "service-error")):
        raise AssertionError(f"fresh service: {fresh}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"  service phases: {time.monotonic() - t_all:.1f} s", flush=True)
    return out["counts"]


def analyze_phases(dev) -> None:
    """The analysis path on the card, as a Jepsen user re-checks a stored
    run: a history stored as run "demo" through `store.Writer` (`save_0`,
    `save_1`) in a temporary store, re-checked by `python -m
    jepsen_tpu_torch analyze --store-root <store>` in a fresh process
    (`core.analyze` -> `Linearizable(algorithm="cuda-wgl")` ->
    `wgl32_chunk`), the analysis written back as a new run.

      (a) the headline: exit 0, `results.json` valid? True from
          "cuda-wgl" on the card, one `kind="checker"` record under
          <store>/ledger, the new run's test.jepsen read back True;
      (b) `INVALID`: exit 1, `linear.svg` byte-identical to
          `linear_report.render` of the host oracle's "wgl" analysis of
          the same history, computed here (the title and the footer name
          the device search: its algorithm, configs, rounds and wall,
          from results.json; the swimlanes and the path are the
          oracle's);
      (c) in this process, `core.analyze` with `compose({"indep":
          independent.cuda_checker(cas_register(), devices=[card] *
          MESH_SHARDS), "stats": stats(), "exceptions":
          unhandled_exceptions()})` over the 100 x 2k fan-out history
          with `FANOUT_BAD`'s lying keys: failures == the host oracle's
          (from `fanout_phases`), one `kind="independent"` record (keys
          100, engine "device-mesh"), every key's results.json written;
          every count set to 0 just before and read just after.

    (a) and (b) run at once, each in its own fresh process; a fresh
    process's launches are its chunks (`util.chunks` in results.json:
    one `wgl32_chunk` launch a chunk)."""
    import os
    import shutil
    import tempfile

    from jepsen_tpu_torch import core, independent, ledger, store, synth
    from jepsen_tpu_torch.checker import (compose, linear_report,
                                          linearizable, stats,
                                          unhandled_exceptions)
    from jepsen_tpu_torch.history import History, strip_nemesis
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import mesh

    print(f"analysis path ({card_line()}):", flush=True)
    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="analyze-", dir=str(REPO / "build" /
                                                      "torch_kernels"))
    # (a) and (b) run at once: most of a fresh process's wall is `import
    # torch` on the host
    cases = (("headline", HEADLINE, 0, True), ("invalid", INVALID, 1, False))
    started = {}
    for name, params, _, _ in cases:
        root = os.path.join(tmp, name)
        hist = synth.cas_register_history(**params)
        test = {"name": "demo", "start_time": "20260101T000000",
                "store_root": root, "history": hist}
        w = store.Writer(test)
        try:
            w.save_0(test)
            w.save_1(test)
        finally:
            w.close()
        proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch", "analyze",
             "--store-root", root], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        started[name] = (root, hist, w.dir, proc, time.monotonic())
    try:
        for name, params, want_rc, want_valid in cases:
            root, hist, stored, proc, t0 = started[name]
            _, err = proc.communicate(timeout=300)
            rc, wall = proc.returncode, time.monotonic() - t0
            run = store.latest(root)
            if rc != want_rc or run == os.path.realpath(stored):
                raise AssertionError(
                    f"analyze {name}: exit {rc} (want {want_rc}), run "
                    f"{run}:\n{err[-4000:]}")
            with open(os.path.join(run, "results.json")) as fh:
                res = json.load(fh)
            recs = [(r["name"], r["verdict"], r.get("algorithm"))
                    for r in ledger.Ledger(root).query(kind="checker")]
            back = store.load_latest(root)["results"]["valid?"]
            u = res.get("util") or {}
            print(f"  {name} {params}: analyze exit {rc} in {wall:.4f} s "
                  f"(a fresh process, both at once), valid? "
                  f"{res['valid?']} algorithm {res.get('algorithm')} on "
                  f"{res.get('device')}, search "
                  f"{res.get('wall_s')} s, {u.get('chunks')} wgl32_chunk "
                  f"launches (chunks), rounds {u.get('rounds')}, configs "
                  f"{res.get('configs_explored')}; ledger checker records "
                  f"{recs}; test.jepsen reads back {back}", flush=True)
            if (res["valid?"] is not want_valid
                    or res.get("algorithm") != "cuda-wgl"
                    or res.get("platform") != "cuda"
                    or not u.get("chunks") or back is not want_valid
                    or recs != [("demo", want_valid, "cuda-wgl")]):
                raise AssertionError(
                    f"analyze {name}: {res}, {recs}, {back}")
            if want_valid:
                continue
            svg = os.path.join(run, "linear.svg")
            with open(svg) as fh:
                got_svg = fh.read()
            h = strip_nemesis(History(hist).index())
            oracle = linearizable(cas_register(), algorithm="wgl",
                                  device="cpu").check({}, h, {})
            want_svg = linear_report.render(h, {
                **oracle, **{k: res[k] for k in ("algorithm",
                                                 "configs_explored", "util",
                                                 "wall_s") if k in res}})
            print(f"  {name}: linear.svg {len(got_svg)} B, == the render "
                  f"of the host oracle's analysis ({oracle['valid?']}, "
                  f"{len(oracle.get('final_paths') or [])} final paths): "
                  f"{got_svg == want_svg}", flush=True)
            if oracle["valid?"] is not False or got_svg != want_svg \
                    or res.get("counterexample-svg") is None:
                raise AssertionError(f"analyze {name}: linear.svg differs "
                                     "from the oracle analysis's render")
    finally:
        for _, _, _, proc, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # (c) the composed fan-out, in this process
    bad = FANOUT_BAD
    hb = MAIN_HISTORIES.get("fan-out invalid") or multikey_history(
        **FANOUT, lie_keys=bad["keys"], lie_p=bad["lie_p"])
    root = os.path.join(tmp, "fanout")
    test = {"name": "fanout", "start_time": "20260101T000000",
            "store_root": root, "history": hb,
            "checker": compose({
                "indep": independent.cuda_checker(
                    cas_register(), devices=[dev] * MESH_SHARDS),
                "stats": stats(), "exceptions": unhandled_exceptions()})}
    test["store_dir"] = store.path_bang(test)
    led = ledger.Ledger(root)
    mesh.pool_settle()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    with ledger.use(led):
        out = core.analyze(test)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    res = out["results"]
    ind = res["indep"]
    recs = [(r["name"], r["keys"], r["failures"], r.get("engine"),
             r.get("model")) for r in led.query(kind="independent")]
    key_dir = os.path.join(test["store_dir"], independent.DIR)
    written = sorted(int(k) for k in os.listdir(key_dir)
                     if os.path.exists(os.path.join(key_dir, k,
                                                    "results.json")))
    want = MAIN_VERDICTS["fan-out invalid failures"]
    print(f"  fan-out {FANOUT} with keys {bad['keys']} at lie_p "
          f"{bad['lie_p']}, composed (indep over {MESH_SHARDS} shards, "
          f"stats, exceptions): valid? {res['valid?']} (indep "
          f"{ind['valid?']}, stats {res['stats']['valid?']}, exceptions "
          f"{res['exceptions']['valid?']}), failures {ind['failures']} "
          f"(host oracle {want}), wall {wall:.4f} s, launches {counts}; "
          f"ledger independent records {recs}; per-key results.json "
          f"{len(written)}", flush=True)
    if (res["valid?"] is not False or sorted(ind["failures"]) != want
            or not set(want) <= set(bad["keys"])
            or recs != [("fanout", FANOUT["n_keys"], len(want),
                          "device-mesh", "CASRegister")]
            or written != list(range(FANOUT["n_keys"]))
            or counts["wgl32_chunk_batched"] < 1
            or counts["wgl_lane_reset"] < 1):
        raise AssertionError(f"analyze fan-out: {ind['failures']}, {recs}, "
                             f"{counts}, {len(written)} keys written")
    mesh.pool_settle()
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"  analysis phases: {time.monotonic() - t_all:.1f} s",
          flush=True)


def paths_main(root: str) -> int:
    """`--paths ROOT`: the main paths the redesigned kernels serve,
    driven through the package under ROOT (this checkout's, or an older
    one's unpacked beside it, to time the two in turns in one call): the
    lane reset at RESET_SHAPES (`reset_turns`), the
    headline through `checker.linearizable(algorithm="cuda-wgl")`, the
    16-wave's search (`ops.wgl.check`, without the oracle's diagnostics
    of the False verdict), the mesh fan-out over 2 shards of the card,
    the headline through the bool-window chunk (`_compiled_search` at
    derive_plan's first bucket, µs a round) and the forced trim of the
    Elle append 3k and 10k histories (`cycle_backend="trim"`, µs a
    peel). Prints one JSON line of verdicts, walls and kernel times
    (CUDA events around each launch)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    root_p = Path(root).resolve()
    sys.path.insert(0, str(root_p))
    import jepsen_tpu_torch
    if root_p not in Path(jepsen_tpu_torch.__file__).resolve().parents:
        raise AssertionError(f"jepsen_tpu_torch not from {root_p}")
    from jepsen_tpu_torch import checker, independent, synth
    from jepsen_tpu_torch.elle import append
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import _native, wgl, wgl_bool
    from jepsen_tpu_torch.parallel import mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _native.build_all()
    for name in CHUNK_KERNELS:      # bound before any timed launch
        _native._lib(name)
    for name in getattr(_native, "CONSTANTS", ()):
        _native.constant(name)
    out = {"root": str(root_p), "card": card_line()}

    def run(what, fn, kernel, also=()):
        torch.cuda.synchronize()
        with Timed() as t:
            t0 = time.monotonic()
            res = fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        ms = t.ms(kernel)
        out[what] = {"wall_s": wall, "kernel_ms": sum(ms),
                     "launches": len(ms),
                     "launch_ms": [round(x, 4) for x in ms[:8]]}
        for k in also:
            ms = t.ms(k)
            out[what][k] = {"kernel_ms": sum(ms), "launches": len(ms)}
        return res

    # the lane reset at its three shapes, then in its main path (the
    # mesh fan-out below: every reset launch's events summed)
    out["reset"] = reset_turns(dev, mesh)

    h = synth.cas_register_history(HEADLINE["n_ops"],
                                   n_procs=HEADLINE["n_procs"],
                                   seed=HEADLINE["seed"],
                                   crash_p=HEADLINE["crash_p"])
    lin = checker.linearizable(cas_register(), algorithm="cuda-wgl")
    res = run("headline", lambda: lin.check({}, h, {}), "wgl32_chunk")
    out["headline"].update(valid=res["valid?"], rounds=res["util"]["rounds"])
    wave = synth.adversarial_wave_history(
        WAVE["n_waves"], width=WAVE["width"], span=WAVE["span"],
        seed=WAVE["seed"])
    res = run("16-wave search", lambda: wgl.check(cas_register(), wave,
                                                  device=dev), "wgln_chunk")
    out["16-wave search"].update(valid=res["valid?"], search_s=res["wall_s"],
                                 rounds=res["util"]["rounds"],
                                 configs=res["configs_explored"])
    fan = multikey_history(**FANOUT)
    res = run("mesh fan-out", lambda: independent.cuda_checker(
        cas_register(), devices=[dev] * MESH_SHARDS).check({}, fan, {}),
              "wgl32_chunk_batched", also=("wgl_lane_reset",))
    out["mesh fan-out"].update(valid=res["valid?"])

    # these two paths run once untimed first: a kernel's first launch in
    # a process loads its module (lazy loading), milliseconds that are
    # not the kernel's
    enc, consts = bool_consts(h, dev)
    drive_bool(enc, consts, dev)
    _, carry, _ = run("bool-window headline",
                      lambda: drive_bool(enc, consts, dev), "wgl_chunk")
    stats = carry[wgl_bool.STATS].tolist()
    kms = out["bool-window headline"]["kernel_ms"]
    out["bool-window headline"].update(
        valid=bool(carry[wgl_bool.FLAGS].tolist()[0]), rounds=stats[5],
        us_per_round=kms * 1e3 / max(stats[5], 1))
    for name, params in (("trim append 3k", ELLE_3K),
                         ("trim append 10k", ELLE_10K)):
        hist = synth.list_append_history(**params)
        append.check(hist, additional_graphs=RT, cycle_backend="trim")
        res = run(name, lambda: append.check(
            hist, additional_graphs=RT, cycle_backend="trim"), "elle_trim")
        peels = res["cycle-util"]["iters_run"]
        out[name].update(valid=res["valid?"], engine=res.get("cycle-engine"),
                         peels=peels, us_per_peel=out[name]["kernel_ms"]
                         * 1e3 / peels)
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--paths":
        return paths_main(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print("card:", card_line(), flush=True)
    # the host oracle's verdict on the Elle 10k history takes about a
    # minute of one core: it runs in a process of its own from the start,
    # done before the fan-out's oracle pool takes every core
    background = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        host10 = background.submit(elle_host_verdict, ELLE_10K)
        return run_phases(dev, host10)
    finally:
        background.shutdown(wait=True, cancel_futures=True)


def run_phases(dev, host10) -> int:
    """Every phase after the card check, the host oracle of the Elle 10k
    history running in the background (`host10`)."""
    from jepsen_tpu_torch import checker, occupancy, synth
    from jepsen_tpu_torch.models import (cas_register, fifo_queue, mutex,
                                         register)
    from jepsen_tpu_torch.ops import _native, adapt, encode, wgl, wgl32
    from jepsen_tpu_torch.ops import wgl_ref, wgln

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

    def bound_bytes(summary, C, tally):
        """Least bytes a chunk must move for this run's data
        (`occupancy.wgl_chunk_bytes`, from chunk_ref's tally)."""
        return occupancy.wgl_chunk_bytes(summary[:wgl32.SUMMARY_HEAD].tolist(),
                                         C, tally, summary.numel())

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
    print(f"headline chunk 1 (K={plan['K']}, "
          f"{form_label(wgl32.block_form(plan['K'], kw['W'], kw['ic'], C))}):"
          f" {rounds_k2} rounds, kernel "
          f"{first_ms:.3f} ms, chunk_ref {plain_ms:.1f} ms, identical")
    wide = adapt.migrate_frontier(carry, 512)
    _, summary512, ms512, plain512, err = run_both(
        consts, wide, K=512, **dict(kw, chunk=HEADLINE_K512_ROUNDS))
    worst_err = max(worst_err, err)
    r512 = int(summary512[9]) - rounds_k2
    print(f"headline chunk 2 after migrate to K=512 "
          f"({form_label(wgl32.block_form(512, kw['W'], kw['ic'], C))}): "
          f"{r512} rounds, kernel "
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
    # least bytes the chunk must move for this run's data (bound_bytes)
    bytes_moved = bound_bytes(summary, C, tally)
    bound_ms = bytes_moved / card_peak("hbm_bytes_per_s") * 1e3
    print(f"bound: {bytes_moved} bytes ({tally['const_bytes']} of consts "
          f"reached, {explored_k2} configs expanded, "
          f"{tally['probed']} successors probed, {new_k2} new) over "
          f"3.35 TB/s = {bound_ms:.6f} ms for {rounds_k2} rounds")

    hconsts = consts

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
    mig_bound_ms = mig_bytes / card_peak("hbm_bytes_per_s") * 1e3
    print(f"migrate_frontier {wplan['K']} -> 2048 (C={wC}): "
          f"{[round(t, 4) for t in mig_times]} ms, median {mig_ms:.4f} ms; "
          f"bytes {mig_bytes} (read K*C*4 + write K'*C*4), bound "
          f"{mig_bound_ms:.6f} ms")
    wave_starts = {wplan["K"]: wstart}
    wave_bounds = {}
    s_prev = wsummary
    for k_new in (2048, 4096):
        carry = adapt.migrate_frontier(carry, k_new)
        wave_starts[k_new] = tuple(t.clone() for t in carry)
        ktally: dict = {}
        carry, s_k, ms_k, plain_k, err = run_both(wconsts, carry, mod=wgln,
                                                  tally=ktally, K=k_new, **wkw)
        wide_err = max(wide_err, err)
        r_k = int(s_k[9]) - rounds_prev
        rounds_prev = int(s_k[9])
        per_bucket[k_new] = (r_k, ms_k)
        # this chunk's own counts: the summary's stats are the search's
        head = s_k[:wgl32.SUMMARY_HEAD].tolist()
        head[4] -= int(s_prev[4])
        head[8] -= int(s_prev[8])
        s_prev = s_k
        kbytes = occupancy.wgl_chunk_bytes(head, wC, ktally, s_k.numel())
        wave_bounds[k_new] = kbytes / card_peak("hbm_bytes_per_s") * 1e3
        print(f"16-wave chunk at K={k_new} ("
              f"{form_label(wgln.solo_form(k_new, wkw['L'], wkw['ic']))}): "
              f"{r_k} rounds, kernel {ms_k:.3f} ms "
              f"({ms_k * 1e3 / max(r_k, 1):.2f} us/round), chunk_ref "
              f"{plain_k:.1f} ms, identical; bound {kbytes} bytes "
              f"({ktally['const_bytes']} of consts reached, {head[4]} configs "
              f"expanded, {ktally['probed']} successors probed, {head[8]} "
              f"new) = {wave_bounds[k_new]:.6f} ms")
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
    wbytes = bound_bytes(wsummary, wC, wtally)
    wbound_ms = wbytes / card_peak("hbm_bytes_per_s") * 1e3
    sh = wsummary[:wgl32.SUMMARY_HEAD].tolist()
    print(f"16-wave chunk 1 (K={wplan['K']}, "
          f"{form_label(wgln.solo_form(wplan['K'], wkw['L'], wkw['ic']))}): "
          f"{r0} rounds, kernel times (ms) "
          f"{[round(t, 4) for t in wtimes]}; median {wkernel_ms:.4f} ms = "
          f"{wkernel_ms * 1e3 / max(r0, 1):.2f} us/round; chunk_ref "
          f"{wplain_ms:.1f} ms; bound {wbytes} bytes ({wtally['const_bytes']} "
          f"of consts reached, {sh[4]} configs "
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
          f"{json.dumps(tkw)}, "
          f"{form_label(wgln.solo_form(tkw['K'], tkw['L'], tkw['ic']))}): "
          f"{int(ts[9])} rounds, kernel {tms:.3f} ms "
          f"({tms * 1e3 / max(int(ts[9]), 1):.2f} us/round), chunk_ref "
          f"{tplain:.1f} ms, identical")

    form_phases(dev, wconsts, wkw, wave_starts, hconsts, kw, start, tconsts,
                tkw)

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
        events.append((name, e0, e1, launch_form(name, a[1])))

    def launch_line(name) -> str:
        """Each launch of `name` in the last drive: ms and form."""
        return "; ".join(f"{a.elapsed_time(b):.3f} ms {f}"
                         for n, a, b, f in events if n == name)

    def drive(lin, hist):
        """One check with both counts at 0 before it; returns (result,
        wall, launches by kernel, kernel ms by kernel, the peak bytes the
        check allocated over its baseline, its own admission report as a
        `GateLog`)."""
        events.clear()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _native.launch = timed_launch
        try:
            zero_counts()
            t0 = time.monotonic()
            with GateLog() as gates:
                res = lin.check({}, hist, {})
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = read_counts()
        finally:
            _native.launch = launch
        dev_ms = {k: sum(a.elapsed_time(b) for n, a, b, _ in events
                         if n == k) for k in counts}
        return (res, wall, counts, dev_ms,
                torch.cuda.max_memory_allocated(dev) - before, gates)

    lin = checker.linearizable(cas_register(), algorithm="cuda-wgl")
    res, wall, counts, dev_ms, peak, gates = drive(lin, h)
    launches = counts["wgl32_chunk"]
    u = res["util"]
    print(f"main path, narrow (after the comparisons above): valid? "
          f"{res['valid?']} wall {wall:.4f} s (search {res['wall_s']} s), "
          f"rounds {u['rounds']}, chunks {u['chunks']}, launches "
          f"{counts}, kernel {dev_ms['wgl32_chunk']:.3f} ms = "
          f"{dev_ms['wgl32_chunk'] * 1e3 / u['rounds']:.2f} us/round, "
          f"configs {res['configs_explored']}, adapt "
          f"{u.get('adapt', {}).get('path')}, peak memory {peak} B; "
          f"launches: {launch_line('wgl32_chunk')}")
    if res["valid?"] is not True or launches < 1:
        raise AssertionError(f"headline: {res['valid?']}, {launches} "
                             "launches")
    Peaks.add("headline", gates, peak)
    planes_phases(dev, lin, h, peak, Peaks.rows[-1][2])

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
    res, wall, wcounts, wdev_ms, wpeak, _ = drive(lin, wave)
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
          f"peak memory {wpeak} B; launches: {launch_line('wgln_chunk')}")
    if (res["valid?"] is not False or wlaunches < 1
            or abs(total - WAVE_CONFIGS) > slack):
        raise AssertionError(f"16-wave: {res['valid?']}, {wlaunches} "
                             f"launches, {total} configs")

    # ---- 5. the default checker (competition) -------------------------------
    res, wall, counts, _, _, _ = drive(
        checker.linearizable(cas_register()), tail)
    print(f"default checker, long tail {LONG_TAIL} (window "
          f"{tenc.window_raw}): valid? {res['valid?']} engine "
          f"{res.get('engine')} wall {wall:.4f} s, launches {counts}: "
          f"{launch_line('wgln_chunk')}")
    if res["valid?"] is not True or res.get("algorithm") != "competition":
        raise AssertionError(f"long tail: {res}")
    fifo = synth.fifo_queue_history(FIFO["n_ops"], n_procs=FIFO["n_procs"],
                                    seed=FIFO["seed"])
    res, wall, counts, _, _, _ = drive(
        checker.linearizable(fifo_queue()), fifo)
    print(f"default checker, fifo queue {FIFO}: valid? {res['valid?']} "
          f"engine {res.get('engine')} wall {wall:.4f} s, launches {counts}")
    if res["valid?"] is not True or res.get("engine") != "queue-poly":
        raise AssertionError(f"fifo queue: {res}")

    fanout = fanout_phases(dev)
    step_us = barrier_step_us(dev)
    elle = elle_phases(dev, host10, step_us)
    bool_entry = bool_chunk_phases(dev, step_us)
    preflight_phases(dev)
    warm_phases(dev, lin, h)
    service_phases(dev)
    analyze_phases(dev)

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
        "bound_by": "bytes", "library_ms": None}] + fanout + elle
        + [bool_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
