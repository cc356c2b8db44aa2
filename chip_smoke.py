#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`jepsen_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every CUDA kernel from `jepsen_tpu_torch/csrc/` (and, with
the host compiler, the host kernel `wgl_host.cpp`), holds each
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
and the frontier migration of a ladder switch is timed. On the card
the default checker races three lanes: the device search, the host
oracle and the same search on the host kernel (`csrc/wgl_host.cpp`,
the `device@cpu` lane). That lane's own phase (`host_lane_phases`)
holds the host kernel against `chunk_ref` on CPU tensors at the
headline's K 2 and 512 and the 16-wave's K 256 (every leaf equal;
timed beside a bound at the host's copy rate), and times the headline's
three-lane race against a two-lane one in turns; the headline's host
oracle runs in a process of its own and is read before the bench. Then
the per-key fan-out:

  * narrow lanes (`wgl32_chunk_batched`): one tuple-valued history of
    100 keys x 2000-op cas-register through
    `independent.cuda_checker(cas_register())` (every key True; its
    first poll's shared form against global scratch, in turns), and a
    variant with four keys made invalid (failing keys == the host
    oracle's, the oracle run per key in a process pool);
  * wide lanes (`wgln_chunk_batched`): 8 adversarial-wave keys (window
    37) through `parallel.check_batched(strategy="vmap")`, every key
    False after the JAX package's config count. Before it, the kernel's
    one-CTA form against its cluster form (one thread-block cluster of
    g CTAs a lane) at each g the card holds, in turns, bit-identical;
    two mesh shards' cluster polls on two streams at once, each
    identical to its run alone; and 12 random wide batches (2-16 lanes,
    valid and invalid keys) through `check_batched` in the rule's forms
    and held to one CTA a lane, verdicts and configs equal;
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
  * the host trim (`elle_trim_host`, `csrc/elle_trim_host.cpp`, one
    host core, built with the host compiler): the 3k list-append
    history checked with `device="cpu"` (the CPU's main path: the route
    picks the trim there), then CPU copies of the trim's inputs at the
    3k append, the 3k wr, the 10k append and the 3k append with the
    realtime thresholds off, each held against the `trim_ref` result
    the card's trim was held against, timed with the host clock (median
    of 3) beside the card's kernel and `trim_ref`, and bound by its
    bytes at the host's copy rate;
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
fresh processes' first checks, cold, bound and warmed, in turns. Then
the checker service
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
Then the test path (`test_phases`): `python -m jepsen_tpu_torch test
--concurrency 2n --time-limit 2 --rate 1000` in a fresh process (~2k
invocations made by the interpreter against the in-process register,
checked by "cuda-wgl" on the card; the run dir, the ledger's run and
checker records, the status mirror, the host oracle's verdict of the
stored history), `core.run` of the demo with a lying client (False, as
the oracle, `linear.svg`), `core.run` of 100 keys x 200 invocations
through `independent.concurrent_generator` checked by
`independent.cuda_checker` over 2 shards of the card (failing keys ==
the oracle's), and `test-all --test-count 2` in a fresh process.
Then the plot checkers (`plots_phases`): the headline through
`compose({linear "cuda-wgl", perf(), clock_plot()})` under a metrics
registry, its heatmap points (`occupancy.heatmap_points`) one per
drained round and equal to the drained `wgl_rounds` series, and no PNG
and no `*-png` key without matplotlib. Then the autopilot
(`autopilot_phases`): the reference's three proofs on the card (a
seeded compile storm fires D001, the warm-bucket actuator warms the
headline's canonical bucket with one counted `wgl32_chunk` launch at
each ladder K, a second warm counts 0 builds, loads and binds, the next
pass verifies; an un-fixable finding is reverted, quarantined and
suppressed with one actuator run; `autopilot.replay` names the live
decisions), then the same storm over `Service(devices=[card] * 2,
autopilot=True)`, whose own actuator warms its held requests' bucket
before they serve as one mesh batch. Then the one command language
(`cli_phases`) in fresh processes at once: `preflight --config headline
--execute --json`, `autopilot latest --json` over the autopilot phase's
store, `serve --service --autopilot --devices 2 -p 0` answering 4 POSTs
and `/status.json`'s autopilot block, `serve --bogus` (254) and `fleet
--discover` over an empty directory (2). Then the fleet observatory and
the pages (`fleet_phases`): two `serve --service --devices 2` replicas
in fresh processes, a mixed WGL and Elle load to each against the host
oracle, a `kind="multichip"` record of an 8-key fan-out over `[card] *
2`, every page of r1, `python -m jepsen_tpu_torch fleet` over both
stores, then r2 killed: D013, and r2's store untouched by the
observatory. Then the lints and the lock-order witness (`lint_phases`):
both lints' CLIs in this process (0 over the port's tree, 1 on a
fixture), then with `JEPSEN_TPU_LOCKWATCH=1` a `Service(devices=[card] *
2)` serving a warm request, 4 held requests as one mesh batch and the 3k
Elle request, and `check_streamed` over 8 keys, every verdict the
oracle's; the witness sees no cycle, `close()` banks one lintable
`kind="lockwatch"` record, the doctor raises no D016, a seeded inversion
raises; unset, a new service holds a plain lock and serves the same 4
requests (both p50 walls printed). Then the harness for real nodes and
the first live suite (`cluster_phases`): the node tools probed
(`start-stop-daemon`, `ps`, `xargs`, `awk`, `/usr/bin/python3`, ...), the
native SSH stack against the port's loopback `MiniSshd` through
`control.with_ssh({"remote": "native"})` (exec, stderr, stdin, upload
and download byte for byte, a daemon started, watched and stopped, a
wrong password and a wrong host-key pin refused), a durable toykv
register run in this process (3 live server processes over the
localexec remote, 6 workers for 3 s, the kill/restart nemesis (every 1 s) sending
real `kill -9`s, logs snarfed, each key decided by the competition race
whose device lane runs `wgl32_chunk` on the card), its stored history
re-checked by `independent.cuda_checker` over `[card] * 2`
(`wgl32_chunk_batched`) and by the host oracle, both equal to the
suite's verdict on every key, a volatile set run that loses
acknowledged adds (False), and `python -m jepsen_tpu_torch.dbs.toykv
test` in a fresh process (exit 0). Then the first live SQL suite
(`suites_phases`): sqlite `append` and `wr` runs against a live minisql
primary under kill -9 (4 workers for 5 s, paced to ~1000 transactions),
each checked on the card by the suite and its stored history re-checked
three ways (the routed "auto", a forced "device" that launches
`elle_closure`, each launch held against `closure_ref`, and the host
oracle), all equal; a bank run (valid, no PNG); and the faultlib
LD_PRELOAD nemesis against a toykv node (faultlib built with g++ there,
EIO injected, the set checker's verdict); then etcd's `register` (a live
mini-etcd server under kill -9, 4 workers for 3 s, each key decided by
the competition race whose device lane runs `wgl32_chunk`, each verdict
equal to the host oracle's) and `append` (paced, 7.5 s, re-checked the
same three ways); then rabbitmq's `semaphore` (a live mini AMQP broker,
3 workers for 3 s, the mutex checked by the suite, then re-checked by a
forced "cuda-wgl" that launches `wgl32_chunk` on the mutex history and
by the host oracle in a worker process, all equal), mongodb's
`register` (a live mini OP_MSG server under kill -9, 4 workers for 3 s,
each key decided by the competition race, its stored history re-checked
key by key by "cuda-wgl" on the card and by the host oracle, all
equal), and EDN ingest (the
headline written as a store.clj-shaped history.edn, read back by
`History.from_edn` and decided by "cuda-wgl" as the native history is,
launch for launch; a list-append history.edn with 600 transactions
checked by Elle on the card and on the host, equal); then the MySQL-wire
family on galera's embedded server (`mysql_runs`): mysql_cluster's
`register` (a live mini server under kill -9, 4 workers for 3 s, each
key decided by the competition race, its stored history re-checked key
by key by "cuda-wgl" on the card, by the three-lane competition (its
winning engines printed) and by the host oracle in a worker process,
all equal) and tidb's `append` (paced, 7.5 s, re-checked the
same three ways as sqlite's); then the pgwire family on stolon's
embedded server (`pg_runs`): postgres's `register` against one minipg
node (4 workers for 2 s, re-checked key by key by "cuda-wgl" and the host
oracle, all equal) and stolon's `append` (paced, 7.5 s, under kill -9,
re-checked the same three ways); then yuga's and raftis's runs on
mini-redis servers from their suites' own ports (`yuga_raftis_runs`):
yuga's `ycql/multi-key-acid` (4 workers for 3 s under kill -9, each
3-subkey group a key decided by the competition race on the
multi-register model, its stored history re-checked key by key by
"cuda-wgl" on the card and by the host oracle, all equal) and raftis's
register (4 workers for 3 s under kill -9, re-checked whole by
"cuda-wgl" with `cas_register(None)` and the host oracle, all equal);
then two binary-wire suites on their own mini servers (`grid_runs`):
aerospike's `cas-register` (4 workers for 3 s under kill -9, each key
decided by the competition race against generation-CAS records, its
stored history re-checked key by key by "cuda-wgl" on the card and by
the host oracle, all equal) and hazelcast's fenced `lock` (4 workers for
2 s, fault-free, the mutex checked by the suite's race and the fences
for monotonicity, the stored history re-checked whole with the mutex
model by "cuda-wgl", which launches `wgl32_chunk`, and by the host
oracle, all equal); then the last HTTP suite on the port's stdlib
client (`http_runs`): dgraph's `register` (a live mini alpha under kill
-9, 4 workers for 3 s, each key decided by the competition race, its
stored history re-checked key by key by "cuda-wgl" on the card and by
the host oracle in a worker process, all equal) and `wr` (2.5 s under
the same nemesis, re-checked the same three ways as sqlite's, the
forced "device" check launching `elle_closure`). A
live step whose server never opens its port prints the server log's tail
and the port's holders (from /proc/net/tcp) before it fails. Last, the bench round
(`bench_phases`): `python -m
jepsen_tpu_torch.bench` in a fresh process with every BASELINE config
at the reference's sizes under what is left of the smoke's 1200 s, each
verdict held against the host oracle or this script's own phase, then a
headline-only round that must read the first as its prior, then
`python -m jepsen_tpu_torch doctor bench`.

It prints as its last lines the card, one JSON line of per-kernel
numbers (the host kernel's two entries say `"platform": "cpu"`; their
`route` is the C++ one) and
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

import contextlib
import functools
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
# when the smoke started (monotonic): the bench round's budget is what
# is left of SMOKE_LIMIT_S
T_START = time.monotonic()

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


# one replica of the fleet phase (`fleet_phases`): argv[1] its plan
# registry, argv[2] where SIGUSR1 writes its launch counts (outside its
# store), argv[3:] the `python -m jepsen_tpu_torch` command line. The
# counts are 0 when the command starts; the process is otherwise the
# command itself.
FLEET_REPLICA = """
import json, os, signal, sys
from jepsen_tpu_torch import __main__ as main_mod, fs_cache
from jepsen_tpu_torch.bench import kernel_wrappers
fs_cache.DIR = sys.argv[1]

def dump(*_):
    tmp = sys.argv[2] + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({k: w.launches for k, w in kernel_wrappers().items()}, fh)
    os.replace(tmp, sys.argv[2])

signal.signal(signal.SIGUSR1, dump)
for w in kernel_wrappers().values():
    w.launches = 0
sys.exit(main_mod.main(sys.argv[3:]))
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
    from jepsen_tpu_torch.bench import kernel_wrappers
    return kernel_wrappers()


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
    if form.name == "cluster":
        return f"cluster ({form.blocks} CTAs of {form.threads} a lane)"
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
    (kernel out, err, plain seconds, inputs dict, trim_ref out)."""
    from jepsen_tpu_torch.elle import tpu as etpu

    t = etpu.trim_inputs(g)
    ins = on_card(t["arrays"], dev)
    kw = dict(p_pad=t["p_pad"], use_rt=t["use_rt"], use_proc=t["use_proc"])
    got = etpu.trim(*ins, **kw)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ref = etpu.trim_ref(*ins, **kw)
    torch.cuda.synchronize()
    return got, outputs_err(got, ref), time.monotonic() - t0, t, ref


def trim_peel_us(t, dev, use_rt: bool) -> tuple:
    """The trim kernel's µs a peel on `t = trim_inputs(g)` with the
    realtime thresholds on or off (off: the same inputs reach another
    fixpoint): the median of 3 launches after a warm one, CUDA events
    around each launch (`Timed`), every one of the 4 launches held
    against `trim_ref` with the same thresholds: (µs a peel, peels,
    trim_ref out, trim_ref ms, the kernel's median ms)."""
    from jepsen_tpu_torch.elle import tpu as etpu

    ins = on_card(t["arrays"], dev)
    kw = dict(p_pad=t["p_pad"], use_rt=use_rt, use_proc=t["use_proc"])
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ref = etpu.trim_ref(*ins, **kw)
    torch.cuda.synchronize()
    ref_ms = (time.monotonic() - t0) * 1e3
    got = [etpu.trim(*ins, **kw)]
    with Timed() as tm:
        got += [etpu.trim(*ins, **kw) for _ in range(3)]
    errs = [outputs_err(g, ref) for g in got]
    if any(errs):
        raise AssertionError(f"elle trim (realtime {use_rt}) differs from "
                             f"trim_ref: max abs err by launch {errs}")
    peels = 2 * got[0][2]
    ms = float(np.median(tm.ms("elle_trim")))
    return ms * 1e3 / peels, peels, ref, ref_ms, ms


def host_trim_vs_ref(t, ref, use_rt: bool) -> dict:
    """The host trim (`elle_trim_host`) on CPU copies of `t =
    trim_inputs(g)`'s arrays with the realtime thresholds `use_rt`, held
    against `ref`, the `trim_ref` result on the card for the same
    inputs: one checked call, then three timed with the host clock, each
    held too. Its bound: the bytes it must move (each input read once,
    each output written once) at the host's copy rate."""
    from jepsen_tpu_torch import occupancy
    from jepsen_tpu_torch.elle import tpu as etpu

    ins = [torch.from_numpy(np.ascontiguousarray(a)) for a in t["arrays"]]
    kw = dict(p_pad=t["p_pad"], use_rt=use_rt, use_proc=t["use_proc"])
    ref = [x.cpu() if torch.is_tensor(x) else x for x in ref]
    got, times = [etpu.trim(*ins, **kw)], []
    for _ in range(3):
        t0 = time.perf_counter()
        got.append(etpu.trim(*ins, **kw))
        times.append((time.perf_counter() - t0) * 1e3)
    err = max(outputs_err(g, ref) for g in got)
    if err:
        raise AssertionError(f"host trim (n_pad {t['n_pad']}, realtime "
                             f"{use_rt}) differs from trim_ref: max abs "
                             f"err {err}")
    nbytes = occupancy.trim_bytes(t["arrays"], t["n_pad"],
                                  len(etpu.SUBSETS))
    return {"ms": float(np.median(times)), "times": times, "err": err,
            "bodies": got[0][2], "bytes": nbytes,
            "bound_ms": nbytes / host_copy_rate() * 1e3}


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


def elle_host_verdict(params: dict, graphs: tuple = RT,
                      kind: str = "append") -> dict:
    """The host oracle's verdict on a list-append history ("append",
    `synth.list_append_history(**params)`) or a wr history ("wr",
    `synth.wr_register_history(**params)`, its keys linearizable) with
    the `graphs` beside its own (in a worker process): valid?,
    anomaly-types, the cycle anomalies' cycles (`cycles`) and seconds."""
    from jepsen_tpu_torch import synth
    from jepsen_tpu_torch.elle import append, wr
    t0 = time.monotonic()
    if kind == "append":
        res = append.check(synth.list_append_history(**params),
                           additional_graphs=graphs, cycle_backend="host")
    else:
        res = wr.check(synth.wr_register_history(**params),
                       linearizable_keys=True, additional_graphs=graphs,
                       cycle_backend="host")
    return {"valid?": res["valid?"], "anomaly-types": res["anomaly-types"],
            "anomalies": {k: [{"cycle": c} for c in v]
                          for k, v in cycles(res).items()},
            "seconds": time.monotonic() - t0}


def elle_phases(dev, host10, step_us: float, background) -> list:
    """Elle on the card: the small corpora, the 3k cells (dense closure
    and trim), the invalid histories, the 10k cell (packed closure), and
    the sharded closure over shards of the card (its verdict against
    `host10`, the future of `elle_host_verdict(ELLE_10K)`). The host
    oracle's verdicts on the 3k and invalid histories are taken in
    `background` while the card works. Returns the four kernels' entries
    of the kernels line."""
    from jepsen_tpu_torch import occupancy, synth
    from jepsen_tpu_torch.elle import append, build, wr
    from jepsen_tpu_torch.elle import tpu as etpu

    host_of = {(kind, params is ELLE_3K): background.submit(
        elle_host_verdict, params, RT, kind) for kind, params in (
        ("append", ELLE_3K), ("wr", ELLE_3K), ("wr", ELLE_STALE),
        ("append", ELLE_CORRUPT))}

    S = len(etpu.SUBSETS)
    int_ops_per_s = card_peak("int32_ops")
    hbm = card_peak("hbm_bytes_per_s")

    # ---- small corpora: every kernel == its plain version ---------------
    errs = {"elle_closure": 0, "elle_packed_closure": 0, "elle_trim": 0}
    for name, g in elle_graphs().items():
        _, err, perr, pderr, _, _, _ = run_closures(g, dev)
        _, terr, _, _, _ = run_trim(g, dev)
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
        host = host_of[kind, True].result()
        host_s = host["seconds"]
        same_verdict(f"elle {kind} 3k auto vs host", res, host)
        gt = builder(hist)
        Peaks.add(f"elle {kind} 3k bf16", t.gates, t.peak,
                  elle_plan(gt, "auto", [dev]))
        dev_s = (sum(sq) + sum(lab)) / 1e3
        print(f"  wall split: build {t.build_s:.4f} s, kernels {dev_s:.4f} "
              f"s, the rest (lint, direct anomalies, host prep, copies) "
              f"{wall - t.build_s - dev_s:.4f} s; host oracle {host_s:.2f} "
              f"s (in the background), same verdict")

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
        tgot, terr, tplain_s, ti, tref = run_trim(gt, dev)
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
              f"({rt_off[1]} peels); trim_ref with them off "
              f"{rt_off[3]:.1f} ms", flush=True)
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
                         bodies=ut["iters_run"] // 2, trim_ref=tref,
                         rt_off=rt_off, hist=hist)

    # ---- invalid histories: device == host, G-single among them -------------
    for kind, hist in (
            ("wr", synth.wr_register_history(**ELLE_STALE)),
            ("append", synth.list_append_history(**ELLE_CORRUPT))):
        check, kw, _ = builders[kind]
        res, wall, counts, t = elle_drive(check, hist, cycle_backend="auto",
                                          **kw)
        host = host_of[kind, False].result()
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
    _, terr10, tplain10_s, ti10, tref10 = run_trim(gt, dev)
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
    host_trim_entry = host_trim_phase(out, ti10, tref10, t10_ms,
                                      tplain10_s * 1e3)
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
        "library_ms": None}, sharded_entry, host_trim_entry]


def host_trim_phase(out, ti10, tref10, t10_ms: float,
                    plain10_ms: float) -> dict:
    """The host trim (`csrc/elle_trim_host.cpp`) inside `elle_phases`:
    the 3k list-append history checked with `device="cpu"` (the CPU's
    main path: the route takes the device engine and the trim; the host
    trim's count at 0 just before, read just after), then the kernel on
    CPU copies of the card's trim inputs at the 3k append, the 3k wr,
    the 10k append and the 3k append with the realtime thresholds off,
    each held against the `trim_ref` result the card's kernel was held
    against (`out` from the 3k cells, `ti10` / `tref10` the 10k's).
    Returns the kernels line's entry."""
    from jepsen_tpu_torch.elle import append
    from jepsen_tpu_torch.elle import tpu as etpu

    d = out["append"]
    etpu.trim.host_calls = 0
    t0 = time.monotonic()
    res = append.check(d["hist"], additional_graphs=RT,
                       cycle_backend="auto", device="cpu")
    wall = time.monotonic() - t0
    calls = etpu.trim.host_calls
    u = res.get("cycle-util") or {}
    print(f"elle host trim ({host_cpu_line()}): append 3k with "
          f"device=\"cpu\": valid? {res['valid?']} engine "
          f"{res.get('cycle-engine')} kernel {u.get('kernel')} iters_run "
          f"{u.get('iters_run')}, host trim calls {calls}, wall "
          f"{wall:.4f} s (kernel_s {u.get('kernel_s')})", flush=True)
    if (res.get("cycle-engine") != "device" or u.get("kernel") != "trim"
            or calls != 1 or res["valid?"] != d["res"]["valid?"]):
        raise AssertionError(f"elle append 3k on the CPU: {res['valid?']} "
                             f"{res.get('cycle-engine')} {u}, {calls} "
                             "host trim calls")
    shapes = (
        ("append 3k", d["trim_inputs"], d["trim_ref"], True,
         d["trim_ms"][0], d["trim_plain_ms"]),
        ("wr 3k", out["wr"]["trim_inputs"], out["wr"]["trim_ref"], True,
         out["wr"]["trim_ms"][0], out["wr"]["trim_plain_ms"]),
        ("append 10k", ti10, tref10, True, t10_ms, plain10_ms),
        ("append 3k, realtime off", d["trim_inputs"], d["rt_off"][2],
         False, d["rt_off"][4], d["rt_off"][3]))
    rows = {}
    for label, t, ref, use_rt, card_ms, plain_ms in shapes:
        r = host_trim_vs_ref(t, ref, use_rt)
        rows[label] = r
        print(f"  {label} (n_pad {t['n_pad']}, {r['bodies']} bodies): host "
              f"trim {[round(x, 4) for x in r['times']]} ms, median "
              f"{r['ms']:.4f} ms; == trim_ref (live planes, every count "
              f"row, bodies); the card's kernel {card_ms:.4f} ms, trim_ref "
              f"{plain_ms:.1f} ms (on the card); bound {r['bytes']} B at "
              f"the copy rate = {r['bound_ms']:.6f} ms", flush=True)
    a = rows["append 3k"]
    return {
        "name": "elle_trim_host", "route": "cuda", "platform": "cpu",
        "source": "jepsen_tpu_torch/csrc/elle_trim_host.cpp",
        "replaces": "jepsen_tpu/elle/tpu.py:899", "launches": calls,
        "max_abs_err": max(r["err"] for r in rows.values()),
        "ms": a["ms"], "plain_ms": d["trim_plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": "bytes", "library_ms": None}


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


# the host lane's own limit (`host_lane_phases`), and its shapes: the
# headline's narrow chunks at K 2 and K 512, the 16-wave's wide chunk at
# K 256, each a short chunk; the three-lane race against the two-lane
# race in turns
HOST_LANE_LIMIT_S = 25
HOST_LANE_ROUNDS = 64
HOST_LANE_WIDE_ROUNDS = 16
HOST_LANE_TURNS = 4
HOST_COPY_BYTES = 1 << 30     # the host copy that rates the host's bytes

# the headline's host oracle in a process of its own, at a low priority
# (about 100 s of one core): argv[1] the HEADLINE dict as JSON; prints
# one JSON line, the verdict and its seconds
HEADLINE_ORACLE = """
import json, sys, time
from jepsen_tpu_torch import synth
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import wgl_ref
h = synth.cas_register_history(**json.loads(sys.argv[1]))
t0 = time.monotonic()
r = wgl_ref.check(cas_register(), h)
print(json.dumps({"valid": r["valid?"], "seconds": time.monotonic() - t0}))
"""


def host_cpu_line() -> str:
    """The host CPU's model (`lscpu`'s "Model name", else /proc/cpuinfo's
    "model name", else its vendor, family and model numbers) and the
    cores this process may run on."""
    import os
    lines = []
    try:
        lines = subprocess.run(["lscpu"], capture_output=True, text=True,
                               timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        with open("/proc/cpuinfo") as fh:
            lines += fh.read().split("\n\n")[0].splitlines()
    except OSError:
        pass
    info = {}
    for ln in lines:
        key, _, value = ln.partition(":")
        info.setdefault(key.strip().lower(), value.strip())
    model = info.get("model name") or " ".join(
        f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model")
        if info.get(k)) or "unknown"
    return (f"{model}; {len(os.sched_getaffinity(0))} cores of "
            f"{os.cpu_count()}")


@functools.lru_cache(maxsize=None)
def host_copy_rate() -> float:
    """Bytes a second a numpy copy of HOST_COPY_BYTES moves on the host
    (each byte read once and written once: 2 x HOST_COPY_BYTES), the
    best of three; measured once a process."""
    src = np.ones(HOST_COPY_BYTES, np.uint8)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return 2 * HOST_COPY_BYTES / best


class LaneClock:
    """Each lane of a competition race timed from its engine's call to
    its return, by wrapping the functions the race calls (`wgl.check`,
    `wgl_ref.check`) and naming the lane by its thread; `host_off`
    makes the host kernel's lane (`wgl.check(device="cpu")`) return
    unknown at once: the two-lane race, switched off in the smoke only."""

    def __init__(self, host_off: bool = False):
        from jepsen_tpu_torch.ops import wgl, wgl_ref
        self.mods = {"wgl": wgl, "wgl_ref": wgl_ref}
        self.host_off = host_off
        self.lanes: dict = {}

    def __enter__(self):
        import threading
        self.orig = {k: m.check for k, m in self.mods.items()}
        self.t0 = time.monotonic()

        def wrap(orig):
            def run(*a, **kw):
                name = threading.current_thread().name.replace("wgl-", "")
                t_in = time.monotonic() - self.t0
                if self.host_off and str(kw.get("device")) == "cpu":
                    r = {"valid?": "unknown", "cause": "lane off"}
                else:
                    r = orig(*a, **kw)
                self.lanes[name] = (round(t_in, 4),
                                    round(time.monotonic() - self.t0, 4),
                                    r.get("valid?"))
                return r
            return run

        for k, m in self.mods.items():
            m.check = wrap(self.orig[k])
        return self

    def __exit__(self, *exc):
        for k, m in self.mods.items():
            m.check = self.orig[k]


def host_counts() -> dict:
    """The host kernel's chunks run on CPU tensors, by entry point."""
    from jepsen_tpu_torch.ops import wgl32, wgln
    return {"wgl32_host_chunk": wgl32.chunk.host_calls,
            "wgln_host_chunk": wgln.chunk.host_calls}


def host_lane_phases(h, wave, tail_host_chunks: int) -> tuple:
    """The competition's third lane on the card, `device@cpu`: the
    same search on the host kernel (`csrc/wgl_host.cpp`, one host core,
    built here with the host compiler), within HOST_LANE_LIMIT_S.

      1. the host kernel against its plain version (`chunk_ref` on CPU
         tensors, the same inputs), every carry leaf and the summary
         equal: the headline's narrow chunk at K 2 (HOST_LANE_ROUNDS
         rounds from the start), then at K 512 after migrating that
         beam, and the 16-wave's wide chunk at K 256
         (HOST_LANE_WIDE_ROUNDS rounds); the host kernel timed three
         times from the same start (host clock), the plain version once,
         and the bound: the chunk's least bytes
         (`occupancy.wgl_chunk_bytes`, from the plain version's tally)
         at the host's copy rate (`host_copy_rate`);
      2. the headline's `competition` on the card with its three lanes
         (device, oracle, device@cpu; `LaneClock`): the winner, each
         lane's wall, the host lane's chunks, the card's launches, the
         drain (the race's wall after the winner's verdict); then
         HOST_LANE_TURNS turns of the three-lane race against the
         two-lane one (the host lane returning unknown at once), in
         turns, the medians beside each other.

    The headline's host oracle runs in a process of its own from the
    start (`HEADLINE_ORACLE`, ~100 s of one core); the returned process
    is read before the bench (`await_headline_oracle`). Returns (the
    kernels line's two host entries, the three-lane verdict, that
    process)."""
    import atexit
    import os

    t_all = time.monotonic()
    oracle = subprocess.Popen(
        [sys.executable, "-c", HEADLINE_ORACLE, json.dumps(HEADLINE)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    os.setpriority(os.PRIO_PROCESS, oracle.pid, 10)
    # whatever fails after this, the process ends with the smoke
    atexit.register(lambda: oracle.poll() is None and (oracle.kill(),
                                                       oracle.wait()))
    return (*host_lane_steps(h, wave, tail_host_chunks, t_all), oracle)


def host_lane_steps(h, wave, tail_host_chunks: int, t_all: float) -> tuple:
    """`host_lane_phases`' steps 1 and 2; returns (the two kernel
    entries, the three-lane verdict)."""
    from jepsen_tpu_torch import checker, occupancy
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import adapt, encode, wgl, wgl32, wgln

    print(f"host lane ({card_line()}; host CPU {host_cpu_line()}):",
          flush=True)
    rate = host_copy_rate()
    print(f"  host copy rate: {rate / 1e9:.3f} GB/s (numpy copy of "
          f"{HOST_COPY_BYTES} B, read and written, best of 3)", flush=True)

    def clone(carry):
        return tuple(t.clone() for t in carry)

    def host_vs_plain(mod, consts, start, **kw):
        times = []
        for _ in range(3):
            c = clone(start)
            t0 = time.perf_counter()
            out, s = mod.chunk(consts, c, **kw)
            times.append((time.perf_counter() - t0) * 1e3)
        tally: dict = {}
        t0 = time.perf_counter()
        ref, rs = mod.chunk_ref(consts, clone(start), tally=tally, **kw)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_abs_err(out, ref), max_abs_err([s], [rs]))
        if not (same_carry(out, ref) and torch.equal(s, rs)):
            raise AssertionError(f"{mod.__name__} host kernel differs from "
                                 f"chunk_ref (max abs err {err}) at {kw}")
        C = start[wgl32.FR].shape[1]
        nbytes = occupancy.wgl_chunk_bytes(s[:wgl32.SUMMARY_HEAD].tolist(),
                                           C, tally, s.numel())
        return out, s, float(np.median(times)), times, plain_ms, err, nbytes

    def consts_of(enc, ic):
        return wgl32.consts_from_numpy(
            enc.inv, enc.ret, enc.opcode, enc.sufminret, enc.inv_info[:ic],
            enc.opcode_info[:ic], enc.table, enc.n_ok, enc.n_info,
            200_000_000, "cpu")

    # ---- 1. the host kernel against chunk_ref, at the main paths' shapes
    enc = encode.encode(cas_register(), h)
    plan = wgl.derive_plan(window_raw=enc.window_raw,
                           ic_pad=len(enc.inv_info), n=enc.n_ok,
                           n_info=enc.n_info, accel=True)
    kw = dict(W=plan["W_eff"], ic=plan["ic_eff"], H=plan["H"], B=plan["B"],
              chunk=HOST_LANE_ROUNDS, probes=plan["probes"])
    consts = consts_of(enc, kw["ic"])
    C = wgl32.row_words(kw["ic"])
    start = wgl32.init_carry(plan["K"], C, kw["H"], kw["B"], 0, "cpu")
    out, s, ms2, times2, plain2, err2, bytes2 = host_vs_plain(
        wgl32, consts, start, K=plan["K"], **kw)
    bound2 = bytes2 / rate * 1e3
    print(f"  headline narrow chunk, K={plan['K']}, {int(s[5])} rounds: "
          f"host kernel {[round(t, 4) for t in times2]} ms, median "
          f"{ms2:.4f} ms ({ms2 * 1e3 / max(int(s[5]), 1):.3f} us/round); "
          f"chunk_ref {plain2:.1f} ms; identical; bound {bytes2} B at the "
          f"copy rate = {bound2:.6f} ms", flush=True)
    wide = adapt.migrate_frontier(out, 512)
    _, s, ms512, times512, plain512, err512, bytes512 = host_vs_plain(
        wgl32, consts, wide, K=512, **kw)
    print(f"  headline narrow chunk after migrating to K=512, {int(s[5])} "
          f"rounds: host kernel {[round(t, 4) for t in times512]} ms, median "
          f"{ms512:.4f} ms ({ms512 * 1e3 / max(int(s[5]), 1):.3f} us/round);"
          f" chunk_ref {plain512:.1f} ms; identical; bound {bytes512} B = "
          f"{bytes512 / rate * 1e3:.6f} ms", flush=True)
    wenc = encode.encode(cas_register(), wave)
    wplan = wgl.derive_plan(window_raw=wenc.window_raw,
                            ic_pad=len(wenc.inv_info), n=wenc.n_ok,
                            n_info=wenc.n_info, accel=True)
    wkw = dict(L=wplan["L"], ic=wplan["ic_eff"], H=wplan["H"], B=wplan["B"],
               chunk=HOST_LANE_WIDE_ROUNDS, probes=wplan["probes"])
    wconsts = consts_of(wenc, wkw["ic"])
    wstart = wgln.init_carry(wplan["K"], wkw["L"], wkw["ic"], wkw["H"],
                             wkw["B"], 0, "cpu")
    _, s, wms, wtimes, wplain, werr, wbytes = host_vs_plain(
        wgln, wconsts, wstart, K=wplan["K"], **wkw)
    wbound = wbytes / rate * 1e3
    print(f"  16-wave wide chunk, K={wplan['K']} (L={wkw['L']}), {int(s[5])} "
          f"rounds: host kernel {[round(t, 4) for t in wtimes]} ms, median "
          f"{wms:.4f} ms ({wms * 1e3 / max(int(s[5]), 1):.3f} us/round); "
          f"chunk_ref {wplain:.1f} ms; identical; bound {wbytes} B = "
          f"{wbound:.6f} ms", flush=True)

    # ---- 2. the headline's competition: three lanes, then in turns ------
    lin = checker.linearizable(cas_register())

    def race(host_off: bool):
        torch.cuda.synchronize()
        zero_counts()
        h0 = host_counts()["wgl32_host_chunk"]
        with LaneClock(host_off) as clock:
            t0 = time.monotonic()
            res = lin.check({}, h, {})
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        chunks = host_counts()["wgl32_host_chunk"] - h0
        return res, wall, clock.lanes, chunks, read_counts()["wgl32_chunk"]

    res, wall, lanes, chunks, launched = race(False)
    winner = res.get("engine")
    won_at = lanes.get(winner, (0, wall))[1]
    print(f"  headline competition, three lanes: valid? {res['valid?']} "
          f"engine {winner} wall {wall:.4f} s, lanes (start, end s, verdict)"
          f" {json.dumps(lanes)}; host lane chunks {chunks}, wgl32_chunk "
          f"launches {launched}; drain after the winner's verdict "
          f"{wall - won_at:.4f} s", flush=True)
    if (res["valid?"] is not True or set(lanes) != {"device", "oracle",
                                                     "device@cpu"}
            or chunks < 1 or launched < 1):
        raise AssertionError(f"three-lane headline: {res['valid?']}, lanes "
                             f"{sorted(lanes)}, {chunks} host chunks, "
                             f"{launched} launches")
    turns: dict = {3: [], 2: []}
    engines: dict = {3: [], 2: []}
    drains: dict = {3: [], 2: []}
    for turn in range(HOST_LANE_TURNS):
        for n in ((3, 2) if turn % 2 == 0 else (2, 3)):
            r, w, ln, _, _ = race(n == 2)
            if r["valid?"] is not True:
                raise AssertionError(f"{n}-lane headline: {r['valid?']}")
            turns[n].append(round(w, 4))
            engines[n].append(r.get("engine"))
            drains[n].append(round(w - ln.get(r.get("engine"), (0, w))[1],
                                   4))
    med3, med2 = float(np.median(turns[3])), float(np.median(turns[2]))
    print(f"  in turns (s): three lanes {turns[3]} (engines {engines[3]}, "
          f"drains {drains[3]}), two lanes {turns[2]} (engines {engines[2]},"
          f" drains {drains[2]}); medians {med3:.4f} / {med2:.4f} s "
          f"({(med3 / med2 - 1) * 100:+.1f}%)", flush=True)
    print(f"  long tail's three-lane race (the default checker above): "
          f"host lane chunks {tail_host_chunks}", flush=True)
    took = time.monotonic() - t_all
    print(f"  host lane: {took:.1f} s", flush=True)
    if took > HOST_LANE_LIMIT_S:
        raise AssertionError(f"host lane took {took:.1f} s (limit "
                             f"{HOST_LANE_LIMIT_S} s)")
    entries = [{
        "name": "wgl32_host_chunk", "route": "cuda", "platform": "cpu",
        "source": "jepsen_tpu_torch/csrc/wgl_host.cpp",
        "replaces": "jepsen_tpu/ops/wgl32.py:725", "launches": chunks,
        "max_abs_err": max(err2, err512), "ms": ms2, "plain_ms": plain2,
        "bound_ms": bound2, "bound_by": "bytes", "library_ms": None}, {
        "name": "wgln_host_chunk", "route": "cuda", "platform": "cpu",
        "source": "jepsen_tpu_torch/csrc/wgl_host.cpp",
        "replaces": "jepsen_tpu/ops/wgln.py:322",
        "launches": tail_host_chunks, "max_abs_err": werr, "ms": wms,
        "plain_ms": wplain, "bound_ms": wbound, "bound_by": "bytes",
        "library_ms": None}]
    return entries, res["valid?"]


def await_headline_oracle(oracle, verdict, limit_s: float = 240.0) -> None:
    """The headline's host oracle (`host_lane_phases`' process): its
    verdict equal to the three-lane race's."""
    try:
        out, err = oracle.communicate(timeout=limit_s)
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.wait()
    if oracle.returncode != 0:
        raise AssertionError(f"headline oracle exited {oracle.returncode}:"
                             f"\n{err[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    print(f"headline host oracle: {got['valid']} in {got['seconds']:.1f} s "
          f"(its own process); the three-lane race's verdict {verdict}",
          flush=True)
    if got["valid"] != verdict:
        raise AssertionError(f"headline: oracle {got['valid']} != race "
                             f"{verdict}")


# the random wide batches held equal between the batched kernel's two
# forms: lanes, waves, width, span (each an inclusive range) and the
# share of invalid keys
WIDE_RANDOM = dict(batches=12, seed=32, lanes=(2, 16), waves=(0, 1),
                   width=(9, 13), span=(4, 5), invalid_p=0.4)


def wide_form_turns(dev, consts, start, kw) -> None:
    """The wide lane-batched chunk (`wgln_chunk_batched`) from `start`:
    one CTA a lane (`block_form`) against the cluster form at each g the
    card holds, in turns (a, b, b, a), every pair bit-identical, after
    one untimed launch of each form; prints each form's us a round (the
    lanes run side by side: a lane's round) and the form the rule
    picks."""
    from jepsen_tpu_torch.ops import wgl32, wgln

    K, L, ic = kw["K"], kw["L"], kw["ic"]
    sms, cap = wgln.card_shape(dev)
    one = wgl32.block_form(K, 32 * L, ic, wgln.row_words(L, ic))
    forms = [one] + [wgl32.Form("cluster", wgl32.MAX_THREADS, g)
                     for g in (2, 4, 8, 16) if cap[g] >= 1]

    def run(c, f):
        return wgl32.launch_batched(
            "wgln_chunk_batched", consts, c, K=K, W=32 * L, L=L, ic=ic,
            H=kw["H"], B=kw["B"], rounds=kw["chunk"], probes=kw["probes"],
            form=f)

    for f in forms:
        run(tuple(t.clone() for t in start), f)
    times, rounds, _ = form_turns(run, start, forms)
    pick = wgln.batched_form(consts.lanes, K, L, ic, sms=sms, capacity=cap)
    print(f"  wgln_chunk_batched forms in turns (a, b, b, a), "
          f"{consts.lanes} lanes, K {K}, L {L}, R {K * (32 * L + ic)} a "
          f"lane, {rounds} rounds, each pair bit-identical ({card_line()}; "
          f"{sms} SMs, clusters resident at once {cap}): "
          + "; ".join(f"{k} {[round(x, 4) for x in v]} ms = "
                      f"{float(np.mean(v)) * 1e3 / max(rounds, 1):.2f} "
                      f"us/round" for k, v in times.items())
          + f"; the rule picks {form_label(pick)}", flush=True)


def wide_form_random(dev) -> None:
    """WIDE_RANDOM's fixed-seed wide batches (valid and invalid wave
    keys of random widths and spans) through `check_batched` on the
    card, each twice: in the forms `wgln.batched_form` picks, then with
    the rule held to one CTA a lane (patched for that run); verdicts,
    configs and rounds equal key by key. Fails unless the first runs
    launched the cluster form and the second never did."""
    from jepsen_tpu_torch import synth
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import wgl32, wgln
    from jepsen_tpu_torch.parallel import batched

    r = WIDE_RANDOM
    rng = np.random.default_rng(r["seed"])
    rule = wgln.batched_form

    def one_cta(lanes, K, L, ic, **kw):
        return wgl32.block_form(K, 32 * L, ic, wgln.row_words(L, ic))

    t0 = time.monotonic()
    shapes, forms = [], {"rule": {}, "one CTA": {}}
    for i in range(r["batches"]):
        lanes = int(rng.integers(r["lanes"][0], r["lanes"][1] + 1))
        hists = []
        for _ in range(lanes):
            span = int(rng.integers(r["span"][0], r["span"][1] + 1))
            hists.append(synth.adversarial_wave_history(
                span + int(rng.integers(r["waves"][0], r["waves"][1] + 1)),
                width=int(rng.integers(r["width"][0], r["width"][1] + 1)),
                span=span, seed=int(rng.integers(1 << 30)),
                invalid=bool(rng.random() < r["invalid_p"])))
        outs = {}
        for name in ("rule", "one CTA"):
            wgln.batched_form = rule if name == "rule" else one_cta
            try:
                with Timed() as t:
                    res = batched.check_batched(
                        cas_register(), hists, strategy="vmap",
                        oracle_fallback=False, chunk=FANOUT_WAVE["chunk"])
            finally:
                wgln.batched_form = rule
            for f, n in t.form_counts("wgln_chunk_batched").items():
                forms[name][f] = forms[name].get(f, 0) + n
            outs[name] = [(x["valid?"], x["configs_explored"],
                           x["util"]["rounds"]) for x in res]
        if outs["rule"] != outs["one CTA"]:
            raise AssertionError(f"random wide batch {i} ({lanes} lanes): "
                                 f"{outs['rule']} != {outs['one CTA']}")
        shapes.append((lanes, sum(v is False for v, _, _ in outs["rule"]),
                       sum(c for _, c, _ in outs["rule"])))
    wall = time.monotonic() - t0
    print(f"  {r['batches']} random wide batches (seed {r['seed']}; lanes, "
          f"invalid keys, configs: {shapes}) through check_batched, the "
          f"rule's forms against one CTA a lane: verdicts, configs and "
          f"rounds equal key by key; forms {json.dumps(forms)}; "
          f"{wall:.2f} s", flush=True)
    if (not any(f.startswith("cluster") for f in forms["rule"])
            or any(f.startswith("cluster") for f in forms["one CTA"])):
        raise AssertionError(f"random wide batches: forms {forms}")


def wide_cluster_streams(dev, consts, start, kw) -> None:
    """Two mesh shards' wide polls (lanes 0-1 and 2-3 of the batch, in
    the cluster form the rule picks for 2 lanes) on two streams of the
    card at once, twice, each bit-identical to its run alone."""
    from jepsen_tpu_torch.ops import wgl32, wgln

    K, L, ic = kw["K"], kw["L"], kw["ic"]
    sms, cap = wgln.card_shape(dev)
    form = wgln.batched_form(2, K, L, ic, sms=sms, capacity=cap)
    if form.name != "cluster":
        raise AssertionError(f"2 wide lanes at K {K}: {form}")
    shards = [lanes_of(consts, start, idx) for idx in ([0, 1], [2, 3])]

    def run(sc, carry):
        return wgl32.launch_batched(
            "wgln_chunk_batched", sc, carry, K=K, W=32 * L, L=L, ic=ic,
            H=kw["H"], B=kw["B"], rounds=kw["chunk"], probes=kw["probes"],
            form=form)

    alone = []
    for sc, st in shards:
        c = tuple(t.clone() for t in st)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        summary = run(sc, c)
        e1.record()
        torch.cuda.synchronize()
        alone.append((c, summary, e0.elapsed_time(e1)))
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for turn in range(2):
        carries = [tuple(t.clone() for t in st) for _, st in shards]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = []
        for (sc, _), carry, stream in zip(shards, carries, streams):
            with torch.cuda.stream(stream):
                torch.cuda._sleep(1_000_000)
                outs.append(run(sc, carry))
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
        for (want, want_s, _), carry, summary in zip(alone, carries, outs):
            if not (same_carry(carry, want) and torch.equal(summary, want_s)):
                raise AssertionError("a cluster poll on two streams differs "
                                     "from the poll run alone")
    print(f"  two mesh shards' wide polls (2 lanes each, K {K}, "
          f"{form_label(form)}) on two streams at once, twice: both "
          f"identical to the poll alone each time; the second pair "
          f"{wall_ms:.3f} ms (host clock, a ~0.5 ms spin before each "
          f"included), alone {[round(a[2], 3) for a in alone]} ms (events)",
          flush=True)


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
    sms, cap = wgln.card_shape(dev)
    wform = wgln.batched_form(w["n_keys"], wplan["K"], wplan["L"],
                              wplan["ic"], sms=sms, capacity=cap)
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
          f"{w_bound_ms:.6f} ms; form {form_label(wform)}", flush=True)
    wide_form_turns(dev, wconsts, wstart, wkw)
    wide_cluster_streams(dev, wconsts, wstart, wkw)
    wide_form_random(dev)
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
          f"{w_launches} polls: {[round(x, 2) for x in wk_ms]} ms, summed "
          f"{sum(wk_ms):.3f} ms, forms "
          f"{t.form_counts('wgln_chunk_batched')}), rounds "
          f"{[r['util']['rounds'] for r in res]}, configs {got} (JAX "
          f"package: {FANOUT_WAVE_CONFIGS}), launches {counts}, peak memory "
          f"{peak} B", flush=True)
    if (any(r["valid?"] is not False for r in res) or w_launches < 1
            or got != FANOUT_WAVE_CONFIGS):
        raise AssertionError(f"wide fan-out: {got}")
    Peaks.add("fan-out waves vmap", t.gates, peak)

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
            # the device@cpu lane calls wgl.check too, on the CPU
            lane = ("device@cpu" if str(kw.get("device")) == "cpu"
                    else name)
            ends.append((lane, time.monotonic(), r.get("valid?"),
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
    # a key's race has three lanes on the card, each ending once
    joins = [round(ends[i + 2][1] - ends[i][1], 4)
             for i in range(0, len(ends) - 2, 3)]
    print(f"  per key, the last loser's end after the winner's verdict: "
          f"{joins} s", flush=True)
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
          f"{[round(x, 2) for x in t.ms('wgln_chunk_batched')]}, summed "
          f"{sum(t.ms('wgln_chunk_batched')):.3f} ms; peak memory "
          f"{peak} B; forms {t.form_counts('wgln_chunk_batched')}", flush=True)
    if ([r["valid?"] for r in res] != [r["valid?"] for r in vm]
            or not idle or counts["wgln_chunk_batched"] < 1
            or counts["wgl_lane_reset"] < 1):
        raise AssertionError(f"mesh waves: {counts}, idle pulls {idle}")
    Peaks.add(f"mesh waves {MESH_SHARDS} shards", t.gates, peak)
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


# fresh processes per mode, in turns (cold, bind, warm; then the reverse
# order): one turn, whose wall the suites phase's etcd runs take
WARM_TURNS = 1


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
    fresh processes (`WARM`), in WARM_TURNS turns: the headline's first check
    unwarmed ("cold", whose guard must count a load and a bind), with
    only its entry point bound ("bind": bound but never launched) and
    after `aot.precompile_service_bucket` ("warm", guard budget 0: h2d
    1, d2h one a chunk); the first turn's cold and warm processes also
    run the mesh fan-out (`check_mesh` over 2 shards of the card, after
    `aot.precompile_mesh_plan` when warm: its starting carries from the
    pool) and Elle append 3k (bf16) and 10k (packed) (after
    `aot.precompile_elle_closure` when warm), each verdict equal to the
    main run's (`python -m jepsen_tpu_torch.bench` runs in
    `bench_phases`). Any guard over its budget raises in its process,
    and the phase fails."""
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
    print(f"  warm phases: {time.monotonic() - t_all:.1f} s", flush=True)

SERVICE_WARM_REQUESTS = 8              # warm same-bucket requests timed


def same_bucket_seeds(want_key, n: int, start: int,
                      lie_p: float = 0.0, shape: dict = HEADLINE) -> list:
    """`n` (seed, history) pairs from `start` on whose histories of
    `shape` (n_ops, n_procs, crash_p; the headline's by default), with
    `lie_p` of lying reads, land in the service bucket `want_key`
    (`service.bucket_for`)."""
    from jepsen_tpu_torch import service, synth
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import encode

    out = []
    seed = start
    while len(out) < n:
        h = synth.cas_register_history(
            shape["n_ops"], n_procs=shape["n_procs"], seed=seed,
            crash_p=shape["crash_p"], lie_p=lie_p)
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


# phase (a): 2 s (10 s, the BASELINE's 10k ops, until the MySQL-wire runs
# joined the suites phase; 5 s until the pgwire runs did; 3 s until yuga's
# and raftis's did)
TEST_RUN = dict(concurrency="2n", time_limit=2, rate=1000)    # phase (a)
TEST_INVALID = dict(concurrency=10, time_limit=1, rate=1000)   # phase (b)
TEST_INDEP = dict(keys=100, ops_per_key=200, concurrency=20)   # phase (c)
TEST_ALL = dict(test_count=2, time_limit=1, rate=500)          # phase (d)


def log_wall(path: str, start: str, end: str) -> float:
    """Seconds between the first log line of `path` (a run's jepsen.log)
    that contains `start` and the first after it that contains `end`,
    from the lines' millisecond timestamps."""
    import datetime

    def stamp(line):
        return datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")

    t0 = None
    with open(path) as fh:
        for line in fh:
            if t0 is None and start in line:
                t0 = stamp(line)
            elif t0 is not None and end in line:
                return (stamp(line) - t0).total_seconds()
    raise AssertionError(f"{path}: no {start!r} .. {end!r} lines")


def test_phases(dev) -> None:
    """The test path on the card, as a Jepsen user runs a test: the
    generator, the interpreter against in-process clients over the dummy
    remote, `core.run`'s store and ledger, and the check on the card.

      (a) `python -m jepsen_tpu_torch test --concurrency 2n --time-limit
          2 --rate 1000` (TEST_RUN) in a fresh process with the
          reference's 5 default nodes: `stagger`'s rate is the total, so
          ~2,000 invocations of a cas-register made by the interpreter;
          exit 0, valid? True from "cuda-wgl" on the card
          with `wgl32_chunk` launches (its chunks, `util.chunks` in
          results.json), `test.jepsen`, `results.json` and `jepsen.log`
          in the run dir, one `kind="run"` and one `kind="checker"`
          ledger record, a final `current-status.json` (active False)
          whose op counts are the history's, and the stored history
          re-checked here by the host oracle ("wgl"): True;
      (b) in this process, `core.run` of the demo map with a client whose
          reads answer a value never written, ~1000 invocations: False,
          the host oracle's verdict, `linear.svg` in the run dir;
      (c) in this process, `core.run` of 100 keys x 200 invocations
          (`independent.concurrent_generator(2, range(100), ...)` at
          concurrency 20) against `fakes.IndependentAtomClient` with
          `FANOUT_BAD`'s lying keys, checked by
          `independent.cuda_checker(cas_register(), devices=[card] *
          MESH_SHARDS)`: the failing keys are the host oracle's per key,
          each a lying key that was read; one `kind="independent"`
          record;
      (d) `python -m jepsen_tpu_torch test-all --test-count 2 --time-limit
          1 --rate 500` in a fresh process: exit 0, "2 successes".

    (b) and (c) set every launch counter to 0 just before and read them
    just after; a fresh process's launches are its chunks."""
    import os
    import shutil
    import tempfile

    from jepsen_tpu_torch import checker, core, fakes, independent, ledger
    from jepsen_tpu_torch import client as jclient
    from jepsen_tpu_torch import fleet, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.__main__ import demo_test, demo_workload
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.parallel import mesh

    print(f"test path ({card_line()}):", flush=True)
    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="test-", dir=str(REPO / "build" /
                                                   "torch_kernels"))

    def host_oracle(h):
        return checker.linearizable(cas_register(), algorithm="wgl",
                                    device="cpu").check({}, h, {})

    # (a) the demo test at the headline's size, a fresh process
    root = os.path.join(tmp, "a")
    a = TEST_RUN
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "test", "--concurrency",
         a["concurrency"], "--time-limit", str(a["time_limit"]), "--rate",
         str(a["rate"]), "--store-root", root], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    proc_wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"test: exit {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    run = store.latest(root)
    for f in ("test.jepsen", "results.json", "jepsen.log"):
        if not os.path.exists(os.path.join(run, f)):
            raise AssertionError(f"test: no {f} in {run}")
    with open(os.path.join(run, "results.json")) as fh:
        res = json.load(fh)
    stored = store.load_latest(root)
    h = History(stored["history"]).index()
    invokes = sum(op.type == "invoke" for op in h)
    clients = sum(op.type == "invoke" and op.process != "nemesis"
                  for op in h)
    oracle = host_oracle(h)
    led = ledger.Ledger(root)
    runs = led.query(kind="run")
    checks = led.query(kind="checker")
    snap = fleet.read_status_file(root)
    log_path = os.path.join(run, "jepsen.log")
    analysis_s = log_wall(log_path, "Analyzing...", "Analysis complete")
    interp_s = (max(op.time for op in h) - min(op.time for op in h)) / 1e9
    u = res.get("util") or {}
    asked = a["rate"] * a["time_limit"]
    print(f"  (a) test {a}: exit 0; {invokes} invocations recorded "
          f"against ~{asked} asked ({invokes / asked:.4f}), {len(h)} ops; "
          f"interpreter wall {interp_s:.4f} s (first to last op), analysis "
          f"wall {analysis_s:.3f} s (jepsen.log), search wall "
          f"{res.get('wall_s')} s, {u.get('chunks')} wgl32_chunk launches "
          f"(chunks), configs {res.get('configs_explored')}, valid? "
          f"{res['valid?']} ({res.get('algorithm')} on {res.get('device')}),"
          f" host oracle {oracle['valid?']}; run record wall "
          f"{runs[0]['wall_s'] if runs else None} s; process wall "
          f"{proc_wall:.4f} s; status ops {snap and snap.get('ops')}",
          flush=True)
    if invokes < 0.8 * asked:
        # `stagger` schedules each op a random interval (mean 1/rate)
        # after the previous op's dispatch, so the scheduler's lateness
        # in dispatching adds to every interval
        inv_t = sorted(op.time for op in h if op.type == "invoke")
        gap_ms = (inv_t[-1] - inv_t[0]) / (len(inv_t) - 1) / 1e6
        print(f"  (a) the interpreter recorded {invokes} of ~{asked} "
              f"invocations asked: the host loop bounds the rate; mean "
              f"interval between invocations {gap_ms:.4f} ms against "
              f"1/rate {1e3 / a['rate']:.4f} ms, {gap_ms - 1e3 / a['rate']:.4f}"
              f" ms a dispatch added by the scheduler", flush=True)
    if (res["valid?"] is not True or res.get("algorithm") != "cuda-wgl"
            or res.get("platform") != "cuda" or not u.get("chunks")
            or oracle["valid?"] is not True or clients != invokes
            or [r["verdict"] for r in runs] != [True]
            or [r["verdict"] for r in checks] != [True]
            or snap is None or snap.get("active") is not False
            or snap.get("ops") != {"invoked": invokes,
                                   "completed": len(h) - invokes}):
        raise AssertionError(f"test (a): {res}, oracle {oracle['valid?']}, "
                             f"runs {runs}, checks {checks}, status {snap}")

    # (b) a lying client, in this process
    class LyingClient(jclient.Client):
        def invoke(self, test, op):
            if op["f"] == "read":
                return {**op, "type": "ok", "value": 99}
            return {**op, "type": "ok"}

    b = TEST_INVALID
    test = demo_test({"name": "liar", "store_root": os.path.join(tmp, "b"),
                      "concurrency": b["concurrency"],
                      "time_limit": b["time_limit"], "rate": b["rate"],
                      "device": dev})
    test["client"] = LyingClient()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    out = core.run(test)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    res = out["results"]
    oracle = host_oracle(out["history"])
    invokes = sum(op.type == "invoke" for op in out["history"])
    svg = os.path.join(store.latest(test["store_root"]), "linear.svg")
    print(f"  (b) lying client {b}: {invokes} invocations, valid? "
          f"{res['valid?']} (host oracle {oracle['valid?']}), run wall "
          f"{wall:.4f} s, search wall {res.get('wall_s')} s, linear.svg "
          f"{os.path.exists(svg)}, launches {counts}", flush=True)
    if (res["valid?"] is not False or oracle["valid?"] is not False
            or not os.path.exists(svg) or counts["wgl32_chunk"] < 1):
        raise AssertionError(f"test (b): {res}, {counts}")

    # (c) the independent run, in this process
    c = TEST_INDEP
    bad = set(FANOUT_BAD["keys"])
    root = os.path.join(tmp, "c")
    test = {**fakes.noop_test(), "name": "indep", "store_root": root,
            "concurrency": c["concurrency"], "ssh": {"dummy?": True},
            "client": fakes.IndependentAtomClient(lie_keys=bad),
            "generator": independent.concurrent_generator(
                2, range(c["keys"]),
                lambda k: gen.limit(c["ops_per_key"], demo_workload())),
            "checker": independent.cuda_checker(
                cas_register(), devices=[dev] * MESH_SHARDS)}
    mesh.pool_settle()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    out = core.run(test)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    res = out["results"]
    h = out["history"]
    oracle = independent.checker(checker.linearizable(
        cas_register(), algorithm="wgl", device="cpu")).check({}, h, {})
    read = {op.value.k for op in h
            if op.f == "read" and op.type == "ok"
            and independent.is_tuple(op.value)}
    recs = [(r["name"], r["keys"], r["failures"], r.get("engine"))
            for r in ledger.Ledger(root).query(kind="independent")]
    invokes = sum(op.type == "invoke" for op in h)
    print(f"  (c) independent {c} with lying keys {sorted(bad)}: "
          f"{invokes} invocations, valid? {res['valid?']}, failures "
          f"{sorted(res['failures'])} (host oracle "
          f"{sorted(oracle['failures'])}), run wall {wall:.4f} s, "
          f"wgl32_chunk_batched {counts['wgl32_chunk_batched']}, "
          f"wgl_lane_reset {counts['wgl_lane_reset']}, "
          f"wgl_frontier_migrate {counts['wgl_frontier_migrate']} "
          f"launches (all {counts}); ledger independent records {recs}",
          flush=True)
    if (sorted(res["failures"]) != sorted(oracle["failures"])
            or set(res["failures"]) != bad & read
            or len(independent.history_keys(h)) != c["keys"]
            or recs != [("indep", c["keys"], len(res["failures"]),
                         "device-mesh")]
            or counts["wgl32_chunk_batched"] < 1
            or counts["wgl_lane_reset"] < 1):
        raise AssertionError(f"test (c): {res['failures']}, oracle "
                             f"{oracle['failures']}, {recs}, {counts}")
    mesh.pool_settle()

    # (d) test-all, a fresh process
    d = TEST_ALL
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "test-all",
         "--test-count", str(d["test_count"]), "--time-limit",
         str(d["time_limit"]), "--rate", str(d["rate"]), "--store-root",
         os.path.join(tmp, "d")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    print(f"  (d) test-all {d}: exit {proc.returncode} in "
          f"{time.monotonic() - t0:.4f} s (a fresh process), "
          f"{[ln for ln in proc.stdout.splitlines() if ln.endswith('successes')]}",
          flush=True)
    if proc.returncode != 0 or "2 successes" not in proc.stdout:
        raise AssertionError(f"test-all: exit {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"  test phases: {time.monotonic() - t_all:.1f} s", flush=True)


# ---- the plot checkers, the autopilot and the one CLI --------------------------

class per_k_launches:
    """While active, `mod.chunk` (`ops/wgl32` or `ops/wgln`) records each
    call's K beside the launches counted during the call: `.per_k` maps
    K to launches. A wrapper counts on its module's name for itself
    (`_count_launch`), so the stand-in carries the count while active
    and hands it back to the wrapper, restored, on exit."""

    def __init__(self, mod):
        self.mod = mod
        self.per_k: dict = {}

    def __enter__(self):
        real = self.real = self.mod.chunk

        def shim(*a, **kw):
            n0 = shim.launches
            try:
                return real(*a, **kw)
            finally:
                k = int(kw["K"])
                self.per_k[k] = self.per_k.get(k, 0) + shim.launches - n0

        shim.launches = real.launches
        self.mod.chunk = shim
        return self

    def __exit__(self, *exc):
        self.real.launches = self.mod.chunk.launches
        self.mod.chunk = self.real
        return False


def plots_phases(dev) -> None:
    """The plot checkers on the card: `checker.compose({"linear":
    linearizable(cas_register(), algorithm="cuda-wgl"), "perf": perf(),
    "clock": clock_plot()})` over the headline at full size, under an
    installed metrics registry, every count set to 0 just before and
    read just after. `occupancy.heatmap_points` of the result's drained
    rounds must give one point per drained round (`rounds_seen` less
    `rounds_truncated`), rounds strictly increasing, fill in [0, 1], and
    equal the points of the `wgl_rounds` series the same launches
    drained (at least one `wgl32_chunk`; the series holds every drained
    round, the result the first `occupancy.MAX_RESULT_ROUNDS`). Without
    matplotlib (`plots._plt` is None) no `*-png` key and no file may
    appear; with it every file named must exist and be non-empty."""
    import os
    import shutil
    import tempfile

    from jepsen_tpu_torch import checker, metrics, occupancy, synth
    from jepsen_tpu_torch.checker import plots
    from jepsen_tpu_torch.models import cas_register

    print(f"plot checkers ({card_line()}):", flush=True)
    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="plots-", dir=str(REPO / "build" /
                                                    "torch_kernels"))
    h = synth.cas_register_history(**HEADLINE)
    test = {"name": "plots", "start_time": "20260101T000000",
            "store_root": tmp}
    have_mpl = plots._plt() is not None
    reg = metrics.Registry()
    composed = checker.compose({
        "linear": checker.linearizable(cas_register(), algorithm="cuda-wgl"),
        "perf": checker.perf(), "clock": checker.clock_plot()})
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    with metrics.use(reg):
        res = composed.check(test, h, {})
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    lin = res["linear"]
    occ = lin["occupancy"]
    pts = occupancy.heatmap_points(occ["rounds"])
    drained = occ["rounds_seen"] - occ["rounds_truncated"]
    rounds = [p["round"] for p in pts]
    series_pts = occupancy.heatmap_points(reg.series("wgl_rounds").points)

    def png_keys(r):
        out = []
        for k, v in r.items():
            if k.endswith("-png"):
                out.append((k, v))
            elif isinstance(v, dict):
                out += png_keys(v)
        return out

    pngs = png_keys(res)
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(tmp)
                   for f in fs)
    print(f"  headline {HEADLINE} with perf() and clock_plot(): valid? "
          f"{res['valid?']} in {wall:.4f} s, launches {counts}; "
          f"matplotlib {'present' if have_mpl else 'absent'}; heatmap "
          f"points {len(pts)} of {drained} drained rounds "
          f"({occ['rounds_total']} run), rounds {rounds[:1]}..{rounds[-1:]}, "
          f"fill {min(p['fill'] for p in pts):.3f}.."
          f"{max(p['fill'] for p in pts):.3f}; png keys "
          f"{[k for k, _ in pngs]}; files {[os.path.basename(f) for f in files]}",
          flush=True)
    if (res["valid?"] is not True or counts["wgl32_chunk"] < 1
            or not pts or len(pts) != drained
            or any(b <= a for a, b in zip(rounds, rounds[1:]))
            or any(not 0.0 <= p["fill"] <= 1.0 for p in pts)
            or len(series_pts) != occ["rounds_seen"]
            or series_pts[:len(pts)] != pts):
        raise AssertionError(f"plots: {res['valid?']}, {counts}, "
                             f"{len(pts)} points of {drained}")
    if not have_mpl and (pngs or files):
        raise AssertionError(f"plots without matplotlib: {pngs} {files}")
    if have_mpl and (not pngs or not files or any(
            not os.path.isfile(p) or os.path.getsize(p) == 0
            for _, p in pngs)):
        raise AssertionError(f"plots with matplotlib: {pngs} {files}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"  plots phase: {time.monotonic() - t_all:.1f} s", flush=True)


AUTOPILOT_BATCH = dict(n_ops=500, n_procs=4, seed=21)   # 4 same-bucket


def autopilot_phases(dev) -> tuple:
    """The autopilot on the card: the reference's three proofs
    (`scripts/autopilot_smoke.py`), then the same loop over a live
    service.

      (a) a compile-storm corpus (50 `independent` records of one
          compile each and a one-bucket preflight plan) in a store's
          ledger fires D001 (`doctor.diagnose`); the supervisor's
          warm-bucket actuator runs `ops/aot.precompile_service_bucket`
          over the headline's canonical bucket on the card, every count
          set to 0 just before the step and read just after: one
          `wgl32_chunk` launch at each ladder K (counted per K); a second
          warm under `CompileGuard(max_compiles=0)` counts 0 builds,
          loads and binds; the next pass past the deadline settles
          `verdict="verified"`;
      (b) a finding whose metric never improves (D003): the action is
          reverted (the rollback runs), the rule quarantined, a re-fire
          `suppressed`, the actuator run exactly once;
      (c) `autopilot.replay` over the banked diagnosis names the rules
          the live supervisor decided on;
      (d) `Service(devices=[card] * MESH_SHARDS, autopilot=True)` with 4
          held same-bucket requests: the storm seeded in the service's
          ledger, the supervisor's own `ServiceHost` warms the held
          requests' bucket (the serial ladder and the mesh lane-group
          plan), the next pass verifies; released, the 4 requests serve
          as one mesh batch (counted), each True.

    Returns (the store of (a)-(c), with a storm record banked last for
    the CLI's replay, and the 4 request bodies)."""
    import os
    import tempfile

    from jepsen_tpu_torch import (autopilot, doctor, fs_cache, ledger,
                                  metrics, service, synth)
    from jepsen_tpu_torch.analysis import guards
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import aot, encode, wgl32

    print(f"autopilot ({card_line()}):", flush=True)
    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="autopilot-", dir=str(REPO / "build" /
                                                        "torch_kernels"))
    head = synth.cas_register_history(**HEADLINE)
    _, bucket = service.bucket_for(encode.encode(cas_register(), head))
    store = os.path.join(tmp, "store")
    led = ledger.Ledger(store)
    reg = metrics.Registry()

    def storm(target):
        for i in range(50):
            target.record({"kind": "independent", "name": f"key-{i}",
                           "compiles": 1, "shapes": {"K": 16, "W_pad": 7}})
        target.record({"kind": "preflight", "name": "indep",
                       "verdict": "feasible", "rules": [],
                       "preflight": {"verdict": "feasible",
                                     "buckets": [16]}})

    class StoreHost(autopilot.Host):
        """Diagnose the store's banked records; warm through the real
        warm path on the card; probe compiles from the same ledger."""

        def __init__(self):
            self.warms: list = []

        def diagnose(self):
            # name order: records banked within a millisecond come back
            # from a query in the order of their random ids
            return doctor.diagnose(doctor.TelemetryView(
                target="storm", platform="gpu",
                records=sorted(led.query(), key=lambda r: r["name"])))

        def probe(self, metric, since=None):
            if metric != "recent_compiles":
                return None
            return float(sum(r["compiles"] for r in led.query(since=since)
                             if isinstance(r.get("compiles"), int)))

        def actuate(self, entry, finding):
            with per_k_launches(wgl32) as pk:
                walls = aot.precompile_service_bucket(bucket, device=dev)
            self.warms.append((walls, pk.per_k))
            return {"bucket": finding.get("subject"),
                    "ladder": sorted(walls)}, None

    # (a) storm -> warm -> verified
    storm(led)
    time.sleep(0.05)  # the storm stays strictly before the action
    host = StoreHost()
    sup = autopilot.Supervisor(host, every_s=60.0, verify_after_s=0.05,
                               where="smoke", mx=reg, ledger=led)
    report = host.diagnose()
    top = (report.get("findings") or [{}])[0]
    torch.cuda.synchronize()
    zero_counts()
    t_apply = time.monotonic()
    out1 = sup.step()
    torch.cuda.synchronize()
    counts = read_counts()
    walls, per_k = host.warms[0] if host.warms else ({}, {})
    with guards.CompileGuard(max_compiles=0, name="autopilot-rewarm") as g:
        aot.precompile_service_bucket(bucket, device=dev)
    rewarm = g.report()
    time.sleep(0.1)  # past the verify deadline
    out2 = sup.step()
    t_verify = time.monotonic() - t_apply
    snap = sup.snapshot()
    print(f"  (a) storm: top {top.get('rule')} ({top.get('summary')}); "
          f"step applied {out1['applied']}, warm of bucket {bucket} s per "
          f"K {({k: round(v, 4) for k, v in walls.items()})}, wgl32_chunk "
          f"launches per K {per_k} (all {counts}); second warm guard "
          f"{ {k: rewarm[k] for k in ('builds', 'loads', 'binds')} }; next "
          f"pass verified {out2['verified']}, {t_verify:.4f} s from the "
          f"apply; counts {snap['counts']}, quarantined "
          f"{sorted(snap['quarantined'])}", flush=True)
    if (top.get("rule") != "D001" or out1["applied"] != ["D001"]
            or len(host.warms) < 1 or sorted(per_k) != sorted(walls)
            or any(v < 1 for v in per_k.values())
            or counts["wgl32_chunk"] != sum(per_k.values())
            or any(rewarm[k] for k in ("builds", "loads", "binds"))
            or "D001" not in out2["verified"]
            or snap["counts"].get("verify") != 1 or snap["quarantined"]):
        raise AssertionError(f"autopilot storm: {out1} {out2} {per_k} "
                             f"{counts} {rewarm} {snap['counts']}")

    # (c) offline replay parity
    decided = autopilot.replay(report)
    print(f"  (c) replay: {[d['rule'] for d in decided]} == live "
          f"decisions {out1['decisions']}", flush=True)
    if [d["rule"] for d in decided] != out1["decisions"]:
        raise AssertionError(f"replay {decided} != {out1['decisions']}")

    # (b) an un-fixable finding -> revert + quarantine -> suppressed
    class BadHost(autopilot.Host):
        def __init__(self):
            self.applied = 0
            self.rolled = 0

        def diagnose(self):
            return {"findings": [{
                "rule": "D003", "name": "ladder-thrash", "severity": "warn",
                "summary": "seeded un-fixable thrash", "subject": "ladder",
                "score": 5.0, "evidence": [{
                    "series": "wgl_adapt", "field": "to_K",
                    "indices": [0, 1], "values": [2, 512]}]}]}

        def probe(self, metric, since=None):
            return 10.0  # never improves

        def actuate(self, entry, finding):
            self.applied += 1

            def rollback():
                self.rolled += 1

            return {"k": 512}, rollback

    bad = BadHost()
    bsup = autopilot.Supervisor(bad, every_s=60.0, verify_after_s=0.0,
                                where="smoke", mx=reg, ledger=led)
    bsup.step(now=1000.0)
    b2 = bsup.step(now=1001.0)
    b3 = bsup.step(now=1002.0)
    print(f"  (b) un-fixable D003: reverted {b2['reverted']} (rollbacks "
          f"{bad.rolled}), quarantined {sorted(bsup.quarantined())}, "
          f"re-fire suppressed {b3['suppressed']}, actuator runs "
          f"{bad.applied}", flush=True)
    inst = sup.perfetto_instants()
    if (b2["reverted"] != ["D003"] or bad.rolled != 1
            or "D003" not in bsup.quarantined()
            or b3["suppressed"] != ["D003"] or bad.applied != 1
            or not inst or any(i["lane"] != autopilot.PERFETTO_LANE
                               for i in inst)):
        raise AssertionError(f"autopilot revert: {b2} {b3} {bad.applied}")

    # (d) the same loop over a live service on the card
    key, first = None, None
    bodies = []
    seed = AUTOPILOT_BATCH["seed"]
    while len(bodies) < 4:
        h = synth.cas_register_history(AUTOPILOT_BATCH["n_ops"],
                                       n_procs=AUTOPILOT_BATCH["n_procs"],
                                       seed=seed)
        k = service.bucket_for(encode.encode(cas_register(), h))[0]
        if key is None:
            key = k
        if k == key:
            bodies.append({"model": "cas-register",
                           "history": [op.to_dict() for op in h]})
        seed += 1
    prev_cache = fs_cache.DIR
    fs_cache.DIR = os.path.join(tmp, "fs_cache")
    svc = service.Service(os.path.join(tmp, "svc"),
                          devices=[dev] * MESH_SHARDS, workers=1,
                          slo_every_s=3600.0, autopilot=True,
                          autopilot_every_s=3600.0, heartbeat_every_s=0)
    try:
        svc.start()
        live = svc._autopilot
        svc.hold(True)
        rids = [svc.submit(b)["id"] for b in bodies]
        storm(svc.ledger)
        time.sleep(0.05)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.monotonic()
        s1 = live.step()
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        warm_counts = read_counts()
        s2 = live.step(now=time.time() + live.verify_after_s + 1.0)
        zero_counts()
        t0 = time.monotonic()
        svc.hold(False)
        deadline = time.monotonic() + 300
        while any(svc.get(r)["state"] not in ("done", "rejected")
                  for r in rids):
            if time.monotonic() > deadline:
                raise AssertionError("autopilot service: requests stuck")
            time.sleep(0.01)
        torch.cuda.synchronize()
        batch_s = time.monotonic() - t0
        batch_counts = read_counts()
        infos = [svc.get(r) for r in rids]
        ssnap = svc.snapshot()
        print(f"  (d) service over [card] * {MESH_SHARDS}, autopilot on: "
              f"step applied {s1['applied']} in {warm_s:.4f} s (launches "
              f"{warm_counts}), next pass verified {s2['verified']}; the 4 "
              f"held requests released: verdicts "
              f"{[i['verdict'] for i in infos]}, warm hits "
              f"{[i['warm_hit'] for i in infos]}, mesh batches "
              f"{ssnap['mesh_batches']}, {batch_s:.4f} s, launches "
              f"{batch_counts}", flush=True)
        if (s1["applied"][:1] != ["D001"] or "D001" not in s2["verified"]
                or warm_counts["wgl32_chunk"] < 1
                or any(i["verdict"] is not True for i in infos)
                or ssnap["mesh_batches"] < 1
                or batch_counts["wgl32_chunk_batched"] < 1):
            raise AssertionError(f"autopilot service: {s1} {s2} {infos} "
                                 f"{warm_counts} {batch_counts}")
    finally:
        svc.close()
        fs_cache.DIR = prev_cache
        autopilot.set_default(None)
        service.set_default(None)
    # the newest record of the store carries a storm of its own: what
    # `autopilot latest` replays in the CLI phase
    led.record({"kind": "independent", "name": "storm-keys",
                "compiles": 50, "shapes": {"K": 16, "W_pad": 7}})
    print(f"  autopilot phase: {time.monotonic() - t_all:.1f} s", flush=True)
    return store, bodies


def cli_phases(dev, ap_store: str, bodies: list) -> None:
    """The one command language in fresh processes, all started at once:
    `preflight --config headline --execute --json` (exit 0, the check
    True on the card with its kernel and buckets as planned);
    `autopilot latest --json --store <the autopilot phase's store>` (exit
    0, its decisions == `autopilot.replay` of the same diagnosis here);
    `serve --service --autopilot --devices MESH_SHARDS -p 0` (binds;
    `bodies`, 4 same-bucket histories, POSTed to /check reach True;
    /status.json carries `"autopilot": {"active": true, ...}`; then the
    process is terminated); `serve --bogus` exits 254, and `fleet
    --discover` over an empty directory (no store root around it) the
    reference's 2."""
    import os
    import queue
    import tempfile
    import threading
    import urllib.request

    from jepsen_tpu_torch import autopilot, doctor, slo

    print(f"one CLI ({card_line()}):", flush=True)
    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="cli-", dir=str(REPO / "build" /
                                                  "torch_kernels"))
    env = {**os.environ, "JEPSEN_TPU_HEARTBEAT_S": "0"}
    # discovery walks the directory, its children and its parent's
    # children: a nest with no store anywhere in that neighbourhood
    empty = os.path.join(tmp, "none", "empty")
    os.makedirs(empty)

    def start(*args, **kw):
        return subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch", *args], cwd=REPO,
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=kw.get("stderr", subprocess.PIPE))

    t0 = time.monotonic()
    serve = start("serve", "--service", "--autopilot", "--devices",
                  str(MESH_SHARDS), "-b", "127.0.0.1", "-p", "0",
                  "--store-root", os.path.join(tmp, "serve"),
                  stderr=subprocess.STDOUT)
    procs = {"preflight": start("preflight", "--config", "headline",
                                "--execute", "--json"),
             "autopilot": start("autopilot", "latest", "--json", "--store",
                                ap_store),
             "bad option": start("serve", "--bogus"),
             "fleet": start("fleet", "--discover", empty)}
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in serve.stdout],
                     daemon=True).start()
    try:
        seen = []
        deadline = time.monotonic() + 180
        while not any(ln.startswith("Checker service:") for ln in seen):
            if time.monotonic() > deadline or serve.poll() is not None:
                raise AssertionError(f"serve: exit {serve.poll()}:\n"
                                     + "".join(seen)[-4000:])
            try:
                seen.append(lines.get(timeout=1.0))
            except queue.Empty:
                pass
        bind_s = time.monotonic() - t0
        base = next(ln for ln in seen if ln.startswith("Listening")
                    ).split()[2].rstrip("/")
        rids = []
        for b in bodies:
            req = urllib.request.Request(
                base + "/check", data=json.dumps(b).encode(),
                headers={"Content-Type": "application/json"})
            rids.append(json.loads(urllib.request.urlopen(
                req, timeout=60).read())["id"])
        verdicts = []
        for rid in rids:
            urllib.request.urlopen(f"{base}/runs/{rid}/events?wait=300",
                                   timeout=360).read()
            rec = json.loads(urllib.request.urlopen(
                f"{base}/runs/{rid}.json", timeout=60).read())
            verdicts.append(rec.get("verdict"))
        status = json.loads(urllib.request.urlopen(
            base + "/status.json", timeout=60).read())
        apt = status.get("autopilot") or {}
        served_s = time.monotonic() - t0
        print(f"  serve --service --autopilot --devices {MESH_SHARDS} -p 0: "
              f"bound in {bind_s:.4f} s ({[ln.strip() for ln in seen if ln.startswith(('Listening', 'Checker'))]}); "
              f"4 POSTs -> verdicts {verdicts} at {served_s:.4f} s; "
              f"/status.json autopilot active {apt.get('active')} "
              f"(steps {apt.get('steps')}, every_s {apt.get('every_s')}, "
              f"quarantined {sorted(apt.get('quarantined') or {})}), "
              f"service mesh_batches "
              f"{(status.get('service') or {}).get('mesh_batches')}",
              flush=True)
        if (verdicts != [True] * len(bodies) or apt.get("active") is not True
                or "autopilot ON" not in "".join(seen)):
            raise AssertionError(f"serve: {verdicts} {apt}")
    finally:
        serve.terminate()
        try:
            serve.wait(timeout=60)
        except subprocess.TimeoutExpired:
            serve.kill()
            serve.wait()
    outs = {}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        outs[name] = (proc.returncode, out, err)
    print(f"  serve terminated (exit {serve.returncode}); the others' exit "
          f"codes {({n: o[0] for n, o in outs.items()})}, all in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    rc, out, err = outs["preflight"]
    par = json.loads(out)["headline"]["executed"] if rc == 0 else {}
    print(f"  preflight --config headline --execute --json: exit {rc}, "
          f"executed {json.dumps(par)}", flush=True)
    if (rc != 0 or par.get("verdict") is not True or not par["kernel_match"]
            or not par["buckets_subset"]):
        raise AssertionError(f"preflight CLI: exit {rc}:\n{err[-3000:]}")
    rc, out, err = outs["autopilot"]
    got = json.loads(out) if rc == 0 else {}
    try:  # what the command reads beside the diagnosis
        slo_rep = slo.evaluate_store(ap_store)
    except Exception:  # noqa: BLE001 — no service traffic recorded
        slo_rep = None
    want = autopilot.replay(doctor.diagnose(doctor.run_view(ap_store,
                                                            "latest")),
                            slo_rep)
    print(f"  autopilot latest --json: exit {rc}, target "
          f"{got.get('target')}, rules fired {got.get('rules_fired')}, "
          f"decisions {[(d['rule'], d['action']) for d in got.get('decisions') or []]}",
          flush=True)
    if (rc != 0 or not got.get("decisions")
            or got["decisions"] != json.loads(json.dumps(want, default=str))):
        raise AssertionError(f"autopilot CLI: exit {rc}: {got}\n{err[-3000:]}")
    for name, want_rc in (("bad option", 254), ("fleet", 2)):
        rc, out, err = outs[name]
        print(f"  {name}: exit {rc} ({(err or out).strip().splitlines()[:1]})",
              flush=True)
        if rc != want_rc:
            raise AssertionError(f"{name}: exit {rc}\n{out}{err}")
    print(f"  CLI phase: {time.monotonic() - t_all:.1f} s", flush=True)


# the fleet phase's load: 4 same-bucket WGL histories a replica of this
# shape, and the 3k Elle append history once a replica
FLEET_WGL = dict(n_ops=500, n_procs=5, seed=42, crash_p=0.002)
FLEET_HEARTBEAT_S = 0.5
FLEET_MESH = dict(n_keys=8, n_ops=600, n_procs=5, crash_p=0.002)


def store_walk(root: str) -> list:
    """Every file under `root` as (path, mtime_ns, size), sorted."""
    import os
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for f in sorted(filenames):
            st = os.stat(os.path.join(dirpath, f))
            out.append((os.path.relpath(os.path.join(dirpath, f), root),
                        st.st_mtime_ns, st.st_size))
    return out


def fleet_phases(dev, background) -> None:
    """The fleet observatory and the HTML pages on the card, the port's
    counterpart of the reference's two-replica gate
    (`scripts/fleet_smoke.py`):

      1. two replicas in fresh processes, started at once: `serve
         --service --devices MESH_SHARDS -p 0 --replica-id r1|r2
         --store-root <tmp>/r1|r2` (`FLEET_REPLICA`: every count 0 at
         the start, SIGUSR1 writes them), each with a heartbeat every
         FLEET_HEARTBEAT_S s and JEPSEN_TPU_FLEET_ROOTS naming both
         stores;
      2. to each replica, 4 same-bucket FLEET_WGL histories and the 3k
         Elle append history over POST /check; every verdict equals the
         host oracle's (`wgl_ref`, the Elle host engine in `background`);
      3. a `kind="multichip"` record (`devices.multichip_record`) of an
         `independent.cuda_checker(devices=[card] * MESH_SHARDS)` check
         of FLEET_MESH keys here, counted, each key == the oracle's,
         banked into r1's ledger;
      4. r1's pages: `/fleet.json` (both replicas live, `requests` ==
         the requests sent, the fleet SLO block), every HTML page 200
         (`/runs/<the multichip id>`, a `/files/` file and a `.zip`
         among them), `/files/../x` 403;
      5. `python -m jepsen_tpu_torch fleet r1 r2` with `--json`,
         `--journey <an id r2 served>` (complete, r2's spans and series)
         and `--perfetto` (one pid a replica), all exit 0;
      6. r2 killed (SIGKILL, after it wrote its counts); past its
         silence threshold `fleet --json` carries D013 for r2;
      7. the observatory pass of 6 (the CLI's snapshot, journey and
         Perfetto, and r1's `/fleet.json` and `/fleet`) leaves r2's store
         walk (`store_walk`) unchanged; both ledgers lint clean under
         scripts/telemetry_lint.py.

    Prints each replica's launches and the multichip check's, the walls
    and the card; any miss raises."""
    import os
    import queue
    import shutil
    import signal
    import tempfile
    import threading
    import io
    import urllib.error
    import urllib.request
    import zipfile

    from jepsen_tpu_torch import devices, independent, ledger, observatory
    from jepsen_tpu_torch import service, synth
    from jepsen_tpu_torch.history import strip_nemesis
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import encode, wgl_ref

    sys.path.insert(0, str(REPO / "scripts"))
    import telemetry_lint

    print(f"fleet observatory and pages ({card_line()}):", flush=True)
    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="fleet-", dir=str(REPO / "build" /
                                                    "torch_kernels"))
    names = ("r1", "r2")
    roots = {r: os.path.join(tmp, r) for r in names}
    counts_at = {r: os.path.join(tmp, f"{r}.launches.json") for r in names}
    env = {**os.environ, "PYTHONUNBUFFERED": "1",
           "JEPSEN_TPU_HEARTBEAT_S": str(FLEET_HEARTBEAT_S),
           observatory.FLEET_ROOTS_ENV: os.pathsep.join(
               roots[r] for r in names)}

    def cli(*args):
        return subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch", *args], cwd=REPO,
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)

    def finish(procs: dict) -> dict:
        out = {}
        for k, proc in procs.items():
            try:
                o, e = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                o, e = proc.communicate()
            out[k] = (proc.returncode, o, e)
        return out

    def get(base, path, want=200):
        try:
            with urllib.request.urlopen(base + path, timeout=60) as r:
                code, ctype, body = r.status, r.headers["Content-Type"], \
                    r.read()
        except urllib.error.HTTPError as e:
            code, ctype, body = e.code, e.headers["Content-Type"], e.read()
        if code != want:
            raise AssertionError(f"GET {path}: {code}, want {want}")
        return ctype, body

    def post(base, body) -> str:
        req = urllib.request.Request(
            base + "/check", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())[
            "id"]

    def read_counts_of(r, proc) -> dict:
        if os.path.exists(counts_at[r]):
            os.unlink(counts_at[r])
        proc.send_signal(signal.SIGUSR1)
        deadline = time.monotonic() + 30
        while not os.path.exists(counts_at[r]):
            if time.monotonic() > deadline or proc.poll() is not None:
                raise AssertionError(f"{r} wrote no counts "
                                     f"(exit {proc.poll()})")
            time.sleep(0.05)
        with open(counts_at[r]) as fh:
            return json.load(fh)

    # 1. both replicas at once
    t0 = time.monotonic()
    reps = {}
    for r in names:
        reps[r] = subprocess.Popen(
            [sys.executable, "-c", FLEET_REPLICA,
             os.path.join(tmp, f"fs_cache-{r}"), counts_at[r],
             "serve", "--service", "--devices", str(MESH_SHARDS), "-b",
             "127.0.0.1", "-p", "0", "--replica-id", r, "--store-root",
             roots[r]], cwd=REPO, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines = {r: queue.Queue() for r in names}
    for r in names:
        threading.Thread(target=lambda r=r: [lines[r].put(ln)
                                             for ln in reps[r].stdout],
                         daemon=True).start()
    # the load and its oracle while the replicas start
    head = synth.cas_register_history(
        FLEET_WGL["n_ops"], n_procs=FLEET_WGL["n_procs"],
        seed=FLEET_WGL["seed"], crash_p=FLEET_WGL["crash_p"])
    key = service.bucket_for(encode.encode(cas_register(), head))[0]
    wgl_load = same_bucket_seeds(key, 4 * len(names), FLEET_WGL["seed"],
                                 shape=FLEET_WGL)
    # the service checks Elle without the realtime graph
    elle_want = background.submit(elle_host_verdict, ELLE_3K, ())
    elle_h = [op.to_dict() for op in synth.list_append_history(**ELLE_3K)]
    wgl_want = [wgl_ref.check(cas_register(), h)["valid?"]
                for _, h in wgl_load]
    fan = multikey_history(**FLEET_MESH)
    ks = independent.history_keys(fan)
    mesh_want = {str(k): wgl_ref.check(cas_register(), strip_nemesis(x))[
        "valid?"] for k, x in zip(ks, independent.subhistories(fan, ks))}
    bases, seen = {}, {r: [] for r in names}
    bind_s = {}
    try:
        deadline = time.monotonic() + 180
        while len(bases) < len(names):
            for r in names:
                if r in bases:
                    continue
                if time.monotonic() > deadline or reps[r].poll() is not None:
                    raise AssertionError(f"{r}: exit {reps[r].poll()}:\n"
                                         + "".join(seen[r])[-4000:])
                try:
                    seen[r].append(lines[r].get(timeout=0.2))
                except queue.Empty:
                    continue
                if seen[r][-1].startswith("Checker service:"):
                    bind_s[r] = time.monotonic() - t0
                    bases[r] = next(ln for ln in seen[r]
                                    if ln.startswith("Listening")
                                    ).split()[2].rstrip("/")
        print(f"  replicas bound in {json.dumps(bind_s)} s (started at "
              f"once): " + "; ".join(
                  f"{r}: {[ln.strip() for ln in seen[r] if ln.startswith(('Listening', 'Device', 'Checker'))]}"
                  for r in names), flush=True)
        if any("· fleet: " not in "".join(seen[r]) for r in names):
            raise AssertionError(f"serve's page lines: {seen}")

        # 2. the mixed load, both replicas at once
        t_load = time.monotonic()
        sent = {r: [] for r in names}
        for i, r in enumerate(names):
            for j, (_, h) in enumerate(wgl_load[4 * i:4 * i + 4]):
                sent[r].append((post(bases[r], {
                    "model": "cas-register", "tenant": "fleet",
                    "history": [op.to_dict() for op in h]}),
                    wgl_want[4 * i + j], "wgl"))
            sent[r].append((post(bases[r], {
                "checker": "elle-append", "tenant": "fleet",
                "history": elle_h}), None, "elle-append"))
        elle_w = elle_want.result(timeout=600)
        got = {}
        for r in names:
            for rid, want, kind in sent[r]:
                urllib.request.urlopen(
                    f"{bases[r]}/runs/{rid}/events?wait=300",
                    timeout=360).read()
                rec = json.loads(get(bases[r], f"/runs/{rid}.json")[1])
                want = elle_w["valid?"] if want is None else want
                got[rid] = (r, kind, rec.get("verdict"), want,
                            rec.get("wall_s"), rec.get("batch_n"))
        load_s = time.monotonic() - t_load
        for rid, (r, kind, v, want, wall, bn) in got.items():
            print(f"    {r} {kind} {rid}: verdict {v} (oracle {want}), "
                  f"wall_s {wall}, batch_n {bn}", flush=True)
        print(f"  load: {len(got)} requests served in {load_s:.4f} s; "
              f"Elle oracle {elle_w['valid?']} "
              f"{elle_w['anomaly-types']} in {elle_w['seconds']:.2f} s",
              flush=True)
        if any(v != want for _, _, v, want, _, _ in got.values()):
            raise AssertionError(f"fleet load verdicts: {got}")

        # 3. the multichip record, banked into r1's ledger
        cards = [dev] * MESH_SHARDS
        zero_counts()
        torch.cuda.synchronize()
        t_mc = time.monotonic()
        res = independent.cuda_checker(cas_register(),
                                       devices=cards).check({}, fan, {})
        torch.cuda.synchronize()
        mc_wall = time.monotonic() - t_mc
        mc_counts = read_counts()
        verdicts = {str(k): r["valid?"] for k, r in res["results"].items()}
        rec = devices.multichip_record(
            "fleet-mesh", MESH_SHARDS, list(res["results"].values()),
            mc_wall, hbm=res.get("hbm"), platform="gpu",
            extra={"keys": len(ks)})
        mc_id = ledger.Ledger(roots["r1"]).record(rec)
        print(f"  multichip: cuda_checker over {MESH_SHARDS} shards of the "
              f"card, {len(ks)} keys x {FLEET_MESH['n_ops']} ops: valid? "
              f"{res['valid?']} in {mc_wall:.4f} s, launches {mc_counts}; "
              f"record {mc_id}: verdict {rec['verdict']}, per_device "
              f"{json.dumps(rec['per_device'])}", flush=True)
        if (verdicts != mesh_want or rec["verdict"] != res["valid?"]
                or mc_counts["wgl32_chunk_batched"] < 1):
            raise AssertionError(f"multichip: {verdicts} != {mesh_want}, "
                                 f"{rec}, {mc_counts}")

        # 4. r1's pages
        b1 = bases["r1"]
        t_pages = time.monotonic()
        deadline = time.monotonic() + 30
        while True:
            snap = json.loads(get(b1, "/fleet.json")[1])
            if snap.get("live") == len(names) or time.monotonic() > deadline:
                break
            time.sleep(FLEET_HEARTBEAT_S)
        slo_block = snap.get("slo") or {}
        print(f"  /fleet.json: replicas {sorted(snap['replicas'])}, live "
              f"{snap['live']}, down {snap['down']}, requests "
              f"{snap['requests']} (sent {len(got)}), fleet SLO met "
              f"{(slo_block.get('fleet') or {}).get('met')}, per replica "
              f"{sorted(slo_block.get('per_replica') or {})}, findings "
              f"{[f['rule'] for f in snap['findings']]}", flush=True)
        if (set(snap["replicas"]) != set(names) or snap["live"] != len(names)
                or snap["down"] or snap["requests"] != len(got)
                or not (slo_block.get("fleet") or {}).get("objectives")
                or set(slo_block.get("per_replica") or {}) != set(names)):
            raise AssertionError(f"/fleet.json: {snap}")
        pages = {}
        for path in ("/", "/status", "/occupancy", "/devices", "/doctor",
                     "/slo", "/autopilot", "/fleet", "/runs",
                     f"/runs/{mc_id}", "/files/ledger",
                     "/files/ledger/index.jsonl"):
            ctype, body = get(b1, path)
            pages[path] = len(body)
            if path != "/files/ledger/index.jsonl" and \
                    not ctype.startswith("text/html"):
                raise AssertionError(f"{path}: {ctype}")
        if b"multichip" not in get(b1, f"/runs/{mc_id}")[1] or \
                b"r2" not in get(b1, "/fleet")[1]:
            raise AssertionError("the run page or /fleet misses its data")
        ctype, raw = get(b1, "/files/ledger.zip")
        zipped = zipfile.ZipFile(io.BytesIO(raw)).namelist()
        get(b1, "/files/../x", want=403)
        get(b1, "/files/nope.txt", want=404)
        print(f"  pages (bytes): {json.dumps(pages)}; /files/ledger.zip "
              f"{ctype} {len(raw)} B with {sorted(zipped)[:3]}...; "
              f"/files/../x 403; in {time.monotonic() - t_pages:.4f} s",
              flush=True)
        if "index.jsonl" not in zipped:
            raise AssertionError(f"ledger.zip: {zipped}")

        # 5. the fleet command over both stores
        r2_rid = sent["r2"][0][0]
        time.sleep(2 * FLEET_HEARTBEAT_S)  # r2's next telemetry export
        pf = {r: os.path.join(tmp, f"perfetto-{r}.json")
              for r in ("live", "down")}
        rr = [roots[r] for r in names]
        t_cli = time.monotonic()
        outs = finish({"json": cli("fleet", *rr, "--json"),
                       "journey": cli("fleet", *rr, "--journey", r2_rid),
                       "perfetto": cli("fleet", *rr, "--perfetto",
                                       pf["live"])})
        cli_s = time.monotonic() - t_cli
        live = json.loads(outs["json"][1]) if outs["json"][0] == 0 else {}
        jdoc = json.loads(outs["journey"][1]) \
            if outs["journey"][0] == 0 else {}
        with open(pf["live"]) as fh:
            pids = sorted({e["pid"] for e in json.load(fh)["traceEvents"]})
        kinds = sorted({(h["type"], h["name"]) for h in jdoc.get("hops", [])})
        print(f"  fleet r1 r2 (3 processes at once, {cli_s:.4f} s): exits "
              f"{({k: o[0] for k, o in outs.items()})}; --json live "
              f"{live.get('live')} requests {live.get('requests')}; "
              f"--journey {r2_rid}: replica {jdoc.get('replica')}, complete "
              f"{jdoc.get('complete')}, {jdoc.get('n_hops')} hops {kinds}; "
              f"--perfetto pids {pids}", flush=True)
        if (any(o[0] != 0 for o in outs.values()) or live.get("live") != 2
                or jdoc.get("replica") != "r2" or not jdoc.get("complete")
                or not any(t == "series" for t, _ in kinds)
                or pids != [observatory.REPLICA_PID_BASE,
                            observatory.REPLICA_PID_BASE + 1]):
            raise AssertionError(f"fleet CLI: {outs}")

        # 6. r2 killed, after its counts
        counts = {"r2": read_counts_of("r2", reps["r2"])}
        reps["r2"].send_signal(signal.SIGKILL)
        reps["r2"].wait(timeout=30)
        t_kill = time.monotonic()
        gap = observatory.DOWN_GAP_X * FLEET_HEARTBEAT_S
        deadline = t_kill + gap + 10
        while json.loads(get(b1, "/fleet.json")[1])["down"] != ["r2"]:
            if time.monotonic() > deadline:
                raise AssertionError("r2 never reported down on r1")
            time.sleep(0.1)
        down_s = time.monotonic() - t_kill
        time.sleep(max(0.0, gap + FLEET_HEARTBEAT_S - down_s))

        # 7. the observatory pass over the dead store, read-only
        before = store_walk(roots["r2"])
        outs = finish({"json": cli("fleet", *rr, "--json"),
                       "journey": cli("fleet", *rr, "--journey", r2_rid),
                       "perfetto": cli("fleet", *rr, "--perfetto",
                                       pf["down"])})
        get(b1, "/fleet")
        get(b1, "/fleet.json")
        after = store_walk(roots["r2"])
        dead = json.loads(outs["json"][1]) if outs["json"][0] == 0 else {}
        d013 = [f for f in dead.get("findings", []) if f["rule"] == "D013"]
        print(f"  r2 killed: down on r1's /fleet.json after "
              f"{down_s:.4f} s (threshold {gap} s); fleet --json exit "
              f"{outs['json'][0]}: down {dead.get('down')}, D013 "
              f"{[(f['subject'], f['severity']) for f in d013]}; journey "
              f"exit {outs['journey'][0]}, perfetto exit "
              f"{outs['perfetto'][0]}; r2's store walk {len(before)} files "
              f"{'unchanged' if before == after else 'CHANGED'}",
              flush=True)
        if (any(o[0] != 0 for o in outs.values()) or dead.get("down") != ["r2"]
                or [f["subject"] for f in d013] != ["r2"]
                or d013[0]["severity"] != "critical"
                or before != after or not before):
            raise AssertionError(f"after the kill: {dead}, "
                                 f"{before == after}, {outs}")
        # the ledgers only: the port's `elle_closure` points lack the
        # reference's XLA `compile_s`, a recorded divergence
        lint = [e for r in names for e in telemetry_lint.lint_ledger_file(
            os.path.join(roots[r], "ledger", "index.jsonl"))]
        if lint:
            raise AssertionError(f"telemetry lint: {lint[:10]}")
        counts["r1"] = read_counts_of("r1", reps["r1"])
    finally:
        for proc in reps.values():
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    for r in names:
        print(f"  launches of {r}: {counts[r]}", flush=True)
    print(f"  launches of the multichip check: {mc_counts}", flush=True)
    total = {k: counts["r1"][k] + counts["r2"][k] + mc_counts[k]
             for k in mc_counts}
    print(f"  launches of the fleet phase: {total}", flush=True)
    for r in names:
        c = counts[r]
        if c["wgl32_chunk"] + c["wgl32_chunk_batched"] < 1 or \
                c["elle_closure"] < 1:
            raise AssertionError(f"{r} launched too little: {c}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"  fleet phase: {time.monotonic() - t_all:.1f} s (lint clean)",
          flush=True)


# ---- the lints and the lock-order witness ------------------------------------

LINT_WARM = dict(n_ops=480, n_procs=4, seed=20)      # warms the bucket
LINT_HELD = dict(n_ops=500, n_procs=4)               # the held batch of 4
LINT_SEEDS = (21, 22, 24, 25)                        # one bucket with seed 20
LINT_STREAM = dict(n_keys=8, n_ops=600, n_procs=5, crash_p=0.002)
LINT_LIMIT_S = 25.0           # the phase's share of SMOKE_LIMIT_S
# the held load's turns after the witnessed one: witness off, on, off
LINT_TURNS = (False, True, False)
# the kernels the witnessed service and fan-out must launch
LINT_KERNELS = ("wgl32_chunk", "wgl32_chunk_batched", "wgl_lane_reset",
                "elle_closure")
# a poll loop that reads its summary each iteration: K007
K007_FIXTURE = '''def poll(step, carry):
    while True:
        carry, summary = step(carry)
        s = summary.cpu().numpy()
        if s[0]:
            return s
'''


def lint_phases(dev, background) -> None:
    """The static lints and the runtime lock-order witness on the card:

      1. `python -m jepsen_tpu_torch.analysis.threadlint` and
         `.kernellint` run in this process (`main([])`): 0 over the
         port's tree, 1 on `tests/threadlint_fixtures/fixture_t002.py`
         and on a K007 fixture written to a temporary file;
      2. the witness armed (`JEPSEN_TPU_LOCKWATCH=1`, `lockwatch.reset()`,
         a metrics registry and a watchdog installed after it): an
         in-process `Service(devices=[card] * MESH_SHARDS,
         mesh_serving=True)` warms its bucket with one LINT_WARM request,
         serves 4 held LINT_HELD histories (LINT_SEEDS) as one mesh batch
         and one 3k Elle append request, and `check_streamed` decides
         LINT_STREAM keys over `[card] * MESH_SHARDS`, every verdict equal
         to the host oracle's and LINT_KERNELS each launched;
      3. the witness's results: the snapshot's `lockwatch` block without
         a cycle, the service, watchdog and fan-out queue locks among
         those witnessed, one `kind="lockwatch"` record banked by
         `close()`, it and the `lockwatch` series points lint clean under
         scripts/telemetry_lint.py, no D016 from `doctor.diagnose` over
         the ledger and the series; a seeded B->A acquire after A->B
         raises `LockOrderViolation` naming both, and both locks are
         taken again after it;
      4. the witness unset: a Service built afterwards holds a plain
         RLock and serves the same warm and 4 held requests; then in
         turns (LINT_TURNS) a new service with the witness on and off
         again; the held walls' p50 printed witness on and off;
      5. the history analyzer and its gate (`history_lint_step`).

    Takes at most LINT_LIMIT_S; any miss raises."""
    import os
    import shutil
    import statistics
    import tempfile
    import threading

    from jepsen_tpu_torch import doctor, fs_cache, metrics, service, synth
    from jepsen_tpu_torch import watchdog
    from jepsen_tpu_torch.analysis import kernellint, lockwatch, threadlint
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import wgl_ref
    from jepsen_tpu_torch.parallel import batched, mesh

    sys.path.insert(0, str(REPO / "scripts"))
    import telemetry_lint

    print(f"lints and the lock-order witness ({card_line()}):", flush=True)
    t_all = time.monotonic()
    # the service checks Elle without the realtime graph
    elle_want = background.submit(elle_host_verdict, ELLE_3K, ())
    tmp = tempfile.mkdtemp(prefix="lint-", dir=str(REPO / "build" /
                                                    "torch_kernels"))

    # 1. the lints, in this process
    t0 = time.monotonic()
    k007 = os.path.join(tmp, "k007.py")
    with open(k007, "w") as fh:
        fh.write(K007_FIXTURE)
    codes = {
        "threadlint tree": threadlint.main([]),
        "kernellint tree": kernellint.main([]),
        "threadlint T002 fixture": threadlint.main([str(
            REPO / "tests" / "threadlint_fixtures" / "fixture_t002.py")]),
        "kernellint K007 fixture": kernellint.main([k007])}
    print(f"  lints ({time.monotonic() - t0:.2f} s): exit codes {codes}",
          flush=True)
    if list(codes.values()) != [0, 0, 1, 1]:
        raise AssertionError(f"lint exit codes: {codes}")

    # the load and its oracle
    def hist(shape, seed):
        return synth.cas_register_history(
            shape["n_ops"], n_procs=shape["n_procs"], seed=seed,
            crash_p=shape.get("crash_p", 0.0))

    warm_h = hist(LINT_WARM, LINT_WARM["seed"])
    held = [hist(LINT_HELD, s) for s in LINT_SEEDS]
    keys = [hist(LINT_STREAM, k) for k in range(LINT_STREAM["n_keys"])]
    elle_h = [op.to_dict() for op in synth.list_append_history(**ELLE_3K)]
    want_held = [wgl_ref.check(cas_register(), h)["valid?"] for h in held]
    want_keys = [wgl_ref.check(cas_register(), h)["valid?"] for h in keys]
    want_warm = wgl_ref.check(cas_register(), warm_h)["valid?"]

    def body(h):
        return {"model": "cas-register", "tenant": "lint",
                "history": [op.to_dict() for op in h]}

    def wait(svc, rid) -> dict:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            info = svc.get(rid)
            if info and info["state"] in ("done", "rejected"):
                if str(info.get("cause") or "").startswith("service-error"):
                    raise AssertionError(f"service error: {info}")
                return info
            time.sleep(0.005)
        raise AssertionError(f"run {rid} never finished")

    def new_service(store):
        return service.Service(store, devices=[dev] * MESH_SHARDS,
                               workers=1, rewarm=False, slo_every_s=3600.0,
                               max_batch=4, mesh_serving=True,
                               heartbeat_every_s=0)

    def serve_held(svc) -> tuple:
        """The warm request, then the 4 held ones as one batch: their
        infos and the batch point."""
        warm = wait(svc, svc.submit(body(warm_h))["id"])
        svc.hold(True)
        rids = [svc.submit(body(h))["id"] for h in held]
        svc.hold(False)
        infos = [wait(svc, r) for r in rids]
        bp = svc.mx.series("service_batch").points[-1]
        if (warm["verdict"] != want_warm
                or [i["verdict"] for i in infos] != want_held
                or bp["mode"] != "mesh" or bp["batch_n"] != len(held)):
            raise AssertionError(f"held load: warm {warm}, {infos} (oracle "
                                 f"{want_warm}, {want_held}), batch {bp}")
        return infos, bp

    prev_cache = fs_cache.DIR
    prev_env = {k: os.environ.get(k)
                for k in (lockwatch.ENV, lockwatch.STRICT_ENV)}
    fs_cache.DIR = os.path.join(tmp, "fs_cache")
    wd = None
    try:
        # 2. the witness armed, then the service and the fan-out
        os.environ[lockwatch.ENV] = "1"
        os.environ[lockwatch.STRICT_ENV] = "1"
        lockwatch.reset()
        reg = metrics.Registry()
        wd = watchdog.Watchdog()
        zero_counts()
        t_on = time.monotonic()
        with metrics.use(reg), watchdog.use(wd):
            svc = new_service(os.path.join(tmp, "store-on"))
            if not isinstance(svc._lock, lockwatch.WatchedLock):
                raise AssertionError(f"armed service lock: {svc._lock!r}")
            try:
                infos_on, bp_on = serve_held(svc)
                ei = wait(svc, svc.submit({"checker": "elle-append",
                                           "tenant": "lint",
                                           "history": elle_h})["id"])
                t_s = time.monotonic()
                res = batched.check_streamed(cas_register(), keys,
                                             devices=[dev] * MESH_SHARDS)
                torch.cuda.synchronize()
                stream_s = time.monotonic() - t_s
                snap = svc.snapshot()
            finally:
                svc.close()
            counts = read_counts()
            on_s = time.monotonic() - t_on
        ew = elle_want.result(timeout=120)
        got_keys = [r["valid?"] for r in res]
        print(f"  witnessed load ({on_s:.2f} s): warm request, held batch "
              f"of {bp_on['batch_n']} mode {bp_on['mode']} verdicts "
              f"{[i['verdict'] for i in infos_on]} (oracle {want_held}); "
              f"elle append {ELLE_3K}: {ei['verdict']} (oracle "
              f"{ew['valid?']} {ew['anomaly-types']}); check_streamed "
              f"{LINT_STREAM['n_keys']} keys x {LINT_STREAM['n_ops']} over "
              f"[card] * {MESH_SHARDS} in {stream_s:.4f} s: {got_keys} "
              f"(oracle {want_keys})", flush=True)
        print(f"  launches of the witnessed load: {counts}", flush=True)
        if ei["verdict"] != ew["valid?"] or got_keys != want_keys:
            raise AssertionError(f"witnessed verdicts: elle {ei}, keys "
                                 f"{got_keys}")
        if any(counts[k] < 1 for k in LINT_KERNELS):
            raise AssertionError(f"witnessed load launched too little: "
                                 f"{counts}")

        # 3. the witness's results
        block = snap.get("lockwatch") or {}
        rep = lockwatch.report()
        locks = rep["locks"]
        print(f"  witness: cycle {block.get('cycle')}, edges "
              f"{rep['edges']}, locks "
              + json.dumps({k: [v["acquires"], v["contended"],
                                v["wait_max_s"], v["hold_max_s"]]
                            for k, v in locks.items()})
              + " [acquires, contended, wait_max_s, hold_max_s]",
              flush=True)
        if block.get("cycle") is not False or rep["cycle"] \
                or not {"service", "watchdog", "batched.queue"} <= set(locks):
            raise AssertionError(f"witness: {block}, {rep}")
        recs = svc.ledger.query(kind="lockwatch")
        pts = reg.series("lockwatch").points
        errs = [e for r in recs for e in telemetry_lint.lint_ledger_file(
            svc.ledger.record_path(r["id"]))]
        errs += [e for p in pts for e in telemetry_lint.lint_line(
            {"type": "sample", "series": "lockwatch", **p}, "lockwatch")]
        diag = doctor.diagnose(doctor.TelemetryView(
            target="service", records=svc.ledger.query(),
            series={"lockwatch": pts}))
        rules = sorted({f["rule"] for f in diag["findings"]})
        print(f"  banked {len(recs)} lockwatch record(s), {len(pts)} "
              f"series point(s), lint errors {errs}; doctor rules {rules}",
              flush=True)
        if len(recs) != 1 or recs[0]["cycle"] is not False or errs \
                or "D016" in rules:
            raise AssertionError(f"lockwatch record: {recs}, {errs}, "
                                 f"{rules}")
        a, b = lockwatch.lock("smoke.A"), lockwatch.lock("smoke.B")
        with a:
            with b:
                pass
        raised = None
        try:
            with b:
                with a:
                    pass
        except lockwatch.LockOrderViolation as e:
            raised = str(e)
        again = a.acquire(timeout=1) and b.acquire(timeout=1)
        a.release()
        b.release()
        print(f"  seeded inversion: raised {raised is not None}, locks "
              f"taken again {again}", flush=True)
        if raised is None or "'smoke.A'" not in raised \
                or "'smoke.B'" not in raised or not again:
            raise AssertionError(f"seeded inversion: {raised}, {again}")
    finally:
        if wd is not None:
            wd.stop()
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        lockwatch.reset()

    # 4. the witness unset: a plain lock, and the same held load timed,
    # off and on in turns after the witnessed turn above
    def held_turn(n: int, witness: bool) -> list:
        if witness:
            os.environ[lockwatch.ENV] = "1"
            lockwatch.reset()
        try:
            svc = new_service(os.path.join(tmp, f"store-{n}"))
            try:
                plain = type(svc._lock) is type(threading.RLock())
                if plain is witness:
                    raise AssertionError(f"turn {n} (witness {witness}): "
                                         f"service lock {svc._lock!r}")
                infos, _ = serve_held(svc)
            finally:
                svc.close()
            if witness and lockwatch.report()["cycle"]:
                raise AssertionError(f"turn {n}: {lockwatch.report()}")
            if not witness and lockwatch.events():
                raise AssertionError(f"{lockwatch.events()} witness events "
                                     "with the witness off")
        finally:
            os.environ.pop(lockwatch.ENV, None)
            lockwatch.reset()
        return sorted(i["wall_s"] for i in infos)

    turns = [(True, sorted(i["wall_s"] for i in infos_on))]
    try:
        if lockwatch.enabled():
            raise AssertionError("the witness is still armed")
        for n, witness in enumerate(LINT_TURNS, 1):
            turns.append((witness, held_turn(n, witness)))
    finally:
        for k, v in prev_env.items():
            if v is not None:
                os.environ[k] = v
        mesh.pool_settle()
        mesh.pool_clear()
        fs_cache.DIR = prev_cache
    shutil.rmtree(tmp, ignore_errors=True)
    for witness in (True, False):
        walls = [w for on, ws in turns if on is witness for w in ws]
        print(f"  held batch walls (s), witness {'on' if witness else 'off'}"
              f": p50 {statistics.median(walls)} over {len(walls)}; turns "
              + "; ".join(f"p50 {statistics.median(ws)} {ws}"
                          for on, ws in turns if on is witness), flush=True)
    history_lint_step(dev, telemetry_lint)
    took = time.monotonic() - t_all
    print(f"  lint phase: {took:.1f} s", flush=True)
    if took > LINT_LIMIT_S:
        raise AssertionError(f"lint phase took {took:.1f} s (limit "
                             f"{LINT_LIMIT_S} s)")


# the history analyzer's step: the keys of the streamed direct call
LINT_DIRECT = dict(n_keys=4, n_ops=600, n_procs=5, crash_p=0.002)
LINT_OUTSIDE = 10 ** 6        # a read's value no cas-register state holds


def history_lint_step(dev, telemetry_lint) -> None:
    """The history analyzer and its gate on the card, with a metrics
    registry and a `fleet.RunStatus` installed:

      a. `python -m jepsen_tpu_torch.analysis.history_lint` in this
         process (`main([])`) exits 0;
      b. `analyze(h, model=cas_register())` over the headline finds no
         H006; with one read's value set to LINT_OUTSIDE, H006 at that
         read's index and "ok" True;
      c. a double invoke (H001) through `checker.linearizable(
         cas_register(), algorithm="cuda-wgl")` is "unknown" /
         "malformed-history" with no kernel launched, its checks counter
         {verdict="malformed"} 1, one `history_lint` point that lints
         clean under scripts/telemetry_lint.py and one MalformedHistory
         fault;
      d. the headline checked on the card: {verdict="clean"} counted
         once, and the preflight probe and the check prepare the history
         in one pass (the memo's lookups and stores counted);
      e. `check_streamed(race=False)` over LINT_DIRECT keys on the card:
         each verdict the host oracle's, `wgl32_chunk` launched, and the
         run status's key count reset to the key count (`begin_keys`).

    Any miss raises."""
    import io
    from collections import OrderedDict

    from jepsen_tpu_torch import checker, fleet, metrics, synth
    from jepsen_tpu_torch.analysis import history_lint
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import linprep, wgl_ref
    from jepsen_tpu_torch.parallel import batched

    class CountingMemo(OrderedDict):
        """`linprep`'s memo with its lookups (prepare calls) and stores
        (passes over a history) counted."""
        gets = sets = 0

        def get(self, key, default=None):
            self.gets += 1
            return super().get(key, default)

        def __setitem__(self, key, value):
            self.sets += 1
            super().__setitem__(key, value)

    t_step = time.monotonic()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = history_lint.main([])
    cli = json.loads(out.getvalue())
    print(f"  history_lint: main([]) exit {code}, {cli}", flush=True)
    if code != 0 or cli != {"ok": True, "failures": []}:
        raise AssertionError(f"history_lint.main: {code} {cli}")

    # b. the model rules over the headline, clean and with one read
    # outside the alphabet
    head = synth.cas_register_history(**HEADLINE)
    t0 = time.monotonic()
    rep = history_lint.analyze(head, model=cas_register())
    clean_s = time.monotonic() - t0
    pos = next(i for i, op in enumerate(head)
               if op.type == "ok" and op.f == "read" and op.value is not None)
    inv = max(i for i in range(pos) if head[i].process == head[pos].process
              and head[i].type == "invoke")
    bad = type(head)([op.with_(value=LINT_OUTSIDE) if i == pos else op
                      for i, op in enumerate(head)])
    rep_bad = history_lint.analyze(bad, model=cas_register())
    h006 = [a for a in rep_bad["anomalies"] if a["rule"] == "H006"]
    print(f"  analyze(model=cas_register) over the headline "
          f"({len(head)} ops, {clean_s:.3f} s): rule counts "
          f"{rep['rule_counts']}; read at {pos} set to {LINT_OUTSIDE}: "
          f"{rep_bad['rule_counts']}, H006 at op index "
          f"{[a['op_index'] for a in h006]}, ok {rep_bad['ok']}", flush=True)
    if rep["rule_counts"] or not rep["ok"] or rep_bad["ok"] is not True \
            or [a["op_index"] for a in h006] != [head[inv].index] \
            or set(rep_bad["rule_counts"]) != {"H006"}:
        raise AssertionError(f"analyze: {rep}, {rep_bad}")

    reg = metrics.Registry()
    st = fleet.RunStatus(test="history-lint", progress=False)
    lin = checker.linearizable(cas_register(), algorithm="cuda-wgl",
                               device=dev)
    with metrics.use(reg), fleet.use(st):
        # c. a double invoke: the gate's diagnosis, no launch
        i = next(i for i, op in enumerate(head) if op.type == "invoke")
        dbl = type(head)(list(head)[:i + 1] + [head[i]]
                         + list(head)[i + 1:]).index()
        zero_counts()
        t0 = time.monotonic()
        res = lin.check({}, dbl, {})
        mal_s = time.monotonic() - t0
        mal_counts = read_counts()
        checks = reg.counter("history_lint_checks_total")
        pts = reg.series("history_lint").points
        faults = [f for f in st.snapshot()["faults"]
                  if f["type"] == "MalformedHistory"]
        errs = [e for p in pts for e in telemetry_lint.lint_line(
            {"type": "sample", "series": "history_lint", **p},
            "history_lint")]
        json.dumps(pts)
        print(f"  malformed (H001) through cuda-wgl ({mal_s:.4f} s): "
              f"{res['valid?']} / {res.get('cause')} "
              f"{res.get('analyzer', {}).get('rule_counts')}; launches "
              f"{sum(mal_counts.values())}; checks "
              f"{checks.samples()}; {len(pts)} history_lint point(s), "
              f"lint errors {errs}; faults {faults}", flush=True)
        if (res["valid?"], res.get("cause")) != ("unknown",
                                                 "malformed-history") \
                or any(mal_counts.values()) \
                or checks.value(where="checker.linearizable",
                                verdict="malformed") != 1 \
                or len(pts) != 1 or errs or len(faults) != 1 \
                or faults[0]["stage"] != "history-lint/checker.linearizable":
            raise AssertionError(f"malformed history: {res}, {mal_counts}, "
                                 f"{checks.samples()}, {pts}, {faults}")

        # d. the headline: counted clean once, prepared in one pass
        memo = CountingMemo()
        prev_memo = linprep._PREP_MEMO
        linprep._PREP_MEMO = memo
        try:
            zero_counts()
            t0 = time.monotonic()
            res = lin.check({}, head, {})
            torch.cuda.synchronize()
            head_s = time.monotonic() - t0
            head_counts = read_counts()
        finally:
            linprep._PREP_MEMO = prev_memo
        print(f"  headline through cuda-wgl ({head_s:.4f} s): "
              f"{res['valid?']}; prepare calls {memo.gets}, passes "
              f"{memo.sets}; checks {checks.samples()}; launches "
              f"{head_counts['wgl32_chunk']} wgl32_chunk", flush=True)
        if res["valid?"] is not True or memo.gets != 2 or memo.sets != 1 \
                or checks.value(where="checker.linearizable",
                                verdict="clean") != 1 \
                or head_counts["wgl32_chunk"] < 1:
            raise AssertionError(f"headline: {res['valid?']}, {memo.gets} "
                                 f"calls, {memo.sets} passes, "
                                 f"{checks.samples()}, {head_counts}")

        # e. the direct streamed call, the race off
        keys = [synth.cas_register_history(
            LINT_DIRECT["n_ops"], n_procs=LINT_DIRECT["n_procs"], seed=k,
            crash_p=LINT_DIRECT["crash_p"])
            for k in range(LINT_DIRECT["n_keys"])]
        want = [wgl_ref.check(cas_register(), h)["valid?"] for h in keys]
        st.begin_keys(99)
        zero_counts()
        t0 = time.monotonic()
        out = batched.check_streamed(cas_register(), keys, race=False,
                                     device=dev)
        torch.cuda.synchronize()
        direct_s = time.monotonic() - t0
        direct_counts = read_counts()
        got = [r["valid?"] for r in out]
        engines = [r["shard"]["engine"] for r in out]
        k = st.snapshot()["keys"]
    print(f"  check_streamed(race=False) {LINT_DIRECT['n_keys']} keys x "
          f"{LINT_DIRECT['n_ops']} on the card ({direct_s:.4f} s): {got} "
          f"(oracle {want}), engines {engines}; launches "
          f"{direct_counts['wgl32_chunk']} wgl32_chunk; run status keys "
          f"total {k['total']} decided {k['decided']}", flush=True)
    if got != want or direct_counts["wgl32_chunk"] < 1 \
            or k["total"] != len(keys) or k["decided"] != len(keys):
        raise AssertionError(f"direct streamed call: {got} (oracle {want}),"
                             f" {direct_counts}, keys {k}")
    print(f"  history_lint step: {time.monotonic() - t_step:.2f} s; "
          f"wgl32_chunk launches: malformed {mal_counts['wgl32_chunk']}, "
          f"headline {head_counts['wgl32_chunk']}, direct streamed "
          f"{direct_counts['wgl32_chunk']}", flush=True)


# ---- the harness for real nodes and toykv ------------------------------------

# the node tools the phase runs (`nodeutil`, toykv), and those it only probes
CLUSTER_TOOLS = ("start-stop-daemon", "ps", "xargs", "awk", "grep", "bash")
CLUSTER_PROBED = ("killall", "pkill")
NODE_PYTHON = "/usr/bin/python3"          # toykv's daemon (`ToyKVDB._start`)
CLUSTER_SSH_NODES = ("127.0.0.1", "localhost")   # both the loopback sshd
CLUSTER_NODES = ["a", "b", "c"]
# 3 s: a kill at 1 s and its restart at 2 s, inside the run (the banners'
# gate needs the restart), leaving the bench round its budget (5 s with
# the kill/restart every 2 s until the mongodb and rabbitmq runs joined the
# suites phase)
CLUSTER_RUN = dict(concurrency=6, time_limit=3, nemesis_interval=1)
# the CLI's run: 2 s (3 s until the pgwire runs joined the suites phase;
# the step gates on the exit code alone)
CLUSTER_CLI = dict(nodes="a,b", concurrency=4, time_limit=2,
                   nemesis_interval=1)
CLUSTER_LIMIT_S = 240.0       # the phase's share of SMOKE_LIMIT_S
# the kernels of the phase's path: the race's device lane, and the
# re-check's mesh fan-out over [card] * MESH_SHARDS
CLUSTER_KERNELS = ("wgl32_chunk", "wgl32_chunk_batched")


def kv_of(value):
    """A stored `[k v]` tuple value (the store writes its repr) as a
    `KV` again; any other value unchanged."""
    import ast

    from jepsen_tpu_torch.independent import tuple_
    if not (isinstance(value, str) and value.startswith("[")
            and value.endswith("]") and " " in value):
        return value
    k, v = value[1:-1].split(" ", 1)
    return tuple_(ast.literal_eval(k), ast.literal_eval(v))


def cluster_phases(dev) -> dict:
    """The harness for real nodes and the first live suite, on the card's
    machine, each step's wall printed:

      1. the node tools: CLUSTER_TOOLS and NODE_PYTHON must be there
         (the package runs the reference's commands; nothing is emulated),
         CLUSTER_PROBED are printed (no step of this phase runs them), and
         `cryptography`'s version;
      2. native SSH: the port's `MiniSshd` on loopback, reached through
         `control.with_ssh({"remote": "native", ...})` on the two
         CLUSTER_SSH_NODES, each: `exec_` with stdout, stderr and exit
         codes, stdin, an upload and a download checked byte for byte,
         `nodeutil.start_daemon` of `sleep`, `daemon_running` True,
         `stop_daemon`, the process gone and `daemon_running` None; then
         a wrong password and a wrong host-key pin each raise `SshError`;
      3. a durable toykv register run in this process: CLUSTER_NODES,
         CLUSTER_RUN, toykv's own ports (from `toykv.BASE_PORT` 31850,
         below Linux's ephemeral range: a client retrying a down server's
         ephemeral port can connect to itself and hold it), the suite's
         checker on the card (the default device): True, one `server.log`
         snarfed per node, more than 3 serving banners, each key's winning
         engine, the launches of the run; then the stored history, read
         back from the store, re-checked by `independent.cuda_checker`
         over `[card] * MESH_SHARDS` (at least one `wgl32_chunk_batched`
         launch) and by the host oracle per key, both equal to the
         suite's own verdict on every key;
      4. a volatile set run (kill -9, restart, read back): False with
         `lost-count` > 0;
      5. `python -m jepsen_tpu_torch.dbs.toykv test` (CLUSTER_CLI) in a
         fresh process: exit 0.

    Returns the launches of steps 3 and 4 by kernel. Takes at most
    CLUSTER_LIMIT_S; any miss raises."""
    import collections
    import hashlib
    import os
    import shutil
    import tempfile

    import cryptography

    from jepsen_tpu_torch import checker, control, core, independent, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.control import minisshd, nodeutil, sshnative
    from jepsen_tpu_torch.control import sshwire
    from jepsen_tpu_torch.dbs import toykv
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.util import integer_interval_set_str

    print(f"the harness for real nodes and toykv ({card_line()}):",
          flush=True)
    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="cluster-", dir=str(REPO / "build" /
                                                      "torch_kernels"))

    # 1. the node tools
    t0 = time.monotonic()
    found = {t: shutil.which(t) for t in CLUSTER_TOOLS + CLUSTER_PROBED}
    py = (subprocess.run([NODE_PYTHON, "-c", "import sys; print(sys.version"
                          ".split()[0])"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
          if os.path.exists(NODE_PYTHON) else None)
    print(f"  node tools ({time.monotonic() - t0:.2f} s): "
          + ", ".join(f"{t} {p or 'MISSING'}" for t, p in found.items())
          + f"; {NODE_PYTHON} {py or 'MISSING'}; cryptography "
          f"{cryptography.__version__} (not run by this phase: "
          f"{', '.join(CLUSTER_PROBED)})", flush=True)
    missing = [t for t in CLUSTER_TOOLS if not found[t]] + (
        [] if py else [NODE_PYTHON])
    if missing:
        raise AssertionError(f"node tools missing: {missing}")

    # 2. native SSH over the loopback sshd
    t0 = time.monotonic()
    ssh_dir = os.path.join(tmp, "sshd")
    os.makedirs(ssh_dir)
    srv = minisshd.MiniSshd(cwd=ssh_dir).start()
    sleep_bin = os.path.realpath(shutil.which("sleep"))
    payload = bytes(range(256)) * 4096 + b"\xff\xfe\x80 not utf-8"
    local = os.path.join(tmp, "payload.bin")
    with open(local, "wb") as fh:
        fh.write(payload)

    def ssh_node():
        host = control.state.host
        out = {"echo": control.exec_("echo", "over", "native", host)}
        sess = control.state.session
        res = sess.execute({}, {"cmd": "echo oops >&2; exit 3"})
        out["stderr"] = (res["exit"], res["out"], res["err"])
        try:
            control.exec_("bash", "-c", "echo gone >&2; exit 7")
            out["raised"] = None
        except control.NonzeroExit as e:
            out["raised"] = (e.result["exit"], e.result["err"])
        res = sess.execute({}, {"cmd": "wc -c", "in": "x" * 100_000})
        out["stdin"] = (res["exit"], res["out"].strip())
        remote = os.path.join(ssh_dir, f"up-{host}.bin")
        control.upload(local, remote)
        back = os.path.join(tmp, f"down-{host}.bin")
        control.download(remote, back)
        with open(back, "rb") as fh:
            out["bytes"] = fh.read() == payload
        out["sha"] = control.exec_("sha256sum", remote).split()[0] == \
            hashlib.sha256(payload).hexdigest()
        pidfile = os.path.join(ssh_dir, f"sleep-{host}.pid")
        opts = {"logfile": os.path.join(ssh_dir, f"sleep-{host}.log"),
                "pidfile": pidfile, "chdir": ssh_dir}
        out["start"] = nodeutil.start_daemon(opts, sleep_bin, "300")
        deadline = time.monotonic() + 10
        while not nodeutil.file_exists(pidfile):
            if time.monotonic() > deadline:
                raise AssertionError(f"{host}: no {pidfile}")
            time.sleep(0.02)
        out["running"] = nodeutil.daemon_running(pidfile)
        pid = control.exec_("cat", pidfile).strip()
        nodeutil.stop_daemon(pidfile)
        deadline = time.monotonic() + 10
        while True:     # gone, or a zombie not yet reaped
            stat = nodeutil.meh(control.exec_, "ps", "-o", "stat=", "-p",
                                pid)
            if not stat or stat.startswith("Z"):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{host}: sleep {pid} still {stat}")
            time.sleep(0.02)
        out["stopped"] = nodeutil.daemon_running(pidfile)
        return out

    ssh = {"remote": "native", "username": srv.user,
           "password": srv.password, "port": srv.port}
    try:
        with control.with_ssh(ssh):
            got = control.on_many(list(CLUSTER_SSH_NODES), ssh_node)
        refused = {}
        for what, spec in (("password", {"password": "wrong"}),
                           ("host key", {"hostkey": b"\x00" * 32})):
            try:
                sshnative.NativeSSHRemote().connect({
                    "host": "127.0.0.1", "port": srv.port,
                    "username": srv.user, "password": srv.password,
                    "hostkey": srv.host_key_raw, **spec})
                refused[what] = None
            except sshwire.SshError as e:
                refused[what] = str(e)
    finally:
        srv.stop()
    print(f"  native SSH ({time.monotonic() - t0:.2f} s) over the loopback "
          f"sshd on {list(CLUSTER_SSH_NODES)}: "
          + "; ".join(f"{h}: {o}" for h, o in got.items())
          + f"; refused: {refused}", flush=True)
    for h, o in got.items():
        if (o["echo"] != f"over native {h}"
                or o["stderr"] != (3, "", "oops\n")
                or o["raised"] != (7, "gone\n") or o["stdin"] != (0, "100000")
                or not o["bytes"] or not o["sha"] or o["start"] != "started"
                or o["running"] is not True or o["stopped"] is not None):
            raise AssertionError(f"native SSH on {h}: {o}")
    if not (refused["password"] and "password rejected" in refused["password"]
            and refused["host key"] and "MISMATCH" in refused["host key"]):
        raise AssertionError(f"native SSH refusals: {refused}")

    # 3. a durable register run, then its stored history three ways
    t0 = time.monotonic()
    root = os.path.join(tmp, "store")
    test = toykv.toykv_test({
        "name": "cluster-register", "nodes": CLUSTER_NODES,
        "store_root": root, "sandbox": os.path.join(tmp, "nodes"),
        **CLUSTER_RUN})
    before = read_counts()
    zero_counts()
    t = core.run(test)
    counts = read_counts()
    run_wall = time.monotonic() - t0
    res = t["results"]
    keys = res["register"]["results"]
    by_engine: dict = collections.defaultdict(list)
    for k, r in keys.items():
        by_engine[r["linear"].get("engine")].append(k)
    banners = {n: open(os.path.join(t["store_dir"], n, "server.log")).read()
               .count("toykv serving on") for n in CLUSTER_NODES}
    n_ops = len(t["history"])
    ports = {n: toykv.node_port(test, n) for n in CLUSTER_NODES}
    print(f"  register run ({run_wall:.2f} s; {CLUSTER_RUN}, ports "
          f"{ports}): valid? {res['valid?']}, {len(keys)} keys, "
          f"{n_ops} ops; serving banners {banners}; the launches before "
          f"{ {k: v for k, v in before.items() if v} } and of the run "
          f"{counts}", flush=True)
    print("  winning engine by key: " + "; ".join(
        f"{e} ({len(ks)}) {integer_interval_set_str(ks)}"
        for e, ks in sorted(by_engine.items(), key=str)), flush=True)
    if (res["valid?"] is not True or sum(banners.values()) <= 3
            or counts["wgl32_chunk"] < 1 or not keys
            or set(by_engine) - {"device", "oracle", "device@cpu"}):
        raise AssertionError(f"register run: {res['valid?']}, banners "
                             f"{banners}, launches {counts}, engines "
                             f"{sorted(by_engine, key=str)}")

    t0 = time.monotonic()
    stored = store.load_latest(root)
    hist = History([{**op, "value": kv_of(op.get("value"))}
                    for op in stored["history"]]).index()
    if [o.to_dict() for o in hist] != [o.to_dict() for o in t["history"]]:
        raise AssertionError("the stored history differs from the run's")
    zero_counts()
    t_c = time.monotonic()
    mesh_res = independent.cuda_checker(
        cas_register(), devices=[dev] * MESH_SHARDS).check(
            {"name": "cluster-recheck"}, hist, {})
    torch.cuda.synchronize()
    mesh_s = time.monotonic() - t_c
    recheck = read_counts()
    t_c = time.monotonic()
    host_res = independent.checker(checker.linearizable(
        cas_register(), algorithm="wgl", device="cpu")).check(
            {"name": "cluster-oracle"}, hist, {})
    host_s = time.monotonic() - t_c
    suite = {k: r["valid?"] for k, r in keys.items()}
    on_card = {k: r["valid?"] for k, r in mesh_res["results"].items()}
    oracle = {k: r["valid?"] for k, r in host_res["results"].items()}
    engines = collections.Counter(
        str((r.get("shard") or {}).get("engine"))
        for r in mesh_res["results"].values())
    print(f"  re-check of the stored history ({time.monotonic() - t0:.2f} s):"
          f" cuda_checker over [card] * {MESH_SHARDS} {mesh_res['valid?']} "
          f"in {mesh_s:.3f} s (engines {dict(engines)}, launches {recheck}), "
          f"host oracle {host_res['valid?']} in {host_s:.3f} s, the suite "
          f"{res['register']['valid?']}; keys agreeing "
          f"{sum(on_card[k] == oracle[k] == suite[k] for k in suite)} of "
          f"{len(suite)}", flush=True)
    if not (on_card == oracle == suite) or recheck["wgl32_chunk_batched"] < 1:
        raise AssertionError(f"re-check: {len(on_card)} / {len(oracle)} / "
                             f"{len(suite)} keys, launches {recheck}")
    for k, v in recheck.items():
        counts[k] += v

    # 4. the volatile set run: acknowledged adds lost under kill -9
    t0 = time.monotonic()
    db = toykv.ToyKVDB(volatile=True)
    vt = toykv.toykv_test({
        "name": "cluster-volatile", "nodes": ["a"], "concurrency": 2,
        "store_root": root, "sandbox": os.path.join(tmp, "volatile"),
        "time_limit": 30})
    vt.update(db=db,
              client=toykv.ToyKVSetClient(),
              nemesis=toykv.kill_restart_nemesis(db),
              checker=checker.set_checker())
    counter = iter(range(1000))
    vt["generator"] = gen.phases(
        gen.clients([gen.limit(10, lambda t_, c: {
            "f": "add", "value": next(counter)})]),
        gen.nemesis([
            gen.once({"type": "info", "f": "start", "value": ["a"]}),
            gen.once({"type": "info", "f": "stop", "value": ["a"]})]),
        gen.clients([gen.limit(3, lambda t_, c: {
            "f": "read", "value": None})]))
    vres = core.run(vt)["results"]
    print(f"  volatile set run ({time.monotonic() - t0:.2f} s): valid? "
          f"{vres['valid?']}, lost-count {vres.get('lost-count')}, "
          f"ok-count {vres.get('ok-count')}", flush=True)
    if vres["valid?"] is not False or not vres.get("lost-count"):
        raise AssertionError(f"volatile set run: {vres}")

    # 5. the suite's CLI in a fresh process
    t0 = time.monotonic()
    c = CLUSTER_CLI
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.dbs.toykv", "test",
         "--nodes", c["nodes"], "--concurrency", str(c["concurrency"]),
         "--time-limit", str(c["time_limit"]), "--nemesis-interval",
         str(c["nemesis_interval"]), "--store-root",
         os.path.join(tmp, "cli-store"), "--sandbox",
         os.path.join(tmp, "cli-nodes")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    print(f"  CLI in a fresh process ({time.monotonic() - t0:.2f} s, "
          f"{CLUSTER_CLI}): exit {proc.returncode}; "
          + (proc.stderr.strip().splitlines() or [""])[-1][-200:],
          flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"toykv CLI: exit {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")

    shutil.rmtree(tmp, ignore_errors=True)
    took = time.monotonic() - t_all
    print(f"  launches of the phase: {counts}", flush=True)
    print(f"  cluster phase: {took:.1f} s", flush=True)
    if any(counts[k] < 1 for k in CLUSTER_KERNELS):
        raise AssertionError(f"cluster phase launched too little: {counts}")
    if took > CLUSTER_LIMIT_S:
        raise AssertionError(f"cluster phase took {took:.1f} s (limit "
                             f"{CLUSTER_LIMIT_S} s)")
    return counts


# ---- the first live SQL suite -------------------------------------------------

SUITES_LIMIT_S = 170.0        # the phase's share of SMOKE_LIMIT_S
# the reference test's options (`tests/test_sqlite.py`: one node, 4 workers,
# a kill/restart of the primary every 2 s), for 5 s
SUITE_RUN = dict(nodes=["p1"], concurrency=4, time_limit=5,
                 nemesis_interval=2.0)
# the mean gap between the runs' transactions: about a thousand complete in
# a run, some 550 in the graph, so that it passes the route's `min_n` (384)
# and stays inside the dense closure's capacity (8192); an unpaced run
# completes ~24k, whose graph goes to the packed closure
SUITE_STAGGER_S = 0.005
# the bank run, unpaced: 1 s (5 s until the mongodb and rabbitmq runs
# joined the phase, 3 s until the MySQL-wire runs did, 2 s until yuga's and
# raftis's did)
SUITE_BANK = dict(time_limit=1)
# etcd's live runs: `register` with the reference test's options
# (`tests/test_etcd.py::test_full_suite_live_mini`: one node, 4 workers, 40
# ops a key), for 3 s (ETCD_RUN's note) with the
# kill/restart every 1 s so that the kill at 1 s and the restart at 2 s
# fall inside the run;
# `append` paced as sqlite's, ETCD_STAGGER_S
# apart, for 7.5 s with the reference test's kill/restart every 2.5 s (up
# 2.5 s, down 2.5, up 2.5), so that its graph lands between the route's
# `min_n` (384) and the dense closure's capacity (8192): each transaction
# is two HTTP requests and an fsync a key written, and on an H100's
# machine 358 of 782 completed transactions reached the graph at
# SUITE_STAGGER_S for 5 s (the rest crashed while the server was down),
# 384-465 at 2 ms for 6 s with the kill/restart every 2 s
# The kill/restart register runs (etcd, mongodb, mysql_cluster, yuga,
# raftis, aerospike, dgraph) last 3 s with the kill at 1 s and the
# restart at 2 s: the restart's invoke lands 0.2-0.46 s past 2 s (the kill
# op's own time; etcd's, on an H100's machine and on the CPU), so runs
# of 2.5 s lost it to the time limit now and then (one serving banner).
ETCD_RUN = dict(nodes=["t1"], concurrency=4, time_limit=3,
                nemesis_interval=1.0, server="mini", per_key_limit=40)
ETCD_APPEND = dict(time_limit=7.5, nemesis_interval=2.5)
ETCD_STAGGER_S = 0.002
ETCD_LIMIT_S = 25.0           # the two etcd runs' share of SUITES_LIMIT_S
# mongodb's live register run: the reference test's one node and 4 workers
# (`tests/test_mongodb.py::test_full_suite_live`) and the suite's 100 ops a
# key, for 3 s (ETCD_RUN's note) with the kill/restart every 1 s so that
# the kill at 1 s and the restart at 2 s fall inside the run
MONGO_RUN = dict(nodes=["m1"], concurrency=4, time_limit=3,
                 nemesis_interval=1.0, server="mini", workload="register")
# rabbitmq's semaphore run, the reference test's
# (`tests/test_rabbitmq.py::test_full_semaphore_suite_live_mini`: one
# broker, 3 workers), for 3 s (the reference test's 5 s until the MySQL-wire
# runs joined the phase)
RABBIT_SEM = dict(nodes=["r1"], concurrency=3, time_limit=3,
                  nemesis_interval=2.0, server="mini", workload="semaphore")
# the list-append history.edn: this many copies of `tests/test_edn.py`'s
# three-transaction G-single (`ELLE_EDN`), each on keys of its own, 600
# transactions in all: past the route's `min_n` (384), inside the dense
# closure's capacity (8192)
EDN_APPEND_COPIES = 200
DOCS_LIMIT_S = 35.0           # rabbitmq's, mongodb's and EDN's share of it
# the MySQL-wire family's live runs, on galera's embedded server (stdlib
# sqlite3 behind the MySQL wire, WAL + synchronous=FULL, one BEGIN
# IMMEDIATE writer at a time): mysql_cluster `register` with the reference
# test's one mini node and 4 workers
# (`tests/test_mysql_cluster.py::test_register_live`) and the suite's 100
# ops a key, for 3 s (ETCD_RUN's note) with the kill/restart every 1 s so
# that the kill at 1 s and the restart at 2 s fall inside the run
NDB_RUN = dict(nodes=["m1"], concurrency=4, time_limit=3,
               nemesis_interval=1.0, server="mini", workload="register")
# tidb `append`, one mini node and 4 workers under the kill nemesis, paced
# TIDB_STAGGER_S apart, for 7.5 s with the kill/restart every 2.5 s (up
# 2.5 s, down 2.5, up 2.5, as etcd's append) so that its graph lands
# between the route's `min_n` (384) and the dense closure's capacity
# (8192): each transaction is a BEGIN .. COMMIT of a statement or two a
# micro-op over the wire, one writer at a time, and the server bounds the
# rate: on an H100's machine, for 5 s with the kill/restart every 2 s, 403
# transactions completed unpaced, 354-388 at 5 ms, 283-350 at 2-3 ms and
# 140 at 10 ms, each all in the graph but those crashed
TIDB_APPEND = dict(nodes=["t1"], concurrency=4, time_limit=7.5,
                   nemesis_interval=2.5, server="mini", workload="append",
                   nemesis="kill")
TIDB_STAGGER_S = 0.005
MYSQL_LIMIT_S = 25.0          # the MySQL-wire runs' share of SUITES_LIMIT_S
# the pgwire family's live runs, on stolon's embedded server (stdlib sqlite3
# behind pgwire, WAL + synchronous=FULL, every BEGIN a BEGIN IMMEDIATE: one
# writer at a time): postgres `register` against one minipg node on
# stolon's ports (the suite drives an existing endpoint and has no nemesis),
# the reference test's 4 workers (`tests/test_postgres.py::
# test_register_suite`) and the suite's 100 ops a key, for 2 s (3 s until
# yuga's and raftis's runs joined the phase)
PG_REGISTER = dict(nodes=["s1"], concurrency=4, time_limit=2,
                   workload="register")
# stolon `append`, one mini node and 4 workers under the kill nemesis, paced
# and timed as tidb's append (the same one-writer engine behind another
# wire) so that its graph lands between the route's `min_n` (384) and the
# dense closure's capacity (8192)
STOLON_APPEND = dict(nodes=["s1"], concurrency=4, time_limit=7.5,
                     nemesis_interval=2.5, server="mini", workload="append")
STOLON_STAGGER_S = 0.005
PG_LIMIT_S = 25.0             # the pgwire runs' share of SUITES_LIMIT_S
# yuga's ycql `multi-key-acid` (txns of micro-ops over 3-subkey groups, each
# group a key checked linearizable against the multi-register model) with
# the reference test's one node and 4 workers
# (`tests/test_yuga.py::test_multi_key_acid_live`), and raftis's register
# with its reference test's (`tests/test_raftis.py::test_full_suite_live`),
# each for 3 s (ETCD_RUN's note) with the kill/restart every 1 s so that
# the kill at 1 s and the restart at 2 s fall inside the run, on a
# mini-redis server on its suite's own ports
YUGA_MKA = dict(nodes=["y1"], concurrency=4, time_limit=3,
                nemesis_interval=1.0, workload="ycql/multi-key-acid")
RAFTIS_RUN = dict(nodes=["r1"], concurrency=4, time_limit=3,
                  nemesis_interval=1.0)
YUGA_LIMIT_S = 20.0           # yuga's and raftis's share of SUITES_LIMIT_S
# the binary-wire suites' live runs, each on its own mini server: aerospike
# `cas-register` (generation-CAS records) with the reference test's one node
# and 4 workers (`tests/test_aerospike.py::test_full_suite_live`) for
# 3 s with the kill/restart every 1 s (NDB_RUN's timing) so that the kill
# at 1 s and the restart at 2 s fall inside the run; hazelcast's fenced
# `lock` with its reference test's one node and 4 workers
# (`tests/test_hazelcast.py::test_full_suite_live`) for 2 s, fault-free as
# the workload is (its nemesis a no-op: a kill frees every held lock); 3 s
# each until the dgraph runs joined the phase
AERO_RUN = dict(nodes=["a1"], concurrency=4, time_limit=3,
                nemesis_interval=1.0, workload="cas-register")
HZ_LOCK = dict(nodes=["h1"], concurrency=4, time_limit=2, workload="lock")
GRID_LIMIT_S = 20.0           # aerospike's and hazelcast's share of it
# the last HTTP suite's live runs, on dgraph's mini alpha from its suite's
# own ports, through the port's stdlib HTTP client: `register` with the
# reference test's one node and 4 workers
# (`tests/test_dgraph.py::test_full_suite_live`) and the suite's 100 ops a
# key, and `wr` with the same, each for 3 s with the kill/restart every
# 1 s so that the kill at 1 s and the restart at 2 s fall inside the run
DGRAPH_RUN = dict(nodes=["d1"], concurrency=4, time_limit=3,
                  nemesis_interval=1.0, workload="register")
DGRAPH_WR = dict(DGRAPH_RUN, workload="wr")
HTTP_LIMIT_S = 20.0           # the dgraph runs' share of SUITES_LIMIT_S
SUITE_KERNELS = ("elle_closure", "wgl32_chunk")


class HeldClosures:
    """Inside the block, the inputs (`closure_inputs`) and the outputs (the
    `_watched` call around the kernel) of every dense closure the Elle
    checks ran; `errs(dev)` holds each output against `closure_ref` on the
    same inputs on the card."""

    def __enter__(self):
        from jepsen_tpu_torch.elle import tpu as etpu
        self.etpu, self.ins, self.outs = etpu, [], []
        self.orig = (etpu.closure_inputs, etpu._watched)

        def inputs(*a, **kw):
            got = self.orig[0](*a, **kw)
            self.ins.append(None if kw.get("packed") else got)
            return got

        def watched(fn, devices, **progress):
            got = self.orig[1](fn, devices, **progress)
            if progress.get("kernel") != "trim":
                self.outs.append(got[0])
            return got

        etpu.closure_inputs, etpu._watched = inputs, watched
        return self

    def __exit__(self, *exc):
        self.etpu.closure_inputs, self.etpu._watched = self.orig

    def errs(self, dev) -> list:
        if len(self.ins) != len(self.outs):
            raise AssertionError(f"{len(self.ins)} closure inputs for "
                                 f"{len(self.outs)} closure outputs")
        out = []
        for a, got in zip(self.ins, self.outs):
            if a is None:
                continue
            ref = self.etpu.closure_ref(*on_card(a["args"], dev),
                                        n_pad=a["n_pad"], iters=a["iters"])
            out.append(outputs_err(got, ref))
        return out


def paced(opts: dict, workload_gen, stagger_s: float):
    """A live suite's generator with its workload paced `stagger_s`
    apart: the kill/restart cycle every `nemesis_interval` seconds and
    the whole under the run's `time_limit` (the suites' own shape)."""
    from jepsen_tpu_torch import generator as gen
    i = opts["nemesis_interval"]
    return gen.time_limit(opts["time_limit"], gen.nemesis(
        gen.cycle([gen.sleep(i), {"type": "info", "f": "start"},
                   gen.sleep(i), {"type": "info", "f": "stop"}]),
        gen.stagger(stagger_s, workload_gen)))


def elle_rechecks(what: str, check, stored, chk, suite: dict, dev) -> tuple:
    """A live Elle run's stored history re-checked with the suite's
    options (`chk`: the suite's append or wr checker) three ways: the
    routed "auto" on the card, a forced `cycle_backend="device"` on the
    card, which must launch `elle_closure` (each dense closure held
    against `closure_ref` on the same inputs, error 0), and the "host"
    oracle; the three and the suite's own result `suite` must agree on
    `valid?` and `anomaly-types`. Returns (the launches by kernel, the
    closures' largest error)."""
    import collections

    kw = dict(anomalies=chk.anomalies,
              additional_graphs=chk.additional_graphs)
    if hasattr(chk, "linearizable_keys"):
        kw.update(sequential_keys=chk.sequential_keys,
                  linearizable_keys=chk.linearizable_keys,
                  wfr_keys=chk.wfr_keys)
    counts: collections.Counter = collections.Counter()
    worst = 0
    verdicts = {"suite": suite}
    for how, backend, where in (("auto", "auto", dev),
                                ("device", "device", dev),
                                ("host", "host", None)):
        zero_counts()
        t_c = time.monotonic()
        with HeldClosures() as held:
            verdicts[how] = check(stored, cycle_backend=backend,
                                  device=where, **kw)
            torch.cuda.synchronize()
        wall = time.monotonic() - t_c
        launched = read_counts()
        errs = held.errs(dev)
        worst = max([worst] + errs)
        counts.update(launched)
        print(f"    {how}: valid? {verdicts[how]['valid?']}, anomalies "
              f"{verdicts[how]['anomaly-types']}, engine "
              f"{verdicts[how].get('cycle-engine')}, route "
              f"{verdicts[how].get('cycle-route-reason')!r}, "
              f"{wall:.3f} s, launches "
              f"{ {k: v for k, v in launched.items() if v} }, dense "
              f"closures held against closure_ref: max abs err by "
              f"closure {errs}", flush=True)
        if any(errs):
            raise AssertionError(f"{what} {how}: elle_closure differs "
                                 f"from closure_ref: {errs}")
        if how == "device" and (launched["elle_closure"] < 1 or not errs):
            raise AssertionError(f"{what}: the forced device check "
                                 f"launched {launched}")
    for how, v in verdicts.items():
        same_verdict(f"{what} {how} vs host", v, verdicts["host"])
    return counts, worst


def etcd_runs(dev, tmp: str) -> tuple:
    """etcd's two live runs on the card (ETCD_RUN, a mini-etcd server over
    the localexec remote, its kill/restart nemesis sending real `kill
    -9`s, the port's stdlib HTTP client): `register`, its checker's
    competition race a key (the device lane `wgl32_chunk`), True with at
    least one launch, each key's verdict equal to the host "wgl"
    oracle's on the stored history; then `append` (ETCD_APPEND), paced by
    ETCD_STAGGER_S, True with no anomaly, its stored history re-checked
    by `elle_rechecks`. Returns (the launches by kernel, the closures'
    largest error); takes at most ETCD_LIMIT_S."""
    import collections
    import os

    from jepsen_tpu_torch import checker, independent, store
    from jepsen_tpu_torch.dbs import etcd
    from jepsen_tpu_torch.elle import append
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import cas_register

    t_all = time.monotonic()
    counts: collections.Counter = collections.Counter()

    def run(which: str, pace: bool):
        opts = {**ETCD_RUN, **(ETCD_APPEND if pace else {}),
                "workload": which, "name": f"suites-etcd-{which}",
                "store_root": os.path.join(tmp, "etcd", which, "store"),
                "sandbox": os.path.join(tmp, "etcd", which, "nodes")}
        test = etcd.etcd_test(opts)
        if pace:
            test["generator"] = paced(
                opts, etcd.WORKLOADS[which](opts)["generator"],
                ETCD_STAGGER_S)
        zero_counts()
        t0 = time.monotonic()
        done = diagnosed_run(test, f"the etcd {which} run", opts["sandbox"],
                             "t1", etcd.MiniEtcdDB.logfile)
        torch.cuda.synchronize()
        launched = read_counts()
        counts.update(launched)
        banners = open(os.path.join(done["store_dir"], "t1",
                                    etcd.MiniEtcdDB.logfile)
                       ).read().count("minietcd serving on")
        return (test, done, {k: v for k, v in launched.items() if v},
                time.monotonic() - t0, banners)

    # register: the suite, then each key against the host oracle
    test, done, launched, wall, banners = run("register", pace=False)
    res = done["results"]["register"]
    keys = res["results"]
    engines = collections.Counter(str(r["linear"].get("engine"))
                                  for r in keys.values())
    n_ops = sum(1 for o in done["history"] if o.process != "nemesis"
                and o.type != "invoke")
    print(f"  etcd register run ({wall:.2f} s; {ETCD_RUN}): valid? "
          f"{done['results']['valid?']}, {len(keys)} keys decided, {n_ops} "
          f"ops completed, serving banners {banners}, winning engines "
          f"{dict(engines)}, launches {launched}", flush=True)
    if (done["results"]["valid?"] is not True or not keys or banners < 2
            or launched.get("wgl32_chunk", 0) < 1):
        raise AssertionError(f"etcd register: {done['results']['valid?']}, "
                             f"{len(keys)} keys, banners {banners}, "
                             f"launches {launched}")
    t0 = time.monotonic()
    stored = store.load_latest(os.path.join(tmp, "etcd", "register",
                                            "store"))
    hist = History([{**op, "value": kv_of(op.get("value"))}
                    for op in stored["history"]]).index()
    if [o.to_dict() for o in hist] != [o.to_dict() for o in done["history"]]:
        raise AssertionError("etcd register: the stored history differs "
                             "from the run's")
    oracle = independent.checker(checker.linearizable(
        cas_register(), algorithm="wgl", device="cpu")).check(
            {"name": "etcd-oracle"}, hist, {})
    suite = {k: r["valid?"] for k, r in keys.items()}
    host = {k: r["valid?"] for k, r in oracle["results"].items()}
    print(f"    host oracle on the stored history "
          f"({time.monotonic() - t0:.2f} s): {oracle['valid?']}; keys "
          f"agreeing {sum(host.get(k) == v for k, v in suite.items())} of "
          f"{len(suite)}", flush=True)
    if host != suite:
        raise AssertionError(f"etcd register: {len(host)} oracle verdicts "
                             f"against {len(suite)} of the suite's differ")

    # append: the suite, then its stored history three ways
    test, done, launched, wall, banners = run("append", pace=True)
    res = done["results"]["append"]
    hist = done["history"]
    stored = History(store.load_latest(os.path.join(
        tmp, "etcd", "append", "store"))["history"]).index()
    if [o.to_dict() for o in stored] != [o.to_dict() for o in hist]:
        raise AssertionError("etcd append: the stored history differs from "
                             "the run's")
    txns = sum(1 for o in hist if o.f == "txn" and o.type != "invoke")
    oks = sum(1 for o in hist if o.f == "txn" and o.type == "ok")
    print(f"  etcd append run ({wall:.2f} s; {ETCD_RUN}, {ETCD_APPEND}, "
          f"paced {ETCD_STAGGER_S} s): valid? {done['results']['valid?']} "
          f"(append {res['valid?']}, anomalies {res['anomaly-types']}), "
          f"{txns} txns completed ({oks} ok), serving banners {banners}, "
          f"engine {res.get('cycle-engine')}, route "
          f"{res.get('cycle-route-reason')!r}, launches {launched}",
          flush=True)
    if (done["results"]["valid?"] is not True or res["valid?"] is not True
            or res["anomaly-types"] or banners < 2):
        raise AssertionError(f"etcd append: {done['results']}, banners "
                             f"{banners}")
    rechecked, worst = elle_rechecks(
        "etcd append", append.check, stored,
        test["checker"].checker_map["append"], res, dev)
    counts.update(rechecked)
    took = time.monotonic() - t_all
    print(f"  etcd runs: {took:.1f} s", flush=True)
    if took > ETCD_LIMIT_S:
        raise AssertionError(f"etcd runs took {took:.1f} s (limit "
                             f"{ETCD_LIMIT_S} s)")
    return counts, worst


def edn_form(v) -> str:
    """`v` as the Clojure Jepsen prints it in a history.edn: None as nil,
    a list or tuple as a vector, an int or a bool as itself, a string as
    a keyword."""
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return "[" + " ".join(edn_form(x) for x in v) + "]"
    if isinstance(v, str):
        return ":" + v
    return repr(v)


def edn_line(op: dict) -> str:
    """One op map as store.clj's `write-history!` prints a line."""
    return "{" + ", ".join(f":{k} {edn_form(v)}" for k, v in op.items()) + "}"


def elle_edn(copies: int) -> str:
    """`tests/test_edn.py`'s list-append G-single (`ELLE_EDN`), `copies`
    times, copy i on keys 2i and 2i + 1, one op map a line."""
    lines, t = [], 0
    for i in range(copies):
        x, y = 2 * i, 2 * i + 1
        for p, inv, done in (
                (0, [["append", x, 1]], [["append", x, 1]]),
                (1, [["r", x, None], ["append", y, 1]],
                 [["r", x, [1]], ["append", y, 1]]),
                (2, [["r", y, None], ["r", x, None]],
                 [["r", y, [1]], ["r", x, []]])):
            for typ, value in (("invoke", inv), ("ok", done)):
                lines.append(edn_line({"process": p, "type": typ,
                                       "f": "txn", "value": value,
                                       "time": t}))
                t += 1
    return "\n".join(lines) + "\n"


TCP_STATES = {"01": "ESTABLISHED", "02": "SYN_SENT", "03": "SYN_RECV",
              "04": "FIN_WAIT1", "05": "FIN_WAIT2", "06": "TIME_WAIT",
              "07": "CLOSE", "08": "CLOSE_WAIT", "09": "LAST_ACK",
              "0A": "LISTEN", "0B": "CLOSING"}


def port_holders(port: int) -> list:
    """Every TCP socket on this host with `port` at either end, read from
    /proc/net/tcp and tcp6: its state, both ports and the process that
    holds it (pid and command line, found by the socket's inode under
    /proc/<pid>/fd), or its inode where no process of ours holds it."""
    import os
    socks = []
    for table in ("tcp", "tcp6"):
        try:
            with open(f"/proc/net/{table}") as fh:
                lines = fh.read().splitlines()[1:]
        except OSError:
            continue
        for line in lines:
            f = line.split()
            local, remote = (int(x.rsplit(":", 1)[1], 16) for x in f[1:3])
            if port in (local, remote):
                socks.append((table, TCP_STATES.get(f[3], f[3]), local,
                              remote, f[9]))
    owners = {}
    want = {s[4] for s in socks if s[4] != "0"}
    for pid in (os.listdir("/proc") if want else ()):
        if not pid.isdigit():
            continue
        try:
            for fd in os.listdir(f"/proc/{pid}/fd"):
                link = os.readlink(f"/proc/{pid}/fd/{fd}")
                if link.startswith("socket:[") and link[8:-1] in want:
                    with open(f"/proc/{pid}/cmdline", "rb") as fh:
                        cmd = fh.read().replace(b"\0", b" ").decode(
                            errors="replace").strip()
                    owners[link[8:-1]] = f"pid {pid}: {cmd[:160]}"
        except OSError:
            continue
    return [f"{t} {st} {lp} -> {rp}, {owners.get(ino, f'inode {ino}')}"
            for t, st, lp, rp, ino in socks]


@contextlib.contextmanager
def server_diagnosis(what: str, port, log_path: str):
    """Around a live run or a server's start: if the block raises (a server
    that never opened its port, a run that failed), print the last 30
    lines of the server's log at `log_path`, who holds its `port`
    (`port_holders`) and the host's ephemeral port range, then let the
    exception go on. No retry."""
    try:
        yield
    except Exception as exc:
        try:
            with open(log_path, errors="replace") as fh:
                tail = fh.read().splitlines()[-30:]
        except OSError as e:
            tail = [f"(unreadable: {e})"]
        print(f"  {what} failed ({type(exc).__name__}: {exc}); the last "
              f"{len(tail)} lines of {log_path}:", flush=True)
        for line in tail:
            print(f"    | {line}", flush=True)
        holders = port_holders(port) if port is not None else []
        print(f"  sockets on port {port} (/proc/net/tcp, tcp6): "
              f"{holders or 'none'}", flush=True)
        try:
            with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
                ephemeral = "-".join(fh.read().split())
        except OSError as e:
            ephemeral = f"unreadable: {e}"
        print(f"  ephemeral ports (ip_local_port_range): {ephemeral}",
              flush=True)
        raise


def diagnosed_run(test: dict, what: str, sandbox: str, node: str, log: str):
    """`core.run(test)` inside a `server_diagnosis` of `node`'s server: its
    log in the node's sandbox directory, its port from the test's DB."""
    import os

    from jepsen_tpu_torch import core
    db = test["db"]
    port = db.port(test, node) if hasattr(db, "port") else None
    with server_diagnosis(what, port, os.path.join(sandbox, node, log)):
        return core.run(test)


def live_run(make, name: str, opts: dict, node: str, log: str, banner: str,
             tmp: str, counts) -> tuple:
    """A live suite run on the card: the test map `make(opts)` with the
    run's name, store root and sandbox under `tmp/name`, every launch
    counter set to 0 just before `core.run` and read just after (added to
    `counts`); a failed run prints its server's log tail and its port's
    holders (`diagnosed_run`). Returns (what `core.run` returned, the
    launches, the wall, the serving `banner`s in `node`'s `log`, None where
    `banner` is None, the stored run)."""
    import os

    from jepsen_tpu_torch import store
    root = os.path.join(tmp, name, "store")
    opts = {**opts, "name": f"suites-{name}", "store_root": root,
            "sandbox": os.path.join(tmp, name, "nodes")}
    test = make(opts)
    zero_counts()
    t0 = time.monotonic()
    done = diagnosed_run(test, f"the {name} run", opts["sandbox"], node, log)
    torch.cuda.synchronize()
    launched = read_counts()
    counts.update(launched)
    banners = None if banner is None else open(
        os.path.join(done["store_dir"], node, log)).read().count(banner)
    return (done, {k: v for k, v in launched.items() if v},
            time.monotonic() - t0, banners, store.load_latest(root))


def mutex_oracle(root: str) -> dict:
    """The host oracle's verdict on the latest mutex history stored under
    `root`, with the rabbitmq suite's time limit (in a worker process):
    valid?, its cause, the configs it explored and its seconds."""
    from jepsen_tpu_torch import checker, store
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import mutex
    t0 = time.monotonic()
    h = History(store.load_latest(root)["history"]).index()
    res = checker.linearizable(mutex(), algorithm="wgl", time_limit=60,
                               device="cpu").check({}, h, {})
    return {"valid?": res["valid?"], "cause": res.get("cause"),
            "configs": res.get("configs_explored"),
            "seconds": time.monotonic() - t0}


def doc_queue_runs(dev, tmp: str, background) -> dict:
    """rabbitmq's and mongodb's live runs and EDN ingest on the card:

      1. rabbitmq `semaphore` (RABBIT_SEM: a mini AMQP broker, the token a
         held delivery), the suite's mutex check on the card: True; its
         stored history re-checked by a forced "cuda-wgl" on the card,
         which must launch `wgl32_chunk` where the history encodes, and
         by the host oracle (`mutex_oracle`, in `background` while the
         steps below run), with the suite's time limit: the three
         verdicts equal. The ops, the crashed ones and the encoded window
         (or the encoder's refusal) are printed;
      2. mongodb `register` (MONGO_RUN: a mini OP_MSG server over the
         localexec remote, its kill/restart nemesis sending real `kill
         -9`s), each key decided by the suite's competition race (the
         device lane `wgl32_chunk`): True, at least one launch, at least
         two serving banners; its stored history read back and re-checked
         key by key by "cuda-wgl" on the card (at least one `wgl32_chunk`
         launch) and by the host oracle, each key's three verdicts equal;
      3. EDN ingest: the headline history written as a store.clj-shaped
         history.edn (`edn_line`), read back by `History.from_edn` into
         the same ops, and decided by "cuda-wgl" on the card as the
         native history is, verdict and `wgl32_chunk` launches equal;
         then `elle_edn(EDN_APPEND_COPIES)` read back and checked by
         `elle.append.check` with `cycle_backend="cuda"` on the card (at
         least one `elle_closure` launch) and "host": `valid?` and
         `anomaly-types` equal.

    Returns the launches of the runs and the re-checks by kernel; takes at
    most DOCS_LIMIT_S."""
    import collections
    import os

    from jepsen_tpu_torch import checker, independent, synth
    from jepsen_tpu_torch.dbs import mongodb, rabbitmq
    from jepsen_tpu_torch.elle import append
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import cas_register, mutex
    from jepsen_tpu_torch.ops import encode

    t_all = time.monotonic()
    counts: collections.Counter = collections.Counter()

    def rechecked(fn):
        zero_counts()
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        launched = read_counts()
        counts.update(launched)
        return res, launched, time.monotonic() - t0

    # 1. rabbitmq semaphore: the suite, a forced device check, and the host
    # oracle in the background
    done, launched, wall, banners, stored = live_run(
        rabbitmq.rabbitmq_test, "rabbitmq", RABBIT_SEM, "r1",
        rabbitmq.MiniRabbitDB.logfile, "minirabbit serving on", tmp, counts)
    m = done["results"]["mutex"]
    hist = History(stored["history"]).index()
    if [o.to_dict() for o in hist] != [o.to_dict() for o in done["history"]]:
        raise AssertionError("rabbitmq semaphore: the stored history "
                             "differs from the run's")
    oracle = background.submit(mutex_oracle,
                               os.path.join(tmp, "rabbitmq", "store"))
    ops = [o for o in hist if o.process != "nemesis" and o.type != "invoke"]
    crashed = collections.Counter(o.f for o in ops if o.type == "info")
    try:
        window = encode.encode(mutex(), hist.client_ops).window
    except encode.EncodingUnsupported as e:
        window = f"refused ({e})"
    print(f"  rabbitmq semaphore run ({wall:.2f} s; {RABBIT_SEM}): valid? "
          f"{done['results']['valid?']} (mutex {m['valid?']}, engine "
          f"{m.get('engine')}), {len(ops)} ops completed "
          f"({sum(o.type == 'ok' for o in ops)} ok), crashed "
          f"{dict(crashed)}, encoded window {window}, serving banners "
          f"{banners}, launches {launched}", flush=True)
    if done["results"]["valid?"] is not True or m["valid?"] is not True \
            or banners < 1:
        raise AssertionError(f"rabbitmq semaphore: {done['results']}, "
                             f"banners {banners}")
    refused = isinstance(window, str)
    res, got, took = rechecked(lambda: checker.linearizable(
        mutex(), algorithm="cuda-wgl", time_limit=60, device=dev).check(
            {}, hist, {}))
    print(f"    cuda-wgl on the stored history ({took:.3f} s): "
          f"{res['valid?']}, cause {res.get('cause')}, configs "
          f"{res.get('configs_explored')}, launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    if not refused and (res["valid?"] != m["valid?"]
                        or got["wgl32_chunk"] < 1):
        raise AssertionError(f"rabbitmq semaphore cuda-wgl: "
                             f"{res['valid?']} against the suite's "
                             f"{m['valid?']}, launches {got}")

    # 2. mongodb register: the suite, then each key two ways
    done, launched, wall, banners, stored = live_run(
        mongodb.mongodb_test, "mongodb", MONGO_RUN, "m1",
        mongodb.MiniMongoDB.logfile, "minimongo serving on", tmp, counts)
    keys = done["results"]["register"]["results"]
    engines = collections.Counter(str(r["linear"].get("engine"))
                                  for r in keys.values())
    n_ops = sum(1 for o in done["history"] if o.process != "nemesis"
                and o.type != "invoke")
    print(f"  mongodb register run ({wall:.2f} s; {MONGO_RUN}): valid? "
          f"{done['results']['valid?']}, {len(keys)} keys decided, {n_ops} "
          f"ops completed, serving banners {banners}, winning engines "
          f"{dict(engines)}, launches {launched}", flush=True)
    if (done["results"]["valid?"] is not True or not keys or banners < 2
            or launched.get("wgl32_chunk", 0) < 1):
        raise AssertionError(f"mongodb register: {done['results']['valid?']}"
                             f", {len(keys)} keys, banners {banners}, "
                             f"launches {launched}")
    hist = History([{**op, "value": kv_of(op.get("value"))}
                    for op in stored["history"]]).index()
    if [o.to_dict() for o in hist] != [o.to_dict() for o in done["history"]]:
        raise AssertionError("mongodb register: the stored history differs "
                             "from the run's")
    suite = {k: r["valid?"] for k, r in keys.items()}
    for how, where in (("cuda-wgl", dev), ("wgl", "cpu")):
        res, got, took = rechecked(lambda: independent.checker(
            checker.linearizable(cas_register(), algorithm=how,
                                 device=where)).check({}, hist, {}))
        verdicts = {k: r["valid?"] for k, r in res["results"].items()}
        print(f"    {how} on the stored history ({took:.2f} s): "
              f"{res['valid?']}; keys agreeing with the suite "
              f"{sum(verdicts.get(k) == v for k, v in suite.items())} of "
              f"{len(suite)}; launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if verdicts != suite or (how == "cuda-wgl"
                                 and got["wgl32_chunk"] < 1):
            raise AssertionError(f"mongodb register {how}: {len(verdicts)} "
                                 f"verdicts against the suite's "
                                 f"{len(suite)} differ, or launches {got}")

    # 3. EDN ingest: the headline, then a list-append history
    os.makedirs(os.path.join(tmp, "edn"), exist_ok=True)
    native = synth.cas_register_history(**HEADLINE).index()
    path = os.path.join(tmp, "edn", "history.edn")
    t0 = time.monotonic()
    with open(path, "w") as fh:
        for op in native:
            d = op.to_dict()
            fh.write(edn_line({k: d[k] for k in ("index", "time", "type",
                                                 "process", "f", "value")})
                     + "\n")
    write_s = time.monotonic() - t0
    t0 = time.monotonic()
    replay = History.from_edn(path).index()
    load_s = time.monotonic() - t0
    if [o.to_dict() for o in replay] != [o.to_dict() for o in native]:
        raise AssertionError("EDN: the headline read back differs")
    lin = checker.linearizable(cas_register(), algorithm="cuda-wgl",
                               device=dev)
    verdicts = {}
    for name, h in (("native", native), ("edn", replay)):
        res, got, took = rechecked(lambda: lin.check({}, h, {}))
        verdicts[name] = (res["valid?"], got["wgl32_chunk"])
        print(f"  EDN headline, {name} ({took:.3f} s): {res['valid?']}, "
              f"{got['wgl32_chunk']} wgl32_chunk launches", flush=True)
    print(f"    written in {write_s:.3f} s ({os.path.getsize(path)} B, "
          f"{len(native)} ops), read by History.from_edn in {load_s:.3f} s",
          flush=True)
    if verdicts["edn"] != verdicts["native"] or verdicts["edn"][1] < 1:
        raise AssertionError(f"EDN headline: {verdicts}")
    path = os.path.join(tmp, "edn", "append.edn")
    with open(path, "w") as fh:
        fh.write(elle_edn(EDN_APPEND_COPIES))
    h = History.from_edn(path).index()
    out = {}
    for backend, where in (("cuda", dev), ("host", None)):
        res, got, took = rechecked(lambda: append.check(
            h, additional_graphs=RT, cycle_backend=backend, device=where))
        out[backend] = res
        print(f"  EDN list-append, {backend} ({took:.3f} s; {len(h)} ops): "
              f"valid? {res['valid?']}, anomalies {res['anomaly-types']}, "
              f"engine {res.get('cycle-engine')}, launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if backend == "cuda" and got["elle_closure"] < 1:
            raise AssertionError(f"EDN list-append: launches {got}")
    same_verdict("EDN list-append cuda vs host", out["cuda"], out["host"])
    if out["host"]["valid?"] is not False:
        raise AssertionError(f"EDN list-append: {out['host']['valid?']}")

    # the semaphore's host oracle, begun after step 1
    t0 = time.monotonic()
    want = oracle.result(timeout=DOCS_LIMIT_S)
    print(f"  rabbitmq semaphore, host oracle on the stored history "
          f"({want['seconds']:.2f} s in the background, "
          f"{time.monotonic() - t0:.2f} s waited for): {want['valid?']}, "
          f"cause {want['cause']}, configs {want['configs']}", flush=True)
    if want["valid?"] != m["valid?"]:
        raise AssertionError(f"rabbitmq semaphore host oracle: "
                             f"{want['valid?']} against the suite's "
                             f"{m['valid?']}")

    took = time.monotonic() - t_all
    print(f"  rabbitmq, mongodb and EDN: {took:.1f} s", flush=True)
    if took > DOCS_LIMIT_S:
        raise AssertionError(f"rabbitmq, mongodb and EDN took {took:.1f} s "
                             f"(limit {DOCS_LIMIT_S} s)")
    return counts


def register_oracle(root: str, model: tuple = ("cas_register",),
                    keyed: bool = True) -> dict:
    """The host oracle's verdict on each key of the latest register history
    stored under `root` (in a worker process): {key: valid?} and its
    seconds. `model` names the model by its constructor in
    `jepsen_tpu_torch.models` and that constructor's arguments (a worker
    process gets names, not model objects); without `keyed` the history
    is one register, its verdict under the key None."""
    from jepsen_tpu_torch import checker, independent, models, store
    from jepsen_tpu_torch.history import History
    t0 = time.monotonic()
    hist = History([{**op, "value": kv_of(op.get("value"))}
                    for op in store.load_latest(root)["history"]]).index()
    lin = checker.linearizable(getattr(models, model[0])(*model[1:]),
                               algorithm="wgl", device="cpu")
    res = (independent.checker(lin) if keyed else lin).check({}, hist, {})
    return {"verdicts": verdicts_by_key(res, keyed),
            "seconds": time.monotonic() - t0}


def verdicts_by_key(res: dict, keyed: bool) -> dict:
    """{key: valid?} of an `independent` check's result, or of one
    register's check under the key None."""
    if keyed:
        return {k: r["valid?"] for k, r in res["results"].items()}
    return {None: res["valid?"]}


def graph_txns(res: dict):
    """The transactions in an Elle check's graph, from its route's reason
    (`n N, ...`), or None where the reason names none."""
    import re
    m = re.search(r"\bn (\d+)", str(res.get("cycle-route-reason")))
    return int(m.group(1)) if m else None


def register_rechecks(what: str, done: dict, stored: dict, root: str, dev,
                      background, counts, model: tuple = ("cas_register",),
                      check="register", keyed: bool = True,
                      kernels: tuple = ("wgl32_chunk",),
                      race: bool = False) -> tuple:
    """A live register run's stored history (`stored`, the latest run under
    the store `root`), read back equal to the run's, re-checked key by key
    with `model` (`register_oracle`'s names): the host oracle
    (`register_oracle`) begun in `background`, and a forced "cuda-wgl" on
    the card, which must launch one of `kernels` and agree with the suite's
    race (`done`'s results under `check`, a key or a tuple of keys into
    nested results) on every key; without `keyed` the history is one
    register, checked whole, its verdict under the key None. With `race`,
    the default checker (`competition`, three lanes on the card: device,
    oracle, device@cpu) re-checks it too, each key equal to the suite's,
    and its winning engines and host lane chunks are printed. Its
    launches are added to `counts`. Returns (the suite's verdicts by key,
    the oracle's future, for `await_oracle`)."""
    from jepsen_tpu_torch import checker, independent, models
    from jepsen_tpu_torch.history import History

    hist = History([{**op, "value": kv_of(op.get("value"))}
                    for op in stored["history"]]).index()
    if [o.to_dict() for o in hist] != [o.to_dict() for o in done["history"]]:
        raise AssertionError(f"{what}: the stored history differs from the "
                             "run's")
    oracle = background.submit(register_oracle, root, model, keyed)
    lin = checker.linearizable(getattr(models, model[0])(*model[1:]),
                               algorithm="cuda-wgl", device=dev)
    want = done["results"]
    for k in (check if isinstance(check, tuple) else (check,)):
        want = want[k]
    suite = verdicts_by_key(want, keyed)
    zero_counts()
    t0 = time.monotonic()
    res = (independent.checker(lin) if keyed else lin).check({}, hist, {})
    torch.cuda.synchronize()
    got = read_counts()
    counts.update(got)
    verdicts = verdicts_by_key(res, keyed)
    print(f"    cuda-wgl on the stored history ({time.monotonic() - t0:.2f} "
          f"s): {res['valid?']}; keys agreeing with the suite "
          f"{sum(verdicts.get(k) == v for k, v in suite.items())} of "
          f"{len(suite)}; launches {({k: v for k, v in got.items() if v})}",
          flush=True)
    if verdicts != suite or sum(got[k] for k in kernels) < 1:
        raise AssertionError(f"{what} cuda-wgl: {len(verdicts)} verdicts "
                             f"against the suite's {len(suite)} differ, or "
                             f"launches {got}")
    if race:
        import collections
        raced = checker.linearizable(getattr(models, model[0])(*model[1:]),
                                     device=dev)
        h0 = host_counts()
        zero_counts()
        t0 = time.monotonic()
        res = (independent.checker(raced) if keyed else raced).check(
            {}, hist, {})
        torch.cuda.synchronize()
        got = read_counts()
        counts.update(got)
        host = {k: v - h0[k] for k, v in host_counts().items()}
        per_key = res["results"].values() if keyed else [res]
        engines = collections.Counter(str(r.get("engine"))
                                      for r in per_key)
        verdicts = verdicts_by_key(res, keyed)
        print(f"    competition (three lanes) on the stored history "
              f"({time.monotonic() - t0:.2f} s): {res['valid?']}; keys "
              f"agreeing with the suite "
              f"{sum(verdicts.get(k) == v for k, v in suite.items())} of "
              f"{len(suite)}; winning engines {dict(engines)}; host lane "
              f"chunks {host}; launches "
              f"{({k: v for k, v in got.items() if v})}", flush=True)
        if verdicts != suite:
            raise AssertionError(f"{what} competition: {len(verdicts)} "
                                 f"verdicts against the suite's "
                                 f"{len(suite)} differ")
    return suite, oracle


def await_oracle(what: str, oracle, suite: dict, limit_s: float) -> None:
    """The host oracle's verdicts (`register_rechecks`' future), each equal
    to the suite's."""
    t0 = time.monotonic()
    want = oracle.result(timeout=limit_s)
    print(f"  {what}, host oracle on the stored history "
          f"({want['seconds']:.2f} s in the background, "
          f"{time.monotonic() - t0:.2f} s waited for): keys agreeing with "
          f"the suite {sum(want['verdicts'].get(k) == v for k, v in suite.items())}"
          f" of {len(suite)}", flush=True)
    if want["verdicts"] != suite:
        raise AssertionError(f"{what} host oracle: {len(want['verdicts'])} "
                             f"verdicts against the suite's {len(suite)} "
                             "differ")


def append_run(what: str, mod, make, name: str, opts: dict, stagger_s: float,
               db, tmp: str, counts, dev) -> int:
    """A live `append` run of the suite module `mod` (its test map from
    `make(opts)`, its workload paced `stagger_s` apart), under its
    kill/restart nemesis, the suite's check on the card: True with no
    anomaly, at least two serving banners of `db`'s server, its graph
    between the route's `min_n` (384) and the dense closure's capacity
    (8192), at least one `elle_closure` launch; its stored history
    re-checked by `elle_rechecks`. The transactions completed and in the
    graph, the route's reason and the launches are printed. Returns the
    closures' largest error."""
    from jepsen_tpu_torch.elle import append
    from jepsen_tpu_torch.history import History

    def paced_append(o):
        test = make(o)
        test["generator"] = paced(o, mod.WORKLOADS["append"](o)["generator"],
                                  stagger_s)
        return test

    node = opts["nodes"][0]
    done, launched, wall, banners, stored = live_run(
        paced_append, name, opts, node, db.logfile,
        db.script.split(".")[0] + " serving on", tmp, counts)
    res = done["results"]["append"]
    hist = done["history"]
    stored = History(stored["history"]).index()
    if [o.to_dict() for o in stored] != [o.to_dict() for o in hist]:
        raise AssertionError(f"{what}: the stored history differs from the "
                             "run's")
    txns = sum(1 for o in hist if o.f == "txn" and o.type != "invoke")
    oks = sum(1 for o in hist if o.f == "txn" and o.type == "ok")
    in_graph = graph_txns(res)
    print(f"  {what} run ({wall:.2f} s; {opts}, paced {stagger_s} s, ports "
          f"from {mod.MINI_BASE_PORT}): valid? {done['results']['valid?']} "
          f"(append {res['valid?']}, anomalies {res['anomaly-types']}), "
          f"{txns} txns completed ({oks} ok), {in_graph} in the graph, "
          f"serving banners {banners}, engine {res.get('cycle-engine')}, "
          f"route {res.get('cycle-route-reason')!r}, launches {launched}",
          flush=True)
    if (done["results"]["valid?"] is not True or res["valid?"] is not True
            or res["anomaly-types"] or banners < 2
            or not 384 <= (in_graph or 0) <= 8192
            or launched.get("elle_closure", 0) < 1):
        raise AssertionError(f"{what}: {done['results']}, banners {banners}, "
                             f"{in_graph} txns in the graph, launches "
                             f"{launched}")
    rechecked, worst = elle_rechecks(
        what, append.check, stored, done["checker"].checker_map["append"],
        res, dev)
    counts.update(rechecked)
    return worst


def mysql_runs(dev, tmp: str, background) -> tuple:
    """The MySQL-wire family's live runs on the card, each on its suite's
    own ports over the localexec remote, its kill/restart nemesis sending
    real `kill -9`s to galera's embedded server:

      1. mysql_cluster `register` (NDB_RUN), each key decided by the
         suite's competition race (the device lane `wgl32_chunk`): True,
         at least one launch, at least two serving banners; its stored
         history re-checked key by key by a forced "cuda-wgl" on the card
         and by the host oracle, in `background` while step 2 runs
         (`register_rechecks`), each key's three verdicts equal;
      2. tidb `append` (TIDB_APPEND, paced by TIDB_STAGGER_S; `append_run`):
         the suite's check on the card True with no anomaly, its graph
         between `min_n` and the dense closure's capacity, its stored
         history re-checked by `elle_rechecks`, all equal.

    Returns (the launches of the runs and the re-checks by kernel, the
    closures' largest error); takes at most MYSQL_LIMIT_S."""
    import collections
    import os

    from jepsen_tpu_torch.dbs import mysql_cluster, tidb

    t_all = time.monotonic()
    counts: collections.Counter = collections.Counter()

    # 1. mysql_cluster register: the suite, "cuda-wgl", the host oracle in
    # the background
    done, launched, wall, banners, stored = live_run(
        mysql_cluster.ndb_test, "ndb", NDB_RUN, "m1",
        mysql_cluster.MiniNdbDB.logfile, "minimysql serving on", tmp, counts)
    keys = done["results"]["register"]["results"]
    engines = collections.Counter(str(r["linear"].get("engine"))
                                  for r in keys.values())
    n_ops = sum(1 for o in done["history"] if o.process != "nemesis"
                and o.type != "invoke")
    print(f"  mysql_cluster register run ({wall:.2f} s; {NDB_RUN}, ports "
          f"from {mysql_cluster.MINI_BASE_PORT}): valid? "
          f"{done['results']['valid?']}, {len(keys)} keys decided, {n_ops} "
          f"ops completed, serving banners {banners}, winning engines "
          f"{dict(engines)}, launches {launched}", flush=True)
    if (done["results"]["valid?"] is not True or not keys or banners < 2
            or launched.get("wgl32_chunk", 0) < 1):
        raise AssertionError(f"mysql_cluster register: "
                             f"{done['results']['valid?']}, {len(keys)} "
                             f"keys, banners {banners}, launches {launched}")
    suite, oracle = register_rechecks(
        "mysql_cluster register", done, stored,
        os.path.join(tmp, "ndb", "store"), dev, background, counts,
        race=True)

    # 2. tidb append: the suite, then its stored history three ways
    worst = append_run("tidb append", tidb, tidb.tidb_test, "tidb",
                       TIDB_APPEND, TIDB_STAGGER_S, tidb.MiniTidbDB, tmp,
                       counts, dev)

    await_oracle("mysql_cluster register", oracle, suite, MYSQL_LIMIT_S)
    took = time.monotonic() - t_all
    print(f"  mysql_cluster and tidb: {took:.1f} s", flush=True)
    if took > MYSQL_LIMIT_S:
        raise AssertionError(f"mysql_cluster and tidb took {took:.1f} s "
                             f"(limit {MYSQL_LIMIT_S} s)")
    return counts, worst


def pg_runs(dev, tmp: str, background) -> tuple:
    """The pgwire family's live runs on the card, each on its suite's own
    ports over the localexec remote:

      1. postgres `register` (PG_REGISTER) against one minipg node started
         through `stolon.MiniStolonDB` on stolon's ports, the client
         pointed at it (`client.addr_fn`) and its tables made by the
         suite's `ExternalDB`; each key decided by the suite's competition
         race (the device lane `wgl32_chunk`): True, at least one launch;
         its stored history re-checked key by key by a forced "cuda-wgl"
         on the card and by the host oracle, in `background` while step 2
         runs (`register_rechecks`), each key's three verdicts equal;
      2. stolon `append` (STOLON_APPEND, paced by STOLON_STAGGER_S;
         `append_run`) under the suite's kill/restart nemesis, real `kill
         -9`s: the suite's check on the card True with no anomaly, its
         graph between `min_n` and the dense closure's capacity, its
         stored history re-checked by `elle_rechecks`, all equal.

    A server that never opens its port prints its log's tail and the
    port's holders before the step fails (`server_diagnosis`). Returns (the
    launches of the runs and the re-checks by kernel, the closures' largest
    error); takes at most PG_LIMIT_S."""
    import collections
    import os

    from jepsen_tpu_torch import control
    from jepsen_tpu_torch.control import localexec
    from jepsen_tpu_torch.dbs import postgres, stolon

    t_all = time.monotonic()
    counts: collections.Counter = collections.Counter()
    node = PG_REGISTER["nodes"][0]

    # 1. postgres register against a minipg node: the suite, "cuda-wgl", the
    # host oracle in the background
    node_test = {"nodes": PG_REGISTER["nodes"]}
    server = stolon.MiniStolonDB()
    # the run's own sandbox (`live_run`'s), so that a failed run's
    # diagnosis reads this server's log
    sandbox = os.path.join(tmp, "pg", "nodes")
    port = stolon.mini_node_port(node_test, node)

    def on_node(fn):
        with control.with_remote(localexec.remote(sandbox)):
            with control.with_ssh({}):
                with control.on(node):
                    fn(node_test, node)

    t0 = time.monotonic()
    with server_diagnosis("the minipg node's start", port,
                         os.path.join(sandbox, node, server.logfile)):
        on_node(server.setup)
    start_s = time.monotonic() - t0

    def pointed(opts):
        test = postgres.postgres_test(opts)
        test["client"].addr_fn = lambda test, node: ("127.0.0.1", port)
        return test

    try:
        done, launched, wall, _, stored = live_run(
            pointed, "pg", PG_REGISTER, node, server.logfile, None, tmp,
            counts)
    finally:
        on_node(server.teardown)
    keys = done["results"]["register"]["results"]
    engines = collections.Counter(str(r["linear"].get("engine"))
                                  for r in keys.values())
    n_ops = sum(1 for o in done["history"] if o.type != "invoke")
    print(f"  postgres register run ({wall:.2f} s; {PG_REGISTER}, a minipg "
          f"node on stolon's port {port}, up in {start_s:.2f} s): valid? "
          f"{done['results']['valid?']}, {len(keys)} keys decided, {n_ops} "
          f"ops completed, winning engines {dict(engines)}, launches "
          f"{launched}", flush=True)
    if (done["results"]["valid?"] is not True or not keys
            or launched.get("wgl32_chunk", 0) < 1):
        raise AssertionError(f"postgres register: "
                             f"{done['results']['valid?']}, {len(keys)} "
                             f"keys, launches {launched}")
    suite, oracle = register_rechecks(
        "postgres register", done, stored, os.path.join(tmp, "pg", "store"),
        dev, background, counts)

    # 2. stolon append: the suite, then its stored history three ways
    worst = append_run("stolon append", stolon, stolon.stolon_test, "stolon",
                       STOLON_APPEND, STOLON_STAGGER_S, stolon.MiniStolonDB,
                       tmp, counts, dev)

    await_oracle("postgres register", oracle, suite, PG_LIMIT_S)
    took = time.monotonic() - t_all
    print(f"  postgres and stolon: {took:.1f} s", flush=True)
    if took > PG_LIMIT_S:
        raise AssertionError(f"postgres and stolon took {took:.1f} s "
                             f"(limit {PG_LIMIT_S} s)")
    return counts, worst


def encoded_shape(model, hist) -> str:
    """The encoded table (states x ops) and window of a register history's
    client ops under `model`, or why the encoder refused it."""
    from jepsen_tpu_torch.ops import encode
    try:
        enc = encode.encode(model, hist.client_ops)
    except encode.EncodingUnsupported as e:
        return f"refused ({e})"
    return (f"table {enc.table.shape[0]} states x {enc.table.shape[1]} ops, "
            f"window {enc.window} (raw {enc.window_raw})")


def yuga_raftis_runs(dev, tmp: str, background) -> dict:
    """yuga's and raftis's live runs on the card, each on a mini-redis
    server from its suite's own ports over the localexec remote, its
    kill/restart nemesis sending real `kill -9`s:

      1. yuga `ycql/multi-key-acid` (YUGA_MKA), each group's key decided by
         the suite's competition race on the multi-register model (the
         device lane `wgl32_chunk`): True, at least two serving banners;
         its stored history re-checked key by key by a forced "cuda-wgl"
         on the card, which must launch `wgl32_chunk`, and by the host
         oracle, in `background` while step 2 runs (`register_rechecks`
         with `multi_register`), each key's three verdicts equal. The
         largest key's encoded table and window are printed;
      2. raftis's register (RAFTIS_RUN), one register decided by the
         suite's competition race: True, at least two serving banners; its
         stored history re-checked whole by a forced "cuda-wgl" with
         `cas_register(None)`, which must launch `wgl32_chunk` or (a window
         past 32) `wgln_chunk`, and by the host oracle, all equal.

    A server that never opens its port prints its log's tail and the
    port's holders before the step fails (`live_run`). Returns the launches
    of the runs and the re-checks by kernel; takes at most YUGA_LIMIT_S."""
    import collections
    import os

    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.dbs import raftis, yuga
    from jepsen_tpu_torch.models import cas_register, multi_register

    t_all = time.monotonic()
    counts: collections.Counter = collections.Counter()

    # 1. yuga multi-key-acid: the suite, "cuda-wgl", the host oracle in the
    # background
    done, launched, wall, banners, stored = live_run(
        yuga.yuga_test, "yuga", YUGA_MKA, "y1", yuga.MiniYcqlDB.logfile,
        "miniredis serving on", tmp, counts)
    check = "ycql-multi-key-acid"
    keys = done["results"][check]["results"]
    engines = collections.Counter(str(r.get("engine")) for r in keys.values())
    hist = done["history"]
    n_ops = sum(1 for o in hist if o.process != "nemesis"
                and o.type != "invoke")
    ks = independent.history_keys(hist)
    subs = dict(zip(ks, independent.subhistories(hist, ks)))
    big = max(ks, key=lambda k: len(subs[k]), default=None)
    big_ops = sum(o.type != "invoke" for o in subs[big].client_ops) \
        if ks else 0
    shape = encoded_shape(multi_register(), subs[big]) if ks else None
    print(f"  yuga ycql/multi-key-acid run ({wall:.2f} s; {YUGA_MKA}, ports "
          f"from {yuga.YCQL_BASE_PORT}): valid? {done['results']['valid?']},"
          f" {len(keys)} keys decided, {n_ops} ops completed, serving "
          f"banners {banners}, winning engines {dict(engines)}, launches "
          f"{launched}; the largest key {big} ({big_ops} ops completed): "
          f"{shape}", flush=True)
    if done["results"]["valid?"] is not True or not keys or banners < 2:
        raise AssertionError(f"yuga multi-key-acid: "
                             f"{done['results']['valid?']}, {len(keys)} "
                             f"keys, banners {banners}, launches {launched}")
    suite, oracle = register_rechecks(
        "yuga multi-key-acid", done, stored,
        os.path.join(tmp, "yuga", "store"), dev, background, counts,
        model=("multi_register",), check=check)

    # 2. raftis register: the suite, then its stored history whole
    done, launched, wall, banners, stored = live_run(
        raftis.raftis_test, "raftis", RAFTIS_RUN, "r1",
        raftis.MiniRaftisDB.logfile, "miniredis serving on", tmp, counts)
    lin = done["results"]["linear"]
    ops = [o for o in done["history"] if o.process != "nemesis"
           and o.type != "invoke"]
    print(f"  raftis register run ({wall:.2f} s; {RAFTIS_RUN}, ports from "
          f"{raftis.MINI_BASE_PORT}): valid? {done['results']['valid?']} "
          f"(linear {lin['valid?']}, engine {lin.get('engine')}), "
          f"{len(ops)} ops completed, {sum(o.type == 'info' for o in ops)} "
          f"crashed, {encoded_shape(cas_register(None), done['history'])}, "
          f"serving banners {banners}, launches {launched}", flush=True)
    if (done["results"]["valid?"] is not True or lin["valid?"] is not True
            or banners < 2):
        raise AssertionError(f"raftis register: {done['results']}, "
                             f"banners {banners}")
    rsuite, roracle = register_rechecks(
        "raftis register", done, stored,
        os.path.join(tmp, "raftis", "store"), dev, background, counts,
        model=("cas_register", None), check="linear", keyed=False,
        kernels=("wgl32_chunk", "wgln_chunk"))

    await_oracle("yuga multi-key-acid", oracle, suite, YUGA_LIMIT_S)
    await_oracle("raftis register", roracle, rsuite, YUGA_LIMIT_S)
    took = time.monotonic() - t_all
    print(f"  yuga and raftis: {took:.1f} s", flush=True)
    if took > YUGA_LIMIT_S:
        raise AssertionError(f"yuga and raftis took {took:.1f} s (limit "
                             f"{YUGA_LIMIT_S} s)")
    return counts


def grid_runs(dev, tmp: str, background) -> dict:
    """Two binary-wire suites' live runs on the card, each on its own mini
    server from its suite's own ports over the localexec remote:

      1. aerospike `cas-register` (AERO_RUN: generation-CAS records, the
         kill/restart nemesis sending real `kill -9`s), each key decided by
         the suite's competition race (the device lane `wgl32_chunk`, or
         `wgln_chunk` where crashed writes open a key's window past 32):
         True, at least two serving banners; its stored history re-checked
         key by key by a forced "cuda-wgl" on the card, which must launch
         one of the chunk kernels, and by the host oracle, in `background`
         while step 2 runs, each key's three verdicts equal. The keys, the
         ops, the crashed ops, the winning engines and the largest key's
         encoded table and window are printed;
      2. hazelcast's fenced `lock` (HZ_LOCK, fault-free), its mutex decided
         by the suite's competition race and its fences checked for
         monotonicity: both True, one serving banner; its stored history
         re-checked whole with the mutex model (each ok acquire's fence its
         value) by a forced "cuda-wgl", which must launch `wgl32_chunk`,
         and by the host oracle, all equal to the suite's mutex verdict.
         The ops by (f, type), the fences, the encoded table and window and
         the winning engine are printed.

    A server that never opens its port prints its log's tail and the
    port's holders before the step fails (`live_run`). Returns the launches
    of the runs and the re-checks by kernel; takes at most GRID_LIMIT_S."""
    import collections
    import os

    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.dbs import aerospike, hazelcast
    from jepsen_tpu_torch.models import cas_register, mutex

    t_all = time.monotonic()
    counts: collections.Counter = collections.Counter()

    # 1. aerospike cas-register: the suite, "cuda-wgl", the host oracle in
    # the background
    done, launched, wall, banners, stored = live_run(
        aerospike.aerospike_test, "aerospike", AERO_RUN, "a1",
        aerospike.MiniAeroDB.logfile, "miniaero serving on", tmp, counts)
    keys = done["results"]["cas-register"]["results"]
    engines = collections.Counter(str(r.get("linear", {}).get("engine"))
                                  for r in keys.values())
    hist = done["history"]
    ops = [o for o in hist if o.process != "nemesis" and o.type != "invoke"]
    ks = independent.history_keys(hist)
    subs = dict(zip(ks, independent.subhistories(hist, ks)))
    big = max(ks, key=lambda k: len(subs[k]), default=None)
    shape = encoded_shape(cas_register(), subs[big]) if ks else None
    print(f"  aerospike cas-register run ({wall:.2f} s; {AERO_RUN}, ports "
          f"from {aerospike.MINI_BASE_PORT}): valid? "
          f"{done['results']['valid?']}, {len(keys)} keys decided, "
          f"{len(ops)} ops completed, {sum(o.type == 'info' for o in ops)} "
          f"crashed, serving banners {banners}, winning engines "
          f"{dict(engines)}, launches {launched}; the largest key {big}: "
          f"{shape}", flush=True)
    if (done["results"]["valid?"] is not True or not keys or banners < 2
            or engines.get("None")):
        raise AssertionError(f"aerospike cas-register: "
                             f"{done['results']['valid?']}, {len(keys)} "
                             f"keys, engines {dict(engines)}, banners "
                             f"{banners}, launches {launched}")
    suite, oracle = register_rechecks(
        "aerospike cas-register", done, stored,
        os.path.join(tmp, "aerospike", "store"), dev, background, counts,
        check="cas-register", kernels=("wgl32_chunk", "wgln_chunk"))

    # 2. hazelcast lock: the suite, then its stored history whole
    done, launched, wall, banners, stored = live_run(
        hazelcast.hazelcast_test, "hazelcast", HZ_LOCK, "h1",
        hazelcast.MiniHzDB.logfile, "minihz serving on", tmp, counts)
    lock = done["results"]["lock"]
    by_f = collections.Counter((o.f, o.type) for o in done["history"]
                               if o.process != "nemesis"
                               and o.type != "invoke")
    print(f"  hazelcast lock run ({wall:.2f} s; {HZ_LOCK}, ports from "
          f"{hazelcast.MINI_BASE_PORT}): valid? {done['results']['valid?']} "
          f"(mutex {lock['mutex']['valid?']}, engine "
          f"{lock['mutex'].get('engine')}; fences {lock['fences']['valid?']}, "
          f"{lock['fences']['acquisition-count']} counted), ops "
          f"{dict(sorted(by_f.items()))}, "
          f"{encoded_shape(mutex(), done['history'])}, serving banners "
          f"{banners}, launches {launched}", flush=True)
    if (done["results"]["valid?"] is not True
            or lock["mutex"]["valid?"] is not True
            or lock["fences"]["valid?"] is not True
            or lock["fences"]["acquisition-count"] < 1 or banners < 1):
        raise AssertionError(f"hazelcast lock: {done['results']}, banners "
                             f"{banners}")
    hsuite, horacle = register_rechecks(
        "hazelcast lock", done, stored,
        os.path.join(tmp, "hazelcast", "store"), dev, background, counts,
        model=("mutex",), check=("lock", "mutex"), keyed=False)

    await_oracle("aerospike cas-register", oracle, suite, GRID_LIMIT_S)
    await_oracle("hazelcast lock", horacle, hsuite, GRID_LIMIT_S)
    took = time.monotonic() - t_all
    print(f"  aerospike and hazelcast: {took:.1f} s", flush=True)
    if took > GRID_LIMIT_S:
        raise AssertionError(f"aerospike and hazelcast took {took:.1f} s "
                             f"(limit {GRID_LIMIT_S} s)")
    return counts


def http_runs(dev, tmp: str, background) -> tuple:
    """dgraph's two live runs on the card, on its mini alpha from its
    suite's own ports over the localexec remote, through the port's stdlib
    HTTP client, the kill/restart nemesis sending real `kill -9`s:

      1. `register` (DGRAPH_RUN), each key decided by the suite's
         competition race (the device lane `wgl32_chunk`, or `wgln_chunk`
         where crashed writes open a key's window past 32): True, at least
         two serving banners; its stored history re-checked key by key by
         a forced "cuda-wgl" on the card, which must launch one of the
         chunk kernels, and by the host oracle, in `background` while step
         2 runs, each key's three verdicts equal. The keys, the ops, the
         crashed ops and the winning engines are printed;
      2. `wr` (DGRAPH_WR), its Elle check on the card: True with no
         anomaly, at least two serving banners; its stored history
         re-checked by `elle_rechecks` (the routed "auto", a forced
         `cycle_backend="device"` that must launch `elle_closure`, each
         dense closure held against `closure_ref`, and the "host" oracle,
         all equal to the suite on `valid?` and `anomaly-types`). The
         transactions completed and in the graph and the route's reason
         are printed; the graph need not reach the route's `min_n`.

    A server that never opens its port prints its log's tail and the
    port's holders before the step fails (`live_run`). Returns (the
    launches of the runs and the re-checks by kernel, the closures'
    largest error); takes at most HTTP_LIMIT_S."""
    import collections
    import os

    from jepsen_tpu_torch.dbs import dgraph
    from jepsen_tpu_torch.elle import wr
    from jepsen_tpu_torch.history import History

    t_all = time.monotonic()
    counts: collections.Counter = collections.Counter()
    banner = "minidgraph serving on"

    # 1. register: the suite, "cuda-wgl", the host oracle in the background
    done, launched, wall, banners, stored = live_run(
        dgraph.dgraph_test, "dgraph", DGRAPH_RUN, "d1",
        dgraph.MiniDgraphDB.logfile, banner, tmp, counts)
    keys = done["results"]["register"]["results"]
    engines = collections.Counter(str(r.get("linear", {}).get("engine"))
                                  for r in keys.values())
    ops = [o for o in done["history"]
           if o.process != "nemesis" and o.type != "invoke"]
    print(f"  dgraph register run ({wall:.2f} s; {DGRAPH_RUN}, ports from "
          f"{dgraph.MINI_BASE_PORT}): valid? {done['results']['valid?']}, "
          f"{len(keys)} keys decided, {len(ops)} ops completed, "
          f"{sum(o.type == 'info' for o in ops)} crashed, serving banners "
          f"{banners}, winning engines {dict(engines)}, launches "
          f"{launched}", flush=True)
    if (done["results"]["valid?"] is not True or not keys or banners < 2
            or engines.get("None")):
        raise AssertionError(f"dgraph register: {done['results']['valid?']}"
                             f", {len(keys)} keys, engines {dict(engines)}, "
                             f"banners {banners}, launches {launched}")
    suite, oracle = register_rechecks(
        "dgraph register", done, stored,
        os.path.join(tmp, "dgraph", "store"), dev, background, counts,
        check="register", kernels=("wgl32_chunk", "wgln_chunk"))

    # 2. wr: the suite, then its stored history three ways
    done, launched, wall, banners, stored = live_run(
        dgraph.dgraph_test, "dgraph-wr", DGRAPH_WR, "d1",
        dgraph.MiniDgraphDB.logfile, banner, tmp, counts)
    res = done["results"]["wr"]
    hist = done["history"]
    stored = History(stored["history"]).index()
    if [o.to_dict() for o in stored] != [o.to_dict() for o in hist]:
        raise AssertionError("dgraph wr: the stored history differs from "
                             "the run's")
    txns = sum(1 for o in hist if o.f == "txn" and o.type != "invoke")
    oks = sum(1 for o in hist if o.f == "txn" and o.type == "ok")
    print(f"  dgraph wr run ({wall:.2f} s; {DGRAPH_WR}, ports from "
          f"{dgraph.MINI_BASE_PORT}): valid? "
          f"{done['results']['valid?']} (wr {res['valid?']}, anomalies "
          f"{res['anomaly-types']}), {txns} txns completed ({oks} ok), "
          f"{graph_txns(res)} in the graph, serving banners {banners}, "
          f"engine {res.get('cycle-engine')}, route "
          f"{res.get('cycle-route-reason')!r}, launches {launched}",
          flush=True)
    if (done["results"]["valid?"] is not True or res["valid?"] is not True
            or res["anomaly-types"] or banners < 2 or oks < 1):
        raise AssertionError(f"dgraph wr: {done['results']}, banners "
                             f"{banners}")
    rechecked, worst = elle_rechecks(
        "dgraph wr", wr.check, stored, done["checker"].checker_map["wr"],
        res, dev)
    counts.update(rechecked)

    await_oracle("dgraph register", oracle, suite, HTTP_LIMIT_S)
    took = time.monotonic() - t_all
    print(f"  dgraph: {took:.1f} s", flush=True)
    if took > HTTP_LIMIT_S:
        raise AssertionError(f"dgraph took {took:.1f} s (limit "
                             f"{HTTP_LIMIT_S} s)")
    return counts, worst


def suites_phases(dev, background) -> dict:
    """The live suites, sqlite, etcd, mongodb, rabbitmq, mysql_cluster, tidb,
    postgres, stolon, yuga, raftis, aerospike, hazelcast and dgraph, the
    faultlib nemesis and EDN ingest, on the card's machine, each step's wall
    printed:

      1. sqlite `append`, then `wr` (`linearizable_keys`), each a live run
         in this process: a minisql primary (stdlib sqlite3 behind RESP,
         WAL + synchronous=FULL) over the localexec remote, SUITE_RUN with
         the workload paced by SUITE_STAGGER_S, the kill/restart nemesis
         sending real `kill -9`s, the suite's checker on the card (the
         default device): True with no anomaly. Then its stored history,
         read back from the store, re-checked with the suite's options
         three ways: the routed "auto" on the card, a forced
         `cycle_backend="device"` on the card, which must launch
         `elle_closure` (each dense closure held against `closure_ref` on
         the same inputs, error 0), and the "host" oracle; the three
         `valid?` and `anomaly-types` and the suite's must be equal. The
         transaction count, the route's reason and the launches are
         printed;
      2. sqlite `bank` (SUITE_BANK): True, and no `bank.png` written;
      3. `FaultLibNemesis` against one toykv node (the shape of the
         reference's `test_faultlib_nemesis_against_toykv`): faultlib
         built on the node with g++ (`make`), the server under its
         LD_PRELOAD, EIO switched on for the recovery log between two
         batches of adds and off again: at least one add crashed, the
         server logged the I/O error, and the `set` checker's verdict is
         printed (True: nothing acknowledged was lost);
      4. etcd `register` and `append` (`etcd_runs`): the register run's
         keys each decided by the competition race (`wgl32_chunk`) and
         each equal to the host oracle's verdict; the append run re-checked
         three ways as in step 1;
      5. rabbitmq `semaphore`, mongodb `register` and EDN ingest
         (`doc_queue_runs`, the host oracles in `background`): the
         semaphore's mutex history decided by the suite, a forced
         "cuda-wgl" (`wgl32_chunk`) and the host oracle, all equal; each
         mongodb key decided by the race and re-checked by "cuda-wgl" and
         the host oracle, all equal; the headline read from a history.edn
         decided as the native history, launch for launch; a list-append
         history.edn checked by Elle on the card (`elle_closure`) and on
         the host, equal;
      6. mysql_cluster `register` and tidb `append` (`mysql_runs`, the
         register's host oracle in `background`): each mysql_cluster key
         decided by the race and re-checked by "cuda-wgl" and the host
         oracle, all equal; the tidb append run re-checked three ways as
         in step 1;
      7. postgres `register` against a minipg node and stolon `append`
         (`pg_runs`, the register's host oracle in `background`): each
         postgres key decided by the race and re-checked by "cuda-wgl" and
         the host oracle, all equal; the stolon append run under its
         kill/restart nemesis re-checked three ways as in step 1;
      8. yuga `ycql/multi-key-acid` and raftis's register
         (`yuga_raftis_runs`, the host oracles in `background`): each
         multi-key group decided by the race on the multi-register model
         and re-checked by "cuda-wgl" and the host oracle, all equal; the
         raftis register decided by the race and re-checked whole by
         "cuda-wgl" and the host oracle, all equal;
      9. aerospike `cas-register` and hazelcast's fenced `lock`
         (`grid_runs`, the host oracles in `background`): each aerospike
         key decided by the race and re-checked by "cuda-wgl" and the
         host oracle, all equal; the lock's mutex decided by the race, its
         fences monotonic, and the mutex re-checked whole by "cuda-wgl"
         (`wgl32_chunk`) and the host oracle, all equal;
     10. dgraph `register` and `wr` through the port's stdlib HTTP client
         (`http_runs`, the register's host oracle in `background`): each
         register key decided by the race and re-checked by "cuda-wgl"
         and the host oracle, all equal; the wr run re-checked three ways
         as in step 1.

    The servers listen on their suites' own ports, below Linux's ephemeral
    range: a client retrying a down server's ephemeral port can connect to
    itself and hold it. Returns the launches of the runs and the re-checks
    by kernel (the comparisons with `closure_ref` launch nothing). Takes at
    most SUITES_LIMIT_S; any miss raises."""
    import collections
    import os
    import shutil
    import tempfile

    from jepsen_tpu_torch import checker, control, core, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.dbs import sqlite as sq
    from jepsen_tpu_torch.dbs import toykv
    from jepsen_tpu_torch.elle import append, wr
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.nemesis import faultfs

    print(f"the live suites, sqlite, etcd, mongodb, rabbitmq, mysql_cluster, "
          f"tidb, postgres, stolon, yuga, raftis, aerospike, hazelcast and "
          f"dgraph, the faultlib nemesis and EDN ingest ({card_line()}):",
          flush=True)
    t_all = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="suites-", dir=str(REPO / "build" /
                                                     "torch_kernels"))
    counts: collections.Counter = collections.Counter()
    worst = 0

    def sqlite_run(which: str, pace: bool = True):
        """A live sqlite run of `which` (its generator paced when `pace`):
        (test map, what `core.run` returned, the run's launches)."""
        opts = {**SUITE_RUN, **(SUITE_BANK if which == "bank" else {}),
                "workload": which, "name": f"suites-{which}",
                "store_root": os.path.join(tmp, which, "store"),
                "sandbox": os.path.join(tmp, which, "nodes")}
        test = sq.sqlite_test(opts)
        if pace:
            test["generator"] = paced(
                opts, sq.WORKLOADS[which](opts)["generator"],
                SUITE_STAGGER_S)
        zero_counts()
        done = diagnosed_run(test, f"the sqlite {which} run",
                             opts["sandbox"], "p1", sq.LOGFILE)
        torch.cuda.synchronize()
        return test, done, read_counts()

    # 1. append and wr: the suite, then its stored history three ways
    for which, check in (("append", append.check), ("wr", wr.check)):
        t0 = time.monotonic()
        test, done, run_counts = sqlite_run(which)
        res = done["results"][which]
        hist = done["history"]
        stored = History(store.load_latest(
            os.path.join(tmp, which, "store"))["history"]).index()
        if [o.to_dict() for o in stored] != [o.to_dict() for o in hist]:
            raise AssertionError(f"{which}: the stored history differs "
                                 "from the run's")
        txns = sum(1 for o in hist if o.f == "txn" and o.type != "invoke")
        banners = open(os.path.join(done["store_dir"], "p1", sq.LOGFILE)) \
            .read().count("minisql serving on")
        print(f"  {which} run ({time.monotonic() - t0:.2f} s; {SUITE_RUN}, "
              f"paced {SUITE_STAGGER_S} s): valid? {done['results']['valid?']}"
              f" ({which} {res['valid?']}, anomalies {res['anomaly-types']}),"
              f" {txns} txns completed, serving banners {banners}, engine "
              f"{res.get('cycle-engine')}, route "
              f"{res.get('cycle-route-reason')!r}, launches "
              f"{ {k: v for k, v in run_counts.items() if v} }", flush=True)
        if (done["results"]["valid?"] is not True or res["valid?"] is not True
                or res["anomaly-types"] or banners < 2):
            raise AssertionError(f"sqlite {which}: {done['results']}, "
                                 f"banners {banners}")
        counts.update(run_counts)

        rechecked, err = elle_rechecks(
            f"sqlite {which}", check, stored,
            test["checker"].checker_map[which], res, dev)
        counts.update(rechecked)
        worst = max(worst, err)

    # 2. bank
    t0 = time.monotonic()
    _, done, bank_counts = sqlite_run("bank", pace=False)
    pngs = [os.path.join(d, f) for d, _, fs in os.walk(done["store_dir"])
            for f in fs if f.endswith(".png")]
    try:
        import matplotlib  # noqa: F401
        have_plt = True
    except ImportError:
        have_plt = False
    bank = done["results"]["bank"]
    print(f"  bank run ({time.monotonic() - t0:.2f} s; {SUITE_BANK}): "
          f"valid? {done['results']['valid?']} (SI {bank['SI']['valid?']}, "
          f"{bank['SI']['read-count']} reads, "
          f"{bank['SI']['error-count']} errors), PNGs written {pngs} "
          f"(matplotlib {'installed' if have_plt else 'absent'})",
          flush=True)
    if done["results"]["valid?"] is not True or (pngs and not have_plt) \
            or bank["SI"]["read-count"] < 1:
        raise AssertionError(f"sqlite bank: {done['results']}, {pngs}")
    counts.update(bank_counts)

    # 3. the faultlib nemesis against a toykv node
    t0 = time.monotonic()
    ft = toykv.toykv_test({
        "name": "suites-faultlib", "nodes": ["a"], "concurrency": 2,
        "store_root": os.path.join(tmp, "faultlib", "store"),
        "sandbox": os.path.join(tmp, "faultlib", "nodes"), "time_limit": 6,
        "per_key_limit": 10, "nemesis_interval": 99})
    with control.with_remote(ft["remote"]):
        with control.with_ssh({}):
            with control.on("a"):
                so = faultfs.install_faultlib()
    build_s = time.monotonic() - t0
    ft.update(db=toykv.ToyKVDB(env=faultfs.preload_env(
        so, conf_path=faultfs.CONF_NAME, path_substr="state.log")),
        client=toykv.ToyKVSetClient(), nemesis=faultfs.FaultLibNemesis(),
        checker=checker.compose({"set": checker.set_checker(),
                                 "crashes": checker.unhandled_exceptions()}))
    counter = iter(range(10_000))

    def adds(n):
        return gen.clients([gen.limit(n, lambda t_, c: {
            "f": "add", "value": next(counter)})])

    ft["generator"] = gen.phases(
        adds(5),
        gen.nemesis([gen.once({"type": "info", "f": "start",
                               "value": {"eio_p": 1.0,
                                         "path": "state.log"}})]),
        adds(6),
        gen.nemesis([gen.once({"type": "info", "f": "stop"})]),
        adds(5),
        gen.clients([gen.limit(2, lambda t_, c: {"f": "read",
                                                 "value": None})]))
    zero_counts()
    t = core.run(ft)
    counts.update(read_counts())
    hist = t["history"]
    crashed = sum(1 for op in hist if op.is_info and op.f == "add"
                  and isinstance(op.process, int))
    log_text = open(os.path.join(t["store_dir"], "a", "server.log")).read()
    eio = log_text.count("Input/output error")
    s = t["results"]["set"]
    print(f"  faultlib nemesis against toykv ({time.monotonic() - t0:.2f} s, "
          f"faultlib built in {build_s:.2f} s): {crashed} adds crashed, "
          f"{eio} EIO in the server log, set checker valid? {s['valid?']} "
          f"(ok-count {s.get('ok-count')}, lost-count {s.get('lost-count')})",
          flush=True)
    if not crashed or not (eio or "OSError" in log_text) or \
            s["valid?"] is not True or s.get("lost-count"):
        raise AssertionError(f"faultlib nemesis: {crashed} crashed adds, "
                             f"{eio} EIO, set {s}")

    # 4. etcd
    etcd_counts, err = etcd_runs(dev, tmp)
    counts.update(etcd_counts)
    worst = max(worst, err)

    # 5. mongodb, rabbitmq and EDN ingest
    counts.update(doc_queue_runs(dev, tmp, background))

    # 6. the MySQL-wire family: mysql_cluster and tidb
    mysql_counts, err = mysql_runs(dev, tmp, background)
    counts.update(mysql_counts)
    worst = max(worst, err)

    # 7. the pgwire family: postgres and stolon
    pg_counts, err = pg_runs(dev, tmp, background)
    counts.update(pg_counts)
    worst = max(worst, err)

    # 8. yuga and raftis
    counts.update(yuga_raftis_runs(dev, tmp, background))

    # 9. the binary-wire suites: aerospike and hazelcast
    counts.update(grid_runs(dev, tmp, background))

    # 10. the last HTTP suite: dgraph
    http_counts, err = http_runs(dev, tmp, background)
    counts.update(http_counts)
    worst = max(worst, err)

    shutil.rmtree(tmp, ignore_errors=True)
    took = time.monotonic() - t_all
    counts = {k: v for k, v in counts.items() if v}
    print(f"  launches of the phase: {counts}; dense closures' max abs err "
          f"against closure_ref {worst}", flush=True)
    print(f"  suites phase: {took:.1f} s", flush=True)
    if any(counts.get(k, 0) < 1 for k in SUITE_KERNELS):
        raise AssertionError(f"suites phase launched too little: {counts}")
    if took > SUITES_LIMIT_S:
        raise AssertionError(f"suites phase took {took:.1f} s (limit "
                             f"{SUITES_LIMIT_S} s)")
    return {"launches": counts, "max_abs_err": worst}


# ---- the bench round ---------------------------------------------------------

SMOKE_LIMIT_S = 1200          # the time limit this script runs under
# what the phase needs after the first round's budget: the first round's
# own start and last config's overrun, the second round, the doctor, the
# last lines, and a margin (the part after the first round took 30-37 s
# on an H100; the round's configs run only while a config's `need`, up to
# 150 s, is left of its budget, so that it skips none below ~255 s)
BENCH_AFTER_S = 90
BENCH_MAX_TOTAL_S = 930       # the bench's own default round budget
BENCH_MIN_TOTAL_S = 60


def bench_want(background) -> dict:
    """{config: (verdict, what established it)} for every config of the
    round at the reference's seeds: the host oracle here (register 500,
    mutex 1k, the 24 mesh keys one by one) or in `background` (the Elle
    configs), or the phase of this script that checked the same history.
    Returns futures where the pool computes them."""
    from jepsen_tpu_torch import synth
    from jepsen_tpu_torch.models import cas_register, mutex, register
    from jepsen_tpu_torch.ops import wgl_ref

    want = {
        "register_500": (wgl_ref.check(register(), synth.cas_register_history(
            500, n_procs=5, seed=7, fs=("read", "write")))["valid?"],
            "host oracle"),
        "mutex_1k": (wgl_ref.check(mutex(), synth.mutex_history(
            1000, n_procs=4, seed=7))["valid?"], "host oracle"),
        "fifo_queue_100k": (True, "the FIFO phase (queue-poly)"),
        "adversarial_wave_2M": (False, "the 16-wave phase"),
        "long_tail_900": (True, "the long-tail phase"),
        "independent_100x2k": (True, "the fan-out phase (100 keys True)"),
    }
    mesh = [wgl_ref.check(cas_register(), synth.cas_register_history(
        600, n_procs=5, seed=1000 + s, crash_p=0.002))["valid?"]
        for s in range(24)]
    want["independent_mesh_24x600"] = (
        True if all(v is True for v in mesh) else
        False if False in mesh else "unknown", "host oracle per key")
    for name, kind, n in (("elle_append_3k", "append", 3000),
                          ("elle_wr_3k", "wr", 3000),
                          ("elle_append_8k", "append", 4000),
                          ("elle_append_sharded_2000", "append", 2000)):
        want[name] = (background.submit(elle_host_check, kind, n),
                      "host oracle (Elle, host engine)")
    return want


def elle_host_check(kind: str, n_txns: int):
    """The host engine's verdict on the bench's Elle history (in a worker
    process): `elle.append` or `elle.wr` (linearizable keys) over
    `n_txns` txns, 5 processes, seed 7, realtime edges."""
    from jepsen_tpu_torch import synth
    from jepsen_tpu_torch.elle import append, wr
    if kind == "wr":
        return wr.check(synth.wr_register_history(n_txns, n_procs=5, seed=7),
                        linearizable_keys=True, additional_graphs=RT,
                        cycle_backend="host")["valid?"]
    return append.check(synth.list_append_history(n_txns, n_procs=5, seed=7),
                        additional_graphs=RT, cycle_backend="host")["valid?"]


def clear_bench_outputs() -> list:
    """The port's own bench outputs in this checkout: `artifacts/torch/`
    and the bench records of `store/torch` (kinds bench, bench-round,
    bench-occupancy, and the doctor's records of bench rounds), so that
    the round's priors are this run's. Nothing of the JAX package is
    touched. Returns the ids dropped."""
    import os
    import shutil
    from jepsen_tpu_torch import bench, ledger

    shutil.rmtree(REPO / bench.ART_DIR, ignore_errors=True)
    led = ledger.Ledger(str(REPO / bench.STORE_DIR))
    drop = {r["id"] for r in led.query()
            if str(r.get("kind")).startswith("bench")
            or (r.get("kind") == "doctor"
                and (r.get("where") == "bench"
                     or r.get("name") == "doctor-bench"))}
    if not drop:
        return []
    for rid in drop:
        try:
            os.remove(led.record_path(rid))
        except OSError:
            pass
    with open(led.index_path) as fh:
        keep = [ln for ln in fh
                if ln.strip() and json.loads(ln).get("id") not in drop]
    tmp = led.index_path + ".tmp"
    with open(tmp, "w") as fh:
        fh.writelines(keep)
    os.replace(tmp, led.index_path)
    return sorted(drop)


def bench_round(extras: bool, total_s: float, timeout: float) -> tuple:
    """`python -m jepsen_tpu_torch.bench` in a fresh process from the
    checkout: (exit code, its line, the details file, stderr tail)."""
    import os
    from jepsen_tpu_torch import bench

    env = {**os.environ, "JEPSEN_TPU_BENCH_EXTRAS": "1" if extras else "0",
           "JEPSEN_TPU_BENCH_TOTAL_S": f"{total_s:.0f}"}
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.monotonic() - t0
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines (exit "
                             f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    with open(REPO / bench.DETAILS_FILE) as fh:
        details = json.load(fh)
    print(f"  round (extras {extras}, JEPSEN_TPU_BENCH_TOTAL_S "
          f"{total_s:.0f}): exit {proc.returncode} in {wall:.1f} s",
          flush=True)
    return proc.returncode, json.loads(lines[0]), details, proc.stderr[-3000:]


def bench_phases(background) -> None:
    """The bench round on the card (`python -m jepsen_tpu_torch.bench`,
    fresh processes from the checkout):

      1. the port's bench outputs are cleared (`clear_bench_outputs`);
      2. a round with the extras on, at the reference's sizes, under a
         round budget (`JEPSEN_TPU_BENCH_TOTAL_S`) of what is left of
         SMOKE_LIMIT_S after BENCH_AFTER_S: a config that does not fit is
         skipped and recorded by the bench's own rule. The phase fails
         unless the exit code is 0, the headline True with 0 warm
         compiles on platform gpu, no config that ran says "error", and
         every config that ran has the verdict that the host oracle or
         this script's own phase gives at the same seed (`bench_want`);
         it prints the compact line, each config's verdict, wall, engine
         and launches, and the skipped ones with their cause;
      3. a headline-only round (`JEPSEN_TPU_BENCH_EXTRAS=0`), whose
         `regressions` block must read the first round as its prior on
         platform gpu;
      4. `python -m jepsen_tpu_torch doctor bench` over the round: its
         exit code (0) and findings."""
    print(f"bench round ({card_line()}):", flush=True)
    dropped = clear_bench_outputs()
    print(f"  cleared artifacts/torch and {len(dropped)} bench record(s) "
          "of store/torch", flush=True)
    elapsed = time.monotonic() - T_START
    total_s = min(BENCH_MAX_TOTAL_S, max(
        BENCH_MIN_TOTAL_S, SMOKE_LIMIT_S - elapsed - BENCH_AFTER_S))
    print(f"  {elapsed:.1f} s into the smoke: round budget {total_s:.0f} s",
          flush=True)
    pending = {}

    def oracle():
        pending.update(bench_want(background))

    import threading
    th = threading.Thread(target=oracle, name="bench-oracle")
    th.start()
    try:
        rc, line, details, err = bench_round(True, total_s,
                                             timeout=total_s + 240)
    finally:
        th.join()
    want = {k: ((v.result(timeout=600) if hasattr(v, "result") else v), by)
            for k, (v, by) in pending.items()}
    print("  line: " + json.dumps(line), flush=True)
    if rc != 0 or line.get("verdict") is not True or \
            line.get("compiles") != 0 or line.get("platform") != "gpu":
        raise AssertionError(f"bench round: exit {rc}, verdict "
                             f"{line.get('verdict')}, compiles "
                             f"{line.get('compiles')}, platform "
                             f"{line.get('platform')}:\n{err}")
    ran, skipped, bad = [], [], []
    for name, c in details["configs"].items():
        if c.get("verdict") == "skipped":
            skipped.append(name)
            print(f"    {name}: skipped ({c.get('cause')})", flush=True)
            continue
        ran.append(name)
        exp = want.get(name)
        print(f"    {name}: {c.get('verdict')} in {c.get('wall_s')} s, "
              f"engine {c.get('engine')}, K {c.get('K')}, launches "
              f"{c.get('launches')}"
              + (f", cause {c.get('cause')}" if c.get("cause") else "")
              + (f"; want {exp[0]} ({exp[1]})" if exp else
                 "; the headline"), flush=True)
        if c.get("verdict") == "error" or (
                exp is not None and c.get("verdict") != exp[0]) or \
                "DISAGREEMENT" in str(c.get("cause") or ""):
            bad.append(name)
    print(f"  ran {ran}; skipped {skipped}", flush=True)
    missing = set(want) - set(details["configs"])
    if bad or missing:
        raise AssertionError(f"bench configs: wrong {bad}, missing "
                             f"{sorted(missing)}:\n{err}")
    headline = details["configs"][line["metric"].replace("_wgl_wall_s", "")]
    if headline.get("verdict") is not True or not headline.get("launches"):
        raise AssertionError(f"bench headline entry: {headline}")

    rc2, line2, _, err2 = bench_round(False, BENCH_MAX_TOTAL_S, timeout=300)
    reg = line2.get("regressions") or {}
    print(f"  second round: value {line2.get('value')} s, verdict "
          f"{line2.get('verdict')}; regressions {json.dumps(reg)}",
          flush=True)
    if rc2 != 0 or line2.get("platform") != "gpu" or \
            reg.get("compared_rounds") != [1]:
        raise AssertionError(f"second bench round: exit {rc2}, "
                             f"regressions {reg}:\n{err2}")

    proc = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch",
                           "doctor", "bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    print(f"  python -m jepsen_tpu_torch doctor bench: exit "
          f"{proc.returncode}\n" + "\n".join(
              "    " + ln for ln in proc.stdout.strip().splitlines()),
          flush=True)
    if proc.returncode != 0 or "doctor: target=bench platform=gpu" \
            not in proc.stdout:
        raise AssertionError(f"doctor bench: exit {proc.returncode}\n"
                             f"{proc.stderr[-2000:]}")
    print(f"  bench phases: {time.monotonic() - T_START - elapsed:.1f} s",
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
    global T_START
    T_START = time.monotonic()
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
        return run_phases(dev, host10, background)
    finally:
        background.shutdown(wait=True, cancel_futures=True)


def run_phases(dev, host10, background) -> int:
    """Every phase after the card check, the host oracle of the Elle 10k
    history running in the background (`host10`; `background` is its
    one-process pool)."""
    from jepsen_tpu_torch import checker, occupancy, synth
    from jepsen_tpu_torch.models import (cas_register, fifo_queue, mutex,
                                         register)
    from jepsen_tpu_torch.ops import _native, adapt, encode, wgl, wgl32
    from jepsen_tpu_torch.ops import wgl_ref, wgln

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    # the host kernel too (the competition's device@cpu lane): a race
    # joins its lanes, so a first race would wait for its build
    t0 = time.monotonic()
    builds = _native.build_all()
    hosts = _native.build_host()
    print(f"build: {time.monotonic() - t0:.2f} s for {sorted(builds)} and "
          f"{sorted(hosts)}")
    for name, rec in builds.items():
        if rec is None:
            print(f"  {name}: already built")
        else:
            print(f"  {name}: nvcc {rec['seconds']:.2f} s\n{rec['ptxas']}")
    for name, rec in hosts.items():
        print(f"  {name}: " + ("already built" if rec is None else
                              f"host compiler {rec['seconds']:.2f} s"))

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
    # three lanes on the card: the device@cpu lane's chunks are the host
    # kernel's (counted apart from the card's launches)
    tail_host = host_counts()["wgln_host_chunk"]
    res, wall, counts, _, _, _ = drive(
        checker.linearizable(cas_register()), tail)
    tail_host = host_counts()["wgln_host_chunk"] - tail_host
    print(f"default checker, long tail {LONG_TAIL} (window "
          f"{tenc.window_raw}): valid? {res['valid?']} engine "
          f"{res.get('engine')} wall {wall:.4f} s, launches {counts}: "
          f"{launch_line('wgln_chunk')}; the device@cpu lane's host chunks "
          f"{tail_host}")
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

    # each phase's wall, and how far into SMOKE_LIMIT_S it ended: what the
    # bench round's budget is left from
    walls = {"up to the fan-out": round(time.monotonic() - T_START, 1)}

    def phase(fn, *a):
        t0 = time.monotonic()
        try:
            return fn(*a)
        finally:
            walls[fn.__name__] = round(time.monotonic() - t0, 1)
            print(f"[{fn.__name__}: {walls[fn.__name__]} s, ended "
                  f"{time.monotonic() - T_START:.1f} s into the smoke]",
                  flush=True)

    host_entries, lane_verdict, lane_oracle = phase(
        host_lane_phases, h, wave, tail_host)
    fanout = phase(fanout_phases, dev)
    step_us = barrier_step_us(dev)
    elle = phase(elle_phases, dev, host10, step_us, background)
    bool_entry = phase(bool_chunk_phases, dev, step_us)
    phase(preflight_phases, dev)
    phase(warm_phases, dev, lin, h)
    phase(service_phases, dev)
    phase(analyze_phases, dev)
    phase(test_phases, dev)
    phase(plots_phases, dev)
    ap_store, ap_bodies = phase(autopilot_phases, dev)
    phase(cli_phases, dev, ap_store, ap_bodies)
    phase(fleet_phases, dev, background)
    phase(lint_phases, dev, background)
    cluster = phase(cluster_phases, dev)
    suites = phase(suites_phases, dev, background)
    await_headline_oracle(lane_oracle, lane_verdict)
    phase(bench_phases, background)
    print(f"phase walls (s): {json.dumps(walls)}", flush=True)

    print("card:", card_line())
    kernels = [{
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
        "bound_by": "bytes", "library_ms": None}] + fanout + elle + [
            bool_entry] + host_entries
    # the cluster and suites phases' launches join each kernel's main-path
    # count, and the suites phase's closures its error
    for entry in kernels:
        entry["launches"] = (entry["launches"] or 0) + cluster.get(
            entry["name"], 0) + suites["launches"].get(entry["name"], 0)
        if entry["name"] in SUITE_KERNELS:
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       suites["max_abs_err"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
