"""The mesh lane scheduler: lane-packed WGL search over several devices
with a host scheduler between polls.

The port of `jepsen_tpu/parallel/mesh.py`. Keys are packed into a
small window of lane slots, `lanes_per_device` per device of a device
list (the reference's mesh: `util.default_devices`, or a
named list that may repeat a device, so that several shards share one
card). Each shard owns a contiguous block of slots and runs them as ONE
lane-batched chunk launch per poll (`wgl32.chunk_batched` /
`wgln.chunk_batched`, PR 4's kernels), on its own CUDA stream of its
device; every shard is launched before the host reads any shard's
summary. This is the reference's `_mesh_compiled` (a `shard_map` of the
batched chunk: no collectives, the shards meet only when the host reads
the poll summary). Between polls the host scheduler

  * **retires** decided lanes and refills their slots from the owning
    shard's pending queue; the refilled lanes' carries are reset in
    place (`reset_lanes`: the `wgl_lane_reset` kernel, the reference's
    `_reset_fn`), and only the shards with a refilled slot re-send
    their consts;
  * **re-buckets** the whole window through the adaptive ladder when
    the live lanes' `adapt.recommend` hints say the shared K is wrong:
    frontiers cross the switch by `migrate_lanes` (the
    `wgl_frontier_migrate` kernel, the reference's `_migrate_fn`), a pad
    or slice, never a restart;
  * **steals** pending keys from straggler shards (`maybe_steal`: the
    work-skew trigger through `fleet.steal_plan`, and the idle pull).

One process drives every shard, as the reference's single controller
does; nothing here uses `torch.distributed`. On a CPU device list (the
tests) every kernel wrapper runs its plain version.

`check_mesh` admits through `preflight.gate_mesh`, and carries the
reference's planes: a watchdog heartbeat a poll (a soft cancel ends the
run, undecided keys "stalled" with their partial progress), the device
monitor's samples a poll (each card once, however many shards it
holds), the `mesh_sched` series of the scheduler's actions and, with
metrics on, the lanes' `wgl_batched_lanes` and `wgl_batched_rounds`
points. `kernel_params` has no `accel` key (the port's kernels have one
layout).

The warm plane (`warm_plan`, reached through `ops/aot.
precompile_mesh_plan`): every kernel a run over one shape bucket may
launch is built, loaded, bound and launched once, the plan registered in
the port's `fs_cache` under `plan_cache_key`, and a pre-zeroed starting
carry stocked in the carry pool, which a run over a caller-named device
list (the reference's explicit mesh) takes and restocks.
"""

from __future__ import annotations

import math
import os
import threading
import time as _time
import weakref
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from .. import devices as _devices
from .. import fleet as _fleet
from .. import metrics as _metrics
from .. import occupancy as _occ
from .. import watchdog as _watchdog
from ..history import History
from ..models.core import Model
from ..ops import _native
from ..ops import adapt as _adapt
from ..analysis import preflight
from ..ops import wgl32, wgln
from ..ops.encode import INF, Encoded
from ..util import (default_devices, on_device, on_stream, raw_stream,
                    resolve_devices, shard_streams)
from .batched import (LANE_ROUNDS_BUDGET, _annotate_shard,
                      _batch_capacities, _oracle_fallback, _record_lanes,
                      shared_shape_bucket)

# Lane slots per device: the active window is n_devices x this many
# lanes; the rest of the keys wait in per-shard pending queues.
MESH_LANES_PER_DEVICE = int(os.environ.get("JEPSEN_TPU_MESH_LANES", "4"))

# Below this many encodable keys the scheduler cannot pay for itself:
# check_batched's "auto" keeps the stream/vmap decision there.
MIN_MESH_KEYS = 4

# Bound on ladder switches per group run.
MAX_REBUCKETS = 6

# Scheduler events kept on the run summary.
EVENT_CAP = 128


def enabled(default: bool = True) -> bool:
    """Kill-switch: JEPSEN_TPU_MESH=0 pins the stream/vmap routing."""
    v = os.environ.get("JEPSEN_TPU_MESH")
    if v is None:
        return default
    return v not in ("0", "false", "no")


def kernel_params(bucket: dict, bk: int, chunk: int = 1024) -> dict:
    """The mesh batch kernel of a shared shape bucket: variant, padded
    widths, capacities (sized by the whole window of `bk` lanes, as in
    the reference), and the adaptive ladder the scheduler may climb."""
    wide = int(bucket["w_eff"]) > 32
    if wide:
        W = int(bucket["w_eff"])
        L = W // 32
        chunk = min(chunk, 128)
    else:
        W = max(8, int(bucket["w_eff"]))
        L = 0
    n_pad = int(bucket["n_pad"])
    ic_eff = max(8, int(bucket["ic_eff"]))
    K_cap, H, B = _batch_capacities(bk, W, n_pad, L)
    if L:
        ladder = _adapt.ladder_for(K_cap, k_min=max(16, K_cap // 16), step=8)
    else:
        ladder = _adapt.ladder_for(K_cap, k_min=2, step=8)
    return {"n_pad": n_pad, "ic_pad": ic_eff, "W": W, "L": L,
            "S": int(bucket["S"]), "O": int(bucket["O"]),
            "H": H, "B": B, "chunk": chunk, "probes": 4,
            "ladder": ladder, "K_cap": K_cap}


def lanes_for(n_keys: int, n_devices: int) -> int:
    """check_mesh's lanes-per-device derivation."""
    return min(MESH_LANES_PER_DEVICE,
               max(1, math.ceil(n_keys / max(n_devices, 1))))


# ---------------------------------------------------------------------------
# the carry programs: lane reset and batched frontier migration
# ---------------------------------------------------------------------------

def _lane_mask(mask, lanes: int) -> np.ndarray:
    m = np.asarray(mask.cpu() if torch.is_tensor(mask) else mask, dtype=bool)
    if m.shape != (lanes,):
        raise ValueError(f"lane mask of shape {m.shape}, want ({lanes},)")
    return m


def reset_lanes_ref(carry, mask, *, mst_col: int, mstate0: int = 0):
    """Plain PyTorch lane reset (the JAX package's `_reset_fn()` with the
    init tree of `init_fn(mstate0)`): every lane whose mask is set takes
    the search's start state in every carry leaf (frontier zero but row
    0's model state in column `mst_col`, fr_cnt 1, memo table, backlog,
    flags, stats and ring zero); the other lanes keep their state.
    Updates the carry in place; returns it."""
    m = _lane_mask(mask, carry[wgl32.FR].shape[0])
    idx = torch.as_tensor(np.flatnonzero(m), device=carry[wgl32.FR].device)
    if not len(idx):
        return carry
    for i, t in enumerate(carry):
        t[idx] = 1 if i == wgl32.FR_CNT else 0
    carry[wgl32.FR][idx, 0, mst_col] = mstate0
    return carry


# A carry of at most this many lanes hands the reset kernel its lane
# mask by value (one 64-bit word of its argument block); a wider one
# hands it the masked lanes' indices on the card (no main path resets
# that many lanes).
MASK_BITS = 64

# The reset kernel's argument block (`csrc/wgl_lanes.cu`): one host
# array of int64 words, the eight leaves' pointers, the masked lanes'
# indices (0: by value), the mask, the masked count, K, C, B, H, the
# ring's words a lane, the model-state column and its value. One
# pointer crosses ctypes in place of twenty arguments (about 7 µs of a
# call's host path).
RESET_WORDS = 18
_IDX, _MASK, _N, _MST_COL, _MSTATE0 = 8, 9, 10, 16, 17

# Carries whose eight leaves `reset_lanes` has checked: their argument
# blocks by the leaves' identities, each beside weak references that
# tell a live carry from a new one at a reused id. Bounded, cleared when
# full.
_RESET_BLOCKS: dict = {}
_RESET_BLOCKS_CAP = 64


def _reset_block(carry) -> np.ndarray:
    """The argument block of `carry`, its leaves checked once a carry
    (the first call with these eight tensors): contiguous int32 (or
    uint32) on the frontier's card, each with the frontier's lane count
    and the carry's shapes. Raises ValueError. The block is the carry's
    own: one thread resets a carry at a time."""
    key = tuple(map(id, carry))
    hit = _RESET_BLOCKS.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], carry)):
        return hit[1]
    fr = carry[wgl32.FR]
    lanes, K, C = fr.shape
    B, H = carry[wgl32.BK].shape[1], carry[wgl32.TABLE].shape[1]
    ring = carry[wgl32.RING_BUF]
    want = {wgl32.FR_CNT: (lanes,), wgl32.BK: (lanes, B, C),
            wgl32.BK_CNT: (lanes,), wgl32.TABLE: (lanes, H, 4),
            wgl32.FLAGS: (lanes, 3), wgl32.STATS: (lanes, 6),
            wgl32.RING_BUF: (lanes,) + tuple(ring.shape[1:])}
    for i, t in enumerate(carry):
        if i in want and tuple(t.shape) != want[i]:
            raise ValueError(f"reset_lanes: leaf {i} of shape "
                             f"{tuple(t.shape)}, want {want[i]}")
        if t.device != fr.device or t.dtype not in (torch.int32,
                                                    torch.uint32) \
                or not t.is_contiguous():
            raise ValueError("reset_lanes: leaves must be contiguous int32 "
                             f"on {fr.device}")
    blk = np.zeros(RESET_WORDS, np.int64)
    blk[:8] = [t.data_ptr() for t in carry]
    blk[11:16] = (K, C, B, H, ring.numel() // lanes)
    if len(_RESET_BLOCKS) >= _RESET_BLOCKS_CAP:
        _RESET_BLOCKS.clear()
    _RESET_BLOCKS[key] = (tuple(weakref.ref(t) for t in carry), blk)
    return blk


def reset_lanes(carry, mask, *, mst_col: int, mstate0: int = 0):
    """The lane reset (see `reset_lanes_ref`). CUDA tensors run the
    `wgl_lane_reset` kernel (one launch per call with a lane set,
    counted in `reset_lanes.launches`; nothing is launched for an empty
    mask); CPU tensors run `reset_lanes_ref`. Updates the carry in
    place; returns it. The launch path is lean, as `migrate_lanes`'s: the
    leaves are checked once a carry (`_reset_block`), a mask of at most
    MASK_BITS lanes crosses by value in the argument block, no device
    switch when the carry's card is current, the current stream's raw
    handle."""
    fr = carry[wgl32.FR]
    if not fr.is_cuda:
        if fr.device.type == "cpu":
            return reset_lanes_ref(carry, mask, mst_col=mst_col,
                                   mstate0=mstate0)
        raise ValueError(f"reset_lanes: unsupported device {fr.device}")
    lanes = fr.shape[0]
    idx = np.flatnonzero(_lane_mask(mask, lanes))
    if not len(idx):
        return carry
    blk = _reset_block(carry)
    if not 0 <= mst_col < blk[12] or len(idx) > 65535:
        raise ValueError(f"reset_lanes: mst_col {mst_col}, {len(idx)} "
                         "lanes masked")
    sel, words = None, 0
    if lanes <= MASK_BITS:
        for i in idx.tolist():
            words |= 1 << i
    else:
        # the indices through pinned memory: an asynchronous copy, which
        # the caching host allocator keeps alive until it is done
        sel = torch.from_numpy(idx.astype(np.int32)).pin_memory().to(
            fr.device, non_blocking=True)
    blk[_IDX] = 0 if sel is None else sel.data_ptr()
    blk[_MASK] = words - (1 << 64) if words >= 1 << 63 else words
    blk[_N], blk[_MST_COL], blk[_MSTATE0] = len(idx), mst_col, mstate0
    d = fr.get_device()
    with on_device(d):
        _native.launch("wgl_lane_reset", (blk.ctypes.data,), (),
                       raw_stream(d))
    reset_lanes.launches += 1
    return carry


reset_lanes.launches = 0


def migrate_lanes(carry, k_new: int):
    """The batched frontier migration (see
    `adapt.migrate_frontier_batch`, its plain version): the (lanes, K,
    C) frontier padded with zero rows or cut to k_new rows; the other
    leaves ride along. The same carry comes back when K does not
    change. CUDA tensors run the `wgl_frontier_migrate` kernel into a
    new frontier (one launch per call, counted in
    `migrate_lanes.launches`); CPU tensors run the plain version. The
    frontier is small, so the host path is most of the call: no device
    switch when `fr`'s card is current, the raw stream, one
    allocation."""
    fr = carry[wgl32.FR]
    lanes, k_old, C = fr.shape
    if k_old == k_new:
        return carry
    if not fr.is_cuda:
        if fr.device.type == "cpu":
            return _adapt.migrate_frontier_batch(carry, k_new)
        raise ValueError(f"migrate_lanes: unsupported device {fr.device}")
    if k_new < 1 or fr.dtype != torch.int32 or not fr.is_contiguous():
        raise ValueError("migrate_lanes: a contiguous int32 (lanes, K, C) "
                         f"frontier and k_new >= 1, got k_new {k_new}")
    out = fr.new_empty((lanes, k_new, C))
    idx = fr.get_device()
    with on_device(idx):
        _native.launch("wgl_frontier_migrate",
                       (fr.data_ptr(), out.data_ptr()),
                       (lanes, k_old, k_new, C), raw_stream(idx))
    migrate_lanes.launches += 1
    return (out, *carry[1:])


migrate_lanes.launches = 0


# ---------------------------------------------------------------------------
# live snapshot
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_SNAP: dict = {"active": False, "runs": 0, "steals": 0,
               "rebuckets": 0, "last": None}


def snapshot() -> dict:
    """How many mesh runs this process scheduled, the total steal and
    rebucket actions, and the last run's summary."""
    with _LOCK:
        return dict(_SNAP, last=(dict(_SNAP["last"])
                                 if _SNAP["last"] else None))


def last_summary() -> Optional[dict]:
    """The most recent `check_mesh` scheduler summary (per-shard keys,
    wall and steals, skew before and after, polls, refills, resets and
    rebuckets, the final K)."""
    with _LOCK:
        return dict(_SNAP["last"]) if _SNAP["last"] else None


def _record_run(summary: dict) -> None:
    with _LOCK:
        _SNAP["runs"] += 1
        _SNAP["steals"] += int(summary.get("steals") or 0)
        _SNAP["rebuckets"] += int(summary.get("rebuckets") or 0)
        _SNAP["last"] = summary
        _SNAP["active"] = True


# ---------------------------------------------------------------------------
# the pre-zeroed carry pool
# ---------------------------------------------------------------------------
# A run's starting carries are lanes x H x 16 B of zero-fill a shard
# (about 67 MB for the 8 slots of a 2k-op narrow fan-out) that every
# run would otherwise pay inside its wall. `warm_plan` stocks one set a
# plan and `_run_group` restocks after each healthy run, off-thread, so
# that the next run over the same bucket and device list finds its
# carries built. An entry is one carry a shard, each beside the event
# recorded after its fill on the filling thread's stream (None on the
# CPU); taking an entry moves ownership to the taker, whose shard
# streams wait on the events (`_pool_adopt`).
_CARRY_POOL: dict = {}
_CARRY_POOL_CAP = 2
_RESTOCKS: list = []      # restock threads not yet joined


def _pool_key(p: dict, K: int, devices, bk: int) -> tuple:
    return (p["n_pad"], p["ic_pad"], p["W"], p["S"], p["O"], int(K),
            p["H"], p["B"], p["chunk"], p["probes"], p["L"],
            tuple(_fleet.device_labels(devices)), int(bk))


def _pool_take(key: tuple):
    with _LOCK:
        return _CARRY_POOL.pop(key, None)


def _pool_stock(key: tuple, build) -> None:
    with _LOCK:
        if key in _CARRY_POOL:
            return
    entry = build()
    with _LOCK:
        while len(_CARRY_POOL) >= _CARRY_POOL_CAP:
            _CARRY_POOL.pop(next(iter(_CARRY_POOL)), None)
        _CARRY_POOL[key] = entry


def _pool_build(devices, lanes: int, K: int, C: int, H: int, B: int,
                mst_col: int) -> list:
    """A pool entry: `wgl32.init_carry_batch` of `lanes` lanes on each
    device of the list, on the calling thread's current stream of that
    device, each with the event recorded after its fill."""
    entry = []
    for dev in devices:
        if dev.type != "cuda":
            entry.append((wgl32.init_carry_batch(lanes, K, C, H, B, 0, dev,
                                                 mst_col=mst_col), None))
            continue
        with on_device(dev):
            carry = wgl32.init_carry_batch(lanes, K, C, H, B, 0, dev,
                                           mst_col=mst_col)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        entry.append((carry, ev))
    return entry


def _pool_adopt(entry, d: int, stream):
    """Shard d's carry of a pool entry, owned by `stream` (the shard's
    stream; None on the CPU): the stream waits for the fill, and the
    allocator learns that the stream uses every leaf."""
    carry, ev = entry[d]
    if stream is not None:
        stream.wait_event(ev)
        for t in carry:
            t.record_stream(stream)
    return carry


def _restock(key: tuple, build) -> None:
    """`_pool_stock` on a daemon thread: the zero-fill belongs to the
    next run, not this one's wall."""
    th = threading.Thread(target=_pool_stock, args=(key, build),
                          daemon=True, name="jepsen-tpu-torch-restock")
    with _LOCK:
        _RESTOCKS[:] = [t for t in _RESTOCKS if t.is_alive()] + [th]
    th.start()


def pool_settle(timeout: Optional[float] = None) -> None:
    """Wait for every restock thread started so far (a caller that
    measures device memory around a run wants the fill outside its
    window)."""
    with _LOCK:
        pending = list(_RESTOCKS)
    for th in pending:
        th.join(timeout)


def pool_clear() -> None:
    """Drop every pooled carry (after `pool_settle`)."""
    pool_settle()
    with _LOCK:
        _CARRY_POOL.clear()



# ---------------------------------------------------------------------------
# the warm path (aot.precompile_mesh_plan delegates here)
# ---------------------------------------------------------------------------

def plan_cache_key(bucket: dict, *, n_devices: int,
                   lanes_per_device: int, axes: Sequence[str],
                   model_name: str = "any") -> tuple:
    """The fs_cache key one warmed mesh plan registers under: (model, W,
    K ceiling, lane shapes, device list shape), the reference's key
    string for string. The port's kernels have one layout, so the key
    says `accel0` where the reference writes its TPU layout bit."""
    bk = n_devices * lanes_per_device
    p = kernel_params(bucket, bk)
    return ("mesh-plan", str(model_name or "any"),
            f"W{p['W']}", f"L{p['L']}", f"K{p['K_cap']}",
            f"n{p['n_pad']}", f"ic{p['ic_pad']}",
            f"S{p['S']}", f"O{p['O']}", "accel0",
            f"mesh-{n_devices}x{lanes_per_device}",
            "-".join(str(a) for a in axes))


def warm_plan(bucket: dict, *, n_devices: Optional[int] = None,
              devices=None, lanes_per_device: Optional[int] = None,
              n_keys: Optional[int] = None,
              chunk: int = 1024, axes: Sequence[str] = ("keys",),
              model_name: str = "any", save: bool = True) -> dict:
    """Build, load, bind and launch once every kernel a mesh run over
    this shape bucket may launch, on every shard's stream: each ladder
    bucket's lane-batched chunk (a zero config budget, so that no round
    runs, through `chunk_batched` and so in the form the run takes),
    the lane reset (every lane of a fresh carry: the result is that
    carry, and an empty mask launches nothing) and the adjacent buckets'
    frontier migrations both ways. One sync per bucket is the job.

    `devices` is the run's device list (`util.resolve_devices`; it may
    repeat a card), else the first `n_devices` cards. With a named list
    the pool is stocked with the run's starting carries (a run over an
    unnamed list does not use the pool). The plan is registered in
    `fs_cache` under `plan_cache_key` (best effort: the registry is a
    warm-up accelerant) so that a fresh process can re-warm it
    (`aot.precompile_cached_mesh_plans`). Pass `n_keys` (or
    `lanes_per_device`) matching the traffic: the lane count is part of
    every launch's shape. A build or launch failure raises. Returns {K:
    seconds}."""
    named = devices is not None
    devs = (resolve_devices(devices) if named
            else default_devices(n_devices))
    nd = len(devs)
    axes = tuple(str(a) for a in axes)
    s_d = int(lanes_per_device
              or (lanes_for(int(n_keys), nd) if n_keys
                  else MESH_LANES_PER_DEVICE))
    bk = nd * s_d
    p = kernel_params(bucket, bk, chunk)
    L, ic, H, B = p["L"], p["ic_pad"], p["H"], p["B"]
    C = wgln.row_words(L, ic) if L else wgl32.row_words(ic)
    mst_col = 1 + L if L else 2
    n_pad = p["n_pad"]
    zeros = np.zeros
    streams = shard_streams(devs)
    ladder = p["ladder"]
    out: dict = {}
    fronts: dict = {}
    for k in ladder:
        t0 = _time.monotonic()
        fronts[k] = []
        for d, dev in enumerate(devs):
            with on_stream(streams[d]):
                # max_cfg 0: no round runs
                consts = wgl32.batch_consts_from_numpy(
                    zeros((s_d, n_pad), np.int32),
                    zeros((s_d, n_pad), np.int32),
                    zeros((s_d, n_pad), np.int32),
                    zeros((s_d, n_pad + 1), np.int32),
                    zeros((s_d, ic), np.int32), zeros((s_d, ic), np.int32),
                    zeros((s_d, p["S"], p["O"]), np.int32), 0, 0, 0, dev)
                carry = wgl32.init_carry_batch(s_d, k, C, H, B, 0, dev,
                                               mst_col=mst_col)
                reset_lanes(carry, np.ones(s_d, bool), mst_col=mst_col)
                kw = dict(K=k, ic=ic, H=H, B=B, chunk=p["chunk"],
                          probes=p["probes"])
                if L:
                    wgln.chunk_batched(consts, carry, L=L, **kw)
                else:
                    wgl32.chunk_batched(consts, carry, W=p["W"], **kw)
                fronts[k].append(carry[wgl32.FR])
                del carry, consts
        _sync_streams(streams)
        out[k] = _time.monotonic() - t0
    # the adjacent buckets' migrations, both ways: the scheduler's only
    # other device programs
    for a, b in zip(ladder, ladder[1:]):
        for d in range(nd):
            with on_stream(streams[d]):
                migrate_lanes((fronts[a][d],), b)
                migrate_lanes((fronts[b][d],), a)
    _sync_streams(streams)
    fronts.clear()
    if named:
        _pool_stock(_pool_key(p, ladder[0], devs, bk),
                    lambda: _pool_build(devs, s_d, ladder[0], C, H, B,
                                        mst_col))
    if save:
        try:
            from .. import fs_cache
            fs_cache.save_data(
                plan_cache_key(bucket, n_devices=nd, lanes_per_device=s_d,
                               axes=axes, model_name=model_name),
                {"bucket": {k: bool(v) if k == "pack" else int(v)
                            for k, v in bucket.items()},
                 "n_devices": nd, "lanes_per_device": s_d,
                 "chunk": int(chunk), "axes": list(axes),
                 "model": str(model_name or "any"), "compile_s": out})
        except Exception:  # noqa: BLE001 — the registry is a warm-up
            pass           # accelerant, never a correctness gate
    return out


def _sync_streams(streams) -> None:
    for st in streams:
        if st is not None:
            # kernellint: ok(K007) — a warm's one wait a stream
            st.synchronize()


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

class _GroupRun:
    """One kernel branch's lane group (narrow or wide) over the device
    list: the slot window, the per-shard pending queues, the packed
    consts arrays, and the per-poll bookkeeping."""

    def __init__(self, encs, idxs, devices, *, chunk: int,
                 lanes_per_device: Optional[int], assign: str,
                 deadline: Optional[float], max_configs: int,
                 oracle_fallback: bool, key_indices, group: str,
                 steal: bool = True, shape_bucket: Optional[dict] = None,
                 pooled: bool = False):
        self.encs = encs
        # a caller-named device list takes its starting carries from
        # the pool and restocks it
        self.pooled = pooled
        self.pool_hit = False
        self.idxs = list(idxs)
        self.deadline = deadline
        self.max_configs = max_configs
        self.oracle_fallback = oracle_fallback
        self.key_indices = key_indices
        self.group = group
        self.steal_enabled = steal
        self.devices = list(devices)
        self.nd = len(self.devices)
        self.labels = _fleet.device_labels(self.devices)
        self.s_d = int(lanes_per_device
                       or lanes_for(len(self.idxs), self.nd))
        self.bk = self.nd * self.s_d
        self.bucket = (dict(shape_bucket) if shape_bucket is not None
                       else shared_shape_bucket(
                           [encs[i] for i in self.idxs]))
        self.params = kernel_params(self.bucket, self.bk, chunk)
        # per-shard pending queues: longest first by encoded op count
        # (assign="block" keeps the caller's order in contiguous blocks)
        self.queues = [deque() for _ in range(self.nd)]
        if assign == "block":
            per = math.ceil(len(self.idxs) / self.nd)
            for j, i in enumerate(self.idxs):
                self.queues[min(j // per, self.nd - 1)].append(i)
        else:
            load = [0.0] * self.nd
            for i in sorted(self.idxs, key=lambda i: -int(encs[i].n_ok)):
                d = load.index(min(load))
                self.queues[d].append(i)
                load[d] += int(encs[i].n_ok)
        # slot state (host side)
        self.slot_key = np.full(self.bk, -1, dtype=np.int64)
        self.slot_t0 = np.zeros(self.bk)
        self.prev_rounds = np.zeros(self.bk, dtype=np.int64)
        self.prev_expl = np.zeros(self.bk, dtype=np.int64)
        self.shard_stats = [{"keys": 0, "wall_s": 0.0, "steals": 0}
                            for _ in range(self.nd)]
        self.completed_shards: list = []
        self.events: list = []
        self.steals = 0
        self.rebuckets = 0
        self.polls = 0
        self.refills = 0
        self.resets = 0
        self.skew_before: Optional[float] = None
        self.completed_since_steal = 0
        self.results: dict = {}           # local idx -> result
        self.pending_fallback: dict = {}  # local idx -> (res, info)
        self._init_consts()

    # -- lane packing -------------------------------------------------------
    def _init_consts(self):
        p = self.params
        bk, n_pad, ic = self.bk, p["n_pad"], p["ic_pad"]
        self.c_inv = np.full((bk, n_pad), INF, dtype=np.int32)
        self.c_ret = np.full((bk, n_pad), INF, dtype=np.int32)
        self.c_opc = np.zeros((bk, n_pad), dtype=np.int32)
        self.c_suf = np.full((bk, n_pad + 1), INF, dtype=np.int32)
        self.c_iinv = np.full((bk, ic), INF, dtype=np.int32)
        self.c_iopc = np.zeros((bk, ic), dtype=np.int32)
        self.c_table = np.full((bk, p["S"], p["O"]), -1, dtype=np.int32)
        self.c_nok = np.zeros(bk, dtype=np.int32)
        self.c_ninfo = np.zeros(bk, dtype=np.int32)
        self.c_maxcfg = np.full(bk, self.max_configs, dtype=np.int32)

    def load_slot(self, sl: int, enc: Encoded) -> None:
        """Pack one key's encoding into a lane slot (the bucket pad:
        rows past the key's own length stay INF/zero)."""
        self.clear_slot(sl)
        ic = self.params["ic_pad"]
        self.c_inv[sl, :len(enc.inv)] = enc.inv
        self.c_ret[sl, :len(enc.ret)] = enc.ret
        self.c_opc[sl, :len(enc.opcode)] = enc.opcode
        self.c_suf[sl, :len(enc.sufminret)] = enc.sufminret
        w = min(len(enc.inv_info), ic)
        self.c_iinv[sl, :w] = enc.inv_info[:w]
        self.c_iopc[sl, :w] = enc.opcode_info[:w]
        s, o = enc.table.shape
        self.c_table[sl, :s, :o] = enc.table
        self.c_nok[sl] = enc.n_ok
        self.c_ninfo[sl] = enc.n_info

    def unpack_slot(self, sl: int) -> dict:
        """The inverse of `load_slot` for one lane: the packed rows
        trimmed back to the key's own length."""
        real = int((self.c_inv[sl] < INF).sum())
        return {"inv": self.c_inv[sl, :real].copy(),
                "ret": self.c_ret[sl, :real].copy(),
                "opcode": self.c_opc[sl, :real].copy(),
                "n_ok": int(self.c_nok[sl]),
                "n_info": int(self.c_ninfo[sl])}

    def clear_slot(self, sl: int) -> None:
        self.c_inv[sl] = INF
        self.c_ret[sl] = INF
        self.c_opc[sl] = 0
        self.c_suf[sl] = INF
        self.c_iinv[sl] = INF
        self.c_iopc[sl] = 0
        self.c_table[sl] = -1
        self.c_nok[sl] = 0
        self.c_ninfo[sl] = 0

    def shard_consts(self, d: int) -> wgl32.BatchConsts:
        """Shard d's block of slots as `BatchConsts` on its device."""
        sl = slice(d * self.s_d, (d + 1) * self.s_d)
        return wgl32.batch_consts_from_numpy(
            self.c_inv[sl], self.c_ret[sl], self.c_opc[sl], self.c_suf[sl],
            self.c_iinv[sl], self.c_iopc[sl], self.c_table[sl],
            self.c_nok[sl], self.c_ninfo[sl], self.c_maxcfg[sl],
            self.devices[d])

    # -- queue ops ----------------------------------------------------------
    def pack_initial(self) -> None:
        """Fill each shard's slots from its OWN queue."""
        now = _time.monotonic()
        for sl in range(self.bk):
            i = self.claim(sl // self.s_d)
            if i is None:
                continue
            self.load_slot(sl, self.encs[i])
            self.slot_key[sl] = i
            self.slot_t0[sl] = now

    def claim(self, d: int) -> Optional[int]:
        """Next key for shard d, from its own queue only: keys move
        between shards only through `maybe_steal`."""
        return self.queues[d].popleft() if self.queues[d] else None

    def _ki(self, i: int) -> int:
        return (self.key_indices[i] if self.key_indices is not None
                else i)

    def _event(self, point: dict) -> None:
        point = dict(point, group=self.group)
        if len(self.events) < EVENT_CAP:
            self.events.append(point)
        elif len(self.events) == EVENT_CAP:
            self.events.append({"event": "truncated",
                                "note": f"first {EVENT_CAP} kept"})
        _fleet.record_sched_event("mesh_sched", point)

    # -- stealing -------------------------------------------------------------
    def maybe_steal(self, *, poll: int, wall: float,
                    rnd: Optional[int] = None) -> None:
        """The one cross-shard migration pass, two triggers:

        * **idle pull**: a shard with no active lane and an empty queue
          while another queue holds more than one key pulls half of it,
          smallest first (the completed-wall skew cannot see a shard
          that never finishes);
        * **work skew**: when `fleet.summarize()` over the completed
          keys reports work_skew past REBUCKET_SKEW_X, pending keys
          move smallest-first off the busiest shard (`fleet.steal_plan`).

        `steal=False` disables both."""
        if not self.steal_enabled or self.nd < 2:
            return
        if not any(self.queues[d] for d in range(self.nd)):
            return
        idle = [d for d in range(self.nd)
                if not self.queues[d] and not any(
                    self.slot_key[d * self.s_d:(d + 1) * self.s_d] >= 0)]
        if idle:
            donor = max(range(self.nd), key=lambda q: len(self.queues[q]))
            if len(self.queues[donor]) > 1:
                tdi = idle[0]
                if self.skew_before is None and self.completed_shards:
                    self.skew_before = float(_fleet.summarize(
                        self.completed_shards).get("work_skew") or 0.0)
                moved = []
                for _ in range(max(1, len(self.queues[donor]) // 2)):
                    i = min(self.queues[donor],
                            key=lambda j: int(self.encs[j].n_ok))
                    self.queues[donor].remove(i)
                    self.queues[tdi].append(i)
                    moved.append(i)
                self.shard_stats[tdi]["steals"] += len(moved)
                self.steals += len(moved)
                self._event({"event": "steal", "reason": "idle",
                             "poll": poll, "wall_s": round(wall, 4),
                             "round": rnd,
                             "from_shard": donor, "to_shard": tdi,
                             "keys": [self._ki(i) for i in moved]})
                return
        if self.completed_since_steal <= 0:
            return
        summ = _fleet.summarize(self.completed_shards)
        skew = float(summ.get("work_skew") or 0.0)
        if skew <= _fleet.REBUCKET_SKEW_X:
            return
        walls = {self.labels[d]: self.shard_stats[d]["wall_s"]
                 for d in range(self.nd)}
        pending = {self.labels[d]: [(int(self.encs[i].n_ok), i)
                                    for i in self.queues[d]]
                   for d in range(self.nd)}
        plan = _fleet.steal_plan(pending, walls)
        if plan is None:
            return
        fdi = self.labels.index(plan["from"])
        tdi = self.labels.index(plan["to"])
        for i in plan["keys"]:
            self.queues[fdi].remove(i)
            self.queues[tdi].append(i)
        self.shard_stats[tdi]["steals"] += len(plan["keys"])
        self.steals += len(plan["keys"])
        self.completed_since_steal = 0
        if self.skew_before is None:
            self.skew_before = skew
        self._event({"event": "steal", "reason": "work-skew",
                     "poll": poll, "wall_s": round(wall, 4),
                     "round": rnd,
                     "from_shard": fdi, "to_shard": tdi,
                     "keys": [self._ki(i) for i in plan["keys"]],
                     "skew": skew,
                     "est_moved": plan["est_moved"]})

    # -- results ----------------------------------------------------------
    def retire(self, sl: int, row: np.ndarray, *, found: bool,
               empty: bool, overflow: bool, budget: bool, K: int,
               stalled: bool = False) -> None:
        """One decided (or abandoned) lane becomes a per-key result.
        Keys whose device verdict stays "unknown" and that are owed an
        oracle fallback are parked in `pending_fallback`; a lane of a
        stalled run carries its partial progress."""
        i = int(self.slot_key[sl])
        self.slot_key[sl] = -1
        e = self.encs[i]
        di = sl // self.s_d
        wall = _time.monotonic() - self.slot_t0[sl]
        stats = row[4:10]
        rounds = int(stats[5])
        n_total = int(e.n_ok + e.n_info)
        detail = {
            "W": e.window_raw, "W_pad": self.params["W"], "K": K,
            "configs_explored": int(stats[0]),
            "util": {
                "rounds": rounds,
                "frontier_fill": round(
                    int(stats[0]) / max(rounds * K, 1), 4),
                "memo_hit_rate": _occ.memo_hit_rate(int(stats[3]),
                                                   int(stats[4]))},
            "occupancy": {
                "lane": sl, "K": K,
                "fill_last": round(int(row[0]) / max(K, 1), 4),
                "rounds": rounds,
                "hint": _adapt.recommend(
                    self.params["ladder"],
                    int(stats[0]) / max(rounds, 1))},
            "mesh": {"shard": di, "slot": sl, "group": self.group}}
        if found:
            res = {"valid?": True, "op_count": n_total, **detail}
        elif empty and not overflow:
            res = {"valid?": False, "op_count": n_total,
                   "max_linearized": int(stats[2]), **detail}
        else:
            cause = ("stalled" if stalled
                     else "backlog-overflow" if overflow
                     else "config-limit" if budget else "timeout")
            res = {"valid?": "unknown", "cause": cause,
                   "op_count": n_total, **detail}
            if stalled:
                res["partial"] = {"configs_explored": int(stats[0]),
                                  "rounds": rounds,
                                  "ops_linearized": int(stats[2])}
        info = {"key_index": self._ki(i), "device": self.labels[di],
                "device_index": di, "t0": self.slot_t0[sl],
                "wall_s": wall,
                "extra": {"rounds": rounds,
                          "configs_explored": int(stats[0])}}
        self.shard_stats[di]["keys"] += 1
        self.shard_stats[di]["wall_s"] = round(
            self.shard_stats[di]["wall_s"] + wall, 4)
        self.completed_shards.append(
            {"device": self.labels[di], "wall_s": wall,
             "key_index": info["key_index"], "t0": self.slot_t0[sl]})
        self.completed_since_steal += 1
        if res.get("valid?") == "unknown" and self.oracle_fallback \
                and res.get("cause") in ("backlog-overflow",
                                         "config-limit"):
            self.pending_fallback[i] = (res, info)
            return
        self.results[i] = _annotate_shard(
            res, key_index=info["key_index"], device=info["device"],
            device_index=di, engine="device-mesh", t0=info["t0"],
            wall_s=wall, extra=info["extra"])

    def summary(self, k_final: int) -> dict:
        fin = _fleet.summarize(self.completed_shards)
        return {"group": self.group, "n_devices": self.nd,
                "lanes_per_device": self.s_d,
                "keys": len(self.idxs),
                "K_final": k_final, "ladder": list(self.params["ladder"]),
                "polls": self.polls, "refills": self.refills,
                "resets": self.resets, "pool_hit": self.pool_hit,
                "steals": self.steals, "rebuckets": self.rebuckets,
                "work_skew_before": self.skew_before,
                "work_skew_after": fin.get("work_skew"),
                "rebucket_hint": _fleet.compact_hint(
                    fin.get("rebucket_hint")),
                "per_shard": {self.labels[d]: dict(self.shard_stats[d])
                              for d in range(self.nd)},
                "events": list(self.events)}


def check_mesh(model: Model, histories: Sequence[History], *,
               encs: Sequence[Encoded],
               time_limit: Optional[float] = None,
               max_configs: int = 50_000_000,
               devices=None, oracle_fallback: bool = True,
               key_indices: Optional[Sequence[int]] = None,
               chunk: int = 1024,
               lanes_per_device: Optional[int] = None,
               assign: str = "lpt", steal: bool = True,
               shape_bucket: Optional[dict] = None,
               n_devices: Optional[int] = None) -> Optional[list]:
    """Check `histories` (all encodable: the caller decides the rest on
    the host, as `check_batched` does) over a device list with the lane
    scheduler. `devices=None` is every visible card (the first
    `n_devices` of them), raising without one; a named list may repeat
    a device. Returns one result per history, in order, or None when
    the mesh path does not apply (fewer than 2 keys or 2 devices, or a
    forced `shape_bucket` that does not cover the batch): None means
    "take the one-device path", never a failure."""
    max_configs = min(max_configs, 2**30)
    if len(encs) < 2:
        return None
    devs = (default_devices(n_devices) if devices is None
            else resolve_devices(devices))
    nd = len(devs)
    if nd < 2:
        return None
    deadline = _time.monotonic() + time_limit if time_limit else None

    groups = [("narrow", [i for i, e in enumerate(encs)
                          if e.window_raw <= 32]),
              ("wide", [i for i, e in enumerate(encs)
                        if e.window_raw > 32])]
    groups = [(g, idxs) for g, idxs in groups if idxs]
    # a forced bucket only applies to a single-branch batch it covers
    if shape_bucket is not None:
        derived = shared_shape_bucket(list(encs))
        forced_wide = int(shape_bucket["w_eff"]) > 32
        covers = all(int(shape_bucket[k]) >= int(derived[k])
                     for k in ("n_pad", "ic_eff", "S", "O", "w_eff"))
        if (len(groups) != 1 or not covers
                or forced_wide != (groups[0][0] == "wide")):
            return None

    # admission (analysis/preflight): the mesh plan's lane groups, each
    # card billed for the lane slots of every shard it holds. An
    # infeasible group degrades the whole request (None: check_batched
    # takes its one-device decision, whose own gates re-decide with
    # fewer lanes), before the first carry is made.
    s_d_plan = int(lanes_per_device
                   or lanes_for(max(len(i) for _, i in groups), nd))
    bad = preflight.gate_mesh(list(encs), n_devices=nd,
                              lanes_per_device=s_d_plan,
                              where="parallel.mesh", devices=devs,
                              shape_bucket=shape_bucket)
    if bad is not None:
        return None

    # the planes, as in the reference: the live status, the metrics
    # registry, the watchdog and the device monitor (each free when off)
    planes = (_fleet.get_default(), _metrics.get_default(),
              _watchdog.get_default(), _devices.get_default())
    t0_all = _time.monotonic()
    results: list = [None] * len(histories)
    run_summaries: list = []
    for gname, idxs in groups:
        gr = _GroupRun(encs, idxs, devs, chunk=chunk,
                       lanes_per_device=lanes_per_device,
                       assign=assign, deadline=deadline,
                       max_configs=max_configs,
                       oracle_fallback=oracle_fallback,
                       key_indices=key_indices, group=gname,
                       steal=steal, shape_bucket=shape_bucket,
                       pooled=devices is not None)
        k_final = _run_group(gr, t0_all, planes)
        run_summaries.append(gr.summary(k_final))
        for i, res in gr.results.items():
            results[i] = res
        # oracle fallback for kernel-unknown keys, inside what remains
        # of the deadline (competition semantics, annotated once)
        for i, (res, info) in gr.pending_fallback.items():
            out = _oracle_fallback(model, histories[i], deadline, res)
            results[i] = _annotate_shard(
                out, key_index=info["key_index"], device=info["device"],
                device_index=info["device_index"],
                engine=str(out.get("engine") or "device-mesh"),
                t0=info["t0"], wall_s=_time.monotonic() - info["t0"],
                extra=info["extra"])

    total = {
        "wall_s": round(_time.monotonic() - t0_all, 4),
        "n_devices": nd,
        "devices": _fleet.device_labels(devs),
        "keys": len(histories),
        "steals": sum(s["steals"] for s in run_summaries),
        "rebuckets": sum(s["rebuckets"] for s in run_summaries),
        "polls": sum(s["polls"] for s in run_summaries),
        "refills": sum(s["refills"] for s in run_summaries),
        "resets": sum(s["resets"] for s in run_summaries),
        "work_skew_before": next(
            (s["work_skew_before"] for s in run_summaries
             if s.get("work_skew_before") is not None), None),
        "work_skew_after": next(
            (s["work_skew_after"] for s in run_summaries
             if s.get("work_skew_after") is not None), None),
        "groups": run_summaries,
        "per_shard": _merge_shards(run_summaries),
    }
    _record_run(total)
    return results


def _merge_shards(summaries: list) -> dict:
    out: dict = {}
    for s in summaries:
        for dev, row in (s.get("per_shard") or {}).items():
            d = out.setdefault(dev, {"keys": 0, "wall_s": 0.0, "steals": 0})
            d["keys"] += row.get("keys", 0)
            d["wall_s"] = round(d["wall_s"]
                                + float(row.get("wall_s") or 0.0), 4)
            d["steals"] += row.get("steals", 0)
    return out


def _run_group(gr: _GroupRun, t0_all: float, planes: tuple) -> int:
    """The scheduler loop for one lane group. Returns the final K.
    `planes` is (RunStatus, metrics registry, watchdog, device monitor):
    a heartbeat a poll (a soft cancel ends the run with every undecided
    key "stalled", its partial progress kept), the allocator sampled a
    poll on each card once, and with metrics on the lanes' fill and
    hints (`wgl_batched_lanes`) and drained rounds
    (`wgl_batched_rounds`)."""
    status, mx, wd, dm = planes
    p = gr.params
    ladder = p["ladder"]
    K = ladder[0]
    W, L, ic, H, B = p["W"], p["L"], p["ic_pad"], p["H"], p["B"]
    C = wgln.row_words(L, ic) if L else wgl32.row_words(ic)
    mst_col = 1 + L if L else 2
    kern = "wgln" if L else "wgl32"
    s_d, nd = gr.s_d, gr.nd
    streams = shard_streams(gr.devices)
    cards = _devices.distinct(gr.devices)
    gr.pack_initial()

    def step(consts, carry, K):
        if L:
            return wgln.chunk_batched(consts, carry, K=K, L=L, ic=ic, H=H,
                                      B=B, chunk=p["chunk"],
                                      probes=p["probes"])
        return wgl32.chunk_batched(consts, carry, K=K, W=W, ic=ic, H=H, B=B,
                                   chunk=p["chunk"], probes=p["probes"])

    # the starting carries come pre-zeroed from the pool when a warm or
    # the previous run over this bucket and device list stocked them
    pool_key = (_pool_key(p, K, gr.devices, gr.bk) if gr.pooled
                else None)
    pooled = _pool_take(pool_key) if pool_key is not None else None
    consts, carries = [], []
    for d in range(nd):
        with on_stream(streams[d]):
            consts.append(gr.shard_consts(d))
            carries.append(
                _pool_adopt(pooled, d, streams[d]) if pooled is not None
                else wgl32.init_carry_batch(s_d, K, C, H, B, 0,
                                            gr.devices[d], mst_col=mst_col))
    gr.pool_hit = pooled is not None
    del pooled
    hb = wd.register("wgl-mesh", device=f"mesh[{nd}]", grace_s=300.0)
    dmark = dm.mark(where="mesh", devices=cards) if dm.enabled else None
    timed_out = stalled = False
    sparse_streak = 0
    occ_budget = LANE_ROUNDS_BUDGET
    s = None
    summaries: list = []
    try:
        while True:
            if wd.cancelled(hb):
                stalled = True
                break
            t_poll = _time.monotonic()
            # every shard's launch before any shard's summary is read
            summaries = []
            for d in range(nd):
                with on_stream(streams[d]):
                    carries[d], sm = step(consts[d], carries[d], K)
                summaries.append(sm)
            parts = []
            for d in range(nd):
                with on_stream(streams[d]):
                    # kernellint: ok(K007) — each shard's one poll read
                    parts.append(summaries[d].cpu().numpy())
            s = np.concatenate(parts)
            gr.polls += 1
            wall = _time.monotonic() - t0_all
            if dmark is not None:
                dm.sample(where="mesh", mx=mx, devices=cards)
            fr_cnt, flags, stats = s[:, 0], s[:, 1:4], s[:, 4:10]
            found = flags[:, 0] != 0
            overflow = flags[:, 1] != 0
            empty = fr_cnt == 0
            budget = stats[:, 0] >= gr.max_configs
            active = gr.slot_key >= 0
            decided = active & (found | empty | budget)
            live = active & ~decided

            # per-lane deltas (rebucket hints) BEFORE retirement
            r_delta = np.maximum(
                stats[:, 5].astype(np.int64) - gr.prev_rounds, 0)
            e_delta = np.maximum(stats[:, 0].astype(np.int64)
                                 - gr.prev_expl, 0)
            occupied = np.where(r_delta > 0,
                                e_delta / np.maximum(r_delta, 1), 0.0)
            if mx.enabled:
                occ_budget = _record_lanes(
                    mx, s, poll=gr.polls - 1, wall_s=wall, K=K, kern=kern,
                    fill_lanes=np.arange(gr.bk),
                    drain_lanes=np.nonzero(active)[0], live=live,
                    hints=[_adapt.recommend(ladder, float(occupied[sl]))
                           for sl in range(gr.bk)],
                    prev_rounds=gr.prev_rounds, budget=occ_budget,
                    device_of=lambda sl: sl // s_d,
                    extra={"scheduler": "mesh"})
            gr.prev_expl = stats[:, 0].astype(np.int64)
            prev_rounds_next = stats[:, 5].astype(np.int64)
            n_act = int(active.sum())
            wd.beat(hb, live_keys=int(live.sum()),
                    decided_keys=len(gr.results) + len(gr.pending_fallback),
                    configs_explored=int(stats[active, 0].sum()))
            if status.enabled:
                status.search_poll({
                    "mode": "mesh-sched", "kernel": kern, "K": K,
                    "frontier": int(fr_cnt[active].sum()),
                    "backlog": int(s[active, 10].sum()),
                    "explored": int(stats[active, 0].sum()),
                    "poll_s": round(_time.monotonic() - t_poll, 4)},
                    search_id="mesh")
                af = (fr_cnt[active] / max(K, 1) if n_act
                      else np.zeros(1))
                status.occupancy_poll({
                    "mode": "mesh", "kernel": kern,
                    "platform": f"mesh[{nd}]", "K": K,
                    "fill_last": round(float(af.mean()), 4),
                    "fill_mean": round(float(af.mean()), 4),
                    "lanes": {"n": n_act,
                              "fill_min": round(float(af.min()), 4),
                              "fill_max": round(float(af.max()), 4),
                              "empty": int((fr_cnt[active] == 0).sum())}},
                    search_id="mesh")

            for sl in np.nonzero(decided)[0]:
                gr.retire(int(sl), s[sl], found=bool(found[sl]),
                          empty=bool(empty[sl]),
                          overflow=bool(overflow[sl]),
                          budget=bool(budget[sl]), K=K)

            # act on the skew telemetry, then refill every idle slot (a
            # key stolen into an idle shard's queue is picked up at once)
            rnd_now = int(stats[:, 5].max()) if len(stats) else 0
            gr.maybe_steal(poll=gr.polls - 1, wall=wall, rnd=rnd_now)
            refill_mask = np.zeros(gr.bk, dtype=bool)
            now = _time.monotonic()
            for sl in np.nonzero(gr.slot_key < 0)[0]:
                i = gr.claim(int(sl) // s_d)
                if i is None:
                    continue
                gr.load_slot(int(sl), gr.encs[i])
                gr.slot_key[sl] = i
                gr.slot_t0[sl] = now
                refill_mask[sl] = True
                prev_rounds_next[sl] = 0
                gr.prev_expl[sl] = 0
            gr.prev_rounds = prev_rounds_next
            gr.refills += int(refill_mask.sum())

            # re-bucket through the ladder on the live lanes' hints
            # (lanes refilled this poll carry a stale occupant's
            # occupancy: they do not vote)
            voters = (gr.slot_key >= 0) & ~refill_mask & live
            if voters.any() and gr.rebuckets < MAX_REBUCKETS:
                want = max(_adapt.recommend(ladder, float(occupied[sl]))
                           for sl in np.nonzero(voters)[0])
                switch_to = None
                if want > K:
                    switch_to = want
                    sparse_streak = 0
                elif want < K:
                    # shrink only when every still-expanding lane's
                    # frontier fits the smaller beam
                    fits = bool((fr_cnt[~found] <= want).all())
                    sparse_streak = sparse_streak + 1 if fits else 0
                    if sparse_streak >= 2:
                        switch_to = want
                        sparse_streak = 0
                else:
                    sparse_streak = 0
                if switch_to is not None:
                    for d in range(nd):
                        with on_stream(streams[d]):
                            carries[d] = migrate_lanes(carries[d],
                                                       switch_to)
                    gr.rebuckets += 1
                    gr._event({"event": "rebucket", "poll": gr.polls - 1,
                               "wall_s": round(wall, 4), "round": rnd_now,
                               "from_K": K, "to_K": switch_to,
                               "reason": ("explored-threshold"
                                          if switch_to > K
                                          else "sparse-frontier")})
                    K = switch_to

            if refill_mask.any():
                for d in range(nd):
                    m = refill_mask[d * s_d:(d + 1) * s_d]
                    if not m.any():
                        continue
                    # re-send only the consts of a shard with a refilled
                    # slot
                    with on_stream(streams[d]):
                        consts[d] = gr.shard_consts(d)
                        reset_lanes(carries[d], m, mst_col=mst_col)
                    gr.resets += 1

            if not (gr.slot_key >= 0).any() \
                    and not any(gr.queues[d] for d in range(nd)):
                break
            if gr.deadline is not None and _time.monotonic() > gr.deadline:
                timed_out = True
                break
    finally:
        wd.unregister(hb)
        if dmark is not None:
            dm.measured(dmark, where="mesh", devices=cards)

    if pool_key is not None and not (stalled or timed_out):
        # this run's carries go first, so that the fill never holds a
        # second set beside them; it runs off-thread, for the next run
        carries.clear()
        summaries.clear()
        _restock(pool_key, lambda: _pool_build(
            gr.devices, s_d, ladder[0], C, H, B, mst_col))

    # keys the loop never decided (deadline, stall): report partials,
    # never silence: active slots off the last summary, pending keys as
    # plain timeouts or stalls
    if timed_out or stalled:
        cause = "stalled" if stalled else "timeout"
        for sl in np.nonzero(gr.slot_key >= 0)[0]:
            row = s[sl] if s is not None else np.zeros(
                wgl32.SUMMARY_HEAD, dtype=np.int32)
            gr.retire(int(sl), row, found=False, empty=False,
                      overflow=False, budget=False, K=K, stalled=stalled)
        for d in range(nd):
            while gr.queues[d]:
                i = gr.queues[d].popleft()
                res = {"valid?": "unknown", "cause": cause,
                       "op_count": int(gr.encs[i].n_ok + gr.encs[i].n_info)}
                gr.results[i] = _annotate_shard(
                    res, key_index=gr._ki(i), device=gr.labels[d],
                    device_index=d, engine="none", t0=_time.monotonic(),
                    wall_s=0.0)
    return K


# -- word-column sharding (the Elle closure's layout) ------------------------

def word_shard_count(w: int, n_devices: Optional[int] = None) -> int:
    """How many shards the packed Elle closure's W = n/32 word columns
    split into: the largest power of two that divides W exactly (a
    ragged block would break the 32-column scan and with it the
    bit-identity with the packed closure) and fits the device count.
    `n_devices=None` counts the visible cards (none: 1, unsharded)."""
    if n_devices is None:
        n_devices = (torch.cuda.device_count()
                     if torch.cuda.is_available() else 1)
    w = int(w)
    nd = max(1, int(n_devices))
    ns = 1
    while ns * 2 <= nd and w % (ns * 2) == 0:
        ns *= 2
    return ns
