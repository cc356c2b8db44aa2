"""Wide-window WGL chunk (32 < W <= 1024) on the H100: the window as L
uint32 lanes.

The port of `jepsen_tpu/ops/wgln.py::_build_searchN -> chunk_fn` with
its host-layout semantics (`accel=False, compact=False`). A
configuration is one packed int32 row `[base, win lanes..., mst, info
words...]` of `row_words(L, ic)` words:

  * window slot j lives in lane j // 32, bit j % 32; setting it is
    `lane[j // 32] |= 1 << (j % 32)`
  * renormalize: t = 32 q + r trailing ones, where q is the first lane
    that is not all ones (L when every lane is full) and r that lane's
    trailing ones; the window shifts right by t across lanes,
    `shifted[l] = (w[l+q] >> r) | (w[l+q+1] << (32 - r))` with lanes
    past L read as 0 (r == 0 takes `w[l+q]` alone), and base += t
  * crashed ops: one uint32 word per 32 info ops, as in `wgl32`

Everything after the successor rows are built (hash, memo probe and
insert, compaction, spill, refill, flags, stats, ring) is `wgl32`'s,
and so is the carry: the same 8-tuple with a wider `fr`/`bk` row, so
`wgl32.carry_from_numpy`/`carry_to_numpy` and `adapt.migrate_frontier`
carry it unchanged. Consts are `wgl32.Consts`.

Two implementations of the same function live here:

  * `chunk_ref` — plain PyTorch, the spec, held bit for bit against the
    JAX `chunk_fn` by the CPU tests (uint32 math in int64 masked to 32
    bits).
  * `chunk` — the wrapper: a CUDA tensor goes to the hand-written
    kernel `csrc/wgln_chunk.cu`, in the launch form `solo_form` picks
    by shape (one CTA while the round is short and fits in shared
    memory, else the grid form); a CPU tensor goes to the host kernel
    `csrc/wgl_host.cpp` (`wgln_host_chunk`). There is no fallback
    between the three, and `chunk_ref` runs in tests only. All update
    the carry in place.

The lane-batched pair (`chunk_batched_ref`, `chunk_batched` on the
`wgln_chunk_batched` kernel, in the form `batched_form` picks: one
thread-block cluster per lane where the lanes leave SMs idle and a
lane's round is long, else one CTA per lane; or on the CPU
`wgln_host_chunk_batched`, the lanes in turn) runs one chunk on every
lane of a padded batch of keys, as the JAX package's wide
`jit(vmap(chunk_fn))` does; consts are `wgl32.BatchConsts`.
"""

from __future__ import annotations

import torch

from . import wgl32
from .wgl32 import FR, Consts, _ctz32, _M32, _to_i32

MIN_LANES, MAX_LANES = 2, 32

# The solo wide search's crossover: a round of at least this many
# successor rows runs the grid form (csrc/wgl_common.cuh); so does a
# smaller round that one CTA could not keep in shared memory. Measured
# on the card by chip_smoke.py, both forms in turns (PERF.md row 3): on
# the 16-wave (L 3) one CTA in shared memory 13.67 / 19.12 / 23.98 us a
# round against the grid's 19.28 / 19.63 / 19.50 at 1664 / 2496 / 3328
# rows; on the long tail (L 21) one CTA 21.99 us (shared) against 35.59
# at 1360 rows, then 61.94 (global) against 44.11 at 2040 and 77.96
# against 40.41 at 2720. The grid holds ~20 us at L 3 and ~40 at L 21;
# one CTA wins only while its round is in shared memory and short.
GRID_MIN_ROWS = 3072

# The lane-batched wide search's crossover: a lane's round of at least
# this many successor rows runs the cluster form (csrc/wgl_common.cuh,
# one cluster of g CTAs a lane) where the card has room for it; so does
# a smaller round that one CTA could not keep in shared memory.
# Measured on the card by scripts/wgln_cluster_turns.py, both forms in
# turns (PERF.md row 9), us a round, one CTA in shared memory against
# the best cluster: 8 fan-out wave lanes (L 2) 18.09 against 18.41 (g 8)
# at 2304 rows, 23.74 against 18.33 at 3456; 2 lanes 16.66 against
# 16.47 (g 16) at 2304, 22.41 against 16.22 at 3456; 2 16-wave lanes
# (L 3) 12.84 against 16.24 at 1664, 21.72 against 16.97 at 3328. Past
# shared memory one CTA loses at every size measured (73.86 against
# 25.54 at 9216 rows, 578.95 against 99.95 at 73,728). The cluster
# gains up to the largest g whose clusters are all resident at once,
# however few rows each CTA gets (2 lanes at 4608 rows: g 4 25.01, g 8
# 18.94, g 16 17.71), and loses where a lane waits for a second wave
# (8 lanes: g 8 99.95, g 16 122.17 with 7 clusters of 16 resident).
CLUSTER_MIN_ROWS = 3072


def row_words(L: int, ic: int) -> int:
    """C: int32 words of one packed config row of L window lanes and
    `ic` info slots: [base, L lanes, mst, Il info words]."""
    return 2 + L + max(1, (ic + 31) // 32)


def init_carry(K: int, L: int, ic: int, H: int, B: int, mstate0: int,
               device) -> tuple:
    """The search's start (JAX `init_fn`): one frontier row (base 0,
    empty window, model state `mstate0`), an empty memo table and
    backlog."""
    return wgl32.init_carry(K, row_words(L, ic), H, B, mstate0, device,
                            mst_col=1 + L)


def init_carry_batch(lanes: int, K: int, L: int, ic: int, H: int, B: int,
                     mstate0, device) -> tuple:
    """`init_carry` of every lane, each leaf with a leading lane axis
    (the JAX package's `vmap(init_fn)`)."""
    return wgl32.init_carry_batch(lanes, K, row_words(L, ic), H, B, mstate0,
                                  device, mst_col=1 + L)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _round_ref(c: Consts, fr, sc: dict, bk, table, ring, *, K, L, ic, H,
               B, probes):
    """One wide-window round (JAX `round_body`); the tail after the
    successor rows is `wgl32.finish_round`."""
    dev = fr.device
    i64 = torch.int64
    W = 32 * L
    f = fr.to(i64)
    base = f[:, 0]
    win = f[:, 1:1 + L] & _M32                                # (K, L)
    mst = f[:, 1 + L]
    info = f[:, 2 + L:] & _M32                                # (K, Il)
    j = torch.arange(W, device=dev, dtype=i64)
    lane_of_j, bit_of_j = j // 32, j % 32
    linearized = ((win[:, lane_of_j] >> bit_of_j) & 1) == 1  # (K, W)
    legal_ok, legal_info, nst_ok, nst_info = wgl32.candidates(
        c, base, mst, info, linearized, sc["fr_cnt"], K=K, W=W, ic=ic,
        reach=sc.get("reach"))

    # --- ok successors: set bit j, then funnel-shift right -------------
    set_mask = torch.zeros((W, L), dtype=i64, device=dev)
    set_mask[j, lane_of_j] = torch.ones_like(j) << bit_of_j
    win_ok = win[:, None, :] | set_mask[None]                 # (K, W, L)
    full = win_ok == _M32
    all_full = full.all(dim=2)
    # q: the first lane with a zero bit (JAX argmin over `full`), L when
    # every lane is full
    q = (~full).to(torch.int8).argmax(dim=2).to(i64)          # (K, W)
    q = torch.where(all_full, torch.full_like(q, L), q)
    lane_q = win_ok.gather(2, q.clamp(max=L - 1)[..., None]).squeeze(2)
    r = _ctz32(~lane_q & _M32)
    r = torch.where(all_full, torch.zeros_like(r), r)
    t = q * 32 + r                                            # (K, W)
    padded = torch.cat([win_ok, torch.zeros_like(win_ok)], dim=2)
    src0 = torch.arange(L, device=dev, dtype=i64) + q[..., None]
    g0 = padded.gather(2, src0.clamp(max=2 * L - 1))
    g1 = padded.gather(2, (src0 + 1).clamp(max=2 * L - 1))
    ru = r[..., None]
    # r == 0 takes g0 alone: a 32-bit shift is no funnel shift
    shifted = torch.where(ru == 0, g0,
                          ((g0 >> ru) | (g1 << (32 - ru))) & _M32)
    base_ok = base[:, None] + t

    base_s = torch.cat([base_ok.reshape(-1), base.repeat_interleave(ic)])
    win_s = torch.cat([shifted.reshape(-1, L),
                       win.repeat_interleave(ic, dim=0)])     # (R, L)
    mst_s = torch.cat([nst_ok.reshape(-1), nst_info.reshape(-1)])
    info_s = wgl32.info_successors(info, K=K, W=W, ic=ic)
    legal = torch.cat([legal_ok.reshape(-1), legal_info.reshape(-1)])

    success = legal & (base_s >= c.n_ok) & (win_s == 0).all(dim=1)
    words = ([base_s & _M32] + [win_s[:, i] for i in range(L)]
             + [mst_s & _M32] + [info_s[:, i] for i in range(info_s.shape[1])])
    succ = torch.stack([_to_i32(w) for w in words], dim=1)
    return wgl32.finish_round(sc, bk, table, ring, words=words, succ=succ,
                              legal=legal, success=success, base_s=base_s,
                              K=K, H=H, B=B, probes=probes)


def chunk_ref(consts: Consts, carry, *, K: int, L: int, ic: int, H: int,
              B: int, chunk: int, probes: int, tally: dict | None = None):
    """Plain PyTorch chunk of the wide search (see `wgl32.chunk_ref`):
    up to `chunk` rounds; updates `carry` in place; returns (carry,
    summary). `tally` gets `wgl32.run_chunk`'s sums."""
    def round_fn(c, fr, sc, bk, table, ring):
        return _round_ref(c, fr, sc, bk, table, ring, K=K, L=L, ic=ic, H=H,
                          B=B, probes=probes)

    return wgl32.run_chunk(consts, carry, round_fn, chunk=chunk, tally=tally)


def chunk_batched_ref(consts: wgl32.BatchConsts, carry, *, K: int, L: int,
                      ic: int, H: int, B: int, chunk: int, probes: int,
                      tally: dict | None = None):
    """Plain PyTorch lane-batched chunk of the wide search: `chunk_ref`
    on every lane (the JAX package's wide `jit(vmap(chunk_fn))`).
    Updates `carry` in place; returns (carry, summary (lanes, ...))."""
    return wgl32.run_lanes(consts, carry, lambda c, lc: chunk_ref(
        c, lc, K=K, L=L, ic=ic, H=H, B=B, chunk=chunk, probes=probes,
        tally=tally))


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def solo_form(K: int, L: int, ic: int) -> wgl32.Form:
    """The launch form of a solo wide chunk, by shape alone:
    `wgl32.block_form` while it keeps the round in shared memory and the
    round has fewer than GRID_MIN_ROWS successor rows, else the grid
    form (asking for one block per 1024 rows; the card caps it at what
    every SM holds at once)."""
    W = 32 * L
    R = K * (W + ic)
    one = wgl32.block_form(K, W, ic, row_words(L, ic))
    if one.name == "shared" and R < GRID_MIN_ROWS:
        return one
    return wgl32.Form("grid", wgl32.MAX_THREADS, -(-R // wgl32.MAX_THREADS))


def batched_form(lanes: int, K: int, L: int, ic: int, *, sms: int,
                 capacity: dict) -> wgl32.Form:
    """The launch form of a lane-batched wide chunk of `lanes` lanes on a
    card of `sms` SMs, by shape: one CTA a lane (`wgl32.block_form`)
    while a lane's round has fewer than CLUSTER_MIN_ROWS successor rows
    and fits in shared memory; else the cluster form with g CTAs a lane,
    g the largest power of two up to `wgl32.MAX_CLUSTER` such that
    `lanes` x g <= `sms` and every lane's cluster is resident at once
    (`capacity`: {g: clusters of g CTAs the card holds at once},
    `card_shape`); one CTA a lane when no g >= 2 is (the lanes fill the
    card)."""
    W = 32 * L
    R = K * (W + ic)
    one = wgl32.block_form(K, W, ic, row_words(L, ic))
    if one.name == "shared" and R < CLUSTER_MIN_ROWS:
        return one
    g = wgl32.MAX_CLUSTER
    while g >= 2:
        if lanes * g <= sms and capacity.get(g, 0) >= lanes:
            return wgl32.Form("cluster", wgl32.MAX_THREADS, g)
        g //= 2
    return one


_CARDS: dict = {}


def card_shape(dev) -> tuple:
    """(SMs, {g: clusters of g CTAs of the cluster form the card holds
    at once}) of CUDA device `dev`, read once a device: the capacities
    from `cudaOccupancyMaxActiveClusters` through the kernel's library
    (`wgln_chunk_cluster_fit`)."""
    import ctypes

    from . import _native

    dev = torch.device(dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    shape = _CARDS.get(idx)
    if shape is None:
        out = ctypes.c_int32(0)
        cap = {}
        with torch.cuda.device(idx):
            g = 2
            while g <= wgl32.MAX_CLUSTER:
                _native.launch("wgln_chunk_cluster_fit",
                               [ctypes.addressof(out)], [g], None)
                cap[g] = out.value
                g *= 2
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        shape = _CARDS[idx] = (sms, cap)
    return shape


def _check_launch(consts, carry, *, K, L, ic, H, B, chunk, probes,
                  lanes=None):
    if not MIN_LANES <= L <= MAX_LANES:
        raise ValueError(f"wgln lane count L={L} outside "
                         f"[{MIN_LANES}, {MAX_LANES}]")
    wgl32.check_launch(consts, carry, K=K, W=32 * L, C=row_words(L, ic),
                       ic=ic, H=H, B=B, chunk=chunk, probes=probes,
                       lanes=lanes)


def chunk(consts: Consts, carry, *, K: int, L: int, ic: int, H: int,
          B: int, chunk: int, probes: int,
          cancel: wgl32.CancelFlag | None = None):
    """One chunk of the wide search (see `chunk_ref`). CUDA tensors run
    the `wgln_chunk` kernel in `solo_form` (one launch per call,
    counted in `chunk.launches`); CPU tensors run the host kernel
    `wgln_host_chunk` (counted in `chunk.host_calls`), which ends the
    chunk after the round in which `cancel` is set. Updates `carry` in
    place; returns (carry, summary)."""
    dev = carry[FR].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"wgln chunk: unsupported device {dev}")
    _check_launch(consts, carry, K=K, L=L, ic=ic, H=H, B=B, chunk=chunk,
                  probes=probes)
    if dev.type == "cpu":
        summary = wgl32.host_chunk("wgln_host_chunk", consts, carry, K=K,
                                   W=32 * L, L=L, ic=ic, H=H, B=B,
                                   chunk=chunk, probes=probes, cancel=cancel)
        _count_host()
    else:
        summary = wgl32.launch("wgln_chunk", consts, carry, K=K, W=32 * L,
                               L=L, ic=ic, H=H, B=B, rounds=chunk,
                               probes=probes, form=solo_form(K, L, ic))
        _count_launch()
    return carry, summary


chunk.launches = 0
chunk.host_calls = 0


def _count_launch():
    # inside `chunk` the name is its round-count parameter
    chunk.launches += 1


def _count_host():
    chunk.host_calls += 1


def chunk_batched(consts: wgl32.BatchConsts, carry, *, K: int, L: int,
                  ic: int, H: int, B: int, chunk: int, probes: int):
    """One wide chunk on every lane (see `chunk_batched_ref`). CUDA
    tensors run the `wgln_chunk_batched` kernel in the form
    `batched_form` picks for the card (one launch per call, counted in
    `chunk_batched.launches`); CPU tensors run the host kernel
    `wgln_host_chunk_batched` (counted in `chunk_batched.host_calls`).
    Updates `carry` in place; returns (carry, summary (lanes, ...))."""
    dev = carry[FR].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"wgln chunk_batched: unsupported device {dev}")
    _check_launch(consts, carry, K=K, L=L, ic=ic, H=H, B=B, chunk=chunk,
                  probes=probes, lanes=consts.lanes)
    if dev.type == "cpu":
        summary = wgl32.host_chunk_batched(
            "wgln_host_chunk_batched", consts, carry, K=K, W=32 * L, L=L,
            ic=ic, H=H, B=B, chunk=chunk, probes=probes)
        chunk_batched.host_calls += 1
    else:
        sms, cap = card_shape(dev)
        summary = wgl32.launch_batched(
            "wgln_chunk_batched", consts, carry, K=K, W=32 * L, L=L, ic=ic,
            H=H, B=B, rounds=chunk, probes=probes,
            form=batched_form(consts.lanes, K, L, ic, sms=sms, capacity=cap))
        chunk_batched.launches += 1
    return carry, summary


chunk_batched.launches = 0
chunk_batched.host_calls = 0
