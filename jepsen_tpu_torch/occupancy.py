"""Analytic cost of the port's kernels: bytes and operations.

The cost half of the JAX package's `jepsen_tpu/occupancy.py`. The
reference reads XLA's `Lowered.cost_analysis`; the port has no compiler
to ask, so every number here is an analytic count of the port's own
kernels, computed from shapes and, where the work depends on the data,
from what a run's plain version tallied:

  * resident bytes: the carry, scratch, summary and consts a WGL search
    keeps on the card (`wgl_state_bytes`) and an Elle closure's buffers
    (`elle_closure_bytes`), which the admission plane
    (`analysis/preflight.py`) bills a plan by, beside its per-round
    cost cache (`cost_for`, `cost_cached`) and the fill target;
  * least traffic and operations of one launch, which `chip_smoke.py`
    reads for its `bound_ms` columns: a WGL chunk (`wgl_chunk_bytes`,
    `batched_chunk_bytes`, `wgl_bool_chunk_bytes`), a dense, packed or
    sharded closure squaring (`dense_square_cost`, `packed_square_cost`,
    `sharded_square_cost`; the packed ones' tensor-core work from their
    tile flags, `bitmm_steps`), the trim (`trim_bytes`, `trim_work`,
    `trim_input_bytes`, `trim_alloc_bytes`);
  * the card's peaks (`PEAKS`, keyed by `torch.cuda.get_device_name`)
    and `bound_ms`, which turns bytes and operations into a least time.

and the per-round half of the reference's module, which the telemetry
plane reads (`ops/wgl.py` when metrics are on, `parallel/mesh.py`):

  * `drain_chunk` turns one packed poll summary's occupancy ring into
    per-round dicts (the ring rides the summary the search already
    copies to the host: no extra transfer); `memo_hit_rate` is the one
    hits / (hits + inserts); `build_block` folds drained rounds into a
    search's `occupancy` result block;
  * `roofline` sets the search's measured round time against the least
    time its bytes take at the card's peak, the bytes from the port's
    own count of a chunk (`search_bytes`, over `wgl_chunk_bytes`), not
    the reference's memo-stream model; `safe_device_kind` names the
    card; `per_shard_cost` scales a cost to one shard of the sharded
    Elle closure;
  * `perfetto_counter_tracks` turns the series a run recorded into the
    counter tracks that `core.run` embeds under the spans of its
    `trace.perfetto.json`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from .ops.wgl32 import RING_COLS, RING_ROWS, SUMMARY_HEAD

# The tracked frontier-fill target (the reference's ROADMAP item 5).
TARGET_FILL = 0.8

# Cap on per-round rows copied into a RESULT's occupancy block — the
# registry series keeps everything the ring surfaced. Overflow is
# counted in `rounds_truncated`, never silent.
MAX_RESULT_ROUNDS = 2048

# Published peaks of the cards the port runs on, by
# `torch.cuda.get_device_name`. NVIDIA H100 80GB HBM3 (SXM), at its 700 W
# power limit: 3.35 TB/s of HBM, 989 TFLOP/s dense bf16 on the tensor
# cores, and int32 at 64 lanes per SM per clock on 132 SMs at the
# 1980 MHz maximum SM clock (1.673e13 op/s); 1,979 TOP/s dense int8 on
# the tensor cores, and 1-bit AND/popc at eight times that (the data
# sheet gives no 1-bit rate: wgmma's .b1 form takes k 256 where int8's
# takes k 32 at the same m and n, so an instruction does eight times the
# multiply-accumulates; 2 operations each). A card set below 700 W runs
# slower under load; its name and limit stand beside every number kept.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "bf16_flops": 989e12,
                              "int32_ops": 132 * 64 * 1.98e9,
                              "int8_ops": 1979e12,
                              "b1_ops": 8 * 1979e12},
}
DEFAULT_KIND = "NVIDIA H100 80GB HBM3"

# The chunk kernels' packed poll summary (ops/wgl32.py): 11 head words
# and a 512 x 7 occupancy ring.
_SUMMARY_WORDS = SUMMARY_HEAD + RING_ROWS * RING_COLS


def peaks(device_kind: Optional[str] = None) -> tuple:
    """(peak dict, the card it is for): the named card's row, else the
    H100's, labeled as such."""
    kind = device_kind if device_kind in PEAKS else DEFAULT_KIND
    return PEAKS[kind], kind


def bound_ms(*, nbytes: float = 0.0, ops: float = 0.0,
             rate: str = "int32_ops",
             device_kind: Optional[str] = None) -> tuple:
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the card's memory rate and the operations over its
    `rate` peak (a key of `PEAKS`)."""
    pk, _ = peaks(device_kind)
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    t_ops = ops / pk[rate]
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


# ---------------------------------------------------------------------------
# the per-round occupancy drain and the search's roofline
# ---------------------------------------------------------------------------

def memo_hit_rate(hits, inserts) -> float:
    """hits / (hits + inserts), guarded — the single definition both
    the per-chunk telemetry points and the final util block use."""
    hits, inserts = int(hits), int(inserts)
    return round(hits / max(hits + inserts, 1), 4)


def drain_chunk(summary, rounds_before: int, K: int) -> tuple[list, int]:
    """Per-round occupancy rows from ONE packed poll summary.

    `summary` is the (SUMMARY_HEAD + RING_ROWS*RING_COLS,) int32 poll
    vector (already on the host — the drain adds no transfer);
    `rounds_before` is the cumulative rounds_total at the PREVIOUS
    poll, which anchors the first row's round span; `K` is the beam
    capacity fill is normalized by.

    Returns (rows, rounds_dropped): `rows` are dicts with round id,
    frontier (configs expanded), fill (frontier / (span * K) — span
    covers the depth-fused accel rounds, where one ring row spans
    `depth` levels), memo hits/inserts, survivors, post-compaction
    frontier, backlog and max linearized base; `rounds_dropped`
    counts rounds past RING_ROWS in this chunk (dropped on device,
    reported so coverage gaps are visible, never silent)."""
    s = np.asarray(summary).reshape(-1)
    if s.shape[0] < SUMMARY_HEAD + RING_COLS:
        return [], 0  # a ring-less summary (e.g. the legacy kernel)
    ring = s[SUMMARY_HEAD:SUMMARY_HEAD + RING_ROWS * RING_COLS]
    ring = ring.reshape(RING_ROWS, RING_COLS)
    writes = int(s[5])           # stats[1]: round-body calls this chunk
    rounds_total = int(s[9])     # stats[5]: cumulative rounds
    rows: list = []
    prev = int(rounds_before)
    for r in ring[:min(writes, RING_ROWS)]:
        rnd = int(r[0])
        span = max(1, rnd - prev)
        prev = rnd
        frontier = int(r[1])
        rows.append({
            "round": rnd,
            "span": span,
            "frontier": frontier,
            "fill": round(frontier / max(span * K, 1), 4),
            "memo_hits": int(r[2]),
            # memo inserts == compaction survivors by construction
            # (a successor survives iff its signature inserted), so
            # ONE field carries both meanings
            "memo_inserts": int(r[3]),
            "frontier_after": int(r[4]),
            "backlog": int(r[5]),
            "max_base": int(r[6]),
        })
    covered = (rows[-1]["round"] - int(rounds_before)) if rows else 0
    dropped = max(0, (rounds_total - int(rounds_before)) - covered)
    return rows, dropped


def _fill_stats(rounds: Sequence[dict]) -> dict:
    fills = [r["fill"] for r in rounds if r.get("fill") is not None]
    if not fills:
        return {"mean": None, "min": None, "max": None, "last": None}
    return {"mean": round(float(np.mean(fills)), 4),
            "min": round(float(np.min(fills)), 4),
            "max": round(float(np.max(fills)), 4),
            "last": fills[-1]}


def roofline(*, bytes_per_round: float, rounds: int, wall_s: float,
             device_kind: Optional[str] = None) -> dict:
    """The search's measured round time against the least time its
    bytes take at the card's memory rate (`PEAKS`; the H100's row,
    labeled, for another card or the CPU). `bytes_per_round` is the
    port's own count (`search_bytes`): a WGL round is bound by the
    memory trips its bytes make, and the port counts no operations for
    it, so `flops_per_round` and `arithmetic_intensity` are None.
    `achieved_frac` = bound / measured round time: latency-bound rounds
    sit far below 1.0, and that gap is the finding."""
    pk, chip = peaks(device_kind)
    peak_bytes = pk["hbm_bytes_per_s"]
    t_bound = max(float(bytes_per_round) / peak_bytes, 1e-12)
    round_time = wall_s / max(rounds, 1)
    return {
        "source": "port-byte-count",
        "bound": "memory",
        "flops_per_round": None,
        "bytes_per_round": float(bytes_per_round),
        "arithmetic_intensity": None,
        "peak_bf16_flops": pk["bf16_flops"],
        "peak_hbm_bytes_per_s": peak_bytes,
        "peak_chip": chip,
        "roofline_round_time_s": t_bound,
        "measured_round_time_s": round(round_time, 9),
        "achieved_frac": round(min(1.0, t_bound / max(round_time,
                                                      1e-12)), 6),
    }


def search_bytes(head, C: int, n_chunks: int) -> int:
    """Least bytes a whole `wgl32` / `wgln` search moved, from its last
    poll summary's head (cumulative counts): `wgl_chunk_bytes` with
    every memo probe counted (hits + inserts) and the consts the
    parents reached left out (a live search keeps no tally of them, so
    the count is a lower bound), plus one summary written a chunk."""
    probed = int(head[7]) + int(head[8])
    return wgl_chunk_bytes(head, C, {"const_bytes": 0, "probed": probed},
                           _SUMMARY_WORDS * max(int(n_chunks), 1))


def build_block(rounds: Sequence[dict], *, K: int, kernel: str,
                platform: str, wall_s: float, rounds_total: int,
                configs_explored: int, memo_hits: int,
                memo_inserts: int, bytes_total: int,
                rounds_dropped: int = 0,
                rounds_seen: Optional[int] = None,
                device_kind: Optional[str] = None) -> dict:
    """The per-search `occupancy` result block (doc/OBSERVABILITY.md):
    drained per-round rows (capped at MAX_RESULT_ROUNDS, overflow
    counted in `rounds_truncated` — `rounds_seen` is what the drain
    surfaced in total, when the caller capped before passing), fill
    statistics, memo dedup, expansion totals, and the roofline of
    `bytes_total` (`search_bytes`) over the search's rounds. Every count
    is device-measured; the bytes are the port's count from them."""
    rounds = list(rounds)
    kept = rounds[:MAX_RESULT_ROUNDS]
    seen = len(rounds) if rounds_seen is None else int(rounds_seen)
    # compaction survivors == memo inserts (see drain_chunk)
    survivors = sum(r.get("memo_inserts", 0) for r in rounds)
    return {
        "schema": 1,
        "kernel": kernel,
        "platform": platform,
        "K": K,
        "rounds_total": int(rounds_total),
        "rounds_seen": seen,
        "rounds_dropped": int(rounds_dropped),
        "rounds_truncated": max(0, seen - len(kept)),
        "fill": _fill_stats(rounds),
        "memo": {"hits": int(memo_hits), "inserts": int(memo_inserts),
                 "hit_rate": memo_hit_rate(memo_hits, memo_inserts)},
        "expansion": {
            "configs_explored": int(configs_explored),
            "survivors_seen": int(survivors),
            "expanded_per_round": round(
                configs_explored / max(rounds_total, 1), 2)},
        "roofline": roofline(
            bytes_per_round=bytes_total / max(int(rounds_total), 1),
            rounds=rounds_total, wall_s=wall_s, device_kind=device_kind),
        "rounds": kept,
    }


def safe_device_kind() -> Optional[str]:
    """The current card's name (`torch.cuda.get_device_name`), the key
    of `PEAKS`, or None when CUDA is not initialised in this process (a
    CPU search; the roofline then labels the H100's peaks)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return torch.cuda.get_device_name(torch.cuda.current_device())


def per_shard_cost(cost: Optional[dict], n_shards: int
                   ) -> Optional[dict]:
    """A whole-kernel per-round cost scaled to ONE shard of the
    mesh-sharded Elle closure's word-column layout: flops split
    evenly (each shard squares its own column block), bytes scaled by
    (1 + 2/n_shards)/3 — the gathered full row set is read once per
    shard regardless of the split, while the two writable blocks
    (local r + local accumulator) shrink with it. Used by
    elle/tpu._squaring_select to sanity-check the analytic per-shard
    HBM bill against the compiler's own packed-closure numbers."""
    if not cost or n_shards < 1:
        return None
    ns = int(n_shards)
    return {"flops": cost.get("flops", 0.0) / ns,
            "bytes_accessed": cost.get("bytes_accessed", 0.0)
            * (1.0 + 2.0 / ns) / 3.0,
            "n_shards": ns}



# ---------------------------------------------------------------------------
# the analytic cost cache (the reference's cost_for over cost_analysis)
# ---------------------------------------------------------------------------

_COST_CACHE: dict = {}


def cost_for(key: tuple, cost_fn) -> Optional[dict]:
    """The per-round cost {'flops', 'bytes_accessed', ...} of one kernel
    shape bucket, `cost_fn()` computed at most once per process per
    `key` (a failing count is cached as None and not retried)."""
    if key not in _COST_CACHE:
        try:
            _COST_CACHE[key] = cost_fn()
        except Exception:  # noqa: BLE001 — the count is best-effort
            _COST_CACHE[key] = None
    return _COST_CACHE[key]


def cost_cached(key: tuple) -> Optional[dict]:
    """The cached cost for `key`, or None when it was never counted."""
    return _COST_CACHE.get(key)


# ---------------------------------------------------------------------------
# resident bytes of a WGL search (the admission plane's bill)
# ---------------------------------------------------------------------------

_MIB = 1 << 20


def alloc_bytes(nbytes: int) -> int:
    """What PyTorch's CUDA caching allocator may count for one buffer
    of `nbytes`: its size rounded up to 512 B, and for a buffer past
    1 MiB up to 1 MiB more (a block carved from a larger segment or a
    cached block keeps a remainder of at most 1 MiB unsplit)."""
    if nbytes <= 0:
        return 0
    size = -(-int(nbytes) // 512) * 512
    return size + (_MIB if size > _MIB else 0)


def _info_words(ic: int) -> int:
    return max(1, (ic + 31) // 32)


def wgl_state_bytes(kern: str, *, K: int, W_eff: int, ic_eff: int, L: int,
                    H: int, B: int, n_pad: int, S: int = 0, O: int = 0,
                    lanes: int = 1) -> int:
    """Bytes a `wgl32` or `wgln` search keeps on the card at frontier
    capacity K, buffer by buffer through `alloc_bytes`: the carry
    (frontier and backlog rows of C words, the 16-byte memo slots,
    flags, stats, the occupancy ring), one chunk's scratch
    (`wgl32.scratch_words`) and summary, and the consts (meta rows, the
    S x O transition table when known, the info tables). `lanes` > 1
    bills a lane-batched carry: each buffer holds every lane, plus the
    three per-lane scalars."""
    C = (3 if kern == "wgl32" else 2 + L) + _info_words(ic_eff)
    R = K * (W_eff + ic_eff)
    words = [K * C, 1, B * C, 1, H * 4, 3, 6, 512 * 7,
             R * (C + 5) + K + K * C, _SUMMARY_WORDS,
             (n_pad + 1) * 4, S * O, ic_eff, ic_eff]
    if lanes > 1:
        words += [1, 1, 1]
    return sum(alloc_bytes(4 * lanes * w) for w in words)


def elle_closure_bytes(kernel: str, *, S: int, n_pad: int, e: int, q: int,
                       n_shards: int = 1, shards_per_card: int = 1) -> int:
    """Bytes an Elle closure keeps on one card, from the port's own
    buffers (`elle/tpu.py`), each through `alloc_bytes`: the seed reach
    and the two buffers the squarings alternate between (bf16 planes,
    or packed uint32 words); for the sharded closure, per shard its
    column block, the gathered full reach and two spare blocks, times
    the shards the card holds; the packed squaring's scratch
    (`bitmm_scratch_bytes`: the bit transpose and the tile flags, once
    for the packed closure, per shard its block's for the sharded one);
    the rw queries and the label pass's outputs; for bf16 the edge
    inputs and the seed scatter's index temporaries. `e` and `q` are the
    edge and rw-query counts (estimates before the graph is built),
    padded as `closure_inputs` pads them."""
    def bucket(x):
        return 1 << max(0, (max(int(x), 1) - 1).bit_length())

    e_pad, q_pad = bucket(e), bucket(q)
    words = S * n_pad * (n_pad // 32) * 4           # one packed reach
    if kernel == "bf16":
        nnz = S * e_pad
        buffers = [2 * S * n_pad * n_pad] * 3 + [
            4 * e_pad, 4 * e_pad, 4 * S * e_pad, nnz, 8 * nnz, 8 * nnz,
            8 * e_pad, 8 * e_pad, 8 * nnz, 8 * nnz, 8 * n_pad]
    elif kernel == "sharded":
        ns = max(1, int(n_shards))
        w_loc = (n_pad // 32) // ns
        buffers = shards_per_card * ([words] + [words // ns] * 3 + [4 * S]
                                     + bitmm_scratch_bytes(S, n_pad, w_loc))
    else:
        buffers = [words] * 3 + bitmm_scratch_bytes(S, n_pad, n_pad // 32)
    buffers += [4 * q_pad, 4 * q_pad, 4 * S * n_pad, S * q_pad, 4 * S]
    return sum(alloc_bytes(b) for b in buffers)


def bitmm_scratch_bytes(S: int, n_pad: int, w: int) -> list:
    """The bytes of each buffer of the packed squaring's scratch
    (`elle.tpu.bitmm_scratch_shapes`) for B of w words a row."""
    from .elle import tpu as etpu

    return [math.prod(shape) * dtype.itemsize
            for shape, dtype in etpu.bitmm_scratch_shapes(S, n_pad, w)]


# ---------------------------------------------------------------------------
# least traffic and operations of one launch (chip_smoke's bound columns)
# ---------------------------------------------------------------------------

def wgl_chunk_bytes(head, C: int, tally: dict, summary_words: int) -> int:
    """Least bytes a `wgl32`/`wgln` chunk must move for one run's data:
    the const entries the live parents reached (tallied by the plain
    version) read once; per expanded config its C-word row read; per
    successor that went to the memo table (tallied) one 16-byte slot
    read; per new config its row and its memo entry written; the
    summary written. `head` is the summary's first 11 words."""
    explored, new = int(head[4]), int(head[8])
    return (tally["const_bytes"] + explored * C * 4 + tally["probed"] * 16
            + new * (C * 4 + 16) + summary_words * 4)


def batched_chunk_bytes(head_rows, C: int, tally: dict, lanes: int,
                        summary_words: int) -> int:
    """`wgl_chunk_bytes` summed over the lanes of a lane-batched chunk
    (`head_rows` the (lanes, 11) summary heads), plus each lane's three
    scalars read."""
    explored = sum(int(r[4]) for r in head_rows)
    new = sum(int(r[8]) for r in head_rows)
    return (3 * lanes * 4 + tally["const_bytes"] + explored * C * 4
            + tally["probed"] * 16 + new * (C * 4 + 16)
            + summary_words * 4)


def wgl_bool_chunk_bytes(*, explored: int, new: int, W: int, ic: int,
                         tally: dict) -> int:
    """Least bytes a bool-window chunk must move: the consts its live
    parents reached (tallied by `wgl_bool.chunk_ref`) read once; per
    expanded config its bool row (base, W + ic bytes, mst) read; per
    row that probed the memo table one 16-byte slot read; per new
    config its row and its memo entry written."""
    row = 8 + W + ic
    return (tally["const_bytes"] + explored * row + tally["probed"] * 16
            + new * (row + 16))


def dense_square_cost(S: int, n_pad: int) -> dict:
    """One bf16 squaring of S reach planes of n_pad^2: 2 S n^3 flops on
    the tensor cores, the planes read and written once."""
    return {"flops": 2.0 * S * n_pad ** 3,
            "bytes_accessed": 2.0 * S * n_pad * n_pad * 2}


def bitmm_steps(fa, fb, *, n_pad: int, n_cols: int) -> float:
    """The bit AND/popc steps the tensor-core squaring does on this run's
    data: for every k stage whose A tile (`fa[s, i, k]`, 128 rows) and
    T tile (`fb[s, c, k]`, 256 output columns) both hold a bit, the
    tile's rows x its columns inside the output (`n_cols`) x its k bits
    inside the plane. `fa`, `fb` are the kernel's flag planes
    (`elle.tpu.tile_flags_ref`), as numpy arrays."""
    import numpy as np

    fa, fb = np.asarray(fa, bool), np.asarray(fb, bool)
    kbits = np.minimum(1024, n_pad - 1024 * np.arange(fa.shape[2]))
    cols = np.minimum(256, n_cols - 256 * np.arange(fb.shape[1]))
    return 128.0 * float(np.einsum(
        "sk,sk,k->", fa.sum(axis=1, dtype=np.float64),
        (fb * cols[None, :, None]).sum(axis=1, dtype=np.float64),
        kbits.astype(np.float64)))


def packed_square_cost(S: int, n_pad: int, set_bits: int,
                       steps: float) -> dict:
    """One packed squaring: the tensor-core work the kernel does on this
    run's data, 2 operations per bit AND/popc step (`bitmm_steps`, as
    the rate probe counts them); beside it the data's own count, a set
    bit j of row i ORing row j in, one int32 op per (set bit, word); the
    bitset read and written once."""
    W = n_pad // 32
    return {"tc_ops": 2.0 * steps, "ops": float(set_bits) * W,
            "bytes_accessed": 2.0 * S * n_pad * W * 4}


def sharded_square_cost(full_words: int, block_words: int, set_bits: int,
                        local_words: int, steps: float) -> dict:
    """One sharded squaring of one word-column shard: the tensor-core
    work as in `packed_square_cost`; one OR per (set bit, local word);
    the gathered reach read, the block read and written."""
    return {"tc_ops": 2.0 * steps, "ops": float(set_bits) * local_words,
            "bytes_accessed": (full_words + 2 * block_words) * 4.0}


def trim_bytes(arrays, n_pad: int, S: int) -> int:
    """The trim's inputs read once and its outputs (the live planes, 64
    count rows per subset, the body count) written once."""
    return sum(a.nbytes for a in arrays) + n_pad * S + 64 * S * 4 + 4


def trim_input_bytes(n_pad: int, d_in: int, d_out: int, S: int) -> int:
    """The trim's inputs on the card (`elle.tpu.trim_inputs`): both
    padded neighbor lists (int32) with their per-subset masks (bool),
    the four event arrays and the initial live planes."""
    return sum(alloc_bytes(b) for b in (
        4 * n_pad * d_in, n_pad * d_in * S, 4 * n_pad * d_out,
        n_pad * d_out * S, *(4 * n_pad,) * 4, n_pad * S))


def trim_alloc_bytes(n_pad: int, slots: int, S: int, p_pad: int = 8,
                     use_proc: bool = False, d_max: int = 0) -> int:
    """What the trim wrapper allocates on the card: the live planes, the
    64 count rows, the body count, the kernel's scratch
    (`elle.tpu.trim_scratch_words`: the transposed lists of `slots`
    masked slots) and, while it counts those slots, a bool a slot of
    the longer list (degree bucket `d_max`)."""
    from .elle import tpu as etpu

    return sum(alloc_bytes(b) for b in (
        n_pad * S, etpu.TRIM_COUNTS_ROWS * S * 4, 4,
        4 * etpu.trim_scratch_words(n_pad, slots, S, p_pad, use_proc),
        n_pad * d_max))


def trim_work(t: dict, device) -> int:
    """The operations the trim's data needs: per subset, for every peel
    up to that subset's own fixpoint (the body whose count repeats), one
    check per real neighbor slot (mask set) of each live node, and one
    compare per live node on each side (has_in, has_out) for each jump
    family that is on. Replays the peels of `elle.tpu.trim_ref` on
    `t = elle.tpu.trim_inputs(g)`."""
    import numpy as np
    import torch

    from .elle import tpu as etpu

    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for a in t["arrays"]]
    args, live = ins[:8], ins[8]
    kw = dict(p_pad=t["p_pad"], use_rt=t["use_rt"], use_proc=t["use_proc"])
    per_node = (ins[1].sum(dim=1, dtype=torch.int64)
                + ins[3].sum(dim=1, dtype=torch.int64)
                + 2 * (int(t["use_rt"]) + int(t["use_proc"])))
    active = torch.ones(live.shape[1], dtype=torch.bool, device=device)
    prev = None
    ops = 0
    for _ in range(t["n_pad"]):
        for _ in range(2):
            ops += int((live * active * per_node).sum())
            live = etpu._peel_ref(live, *args, **kw)
        c = live.sum(dim=0)
        if prev is not None:
            active &= c != prev
        if not bool(active.any()):
            break
        prev = c
    return ops


def perfetto_counter_tracks(registry) -> dict:
    """Counter tracks for `trace.Tracer.export_perfetto`'s `counters=`
    input, from the series a run recorded under the port's names (the
    reference's `perfetto_counter_tracks`, `jepsen_tpu/occupancy.py:304`):

      wgl fill             — per-round frontier fill (`wgl_rounds`)
      wgl frontier/backlog — per-poll beam and backlog (`wgl_chunks`)
      batched live keys    — live lanes per poll (`wgl_batched_chunks`)
      mesh sched actions   — cumulative steals and rebuckets of the mesh
                             fan-out (`mesh_sched`)
      hbm bytes <device>   — bytes in use per device (`hbm`), one lane
                             per device

    The reference's "elle gather bytes" lane reads a field that only its
    collective closure records; the port's `elle_closure` points carry
    none, so the lane never appears. Points ride their metrics `t`
    wall-clock stamps, so the counter graphs line up with the spans."""
    tracks: dict = {}

    def add(series: str, field: str, track: str) -> None:
        pts = registry.series(series).points
        vals = [(p["t"], p[field]) for p in pts
                if p.get("t") is not None
                and isinstance(p.get(field), (int, float))]
        if vals:
            tracks[track] = vals

    try:
        add("wgl_rounds", "fill", "wgl fill")
        add("wgl_chunks", "frontier", "wgl frontier")
        add("wgl_chunks", "backlog", "wgl backlog")
        add("wgl_batched_chunks", "live_keys", "batched live keys")
        n_sched = 0
        sched_vals = []
        for p in registry.series("mesh_sched").points:
            if p.get("t") is not None:
                n_sched += 1
                sched_vals.append((p["t"], n_sched))
        if sched_vals:
            tracks["mesh sched actions"] = sched_vals
        by_dev: dict = {}
        for p in registry.series("hbm").points:
            if p.get("t") is not None and isinstance(
                    p.get("bytes_in_use"), (int, float)):
                by_dev.setdefault(str(p.get("device")), []).append(
                    (p["t"], p["bytes_in_use"]))
        for dev, vals in sorted(by_dev.items()):
            tracks[f"hbm bytes {dev}"] = vals
    except Exception:  # noqa: BLE001 — a torn registry never blocks
        pass           # the trace export itself
    return tracks
