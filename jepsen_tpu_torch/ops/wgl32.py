"""Bitmask WGL chunk for windows of at most 32 ok-ops, on the H100.

The port of `jepsen_tpu/ops/wgl32.py::_build_search32 -> chunk_fn` with
its host-layout semantics (`accel=False, depth=1, compact=False`): one
chunk runs up to `chunk` WGL rounds and writes the packed poll summary.
A configuration is one packed int32 row `[base, win, mst, info words]`:

  * set bit j:      win' = win | (1 << j)
  * renormalize:    t = trailing ones of win', base += t, win' >>= t
                    (t == 32 drains the window: win' = 0)
  * crashed ops:    one uint32 word per 32 info ops

Each round expands the K frontier rows into R = K*(W + ic) successor
rows (first the K*W ok-rows, row-major, then the K*ic info-rows; dead
parent rows keep their slots), hashes each into three FNV words,
dedups against the open-addressing memo table (4 probes, insert at the
first empty slot, the highest row wins a slot raced by several rows,
a verify read catches twins), compacts the survivors into the next
frontier, spills the rest to the backlog and refills LIFO from it, and
writes one occupancy-ring row.

Two implementations of the same function live here:

  * `chunk_ref` — plain PyTorch, the spec. The CPU tests hold it bit
    for bit against the JAX `chunk_fn`; uint32 arithmetic runs in
    int64 masked to 32 bits (torch's int32 `>>` is arithmetic).
  * `chunk` — the wrapper: a CUDA tensor goes to the hand-written
    kernel `csrc/wgl32_chunk.cu` (built and bound by `_native`); a CPU
    tensor goes to `chunk_ref`. There is no fallback between the two.

Both update the carry's tensors IN PLACE (the memo table is 128 MB at
the headline's size, so a functional copy per chunk would double the
device memory) and return `(carry, summary)`.

The carry is the JAX package's 8-tuple, as int32 tensors:

    (fr (K, C), fr_cnt (), bk (B, C), bk_cnt (), table (H, 4),
     flags (3,), stats (6,), ring (RING_ROWS, RING_COLS))

`table` holds the uint32 memo words as their int32 bit patterns and
`flags` the three booleans as 0/1; `carry_from_numpy`/`carry_to_numpy`
convert a JAX carry bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

INF = np.int32(2**31 - 1)

# The JAX package's packed-table eligibility bound (`wgl._packable`).
# The port's kernel reads int32 tables only: `pack` is a TPU
# gather-width trick, bit-exact by construction.
PACK_MAX = (2**15 - 1) - 64

# carry indices, shared with the JAX package
FR, FR_CNT, BK, BK_CNT, TABLE, FLAGS, STATS, RING_BUF = range(8)

# Per-round occupancy ring: one (RING_COLS,) row per round at index
# stats[1] (rounds already run this chunk); rows past RING_ROWS in one
# chunk are dropped, never wrapped. Columns: [rounds_total after this
# round, frontier rows expanded, memo hits, unique survivors, frontier
# after compaction+refill, backlog depth, max linearized base].
RING_ROWS = 512
RING_COLS = 7

# leading words of the packed poll summary, before the flattened ring:
# [fr_cnt, flags x3, stats x6, bk_cnt]
SUMMARY_HEAD = 11

_M32 = 0xFFFFFFFF
_FNV_SEEDS = (0x811C9DC5, 0x01000193, 0xDEADBEEF)
_FNV_PRIME = 16777619


@dataclass
class Consts:
    """The per-history lookup tables of the search, on one device.

    `meta` is (n_pad + 1, 4) int32 rows [inv, ret, opcode, sufminret]
    with an INF sentinel row at n_pad; `tk` is the transition table
    flattened op-major, tk[o * S + s] = T[s, o]."""

    meta: torch.Tensor
    tk: torch.Tensor
    iinv: torch.Tensor
    iopc: torch.Tensor
    n_pad: int
    S: int
    n_ok: int
    n_info: int
    max_cfg: int


def consts_from_numpy(inv, ret, opcode, sufminret, inv_info, opcode_info,
                      table, n_ok: int, n_info: int, max_cfg: int,
                      device) -> Consts:
    """An encoding's numpy arrays (this package's `encode` or the JAX
    package's) -> `Consts` on `device`. `inv_info`/`opcode_info` are
    already cut to the plan's ic_eff."""
    inv = np.asarray(inv, np.int32)
    n_pad = len(inv)
    meta = np.empty((n_pad + 1, 4), np.int32)
    meta[:n_pad, 0] = inv
    meta[:n_pad, 1] = np.asarray(ret, np.int32)
    meta[:n_pad, 2] = np.asarray(opcode, np.int32)
    meta[n_pad, :2] = INF
    meta[n_pad, 2] = 0
    meta[:, 3] = np.asarray(sufminret, np.int32)[:n_pad + 1]
    table = np.asarray(table, np.int32)
    S = table.shape[0]
    tk = np.ascontiguousarray(table.T).reshape(-1)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return Consts(meta=dev(meta), tk=dev(tk), iinv=dev(inv_info),
                  iopc=dev(opcode_info), n_pad=n_pad, S=S, n_ok=int(n_ok),
                  n_info=int(n_info), max_cfg=int(max_cfg))


def row_words(ic: int) -> int:
    """C: int32 words of one packed config row for `ic` info slots."""
    return 3 + max(1, (ic + 31) // 32)


def init_carry(K: int, C: int, H: int, B: int, mstate0: int,
               device, mst_col: int = 2) -> tuple:
    """The search's start: one frontier row (base 0, empty window,
    model state `mstate0` in column `mst_col`), an empty memo table
    and backlog."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    fr = z(K, C)
    fr[0, mst_col] = mstate0
    fr_cnt = torch.ones((), dtype=torch.int32, device=device)
    return (fr, fr_cnt, z(B, C), z(), z(H, 4), z(3), z(6),
            z(RING_ROWS, RING_COLS))


def carry_from_numpy(leaves, device) -> tuple:
    """A JAX carry (`np.asarray` of each leaf) -> the port's carry, bit
    for bit (uint32 table words keep their bit patterns)."""
    out = []
    for a in leaves:
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(np.array(a, dtype=np.int32)).to(device))
    return tuple(out)


def carry_to_numpy(carry) -> tuple:
    """The port's carry -> numpy leaves with the JAX carry's dtypes:
    int32 everywhere, the memo table as uint32, flags as bool."""
    out = []
    for i, t in enumerate(carry):
        a = t.detach().cpu().numpy()
        if i == TABLE:
            a = a.view(np.uint32)
        elif i == FLAGS:
            a = a != 0
        out.append(a)
    return tuple(out)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 (or small signed) value -> its int32 bits."""
    x = x & _M32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _ctz32(x: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of uint32 values held in int64; 32 for 0."""
    low = x & (-x)
    return torch.where(x == 0, torch.full_like(x, 32),
                       _popcount32((low - 1) & _M32))


def _fnv(words, seed: int) -> torch.Tensor:
    h = torch.full_like(words[0], seed)
    for w in words:
        h = ((h ^ w) * _FNV_PRIME) & _M32
        h = h ^ (h >> 15)
    return h


def candidates(c: Consts, base, mst, info, linearized, fr_cnt: int, *,
               K, W, ic):
    """Candidate discovery, shared by both window layouts: which of the
    K parents' W window slots and ic info slots may be linearized next,
    and the model state each would reach. `base`/`mst` are (K,) int64,
    `info` (K, Il) uint32 words in int64, `linearized` (K, W) bools.
    Returns (legal_ok (K, W), legal_info (K, ic), nst_ok, nst_info)."""
    dev = base.device
    i64 = torch.int64
    meta = c.meta.to(i64)
    alive = torch.arange(K, device=dev) < fr_cnt
    j = torch.arange(W, device=dev, dtype=i64)
    pos = base[:, None] + j
    posc = pos.clamp(max=c.n_pad - 1)
    tailp = (base + W).clamp(max=c.n_pad)
    mrows = meta[posc]                                        # (K, W, 4)
    invw, retw0, opw = mrows[..., 0], mrows[..., 1], mrows[..., 2]
    tail = meta[tailp, 3]
    tk = c.tk.to(i64)
    nst_ok = tk[opw * c.S + mst[:, None]]                     # (K, W)
    nst_info = tk[c.iopc.to(i64)[None, :] * c.S + mst[:, None]]  # (K, ic)
    retw = torch.where(linearized | (pos >= c.n_ok),
                       torch.full_like(retw0, int(INF)), retw0)
    minret = torch.minimum(retw.min(dim=1).values, tail)     # (K,)

    cand_ok = (~linearized & (pos < c.n_ok)
               & (invw < minret[:, None]) & alive[:, None])
    m = torch.arange(ic, device=dev, dtype=i64)
    info_set = ((info[:, m // 32] >> (m % 32)) & 1) == 1      # (K, ic)
    cand_info = (~info_set & (m < c.n_info)[None, :]
                 & (c.iinv.to(i64)[None, :] < minret[:, None])
                 & alive[:, None])
    return (cand_ok & (nst_ok >= 0), cand_info & (nst_info >= 0), nst_ok,
            nst_info)


def info_successors(info, *, K, W, ic):
    """The info words of the R successor rows: unchanged on the K*W
    ok-rows, info bit m set on the K*ic info-rows. (R, Il) int64."""
    dev = info.device
    Il = info.shape[1]
    m = torch.arange(ic, device=dev, dtype=torch.int64)
    set_mask = torch.zeros((ic, Il), dtype=torch.int64, device=dev)
    set_mask[m, m // 32] = torch.ones_like(m) << (m % 32)
    return torch.cat([info[:, None, :].expand(K, W, Il).reshape(-1, Il),
                      (info[:, None, :] | set_mask[None]).reshape(-1, Il)])


def _round_ref(c: Consts, fr, sc: dict, bk, table, ring, *, K, W, ic, H,
               B, probes):
    """One WGL round (JAX `round_body` with `_expand` and
    `probe_insert`). `sc` holds the scalar state as Python ints and is
    updated in place; returns the next frontier."""
    i64 = torch.int64
    f = fr.to(i64)
    base, win, mst = f[:, 0], f[:, 1] & _M32, f[:, 2]
    info = f[:, 3:] & _M32                                    # (K, Il)
    j = torch.arange(W, device=fr.device, dtype=i64)
    linearized = ((win[:, None] >> j) & 1) == 1               # (K, W)
    legal_ok, legal_info, nst_ok, nst_info = candidates(
        c, base, mst, info, linearized, sc["fr_cnt"], K=K, W=W, ic=ic)

    # --- successor construction (bit math) -----------------------------
    win_ok = win[:, None] | (torch.ones_like(j) << j)         # (K, W)
    t = _ctz32(~win_ok & _M32)                                # trailing ones
    shifted = torch.where(t >= 32, torch.zeros_like(win_ok),
                          win_ok >> t.clamp(max=31))
    base_ok = base[:, None] + t

    base_s = torch.cat([base_ok.reshape(-1), base.repeat_interleave(ic)])
    win_s = torch.cat([shifted.reshape(-1), win.repeat_interleave(ic)])
    mst_s = torch.cat([nst_ok.reshape(-1), nst_info.reshape(-1)])
    info_s = info_successors(info, K=K, W=W, ic=ic)
    legal = torch.cat([legal_ok.reshape(-1), legal_info.reshape(-1)])

    success = legal & (base_s >= c.n_ok) & (win_s == 0)
    words = [base_s & _M32, win_s, mst_s & _M32] + [
        info_s[:, i] for i in range(info_s.shape[1])]
    succ = torch.stack([_to_i32(w) for w in words], dim=1)
    return finish_round(sc, bk, table, ring, words=words, succ=succ,
                        legal=legal, success=success, base_s=base_s, K=K,
                        H=H, B=B, probes=probes)


def finish_round(sc: dict, bk, table, ring, *, words, succ, legal, success,
                 base_s, K, H, B, probes):
    """The row-layout-free tail of a round (JAX `probe_insert` and the
    compaction after it), shared with the wide-window search: hash each
    successor row, dedup against the memo table, compact the survivors
    into the next frontier, spill and refill, and write the flags,
    stats and ring row.

    `words` are the R rows' uint32 words in hash order (int64 tensors
    masked to 32 bits; the row layout), `succ` the same rows as (R, C)
    int32, `legal`/`success` (R,) bools and `base_s` (R,) the
    successor bases. `sc` holds the scalar state as Python ints and is
    updated in place; returns the next frontier (K, C)."""
    dev = succ.device
    i64 = torch.int64
    fr_cnt, bk_cnt = sc["fr_cnt"], sc["bk_cnt"]
    R = legal.shape[0]
    found = bool(success.any())
    explore = legal & ~success
    s0 = _fnv(words, _FNV_SEEDS[0]) | 1                       # never 0
    s1 = _fnv(words, _FNV_SEEDS[1])
    s2 = _fnv(words, _FNV_SEEDS[2])
    base_max = int(torch.where(legal, base_s, 0).max())

    # --- memo probe ------------------------------------------------------
    rows = torch.arange(R, device=dev, dtype=i64)
    mysig = torch.stack([s0, s1, s2], dim=1)                  # (R, 3)
    step = s1 | 1
    pr = torch.arange(probes, device=dev, dtype=i64)
    idx_p = (s0[:, None] + pr[None, :] * step[:, None]) & (H - 1)  # (R, P)
    slots = table[idx_p].to(i64) & _M32                       # (R, P, 4)
    occ = slots[..., 0] != 0
    seen = (occ & (slots[..., :3] == mysig[:, None, :]).all(dim=2)).any(1)
    empt = ~occ
    has_empty = empt.any(dim=1)
    # first empty probe (JAX argmax over `empt`: 0 when none is empty)
    lead = (empt.to(i64).cumsum(dim=1) == 0).sum(dim=1)
    firstp = torch.where(has_empty, lead, torch.zeros_like(lead))
    ins_idx = idx_p.gather(1, firstp[:, None]).squeeze(1)     # (R,)

    # --- insert: the highest row wins a slot several rows claim ----------
    inserting = explore & ~seen & has_empty
    irow = rows[inserting]
    if irow.numel():
        key, _ = (ins_idx[irow] * R + irow).sort()
        wslot, wrow = key // R, key % R
        last = torch.ones_like(wslot, dtype=torch.bool)
        last[:-1] = wslot[1:] != wslot[:-1]
        wslot, wrow = wslot[last], wrow[last]
        table[wslot] = _to_i32(torch.stack(
            [s0[wrow], s1[wrow], s2[wrow], wrow], dim=1))
    verify = table[ins_idx].to(i64) & _M32
    twin_lost = (inserting & (verify[:, :3] == mysig).all(dim=1)
                 & (verify[:, 3] != rows))
    seen = seen | twin_lost
    new = explore & ~seen

    # --- compact survivors into frontier + backlog -----------------------
    posn = new.to(i64).cumsum(0) - 1
    total = int(new.sum())
    nfr = torch.zeros((K, succ.shape[1]), dtype=torch.int32, device=dev)
    front = new & (posn < K)
    nfr[posn[front]] = succ[front]
    nfr_cnt = min(total, K)
    spill = new & (posn >= K)
    sidx = bk_cnt + posn - K
    overflow = bool((spill & (sidx >= B)).any())
    keep = spill & (sidx < B)
    bk[sidx[keep]] = succ[keep]
    nbk_cnt = min(bk_cnt + max(total - K, 0), B)

    # refill the frontier LIFO from the backlog top
    take = min(K - nfr_cnt, nbk_cnt)
    if take > 0:
        src = nbk_cnt - 1 - torch.arange(take, device=dev)
        nfr[nfr_cnt:nfr_cnt + take] = bk[src]
    nfr_cnt += take
    nbk_cnt -= take

    seen_n = int(seen.sum())
    sc["probed"] += int(explore.sum())
    st = sc["stats"]
    bmax = max(st[2], base_max)
    ridx = st[1]
    sc["stats"] = [st[0] + fr_cnt, st[1] + 1, bmax, st[3] + seen_n,
                   st[4] + total, st[5] + 1]
    sc["flags"] = [sc["flags"][0] | int(found), sc["flags"][1] | int(overflow),
                   int(nfr_cnt == 0)]
    if ridx < RING_ROWS:
        ring[ridx] = torch.tensor(
            [sc["stats"][5], fr_cnt, seen_n, total, nfr_cnt, nbk_cnt, bmax],
            dtype=torch.int32, device=dev)
    sc["fr_cnt"], sc["bk_cnt"] = nfr_cnt, nbk_cnt
    return nfr


def _summary(carry) -> torch.Tensor:
    return torch.cat([carry[FR_CNT].reshape(1), carry[FLAGS], carry[STATS],
                      carry[BK_CNT].reshape(1), carry[RING_BUF].reshape(-1)])


def run_chunk(consts: Consts, carry, round_fn, *, chunk: int,
              tally: dict | None = None):
    """The plain chunk loop of both window layouts: up to `chunk` calls
    of `round_fn(consts, fr, sc, bk, table, ring)`, stopping when a
    linearization is found, the frontier is empty, or `max_cfg`
    configs were explored. Updates `carry` in place; returns (carry,
    summary)."""
    fr, fr_cnt_t, bk, bk_cnt_t, table, flags_t, stats_t, ring = carry
    sc = {"probed": 0, "fr_cnt": int(fr_cnt_t), "bk_cnt": int(bk_cnt_t),
          "flags": [int(x) for x in flags_t.tolist()],
          "stats": [int(x) for x in stats_t.tolist()]}
    sc["stats"][1] = 0
    cur = fr
    while (not sc["flags"][0] and sc["fr_cnt"] > 0
           and sc["stats"][1] < chunk and sc["stats"][0] < consts.max_cfg):
        cur = round_fn(consts, cur, sc, bk, table, ring)
    if cur is not fr:
        fr.copy_(cur)
    fr_cnt_t.fill_(sc["fr_cnt"])
    bk_cnt_t.fill_(sc["bk_cnt"])
    flags_t.copy_(torch.tensor(sc["flags"], dtype=torch.int32))
    stats_t.copy_(torch.tensor(sc["stats"], dtype=torch.int32))
    if tally is not None:
        tally["probed"] = tally.get("probed", 0) + sc["probed"]
    return carry, _summary(carry)


def chunk_ref(consts: Consts, carry, *, K: int, W: int, ic: int, H: int,
              B: int, chunk: int, probes: int, tally: dict | None = None):
    """Plain PyTorch chunk: up to `chunk` rounds, stopping when a
    linearization is found, the frontier is empty, or `max_cfg`
    configs were explored. Updates `carry` in place; returns
    (carry, summary). A `tally` dict gets "probed": the successor rows
    that went to the memo table (legal, not a linearization), the
    data-dependent count a bound on the chunk's memory traffic needs."""
    def round_fn(c, fr, sc, bk, table, ring):
        return _round_ref(c, fr, sc, bk, table, ring, K=K, W=W, ic=ic, H=H,
                          B=B, probes=probes)

    return run_chunk(consts, carry, round_fn, chunk=chunk, tally=tally)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

MAX_PROBES = 8   # the kernel's unrolled probe loop
MAX_INFO_WORDS = 8


def check_launch(consts: Consts, carry, *, K, W, C, ic, H, B, chunk,
                 probes):
    """The checks before a chunk kernel's launch, shared by both window
    layouts (rows of C int32 words); raises ValueError on what the
    kernels do not take."""
    dev = carry[FR].device
    if not 1 <= probes <= MAX_PROBES:
        raise ValueError(f"probes={probes} outside [1, {MAX_PROBES}]")
    if ic < 1 or (ic + 31) // 32 > MAX_INFO_WORDS:
        raise ValueError(f"info slots ic={ic} outside [1, "
                         f"{32 * MAX_INFO_WORDS}]")
    if H < 1 or H & (H - 1):
        raise ValueError(f"memo table size H={H} is not a power of two")
    if K < 1 or B < 1 or chunk < 0:
        raise ValueError(f"bad capacities K={K} B={B} chunk={chunk}")
    if K * (W + ic) >= 2**31 - 1:
        raise ValueError("successor row count overflows int32")
    want = {FR: (K, C), FR_CNT: (), BK: (B, C), BK_CNT: (), TABLE: (H, 4),
            FLAGS: (3,), STATS: (6,), RING_BUF: (RING_ROWS, RING_COLS)}
    for i, t in enumerate(carry):
        if tuple(t.shape) != want[i]:
            raise ValueError(f"carry leaf {i} has shape {tuple(t.shape)}, "
                             f"want {want[i]}")
    tensors = list(carry) + [consts.meta, consts.tk, consts.iinv,
                             consts.iopc]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, carry on {dev}")
        if t.dtype not in (torch.int32, torch.uint32):
            raise ValueError(f"tensor dtype {t.dtype}, want int32")
        if not t.is_contiguous():
            raise ValueError("kernel tensors must be contiguous")
    if carry[TABLE].data_ptr() % 16:
        raise ValueError("memo table must be 16-byte aligned (uint4 slots)")
    if tuple(consts.meta.shape) != (consts.n_pad + 1, 4):
        raise ValueError("meta must be (n_pad + 1, 4)")
    if consts.iinv.numel() != ic or consts.iopc.numel() != ic:
        raise ValueError(f"info tables must hold ic={ic} slots")
    if not 0 <= consts.max_cfg < 2**31:
        raise ValueError(f"max_cfg={consts.max_cfg} does not fit int32")


def _check_launch(consts: Consts, carry, *, K, W, ic, H, B, chunk, probes):
    if not 1 <= W <= 32:
        raise ValueError(f"wgl32 window width W={W} outside [1, 32]")
    check_launch(consts, carry, K=K, W=W, C=row_words(ic), ic=ic, H=H, B=B,
                 chunk=chunk, probes=probes)


def scratch_words(K: int, W: int, ic: int, C: int) -> int:
    """int32 words of kernel scratch for rows of C words: successor
    rows, three signatures, insert slots, row flags, per-parent
    min-ret, the second frontier."""
    R = K * (W + ic)
    return R * (C + 5) + K + K * C


def launch(name: str, consts: Consts, carry, *, K, W, L, ic, H, B, rounds,
           probes) -> torch.Tensor:
    """Launch the chunk kernel `name` (`wgl32_chunk` or `wgln_chunk`,
    which share one C interface) on the carry's card, on the current
    stream: scratch and the summary come from `torch.empty`. Returns
    the summary; the carry is updated in place."""
    from . import _native

    dev = carry[FR].device
    C = carry[FR].shape[1]
    with torch.cuda.device(dev):
        scratch = torch.empty(scratch_words(K, W, ic, C), dtype=torch.int32,
                              device=dev)
        summary = torch.empty(SUMMARY_HEAD + RING_ROWS * RING_COLS,
                              dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [consts.meta, consts.tk, consts.iinv, consts.iopc,
                *carry, summary, scratch]
        _native.launch(name, [t.data_ptr() for t in ptrs],
                       [K, W, L, ic, H, B, rounds, probes, consts.n_pad,
                        consts.S, consts.n_ok, consts.n_info, consts.max_cfg],
                       stream)
    return summary


def chunk(consts: Consts, carry, *, K: int, W: int, ic: int, H: int,
          B: int, chunk: int, probes: int):
    """One chunk of the search (see `chunk_ref`). CUDA tensors run the
    `wgl32_chunk` kernel (one launch per call, counted in
    `chunk.launches`); CPU tensors run `chunk_ref`. Updates `carry` in
    place; returns (carry, summary)."""
    dev = carry[FR].device
    if dev.type == "cpu":
        return chunk_ref(consts, carry, K=K, W=W, ic=ic, H=H, B=B,
                         chunk=chunk, probes=probes)
    if dev.type != "cuda":
        raise ValueError(f"wgl32 chunk: unsupported device {dev}")
    _check_launch(consts, carry, K=K, W=W, ic=ic, H=H, B=B, chunk=chunk,
                  probes=probes)
    summary = launch("wgl32_chunk", consts, carry, K=K, W=W, L=1, ic=ic,
                     H=H, B=B, rounds=chunk, probes=probes)
    _count_launch()
    return carry, summary


chunk.launches = 0


def _count_launch():
    # inside `chunk` the name is its round-count parameter
    chunk.launches += 1
