"""The bool-window WGL chunk on the H100.

The port of `jepsen_tpu/ops/wgl.py::_build_search -> chunk_fn`, the
general search whose configuration keeps its window as a `(W,)` bool
row (`ops/wgl.py::_build_search` and `_compiled_search` return the
functions defined here). A configuration is

  * `base`   the first unlinearized ok op,
  * `window` W bools: ok ops [base, base + W) already linearized,
  * `info`   ic bools: crashed ops already linearized,
  * `mst`    the model state (a row of the transition table T).

One round expands the K frontier configs into R = K*(W + ic) successor
rows (the K*W ok rows parent-major, then the K*ic info rows), hashes
each into three FNV words over `[base, window words, info words, mst]`
(rows that do not explore get all-ones signatures), orders the rows by
a stable 3-key sort of the signatures, drops adjacent duplicates,
probes the `H x 4` memo table `probes` times by double hashing (a row
that finds an empty slot claims it; the highest sorted position wins a
slot several rows claim), compacts the survivors in sorted order into
the next frontier, spills the rest to the backlog and refills the
frontier from the backlog's top. The carry is the JAX package's 13
leaves, in its order and shapes:

    (fr_base (K,), fr_win (K, W) bool, fr_info (K, ic) bool,
     fr_mst (K,), fr_cnt (), bk_base (B,), bk_win (B, W) bool,
     bk_info (B, ic) bool, bk_mst (B,), bk_cnt (), table (H, 4),
     flags (3,) bool, stats (6,))

Every integer leaf is int32; `table` holds the uint32 memo words as
their int32 bit patterns (`carry_to_numpy` gives the JAX carry's
dtypes back). The consts are the JAX package's 10-tuple
`(inv, ret, opcode, sufminret, inv_info, opcode_info, T, n_ok, n_info,
max_cfg)`: int32 tensors, T as (S, O), the three scalars as ints.

Two implementations of the same function:

  * `chunk_ref` — plain PyTorch, the spec. The CPU tests hold it bit
    for bit against the JAX `chunk_fn` on every carry leaf; uint32
    arithmetic runs in int64 masked to 32 bits (`wgl32`'s helpers and
    FNV hash), and the 3-key sort is three stable sorts (least
    significant key first).
  * `chunk` — the wrapper: a CUDA tensor goes to the hand-written
    kernel `csrc/wgl_chunk.cu` (built and bound by `_native`); a CPU
    tensor goes to `chunk_ref`. There is no fallback between the two.

Both update the carry's tensors in place and return the carry.
"""

from __future__ import annotations

import numpy as np
import torch

from ..util import raw_stream, resolve_device
from .wgl32 import _FNV_SEEDS, _M32, _fnv, _to_i32

INF = np.int32(2**31 - 1)

# carry indices, shared with the JAX package's `_build_search`
(FR_BASE, FR_WIN, FR_INFO, FR_MST, FR_CNT, BK_BASE, BK_WIN, BK_INFO,
 BK_MST, BK_CNT, TABLE, FLAGS, STATS) = range(13)
BOOL_LEAVES = (FR_WIN, FR_INFO, BK_WIN, BK_INFO, FLAGS)

# the kernel's limits: the window and info words one thread streams
# through its hashes, the successor rows one CTA expands (and the most
# explorers it sorts), the probe loop
MAX_W = 1024
MAX_IC = 256
MAX_ROWS = 1 << 20
MAX_PROBES = 8


def init_carry(K: int, W: int, ic: int, H: int, B: int, mstate0: int,
               device=None) -> tuple:
    """The search's start (JAX `init_fn`): one frontier config (base 0,
    empty window and info mask, model state `mstate0`), an empty
    backlog and memo table. `device=None` is the card."""
    dev = resolve_device(device)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    fr_mst = z(K)
    fr_mst[0] = mstate0
    return (z(K), z(K, W, dtype=torch.bool), z(K, ic, dtype=torch.bool),
            fr_mst, torch.ones((), dtype=torch.int32, device=dev), z(B),
            z(B, W, dtype=torch.bool), z(B, ic, dtype=torch.bool), z(B),
            z(), z(H, 4), z(3, dtype=torch.bool), z(6))


def consts_from_numpy(inv, ret, opcode, sufminret, inv_info, opcode_info,
                      table, n_ok: int, n_info: int, max_cfg: int,
                      device=None) -> tuple:
    """An encoding's arrays (this package's `encode` or the JAX
    package's, `aot._wgl_consts_spec` order) -> the consts tuple on
    `device` (None: the card)."""
    dev = resolve_device(device)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return (on(inv), on(ret), on(opcode), on(sufminret), on(inv_info),
            on(opcode_info), on(table), int(n_ok), int(n_info),
            int(max_cfg))


def carry_to_numpy(carry) -> tuple:
    """The port's carry -> numpy leaves with the JAX carry's dtypes."""
    out = []
    for i, t in enumerate(carry):
        a = t.detach().cpu().numpy()
        out.append(a.view(np.uint32) if i == TABLE else a)
    return tuple(out)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(R, L) bool -> (R, L // 32) uint32 words in int64."""
    R, L = bits.shape
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    return (bits.reshape(R, L // 32, 32).to(torch.int64) * weights).sum(-1)


def _round_ref(consts, carry, sc: dict, *, K, W, ic, H, B, probes):
    """One round (JAX `round_body`). The frontier leaves are replaced
    by new tensors (returned); the backlog and memo table are updated
    in place; `sc` holds the scalar state as Python ints."""
    inv, ret, opc, suf, iinv, iopc, T, n_ok, n_info, _ = consts
    fr_base, fr_win, fr_info, fr_mst = carry
    dev = fr_base.device
    i64 = torch.int64
    n_pad = inv.shape[0]
    S, O = T.shape
    fr_cnt, bk_cnt = sc["fr_cnt"], sc["bk_cnt"]
    bk_base, bk_win, bk_info, bk_mst, table = sc["bk"]

    # --- candidate discovery (gather indices clamped as XLA's are) -------
    alive = torch.arange(K, device=dev) < fr_cnt
    base = fr_base.to(i64)
    mst = fr_mst.to(i64).clamp(0, S - 1)
    pos = base[:, None] + torch.arange(W, device=dev)
    posc = pos.clamp(0, n_pad - 1)
    retw = torch.where(fr_win | (pos >= n_ok), int(INF), ret.to(i64)[posc])
    tail = suf.to(i64)[(base + W).clamp(0, n_pad)]
    minret = torch.minimum(retw.min(dim=1).values, tail)      # (K,)
    cand_ok = (~fr_win & (pos < n_ok) & (inv.to(i64)[posc] < minret[:, None])
               & alive[:, None])
    Tl = T.to(i64)
    nst_ok = Tl[mst[:, None], opc.to(i64)[posc].clamp(0, O - 1)]
    legal_ok = cand_ok & (nst_ok >= 0)
    m = torch.arange(ic, device=dev)
    cand_info = (~fr_info & (m < n_info)[None, :]
                 & (iinv.to(i64)[None, :] < minret[:, None]) & alive[:, None])
    nst_info = Tl[mst[:, None], iopc.to(i64).clamp(0, O - 1)[None, :]]
    legal_info = cand_info & (nst_info >= 0)
    reach = sc.get("reach")
    if reach is not None:
        # the const entries the live parents must read
        reach["pos"][posc[~fr_win & (pos < n_ok) & alive[:, None]]] = True
        reach["suf"][(base + W).clamp(0, n_pad)[alive]] = True
        reach["T"][(mst[:, None] * O
                    + opc.to(i64)[posc].clamp(0, O - 1))[cand_ok]] = True
        reach["T"][(mst[:, None] * O
                    + iopc.to(i64).clamp(0, O - 1)[None, :])[cand_info]] = True
        reach["iinv"] |= (~fr_info & (m < n_info)[None, :]
                          & alive[:, None]).any(dim=0)
        reach["iopc"] |= cand_info.any(dim=0)

    # --- successors: ok rows set bit j and renormalize; info rows set m ---
    eye_w = torch.eye(W, dtype=torch.bool, device=dev)
    win2 = fr_win[:, None, :] | eye_w[None]                   # (K, W, W)
    t = win2.to(i64).cumprod(dim=2).sum(dim=2)                # leading ones
    padded = torch.cat([win2, torch.zeros_like(win2)], dim=2)
    gidx = t[..., None] + torch.arange(W, device=dev)
    shifted = padded.gather(2, gidx.clamp(max=2 * W - 1))     # (K, W, W)
    base_ok = base[:, None] + t
    eye_i = torch.eye(ic, dtype=torch.bool, device=dev)
    info2 = fr_info[:, None, :] | eye_i[None]                 # (K, ic, ic)

    base_s = torch.cat([base_ok.reshape(-1), base.repeat_interleave(ic)])
    win_s = torch.cat([shifted.reshape(-1, W),
                       fr_win.repeat_interleave(ic, dim=0)])
    info_s = torch.cat([fr_info.repeat_interleave(W, dim=0),
                        info2.reshape(-1, ic)])
    mst_s = torch.cat([nst_ok.reshape(-1), nst_info.reshape(-1)])
    legal = torch.cat([legal_ok.reshape(-1), legal_info.reshape(-1)])
    R = legal.shape[0]
    success = legal & (base_s >= n_ok)
    found = bool(success.any())
    explore = legal & ~success

    # --- hash + stable 3-key sort + adjacent dedup ------------------------
    winp, infop = _pack_bits(win_s), _pack_bits(info_s)
    words = ([base_s & _M32] + [winp[:, i] for i in range(W // 32)]
             + [infop[:, i] for i in range(ic // 32)] + [mst_s & _M32])
    sig = [_fnv(words, _FNV_SEEDS[0]) | 1, _fnv(words, _FNV_SEEDS[1]),
           _fnv(words, _FNV_SEEDS[2])]
    sig = [torch.where(explore, s, _M32) for s in sig]
    if sc.get("on_keys") is not None:
        sc["on_keys"](sig, explore)
    perm = torch.arange(R, device=dev)
    for key in reversed(sig):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    s0, s1, s2 = (s[perm] for s in sig)
    ex_s = explore[perm]
    samep = torch.zeros(R, dtype=torch.bool, device=dev)
    samep[1:] = (s0[1:] == s0[:-1]) & (s1[1:] == s1[:-1]) & (s2[1:] == s2[:-1])
    uniq = ex_s & ~samep

    # --- memo probe (double hashing); myrow is the sorted position --------
    mysig = torch.stack([s0, s1, s2], dim=1)
    myrow = torch.arange(R, device=dev)
    step = s1 | 1
    pending = uniq.clone()
    seen = torch.zeros(R, dtype=torch.bool, device=dev)
    for q in range(probes):
        idx = (s0 + q * step) & (H - 1)
        slot = table[idx].to(i64) & _M32
        occupied = slot[:, 0] != 0
        equal = occupied & (slot[:, :3] == mysig).all(dim=1)
        seen |= pending & equal
        claim = pending & ~occupied
        rows = myrow[claim]
        if rows.numel():
            # the highest position wins a slot several rows claim (the
            # last duplicate of XLA's scatter)
            key = (idx[rows] * R + rows).sort().values
            wslot, wrow = key // R, key % R
            last = torch.ones_like(wslot, dtype=torch.bool)
            last[:-1] = wslot[1:] != wslot[:-1]
            wslot, wrow = wslot[last], wrow[last]
            table[wslot] = _to_i32(torch.stack(
                [s0[wrow], s1[wrow], s2[wrow], wrow], dim=1))
        slot2 = table[idx].to(i64) & _M32
        won = claim & (slot2[:, :3] == mysig).all(dim=1) & (slot2[:, 3] == myrow)
        pending = pending & ~equal & ~won
    new = uniq & ~seen

    # --- compaction in sorted order, spill, LIFO refill -------------------
    posn = new.to(i64).cumsum(0) - 1
    total = int(new.sum())
    rows_g = (base_s[perm].to(torch.int32), win_s[perm], info_s[perm],
              mst_s[perm].to(torch.int32))
    nfr = (torch.zeros(K, dtype=torch.int32, device=dev),
           torch.zeros((K, W), dtype=torch.bool, device=dev),
           torch.zeros((K, ic), dtype=torch.bool, device=dev),
           torch.zeros(K, dtype=torch.int32, device=dev))
    front = new & (posn < K)
    for dst, src in zip(nfr, rows_g):
        dst[posn[front]] = src[front]
    nfr_cnt = min(total, K)
    spill = new & (posn >= K)
    sidx = bk_cnt + posn - K
    overflow = bool((spill & (sidx >= B)).any())
    keep = spill & (sidx < B)
    for dst, src in zip((bk_base, bk_win, bk_info, bk_mst), rows_g):
        dst[sidx[keep]] = src[keep]
    nbk_cnt = min(bk_cnt + max(total - K, 0), B)
    take = min(K - nfr_cnt, nbk_cnt)
    if take > 0:
        src = nbk_cnt - 1 - torch.arange(take, device=dev)
        for dst, b in zip(nfr, (bk_base, bk_win, bk_info, bk_mst)):
            dst[nfr_cnt:nfr_cnt + take] = b[src]
    nfr_cnt += take
    nbk_cnt -= take

    st = sc["stats"]
    bmax = int(torch.where(legal, base_s, 0).max())
    sc["stats"] = [st[0] + fr_cnt, st[1] + 1, max(st[2], bmax),
                   st[3] + int(seen.sum()) + int((ex_s & samep).sum()),
                   st[4] + total, st[5] + 1]
    sc["flags"] = [sc["flags"][0] | found, sc["flags"][1] | overflow,
                   nfr_cnt == 0]
    sc["fr_cnt"], sc["bk_cnt"] = nfr_cnt, nbk_cnt
    sc["probed"] += int(uniq.sum())
    return nfr


def chunk_ref(consts, carry, *, K: int, W: int, ic: int, H: int, B: int,
              chunk: int, probes: int, tally: dict | None = None,
              on_keys=None) -> tuple:
    """Plain PyTorch chunk: up to `chunk` rounds, stopping when a
    linearization is found, the frontier is empty, or `max_cfg`
    configs were explored. Updates `carry` in place; returns it. A
    `tally` dict gets two sums for a bound on the chunk's traffic:
    "probed", the rows that probed the memo table, and "const_bytes",
    the bytes of the const entries the live parents had to read (inv,
    ret and opcode of their open window slots, their suffix tail, the
    transitions of their candidates, the info slots they considered),
    each entry once. `on_keys(sig, explore)`, when given, sees each
    round's sort keys before the sort: the three signature words by row
    (all ones where the row does not explore) and the explore flags."""
    (fr_base, fr_win, fr_info, fr_mst, fr_cnt_t, bk_base, bk_win, bk_info,
     bk_mst, bk_cnt_t, table, flags_t, stats_t) = carry
    max_cfg = int(consts[9])
    consts = consts[:7] + (int(consts[7]), int(consts[8]), max_cfg)
    sc = {"fr_cnt": int(fr_cnt_t), "bk_cnt": int(bk_cnt_t), "probed": 0,
          "flags": [bool(x) for x in flags_t.tolist()],
          "stats": [int(x) for x in stats_t.tolist()],
          "bk": (bk_base, bk_win, bk_info, bk_mst, table),
          "on_keys": on_keys}
    if tally is not None:
        dev = fr_base.device
        sc["reach"] = {k: torch.zeros(n, dtype=torch.bool, device=dev)
                       for k, n in (("pos", consts[0].shape[0]),
                                    ("suf", consts[3].shape[0]),
                                    ("T", consts[6].numel()),
                                    ("iinv", ic), ("iopc", ic))}
    sc["stats"][1] = 0
    fr = (fr_base, fr_win, fr_info, fr_mst)
    cur = fr
    while (not sc["flags"][0] and sc["fr_cnt"] > 0
           and sc["stats"][1] < chunk and sc["stats"][0] < max_cfg):
        cur = _round_ref(consts, cur, sc, K=K, W=W, ic=ic, H=H, B=B,
                         probes=probes)
    if cur is not fr:
        for dst, src in zip(fr, cur):
            dst.copy_(src)
    fr_cnt_t.fill_(sc["fr_cnt"])
    bk_cnt_t.fill_(sc["bk_cnt"])
    flags_t.copy_(torch.tensor(sc["flags"], dtype=torch.bool))
    stats_t.copy_(torch.tensor(sc["stats"], dtype=torch.int32))
    if tally is not None:
        r = sc["reach"]
        tally["probed"] = tally.get("probed", 0) + sc["probed"]
        tally["const_bytes"] = tally.get("const_bytes", 0) + 12 * int(
            r["pos"].sum()) + 4 * sum(int(r[k].sum()) for k in (
                "suf", "T", "iinv", "iopc"))
    return carry


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def sort_rows(K: int, W: int, ic: int) -> int:
    """R_pad: a round's successor rows padded to a power of two, the
    most explorers a round can sort."""
    R = K * (W + ic)
    return 1 << max(0, (R - 1).bit_length())


def scratch_layout(K: int, W: int, ic: int) -> dict:
    """The kernel's device scratch, {region: (offset, words)} in int32
    words, in the order `csrc/wgl_chunk.cu` lays it out: the explorers'
    sort keys (s0, s1, s2, row) for R_pad rows (first, so 16-byte
    aligned), the probe state and the claimed slot by sorted position,
    the two packed frontiers of K rows of [base, W/32 window words,
    ic/32 info words, mst], and the per-parent min-ret. The kernel uses a
    region where its copy in shared memory does not fit."""
    rp = sort_rows(K, W, ic)
    cw = 2 + W // 32 + ic // 32
    out, off = {}, 0
    for name, words in (("keys", 4 * rp), ("state", rp), ("slot", rp),
                        ("cur", K * cw), ("nxt", K * cw), ("minret", K)):
        out[name] = (off, words)
        off += words
    return out


def scratch_words(K: int, W: int, ic: int) -> int:
    """int32 words of kernel scratch (`scratch_layout`)."""
    return sum(words for _, words in scratch_layout(K, W, ic).values())


def check_launch(consts, carry, *, K, W, ic, H, B, chunk, probes) -> None:
    """The checks before a launch; raises ValueError on what the kernel
    does not take (it never falls back to the plain version)."""
    if W < 32 or W % 32 or W > MAX_W:
        raise ValueError(f"window W={W}: a multiple of 32 in [32, {MAX_W}]")
    if ic < 32 or ic % 32 or ic > MAX_IC:
        raise ValueError(f"info slots ic={ic}: a multiple of 32 in "
                         f"[32, {MAX_IC}]")
    if not 1 <= probes <= MAX_PROBES:
        raise ValueError(f"probes={probes} outside [1, {MAX_PROBES}]")
    if H < 1 or H & (H - 1):
        raise ValueError(f"memo table size H={H} is not a power of two")
    if K < 1 or B < 1 or chunk < 0:
        raise ValueError(f"bad capacities K={K} B={B} chunk={chunk}")
    if K * (W + ic) > MAX_ROWS:
        raise ValueError(f"K*(W+ic)={K * (W + ic)} successor rows past the "
                         f"kernel's row cap {MAX_ROWS}")
    want = {FR_BASE: (K,), FR_WIN: (K, W), FR_INFO: (K, ic), FR_MST: (K,),
            FR_CNT: (), BK_BASE: (B,), BK_WIN: (B, W), BK_INFO: (B, ic),
            BK_MST: (B,), BK_CNT: (), TABLE: (H, 4), FLAGS: (3,),
            STATS: (6,)}
    if len(carry) != 13:
        raise ValueError(f"carry has {len(carry)} leaves, want 13")
    dev = carry[FR_BASE].device
    for i, t in enumerate(carry):
        if tuple(t.shape) != want[i]:
            raise ValueError(f"carry leaf {i} has shape {tuple(t.shape)}, "
                             f"want {want[i]}")
        dtype = torch.bool if i in BOOL_LEAVES else torch.int32
        if t.dtype != dtype:
            raise ValueError(f"carry leaf {i} is {t.dtype}, want {dtype}")
    arrays = list(consts[:7])
    n_pad = arrays[0].shape[0]
    if (tuple(arrays[1].shape) != (n_pad,) or tuple(arrays[2].shape)
            != (n_pad,) or tuple(arrays[3].shape) != (n_pad + 1,)):
        raise ValueError("inv, ret, opcode must be (n_pad,), sufminret "
                         "(n_pad + 1,)")
    if tuple(arrays[4].shape) != (ic,) or tuple(arrays[5].shape) != (ic,):
        raise ValueError(f"info tables must hold ic={ic} slots")
    if arrays[6].dim() != 2:
        raise ValueError("T must be (S, O)")
    for t in list(carry) + arrays:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, carry on {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel tensors must be contiguous")
    for t in arrays:
        if t.dtype != torch.int32:
            raise ValueError(f"const dtype {t.dtype}, want int32")
    if carry[TABLE].data_ptr() % 16:
        raise ValueError("memo table must be 16-byte aligned (uint4 slots)")
    if any(carry[i].data_ptr() % 4 for i in BOOL_LEAVES[:4]):
        raise ValueError("bool rows must be 4-byte aligned (read as words)")
    if not 0 <= int(consts[9]) < 2**31:
        raise ValueError(f"max_cfg={int(consts[9])} does not fit int32")


def chunk(consts, carry, *, K: int, W: int, ic: int, H: int, B: int,
          chunk: int, probes: int) -> tuple:
    """One chunk of the search (see `chunk_ref`). CUDA tensors run the
    `wgl_chunk` kernel (one launch per call, counted in
    `chunk.launches`); CPU tensors run `chunk_ref`. Updates `carry` in
    place; returns it."""
    from . import _native

    dev = carry[FR_BASE].device
    if dev.type == "cpu":
        return chunk_ref(consts, carry, K=K, W=W, ic=ic, H=H, B=B,
                         chunk=chunk, probes=probes)
    if dev.type != "cuda":
        raise ValueError(f"wgl chunk: unsupported device {dev}")
    check_launch(consts, carry, K=K, W=W, ic=ic, H=H, B=B, chunk=chunk,
                 probes=probes)
    inv = consts[0]
    S, O = consts[6].shape
    with torch.cuda.device(dev):
        scratch = torch.empty(scratch_words(K, W, ic), dtype=torch.int32,
                              device=dev)
        stream = raw_stream(dev)
        ptrs = list(consts[:7]) + list(carry) + [scratch]
        _native.launch("wgl_chunk", [t.data_ptr() for t in ptrs],
                       [inv.shape[0], ic, W, S, O, K, H, B, chunk, probes,
                        int(consts[7]), int(consts[8]), int(consts[9])],
                       stream)
    _count_launch()
    return carry


chunk.launches = 0


def _count_launch():
    # inside `chunk` the name is its round-count parameter
    chunk.launches += 1
