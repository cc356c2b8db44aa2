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
    kernel `csrc/wgln_chunk.cu`; a CPU tensor goes to `chunk_ref`.
    There is no fallback between the two. Both update the carry in
    place.
"""

from __future__ import annotations

import torch

from . import wgl32
from .wgl32 import FR, Consts, _ctz32, _M32, _to_i32

MIN_LANES, MAX_LANES = 2, 32


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
        c, base, mst, info, linearized, sc["fr_cnt"], K=K, W=W, ic=ic)

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
    summary). `tally` gets "probed", the successor rows that went to
    the memo table."""
    def round_fn(c, fr, sc, bk, table, ring):
        return _round_ref(c, fr, sc, bk, table, ring, K=K, L=L, ic=ic, H=H,
                          B=B, probes=probes)

    return wgl32.run_chunk(consts, carry, round_fn, chunk=chunk, tally=tally)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _check_launch(consts: Consts, carry, *, K, L, ic, H, B, chunk, probes):
    if not MIN_LANES <= L <= MAX_LANES:
        raise ValueError(f"wgln lane count L={L} outside "
                         f"[{MIN_LANES}, {MAX_LANES}]")
    wgl32.check_launch(consts, carry, K=K, W=32 * L, C=row_words(L, ic),
                       ic=ic, H=H, B=B, chunk=chunk, probes=probes)


def chunk(consts: Consts, carry, *, K: int, L: int, ic: int, H: int,
          B: int, chunk: int, probes: int):
    """One chunk of the wide search (see `chunk_ref`). CUDA tensors run
    the `wgln_chunk` kernel (one launch per call, counted in
    `chunk.launches`); CPU tensors run `chunk_ref`. Updates `carry` in
    place; returns (carry, summary)."""
    dev = carry[FR].device
    if dev.type == "cpu":
        return chunk_ref(consts, carry, K=K, L=L, ic=ic, H=H, B=B,
                         chunk=chunk, probes=probes)
    if dev.type != "cuda":
        raise ValueError(f"wgln chunk: unsupported device {dev}")
    _check_launch(consts, carry, K=K, L=L, ic=ic, H=H, B=B, chunk=chunk,
                  probes=probes)
    summary = wgl32.launch("wgln_chunk", consts, carry, K=K, W=32 * L, L=L,
                           ic=ic, H=H, B=B, rounds=chunk, probes=probes)
    _count_launch()
    return carry, summary


chunk.launches = 0


def _count_launch():
    # inside `chunk` the name is its round-count parameter
    chunk.launches += 1
