"""Occupancy-driven adaptive frontier scheduling for the WGL search.

A copy of the JAX package's bucket ladder (`jepsen_tpu/ops/adapt.py`),
so both packages climb the same ladder on the same counters. A valid
history's wavefront is 2-4 configs wide, so a narrow beam wastes
nothing; an exhaustive search (an invalid or adversarial history)
must expand the whole reachable space, and there breadth amortizes the
per-round cost.

The ladder is a small set of frontier capacities; a host-side
hysteresis **policy** picks the bucket BETWEEN device chunks from the
packed poll summary the host already reads:

  * **grow** when the search looks exhaustive: configs explored pass
    an n_ok-relative threshold that quadruples per level, or the
    backlog nears capacity (overflow turns False into "unknown" —
    jump to the top bucket before that);
  * **shrink** when the beam runs persistently sparse: mean occupied
    lanes fit inside HALF the next bucket down for `patience`
    consecutive polls;
  * a bucket abandoned by a shrink-then-regrow within the thrash
    window is burned for the rest of the search.

The policy is pure Python over integers; `migrate_frontier` is a torch
pad or slice of the frontier on its device.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

# The narrow-kernel (wgl32) ladder: bottom bucket 2 (the wavefront of
# a valid register/cas/mutex history), top bucket 512 (the exhaustion
# beam). Geometric x8 spacing keeps the ladder at 4 buckets.
LADDER32 = (2, 16, 64, 512)

# Explored-configs growth schedule: level i -> i+1 when
# explored >= max(ESC_BASE, ESC_MULT * n_ok) * ESC_STEP**i.
# A valid history explores ~2.6 x n_ok configs, so 6 x n_ok never
# fires on one; the 40k floor keeps tiny adversarial histories from
# crawling at the bottom bucket for long.
ESC_BASE = 40_000
ESC_MULT = 6
ESC_STEP = 4


def enabled(default: bool = True) -> bool:
    """The adaptive kill-switch, shared with the JAX package:
    JEPSEN_TPU_ADAPTIVE=0 pins the fixed-K behavior (and the legacy
    one-shot escalation)."""
    v = os.environ.get("JEPSEN_TPU_ADAPTIVE")
    if v is None:
        return default
    return v not in ("0", "false", "no")


def ladder_for(k_max: int, k_min: int = 2, step: int = 8) -> tuple:
    """A geometric bucket ladder [k_min .. k_max] (k_max always
    included). Powers of two, ascending."""
    k_max = max(1, int(k_max))
    k_min = max(1, min(int(k_min), k_max))
    out = []
    k = k_min
    while k < k_max:
        out.append(k)
        k *= step
    out.append(k_max)
    return tuple(out)


def recommend(ladder: tuple, occupied: float) -> int:
    """The stateless hint: the smallest bucket that holds ~2x the
    observed mean occupancy."""
    want = max(1.0, 2.0 * float(occupied))
    for k in ladder:
        if k >= want:
            return k
    return ladder[-1]


@dataclass
class Decision:
    """One policy verdict."""

    switch: bool
    to_k: int
    reason: str


# ---------------------------------------------------------------------------
# ladder pin
# ---------------------------------------------------------------------------
# A process-wide pin that every live Policy consults per poll: while a
# pin is set, the policy forces one rebucket to the pinned capacity
# (reason "pinned") and then HOLDS there. `unpin_ladder` restores
# normal hysteresis on the very next poll.

_PIN_LOCK = threading.Lock()
_PIN: Optional[dict] = None


def pin_ladder(k: int, reason: str = "autopilot") -> dict:
    """Pin every live (and future) Policy to bucket `k`. Returns the
    pin record {k, reason, t}; re-pinning replaces the prior pin."""
    global _PIN
    pin = {"k": int(k), "reason": str(reason),
           "t": round(time.time(), 3)}
    with _PIN_LOCK:
        _PIN = pin
    return pin


def unpin_ladder() -> Optional[dict]:
    """Clear the pin; returns the pin that was cleared, None when none
    was set."""
    global _PIN
    with _PIN_LOCK:
        pin, _PIN = _PIN, None
    return pin


def ladder_pin() -> Optional[dict]:
    """The active pin record, None when the ladder floats freely."""
    with _PIN_LOCK:
        return _PIN


@dataclass
class Policy:
    """Hysteresis bucket selection from per-poll occupancy inputs.

    `observe()` is called once per device poll with cumulative
    explored plus this chunk's round/expansion deltas and the
    end-of-chunk frontier/backlog counts; it returns a `Decision`.
    The caller owns the carry migration (`wgl._search_loop` /
    `migrate_frontier`).
    """

    ladder: tuple
    n_ok: int
    backlog_cap: int            # B: jump to top before overflow
    start_k: Optional[int] = None
    esc_base: int = ESC_BASE
    esc_mult: int = ESC_MULT
    esc_step: int = ESC_STEP
    shrink_frac: float = 0.5    # occupied <= frac * lower bucket
    patience: int = 2           # consecutive sparse polls to shrink
    level: int = field(init=False)
    sparse_streak: int = field(default=0, init=False)
    burned: set = field(default_factory=set, init=False)
    switches: list = field(default_factory=list, init=False)

    def __post_init__(self):
        self.ladder = tuple(sorted(set(int(k) for k in self.ladder)))
        if not self.ladder:
            raise ValueError("empty ladder")
        # an active pin outranks the caller's start bucket
        pin = ladder_pin()
        if pin is not None and int(pin["k"]) in self.ladder:
            self.start_k = int(pin["k"])
        self.level = (self.ladder.index(self.start_k)
                      if self.start_k in self.ladder else 0)

    @property
    def k(self) -> int:
        return self.ladder[self.level]

    def _esc_threshold(self) -> int:
        base = max(self.esc_base, self.esc_mult * max(self.n_ok, 1))
        return base * (self.esc_step ** self.level)

    def observe(self, *, explored: int, rounds_delta: int,
                explored_delta: int, frontier: int,
                backlog: int) -> Decision:
        k = self.k
        top = len(self.ladder) - 1
        # a pin outranks every signal EXCEPT backlog pressure (a pin
        # must not turn a False verdict into "backlog-overflow")
        pin = ladder_pin()
        if pin is not None and int(pin["k"]) in self.ladder \
                and backlog < max(1, self.backlog_cap // 8):
            lvl = self.ladder.index(int(pin["k"]))
            if lvl != self.level:
                return self._switch(lvl, "pinned")
            return Decision(False, k, "pinned")
        # overflow prevention outranks everything: a backlog within
        # 1/8 of capacity risks turning a False verdict into
        # "backlog-overflow"/unknown — take the whole top beam now
        if self.level < top and backlog >= max(1, self.backlog_cap // 8):
            return self._switch(top, "backlog-pressure")
        # exhaustion regime: explored blew through this level's
        # threshold — the search is enumerating, breadth amortizes
        if self.level < top and explored >= self._esc_threshold():
            return self._switch(self.level + 1, "explored-threshold")
        # sparse beam: mean occupied lanes fit well inside the next
        # bucket down, for `patience` consecutive polls
        if self.level > 0 and rounds_delta > 0:
            occupied = explored_delta / rounds_delta
            lower = self.ladder[self.level - 1]
            fits = (occupied <= self.shrink_frac * lower
                    and frontier <= lower
                    and self.level - 1 not in self.burned)
            self.sparse_streak = self.sparse_streak + 1 if fits else 0
            if self.sparse_streak >= self.patience:
                return self._switch(self.level - 1, "sparse-frontier")
        else:
            self.sparse_streak = 0
        return Decision(False, k, "hold")

    def _switch(self, new_level: int, reason: str) -> Decision:
        # shrink-then-regrow inside the thrash window burns the
        # abandoned lower bucket: oscillating wavefronts settle at
        # the wider bucket instead of ping-ponging
        if (new_level > self.level and self.switches
                and self.switches[-1][1] < self.switches[-1][0]):
            self.burned.add(self.level)
        self.switches.append((self.level, new_level, reason))
        self.level = new_level
        self.sparse_streak = 0
        return Decision(True, self.k, reason)

    def summary(self) -> dict:
        """The `util.adapt` block: what the ladder did this search."""
        return {
            "ladder": list(self.ladder),
            "final_K": self.k,
            "switches": len(self.switches),
            "path": [[self.ladder[a], self.ladder[b], r]
                     for a, b, r in self.switches],
            "buckets_visited": sorted(
                {self.ladder[0]} | {self.ladder[b]
                                    for _, b, _ in self.switches}),
        }


def migrate_frontier(carry, k_new: int):
    """Re-bucket a wgl32 carry between chunks: the frontier (K, C)
    grows by zero-padding (rows past fr_cnt are inert) or shrinks by
    slicing, on its own device. The caller must only shrink when the
    polled fr_cnt <= k_new (the policy's sparse rule guarantees it);
    backlog/memo/flags/stats/ring ride along untouched."""
    import torch

    fr = carry[0]
    k_old = fr.shape[0]
    if k_new == k_old:
        return carry
    if k_new > k_old:
        fr = torch.cat([fr, fr.new_zeros((k_new - k_old, fr.shape[1]))])
    else:
        fr = fr[:k_new].contiguous()
    return (fr, *carry[1:])


def migrate_frontier_batch(carry, k_new: int):
    """`migrate_frontier` for a lane-batched carry (the JAX package's
    `migrate_frontier_batch`): the frontier is (lanes, K, C), so the
    pad or slice runs on axis 1. The plain version of the mesh
    scheduler's `wgl_frontier_migrate` kernel (`parallel.mesh.
    migrate_lanes`). Only shrink when every live lane's polled fr_cnt
    fits k_new (the scheduler's sparse rule guarantees it); the other
    leaves ride along untouched, and the same carry comes back when K
    does not change."""
    import torch

    fr = carry[0]
    k_old = fr.shape[1]
    if k_new == k_old:
        return carry
    if k_new > k_old:
        fr = torch.cat([fr, fr.new_zeros((fr.shape[0], k_new - k_old,
                                          fr.shape[2]))], dim=1)
    else:
        fr = fr[:, :k_new].contiguous()
    return (fr, *carry[1:])


def precompile_ladder(*, n_pad: int, ic_pad: int, S: int, O: int,
                      H: int, B: int, chunk: int, probes: int,
                      W: int, L: int = 0, ladder: tuple = LADDER32,
                      device=None) -> dict:
    """Warm every ladder bucket's kernel for one shape bucket, on
    `device` (None: the card): per bucket, the consts and the carry the
    search makes (`ops/wgl._search_loop`), zeroed, and one chunk with a
    zero config budget, so that the loop exits before its first round,
    through the search's own wrapper (`wgl32.chunk` / `wgln.chunk`) and
    so in the launch form the search takes at that K. The first launch
    builds, loads and binds the kernel and loads its form onto the card;
    the allocator keeps the bucket's segments. One sync per bucket is
    the job. The reference's layout knobs (`accel`, `depth`, `pack`)
    have no counterpart: the port's kernels have one layout. Returns
    {K: seconds}."""
    import time as _t

    import numpy as np
    import torch

    from ..util import resolve_device
    from . import wgl32, wgln

    dev = resolve_device(device)
    z = np.zeros(n_pad, np.int32)
    zi = np.zeros(ic_pad, np.int32)
    out: dict = {}
    for k in ladder:
        t0 = _t.monotonic()
        # max_cfg 0: zero rounds run
        consts = wgl32.consts_from_numpy(
            z, z, z, np.zeros(n_pad + 1, np.int32), zi, zi,
            np.zeros((S, O), np.int32), 0, 0, 0, dev)
        if L:
            carry = wgln.init_carry(k, L, ic_pad, H, B, 0, dev)
            _, summary = wgln.chunk(consts, carry, K=k, L=L, ic=ic_pad, H=H,
                                    B=B, chunk=chunk, probes=probes)
        else:
            carry = wgl32.init_carry(k, wgl32.row_words(ic_pad), H, B, 0,
                                     dev)
            _, summary = wgl32.chunk(consts, carry, K=k, W=W, ic=ic_pad,
                                     H=H, B=B, chunk=chunk, probes=probes)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        del carry, summary
        out[k] = _t.monotonic() - t0
    return out
