"""Synthetic concurrent histories for tests and the chip smoke.

Simulates N logical processes running against a *real* in-memory object
(cas-register / mutex / fifo-queue) under a random interleaving, emitting
invoke/ok/fail/info events exactly as the interpreter journals them.
Because ops execute against real state, the histories are linearizable
by construction; `lie_p` injects occasional wrong read values to produce
known-invalid histories; `crash_p` leaves ops in the :info state
(applied or not, at random), exercising the may-linearize path.

A copy of the JAX package's generators: the same seed gives the same
history in both packages.
"""

from __future__ import annotations

import random
from typing import Optional

from . import history as h


def cas_register_history(n_ops: int, n_procs: int = 5, values: int = 5,
                         crash_p: float = 0.02, lie_p: float = 0.0,
                         seed: int = 0,
                         fs=("read", "write", "cas")) -> h.History:
    """A concurrent cas-register run (r/w/cas over `values` small ints,
    matching the reference workload's rand-int 5 values,
    jepsen/src/jepsen/tests/linearizable_register.clj:18-20)."""
    rng = random.Random(seed)
    hist = h.History()
    reg: Optional[int] = None
    pending: dict = {}
    free = list(range(n_procs))
    next_pid = n_procs
    issued = 0
    t = 0
    while issued < n_ops or pending:
        can_invoke = free and issued < n_ops
        if not can_invoke and not pending:
            break
        if can_invoke and (not pending or rng.random() < 0.6):
            p = free.pop(rng.randrange(len(free)))
            f = rng.choice(fs)
            if f == "read":
                v = None
            elif f == "write":
                v = rng.randrange(values)
            else:
                v = [rng.randrange(values), rng.randrange(values)]
            hist.append(h.invoke(p, f, v, time=t))
            pending[p] = (f, v)
            issued += 1
        else:
            p = rng.choice(list(pending))
            f, v = pending.pop(p)
            r = rng.random()
            if r < crash_p:
                hist.append(h.info(p, f, v, time=t))
                if rng.random() < 0.5 and f != "read":
                    if f == "write":
                        reg = v
                    elif v[0] == reg:
                        reg = v[1]
                # a crashed process is retired; the interpreter assigns a
                # fresh process id to its worker (interpreter.clj:233-236)
                free.append(next_pid)
                next_pid += 1
            else:
                if f == "read":
                    val = reg
                    if lie_p and rng.random() < lie_p:
                        val = (reg or 0) + 1
                    hist.append(h.ok(p, f, val, time=t))
                elif f == "write":
                    reg = v
                    hist.append(h.ok(p, f, v, time=t))
                else:
                    if v[0] == reg:
                        reg = v[1]
                        hist.append(h.ok(p, f, v, time=t))
                    else:
                        hist.append(h.fail(p, f, v, time=t))
                free.append(p)
        t += 1
    return hist.index()


def mutex_history(n_ops: int, n_procs: int = 4, seed: int = 0) -> h.History:
    """A concurrent mutex run: processes race to acquire; the simulated
    lock serializes them, so the history is linearizable."""
    rng = random.Random(seed)
    hist = h.History()
    holder: Optional[int] = None
    pending: dict = {}  # process -> f
    free = list(range(n_procs))
    issued = 0
    t = 0
    while issued < n_ops or pending:
        can_invoke = free and issued < n_ops
        if not can_invoke and not pending:
            break
        if can_invoke and (not pending or rng.random() < 0.5):
            p = free.pop(rng.randrange(len(free)))
            f = "release" if p == holder else "acquire"
            hist.append(h.invoke(p, f, None, time=t))
            pending[p] = f
            issued += 1
        else:
            # complete a pending op that is currently legal, if any
            completable = [p for p, f in pending.items()
                           if (f == "acquire" and holder is None)
                           or (f == "release" and holder == p)]
            if not completable:
                # everyone is stuck waiting on the lock: nobody can
                # complete until the holder releases — force an invoke
                if free and issued < n_ops:
                    continue
                break
            p = rng.choice(completable)
            f = pending.pop(p)
            holder = p if f == "acquire" else None
            hist.append(h.ok(p, f, None, time=t))
            free.append(p)
        t += 1
    return hist.index()


def fifo_queue_history(n_ops: int, n_procs: int = 4, seed: int = 0
                       ) -> h.History:
    """A concurrent FIFO-queue run against a real queue."""
    rng = random.Random(seed)
    hist = h.History()
    q: list = []
    nxt = 0
    pending: dict = {}
    free = list(range(n_procs))
    issued = 0
    t = 0
    while issued < n_ops or pending:
        can_invoke = free and issued < n_ops
        if not can_invoke and not pending:
            break
        if can_invoke and (not pending or rng.random() < 0.6):
            p = free.pop(rng.randrange(len(free)))
            # a dequeue is only issued when something can satisfy it,
            # or every process could end up blocked on an empty queue
            can_deq = q or any(f == "enqueue"
                               for f, _ in pending.values())
            if rng.random() < 0.55 or not can_deq:
                f, v = "enqueue", nxt
                nxt += 1
            else:
                f, v = "dequeue", None
            hist.append(h.invoke(p, f, v, time=t))
            pending[p] = (f, v)
            issued += 1
        else:
            completable = [p for p, (f, _) in pending.items()
                           if f == "enqueue" or q]
            if not completable:
                if free and issued < n_ops:
                    continue
                break
            p = rng.choice(completable)
            f, v = pending.pop(p)
            if f == "enqueue":
                q.append(v)
                hist.append(h.ok(p, f, v, time=t))
            else:
                hist.append(h.ok(p, f, q.pop(0), time=t))
            free.append(p)
        t += 1
    return hist.index()


def long_tail_history(n_quick: int, n_slow: int = 1, values: int = 5,
                      lie_p: float = 0.0, seed: int = 0) -> h.History:
    """Porcupine-style adversarial long tail: `n_slow` reads stay open
    across the whole run while other processes complete `n_quick` fast
    ops — every fast op overlaps the slow ones, so the WGL window
    requirement is ~n_quick (BASELINE.md "adversarial long-tail
    histories"; the JVM checker degrades in exactly this regime)."""
    rng = random.Random(seed)
    hist = h.History()
    reg: Optional[int] = None
    t = 0
    for p in range(n_slow):
        hist.append(h.invoke(p, "read", None, time=t))
        t += 1
    fast = n_slow
    for _ in range(n_quick):
        f = rng.choice(["write", "read", "cas"])
        if f == "write":
            v = rng.randrange(values)
        elif f == "cas":
            v = [rng.randrange(values), rng.randrange(values)]
        else:
            v = None
        hist.append(h.invoke(fast, f, v, time=t))
        t += 1
        if f == "write":
            reg = v
            hist.append(h.ok(fast, f, v, time=t))
        elif f == "cas":
            if v[0] == reg:
                reg = v[1]
                hist.append(h.ok(fast, f, v, time=t))
            else:
                hist.append(h.fail(fast, f, v, time=t))
        else:
            out = reg
            if lie_p and rng.random() < lie_p:
                out = (reg or 0) + 1
            hist.append(h.ok(fast, f, out, time=t))
        t += 1
    # the slow reads finally return: any value the register ever held is
    # linearizable somewhere in their span; report the final value
    for p in range(n_slow):
        hist.append(h.ok(p, "read", reg, time=t))
        t += 1
    return hist.index()


def adversarial_wave_history(n_waves: int, width: int = 14,
                             span: int = 5, seed: int = 0,
                             invalid: bool = True) -> h.History:
    """The device-or-nothing benchmark shape: a history whose decision
    REQUIRES mass state-space exhaustion, engineered so the reachable
    config count exceeds what a host DFS can visit in the 60 s budget
    while staying inside the device kernel's capacities.

    Structure (Porcupine-adversarial family, BASELINE.md "long-tail
    histories"; cf. the reference's truncated-analysis warning at
    jepsen/src/jepsen/checker.clj:213-216 — the JVM checker gives up on
    exactly this regime):

      * `n_waves` waves of `width` CONCURRENT blind writes of distinct
        values. Blind writes make every interleaving legal, so an
        exhaustive verdict must visit ~width * 2^(width-1) configs per
        wave (window-mask subsets x last-writer states). Waves are
        real-time ordered, so the space is the SUM over waves, not the
        product — total configs are tuned linearly by `n_waves`.
      * a straggler read held open across `span` waves stretches the
        WGL window to ~span*width+1 ops (> 32 forces the general
        wide-window kernel, not the uint32 fast path) without adding
        branching of its own.
      * `invalid` appends a final read of a never-written value, so
        NO search can shortcut: proving False means exhausting every
        reachable config — the fair fight between engines.

    At the defaults, width=14 gives ~135k configs/wave (measured;
    host oracle ~25-30k configs/s, i.e. DNF past ~14 waves), and the
    wavefront (~C(14,7)*14 = 48k live configs) fits the general
    kernel's scaled backlog (ops/wgl.py _pick_capacities)."""
    rng = random.Random(seed)
    hist = h.History()
    t = 0
    val = 0
    strag_pid = width  # dedicated straggler process id
    strag_open_since: Optional[int] = None
    last_wave_val: Optional[int] = None
    for wv in range(n_waves):
        if strag_open_since is None:
            hist.append(h.invoke(strag_pid, "read", None, time=t))
            t += 1
            strag_open_since = wv
        order = list(range(width))
        rng.shuffle(order)
        wave_vals = []
        for p in order:
            v = val
            val += 1
            hist.append(h.invoke(p, "write", v, time=t))
            t += 1
            wave_vals.append((p, v))
        rng.shuffle(wave_vals)
        for p, v in wave_vals:
            hist.append(h.ok(p, "write", v, time=t))
            t += 1
            last_wave_val = v
        if wv - strag_open_since + 1 >= span:
            # straggler returns the last write of this wave — legal
            # (linearize the read right here), so it constrains nothing
            hist.append(h.ok(strag_pid, "read", last_wave_val, time=t))
            t += 1
            strag_open_since = None
    if strag_open_since is not None:
        hist.append(h.ok(strag_pid, "read", last_wave_val, time=t))
        t += 1
    hist.append(h.invoke(0, "read", None, time=t))
    t += 1
    hist.append(h.ok(0, "read",
                     -1 if invalid else last_wave_val, time=t))
    return hist.index()
