"""Synthetic concurrent histories for tests and the chip smoke.

Simulates N logical processes running against a *real* in-memory object
(cas-register / mutex) under a random interleaving, emitting
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
