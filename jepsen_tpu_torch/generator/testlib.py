"""Deterministic virtual-time generator simulation (no threads, no wall
clock) — capability parity with jepsen.generator.test
(`jepsen/src/jepsen/generator/test.clj:50-80`): `simulate` runs a
generator against a completion function under a virtual clock, `quick` /
`perfect` / `perfect_info` / `imperfect` model standard executions, and
randomness is pinned to RAND_SEED (test.clj:44-48 pins 45100) so op
sequences are exact values tests can assert on.

The port's copy of `jepsen_tpu/generator/testlib.py`.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Optional

from . import (NEMESIS, PENDING, Context, secs_to_nanos, with_seed)
from . import context as make_context
from . import op as gen_op
from . import update as gen_update
from . import validate

RAND_SEED = 45100
PERFECT_LATENCY = 10  # nanos (test.clj:118-120)

DEFAULT_TEST: dict = {}


def n_nemesis_context(n: int) -> Context:
    """n worker threads plus the nemesis (test.clj:16-24)."""
    return make_context({"concurrency": n})


def default_context() -> Context:
    return n_nemesis_context(2)


def invocations(history):
    return [o for o in history if o.get("type") == "invoke"]


def simulate(gen, complete_fn: Callable, ctx: Optional[Context] = None,
             test: Optional[dict] = None):
    """Simulate the op series from `gen`, with `complete_fn(ctx, invoke)`
    producing each invocation's completion (test.clj:50-80). Returns the
    full simulated history as a list of op dicts."""
    ctx = ctx or default_context()
    test = test if test is not None else DEFAULT_TEST
    with with_seed(RAND_SEED):
        ops: list = []
        in_flight: list = []  # completions, sorted by time
        gen = validate(gen)
        while True:
            res = gen_op(gen, test, ctx)
            if res is None:
                return ops + [o for o in in_flight
                              if not o.get("_silent")]
            invoke, gen2 = res
            if invoke is not PENDING and (
                    not in_flight
                    or invoke["time"] <= in_flight[0]["time"]):
                # Apply the invocation: clock forward, thread busy.
                thread = ctx.process_to_thread(invoke["process"])
                ctx = replace(ctx, time=max(ctx.time, invoke["time"]),
                              free_threads=ctx.free_threads - {thread})
                gen = gen_update(gen2, test, ctx, invoke)
                if invoke["type"] in ("sleep", "log"):
                    # the worker naps for `value` seconds / logs; these
                    # never enter the history but do consume the thread,
                    # and the worker echoes the op back unchanged
                    # (interpreter.py:117-124, goes_in_history :162)
                    dt = secs_to_nanos(invoke.get("value") or 0) \
                        if invoke["type"] == "sleep" else 0
                    complete = {**invoke,
                                "time": invoke["time"] + dt,
                                "_silent": True}
                else:
                    complete = complete_fn(ctx, invoke)
                    ops.append(invoke)
                in_flight = sorted(in_flight + [complete],
                                   key=lambda o: o["time"])
            else:
                # Complete something before the next invocation; the
                # speculative invoke is discarded and re-asked next loop.
                assert in_flight, "generator pending and nothing in flight"
                done = in_flight[0]
                thread = ctx.process_to_thread(done["process"])
                ctx = replace(ctx, time=max(ctx.time, done["time"]),
                              free_threads=ctx.free_threads | {thread})
                silent = done.pop("_silent", False)
                gen = gen_update(gen, test, ctx, done)
                if silent:
                    # waking from a sleep/log: updates the generator
                    # (the interpreter passes the echoed op to update
                    # too) but never enters the history
                    in_flight = in_flight[1:]
                    continue
                if thread != NEMESIS and done.get("type") == "info":
                    workers = dict(ctx.workers)
                    workers[thread] = ctx.next_process(thread)
                    ctx = replace(ctx, workers=workers)
                ops.append(done)
                in_flight = in_flight[1:]


def quick_ops(gen, ctx=None):
    """Every op completes :ok instantly with zero latency."""
    return simulate(gen, lambda c, inv: {**inv, "type": "ok"}, ctx)


def quick(gen, ctx=None):
    return invocations(quick_ops(gen, ctx))


def perfect_star(gen, ctx=None):
    """Every op completes :ok after PERFECT_LATENCY ns; full history."""
    return simulate(
        gen,
        lambda c, inv: {**inv, "type": "ok",
                        "time": inv["time"] + PERFECT_LATENCY},
        ctx)


def perfect(gen, ctx=None):
    return invocations(perfect_star(gen, ctx))


def perfect_info(gen, ctx=None):
    """Every op crashes :info after PERFECT_LATENCY ns; invocations."""
    return invocations(simulate(
        gen,
        lambda c, inv: {**inv, "type": "info",
                        "time": inv["time"] + PERFECT_LATENCY},
        ctx))


def imperfect(gen, ctx=None):
    """Threads cycle fail -> info -> ok completions (test.clj:160-178);
    full history."""
    state: dict = {}
    nxt = {None: "fail", "fail": "info", "info": "ok", "ok": "fail"}

    def complete(c, inv):
        t = c.process_to_thread(inv["process"])
        state[t] = nxt[state.get(t)]
        return {**inv, "type": state[t],
                "time": inv["time"] + PERFECT_LATENCY}

    return simulate(gen, complete, ctx)
