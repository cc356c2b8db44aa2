"""Pure-functional generator DSL: what operations to run, and when.

Capability parity with jepsen.generator
(`jepsen/src/jepsen/generator.clj`). A generator is an immutable value
answering two questions (the `Generator` protocol, generator.clj:382-390):

    op(gen, test, ctx)            -> None                (exhausted)
                                   | (PENDING, gen')     (nothing *yet*)
                                   | (op_dict, gen')     (an operation)
    update(gen, test, ctx, event) -> gen'                (observe an event)

where `ctx` tracks virtual time, the set of free threads, and the
thread→process map (generator.clj:453-464). Because generators are pure
values, the scheduler (generator/interpreter.py) is single-threaded and
deterministic given an RNG seed — the reference moved to this design
because its mutable predecessor "was plagued by race conditions"
(generator.clj:23-31).

Base lifts (generator.clj:545-620): None is exhausted; a dict emits one
op (fields filled from ctx); a callable is invoked for a fresh generator
each op; a list/tuple is a sequence of generators run back to back.

Ops here are plain dicts ({"type","f","value","process","time"}); the
interpreter journals them into `history.Op` records. Special
op types: "sleep" (worker naps), "log" (worker logs), "pending".

Randomness goes through the module RNG so tests can pin it
(`with_seed`, mirroring generator/test.clj:31-48's fixed rand).

The port's copy of `jepsen_tpu/generator/__init__.py`.
"""

from __future__ import annotations

import random as _random
from contextlib import contextmanager
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Any, Callable, Optional

PENDING = "pending"
NEMESIS = "nemesis"

RNG = _random.Random()


@contextmanager
def with_seed(seed: int):
    """Pin the DSL's randomness (generator/test.clj pins rand-seed 45100)."""
    state = RNG.getstate()
    RNG.seed(seed)
    try:
        yield
    finally:
        RNG.setstate(state)


def secs_to_nanos(s) -> int:
    return int(s * 1_000_000_000)


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Context:
    """Scheduler context: virtual time, free threads, thread→process map
    (generator.clj:453-464). Threads are NEMESIS plus ints [0, n)."""

    time: int
    free_threads: frozenset
    workers: dict  # thread -> process

    def sorted_free_threads(self) -> list:
        # deterministic order regardless of PYTHONHASHSEED
        return sorted(self.free_threads, key=str)

    def free_processes(self) -> list:
        return [self.workers[t] for t in self.sorted_free_threads()]

    def some_free_process(self):
        """A *random* free process — uniform choice prevents thread
        starvation (generator.clj:66-77 "Fair sets")."""
        if not self.free_threads:
            return None
        ts = self.sorted_free_threads()
        return self.workers[ts[RNG.randrange(len(ts))]]

    def all_threads(self) -> list:
        return list(self.workers)

    def all_processes(self) -> list:
        return list(self.workers.values())

    def process_to_thread(self, process):
        for t, p in self.workers.items():
            if p == process:
                return t
        return None

    def thread_to_process(self, thread):
        return self.workers.get(thread)

    def next_process(self, thread):
        """Replacement process id for a crashed process on `thread`
        (generator.clj:519-527): old process + count of numeric
        processes. Nemesis never changes."""
        if isinstance(thread, int):
            return (self.workers[thread]
                    + sum(1 for p in self.all_processes()
                          if isinstance(p, int)))
        return thread

    def restrict(self, pred: Callable[[Any], bool]) -> "Context":
        """Context visible to a thread-restricted generator
        (on-threads-context, generator.clj:846-862)."""
        return Context(
            time=self.time,
            free_threads=frozenset(t for t in self.free_threads if pred(t)),
            workers={t: p for t, p in self.workers.items() if pred(t)})

    def busy_thread(self, thread) -> "Context":
        return replace(self,
                       free_threads=self.free_threads - {thread})

    def free_thread(self, thread) -> "Context":
        return replace(self,
                       free_threads=self.free_threads | {thread})


def context(test: dict) -> Context:
    """Initial context for a test (generator.clj:453-464): `concurrency`
    worker threads plus the nemesis."""
    threads = [NEMESIS] + list(range(test.get("concurrency", 1)))
    return Context(time=0,
                   free_threads=frozenset(threads),
                   workers={t: t for t in threads})


def fill_in_op(op: dict, ctx: Context):
    """Fill :time, :process, :type from context; PENDING when no process
    is free (generator.clj:531-543)."""
    p = ctx.some_free_process()
    if p is None:
        return PENDING
    out = dict(op)
    out.setdefault("time", ctx.time)
    out.setdefault("process", p)
    out.setdefault("type", "invoke")
    return out


# ---------------------------------------------------------------------------
# Protocol dispatch over base types (generator.clj:545-620)
# ---------------------------------------------------------------------------

class Generator:
    """Base class for combinator generators."""

    def op(self, test, ctx):
        raise NotImplementedError

    def update(self, test, ctx, event):
        return self


def op(gen, test, ctx):
    """Ask `gen` for an operation: None | (PENDING, gen') | (op, gen')."""
    if gen is None:
        return None
    if isinstance(gen, Generator):
        return gen.op(test, ctx)
    if isinstance(gen, dict):
        o = fill_in_op(gen, ctx)
        return (o, gen if o is PENDING else None)
    if callable(gen):
        x = _call_fn_gen(gen, test, ctx)
        if x is None:
            return None
        res = op([x, gen], test, ctx)
        return res
    if isinstance(gen, (list, tuple)):
        # a sequence of generators, run in order
        i = 0
        gen = list(gen)
        while i < len(gen):
            res = op(gen[i], test, ctx)
            if res is None:
                i += 1
                continue
            o, g2 = res
            rest = gen[i + 1:]
            return (o, [g2] + rest if rest else g2)
        return None
    raise TypeError(f"don't know how to generate ops from {gen!r}")


def update(gen, test, ctx, event):
    """Inform `gen` that an event happened; returns the evolved gen."""
    if gen is None:
        return None
    if isinstance(gen, Generator):
        return gen.update(test, ctx, event)
    if isinstance(gen, dict) or callable(gen):
        return gen
    if isinstance(gen, (list, tuple)):
        gen = list(gen)
        if not gen:
            return None
        return [update(gen[0], test, ctx, event)] + gen[1:]
    raise TypeError(f"don't know how to update {gen!r}")


@lru_cache(maxsize=1024)
def _fn_gen_arity(f) -> int:
    try:
        import inspect
        sig = inspect.signature(f)
        return len([p for p in sig.parameters.values()
                    if p.default is inspect.Parameter.empty
                    and p.kind in (p.POSITIONAL_ONLY,
                                   p.POSITIONAL_OR_KEYWORD)])
    except (TypeError, ValueError):
        return 0


def _call_fn_gen(f, test, ctx):
    """Call a function generator with (test, ctx) if it accepts them,
    else with no args (generator.clj:557-563 checks arity)."""
    return f(test, ctx) if _fn_gen_arity(f) == 2 else f()


# ---------------------------------------------------------------------------
# Validation wrappers
# ---------------------------------------------------------------------------

class InvalidOp(Exception):
    def __init__(self, problems, res, ctx):
        super().__init__(
            "Generator produced an invalid [op, gen'] tuple: "
            + "; ".join(problems) + f"\nresult: {res!r}\ncontext: {ctx!r}")
        self.problems = problems


class Validate(Generator):
    """Checks well-formedness of emitted ops (generator.clj:622-676)."""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        problems = []
        if not (isinstance(res, tuple) and len(res) == 2):
            problems = ["should return a tuple of two elements"]
        else:
            o = res[0]
            if o is not PENDING:
                if not isinstance(o, dict):
                    problems.append("should be PENDING or a dict")
                else:
                    if o.get("type") not in ("invoke", "info", "sleep", "log"):
                        problems.append(
                            "type should be invoke, info, sleep, or log")
                    if not isinstance(o.get("time"), (int, float)):
                        problems.append("time should be a number")
                    if o.get("process") is None:
                        problems.append("no process")
                    elif o["process"] not in ctx.free_processes():
                        problems.append(
                            f"process {o['process']!r} is not free")
        if problems:
            raise InvalidOp(problems, res, ctx)
        return (res[0], Validate(res[1]))

    def update(self, test, ctx, event):
        return Validate(update(self.gen, test, ctx, event))


def validate(gen):
    return Validate(gen)


class FriendlyExceptions(Generator):
    """Attaches generator + context to exceptions (generator.clj:678-718)."""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        try:
            res = op(self.gen, test, ctx)
        except Exception as e:
            raise RuntimeError(
                f"Generator threw {type(e).__name__} when asked for an "
                f"operation.\nGenerator: {self.gen!r}\nContext: {ctx!r}"
            ) from e
        if res is None:
            return None
        return (res[0], FriendlyExceptions(res[1]))

    def update(self, test, ctx, event):
        try:
            g = update(self.gen, test, ctx, event)
        except Exception as e:
            raise RuntimeError(
                f"Generator threw {type(e).__name__} when updated with "
                f"{event!r}.\nGenerator: {self.gen!r}\nContext: {ctx!r}"
            ) from e
        return FriendlyExceptions(g)


def friendly_exceptions(gen):
    return FriendlyExceptions(gen)


class Trace(Generator):
    """Logs op/update calls (generator.clj:720-763)."""

    def __init__(self, k, gen, logger=None):
        import logging
        self.k = k
        self.gen = gen
        self.logger = logger or logging.getLogger("jepsen_tpu_torch.generator")

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        self.logger.info("%s op -> %r", self.k,
                         None if res is None else res[0])
        if res is None:
            return None
        return (res[0], Trace(self.k, res[1], self.logger))

    def update(self, test, ctx, event):
        self.logger.info("%s update %r", self.k, event)
        return Trace(self.k, update(self.gen, test, ctx, event), self.logger)


def trace(k, gen):
    return Trace(k, gen)


# ---------------------------------------------------------------------------
# Transformation combinators
# ---------------------------------------------------------------------------

class Map(Generator):
    """Transform ops with f (generator.clj:766-789)."""

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        return (o if o is PENDING else self.f(o), Map(self.f, g2))

    def update(self, test, ctx, event):
        return Map(self.f, update(self.gen, test, ctx, event))


def map_(f, gen):
    return Map(f, gen)


def f_map(fmap: dict, gen):
    """Rewrite op :f values through a mapping — used when composing
    nemeses (generator.clj:790-796)."""
    def transform(o):
        o = dict(o)
        o["f"] = fmap.get(o.get("f"), o.get("f"))
        return o
    return Map(transform, gen)


class Filter(Generator):
    """Pass only ops matching f; PENDING/None bypass
    (generator.clj:798-818)."""

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        gen = self.gen
        while True:
            res = op(gen, test, ctx)
            if res is None:
                return None
            o, g2 = res
            if o is PENDING or self.f(o):
                return (o, Filter(self.f, g2))
            gen = g2

    def update(self, test, ctx, event):
        return Filter(self.f, update(self.gen, test, ctx, event))


def filter_(f, gen):
    return Filter(f, gen)


class IgnoreUpdates(Generator):
    """(generator.clj:820-826)"""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        return op(self.gen, test, ctx)

    def update(self, test, ctx, event):
        return self


def ignore_updates(gen):
    return IgnoreUpdates(gen)


class OnUpdate(Generator):
    """Custom update handler (generator.clj:828-843)."""

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        return (res[0], OnUpdate(self.f, res[1]))

    def update(self, test, ctx, event):
        return self.f(self, test, ctx, event)


def on_update(f, gen):
    return OnUpdate(f, gen)


class OnThreads(Generator):
    """Restrict a generator to threads satisfying f
    (generator.clj:864-886)."""

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx.restrict(self.f))
        if res is None:
            return None
        return (res[0], OnThreads(self.f, res[1]))

    def update(self, test, ctx, event):
        if self.f(ctx.process_to_thread(event.get("process"))):
            return OnThreads(self.f, update(self.gen, test,
                                            ctx.restrict(self.f), event))
        return self


def on_threads(f, gen):
    return OnThreads(f, gen)


on = on_threads


def soonest_op_map(m1: Optional[dict], m2: Optional[dict]) -> Optional[dict]:
    """Pick whichever candidate op occurs sooner; ties break randomly
    proportional to weight (generator.clj:888-934)."""
    if m1 is None:
        return m2
    if m2 is None:
        return m1
    op1, op2 = m1["op"], m2["op"]
    if op1 is PENDING:
        return m2
    if op2 is PENDING:
        return m1
    t1, t2 = op1.get("time"), op2.get("time")
    if t1 == t2:
        w1 = m1.get("weight", 1)
        w2 = m2.get("weight", 1)
        pick = m1 if RNG.randrange(w1 + w2) < w1 else m2
        return {**pick, "weight": w1 + w2}
    return m1 if t1 < t2 else m2


class Any(Generator):
    """Ops from whichever sub-generator is soonest; updates go to all
    (generator.clj:936-957)."""

    def __init__(self, gens):
        self.gens = list(gens)

    def op(self, test, ctx):
        soonest = None
        for i, g in enumerate(self.gens):
            res = op(g, test, ctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1], "i": i})
        if soonest is None:
            return None
        gens = list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return (soonest["op"], Any(gens))

    def update(self, test, ctx, event):
        return Any([update(g, test, ctx, event) for g in self.gens])


def any_(*gens):
    if not gens:
        return None
    if len(gens) == 1:
        return gens[0]
    return Any(gens)


class EachThread(Generator):
    """An independent copy of the generator per thread
    (generator.clj:959-1006)."""

    def __init__(self, fresh_gen, gens: Optional[dict] = None):
        self.fresh_gen = fresh_gen
        self.gens = gens or {}

    def op(self, test, ctx):
        soonest = None
        for thread in ctx.sorted_free_threads():
            g = self.gens.get(thread, self.fresh_gen)
            tctx = Context(time=ctx.time,
                           free_threads=frozenset([thread]),
                           workers={thread: ctx.workers[thread]})
            res = op(g, test, tctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1], "thread": thread})
        if soonest is not None:
            gens = dict(self.gens)
            gens[soonest["thread"]] = soonest["gen"]
            return (soonest["op"], EachThread(self.fresh_gen, gens))
        if len(ctx.free_threads) != len(ctx.workers):
            return (PENDING, self)  # busy threads may still need ops
        return None  # every thread exhausted

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread(event.get("process"))
        if thread is None:
            return self
        g = self.gens.get(thread, self.fresh_gen)
        tctx = Context(time=ctx.time,
                       free_threads=ctx.free_threads & {thread},
                       workers={thread: ctx.workers.get(thread)})
        gens = dict(self.gens)
        gens[thread] = update(g, test, tctx, event)
        return EachThread(self.fresh_gen, gens)


def each_thread(gen):
    return EachThread(gen)


class Reserve(Generator):
    """Dedicated thread ranges per generator + a default
    (generator.clj:1008-1090)."""

    def __init__(self, ranges, gens):
        self.ranges = [frozenset(r) for r in ranges]  # per-gen thread sets
        self.all_ranges = frozenset().union(*self.ranges) if ranges \
            else frozenset()
        self.gens = list(gens)  # len(ranges) + 1 (default)

    def op(self, test, ctx):
        soonest = None
        for i, threads in enumerate(self.ranges):
            rctx = ctx.restrict(lambda t, s=threads: t in s)
            res = op(self.gens[i], test, rctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1],
                              "weight": len(threads), "i": i})
        dctx = ctx.restrict(lambda t: t not in self.all_ranges)
        res = op(self.gens[-1], test, dctx)
        if res is not None:
            soonest = soonest_op_map(
                soonest, {"op": res[0], "gen": res[1],
                          "weight": len(dctx.workers),
                          "i": len(self.ranges)})
        if soonest is None:
            return None
        gens = list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return (soonest["op"], Reserve(self.ranges, gens))

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread(event.get("process"))
        i = len(self.ranges)
        for j, r in enumerate(self.ranges):
            if thread in r:
                i = j
                break
        gens = list(self.gens)
        gens[i] = update(gens[i], test, ctx, event)
        return Reserve(self.ranges, gens)


def reserve(*args):
    """reserve(5, write_gen, 10, cas_gen, read_gen): thread counts with
    their generators, then a default for the remaining threads."""
    *pairs, default = args
    assert len(pairs) % 2 == 0
    ranges, gens = [], []
    n = 0
    for i in range(0, len(pairs), 2):
        count, g = pairs[i], pairs[i + 1]
        ranges.append(set(range(n, n + count)))
        gens.append(g)
        n += count
    return Reserve(ranges, gens + [default])


def clients(client_gen, nemesis_gen=None):
    """Restrict to client threads; optionally route nemesis ops too
    (generator.clj:1093-1103)."""
    only_clients = on_threads(lambda t: t != NEMESIS, client_gen)
    if nemesis_gen is None:
        return only_clients
    return any_(only_clients, nemesis(nemesis_gen))


def nemesis(nemesis_gen, client_gen=None):
    """Restrict to the nemesis thread (generator.clj:1105-1115)."""
    only_nemesis = on_threads(lambda t: t == NEMESIS, nemesis_gen)
    if client_gen is None:
        return only_nemesis
    return any_(only_nemesis, clients(client_gen))


class Mix(Generator):
    """Uniform random mixture; ignores updates (generator.clj:1117-1154)."""

    def __init__(self, gens, i=None):
        self.gens = list(gens)
        self.i = i  # chosen lazily so construction stays RNG-free

    def op(self, test, ctx):
        gens, i = self.gens, self.i
        if i is None and gens:
            i = RNG.randrange(len(gens))
        while gens:
            res = op(gens[i], test, ctx)
            if res is not None:
                o, g2 = res
                gens = list(gens)
                gens[i] = g2
                return (o, Mix(gens, RNG.randrange(len(gens))))
            gens = gens[:i] + gens[i + 1:]
            if not gens:
                return None
            i = RNG.randrange(len(gens))
        return None

    def update(self, test, ctx, event):
        return self


def mix(gens):
    return Mix(list(gens))


class Limit(Generator):
    """At most `remaining` ops (generator.clj:1156-1170).

    Deviation: the reference decrements on PENDING results too (harmless
    there because callers discard the post-PENDING generator); here
    PENDING never consumes the budget, matching the docstring."""

    def __init__(self, remaining, gen):
        self.remaining = remaining
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining <= 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        n = self.remaining if o is PENDING else self.remaining - 1
        return (o, Limit(n, g2))

    def update(self, test, ctx, event):
        return Limit(self.remaining, update(self.gen, test, ctx, event))


def limit(remaining, gen):
    return Limit(remaining, gen)


def once(gen):
    return Limit(1, gen)


def log(msg):
    """One :log op (generator.clj:1177-1181)."""
    return {"type": "log", "value": msg}


class Repeat(Generator):
    """Repeat the (unevolved) generator forever or `remaining` times
    (generator.clj:1183-1211)."""

    def __init__(self, remaining, gen):
        self.remaining = remaining  # -1 = infinite
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining == 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, _ = res
        n = self.remaining
        if o is not PENDING and n > 0:
            n -= 1
        return (o, Repeat(n, self.gen))

    def update(self, test, ctx, event):
        return Repeat(self.remaining, update(self.gen, test, ctx, event))


def repeat(arg, gen=None):
    if gen is None:
        return Repeat(-1, arg)
    assert arg >= 0
    return Repeat(arg, gen)


class Cycle(Generator):
    """Reset a finite generator once exhausted (generator.clj:1213-1237)."""

    def __init__(self, remaining, original, gen):
        self.remaining = remaining
        self.original = original
        self.gen = gen

    def op(self, test, ctx):
        remaining, gen = self.remaining, self.gen
        while remaining != 0:
            res = op(gen, test, ctx)
            if res is not None:
                return (res[0], Cycle(remaining, self.original, res[1]))
            remaining = remaining - 1 if remaining > 0 else remaining
            if gen is self.original and res is None:
                # original is itself exhausted: avoid spinning forever
                return None
            gen = self.original
        return None

    def update(self, test, ctx, event):
        return Cycle(self.remaining, self.original,
                     update(self.gen, test, ctx, event))


def cycle(arg, gen=None):
    if gen is None:
        return Cycle(-1, arg, arg)
    return Cycle(arg, gen, gen)


class ProcessLimit(Generator):
    """Ops from at most n distinct processes (generator.clj:1239-1265)."""

    def __init__(self, n, procs, gen):
        self.n = n
        self.procs = frozenset(procs)
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return (o, ProcessLimit(self.n, self.procs, g2))
        procs = self.procs | frozenset(ctx.all_processes())
        if len(procs) > self.n:
            return None
        return (o, ProcessLimit(self.n, procs, g2))

    def update(self, test, ctx, event):
        return ProcessLimit(self.n, self.procs,
                            update(self.gen, test, ctx, event))


def process_limit(n, gen):
    return ProcessLimit(n, set(), gen)


class TimeLimit(Generator):
    """Ops for `limit` nanos after the first op (generator.clj:1267-1291)."""

    def __init__(self, limit_nanos, cutoff, gen):
        self.limit = limit_nanos
        self.cutoff = cutoff
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return (o, TimeLimit(self.limit, self.cutoff, g2))
        cutoff = self.cutoff
        if cutoff is None:
            cutoff = o["time"] + self.limit
        if o["time"] >= cutoff:
            return None
        return (o, TimeLimit(self.limit, cutoff, g2))

    def update(self, test, ctx, event):
        return TimeLimit(self.limit, self.cutoff,
                         update(self.gen, test, ctx, event))


def time_limit(dt_secs, gen):
    return TimeLimit(secs_to_nanos(dt_secs), None, gen)


class Stagger(Generator):
    """Schedule ops at uniformly random intervals averaging dt — a
    *total* rate over all threads (generator.clj:1293-1328)."""

    def __init__(self, dt, next_time, gen):
        self.dt = dt  # 2 * mean interval, nanos
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return (o, self)
        next_time = self.next_time if self.next_time is not None \
            else ctx.time
        if next_time <= o["time"]:
            return (o, Stagger(self.dt, o["time"] + RNG.randrange(
                max(1, self.dt)), g2))
        o = {**o, "time": next_time}
        return (o, Stagger(self.dt, next_time + RNG.randrange(
            max(1, self.dt)), g2))

    def update(self, test, ctx, event):
        return Stagger(self.dt, self.next_time,
                       update(self.gen, test, ctx, event))


def stagger(dt_secs, gen):
    return Stagger(secs_to_nanos(2 * dt_secs), None, gen)


class Delay(Generator):
    """Emit ops exactly dt apart (catching up if behind)
    (generator.clj:1368-1385)."""

    def __init__(self, dt, next_time, gen):
        self.dt = dt
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return (o, Delay(self.dt, self.next_time, g2))
        next_time = self.next_time if self.next_time is not None else o["time"]
        o = {**o, "time": max(o["time"], next_time)}
        return (o, Delay(self.dt, o["time"] + self.dt, g2))

    def update(self, test, ctx, event):
        return Delay(self.dt, self.next_time,
                     update(self.gen, test, ctx, event))


def delay(dt_secs, gen):
    return Delay(secs_to_nanos(dt_secs), None, gen)


def sleep(dt_secs):
    """One :sleep op — the receiving worker naps for dt seconds
    (generator.clj:1397-1402)."""
    return {"type": "sleep", "value": dt_secs}


class Synchronize(Generator):
    """Wait for every worker to be free before starting
    (generator.clj:1404-1423)."""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        if ctx.free_threads == frozenset(ctx.workers):
            return op(self.gen, test, ctx)
        return (PENDING, self)

    def update(self, test, ctx, event):
        return Synchronize(update(self.gen, test, ctx, event))


def synchronize(gen):
    return Synchronize(gen)


def phases(*gens):
    """Run each generator to completion in turn (generator.clj:1425-1430)."""
    return [synchronize(g) for g in gens]


def then(a, b):
    """b, then (synchronize a). Argument order matches the reference's
    ->> composition (generator.clj:1432-1442)."""
    return [b, synchronize(a)]


class UntilOk(Generator):
    """Yield ops until one completes :ok (generator.clj:1444-1483)."""

    def __init__(self, gen, done=False, active=frozenset()):
        self.gen = gen
        self.done = done
        self.active = frozenset(active)

    def op(self, test, ctx):
        if self.done:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return (o, UntilOk(g2, self.done, self.active))
        return (o, UntilOk(g2, self.done, self.active | {o.get("process")}))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        p = event.get("process")
        if p in self.active:
            t = event.get("type")
            if t == "ok":
                return UntilOk(g2, True, self.active - {p})
            if t in ("info", "fail"):
                return UntilOk(g2, self.done, self.active - {p})
        return UntilOk(g2, self.done, self.active)


def until_ok(gen):
    return UntilOk(gen)


class FlipFlop(Generator):
    """Alternate between generators; stop when any is exhausted
    (generator.clj:1485-1501)."""

    def __init__(self, gens, i=0):
        self.gens = list(gens)
        self.i = i

    def op(self, test, ctx):
        res = op(self.gens[self.i], test, ctx)
        if res is None:
            return None
        o, g2 = res
        gens = list(self.gens)
        gens[self.i] = g2
        return (o, FlipFlop(gens, (self.i + 1) % len(gens)))

    def update(self, test, ctx, event):
        # DELIBERATE divergence from the reference: its flip-flop
        # ignores updates outright (generator.clj:1485-1501 "Updates
        # are ignored."), so a stateful child (e.g. until-ok) nested
        # inside never sees completions and generates forever. Here
        # every child sees every event — the pure-update contract the
        # rest of this DSL honors.
        return FlipFlop([update(g, test, ctx, event) for g in self.gens],
                        self.i)


def flip_flop(a, b):
    return FlipFlop([a, b])


class CycleTimes(Generator):
    """Rotate between generators on a repeating schedule
    (generator.clj:1503-1581)."""

    def __init__(self, period, t0, intervals, cutoffs, gens):
        self.period = period
        self.t0 = t0
        self.intervals = intervals
        self.cutoffs = cutoffs
        self.gens = list(gens)

    def op(self, test, ctx):
        now = ctx.time
        t0 = self.t0 if self.t0 is not None else now
        in_period = (now - t0) % self.period
        cycle_start = now - in_period
        i = 0
        while i < len(self.cutoffs) and in_period >= self.cutoffs[i]:
            i += 1
        t = cycle_start + sum(self.intervals[:i])
        # The reference loops until a generator's op lands inside its
        # window (t grows one interval per step, so ops scheduled in the
        # future terminate the loop); bound it defensively.
        for _ in range(10_000):
            g = self.gens[i]
            interval = self.intervals[i]
            t_end = t + interval
            res = op(g, test, replace(ctx, time=max(now, t)))
            if res is None:
                return None
            o, g2 = res
            gens = list(self.gens)
            gens[i] = g2
            nxt = CycleTimes(self.period, t0, self.intervals,
                             self.cutoffs, gens)
            if o is PENDING:
                return (PENDING, nxt)
            if o["time"] < t_end:
                return (o, nxt)
            i = (i + 1) % len(self.gens)
            t = t_end
        return (PENDING, self)

    def update(self, test, ctx, event):
        return CycleTimes(self.period, self.t0, self.intervals, self.cutoffs,
                          [update(g, test, ctx, event) for g in self.gens])


def cycle_times(*specs):
    """cycle_times(5, gen_a, 10, gen_b): 5 s of a, 10 s of b, repeat."""
    assert specs and len(specs) % 2 == 0
    intervals = [secs_to_nanos(specs[i]) for i in range(0, len(specs), 2)]
    gens = [specs[i] for i in range(1, len(specs), 2)]
    cutoffs = []
    acc = 0
    for iv in intervals:
        acc += iv
        cutoffs.append(acc)
    return CycleTimes(sum(intervals), None, intervals, cutoffs[:-1], gens)


def concat(*gens):
    """Sequence of generators (generator.clj:776-781)."""
    return list(gens)
