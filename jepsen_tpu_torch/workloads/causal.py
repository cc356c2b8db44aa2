"""Causal-consistency workload: a causal order of ops on one register.

Capability parity with jepsen.tests.causal
(`jepsen/src/jepsen/tests/causal.clj:12-131`): a CausalRegister model
steps through write/read/read-init ops, each carrying a `position` and
a `link` to the previously-seen position; unlinked or out-of-order
ops are inconsistent. The workload issues the canonical 5-op causal
order (read-init, write 1, read, write 2, read) per key, one thread
group per key, under a partitioning nemesis.

The local Model protocol here is deliberately the checker-model one
(jepsen_tpu_torch.models.Model) — the reference re-defines its own
identical protocol locally (causal.clj:12-26); this build reuses the
shared one.

The port's copy of `jepsen_tpu/workloads/causal.py`.
"""

from __future__ import annotations

import itertools
from typing import Optional

from .. import generator as gen
from .. import independent
from ..checker import Checker
from ..models import Inconsistent, Model


class CausalRegister(Model):
    """causal.clj:33-83."""

    def __init__(self, value=0, counter=0, last_pos=None):
        self.value = value
        self.counter = counter
        self.last_pos = last_pos

    def step(self, op):
        c = self.counter + 1
        v = op.value
        pos = op.extra.get("position")
        link = op.extra.get("link")
        if link != "init" and link != self.last_pos:
            return Inconsistent(
                f"Cannot link {link!r} to last-seen position "
                f"{self.last_pos!r}")
        if op.f == "write":
            if v == c:
                return CausalRegister(v, c, pos)
            return Inconsistent(
                f"expected value {c} attempting to write {v} instead")
        if op.f == "read-init":
            if self.counter == 0 and v not in (None, 0):
                return Inconsistent(f"expected init value 0, read {v}")
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return Inconsistent(
                f"can't read {v} from register {self.value}")
        if op.f == "read":
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return Inconsistent(
                f"can't read {v} from register {self.value}")
        return Inconsistent(f"unknown op {op.f!r}")

    def __repr__(self):
        return f"CausalRegister({self.value!r})"

    def __eq__(self, other):
        return (isinstance(other, CausalRegister)
                and (self.value, self.counter, self.last_pos)
                == (other.value, other.counter, other.last_pos))

    def __hash__(self):
        return hash((self.value, self.counter, self.last_pos))


def causal_register() -> CausalRegister:
    return CausalRegister()


class CausalChecker(Checker):
    """Step the model through every ok op in issue order
    (causal.clj:88-110)."""

    def __init__(self, model: Model):
        self.model = model

    def check(self, test, history, opts=None):
        s = self.model
        for op in history:
            if not op.is_ok:
                continue
            s = s.step(op)
            if isinstance(s, Inconsistent):
                return {"valid?": False, "error": s.msg}
        return {"valid?": True, "model": s}


def check(model: Optional[Model] = None) -> Checker:
    return CausalChecker(model or causal_register())


def r(test, ctx):
    return {"f": "read", "value": None}


def ri(test, ctx):
    return {"f": "read-init", "value": None}


def cw1(test, ctx):
    return {"f": "write", "value": 1}


def cw2(test, ctx):
    return {"f": "write", "value": 2}


def workload(opts: dict) -> dict:
    """The canonical causal order (ri w1 r w2 r) per key, one thread
    per key, staggered, under a start/stop nemesis cycle
    (causal.clj:113-131)."""
    return {
        "checker": independent.checker(check(causal_register())),
        "generator": gen.time_limit(
            opts.get("time_limit", 60),
            gen.nemesis(
                gen.cycle([gen.sleep(10),
                           {"type": "info", "f": "start"},
                           gen.sleep(10),
                           {"type": "info", "f": "stop"}]),
                gen.stagger(1, independent.concurrent_generator(
                    1, itertools.count(),
                    # each step one-shot: bare fns would repeat forever
                    # and the sequence would never advance past ri
                    lambda k: [gen.once(ri), gen.once(cw1), gen.once(r),
                               gen.once(cw2), gen.once(r)]))),
        ),
    }
