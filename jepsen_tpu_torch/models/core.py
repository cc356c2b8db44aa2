"""Object-form consistency models (the Python correctness oracle).

Capability parity with knossos.model: `Model.step(op) -> Model`, returning
an `Inconsistent` marker when the op is illegal in the current state. The
protocol shape is the one the reference documents at
`doc/tutorial/04-checker.md:38-95` (reproducing knossos's definition) and
re-defines locally at `jepsen/src/jepsen/tests/causal.clj:12-26`.

Models must be immutable values with structural equality and hashability:
the WGL search memoizes on (linearized-set, model) pairs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class Inconsistent:
    """Marker returned by step when an operation is illegal."""

    msg: str

    def step(self, op) -> "Inconsistent":
        return self


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(m) -> bool:
    return isinstance(m, Inconsistent)


class Model:
    """Base class; subclasses are frozen dataclasses implementing step."""

    def step(self, op) -> "Model | Inconsistent":
        raise NotImplementedError

    def unreachable(self, op_counts: dict) -> bool:
        """True when this state cannot arise in a search that applies each
        history op at most once (`op_counts` maps op f -> multiplicity).
        Used to bound host-side state-space enumeration for the table-
        driven device kernel; states for which this returns True are pruned
        as illegal, which is sound because the search never requests
        them."""
        return False


@dataclass(frozen=True)
class NoOp(Model):
    """A model that accepts everything (knossos model/noop parity)."""

    def step(self, op):
        return self


@dataclass(frozen=True)
class Register(Model):
    """A read/write register. A read with value None matches any state
    (an unknown read)."""

    value: Any = None

    def step(self, op):
        f, v = op.f, op.value
        if f == "write":
            return Register(v)
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"can't read {v!r} from register {self.value!r}")
        return inconsistent(f"unknown op f {f!r} for register")


@dataclass(frozen=True)
class CASRegister(Model):
    """A compare-and-set register: read / write / cas [old new].

    Semantics match the cas-register the reference's tutorial reproduces
    from knossos (`doc/tutorial/04-checker.md:60-80`): a cas succeeds only
    when the current value equals `old`; a read with value None matches
    anything.
    """

    value: Any = None

    def step(self, op):
        f, v = op.f, op.value
        if f == "write":
            return CASRegister(v)
        if f == "cas":
            cur, new = v
            if cur == self.value:
                return CASRegister(new)
            return inconsistent(f"can't CAS {self.value!r} from {cur!r} to {new!r}")
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"can't read {v!r} from register {self.value!r}")
        return inconsistent(f"unknown op f {f!r} for cas-register")


@dataclass(frozen=True)
class Mutex(Model):
    """A single mutex: acquire / release."""

    locked: bool = False

    def step(self, op):
        f = op.f
        if f == "acquire":
            if self.locked:
                return inconsistent("cannot acquire a locked mutex")
            return Mutex(True)
        if f == "release":
            if not self.locked:
                return inconsistent("cannot release a free mutex")
            return Mutex(False)
        return inconsistent(f"unknown op f {f!r} for mutex")


@dataclass(frozen=True)
class FIFOQueue(Model):
    """A FIFO queue: enqueue / dequeue. Dequeue of value v is legal only
    when v is at the head. A dequeue with value None (unknown) matches any
    non-empty queue."""

    items: Tuple[Any, ...] = ()

    def step(self, op):
        f, v = op.f, op.value
        if f == "enqueue":
            return FIFOQueue(self.items + (v,))
        if f == "dequeue":
            if not self.items:
                return inconsistent("cannot dequeue from empty queue")
            head = self.items[0]
            if v is None or v == head:
                return FIFOQueue(self.items[1:])
            return inconsistent(f"queue head is {head!r}, not {v!r}")
        return inconsistent(f"unknown op f {f!r} for fifo-queue")

    def unreachable(self, op_counts):
        return len(self.items) > op_counts.get("enqueue", 0)


@dataclass(frozen=True)
class UnorderedQueue(Model):
    """A queue without ordering guarantees (knossos unordered-queue parity):
    dequeue may return any enqueued-but-not-dequeued element."""

    items: frozenset = frozenset()

    def step(self, op):
        f, v = op.f, op.value
        if f == "enqueue":
            return UnorderedQueue(self.items | {v})
        if f == "dequeue":
            if v in self.items:
                return UnorderedQueue(self.items - {v})
            return inconsistent(f"{v!r} is not in the queue")
        return inconsistent(f"unknown op f {f!r} for unordered-queue")

    def unreachable(self, op_counts):
        return len(self.items) > op_counts.get("enqueue", 0)


@dataclass(frozen=True)
class MultiRegister(Model):
    """A transactional multi-register (yugabyte's multi-key-acid
    model, multi_key_acid.clj:16-38): ops carry f="txn" with value =
    a list of [f k v] micro-ops over independent sub-registers; every
    mop applies atomically in order. Nil reads are always legal.

    State is a sorted (key, value) tuple so configurations stay
    hashable for the generic table encoder."""

    state: tuple = ()

    def _get(self, k):
        for kk, vv in self.state:
            if kk == k:
                return vv
        return None

    def _set(self, k, v) -> "MultiRegister":
        rest = tuple((kk, vv) for kk, vv in self.state if kk != k)
        return MultiRegister(tuple(sorted(rest + ((k, v),))))

    def step(self, op):
        mops = op.value
        if not isinstance(mops, (list, tuple)):
            return inconsistent(
                f"multi-register wants mop lists, got {mops!r}")
        cur = self
        for mop in mops:
            f, k, v = mop
            if f == "w":
                cur = cur._set(k, v)
            elif f == "r":
                if v is not None and v != cur._get(k):
                    return inconsistent(
                        f"can't read {v!r} from key {k!r} "
                        f"(= {cur._get(k)!r})")
            else:
                return inconsistent(
                    f"unknown mop f {f!r} for multi-register")
        return cur


# -- constructor conveniences (knossos model/register style) --
def register(value=None) -> Register:
    return Register(value)


def cas_register(value=None) -> CASRegister:
    return CASRegister(value)


def mutex() -> Mutex:
    return Mutex(False)


def fifo_queue() -> FIFOQueue:
    return FIFOQueue(())


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue(frozenset())


def multi_register(values: dict = None) -> MultiRegister:
    return MultiRegister(tuple(sorted((values or {}).items())))


def noop() -> NoOp:
    return NoOp()
