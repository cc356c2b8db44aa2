"""Operation histories: the core data structure of the framework.

A history is an ordered sequence of operations. Each operation is either an
*invocation* (a client started something) or a *completion* (it finished
:ok, failed cleanly :fail, or ended in an unknown state :info). Checkers
consume histories and decide whether they are consistent with a model.

This mirrors the reference's op-map shape
(`jepsen/src/jepsen/core.clj:328-353` documents the test map; ops are maps
`{:type :invoke/:ok/:fail/:info, :process, :f, :value, :time, :index}`) and
the knossos history utilities the reference calls (`history/index` at
`jepsen/src/jepsen/core.clj:228`).

The port keeps its own copy of the JAX package's history type; ops move
between the two as dicts (`Op.to_dict` / `Op.from_dict`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

# Op types
INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

_TYPE_CODES = {INVOKE: 0, OK: 1, FAIL: 2, INFO: 3}


@dataclass
class Op:
    """A single operation event.

    Fields mirror the reference op maps. `value` is arbitrary (often an int,
    a [k v] tuple for independent tests, or a list of micro-ops for
    transactional workloads). `time` is relative nanoseconds since test
    start. `index` is the position in the history (assigned by
    `History.index`).
    """

    type: str  # invoke | ok | fail | info
    f: Any = None  # operation function: :read, :write, :cas, ...
    process: Any = None  # logical process id, or :nemesis
    value: Any = None
    time: int = -1
    index: int = -1
    error: Any = None
    extra: dict = field(default_factory=dict)

    @property
    def is_invoke(self) -> bool:
        return self.type == INVOKE

    @property
    def is_ok(self) -> bool:
        return self.type == OK

    @property
    def is_fail(self) -> bool:
        return self.type == FAIL

    @property
    def is_info(self) -> bool:
        return self.type == INFO

    def with_(self, **kw) -> "Op":
        return replace(self, **kw)

    def to_dict(self) -> dict:
        d = {
            "type": self.type,
            "f": self.f,
            "process": self.process,
            "value": self.value,
            "time": self.time,
            "index": self.index,
        }
        if self.error is not None:
            d["error"] = self.error
        if self.extra:
            d.update(self.extra)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Op":
        known = {"type", "f", "process", "value", "time", "index", "error"}
        return Op(
            type=d["type"],
            f=d.get("f"),
            process=d.get("process"),
            value=d.get("value"),
            time=d.get("time", -1),
            index=d.get("index", -1),
            error=d.get("error"),
            extra={k: v for k, v in d.items() if k not in known},
        )


def invoke(process, f, value, time=-1, **extra) -> Op:
    return Op(INVOKE, f=f, process=process, value=value, time=time, extra=extra)


def ok(process, f, value, time=-1, **extra) -> Op:
    return Op(OK, f=f, process=process, value=value, time=time, extra=extra)


def fail(process, f, value, time=-1, **extra) -> Op:
    return Op(FAIL, f=f, process=process, value=value, time=time, extra=extra)


def info(process, f, value, time=-1, **extra) -> Op:
    return Op(INFO, f=f, process=process, value=value, time=time, extra=extra)


class History:
    """An indexed sequence of Ops with struct-of-arrays access.

    Supports list-like iteration/indexing plus the columnar view the
    history analyzer uses. Mutation is append-only (`append`); most
    pipeline stages produce new History objects.
    """

    __slots__ = ("ops",)

    def __init__(self, ops: Optional[Iterable] = None):
        self.ops: list[Op] = []
        if ops is not None:
            for o in ops:
                self.append(o)

    def append(self, op) -> None:
        if isinstance(op, dict):
            op = Op.from_dict(op)
        if not isinstance(op, Op):
            raise TypeError(f"not an Op: {op!r}")
        self.ops.append(op)

    # -- sequence protocol --
    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return History(self.ops[i])
        return self.ops[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, History):
            return self.ops == other.ops
        if isinstance(other, list):
            return self.ops == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"History({len(self.ops)} ops)"

    def to_jsonl(self, path: str) -> None:
        """One JSON op map per line (the JAX package's format)."""
        with open(path, "w") as fh:
            for op in self.ops:
                fh.write(json.dumps(op.to_dict(), default=str) + "\n")

    # -- transforms --
    def index(self) -> "History":
        """Assign sequential :index to every op (knossos history/index
        parity; the reference indexes every history before checking,
        jepsen/src/jepsen/core.clj:228)."""
        return History(op.with_(index=i) for i, op in enumerate(self.ops))

    def filter(self, pred: Callable[[Op], bool]) -> "History":
        return History(op for op in self.ops if pred(op))

    def pairs(self) -> list[tuple[Op, Optional[Op]]]:
        """Pair each invocation with its completion (or None if it never
        completed). Completion matching is per-process FIFO — each process
        has at most one outstanding op, matching the interpreter's
        invariant (reference: jepsen/src/jepsen/checker/timeline.clj:38-57).
        Non-invoke ops without a pending invocation (e.g. nemesis :info
        markers) are returned as (op, None) pairs too.
        """
        out: list[tuple[Op, Optional[Op]]] = []
        pending: dict[Any, int] = {}  # process -> slot in out
        for op in self.ops:
            if op.is_invoke:
                pending[op.process] = len(out)
                out.append((op, None))
            else:
                slot = pending.pop(op.process, None)
                if slot is None:
                    out.append((op, None))
                else:
                    inv, _ = out[slot]
                    out[slot] = (inv, op)
        return out

    # -- struct-of-arrays columns --
    def columns(self):
        """Return (type_codes, f_objs, process_objs, times, indexes) as numpy
        arrays / object arrays. Cheap columnar access for the analyzer."""
        n = len(self.ops)
        types = np.empty(n, dtype=np.int8)
        times = np.empty(n, dtype=np.int64)
        idxs = np.empty(n, dtype=np.int64)
        fs = np.empty(n, dtype=object)
        procs = np.empty(n, dtype=object)
        for i, op in enumerate(self.ops):
            types[i] = _TYPE_CODES[op.type]
            times[i] = op.time
            idxs[i] = op.index
            fs[i] = op.f
            procs[i] = op.process
        return types, fs, procs, times, idxs


def strip_nemesis(history: History) -> History:
    """Client ops only — checkers generally ignore nemesis ops."""
    return history.filter(lambda o: o.process != "nemesis")
