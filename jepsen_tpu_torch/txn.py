"""Transaction micro-op algebra (a copy of `jepsen_tpu/txn.py`).

Transactions are sequences of *micro-operations* (mops): 3-element
sequences ``[f, k, v]`` where ``f`` is the function ("r", "w", or
"append"), ``k`` the key, and ``v`` the value (``None`` for an
unperformed read).

Capability parity with the in-tree jepsen.txn library
(`txn/src/jepsen/txn.clj:1-75` — reduce-mops, op-mops, ext-reads,
ext-writes, int-write-mops) and `txn/src/jepsen/txn/micro_op.clj`
(f/key/value accessors + read?/write? predicates). Mops here are plain
lists/tuples, not objects: the Elle-equivalent checkers
(`jepsen_tpu_torch.elle`) consume them in bulk and convert to index tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

R = "r"
W = "w"
APPEND = "append"

_WRITE_FS = (W, APPEND)


# -- micro_op.clj accessors --------------------------------------------------

def mop_f(mop) -> Any:
    return mop[0]


def mop_key(mop) -> Any:
    return mop[1]


def mop_value(mop) -> Any:
    return mop[2]


def is_read(mop) -> bool:
    return mop[0] == R


def is_write(mop) -> bool:
    return mop[0] in _WRITE_FS


def is_mop(mop) -> bool:
    """Is this a legal micro-op? (micro_op.clj:30-35)"""
    return (isinstance(mop, (list, tuple)) and len(mop) == 3
            and mop[0] in (R, W, APPEND))


# -- txn.clj -----------------------------------------------------------------

def reduce_mops(f: Callable, init: Any, history: Iterable) -> Any:
    """Reduce ``f(state, op, mop)`` over every micro-op of every op in
    the history (txn.clj:5-17). Ops are anything with a ``value``
    attribute or key holding the txn."""
    state = init
    for op in history:
        for mop in _txn_of(op):
            state = f(state, op, mop)
    return state


def op_mops(history: Iterable) -> Iterator[tuple]:
    """All (op, mop) pairs from a history, lazily (txn.clj:19-22)."""
    for op in history:
        for mop in _txn_of(op):
            yield op, mop


def ext_reads(txn: Iterable) -> dict:
    """Keys -> values the txn observed *externally* — reads not preceded
    by the txn's own write/read of that key (txn.clj:24-41)."""
    ext: dict = {}
    ignore: set = set()
    for f, k, v in txn:
        if f == R and k not in ignore:
            ext[k] = v
        ignore.add(k)
    return ext


def ext_writes(txn: Iterable) -> dict:
    """Keys -> final values written by the txn (txn.clj:43-54)."""
    ext: dict = {}
    for f, k, v in txn:
        if f != R:
            ext[k] = v
    return ext


def int_write_mops(txn: Iterable) -> dict:
    """Keys -> list of all non-final write mops to that key
    (txn.clj:56-75)."""
    writes: dict = {}
    for mop in txn:
        if mop[0] != R:
            writes.setdefault(mop[1], []).append(mop)
    return {k: vs[:-1] for k, vs in writes.items() if len(vs) > 1}


def _txn_of(op):
    v = getattr(op, "value", None)
    if v is None and isinstance(op, dict):
        v = op.get("value")
    return v or []
