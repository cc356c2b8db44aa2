"""Host-side encoding: history -> arrays for the device WGL kernel.

Turns the prepared LinOp list (`linprep.prepare`) into the fixed-shape
integer arrays the device search consumes:

  * ok ops sorted by invocation: inv[], ret[], opcode[]
  * info (crashed) ops: inv_info[], opcode_info[]
  * a model transition table T[S, O] -> next-state index or -1, built by
    enumerating the model's reachable state space on the host under the
    history's distinct (f, value) op alphabet

This is the bridge between the object-form models (knossos.model parity,
`models.core`) and the device search. The reference's checker
selects the search engine by :algorithm (jepsen/src/jepsen/checker.clj:
199-202); here the table-driven encoding is what makes a single generic
kernel serve every model.

Window-width theory: with `base` = index of the first unlinearized ok op,
an ok op j can only be linearized when some unlinearized op i <= j has
ret(i) > inv(j); hence j < searchsorted(inv, ret(base)). So
  W_needed = max_i ( #{j >= i : inv(j) < ret(i)} )
bounds how far beyond `base` any linearizable op can sit, and a W-slot
window loses nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..history import History
from ..models.core import Model, is_inconsistent
from .linprep import LinOp, prepare

INF = np.int32(2**31 - 1)  # event indices are small; x64 stays off

# Kernel limits (the `encode()` defaults), the same as the JAX
# package's so both encode the same histories.
MAX_WINDOW = 1024
MAX_INFO = 256


def window_requirement(inv_ok: np.ndarray,
                       ret_ok: np.ndarray) -> tuple[int, int]:
    """(w_needed, W_padded) for inv-sorted ok-op intervals — the
    window-width theory in the module docstring."""
    n = len(inv_ok)
    if n:
        hi = np.searchsorted(inv_ok, ret_ok)
        w_needed = int(np.max(hi - np.arange(n)))
    else:
        w_needed = 1
    # Narrow windows bucket at 32 (few shapes, cheap); wide ones at
    # 128 so adversarial long-tail runs don't compile a fresh kernel
    # per history length.
    return w_needed, _pad_to(w_needed, 32 if w_needed <= 256 else 128)


class EncodingUnsupported(Exception):
    """The history/model cannot be encoded within kernel limits; callers
    should fall back to the host oracle.

    Carries machine-readable coordinates of the offending op so the
    history analyzer (`analysis/history_lint`) and error reports can
    point at the exact op instead of re-deriving it from the message:
    `op_index` (the op's :index), `process`, `value`, and `rule`
    (which limit tripped: "info-cap" | "state-space" | "window")."""

    def __init__(self, message: str, *, op_index: Optional[int] = None,
                 process: Any = None, value: Any = None,
                 rule: Optional[str] = None):
        super().__init__(message)
        self.op_index = op_index
        self.process = process
        self.value = value
        self.rule = rule

    def to_dict(self) -> dict:
        return {"message": str(self), "rule": self.rule,
                "op_index": self.op_index, "process": self.process,
                "value": self.value}


def _hashable(v):
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


def build_table(model: Model, alphabet: list, max_states: int = 1 << 16,
                op_counts: Optional[dict] = None) -> tuple[np.ndarray, list]:
    """Enumerate the model's reachable states under `alphabet` (a list of
    ops as seen by Model.step) and return (T, states) where
    T[s, o] = next-state index or -1.

    `op_counts` (f -> multiplicity in the history) lets models prune
    states the at-most-once search can never reach (Model.unreachable),
    keeping e.g. queue state spaces finite."""
    op_counts = op_counts or {}
    states: dict = {model: 0}
    order: list = [model]
    rows: list[list[int]] = []
    i = 0
    while i < len(order):
        s = order[i]
        row = []
        for op in alphabet:
            m2 = s.step(op)
            if is_inconsistent(m2) or m2.unreachable(op_counts):
                row.append(-1)
            else:
                j = states.get(m2)
                if j is None:
                    if len(order) >= max_states:
                        raise EncodingUnsupported(
                            f"model state space exceeds {max_states}",
                            op_index=op.index, process=op.process,
                            value=op.value, rule="state-space")
                    j = len(order)
                    states[m2] = j
                    order.append(m2)
                row.append(j)
        rows.append(row)
        i += 1
    return np.asarray(rows, dtype=np.int32), order


@dataclass
class Encoded:
    """Everything the device search needs, in numpy (host) form."""

    n_ok: int              # number of ok (must-linearize) ops
    n_info: int            # number of crashed (may-linearize) ops
    inv: np.ndarray        # (n_pad,) i64, INF beyond n_ok
    ret: np.ndarray        # (n_pad,) i64, INF beyond n_ok
    opcode: np.ndarray     # (n_pad,) i32, 0 beyond n_ok
    sufminret: np.ndarray  # (n_pad+1,) i64; sufminret[i] = min ret[i:]
    inv_info: np.ndarray   # (ic_pad,) i64, INF beyond n_info
    opcode_info: np.ndarray  # (ic_pad,) i32
    table: np.ndarray      # (S, O) i32 transition table
    states: list           # state index -> model object
    window: int            # W, multiple of 32
    window_raw: int        # exact W requirement before padding
    lin_ops: list          # LinOp list (ok ops then info ops), for reporting


def _pad_to(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def encode(model: Model, history: History, max_window: int = MAX_WINDOW,
           max_states: int = 1 << 16, max_info: int = MAX_INFO) -> Encoded:
    """History + model -> Encoded tensors, or raise EncodingUnsupported."""
    ops = prepare(history)
    ok_ops = [o for o in ops if o.ok]
    info_ops = [o for o in ops if not o.ok]
    n, ni = len(ok_ops), len(info_ops)
    if ni > max_info:
        first_over = info_ops[max_info]  # the op past the cap
        raise EncodingUnsupported(
            f"{ni} crashed ops exceeds cap {max_info}",
            op_index=first_over.orig_index, process=first_over.process,
            value=first_over.value, rule="info-cap")

    # Distinct op alphabet over every op the search might apply.
    key_of = {}
    alphabet = []
    codes_ok = np.zeros(n, dtype=np.int32)
    codes_info = np.zeros(ni, dtype=np.int32)
    for arr, group in ((codes_ok, ok_ops), (codes_info, info_ops)):
        for i, o in enumerate(group):
            k = (o.f, _hashable(o.value))
            c = key_of.get(k)
            if c is None:
                c = len(alphabet)
                key_of[k] = c
                alphabet.append(o.as_op())
            arr[i] = c

    op_counts: dict = {}
    for o in ok_ops + info_ops:
        op_counts[o.f] = op_counts.get(o.f, 0) + 1
    table, states = build_table(model, alphabet, max_states=max_states,
                                op_counts=op_counts)

    inv_ok = np.asarray([o.inv for o in ok_ops], dtype=np.int32)
    # crashed ops have ret = INF_TIME (2**62); clamp into int32 range
    ret_ok = np.asarray([min(o.ret, 2**31 - 1) for o in ok_ops],
                        dtype=np.int32)
    # ok ops are already inv-sorted (prepare sorts); assert the invariant.
    if n > 1:
        assert np.all(np.diff(inv_ok) > 0)

    # Exact window requirement (see module docstring).
    w_needed, W = window_requirement(inv_ok, ret_ok)
    if W > max_window:
        # the op whose open window drives the requirement
        hi = np.searchsorted(inv_ok, ret_ok)
        widest = ok_ops[int(np.argmax(hi - np.arange(n)))] if n else None
        raise EncodingUnsupported(
            f"window {w_needed} exceeds max {max_window} "
            "(extremely skewed op latencies)",
            op_index=widest.orig_index if widest else None,
            process=widest.process if widest else None,
            value=widest.value if widest else None, rule="window")

    n_pad = _pad_to(n, 64)
    ic_pad = _pad_to(ni, 32)
    inv = np.full(n_pad, INF, dtype=np.int32)
    ret = np.full(n_pad, INF, dtype=np.int32)
    opc = np.zeros(n_pad, dtype=np.int32)
    inv[:n] = inv_ok
    ret[:n] = ret_ok
    opc[:n] = codes_ok
    suf = np.full(n_pad + 1, INF, dtype=np.int32)
    for i in range(n - 1, -1, -1):
        suf[i] = min(ret[i], suf[i + 1])
    suf[n:] = INF  # beyond real ops
    iinv = np.full(ic_pad, INF, dtype=np.int32)
    iopc = np.zeros(ic_pad, dtype=np.int32)
    if ni:
        iinv[:ni] = np.asarray([o.inv for o in info_ops], dtype=np.int32)
        iopc[:ni] = codes_info

    # Pad the table to power-of-two-ish shapes so shape buckets recur.
    S, O = table.shape
    Sp, Op_ = _pad_to(S, 16), _pad_to(O, 16)
    tpad = np.full((Sp, Op_), -1, dtype=np.int32)
    tpad[:S, :O] = table

    return Encoded(n_ok=n, n_info=ni, inv=inv, ret=ret, opcode=opc,
                   sufminret=suf, inv_info=iinv, opcode_info=iopc,
                   table=tpad, states=states, window=W,
                   window_raw=w_needed, lin_ops=ok_ops + info_ops)
