"""Pre-search history analyzer: well-formedness before the device burns.

A copy of the JAX package's structural pass
(`jepsen_tpu/analysis/history_lint.py`). WGL search is only sound on
well-formed histories: a single process with two concurrent invokes or
an unmatched completion silently corrupts the encoded tensors, and the
device search then returns a confident garbage verdict. This pass runs
before every search and turns that failure mode into a diagnosis.

Rules (the structural subset of the JAX package's catalog):

  H001 double-invoke      a process invoked again while an op was
                          still outstanding
  H002 unmatched-complete an :ok/:fail completion with no pending
                          invocation for that process
  H003 time-regression    a later op carries a smaller timestamp than
                          an earlier one (among ops with real times)
  H004 negative-time      a timestamp below the -1 "unset" sentinel
  H005 index-disorder     duplicate or decreasing :index values; in
                          strict mode also gaps
  H007 crashed-pairing    ops by a process AFTER its :info crash, or an
                          :info completion with no pending invocation
                          (warn)

Severities: "error" rules gate (fast-fail the checker as unknown);
"warn" rules only report.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..history import History

UNKNOWN = "unknown"

RULES = {
    "H001": "double-invoke",
    "H002": "unmatched-complete",
    "H003": "time-regression",
    "H004": "negative-time",
    "H005": "index-disorder",
    "H007": "crashed-pairing",
}

# Rules that fast-fail a linearizability check.
GATE_RULES = ("H001", "H002", "H003", "H004", "H005", "H007")

# Elle histories legitimately omit invocations (the reference Elle
# accepts completion-only txn lists), so the elle gate drops the
# pairing rules and keeps the clock/index ones.
ELLE_GATE_RULES = ("H001", "H003", "H004", "H005")

# The independent fan-out gate sees the WHOLE multi-key history;
# merged per-key streams may legitimately carry per-key clocks, so
# global time monotonicity is not required here: each per-key
# subhistory still passes through the full checker gate downstream.
INDEPENDENT_GATE_RULES = ("H001", "H002", "H004", "H005", "H007")

# Cap diagnostics per rule; one summary entry reports the overflow.
MAX_PER_RULE = 16


@dataclass
class Diagnostic:
    """One analyzer finding, pointing at an exact op."""

    rule: str           # rule id, e.g. "H001"
    op_index: int       # the op's :index when assigned, else position
    position: int       # position in the analyzed history
    process: object     # the op's process (None for summary entries)
    message: str
    severity: str = "error"   # "error" gates; "warn" only reports
    value: object = None

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "name": RULES.get(self.rule, "?"),
             "op_index": self.op_index, "position": self.position,
             "process": self.process, "message": self.message,
             "severity": self.severity}
        if self.value is not None:
            d["value"] = self.value
        return d


def _diag(history: History, pos: int, rule: str, msg: str,
          severity: str = "error") -> Diagnostic:
    op = history[pos]
    idx = op.index if op.index is not None and op.index >= 0 else pos
    return Diagnostic(rule=rule, op_index=int(idx), position=int(pos),
                      process=op.process, message=msg,
                      severity=severity, value=op.value)


def _cap(history: History, positions, rule: str, fmt, diags: list,
         severity: str = "error") -> None:
    """Append up to MAX_PER_RULE diagnostics for `positions`, plus one
    summary entry when the rule fired more often."""
    positions = list(positions)
    for pos in positions[:MAX_PER_RULE]:
        diags.append(_diag(history, int(pos), rule, fmt(int(pos)),
                           severity=severity))
    if len(positions) > MAX_PER_RULE:
        diags.append(Diagnostic(
            rule=rule, op_index=-1, position=-1, process=None,
            severity=severity,
            message=f"... and {len(positions) - MAX_PER_RULE} more "
                    f"{RULES[rule]} findings (suppressed)"))


def lint_structure(history: History,
                   rules: Sequence[str] = tuple(RULES),
                   strict_index: bool = False) -> list:
    """The vectorized structural pass (H001-H005, H007). Returns a
    list of Diagnostics."""
    n = len(history)
    diags: list = []
    if n == 0:
        return diags
    rules = set(rules)
    types, _fs, procs, times, idxs = history.columns()
    is_inv = types == 0
    is_ok = types == 1
    is_fail = types == 2
    is_info = types == 3

    # -- per-process pairing rules (H001/H002/H007) -------------------
    if rules & {"H001", "H002", "H007"}:
        pid_of: dict = {}
        pid = np.empty(n, dtype=np.int64)
        for i, p in enumerate(procs):
            key = (type(p).__name__, p)  # 1 and "1" are different procs
            pid[i] = pid_of.setdefault(key, len(pid_of))
        order = np.lexsort((np.arange(n), pid))  # by process, stable
        start = np.empty(n, dtype=bool)
        start[0] = True
        ps = pid[order]
        start[1:] = ps[1:] != ps[:-1]
        gidx = np.cumsum(start) - 1

        def seg_cumsum(vals_sorted):
            """Within-group inclusive cumsum over the sorted domain."""
            cs = np.cumsum(vals_sorted)
            offsets = (cs - vals_sorted)[start]
            return cs - offsets[gidx]

        delta = np.where(is_inv, 1, -1).astype(np.int64)[order]
        depth_after = seg_cumsum(delta)
        depth_before = depth_after - delta

        if "H001" in rules:
            bad = is_inv[order] & (depth_before >= 1)
            _cap(history, order[bad], "H001",
                 lambda p: f"process {history[p].process!r} invoked "
                           "while an op was still outstanding", diags)
        if "H002" in rules:
            bad = (is_ok | is_fail)[order] & (depth_before <= 0)
            _cap(history, order[bad], "H002",
                 lambda p: f"{history[p].type} completion for process "
                           f"{history[p].process!r} with no pending "
                           "invocation", diags)
        if "H007" in rules:
            crashed = is_info[order].astype(np.int64)
            crashed_before = seg_cumsum(crashed) - crashed
            bad = crashed_before >= 1
            _cap(history, order[bad], "H007",
                 lambda p: f"op by process {history[p].process!r} "
                           "after its :info crash (crashed processes "
                           "must be relabeled)", diags)
            # info completion with nothing pending: linprep tolerates
            # these as markers, so warn rather than gate
            bad = is_info[order] & (depth_before <= 0)
            _cap(history, order[bad], "H007",
                 lambda p: f":info completion for process "
                           f"{history[p].process!r} with no pending "
                           "invocation", diags, severity="warn")

    # -- clock rules (H003/H004) --------------------------------------
    if "H004" in rules:
        bad = np.flatnonzero(times < -1)
        _cap(history, bad, "H004",
             lambda p: f"negative timestamp {history[p].time}", diags)
    if "H003" in rules:
        has_t = times >= 0
        if has_t.any():
            lo = np.iinfo(np.int64).min
            run = np.maximum.accumulate(np.where(has_t, times, lo))
            prev = np.empty(n, dtype=np.int64)
            prev[0] = lo
            prev[1:] = run[:-1]
            bad = np.flatnonzero(has_t & (times < prev))
            _cap(history, bad, "H003",
                 lambda p: f"timestamp {history[p].time} regresses "
                           "below an earlier op's", diags)

    # -- index rule (H005) --------------------------------------------
    if "H005" in rules:
        assigned = idxs >= 0
        if assigned.any():
            lo = np.iinfo(np.int64).min
            run = np.maximum.accumulate(np.where(assigned, idxs, lo))
            prev = np.empty(n, dtype=np.int64)
            prev[0] = lo
            prev[1:] = run[:-1]
            bad = np.flatnonzero(assigned & (idxs <= prev))
            _cap(history, bad, "H005",
                 lambda p: f"index {history[p].index} duplicates or "
                           "regresses an earlier op's", diags)
            if strict_index and not len(bad):
                want = np.arange(n)
                gaps = np.flatnonzero(assigned & (idxs != want))
                _cap(history, gaps[:1], "H005",
                     lambda p: f"index {history[p].index} at position "
                               f"{p}: history is not densely indexed "
                               "(run History.index())", diags)
    return diags


def gate(history: History, where: str = "checker",
         rules: Sequence[str] = GATE_RULES) -> Optional[dict]:
    """The checker-side fast-fail: run the structural gate rules and
    return None when the history is well-formed, else a checker-style
    result

        {"valid?": "unknown", "cause": "malformed-history",
         "anomalies": [...], "analyzer": {...}}
    """
    diags = [d for d in lint_structure(history, rules=rules)
             if d.severity == "error"]
    if not diags:
        return None
    counts: dict = {}
    for d in diags:
        counts[d.rule] = counts.get(d.rule, 0) + 1
    return {
        "valid?": UNKNOWN,
        "cause": "malformed-history",
        "anomalies": [d.to_dict() for d in diags],
        "analyzer": {"where": where, "op_count": len(history),
                     "rule_counts": counts},
    }
