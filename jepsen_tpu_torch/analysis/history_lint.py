"""Pre-search history analyzer: well-formedness before the device burns.

A copy of the JAX package's analyzer (`jepsen_tpu/analysis/history_lint.py`).
WGL search (Lowe 2017) and Elle-style cycle search are only sound on
well-formed histories: a single process with two concurrent invokes, an
unmatched completion, or a value outside the encoded alphabet silently
corrupts the arrays `ops/encode.py` builds, and the device search then
returns a confident garbage verdict. This pass runs before every search
and turns that failure mode into a diagnosis.

Rule catalog:

  H001 double-invoke      a process invoked again while an op was
                          still outstanding
  H002 unmatched-complete an :ok/:fail completion with no pending
                          invocation for that process
  H003 time-regression    a later op carries a smaller timestamp than
                          an earlier one (among ops with real times)
  H004 negative-time      a timestamp below the -1 "unset" sentinel
  H005 index-disorder     duplicate or decreasing :index values; in
                          strict mode also gaps
  H006 unknown-op         an op's (f, value) is rejected from EVERY
                          model state reachable under the history's
                          alphabet: the op can never linearize, which
                          almost always means the value is outside the
                          model's domain (requires `model=`)
  H007 crashed-pairing    ops by a process AFTER its :info crash, or an
                          :info completion with no pending invocation
                          (warn)
  H008 encoding           the history/model cannot be encoded within
                          kernel limits (`EncodingUnsupported`),
                          surfaced with the offending op's coordinates

Severities: "error" rules gate (fast-fail the checker as unknown);
"warn" rules only report.

Entry points:

  analyze(history, model=None)  -> full report dict
  gate(history, where=...)      -> None when clean, else a checker-
                                   style {"valid?": "unknown", ...}
                                   fast-fail result (recorded into the
                                   ambient metrics/fleet planes)

`python -m jepsen_tpu_torch.analysis.history_lint` runs `self_check`
and prints its JSON (exit 0 when every rule fires where seeded).
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
    "H006": "unknown-op",
    "H007": "crashed-pairing",
    "H008": "encoding",
}

# Rules that fast-fail a linearizability check. H006/H008 need a model
# and are advisory (an out-of-alphabet *read* is often a genuine
# non-linearizable observation the search itself must judge).
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
    list of Diagnostics; model-dependent rules live in `lint_model`."""
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




def lint_model(history: History, model,
               max_states: int = 1 << 14) -> list:
    """Model-dependent rules (H006/H008): encode the history's op
    alphabet against the model's reachable state space and flag ops no
    reachable state accepts. Skipped silently when the structural pass
    would already make `linprep.prepare` raise."""
    from ..models.core import Model
    from ..ops.encode import EncodingUnsupported, _hashable, build_table
    from ..ops.linprep import prepare

    diags: list = []
    if model is None or not isinstance(model, Model):
        return diags
    try:
        ops = prepare(history)
    except ValueError:
        return diags  # structural rules own this failure
    if not ops:
        return diags
    key_of: dict = {}
    alphabet: list = []
    codes: list = []
    for o in ops:
        # the same alphabet key encode() uses, so H006 advisories
        # classify ops exactly as the encoder will
        k = (o.f, _hashable(o.value))
        c = key_of.get(k)
        if c is None:
            c = key_of[k] = len(alphabet)
            alphabet.append(o.as_op())
        codes.append(c)
    op_counts: dict = {}
    for o in ops:
        op_counts[o.f] = op_counts.get(o.f, 0) + 1
    try:
        table, _states = build_table(model, alphabet,
                                     max_states=max_states,
                                     op_counts=op_counts)
    except EncodingUnsupported as e:
        diags.append(Diagnostic(
            rule="H008",
            op_index=e.op_index if e.op_index is not None else -1,
            position=-1, process=e.process, value=e.value,
            message=f"encoding unsupported: {e}", severity="warn"))
        return diags
    dead = ~np.any(table >= 0, axis=0)  # column accepted by no state
    flagged = 0
    for o, c in zip(ops, codes):
        if dead[c]:
            flagged += 1
            if flagged > MAX_PER_RULE:
                continue
            diags.append(Diagnostic(
                rule="H006", op_index=o.orig_index, position=o.inv,
                process=o.process, value=o.value, severity="warn",
                message=f"op ({o.f!r}, {o.value!r}) is rejected from "
                        "every reachable model state — value outside "
                        "the model alphabet?"))
    if flagged > MAX_PER_RULE:
        diags.append(Diagnostic(
            rule="H006", op_index=-1, position=-1, process=None,
            severity="warn",
            message=f"... and {flagged - MAX_PER_RULE} more "
                    "unknown-op findings (suppressed)"))
    return diags


def analyze(history: History, model=None,
            rules: Sequence[str] = tuple(RULES),
            strict_index: bool = False) -> dict:
    """Full analyzer report over `history`.

    Returns {"ok": <no error-severity findings>, "valid":
    True|"unknown", "anomalies": [diag dicts], "op_count", and
    "rule_counts"}. `model` enables the H006/H008 alphabet rules."""
    diags = lint_structure(history, rules=rules,
                           strict_index=strict_index)
    if model is not None and ("H006" in rules or "H008" in rules):
        diags += lint_model(history, model)
    counts: dict = {}
    for d in diags:
        counts[d.rule] = counts.get(d.rule, 0) + 1
    errors = [d for d in diags if d.severity == "error"]
    return {
        "ok": not errors,
        "valid": True if not errors else UNKNOWN,
        "anomalies": [d.to_dict() for d in diags],
        "op_count": len(history),
        "rule_counts": counts,
    }


def gate(history: History, where: str = "checker",
         rules: Sequence[str] = GATE_RULES,
         metrics=None, status=None) -> Optional[dict]:
    """The checker-side fast-fail: run the structural gate rules and
    return None when the history is well-formed, else a checker-style
    result

        {"valid?": "unknown", "cause": "malformed-history",
         "anomalies": [...], "analyzer": {...}}

    so `checker.Linearizable` / `elle.*` / `independent` can return a
    diagnosis instead of spending device time on garbage arrays. The
    verdict and findings are recorded into `metrics` (else the ambient
    registry: the `history_lint` series and counters) and `status`
    (else the live `fleet.RunStatus`)."""
    from .. import fleet as _fleet
    from .. import metrics as _metrics

    diags = [d for d in lint_structure(history, rules=rules)
             if d.severity == "error"]
    mx = metrics if metrics is not None else _metrics.get_default()
    if not diags:
        if mx.enabled:
            mx.counter("history_lint_checks_total",
                       "pre-search history analyzer runs").inc(
                where=where, verdict="clean")
        return None
    counts: dict = {}
    for d in diags:
        counts[d.rule] = counts.get(d.rule, 0) + 1
    if mx.enabled:
        mx.counter("history_lint_checks_total",
                   "pre-search history analyzer runs").inc(
            where=where, verdict="malformed")
        for rule, c in counts.items():
            mx.counter("history_lint_anomalies_total",
                       "structural anomalies found by the history "
                       "analyzer").inc(c, rule=rule, where=where)
        # JSON-safe copy: op values/processes can be arbitrary objects
        # (KV tuples), and export_jsonl has no default=
        first = {k: (v if isinstance(v, (str, int, float, bool,
                                         type(None))) else repr(v))
                 for k, v in diags[0].to_dict().items()}
        mx.series("history_lint",
                  "malformed-history gate events").append(
            {"where": where, "op_count": len(history),
             "rule_counts": counts, "first": first})
    st = status if status is not None else _fleet.get_default()
    if st.enabled:
        st.fault({"type": "MalformedHistory",
                  "error": f"{sum(counts.values())} anomalies "
                           f"({', '.join(sorted(counts))}) "
                           f"at {where}",
                  "stage": f"history-lint/{where}"})
    return {
        "valid?": UNKNOWN,
        "cause": "malformed-history",
        "anomalies": [d.to_dict() for d in diags],
        "analyzer": {"where": where, "op_count": len(history),
                     "rule_counts": counts},
    }


def self_check() -> dict:
    """Every gate rule must fire on its seeded malformed history and
    stay silent on a clean one. Returns {"ok": bool, "failures": [...]};
    run as a test and by the module's CLI."""
    from ..history import info, invoke, ok

    failures: list = []

    def expect(name, hist, rule, should_fire=True):
        rep = analyze(hist, rules=tuple(RULES), strict_index=False)
        fired = rule in rep["rule_counts"]
        if fired != should_fire:
            failures.append(f"{name}: rule {rule} "
                            f"{'missing' if should_fire else 'spurious'}")

    clean = History([invoke(0, "write", 1, time=0),
                     ok(0, "write", 1, time=1),
                     invoke(1, "read", None, time=2),
                     ok(1, "read", 1, time=3)]).index()
    for r in GATE_RULES:
        expect("clean", clean, r, should_fire=False)
    expect("double-invoke",
           History([invoke(0, "write", 1, time=0),
                    invoke(0, "write", 2, time=1)]).index(), "H001")
    expect("unmatched-complete",
           History([ok(0, "write", 1, time=0)]).index(), "H002")
    expect("time-regression",
           History([invoke(0, "write", 1, time=5),
                    ok(0, "write", 1, time=2)]).index(), "H003")
    expect("negative-time",
           History([invoke(0, "write", 1, time=-7)]).index(), "H004")
    h = History([invoke(0, "write", 1, time=0),
                 ok(0, "write", 1, time=1)])
    h = History([op.with_(index=3) for op in h])
    expect("index-disorder", h, "H005")
    expect("crashed-pairing",
           History([invoke(0, "write", 1, time=0),
                    info(0, "write", 1, time=1),
                    invoke(0, "write", 2, time=2)]).index(), "H007")
    return {"ok": not failures, "failures": failures}


def main(argv=None) -> int:
    """The module's CLI: run `self_check`, print its JSON, exit 0 when
    it is ok, else 1. Takes no arguments."""
    import json
    res = self_check()
    print(json.dumps(res, indent=2))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
