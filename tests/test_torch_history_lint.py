"""The port's history analyzer against the JAX package's.

`analyze` with and without `model=` over the reference's structural
corpus (`tests/test_analysis.py`), the out-of-alphabet read (H006, also
with tuple and micro-op list values) and a state space past the table's
cap (H008); `self_check` of both packages; `python -m
jepsen_tpu_torch.analysis.history_lint`; and `gate`'s telemetry: the
counters with their labels, the `history_lint` series point and the
`MalformedHistory` fault, for clean and malformed histories at the
checker's, Elle's and the independent fan-out's `where`. Each history
is built by both packages from the same ops; every comparison is exact.
The `gpu` case sends a malformed history to the card's checker, which
must launch nothing.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import fleet as jfleet
from jepsen_tpu import history as jh
from jepsen_tpu import metrics as jmetrics
from jepsen_tpu import models as jmodels
from jepsen_tpu import synth as jsynth
from jepsen_tpu.analysis import history_lint as jlint
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import fleet as tfleet
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import metrics as tmetrics
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.analysis import history_lint as tlint

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"ref": (jh, jlint, jmodels, jmetrics, jfleet, jchecker),
        "port": (th, tlint, tmodels, tmetrics, tfleet, tchecker)}


# The structural corpus of tests/test_analysis.py, as op lists:
# (type, process, f, value, time[, index]); `index=None` histories are
# indexed by `History.index()`.
CORPUS = {
    "clean": [("invoke", 0, "write", 1, 0), ("ok", 0, "write", 1, 1),
              ("invoke", 1, "read", None, 2), ("ok", 1, "read", 1, 3)],
    "double-invoke": [("invoke", 0, "write", 1, 0),
                      ("invoke", 0, "write", 2, 1),
                      ("ok", 0, "write", 1, 2)],
    "unmatched-complete": [("invoke", 0, "write", 1, 0),
                           ("ok", 0, "write", 1, 1),
                           ("ok", 1, "write", 2, 2)],
    "time-regression": [("invoke", 0, "write", 1, 10),
                        ("ok", 0, "write", 1, 3)],
    "unset-times": [("invoke", 0, "write", 1, -1),
                    ("ok", 0, "write", 1, -1)],
    "negative-time": [("invoke", 0, "write", 1, -44)],
    "index-disorder": [("invoke", 0, "write", 1, 0, 5),
                       ("ok", 0, "write", 1, 1, 5)],
    "strip-gaps": [("invoke", 0, "write", 1, 0, 0),
                   ("ok", 0, "write", 1, 1, 4)],
    "crashed-pairing": [("invoke", 0, "write", 1, 0),
                        ("info", 0, "write", 1, 1),
                        ("invoke", 0, "write", 2, 2)],
    "out-of-alphabet": [("invoke", 0, "write", 1, 0),
                        ("ok", 0, "write", 1, 1),
                        ("invoke", 1, "read", None, 2),
                        ("ok", 1, "read", 99, 3)],
    "capped": [("ok", i, "write", 1, i) for i in range(40)],
    # a register of (key, value) tuples: the alphabet key must treat the
    # tuples as the encoder does; the read of (9, 9) no state accepts
    "kv-tuples": [("invoke", 0, "write", (1, 2), 0),
                  ("ok", 0, "write", (1, 2), 1),
                  ("invoke", 1, "read", None, 2),
                  ("ok", 1, "read", (1, 2), 3),
                  ("invoke", 2, "read", None, 4),
                  ("ok", 2, "read", (9, 9), 5)],
    # 20 reads of a value never written: 16 findings and a summary
    "unknown-capped": [("invoke", 0, "write", 1, 0),
                       ("ok", 0, "write", 1, 1)] + [
        op for i in range(20) for op in (("invoke", 1, "read", None, 2 + 2 * i),
                                         ("ok", 1, "read", 50 + i, 3 + 2 * i))],
}


def _build(pkg, ops):
    hmod = PKGS[pkg][0]
    made = [getattr(hmod, o[0])(o[1], o[2], o[3], time=o[4]) for o in ops]
    if any(len(o) > 5 for o in ops):
        return hmod.History([m.with_(index=o[5]) for m, o in zip(made, ops)])
    return hmod.History(made).index()


def _model(pkg, name):
    return getattr(PKGS[pkg][2], name)()


@pytest.mark.parametrize("name", sorted(CORPUS))
@pytest.mark.parametrize("model", [None, "cas_register", "register"])
def test_analyze_matches_reference(name, model):
    reps = {}
    for pkg in PKGS:
        lint = PKGS[pkg][1]
        h = _build(pkg, CORPUS[name])
        reps[pkg] = lint.analyze(h, model=_model(pkg, model) if model
                                 else None)
    assert reps["port"] == reps["ref"]
    if name == "out-of-alphabet" and model == "cas_register":
        d = [a for a in reps["port"]["anomalies"] if a["rule"] == "H006"]
        assert d and d[0]["op_index"] == 2 and d[0]["value"] == 99
        assert reps["port"]["ok"] is True     # advisory only
    if name == "kv-tuples" and model:
        d = [a for a in reps["port"]["anomalies"] if a["rule"] == "H006"]
        assert [a["value"] for a in d] == [(9, 9)]


def test_unknown_op_findings_capped_like_reference():
    for pkg in PKGS:
        lint = PKGS[pkg][1]
        rep = lint.analyze(_build(pkg, CORPUS["unknown-capped"]),
                           model=_model(pkg, "cas_register"))
        h006 = [a for a in rep["anomalies"] if a["rule"] == "H006"]
        assert len(h006) == lint.MAX_PER_RULE + 1, pkg
        assert "4 more" in h006[-1]["message"]


def _txn_history(pkg):
    """Multi-register transactions whose values are lists of [f k v]
    micro-ops; the last reads a value key 1 never held. The reads'
    invocations carry no value, so they take their completions'."""
    hmod = PKGS[pkg][0]
    ops = [hmod.invoke(0, "txn", [["w", 1, 3], ["w", 2, 4]], time=0),
           hmod.ok(0, "txn", [["w", 1, 3], ["w", 2, 4]], time=1),
           hmod.invoke(1, "txn", None, time=2),
           hmod.ok(1, "txn", [["r", 1, 3], ["r", 2, 4]], time=3),
           hmod.invoke(2, "txn", None, time=4),
           hmod.ok(2, "txn", [["r", 1, 7]], time=5)]
    return hmod.History(ops).index()


def test_analyze_micro_op_lists_match_reference():
    reps = [PKGS[pkg][1].analyze(_txn_history(pkg),
                                 model=_model(pkg, "multi_register"))
            for pkg in PKGS]
    assert reps[0] == reps[1]
    assert [a["op_index"] for a in reps[1]["anomalies"]] == [4]


def _queue_history(pkg, n=15):
    """n distinct enqueues, all crashed: 2^n reachable queue states,
    past lint_model's cap of 2^14."""
    hmod = PKGS[pkg][0]
    return hmod.History([hmod.invoke(i, "enqueue", i, time=i)
                         for i in range(n)]).index()


def test_h008_encoding_matches_reference():
    reps = [PKGS[pkg][1].analyze(_queue_history(pkg),
                                 model=_model(pkg, "unordered_queue"))
            for pkg in PKGS]
    assert reps[0] == reps[1]
    assert reps[1]["rule_counts"] == {"H008": 1}
    assert reps[1]["ok"] is True
    # under a small cap, straight through lint_model
    small = [[d.to_dict() for d in PKGS[pkg][1].lint_model(
        _queue_history(pkg, 6), _model(pkg, "unordered_queue"),
        max_states=8)] for pkg in PKGS]
    assert small[0] == small[1] and small[1][0]["rule"] == "H008"


def test_rules_match_reference():
    assert tlint.RULES == jlint.RULES
    for name in ("GATE_RULES", "ELLE_GATE_RULES", "INDEPENDENT_GATE_RULES",
                 "MAX_PER_RULE"):
        assert getattr(tlint, name) == getattr(jlint, name), name


def test_self_check_of_both_packages():
    for lint in (jlint, tlint):
        res = lint.self_check()
        assert res == {"ok": True, "failures": []}


def test_module_cli():
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.analysis.history_lint"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout) == {"ok": True, "failures": []}
    assert tlint.main([]) == 0


# --- the gate's telemetry -----------------------------------------------------

WHERES = {"checker.linearizable": "GATE_RULES",
          "elle.append": "ELLE_GATE_RULES",
          "independent": "INDEPENDENT_GATE_RULES"}
GATED = ("clean", "double-invoke", "unmatched-complete", "time-regression",
         "negative-time", "index-disorder", "crashed-pairing", "capped",
         "kv-tuples")


def _planes(pkg):
    return (PKGS[pkg][3].Registry(),
            PKGS[pkg][4].RunStatus(test="lint", progress=False))


def _telemetry(reg, st):
    return {
        "checks": sorted(reg.counter("history_lint_checks_total").samples()),
        "anomalies": sorted(
            reg.counter("history_lint_anomalies_total").samples()),
        "points": [{k: v for k, v in p.items() if k != "t"}
                   for p in reg.series("history_lint").points],
        "faults": st.snapshot()["faults"]}


@pytest.mark.parametrize("where", sorted(WHERES))
@pytest.mark.parametrize("name", GATED)
def test_gate_telemetry_matches_reference(where, name):
    got = {}
    for pkg in PKGS:
        lint = PKGS[pkg][1]
        reg, st = _planes(pkg)
        h = _build(pkg, CORPUS[name])
        res = lint.gate(h, where=where, rules=getattr(lint, WHERES[where]),
                        metrics=reg, status=st)
        got[pkg] = (res, _telemetry(reg, st))
    assert got["port"] == got["ref"]
    res, tel = got["port"]
    clean = res is None
    assert tel["checks"] == [((("verdict", "clean" if clean else "malformed"),
                               ("where", where)), 1)]
    assert len(tel["points"]) == len(tel["faults"]) == (0 if clean else 1)
    if not clean:
        assert tel["faults"][0]["type"] == "MalformedHistory"
        assert tel["faults"][0]["stage"] == f"history-lint/{where}"
        json.dumps(tel["points"])   # the series point is JSON-safe


def test_checker_gate_records_into_ambient_planes():
    """A malformed history through `checker.linearizable` records the
    reference's counter, series point and fault into the installed
    registry and run status, and launches no search."""
    got = {}
    for pkg in PKGS:
        hmod, _lint, models, metrics, fleet, checker = PKGS[pkg]
        reg, st = _planes(pkg)
        h = _build(pkg, CORPUS["double-invoke"])
        with metrics.use(reg), fleet.use(st):
            res = checker.linearizable(models.cas_register(),
                                       algorithm="wgl").check({}, h, {})
        got[pkg] = (res["valid?"], res["cause"], _telemetry(reg, st))
    assert got["port"] == got["ref"]
    assert got["port"][:2] == ("unknown", "malformed-history")


def test_gate_records_nothing_without_planes():
    h = _build("port", CORPUS["double-invoke"])
    assert not tmetrics.get_default().enabled
    assert not tfleet.get_default().enabled
    assert tlint.gate(h)["cause"] == "malformed-history"


def test_synth_histories_analyze_clean_in_both():
    for kw in (dict(n_ops=200, n_procs=5, seed=7, crash_p=0.05),):
        a = jsynth.cas_register_history(**kw)
        b = th.History([th.Op.from_dict(o.to_dict()) for o in a])
        ra = jlint.analyze(a, model=jmodels.cas_register())
        rb = tlint.analyze(b, model=tmodels.cas_register())
        assert ra == rb and rb["ok"] and rb["anomalies"] == []


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_malformed_history_launches_nothing_on_card(cuda_device):
    """A double invoke through `checker.linearizable(algorithm="cuda-wgl")`
    on the card: the gate's diagnosis, its counter, point and fault, and
    no kernel launched."""
    from jepsen_tpu_torch.bench import kernel_wrappers

    h = _build("port", CORPUS["double-invoke"])
    before = {k: w.launches for k, w in kernel_wrappers().items()}
    reg, st = _planes("port")
    with tmetrics.use(reg), tfleet.use(st):
        res = tchecker.linearizable(tmodels.cas_register(),
                                    algorithm="cuda-wgl",
                                    device=cuda_device).check({}, h, {})
    assert (res["valid?"], res["cause"]) == ("unknown", "malformed-history")
    assert {k: w.launches for k, w in kernel_wrappers().items()} == before
    tel = _telemetry(reg, st)
    assert tel["checks"] == [((("verdict", "malformed"),
                               ("where", "checker.linearizable")), 1)]
    assert len(tel["points"]) == 1
    assert [f["type"] for f in tel["faults"]] == ["MalformedHistory"]
