"""The port's autopilot (`jepsen_tpu_torch/autopilot.py`) against the JAX
package's.

The jax-free cases of `tests/test_autopilot.py` run on the port's
modules: the verify-or-revert contract against fabricated hosts
(verified / reverted + quarantined / suppressed / apply-failure faults /
per-rule quarantine isolation), the policy predicate and burn gate,
offline replay parity over a ledger-banked compile-storm corpus, the
`/status.json` `autopilot` block, the schema lint (good and drifted),
the service's actuator substrate (resize_workers / open_shed / the
ladder pin) and the Perfetto lane. The reference's two HTML-panel cases
wait for the port's pages.

Held exactly against the reference: `policy_rows`, `replay`,
`burn_finding`, and the `kind="autopilot-action"` and
`kind="autopilot-quarantine"` records of the same lifecycle. Then a CPU
`Service(autopilot=True, device="cpu")` runs the closed loop through
its own `ServiceHost`: a seeded compile storm fires D001, the
warm-bucket actuator warms the held request's canonical bucket through
`aot.precompile_service_plan`, and the next pass settles "verified"; a
burn that never cools is pre-shed, reverted, quarantined and
suppressed, with the actuator run once; a new service on the same store
rehydrates the quarantine, and `serve --clear-quarantine` discards it.
"""

import json
import os
import sys
import threading
import time
import urllib.request

import pytest

from jepsen_tpu import autopilot as jap
from jepsen_tpu import doctor as jdoctor
from jepsen_tpu import ledger as jledger
from jepsen_tpu import metrics as jmetrics
from jepsen_tpu_torch import __main__ as tmain
from jepsen_tpu_torch import autopilot as ap
from jepsen_tpu_torch import doctor, fleet, fs_cache, ledger, metrics
from jepsen_tpu_torch import service as tservice
from jepsen_tpu_torch import slo, synth, trace, web
from jepsen_tpu_torch.ops import adapt

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scripts"))
import telemetry_lint  # noqa: E402


@pytest.fixture(autouse=True)
def _isolate():
    ap._reset()
    jap._reset()
    adapt.unpin_ladder()
    yield
    ap._reset()
    jap._reset()
    adapt.unpin_ladder()


def _finding(rule="D001", subject="W=7,K=16", **kw):
    f = {"rule": rule, "name": "compile-storm", "severity": "warn",
         "summary": f"seeded {rule}", "subject": subject,
         "score": 9.0, "evidence": []}
    f.update(kw)
    return f


def _host_classes(mod):
    """OneRuleHost / StuckHost over one package's `Host` base."""

    class OneRuleHost(mod.Host):
        """Fires one rule; the metric improves once `actuate` ran."""

        def __init__(self, rule="D001", before=50.0, after=0.0):
            self.rule, self.before, self.after = rule, before, after
            self.applied = 0
            self.rolled = 0

        def diagnose(self):
            return {"findings": [_finding(self.rule)]}

        def probe(self, metric, since=None):
            return self.after if self.applied else self.before

        def actuate(self, entry, finding):
            self.applied += 1

            def rollback():
                self.rolled += 1

            return {"subject": finding.get("subject")}, rollback

    class StuckHost(OneRuleHost):
        """The actuator runs but the metric never improves."""

        def probe(self, metric, since=None):
            return self.before

    return OneRuleHost, StuckHost


OneRuleHost, StuckHost = _host_classes(ap)


class TestPolicyPredicate:
    def test_down_abs_ok(self):
        e = ap.PolicyRule("D001", "a", "m", improve_x=0.5, abs_ok=0.0)
        assert e.improved(50.0, 0.0)
        assert e.improved(50.0, 20.0)      # ratio path
        assert not e.improved(50.0, 40.0)

    def test_up_direction(self):
        e = ap.PolicyRule("D002", "a", "m", direction="up",
                          improve_x=1.2, abs_ok=0.8)
        assert e.improved(0.3, 0.9)        # abs path
        assert e.improved(0.3, 0.4)        # ratio path
        assert not e.improved(0.3, 0.31)

    def test_unprobeable_after_never_verifies(self):
        e = ap.PolicyRule("D001", "a", "m", abs_ok=0.0)
        assert not e.improved(50.0, None)

    def test_missing_baseline_needs_abs(self):
        e = ap.PolicyRule("D001", "a", "m", improve_x=0.5,
                          abs_ok=None)
        assert not e.improved(None, 1.0)

    def test_table_is_frozen_rows(self):
        rules = [e.rule for e in ap.POLICY]
        assert rules == ["D001", "D002", "D003", "D005", "D012",
                         "burn"]
        with pytest.raises(AttributeError):
            ap.POLICY[0].improve_x = 99.0


class TestBurnGate:
    def test_alerting_objective_fires(self):
        rep = {"objectives": [
            {"name": "warm-p50", "burn_alert": True,
             "budget": {"remaining_frac": 0.9},
             "windows": [{"burn_rate": 4.0}]}]}
        f = ap.burn_finding(rep)
        assert f and f["rule"] == "burn"
        assert "warm-p50" in f["objectives"]

    def test_draining_budget_fires_before_alert(self):
        rep = {"objectives": [
            {"name": "availability", "burn_alert": False,
             "budget": {"remaining_frac": 0.4},
             "windows": [{"burn_rate": 1.5}]}]}
        assert ap.burn_finding(rep) is not None

    def test_healthy_budget_is_silent(self):
        rep = {"objectives": [
            {"name": "availability", "burn_alert": False,
             "budget": {"remaining_frac": 0.95},
             "windows": [{"burn_rate": 0.2}]}]}
        assert ap.burn_finding(rep) is None
        assert ap.burn_finding(None) is None


class TestVerifyOrRevert:
    def test_improving_action_verifies(self):
        host = OneRuleHost()
        sup = ap.Supervisor(host, verify_after_s=0.0)
        out1 = sup.step(now=100.0)
        assert out1["applied"] == ["D001"]
        out2 = sup.step(now=101.0)
        assert "D001" in out2["verified"]
        assert sup.quarantined() == {}
        events = [h["event"] for h in sup.history()]
        assert events[:3] == ["decision", "apply", "verify"]

    def test_failing_verify_reverts_and_quarantines(self):
        host = StuckHost()
        sup = ap.Supervisor(host, verify_after_s=0.0)
        sup.step(now=100.0)
        out2 = sup.step(now=101.0)
        assert out2["reverted"] == ["D001"]
        assert host.rolled == 1
        q = sup.quarantined()
        assert q["D001"]["reason"] == "verify-failed"
        # re-fire is suppressed, never retried
        out3 = sup.step(now=102.0)
        assert out3["suppressed"] == ["D001"]
        assert host.applied == 1

    def test_unprobeable_after_reverts(self):
        class Blind(OneRuleHost):
            def probe(self, metric, since=None):
                return 50.0 if not self.applied else None

        sup = ap.Supervisor(Blind(), verify_after_s=0.0)
        sup.step(now=100.0)
        out2 = sup.step(now=101.0)
        assert out2["reverted"] == ["D001"]

    def test_one_in_flight_action_per_rule(self):
        host = OneRuleHost()
        sup = ap.Supervisor(host, verify_after_s=60.0)
        sup.step(now=100.0)
        sup.step(now=101.0)  # deadline not reached: no second apply
        assert host.applied == 1

    def test_apply_failure_faults_and_quarantines(self):
        class Broken(OneRuleHost):
            def actuate(self, entry, finding):
                raise RuntimeError("precompile failed")

        mx = metrics.Registry()
        sup = ap.Supervisor(Broken(), verify_after_s=0.0, mx=mx)
        out = sup.step(now=100.0)
        assert out["reverted"] == ["D001"]
        assert "D001" in sup.quarantined()
        assert sup.quarantined()["D001"]["reason"].startswith(
            "apply-failed")
        # the failure is a structured fleet fault with stage and
        # rule/action attribution
        pts = mx.series("fleet_faults").points
        assert pts and pts[-1]["stage"] == "autopilot"
        assert pts[-1]["rule"] == "D001"
        assert pts[-1]["action"] == "warm-bucket"

    def test_quarantine_isolates_per_rule(self):
        class TwoRules(ap.Host):
            def __init__(self):
                self.applied = []

            def diagnose(self):
                return {"findings": [_finding("D001"),
                                     _finding("D003",
                                              subject="ladder")]}

            def probe(self, metric, since=None):
                # D001's metric never improves; D003's always does
                return 50.0 if metric == "recent_compiles" else 0.0

            def actuate(self, entry, finding):
                self.applied.append(entry.rule)
                return {}, None

        host = TwoRules()
        sup = ap.Supervisor(host, verify_after_s=0.0)
        sup.step(now=100.0)
        out2 = sup.step(now=101.0)
        assert out2["reverted"] == ["D001"]
        assert "D003" in out2["verified"]
        out3 = sup.step(now=102.0)
        # D001 quarantined and suppressed; D003 keeps acting
        assert out3["suppressed"] == ["D001"]
        assert "D003" in out3["applied"]
        assert list(sup.quarantined()) == ["D001"]


class TestBanking:
    def test_series_and_records_lint_clean(self, tmp_path):
        mx = metrics.Registry()
        led = ledger.Ledger(str(tmp_path))
        sup = ap.Supervisor(StuckHost(), verify_after_s=0.0,
                            where="test", mx=mx, ledger=led)
        sup.step(now=100.0)
        sup.step(now=101.0)
        sup.step(now=102.0)
        mpath = str(tmp_path / "m.jsonl")
        mx.export_jsonl(mpath)
        assert telemetry_lint.lint_jsonl_file(mpath) == []
        assert telemetry_lint.lint_ledger_file(led.index_path) == []
        recs = led.query(kind="autopilot-action")
        events = sorted(r["event"] for r in recs)
        # step 2 reverts AND suppresses the still-live finding;
        # step 3 suppresses again
        assert events == ["apply", "decision", "revert", "suppress",
                          "suppress"]
        rev = next(r for r in recs if r["event"] == "revert")
        assert rev["verdict"] == "reverted"
        assert rev["quarantined"] is True
        assert rev["baseline"]["metric"] == "recent_compiles"
        assert rev["rollback"] == "applied"
        assert rev["finding"]["rule"] == "D001"

    def test_counters_by_event(self):
        mx = metrics.Registry()
        sup = ap.Supervisor(OneRuleHost(), verify_after_s=0.0, mx=mx)
        sup.step(now=100.0)
        sup.step(now=101.0)
        snap = sup.snapshot()
        assert snap["counts"]["decision"] == 2
        assert snap["counts"]["verify"] == 1

    def test_banking_never_raises_without_sinks(self):
        # disabled ambient defaults: recording must be a no-op
        sup = ap.Supervisor(OneRuleHost(), verify_after_s=0.0)
        sup.step(now=100.0)
        out = sup.step(now=101.0)
        assert "D001" in out["verified"]


class TestLintDrift:
    def _line(self, **kw):
        obj = {"type": "sample", "series": "autopilot",
               "t": 100.0, "event": "apply", "rule": "D001",
               "action": "warm-bucket", "where": "test",
               "metric": "recent_compiles"}
        obj.update(kw)
        return obj

    def test_good_series_line_passes(self):
        assert telemetry_lint.lint_line(self._line(), "x") == []
        assert telemetry_lint.lint_line(
            self._line(rule="burn", event="suppress"), "x") == []

    def test_drifted_event_fails(self):
        errs = telemetry_lint.lint_line(
            self._line(event="applied"), "x")
        assert errs and "event" in errs[0]

    def test_drifted_rule_fails(self):
        errs = telemetry_lint.lint_line(self._line(rule="D099"), "x")
        assert errs

    def test_record_drift_fails(self, tmp_path):
        bad = {"schema": 1, "id": "r1", "kind": "autopilot-action",
               "name": "autopilot-D001", "t": 100.0,
               "event": "verify", "rule": "D001",
               "action": "warm-bucket", "params": {}}
        p = tmp_path / "r1.json"
        p.write_text(json.dumps(bad))
        errs = telemetry_lint.lint_ledger_file(str(p))
        # a settled event without baseline or verdict is drift
        assert any("baseline" in e for e in errs)
        assert any("verdict" in e for e in errs)


def _banked_storm(led):
    for i in range(50):
        led.record({"kind": "independent", "name": f"key-{i}",
                    "compiles": 1,
                    "shapes": {"K": 16, "W_pad": 7}})
    led.record({"kind": "preflight", "name": "indep",
                "verdict": "feasible", "rules": [],
                "preflight": {"verdict": "feasible",
                              "buckets": [16]}})
    return led


class TestReplay:
    def test_parity_with_live_decisions(self, tmp_path):
        led = _banked_storm(ledger.Ledger(str(tmp_path)))
        report = doctor.diagnose(doctor.TelemetryView(
            target="storm-replay", platform="cpu",
            records=led.query()))

        class StoreHost(ap.Host):
            def __init__(self):
                self.warmed = False

            def diagnose(self):
                return report

            def probe(self, metric, since=None):
                return 0.0 if self.warmed else 50.0

            def actuate(self, entry, finding):
                self.warmed = True
                return {}, None

        sup = ap.Supervisor(StoreHost(), verify_after_s=0.0)
        live = sup.step(now=100.0)
        decided = ap.replay(report)
        assert [d["rule"] for d in decided] == live["decisions"]
        assert decided[0]["action"] == "warm-bucket"
        assert decided[0]["subject"]  # the storm's worst subject

    def test_replay_is_pure(self, tmp_path):
        led = _banked_storm(ledger.Ledger(str(tmp_path)))
        report = doctor.diagnose(doctor.TelemetryView(
            target="storm-replay", records=led.query()))
        n_before = len(led.query())
        out = ap.replay(report)
        assert out and len(led.query()) == n_before

    def test_burn_rides_replay(self):
        slo_rep = {"objectives": [
            {"name": "warm-p50", "burn_alert": True,
             "budget": {"remaining_frac": 0.1},
             "windows": [{"burn_rate": 5.0}]}]}
        out = ap.replay({"findings": []}, slo_rep)
        assert [d["rule"] for d in out] == ["burn"]
        assert out[0]["action"] == "pre-shed"

    def test_cli_json(self, tmp_path, capsys):
        led = _banked_storm(ledger.Ledger(str(tmp_path)))
        led.record({"kind": "checker", "name": "run-x",
                    "platform": "cpu", "compiles": 0})
        rc = ap.cli_main({"store": str(tmp_path), "json": True},
                         ["latest"])
        assert rc == 0
        out = json.loads(capsys.readouterr().out)
        assert "decisions" in out and "policy" in out
        assert [p["rule"] for p in out["policy"]] == [
            e.rule for e in ap.POLICY]

    def test_cli_missing_target(self, tmp_path):
        assert ap.cli_main({"store": str(tmp_path)},
                           ["nope"]) == 254


class TestStatusSurface:
    def test_idle_stub(self, tmp_path):
        snap = web.status_snapshot(str(tmp_path / "store"))
        assert snap["autopilot"] == {
            "active": False, "steps": 0, "counts": {},
            "quarantined": {}, "pending": [], "actions": []}

    def test_live_block(self, tmp_path):
        sup = ap.Supervisor(StuckHost(), verify_after_s=0.0)
        ap.set_default(sup)
        sup.step(now=100.0)
        sup.step(now=101.0)
        snap = web.status_snapshot(str(tmp_path / "store"))
        blk = snap["autopilot"]
        assert blk["steps"] == 2
        assert "D001" in blk["quarantined"]
        assert blk["counts"]["revert"] == 1
        assert [p["rule"] for p in blk["policy"]] == [
            e.rule for e in ap.POLICY]

    def test_mirror_keeps_its_own_block(self, tmp_path):
        """A status mirror written by another process keeps its
        `autopilot` block while this process runs no supervisor."""
        root = tmp_path / "store"
        root.mkdir()
        mirror = {**web._idle_status(), "active": True,
                  "autopilot": {"active": True, "steps": 3}}
        (root / "current-status.json").write_text(json.dumps(mirror))
        snap = web.status_snapshot(str(root))
        assert snap["autopilot"] == {"active": True, "steps": 3}

    def test_perfetto_lane(self):
        sup = ap.Supervisor(OneRuleHost(), verify_after_s=0.0)
        ap.set_default(sup)
        sup.step(now=100.0)
        inst = ap.perfetto_instants()
        assert inst and all(
            i["lane"] == "autopilot actions" for i in inst)
        events = trace.instant_events(inst)
        lanes = {e["args"]["name"] for e in events
                 if e.get("name") == "thread_name"}
        assert "autopilot actions" in lanes

    def test_perfetto_export_takes_both_lanes(self, tmp_path):
        """`to_perfetto(instants=)` renders the autopilot's markers and
        the doctor's in their own labeled rows."""
        sup = ap.Supervisor(OneRuleHost(), verify_after_s=0.0)
        ap.set_default(sup)
        sup.step(now=100.0)
        inst = ap.perfetto_instants() + [
            {"t": 100.5, "name": "D001 compile-storm"}]
        doc = trace.to_perfetto([], instants=inst)
        rows = {e["args"]["name"] for e in doc["traceEvents"]
                if e.get("name") == "thread_name"}
        assert {"autopilot actions", "doctor findings"} <= rows
        ap._reset()
        assert ap.perfetto_instants() == []


def _svc(root, **kw):
    kw.setdefault("heartbeat_every_s", 0)
    kw.setdefault("slo_every_s", 3600.0)
    return tservice.Service(str(root), device="cpu", **kw)


class TestServiceActuatorSubstrate:
    def test_resize_workers_grow_and_shrink(self, tmp_path):
        svc = _svc(tmp_path / "store", workers=2)
        svc.start()
        try:
            assert svc.resize_workers(4) == {"from": 2, "to": 4}
            time.sleep(0.1)
            assert sum(t.is_alive() for t in svc._threads) == 4
            assert svc.resize_workers(1) == {"from": 4, "to": 1}
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline:
                if sum(t.is_alive() for t in svc._threads) == 1:
                    break
                time.sleep(0.05)
            assert sum(t.is_alive() for t in svc._threads) == 1
        finally:
            svc.close()

    def test_resize_workers_rejects_out_of_range(self, tmp_path):
        svc = _svc(tmp_path / "store")
        with pytest.raises(ValueError):
            svc.resize_workers(0)
        with pytest.raises(ValueError):
            svc.resize_workers(tservice.POOL_MAX + 1)

    def test_open_close_shed(self, tmp_path):
        svc = _svc(tmp_path / "store")
        svc.open_shed(["warm-p50"], hold_s=30.0, source="autopilot")
        shed = svc.shedding()
        assert shed and shed["burning"] == ["warm-p50"]
        assert shed["source"] == "autopilot"
        svc.close_shed()
        assert svc.shedding() is None

    def test_service_autopilot_flag_spawns_supervisor(self, tmp_path):
        svc = _svc(tmp_path / "store", autopilot=True,
                   autopilot_every_s=600.0)
        svc.start()
        try:
            assert svc.autopilot_enabled
            assert svc._autopilot is not None
            assert svc._autopilot.active
            assert ap.get_default() is svc._autopilot
        finally:
            svc.close()
        assert not (svc._autopilot and svc._autopilot.active)

    def test_ladder_pin_forces_switch_and_unpin_releases(self):
        pol = adapt.Policy(ladder=adapt.LADDER32, n_ok=64,
                           backlog_cap=1024)
        assert pol.k == adapt.LADDER32[0]
        adapt.pin_ladder(512, reason="autopilot-D003")
        d = pol.observe(explored=10, rounds_delta=1,
                        explored_delta=10, frontier=1, backlog=0)
        assert d.switch and d.to_k == 512
        assert d.reason == "pinned"
        # held while pinned
        d2 = pol.observe(explored=20, rounds_delta=1,
                         explored_delta=10, frontier=1, backlog=0)
        assert not d2.switch and d2.reason == "pinned"
        adapt.unpin_ladder()
        assert adapt.ladder_pin() is None

    def test_pin_is_start_bucket_for_new_policies(self):
        adapt.pin_ladder(64)
        pol = adapt.Policy(ladder=adapt.LADDER32, n_ok=64,
                           backlog_cap=1024)
        assert pol.k == 64

    def test_backlog_pressure_outranks_pin(self):
        adapt.pin_ladder(2)
        pol = adapt.Policy(ladder=adapt.LADDER32, n_ok=64,
                           backlog_cap=64, start_k=2)
        d = pol.observe(explored=10, rounds_delta=1,
                        explored_delta=10, frontier=1, backlog=60)
        assert d.reason != "pinned"

    def test_fault_event_context_rides_under_envelope(self):
        ev = fleet.fault_event(RuntimeError("boom"),
                               stage="autopilot",
                               context={"rule": "D001",
                                        "action": "warm-bucket",
                                        "stage": "spoofed"})
        assert ev["stage"] == "autopilot"  # envelope wins
        assert ev["rule"] == "D001"
        assert ev["action"] == "warm-bucket"


# --- against the reference ----------------------------------------------------

SLO_REPORTS = [
    None, {}, {"objectives": []},
    {"objectives": [{"name": "warm-p50", "burn_alert": True,
                     "budget": {"remaining_frac": 0.9},
                     "windows": [{"burn_rate": 4.0}]}]},
    {"objectives": [{"name": "availability", "burn_alert": False,
                     "budget": {"remaining_frac": 0.4},
                     "windows": [{"burn_rate": 1.5},
                                 {"burn_rate": 2.5}]},
                    {"name": "warm-p50", "burn_alert": True,
                     "budget": {}, "windows": [{}]}]},
    {"objectives": [{"name": "availability", "burn_alert": False,
                     "budget": {"remaining_frac": 0.95},
                     "windows": [{"burn_rate": 0.2}]}]},
]


def test_policy_rows_match_the_reference():
    assert ap.policy_rows() == jap.policy_rows()
    assert ap.policy_rows(ap.POLICY[2:4]) == jap.policy_rows(
        jap.POLICY[2:4])
    assert (ap.EVENTS, ap.PERFETTO_LANE, ap.CLEAR_QUARANTINE_ENV,
            ap.PRE_SHED_BUDGET_FRAC) == (
        jap.EVENTS, jap.PERFETTO_LANE, jap.CLEAR_QUARANTINE_ENV,
        jap.PRE_SHED_BUDGET_FRAC)


@pytest.mark.parametrize("i", range(len(SLO_REPORTS)))
def test_burn_finding_matches_the_reference(i):
    assert ap.burn_finding(SLO_REPORTS[i]) == jap.burn_finding(
        SLO_REPORTS[i])


@pytest.mark.parametrize("i", range(len(SLO_REPORTS)))
def test_replay_matches_the_reference(tmp_path, i):
    """Both doctors over the same banked storm, both replays over each
    package's report, and each replay over the other's report. The
    records go to each doctor in name order: records banked within one
    millisecond come back from a query in an order of their random ids,
    and the storm's subject is the first of its equal keys."""
    def storm(mod, d):
        return sorted(_banked_storm(mod.Ledger(str(tmp_path / d))).query(),
                      key=lambda r: r["name"])

    trep = doctor.diagnose(doctor.TelemetryView(
        target="storm", platform="cpu", records=storm(ledger, "t")))
    jrep = jdoctor.diagnose(jdoctor.TelemetryView(
        target="storm", platform="cpu", records=storm(jledger, "j")))
    slo_rep = SLO_REPORTS[i]
    want = jap.replay(jrep, slo_rep)
    assert [d["rule"] for d in want][:1] == ["D001"]
    assert ap.replay(trep, slo_rep) == want
    assert ap.replay(jrep, slo_rep) == want
    assert ap.replay({"findings": []}, slo_rep) == jap.replay(
        {"findings": []}, slo_rep)


def _records(led, kind):
    """A ledger's records of `kind` without their clocks and ids, in a
    canonical order (records banked within one millisecond come back
    from a query in the order of their random ids)."""
    recs = [{k: v for k, v in r.items() if k not in ("t", "id")}
            for r in led.query(kind=kind)]
    return sorted(recs, key=lambda r: json.dumps(r, sort_keys=True,
                                                 default=str))


@pytest.mark.parametrize("host", ["verify", "revert"])
def test_action_records_match_the_reference(tmp_path, host):
    """The same lifecycle under both supervisors banks the same
    `autopilot-action` and `autopilot-quarantine` records (keys and
    values), the same series points and the same snapshot counts."""
    out = {}
    for name, mod, led_mod, mx_mod in (
            ("j", jap, jledger, jmetrics), ("t", ap, ledger, metrics)):
        one, stuck = _host_classes(mod)
        led = led_mod.Ledger(str(tmp_path / name))
        mx = mx_mod.Registry()
        sup = mod.Supervisor(one() if host == "verify" else stuck(),
                             verify_after_s=0.0, where="test", mx=mx,
                             ledger=led)
        steps = [sup.step(now=100.0 + s) for s in range(3)]
        out[name] = {
            "steps": steps,
            "actions": _records(led, "autopilot-action"),
            "quarantine": _records(led, "autopilot-quarantine"),
            "points": [{k: v for k, v in p.items() if k != "t"}
                       for p in mx.series("autopilot").points],
            "counts": sup.snapshot()["counts"],
            "history": sup.history()}
    assert out["t"] == out["j"]
    assert out["t"]["actions"]
    assert bool(out["t"]["quarantine"]) == (host == "revert")


# --- the closed loop over a CPU service -----------------------------------------

@pytest.fixture
def cpu_service_env(tmp_path, monkeypatch):
    """Isolated process-wide state for a service: the plan registry, the
    ambient defaults, no heartbeat writer."""
    monkeypatch.setattr(fs_cache, "DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("JEPSEN_TPU_HEARTBEAT_S", "0")
    monkeypatch.delenv(ap.CLEAR_QUARANTINE_ENV, raising=False)
    slo._reset()
    yield tmp_path
    tservice.set_default(None)
    slo._reset()


def _body(seed, n_ops=300):
    h = synth.cas_register_history(n_ops, n_procs=4, seed=seed)
    return {"model": "cas-register", "history": [o.to_dict() for o in h]}


BURNING = {"objectives": [{"name": "warm-p50", "burn_alert": True,
                           "budget": {"remaining_frac": 0.2},
                           "windows": [{"burn_rate": 6.0}]}]}


class _NeverCools(ap.ServiceHost):
    """The live service, under an SLO report whose burn never cools."""

    def diagnose(self):
        return {"findings": []}

    def slo_report(self):
        return BURNING


def test_service_closed_loop_on_the_cpu(cpu_service_env):
    root = cpu_service_env / "store"
    svc = _svc(root, autopilot=True, autopilot_every_s=3600.0)
    svc.start()
    try:
        sup = svc._autopilot
        assert sup is not None and sup.active
        assert ap.get_default() is sup
        # a held request: the live request whose canonical bucket the
        # warm-bucket actuator warms
        svc.hold(True)
        rid = svc.submit(_body(21))["id"]
        req = svc._runs[rid]
        assert req.bucket is not None and req.bucket_key not in svc._warm
        # storm -> warm -> verified, through the service's own host
        _banked_storm(svc.ledger)
        time.sleep(0.01)  # the storm stays strictly before the action
        out1 = sup.step()
        assert out1["decisions"][:1] == ["D001"]
        assert out1["applied"] == ["D001"]
        assert req.bucket_key in svc._warm
        assert svc._warm[req.bucket_key]["autopilot"] is True
        # past the verify deadline (every_s: the loop's own cadence)
        out2 = sup.step(now=time.time() + sup.verify_after_s + 1.0)
        assert out2["verified"] == ["D001"]
        # the storm's records are still in the doctor's window, so D001
        # fires again in the same pass; its bucket is warm now, so no
        # cold request is left to warm: a structured fault and a
        # quarantine, not a retry loop
        assert out2["reverted"] == ["D001"]
        assert sup.quarantined()["D001"]["reason"].startswith(
            "apply-failed")
        fault = svc.mx.series("fleet_faults").points[-1]
        assert (fault["stage"], fault["rule"]) == ("autopilot", "D001")
        recs = svc.ledger.query(kind="autopilot-action")
        apply = next(r for r in recs if r["event"] == "apply")
        assert apply["params"] == {"bucket": tservice._key_str(
            req.bucket_key)}
        verify = next(r for r in recs if r["event"] == "verify")
        assert verify["verdict"] == "verified"
        assert verify["metric_after"] == 0.0
        # the warmed bucket answers its request
        svc.hold(False)
        deadline = time.monotonic() + 120
        while svc.get(rid)["state"] not in ("done", "rejected"):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert svc.get(rid)["verdict"] is True
        assert svc.get(rid)["warm_hit"] is True

        # revert -> quarantine -> suppressed: a burn that never cools
        shed_calls = []
        real_open = svc.open_shed

        def counted_open(*a, **kw):
            shed_calls.append(a)
            return real_open(*a, **kw)

        svc.open_shed = counted_open
        bsup = ap.Supervisor(_NeverCools(svc), verify_after_s=0.0,
                             where="service", mx=svc.mx,
                             ledger=svc.ledger)
        b1 = bsup.step(now=1000.0)
        assert b1["applied"] == ["burn"] and svc.shedding() is not None
        b2 = bsup.step(now=1001.0)
        assert b2["reverted"] == ["burn"]
        assert svc.shedding() is None  # the rollback closed the window
        assert bsup.quarantined()["burn"]["reason"] == "verify-failed"
        b3 = bsup.step(now=1002.0)
        assert b3["suppressed"] == ["burn"]
        assert len(shed_calls) == 1
        snap = web.status_snapshot(str(root))["autopilot"]
        assert snap["active"] is True and snap["counts"]["verify"] == 1
    finally:
        svc.close()
    assert not sup.active

    # a new service on the same store rehydrates the quarantine
    svc2 = _svc(root, autopilot=True, autopilot_every_s=3600.0)
    svc2.start()
    try:
        q = svc2._autopilot.quarantined()
        assert set(q) == {"D001", "burn"}
        assert all(v["restored"] is True for v in q.values())
        assert svc2._heartbeat_once() is not None
        hb = svc2.ledger.query(kind="replica-heartbeat")[-1]
        assert hb["autopilot"] == {"active": True,
                                   "quarantined": ["D001", "burn"]}
    finally:
        svc2.close()


def _serve_on_a_thread(monkeypatch, argv):
    """`python -m jepsen_tpu_torch serve ...` in this process, on a
    thread; returns (base URL, stop)."""
    made = []
    real_serve = web.serve

    def capture(**kw):
        server = real_serve(**kw)
        made.append(server)
        return server

    monkeypatch.setattr(web, "serve", capture)
    rc = []
    t = threading.Thread(target=lambda: rc.append(tmain.main(argv)),
                         daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    while not made:
        assert time.monotonic() < deadline and t.is_alive(), rc
        time.sleep(0.02)
    base = f"http://127.0.0.1:{made[0].server_port}"

    def stop():
        made[0].shutdown()
        t.join(timeout=30)
        return rc

    return base, stop


def _status(base):
    with urllib.request.urlopen(base + "/status.json", timeout=30) as r:
        return json.loads(r.read())


def test_serve_clear_quarantine_discards_it(cpu_service_env, monkeypatch):
    root = cpu_service_env / "store"
    led = ledger.Ledger(str(root))
    sup = ap.Supervisor(StuckHost(), verify_after_s=0.0, ledger=led)
    sup.step(now=100.0)
    sup.step(now=101.0)
    assert set(sup.quarantined()) == {"D001"}
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    # setenv first, so that the value the command sets is undone after
    monkeypatch.setenv(ap.CLEAR_QUARANTINE_ENV, "0")
    base, stop = _serve_on_a_thread(monkeypatch, [
        "serve", "--service", "--autopilot", "--clear-quarantine",
        "--device", "cpu", "-b", "127.0.0.1", "-p", "0",
        "--store-root", str(root)])
    try:
        blk = _status(base)["autopilot"]
        assert blk["active"] is True and blk["quarantined"] == {}
        assert os.environ[ap.CLEAR_QUARANTINE_ENV] == "1"
    finally:
        assert stop() == [0]
    clears = [r for r in led.query(kind="autopilot-quarantine")
              if r["event"] == "clear"]
    assert [r["rule"] for r in clears] == ["D001"]
    # without the flag the quarantine would have come back
    monkeypatch.setenv(ap.CLEAR_QUARANTINE_ENV, "0")
    assert ap.Supervisor(StuckHost(), ledger=led).quarantined() == {}
