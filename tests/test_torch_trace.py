"""The port's tracer (`jepsen_tpu_torch/trace.py`) against the JAX
package's, and the phase spans of the port's `ops/wgl.check(tracer=)`.

  * the same span program (nesting, threads, an explicit parent,
    annotations, attributes, listeners, trim) in both tracers gives the
    same span tree, and the same OTLP lines and Perfetto events once ids
    and times are masked; `counter_events`, `instant_events`,
    `to_perfetto`, `perfetto_from_jsonl` and `tracing` agree;
  * `wgl.check(tracer=)` opens the reference's span names, in the
    reference's order and nesting (encode, then compile / device-round
    with host-poll inside each chunk), on the headline's shape at a
    small size, narrow and wide, on the CPU.
"""

import json
import threading

import pytest

from jepsen_tpu import synth as jsynth
from jepsen_tpu import trace as jtrace
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import trace as ttrace
from jepsen_tpu_torch.models import core as tmodels
from jepsen_tpu_torch.ops import wgl as twgl


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


def _program(mod):
    """One span program; returns the tracer and the listener's log."""
    t = mod.Tracer(sampled=True, service="svc")
    seen = []
    t.add_listener(lambda ev, sp: seen.append((ev, sp.name)))
    t.add_listener(lambda ev, sp: 1 / 0)   # a failing listener is ignored
    with t.span("admit", attrs={"run_id": "r1", "tenant": "x"}):
        ctx = t.context()
        with t.span("encode", attrs={"ops": 10}):
            t.annotate("halfway")
            t.attribute("k", 7)
        with t.span("search"):
            with t.span("device-round", attrs={"chunk": 0}):
                with t.span("host-poll"):
                    pass

    def worker():
        with t.span("queue-wait", parent=ctx, attrs={"run_id": "r1"}):
            with t.span("respond"):
                pass
    th_ = threading.Thread(target=worker)
    th_.start()
    th_.join(timeout=10)
    with t.span("detached"):
        pass
    return t, seen


def _tree(spans):
    """Each span as (name, parent name, same trace as the first span,
    attrs, annotation messages), in finish order."""
    by_id = {s.span_id: s for s in spans}
    root_trace = spans[0].trace_id
    return [(s.name, by_id[s.parent_id].name if s.parent_id in by_id
             else s.parent_id, s.trace_id == root_trace, s.attrs,
             [a["message"] for a in s.annotations]) for s in spans]


_IDS = {"traceId", "spanId", "parentSpanId", "startTimeUnixNano",
        "endTimeUnixNano"}


def _mask_events(events):
    out = []
    for e in events:
        e = dict(e)
        for k in ("ts", "dur"):
            if k in e:
                e[k] = 0
        if "args" in e:
            e["args"] = {k: v for k, v in e["args"].items()
                         if k not in ("spanId", "parentSpanId")}
        if e.get("name", "").startswith("trace ") or \
                str(e.get("args", {}).get("name", "")).startswith("trace "):
            e["args"] = {"name": "trace"}
        out.append(e)
    return out


def test_span_tree_matches_reference():
    (tj, seen_j), (tt, seen_t) = _program(jtrace), _program(ttrace)
    assert _tree(tj.spans) == _tree(tt.spans)
    assert seen_j == seen_t
    assert tt.context() is None
    # the worker adopted the explicit parent's trace
    names = {s.name: s for s in tt.spans}
    assert names["queue-wait"].trace_id == names["admit"].trace_id
    assert names["detached"].parent_id is None


def test_export_and_perfetto_match_reference(tmp_path):
    (tj, _), (tt, _) = _program(jtrace), _program(ttrace)
    pj, pt = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    assert tj.export(str(pj)) == tt.export(str(pt)) == 8
    lj = [json.loads(x) for x in pj.read_text().splitlines()]
    lt = [json.loads(x) for x in pt.read_text().splitlines()]

    def bare(x):
        return {k: ([{**a, "time": 0} for a in v] if k == "events" else v)
                for k, v in x.items() if k not in _IDS}
    assert [bare(x) for x in lj] == [bare(x) for x in lt]
    dj = jtrace.perfetto_from_jsonl(str(pj))
    dt = ttrace.perfetto_from_jsonl(str(pt))
    assert dt["displayTimeUnit"] == dj["displayTimeUnit"] == "ms"
    assert _mask_events(dt["traceEvents"]) == \
        _mask_events(dj["traceEvents"])
    ej, et = tmp_path / "j.json", tmp_path / "t.json"
    counters = {"fill": [(1.0, 0.5), (0.5, 0.25), ("x", 1)],
                "hbm bytes cpu": [(2.0, 10)], "empty": []}
    instants = [{"t": 1.5, "name": "D001"}, {"t": 2.0, "name": "act",
                                             "lane": "actions"}, {"x": 1}]
    assert tj.export_perfetto(str(ej), counters=counters,
                              instants=instants) == \
        tt.export_perfetto(str(et), counters=counters, instants=instants)
    assert _mask_events(json.loads(et.read_text())["traceEvents"]) == \
        _mask_events(json.loads(ej.read_text())["traceEvents"])


@pytest.mark.parametrize("pid", [1, 4])
def test_event_builders_match_reference(pid):
    spans = [{"name": "a", "traceId": "t" * 32, "spanId": "s1",
              "parentSpanId": None, "startTimeUnixNano": 1_000_000,
              "endTimeUnixNano": 3_000_000, "attributes": {"x": 1},
              "events": [{"time": 0.002, "message": "m"}, {"bad": 1}]},
             {"name": "open", "traceId": "u" * 32, "spanId": "s2",
              "startTimeUnixNano": 2_000_000, "endTimeUnixNano": None},
             "junk", {"name": "no-start"}]
    assert ttrace.perfetto_events(spans, service="s", pid=pid) == \
        jtrace.perfetto_events(spans, service="s", pid=pid)
    tracks = {"b": [(2, 1), (1, 2)], "a": [(0, "x")]}
    assert ttrace.counter_events(tracks, pid=pid + 1) == \
        jtrace.counter_events(tracks, pid=pid + 1)
    inst = [{"t": 1, "name": "n" * 100}, {"t": 2, "name": "m", "lane": "L"},
            {"name": "no-t"}]
    assert ttrace.instant_events(inst, pid=pid + 2) == \
        jtrace.instant_events(inst, pid=pid + 2)
    assert ttrace.to_perfetto(spans, "s", tracks, inst) == \
        jtrace.to_perfetto(spans, "s", tracks, inst)


def test_disabled_tracers_and_trim_match_reference():
    for mod in (jtrace, ttrace):
        off = mod.tracing(None)
        with off.span("x") as sp:
            assert sp is None and off.context() is None
            off.annotate("ignored")
        assert off.spans == [] and not mod.NULL_TRACER.sampled
        assert mod.tracing("path").sampled
    (tj, _), (tt, _) = _program(jtrace), _program(ttrace)
    assert tt.trim(2) == tj.trim(2) == 6
    assert [s.name for s in tt.spans] == [s.name for s in tj.spans]


# --- the search's phase spans -------------------------------------------------

HISTS = {
    "narrow": lambda: jsynth.cas_register_history(300, n_procs=5, seed=42,
                                                  crash_p=0.002),
    "wide": lambda: jsynth.adversarial_wave_history(3, width=10, span=4,
                                                    seed=5, invalid=False),
}


def _phases(spans):
    """(name, parent name) of every span under the caller's root, in
    finish order."""
    by_id = {s.span_id: s for s in spans}
    return [(s.name, by_id[s.parent_id].name if s.parent_id in by_id
             else None) for s in spans]


@pytest.mark.parametrize("which", list(HISTS))
def test_wgl_check_opens_the_reference_spans(which):
    h = HISTS[which]()
    tj, tt = jtrace.Tracer(), ttrace.Tracer()
    with tj.span("check"):
        a = jwgl.check(jmodels.cas_register(), h, tracer=tj)
    with tt.span("check"):
        b = twgl.check(tmodels.cas_register(), to_port(h), device="cpu",
                       tracer=tt)
    assert a["valid?"] == b["valid?"] is True
    pa, pb = _phases(tj.spans), _phases(tt.spans)
    assert pa == pb
    assert pb[0] == ("encode", "check") and pb[-1] == ("check", None)
    chunks = [p for p in pb if p[0] in ("compile", "device-round")]
    assert chunks[0] == ("compile", "check")
    assert len(chunks) == b["util"]["chunks"]
    assert [p for p in pb if p[0] == "host-poll"] == \
        [("host-poll", c) for c, _ in chunks]
    # one trace for the whole check
    assert len({s.trace_id for s in tt.spans}) == 1


def test_untraced_check_records_nothing():
    h = to_port(HISTS["narrow"]())
    assert ttrace.NULL_TRACER.spans == []
    res = twgl.check(tmodels.cas_register(), h, device="cpu")
    assert res["valid?"] is True and ttrace.NULL_TRACER.spans == []
