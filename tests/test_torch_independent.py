"""Per-key fan-out (`independent`) of the PyTorch/CUDA port against the
JAX package's.

The same multi-key history is built in both packages (interleaved
per-key cas-register histories with tuple values and nemesis markers).
`history_keys`/`subhistory` must agree; `checker(...)` over the oracle
must give the JAX package's per-key verdicts; `cuda_checker(device=
"cpu")` must give the JAX `tpu_checker`'s verdicts, failures and per-key
configs_explored on a one-device mesh; a malformed history must be
gated the same way; and without a card `cuda_checker()` must raise.
"""

import json
import random

import pytest
import jax
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.parallel import default_mesh
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import fleet as tfleet
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch.models import core as tmodels

# intra-op threads only contend with the other test workers
torch.set_num_threads(1)

PKGS = {"jax": (jh, jsynth, jind), "port": (th, tsynth, tind)}


def multikey_history(pkg, n_keys=4, ops_per_key=24, bad_keys=(),
                     n_procs=3):
    """Interleave per-key cas-register histories into one tuple-valued
    history, plus nemesis marker ops every subhistory keeps."""
    h, synth, ind = PKGS[pkg]
    rng = random.Random(7)
    hist = h.History()
    hist.append(h.info("nemesis", "start-partition", None))
    streams = []
    for k in range(n_keys):
        sub = synth.cas_register_history(
            ops_per_key, n_procs=n_procs, seed=100 + k,
            lie_p=0.2 if k in bad_keys else 0.0)
        streams.append((k, list(sub)))
    while any(ops for _, ops in streams):
        k, ops = rng.choice([s for s in streams if s[1]])
        op = ops.pop(0)
        hist.append(op.with_(process=(op.process, k),
                             value=ind.tuple_(k, op.value)))
    hist.append(h.info("nemesis", "stop-partition", None))
    return hist.index()


def _ops(hist):
    return [(o.type, o.f, o.process, repr(o.value), o.index) for o in hist]


def test_history_keys_and_subhistory_match_jax():
    j = multikey_history("jax", n_keys=3)
    t = multikey_history("port", n_keys=3)
    assert _ops(j) == _ops(t)
    assert tind.history_keys(t) == jind.history_keys(j)
    assert sorted(tind.history_keys(t)) == [0, 1, 2]
    for k in tind.history_keys(t):
        assert _ops(tind.subhistory(k, t)) == _ops(jind.subhistory(k, j))
    ks = tind.history_keys(t)
    assert [_ops(s) for s in tind.subhistories(t, ks)] == \
        [_ops(jind.subhistory(k, j)) for k in ks]
    sub = tind.subhistory(0, t)
    assert sub[0].f == "start-partition" and sub[-1].f == "stop-partition"
    assert not any(tind.is_tuple(o.value) for o in sub)
    assert list(tind.tuple_(1, 2)) == [1, 2] and repr(tind.tuple_(1, 2)) \
        == repr(jind.tuple_(1, 2))


def test_independent_checker_matches_jax():
    j = multikey_history("jax", n_keys=4, bad_keys=(2,))
    t = multikey_history("port", n_keys=4, bad_keys=(2,))
    jr = jind.checker(jchecker.linearizable(
        jmodels.cas_register(), algorithm="wgl")).check({}, j, {})
    tr = tind.checker(tchecker.linearizable(
        tmodels.cas_register(), algorithm="wgl")).check({}, t, {})
    assert tr["valid?"] is jr["valid?"] is False
    assert tr["failures"] == jr["failures"] == [2]
    for k in jr["results"]:
        assert tr["results"][k]["valid?"] == jr["results"][k]["valid?"]
    assert tr["util"]["fleet"]["keys"] == 4
    assert tr["results"][0]["shard"]["device"] == "host"


def test_independent_checker_captures_a_key_exception():
    class Boom:
        def check(self, test, history, opts):
            raise RuntimeError("boom")

    res = tind.checker(Boom()).check({}, multikey_history("port", 2), {})
    assert res["valid?"] == "unknown"
    assert res["results"][0]["fault"]["type"] == "RuntimeError"
    # "unknown" is not a failure (the reference's `(not valid?)`)
    assert res["failures"] == []


@pytest.mark.parametrize("n_keys,bad", [(5, (1, 3)), (3, (0,))])
def test_cuda_checker_matches_jax_tpu_checker(n_keys, bad):
    """On the CPU the port's "auto" takes the lane-batched path for
    these short keys; the JAX checker on a one-device mesh pins its
    vmap path too."""
    j = multikey_history("jax", n_keys=n_keys, bad_keys=bad)
    t = multikey_history("port", n_keys=n_keys, bad_keys=bad)
    jr = jind.tpu_checker(jmodels.cas_register(),
                          mesh=default_mesh(n_devices=1)).check({}, j, {})
    tr = tind.cuda_checker(tmodels.cas_register(),
                           device="cpu").check({}, t, {})
    assert tr["valid?"] == jr["valid?"] is False
    assert sorted(tr["failures"]) == sorted(jr["failures"]) == list(bad)
    for k in jind.history_keys(j):
        a, b = jr["results"][k], tr["results"][k]
        assert a["valid?"] == b["valid?"], k
        assert a.get("configs_explored") == b.get("configs_explored"), k
        assert b["shard"]["key"] == str(k)
    assert tr["util"]["fleet"]["keys"] == n_keys


def test_cuda_checker_gates_malformed_history():
    def double_invoke(h, ind):
        hist = h.History([
            h.invoke(0, "write", ind.tuple_(0, 1)),
            h.invoke(0, "write", ind.tuple_(0, 2)),
            h.ok(0, "write", ind.tuple_(0, 1))])
        return hist.index()

    jr = jind.tpu_checker(jmodels.cas_register(),
                          mesh=default_mesh(n_devices=1)).check(
        {}, double_invoke(jh, jind), {})
    tr = tind.cuda_checker(tmodels.cas_register(), device="cpu").check(
        {}, double_invoke(th, tind), {})
    assert tr["valid?"] == jr["valid?"] == "unknown"
    assert tr["cause"] == jr["cause"] == "malformed-history"
    assert [a["rule"] for a in tr["anomalies"]] == \
        [a["rule"] for a in jr["anomalies"]]
    assert tr["results"] == {} and tr["failures"] == []
    assert tr["analyzer"]["where"] == "independent.cuda"


def test_cuda_checker_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tind.cuda_checker(tmodels.cas_register()).check(
            {}, multikey_history("port", 2), {})


def test_key_artifacts_are_written(tmp_path):
    t = multikey_history("port", n_keys=2)
    res = tind.cuda_checker(tmodels.cas_register(), device="cpu").check(
        {"store_dir": str(tmp_path)}, t, {})
    for k in (0, 1):
        d = tmp_path / "independent" / str(k)
        saved = json.loads((d / "results.json").read_text())
        assert saved["valid?"] == res["results"][k]["valid?"] is True
        lines = (d / "history.jsonl").read_text().splitlines()
        assert len(lines) == len(tind.subhistory(k, t))


def test_fleet_helpers_match_jax():
    from jepsen_tpu import fleet as jfleet
    shards = [{"key_index": i, "device": f"d{i % 2}", "engine": "device",
               "t0": 1.0 + i, "wall_s": 0.5 + (i % 2) * 2.0 * i,
               "valid?": True, "op_count": 10} for i in range(6)]
    shards.append(None)
    assert tfleet.summarize(shards) == jfleet.summarize(shards)
    assert tfleet.rebucket_hint(shards[:6]) == \
        jfleet.rebucket_hint(shards[:6])
    pending = {"a": [(3.0, 1), (1.0, 2), (5.0, 3)], "b": []}
    walls = {"a": 9.0, "b": 2.0}
    assert tfleet.steal_plan(pending, walls) == \
        jfleet.steal_plan(pending, walls)
    hint = {"keys": list(range(40)), "from": "a"}
    assert tfleet.compact_hint(hint) == jfleet.compact_hint(hint)
    try:
        raise ValueError("x")
    except ValueError as e:
        a = tfleet.fault_event(e, device="d0", key_index=3)
        b = jfleet.fault_event(e, device="d0", key_index=3)
    assert {k: a[k] for k in a if k != "traceback"} == \
        {k: b[k] for k in b if k != "traceback"}


def test_merge_valid_matches_jax():
    cases = [[], [True], [True, "unknown"], [True, False, "unknown"],
             [None, True], ["unknown", False]]
    for c in cases:
        assert tchecker.merge_valid(c) == jchecker.merge_valid(c), c
