"""The port's analysis path against the JAX package's: `python -m
jepsen_tpu_torch analyze`, `core.analyze` / `log_results` and the HTML
timeline.

`analyze --device cpu` over a stored valid run exits 0, over an invalid
run 1 (with `linear.svg` beside `results.json`), over a malformed one 2;
an empty store or a name mismatch exits 255 and a bad argument 254, the
reference's codes (`jepsen_tpu/cli.py:44-48`). A run the JAX package
stored is re-analyzed by pointing `--store-root` at it. `core.analyze`
with the same composed checker gives the reference's `valid?` and
per-checker keys, and `timeline.html()` writes the reference's page,
byte for byte. Every comparison is exact.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import core as jcore
from jepsen_tpu import history as jh
from jepsen_tpu import independent as jind
from jepsen_tpu import store as jstore
from jepsen_tpu import synth as jsynth
from jepsen_tpu.checker import timeline as jtimeline
from jepsen_tpu.models import core as jmodels
from jepsen_tpu_torch import __main__ as tmain
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import ledger as tledger
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.checker import linear_report as treport
from jepsen_tpu_torch.checker import timeline as ttimeline
from jepsen_tpu_torch.models import core as tmodels

# intra-op threads only contend with the other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def ops(n_ops=200, seed=3, lie_p=0.0, crash_p=0.02):
    h = jsynth.cas_register_history(n_ops, n_procs=4, seed=seed,
                                    crash_p=crash_p, lie_p=lie_p)
    return [o.to_dict() for o in h]


def store_run(root, history, name="demo", start="20260101T000000",
              writer=tstore):
    test = {"name": name, "start_time": start, "store_root": str(root),
            "history": history}
    w = writer.Writer(test)
    try:
        w.save_0(test)
        w.save_1(test)
    finally:
        w.close()
    return w.dir


def analyze(root, *extra):
    return tmain.main(["analyze", "--store-root", str(root), "--device",
                       "cpu", *extra])


def new_run(root, stored_dir):
    """The run dir the analysis wrote (the latest, not the stored one)."""
    d = tstore.latest(str(root))
    assert d != os.path.realpath(stored_dir)
    return d


def test_cli_over_a_valid_run_exits_0(tmp_path):
    root = tmp_path / "store"
    stored = store_run(root, ops())
    before = Path(stored, "test.jepsen").read_bytes()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "analyze", "--store-root",
         str(root), "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Everything looks good!" in proc.stderr
    d = new_run(root, stored)
    res = json.loads(Path(d, "results.json").read_text())
    assert res["valid?"] is True and res["algorithm"] == "cuda-wgl"
    assert not Path(d, "linear.svg").exists()
    # the analysis reads back from its own test.jepsen
    back = tstore.load_latest(str(root))
    assert back["results"]["valid?"] is True
    assert back["history"] == [o.to_dict() for o in th.History(ops())
                               .index()]
    # the stored run is left as it was
    assert Path(stored, "test.jepsen").read_bytes() == before
    [rec] = tledger.Ledger(str(root)).query(kind="checker")
    assert (rec["name"], rec["verdict"], rec["algorithm"]) == (
        "demo", True, "cuda-wgl")


def test_invalid_run_exits_1_with_the_counterexample(tmp_path):
    root = tmp_path / "store"
    stored = store_run(root, ops(n_ops=300, lie_p=0.02, crash_p=0.0))
    assert analyze(root) == 1
    d = new_run(root, stored)
    res = json.loads(Path(d, "results.json").read_text())
    assert res["valid?"] is False
    assert os.path.realpath(res["counterexample-svg"]) == \
        os.path.join(d, "linear.svg")
    svg = Path(d, "linear.svg").read_text()
    # the file is the render of the stored analysis over the history
    hist = th.History(tstore.load_latest(str(root))["history"])
    assert svg == treport.render(th.strip_nemesis(hist), res)
    assert tstore.load_latest(str(root))["results"]["valid?"] is False


def test_malformed_run_exits_2(tmp_path):
    bad = [{"type": "invoke", "f": "read", "process": 0, "value": None},
           {"type": "invoke", "f": "read", "process": 0, "value": None},
           {"type": "ok", "f": "read", "process": 0, "value": 1}]
    root = tmp_path / "store"
    store_run(root, bad)
    assert analyze(root) == 2
    res = tstore.load_latest(str(root))["results"]
    assert (res["valid?"], res["cause"]) == ("unknown", "malformed-history")


@pytest.mark.parametrize("argv,rc", [
    (["--name", "other"], 255), ([], 255), (["--bogus"], 254),
    (["--device", "nope"], 255)],
    ids=["name-mismatch", "empty-store", "bad-argument", "bad-device"])
def test_refusals_exit_with_the_references_codes(tmp_path, argv, rc):
    root = tmp_path / "store"
    if argv:
        store_run(root, ops(n_ops=40))
    before = sorted(os.listdir(root)) if root.exists() else []
    if argv == ["--device", "nope"]:
        got = tmain.main(["analyze", "--store-root", str(root), *argv])
    else:
        got = analyze(root, *argv)
    assert got == rc
    assert (sorted(os.listdir(root)) if root.exists() else []) == before


def test_without_a_card_the_default_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "store"
    store_run(root, ops(n_ops=40))
    assert tmain.main(["analyze", "--store-root", str(root)]) == 255


def test_the_reference_cli_agrees_on_the_codes(tmp_path):
    """The reference's own `analyze` on the same stored runs: valid 0,
    invalid 1, mismatch 255 (its demo checks with the host oracle)."""
    from jepsen_tpu import __main__ as jmain
    from jepsen_tpu import cli as jcli
    for lie_p, want in ((0.0, 0), (0.02, 1)):
        root = tmp_path / f"lie{lie_p}"
        store_run(root, ops(n_ops=300, lie_p=lie_p, crash_p=0.0),
                  writer=jstore)
        assert jcli.run_cli(jmain.COMMANDS, [
            "analyze", "--store-root", str(root)]) == want
        store_run(root / "port", ops(n_ops=300, lie_p=lie_p, crash_p=0.0))
        assert analyze(root / "port") == want
    assert jcli.run_cli(jmain.COMMANDS, [
        "analyze", "--store-root", str(tmp_path / "lie0.0"), "--name",
        "x"]) == 255


def test_reanalyze_a_run_the_reference_stored(tmp_path):
    root = tmp_path / "jax-store"
    stored = store_run(root, ops(n_ops=300, lie_p=0.02, crash_p=0.0),
                       writer=jstore)
    assert analyze(root) == 1
    d = new_run(root, stored)
    assert Path(d, "linear.svg").exists()
    # the port's analysis loads in the reference
    back = jstore.load_latest(str(root))
    assert back["results"]["valid?"] is False
    assert back["results"]["algorithm"] == "cuda-wgl"


def composed(mod, models, lin_algo, **kw):
    return mod.compose({
        "linear": mod.linearizable(models.cas_register(),
                                   algorithm=lin_algo, **kw),
        "stats": mod.stats(),
        "exceptions": mod.unhandled_exceptions()})


@pytest.mark.parametrize("lie_p", [0.0, 0.02], ids=["valid", "invalid"])
def test_core_analyze_matches_the_reference(tmp_path, lie_p):
    history = ops(n_ops=300, lie_p=lie_p, crash_p=0.03)
    base = {"name": "core", "start_time": "20260101T000000"}
    jt = jcore.analyze({**base, "store_root": str(tmp_path / "j"),
                        "history": history,
                        "checker": composed(jchecker, jmodels, "wgl")})
    tt = tcore.analyze({**base, "store_root": str(tmp_path / "t"),
                        "history": history,
                        "checker": composed(tchecker, tmodels, "wgl")})
    assert isinstance(tt["history"], th.History)
    assert [o.to_dict() for o in tt["history"]] == \
        [o.to_dict() for o in jt["history"]]
    jr, tr = jt["results"], tt["results"]
    assert tr["valid?"] == jr["valid?"] == (lie_p == 0.0)
    assert sorted(tr) == sorted(jr)
    assert tr["stats"] == jr["stats"]
    assert tr["exceptions"]["valid?"] == jr["exceptions"]["valid?"]
    assert tr["linear"]["valid?"] == jr["linear"]["valid?"]
    if lie_p:
        assert Path(tr["linear"]["counterexample-svg"]).read_bytes() == \
            Path(jr["linear"]["counterexample-svg"]).read_bytes()
    # the device search gives the same verdicts under the same compose
    dt = tcore.analyze({**base, "store_root": str(tmp_path / "d"),
                        "history": history,
                        "checker": composed(tchecker, tmodels, "cuda-wgl",
                                            device="cpu")})
    assert dt["results"]["valid?"] == jr["valid?"]
    assert dt["results"]["linear"]["algorithm"] == "cuda-wgl"


def test_core_analyze_defaults_and_faults():
    history = ops(n_ops=40)
    tt = tcore.analyze({"history": history})
    jt = jcore.analyze({"history": history})
    assert tt["results"] == jt["results"] == {"valid?": True}

    class Boom(tchecker.Checker):
        def check(self, test, history, opts=None):
            raise RuntimeError("boom")

    res = tcore.analyze({"history": history, "checker": Boom()})["results"]
    assert res["valid?"] == "unknown"
    assert res["fault"] == {"type": "RuntimeError", "error": "boom",
                            "stage": "checker/Boom"}


@pytest.mark.parametrize("valid,text", [
    (True, "Everything looks good!"), (False, "Analysis invalid!"),
    ("unknown", "Errors occurred during analysis")])
def test_log_results_matches(caplog, valid, text):
    test = {"results": {"valid?": valid}}
    with caplog.at_level(logging.INFO):
        assert tcore.log_results(test) is test
        jcore.log_results(test)
    port, ref = [r.getMessage() for r in caplog.records[-2:]]
    assert port == ref and text in port


def test_core_analyze_writes_the_fanouts_key_artifacts(tmp_path):
    """With a store_dir, each key's results.json lands under
    independent/<k>/ in both packages."""
    from jepsen_tpu import synth as js
    from jepsen_tpu_torch import synth as ts
    out = {}
    for name, (hmod, smod, imod, cmod, mmod, core) in {
            "reference": (jh, js, jind, jchecker, jmodels, jcore),
            "port": (th, ts, tind, tchecker, tmodels, tcore)}.items():
        hist = hmod.History()
        for k in range(3):
            for op in smod.cas_register_history(
                    20, n_procs=2, seed=k, lie_p=0.2 if k == 1 else 0.0):
                hist.append(op.with_(process=(op.process, k),
                                     value=imod.tuple_(k, op.value)))
        d = str(tmp_path / name)
        test = core.analyze({"name": "fan", "store_dir": d,
                             "history": hist,
                             "checker": imod.checker(cmod.linearizable(
                                 mmod.cas_register(), algorithm="wgl"))})
        out[name] = (test["results"]["failures"], sorted(
            os.path.relpath(os.path.join(p, f), d)
            for p, _, fs in os.walk(d) for f in fs))
    assert out["port"] == out["reference"]
    assert out["port"][0] == [1]
    assert "independent/2/results.json" in out["port"][1]


def timeline_history(pkg, n_ops=60, seed=4):
    h = (jh if pkg == "reference" else th)
    hist = h.History()
    src = jsynth.cas_register_history(n_ops, n_procs=3, seed=seed,
                                      crash_p=0.1)
    for i, o in enumerate(src):
        if i in (10, 30):
            hist.append(h.invoke("nemesis", "start", None, time=o.time))
            hist.append(h.info("nemesis", "start", "partitioned",
                               time=o.time))
        if i == 40:
            hist.append(h.invoke("nemesis", "stop", None, time=o.time))
            hist.append(h.info("nemesis", "stop", "healed", time=o.time))
        hist.append(h.Op.from_dict(o.to_dict()))
    return hist.index()


@pytest.mark.parametrize("key", [None, 7])
def test_timeline_page_matches(key):
    test = {"name": "tl"}
    got = ttimeline.render(test, timeline_history("port"), key)
    assert got == jtimeline.render(test, timeline_history("reference"), key)
    assert "nemesis-band" in got


def test_timeline_truncates_like_the_reference(monkeypatch):
    monkeypatch.setattr(ttimeline, "OP_LIMIT", 25)
    monkeypatch.setattr(jtimeline, "OP_LIMIT", 25)
    test = {"name": "tl"}
    got = ttimeline.render(test, timeline_history("port"))
    assert got == jtimeline.render(test, timeline_history("reference"))
    assert "truncated: showing 25 of" in got


def test_timeline_checker_writes_the_page(tmp_path):
    out = {}
    for name, mod, pkg in (("reference", jtimeline, "reference"),
                           ("port", ttimeline, "port")):
        test = {"name": "tl", "start_time": "20260101T000000",
                "store_root": str(tmp_path / name)}
        res = mod.html().check(test, timeline_history(pkg),
                               {"subdirectory": ["independent", "3"],
                                "history_key": 3})
        assert res == {"valid?": True}
        out[name] = Path(tmp_path, name, "tl", "20260101T000000",
                         "independent", "3", "timeline.html").read_bytes()
    assert out["port"] == out["reference"]
    assert isinstance(ttimeline.html(), tchecker.Checker)
