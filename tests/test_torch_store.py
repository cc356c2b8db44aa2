"""The port's store (`jepsen_tpu_torch.store`) against the JAX package's.

Both packages read and write the same `.jepsen` bytes: a run that either
`store.Writer` wrote loads in the other as the same dict, and the two
writers give byte-identical `test.jepsen` files for one test map. The
block file's lazy reads, `latest` and its symlinks, and the recovery
after a torn trailing write behave as the reference's. Every comparison
is exact.
"""

import json
import os
import shutil
import struct

import pytest

from jepsen_tpu import store as jstore
from jepsen_tpu import synth as jsynth
from jepsen_tpu.store import format as jformat
from jepsen_tpu_torch import ledger as tledger
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch.store import format as tformat

PACKAGES = {"reference": (jstore, jformat), "port": (tstore, tformat)}


def make_test(root, seed=3, n_ops=120, **kw):
    h = jsynth.cas_register_history(n_ops, n_procs=4, seed=seed,
                                    crash_p=0.05)
    return {"name": "demo", "start_time": f"20260729T1200{seed:02d}",
            "store_root": str(root), "nodes": ["n1", "n2"],
            "concurrency": 4, "history": [o.to_dict() for o in h], **kw}


def write_run(mod, test, results=None):
    w = mod.Writer(test)
    try:
        w.save_0(test)
        w.save_1(test)
        if results is not None:
            w.save_2({**test, "results": results})
    finally:
        w.close()
    return w.dir


RESULTS = {"valid?": False, "count": 3,
           "final_paths": [[{"f": "read", "value": 1}]],
           "nested": {"a": [1, 2, {"b": None}]}}


def test_base_dir_is_the_ports_ledger_root():
    assert tstore.BASE_DIR == tledger.BASE_DIR == os.path.join("store",
                                                               "torch")


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference"),
                                           ("port", "port")])
def test_a_stored_run_loads_in_either_package(tmp_path, writer, reader):
    test = make_test(tmp_path / "store")
    write_run(PACKAGES[writer][0], test, RESULTS)
    rmod = PACKAGES[reader][0]
    got = rmod.load_latest(str(tmp_path / "store"))
    want = jstore.load_latest(str(tmp_path / "store"))
    assert got == want
    assert got["history"] == test["history"]
    assert got["results"] == RESULTS
    assert {k: v for k, v in got.items()
            if k not in ("history", "results")} == \
        {k: v for k, v in test.items() if k != "history"}


@pytest.mark.parametrize("phases", ["0", "01", "012"])
def test_writers_give_identical_bytes(tmp_path, phases):
    root = tmp_path / "store"
    blobs = {}
    for name, (mod, _) in PACKAGES.items():
        test = make_test(root, seed=5)
        w = mod.Writer(test)
        try:
            w.save_0(test)
            if "1" in phases:
                w.save_1(test)
            if "2" in phases:
                w.save_2({**test, "results": RESULTS})
        finally:
            w.close()
        files = sorted(os.listdir(w.dir))
        blobs[name] = {f: (root / "demo" / test["start_time"] / f
                           ).read_bytes() for f in files}
        shutil.rmtree(root)
    assert blobs["port"] == blobs["reference"]
    assert "test.jepsen" in blobs["port"]


def test_lazy_read_test(tmp_path):
    p = str(tmp_path / "t.jepsen")
    test = make_test(tmp_path)
    hist = test.pop("history")
    for mod in (jformat, tformat):
        jf = mod.JepsenFile(p, "w")
        jf.write_history(test, ops=hist)
        jf.write_results(test, {"valid?": False, "huge": list(range(1000))})
        jf.close()
    out = {}
    for name, mod in (("reference", jformat), ("port", tformat)):
        jf = mod.JepsenFile(p)
        assert jf.read_valid() is False
        t = jf.read_test()
        assert isinstance(t, mod.LazyTest)
        # history and results are block refs until first access
        assert mod.is_block_ref(dict.__getitem__(t, "history"))
        assert mod.is_block_ref(dict.__getitem__(t, "results"))
        out[name] = (t["history"], t.get("results"), t["name"])
        assert not mod.is_block_ref(dict.__getitem__(t, "history"))
        jf.close()
    assert out["port"] == out["reference"]
    assert out["port"][0] == hist


def test_load_is_lazy_and_tests_lists_runs(tmp_path):
    root = tmp_path / "store"
    for seed in (1, 2):
        write_run(tstore, make_test(root, seed=seed), {"valid?": True})
    assert tstore.tests(str(root)) == jstore.tests(str(root))
    assert sorted(tstore.tests(str(root))["demo"]) == [
        "20260729T120001", "20260729T120002"]
    t = tstore.load("demo", "20260729T120001", str(root))
    assert isinstance(t, tformat.LazyTest)
    assert t["results"] == {"valid?": True}


def test_latest_and_symlinks(tmp_path):
    root = tmp_path / "store"
    dirs = [write_run(tstore, make_test(root, seed=s)) for s in (4, 2)]
    # the last save moved both links, whatever the start times' order
    for link in (root / "latest", root / "demo" / "latest"):
        assert os.path.islink(link)
        assert os.path.realpath(link) == os.path.realpath(dirs[-1])
    assert tstore.latest(str(root)) == jstore.latest(str(root)) \
        == os.path.realpath(dirs[-1])
    # without the root link, the newest start time wins in both
    os.unlink(root / "latest")
    assert tstore.latest(str(root)) == jstore.latest(str(root)) \
        == str(root / "demo" / "20260729T120004")
    assert tstore.latest(str(tmp_path / "nothing")) is None
    assert tstore.load_latest(str(tmp_path / "nothing")) is None


def test_path_and_serializable_test(tmp_path):
    test = make_test(tmp_path, checker=object(), client=object(),
                     tracer=object(), nonserializable_keys=["nodes"])
    assert tstore.path(test, "n1", "log") == jstore.path(test, "n1", "log")
    assert tstore.path({}) == os.path.join(tstore.BASE_DIR, "unnamed",
                                           "unknown")
    p = tstore.path_bang(test, "sub", "x.svg")
    assert os.path.isdir(os.path.dirname(p))
    assert tstore.serializable_test(test) == jstore.serializable_test(test)
    assert "checker" not in tstore.serializable_test(test)
    assert "nodes" not in tstore.serializable_test(test)


def test_history_artifacts_match(tmp_path):
    out = {}
    for name, (mod, _) in PACKAGES.items():
        d = write_run(mod, make_test(tmp_path / name, seed=7),
                      {"valid?": True, "x": [1]})
        out[name] = {f: open(os.path.join(d, f)).read()
                     for f in ("history.jsonl", "history.txt",
                               "results.json")}
    assert out["port"] == out["reference"]
    assert json.loads(out["port"]["results.json"]) == {"valid?": True,
                                                       "x": [1]}


def _torn_tail(p, size):
    with open(p, "ab") as fh:
        fh.write(b"\x00" * 17)


def _pointer_past_eof(p, size):
    with open(p, "r+b") as fh:
        fh.seek(len(tformat.MAGIC))
        fh.write(struct.pack("<Q", size + 64))


def _pointer_into_torn_block(p, size):
    with open(p, "r+b") as fh:
        fh.seek(0, os.SEEK_END)
        fh.write(b"\x40\x00\x00\x00\x00\x00\x00\x00")
        fh.seek(len(tformat.MAGIC))
        fh.write(struct.pack("<Q", size))


@pytest.mark.parametrize("tear", [_torn_tail, _pointer_past_eof,
                                  _pointer_into_torn_block],
                         ids=["torn-tail", "pointer-past-eof",
                              "pointer-into-torn-block"])
def test_recovery_after_a_torn_trailing_write(tmp_path, tear):
    test = make_test(tmp_path)
    hist = test.pop("history")
    got = {}
    for name, mod in (("reference", jformat), ("port", tformat)):
        p = str(tmp_path / f"{name}.jepsen")
        jf = mod.JepsenFile(p, "w")
        jf.write_history(test, ops=hist)
        jf.close()
        tear(p, os.path.getsize(p))
        got[name] = mod.JepsenFile(p).read_test(lazy=False)
    assert got["port"] == got["reference"]
    assert got["port"]["history"] == hist


def test_append_after_a_torn_tail_stays_reachable(tmp_path):
    """Reopening for append truncates the torn tail, so the new save
    point is found by the scan even with the header pointer lost; the
    reference reads the port's repaired file the same way."""
    test = make_test(tmp_path)
    hist = test.pop("history")
    p = str(tmp_path / "t.jepsen")
    jf = tformat.JepsenFile(p, "w")
    jf.write_history(test, ops=hist)
    jf.close()
    _torn_tail(p, os.path.getsize(p))
    jf = tformat.JepsenFile(p, "a")
    jf.write_results(test, {"valid?": True})
    jf.close()
    with open(p, "r+b") as fh:
        fh.seek(len(tformat.MAGIC))
        fh.write(struct.pack("<Q", 0))
    for mod in (tformat, jformat):
        t = mod.JepsenFile(p).read_test(lazy=False)
        assert t["results"] == {"valid?": True}
        assert t["history"] == hist


def test_unreachable_index_raises_in_both(tmp_path):
    test = make_test(tmp_path)
    hist = test.pop("history")
    p = str(tmp_path / "t.jepsen")
    jf = tformat.JepsenFile(p, "w")
    jf.write_history(test, ops=hist)
    jf.close()
    size = os.path.getsize(p)
    with open(p, "r+b") as fh:
        fh.seek(tformat.HEADER_LEN + 12)
        fh.write(b"\xff\xff")           # an early block's payload rots
        fh.seek(len(tformat.MAGIC))
        fh.write(struct.pack("<Q", size + 64))
    for mod in (tformat, jformat):
        with pytest.raises(mod.CorruptFile):
            mod.JepsenFile(p)
    assert os.path.getsize(p) == size
