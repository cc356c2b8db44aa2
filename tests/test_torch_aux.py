"""The port's small utilities (`jepsen_tpu_torch/codec.py`, `report.py`,
`repl.py`), held against the JAX package: the twins of the codec, report
and repl tests of `tests/test_aux.py`, and parity cases: the codec's
bytes, its decodes and its rejections equal to the reference's, a report
file equal to the reference's, and `repl.latest_test` reading the port's
own store root by default.
"""

import os

import pytest

from jepsen_tpu import codec as ref_codec
from jepsen_tpu import report as ref_report
from jepsen_tpu_torch import codec, repl, report, store


# -- the twins of tests/test_aux.py -------------------------------------------

def test_codec_roundtrip():
    for o in (None, 0, "x", [1, 2, {"a": True}], {"valid?": "unknown"}):
        assert codec.decode(codec.encode(o)) == o
    assert codec.encode(None) == b""
    assert codec.decode(b"") is None
    assert codec.decode(None) is None


def test_codec_deterministic():
    assert codec.encode({"b": 1, "a": 2}) == codec.encode({"a": 2, "b": 1})


def test_codec_rejects_nonstr_dict_keys():
    # json.dumps would silently coerce 1 -> "1", breaking the
    # decode(encode(o)) == o contract; the codec must raise instead.
    for bad in ({1: "a"}, {"ok": {2: "b"}}, [{"x": 1}, {(): "t"}]):
        with pytest.raises(TypeError):
            codec.encode(bad)


def test_report_to(tmp_path, capsys):
    path = str(tmp_path / "sub" / "set.txt")
    with report.to(path):
        print("lost:", [1, 2])
    assert open(path).read() == "lost: [1, 2]\n"
    # the announcement goes to the real stdout, not the report
    assert f"Report written to {path}" in capsys.readouterr().out


def saved_test(root: str, name: str = "repl-t") -> None:
    t = {"name": name, "nodes": [],
         "start_time": "20260730T000000",
         "store_root": root}
    w = store.Writer(t)
    w.save_0(t)
    t["results"] = {"valid?": True}
    w.save_1(t)
    w.save_2(t)
    w.close()


def test_repl_latest_test(tmp_path):
    saved_test(str(tmp_path))
    loaded = repl.latest_test(str(tmp_path))
    assert loaded["name"] == "repl-t"
    assert loaded["results"]["valid?"] is True


# -- parity with the reference ------------------------------------------------

VALUES = (None, 0, -3, 2**40, 2.5, "x", "", True, [], {},
          [1, 2, {"a": True}], {"valid?": "unknown", "b": [None, 1.5]},
          {"nested": {"z": 1, "a": [{"k": "v"}]}}, (1, 2))


@pytest.mark.parametrize("o", VALUES, ids=repr)
def test_codec_bytes_match_reference(o):
    b = codec.encode(o)
    assert b == ref_codec.encode(o)
    assert codec.decode(b) == ref_codec.decode(b)


@pytest.mark.parametrize("bad", ({1: "a"}, {"ok": {2: "b"}},
                                 [{"x": 1}, {(): "t"}], {"s": {1, 2}}),
                         ids=repr)
def test_codec_rejections_match_reference(bad):
    with pytest.raises(TypeError):
        ref_codec.encode(bad)
    with pytest.raises(TypeError):
        codec.encode(bad)


def test_report_file_matches_reference(tmp_path, capsys):
    for name, mod in (("port", report), ("ref", ref_report)):
        with mod.to(str(tmp_path / name / "r.txt")):
            print("lost:", [1, 2])
            mod.pprint({"valid?": False, "lost": list(range(30))})
    assert (tmp_path / "port" / "r.txt").read_text() == \
        (tmp_path / "ref" / "r.txt").read_text()
    assert report.__all__ == ref_report.__all__


def test_repl_defaults_to_the_ports_store_root(tmp_path, monkeypatch):
    assert repl.latest_test.__defaults__ == (os.path.join("store", "torch"),)
    monkeypatch.chdir(tmp_path)
    assert repl.latest_test() is None
    saved_test(os.path.join("store", "torch"), name="port-root")
    assert repl.latest_test()["name"] == "port-root"
