"""The port's history type (`jepsen_tpu_torch/history.py`), held against
the JAX package: the twins of `tests/test_history.py`, and parity cases on
the same ops: `complete` (knossos' read-value fill and `fails?` marks),
`from_jsonl`, `from_edn`, and the views (`map`, `invocations`, `oks`,
`client_ops`), each equal to the reference's, op for op.
"""

import pytest

from jepsen_tpu import history as ref_h
from jepsen_tpu_torch.history import History, Op, fail, info, invoke, ok


# -- the twins of tests/test_history.py ---------------------------------------

def test_op_predicates():
    assert invoke(0, "read", None).is_invoke
    assert ok(0, "read", 1).is_ok
    assert fail(0, "write", 1).is_fail
    assert info(0, "write", 1).is_info
    assert not ok(0, "read", 1).is_invoke


def test_index():
    h = History([invoke(0, "write", 1), ok(0, "write", 1)]).index()
    assert [op.index for op in h] == [0, 1]


def test_pairs():
    h = History([
        invoke(0, "write", 1),
        invoke(1, "read", None),
        ok(0, "write", 1),
        ok(1, "read", 1),
    ])
    pairs = h.pairs()
    assert len(pairs) == 2
    assert pairs[0][0].process == 0 and pairs[0][1].type == "ok"
    assert pairs[1][0].process == 1 and pairs[1][1].value == 1


def test_pairs_incomplete():
    h = History([invoke(0, "write", 1)])
    pairs = h.pairs()
    assert pairs == [(h[0], None)]


def test_complete_fills_read_values():
    h = History([
        invoke(0, "read", None),
        ok(0, "read", 42),
    ]).complete()
    assert h[0].value == 42
    assert h[0].index == 0 and h[1].index == 1


def test_jsonl_roundtrip(tmp_path):
    h = History([
        invoke(0, "write", 1, time=10),
        ok(0, "write", 1, time=20),
        info(1, "cas", [1, 2], time=30),
    ]).index()
    p = tmp_path / "history.jsonl"
    h.to_jsonl(str(p))
    h2 = History.from_jsonl(str(p))
    assert len(h2) == 3
    assert h2[2].type == "info"
    assert h2[2].value == [1, 2]
    assert h2[0].time == 10


def test_columns():
    h = History([invoke(0, "write", 1, time=5),
                 ok(0, "write", 1, time=9)]).index()
    types, fs, procs, times, idxs = h.columns()
    assert list(types) == [0, 1]
    assert list(fs) == ["write", "write"]
    assert list(times) == [5, 9]


def test_from_dict_extra_fields():
    op = Op.from_dict({"type": "ok", "f": "read", "process": 3, "value": 7,
                       "node": "n1"})
    assert op.extra == {"node": "n1"}
    assert op.to_dict()["node"] == "n1"


# -- parity with the reference, on the same ops -------------------------------

# reads filled from their :ok, a failed cas marked, a crashed write left
# open, a nemesis op, and an op with extra fields
OPS = [
    {"type": "invoke", "f": "write", "process": 0, "value": 1, "time": 0},
    {"type": "invoke", "f": "read", "process": 1, "value": None, "time": 1},
    {"type": "ok", "f": "write", "process": 0, "value": 1, "time": 2},
    {"type": "ok", "f": "read", "process": 1, "value": 1, "time": 3},
    {"type": "invoke", "f": "cas", "process": 0, "value": [2, 3],
     "time": 4},
    {"type": "info", "f": "start", "process": "nemesis", "value": None,
     "time": 5},
    {"type": "fail", "f": "cas", "process": 0, "value": [2, 3], "time": 6},
    {"type": "invoke", "f": "write", "process": 2, "value": 4, "time": 7,
     "node": "n2"},
    {"type": "invoke", "f": "read", "process": 1, "value": None, "time": 8},
    {"type": "fail", "f": "read", "process": 1, "value": None, "time": 9},
    {"type": "info", "f": "write", "process": 2, "value": 4, "time": 10},
]


def dicts(h) -> list:
    return [op.to_dict() for op in h]


def both():
    return History(OPS), ref_h.History(OPS)


def test_complete_matches_reference():
    port, ref = both()
    got = port.complete()
    assert dicts(got) == dicts(ref.complete())
    assert got[1].value == 1
    assert got[4].extra == {"fails?": True}
    assert got[8].extra == {"fails?": True}
    assert got[7].extra == {"node": "n2"}


@pytest.mark.parametrize("view", ("invocations", "oks", "client_ops"))
def test_views_match_reference(view):
    port, ref = both()
    assert dicts(getattr(port, view)) == dicts(getattr(ref, view))
    assert len(getattr(port, view)) > 0


def test_map_matches_reference():
    port, ref = both()

    def bump(op):
        return op.with_(time=op.time + 100)

    assert dicts(port.map(bump)) == dicts(ref.map(bump))
    assert isinstance(port.map(bump), History)


def test_from_jsonl_reads_the_references_file(tmp_path):
    """A history the JAX package wrote reads back into the port's type
    as the same ops, and the port's file into the reference's."""
    port, ref = both()
    a, b = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    ref.index().to_jsonl(str(a))
    port.index().to_jsonl(str(b))
    assert a.read_text() == b.read_text()
    assert dicts(History.from_jsonl(str(a))) == \
        dicts(ref_h.History.from_jsonl(str(a)))
    assert dicts(ref_h.History.from_jsonl(str(b))) == dicts(port.index())


def test_from_edn_matches_reference(tmp_path):
    p = tmp_path / "history.edn"
    p.write_text(
        "{:process 0, :type :invoke, :f :write, :value 1, :time 0}\n"
        "{:process 0, :type :ok, :f :write, :value 1, :time 1}\n"
        "{:process :nemesis, :type :info, :f :start, :value nil}\n"
        "{:process 1, :type :invoke, :f :cas, :value [1 2], :time 2}\n")
    got = History.from_edn(str(p))
    assert isinstance(got, History)
    assert dicts(got) == dicts(ref_h.History.from_edn(str(p)))
    assert got[2].process == "nemesis" and got[3].value == [1, 2]
