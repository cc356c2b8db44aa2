"""The port's EDN reader (`jepsen_tpu_torch/edn.py`) and
`History.from_edn`, held against the JAX package: the twins of
`tests/test_edn.py` (the reader itself, then histories written in the
reference's own EDN shapes, checker_test.clj's hand-written vectors and
store.clj's one-op-per-line history.edn, replayed through both checker
planes, here `"cuda-wgl"` and the Elle closure on the CPU's plain
versions), and parity cases: `edn.loads` on every form of the twins,
`loads_all` and `load_history` equal to the reference's, form for form
and op for op.
"""

import pytest

from jepsen_tpu import edn as ref_edn
from jepsen_tpu_torch import checker, edn
from jepsen_tpu_torch.history import History, invoke, ok
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.ops import wgl_ref


# -- reader -------------------------------------------------------------------

def test_atoms():
    assert edn.loads("nil") is None
    assert edn.loads("true") is True
    assert edn.loads("false") is False
    assert edn.loads("42") == 42
    assert edn.loads("-7") == -7
    assert edn.loads("3.5") == 3.5
    assert edn.loads("1e3") == 1000.0
    assert edn.loads("123N") == 123
    assert edn.loads("1.5M") == 1.5
    assert edn.loads(":invoke") == "invoke"
    assert edn.loads(":jepsen.checker/foo") == "jepsen.checker/foo"
    assert edn.loads("some-symbol") == "some-symbol"
    assert edn.loads('"hi\\nthere"') == "hi\nthere"
    assert edn.loads("\\a") == "a"
    assert edn.loads("\\newline") == "\n"


def test_collections():
    assert edn.loads("[1 2 3]") == [1, 2, 3]
    assert edn.loads("(1 2)") == [1, 2]
    assert edn.loads("{:a 1, :b [2 3]}") == {"a": 1, "b": [2, 3]}
    assert edn.loads("#{1 2 3}") == {1, 2, 3}
    # nested map keys freeze to hashable forms
    assert edn.loads("{[1 2] :x}") == {(1, 2): "x"}


def test_dispatch_forms():
    assert edn.loads('#inst "2024-01-01T00:00:00Z"') == \
        "2024-01-01T00:00:00Z"
    # record tags yield their map (op records in new-jepsen histories)
    assert edn.loads(
        "#jepsen.history.Op{:type :ok, :f :read, :value 3}") == \
        {"type": "ok", "f": "read", "value": 3}
    assert edn.loads("[1 #_ 2 3]") == [1, 3]
    assert edn.loads("[1 ; comment\n 2]") == [1, 2]


BAD_FORMS = ("[1 2", "{:a}", '"unterminated', "]", "")


def test_errors():
    for bad in BAD_FORMS:
        with pytest.raises(edn.EdnError):
            edn.loads(bad)


# -- history ingest -----------------------------------------------------------

REGISTER_EDN = """
[{:process 0, :type :invoke, :f :write, :value 1, :time 0}
 {:process 0, :type :ok,     :f :write, :value 1, :time 1}
 {:process 1, :type :invoke, :f :read,  :value nil, :time 2}
 {:process 1, :type :ok,     :f :read,  :value 1, :time 3}
 {:process 0, :type :invoke, :f :cas,   :value [1 2], :time 4}
 {:process 0, :type :ok,     :f :cas,   :value [1 2], :time 5}]
"""

BAD_REGISTER_EDN = """
{:process 0, :type :invoke, :f :write, :value 1, :time 0, :index 0}
{:process 0, :type :ok,     :f :write, :value 1, :time 1, :index 1}
{:process 1, :type :invoke, :f :read,  :value nil, :time 2, :index 2}
{:process 1, :type :ok,     :f :read,  :value 9, :time 3, :index 3}
"""


def cuda_wgl():
    return checker.linearizable(cas_register(), algorithm="cuda-wgl",
                                device="cpu")


def test_vector_history_through_both_wgl_planes(tmp_path):
    p = tmp_path / "history.edn"
    p.write_text(REGISTER_EDN)
    h = History.from_edn(str(p)).index()
    assert len(h) == 6
    assert h[0].f == "write" and h[0].type == "invoke"
    assert h[4].value == [1, 2]
    r_dev = cuda_wgl().check({}, h, {})
    r_ora = wgl_ref.check(cas_register(), h)
    assert r_dev["valid?"] is True and r_ora["valid?"] is True


def test_line_format_history_invalid_verdict_parity(tmp_path):
    # store.clj shape: one op map per prn line, with :index/:time
    p = tmp_path / "history.edn"
    p.write_text(BAD_REGISTER_EDN)
    h = History.from_edn(str(p)).index()
    r_dev = cuda_wgl().check({}, h, {})
    r_ora = wgl_ref.check(cas_register(), h)
    assert r_dev["valid?"] is False and r_ora["valid?"] is False


NATIVE_EDN = (
    "[{:process 0, :type :invoke, :f :write, :value 1, :time 0}"
    " {:process 0, :type :ok, :f :write, :value 1, :time 1}"
    " {:process 1, :type :invoke, :f :read, :value nil, :time 2}"
    " {:process 1, :type :ok, :f :read, :value 1, :time 3}]")


def test_edn_equals_native_history():
    """The EDN replay and the natively built history are the same ops,
    so every downstream consumer sees identical input."""
    native = History([
        invoke(0, "write", 1, time=0), ok(0, "write", 1, time=1),
        invoke(1, "read", None, time=2), ok(1, "read", 1, time=3),
    ]).index()
    replay = edn.load_history(NATIVE_EDN).index()
    assert [o.to_dict() for o in replay] == [o.to_dict() for o in native]


ELLE_EDN = """
{:process 0, :type :invoke, :f :txn, :value [[:append :x 1]], :time 0}
{:process 0, :type :ok,     :f :txn, :value [[:append :x 1]], :time 1}
{:process 1, :type :invoke, :f :txn, :value [[:r :x nil] [:append :y 1]], :time 2}
{:process 1, :type :ok,     :f :txn, :value [[:r :x [1]] [:append :y 1]], :time 3}
{:process 2, :type :invoke, :f :txn, :value [[:r :y nil] [:r :x nil]], :time 4}
{:process 2, :type :ok,     :f :txn, :value [[:r :y [1]] [:r :x []]], :time 5}
"""


def test_elle_plane_on_edn_history(tmp_path):
    """The reference's list-append value shape ([[:append :x 1]] micro
    ops) replays straight into the Elle plane: keywords become the
    string mnemonics elle/append.py speaks, and the G-single anomaly
    in this fixture is found on both engines."""
    from jepsen_tpu_torch.elle import append

    p = tmp_path / "history.edn"
    p.write_text(ELLE_EDN)
    h = History.from_edn(str(p)).index()
    r_host = append.check(h, additional_graphs=("realtime",),
                          cycle_backend="host")
    r_dev = append.check(h, additional_graphs=("realtime",),
                         cycle_backend="cuda", device="cpu")
    assert r_host["valid?"] == r_dev["valid?"] is False
    assert r_host["anomaly-types"] == r_dev["anomaly-types"]


# -- parity with the reference ------------------------------------------------

FORMS = (
    "nil", "true", "false", "42", "-7", "3.5", "1e3", "123N", "1.5M",
    ":invoke", ":jepsen.checker/foo", "some-symbol", '"hi\\nthere"', "\\a",
    "\\newline", "[1 2 3]", "(1 2)", "{:a 1, :b [2 3]}", "#{1 2 3}",
    "{[1 2] :x}", '#inst "2024-01-01T00:00:00Z"',
    "#jepsen.history.Op{:type :ok, :f :read, :value 3}", "[1 #_ 2 3]",
    "[1 ; comment\n 2]", "0x1F", "-0o17", "22/7", '#uuid "0-1"',
    "{:a #{[1 2] {:b nil}}}", "\\space", "[:r :x [1 2]]", "1.0e-3",
    NATIVE_EDN, REGISTER_EDN)


@pytest.mark.parametrize("form", FORMS)
def test_loads_matches_reference(form):
    got, want = edn.loads(form), ref_edn.loads(form)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("form", BAD_FORMS + ("{:a 1 :b}", "#{", "1/0"))
def test_errors_match_reference(form):
    with pytest.raises(ref_edn.EdnError) as ref_err:
        ref_edn.loads(form)
    with pytest.raises(edn.EdnError) as err:
        edn.loads(form)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("text", (REGISTER_EDN, BAD_REGISTER_EDN, ELLE_EDN,
                                  NATIVE_EDN, "1 #_ 2 [3] #_ 4"))
def test_loads_all_matches_reference(text):
    assert edn.loads_all(text) == ref_edn.loads_all(text)


@pytest.mark.parametrize("text", (REGISTER_EDN, BAD_REGISTER_EDN, ELLE_EDN,
                                  NATIVE_EDN))
def test_load_history_matches_reference(text):
    got = [o.to_dict() for o in edn.load_history(text).index()]
    want = [o.to_dict() for o in ref_edn.load_history(text).index()]
    assert got == want and got


def test_tagged_op_records_load_as_ops():
    """jepsen.history.Op records, one a line (the newer Jepsen's
    history.edn), load as the same ops in both packages."""
    text = "\n".join(
        "#jepsen.history.Op{:index %d, :time %d, :type %s, :process 0, "
        ":f :write, :value %d}" % (i, 10 * i, t, i // 2)
        for i, t in enumerate((":invoke", ":ok", ":invoke", ":info")))
    got = edn.load_history(text)
    assert [o.type for o in got] == ["invoke", "ok", "invoke", "info"]
    assert [o.to_dict() for o in got] == \
        [o.to_dict() for o in ref_edn.load_history(text)]


def test_non_op_form_rejected_as_reference():
    for text in ("[1 2]", "{:type :ok} 3"):
        with pytest.raises(ref_edn.EdnError):
            ref_edn.load_history(text)
        with pytest.raises(edn.EdnError):
            edn.load_history(text)
