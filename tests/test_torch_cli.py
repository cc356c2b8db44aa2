"""The port's `cli` option language and its `test` / `test-all`
commands against the JAX package's.

For a table of argv, the port's `parse_opts` + `test_opt_fn` must give
the reference's options and errors over the same spec. Then the demo
commands (`python -m jepsen_tpu_torch test` / `test-all`) run in this
process with `--device cpu`: exit 0 on a valid run, 254 on bad
arguments, 255 without a card when `--device cpu` is not given
(`torch.cuda.is_available` stubbed to False), and `test-all --test-count
2` prints "2 successes".
"""

import pytest
import torch

from jepsen_tpu import cli as ref_cli
from jepsen_tpu.__main__ import DEMO_OPTS as REF_DEMO_OPTS
from jepsen_tpu_torch import cli as port_cli
from jepsen_tpu_torch import __main__ as port_main
from jepsen_tpu_torch import ledger, store

ARGV = [
    [],
    ["-n", "a", "-n", "b"],
    ["--time-limit=30", "--no-ssh", "--username", "admin"],
    ["--bogus"],
    ["--concurrency", "abc"],
    ["--time-limit", "-3"],
    ["foo", "--time-limit", "9", "bar"],
    ["--no-ssh", "--concurrency", "2n", "--leave-db-running"],
    ["--nodes", "y1,y2", "--concurrency", "3n"],
    ["-n", "z1", "--nodes", "y1"],
    ["--concurrency", "7", "--test-count", "3", "--logging-json"],
    ["--password", "pw", "--ssh-private-key", "/k", "--strict-host-key-checking"],
    ["--time-limit"],
    ["--", "--time-limit", "5"],
    ["--concurrency", "12n", "-n", "a", "-n", "b", "-n", "c"],
    ["--rate", "1000", "--name", "x", "--store-root", "/s"],
    ["--rate", "fast"],
]


def _parse(mod, argv, spec):
    p = mod.parse_opts(argv, spec)
    out = {"options": dict(p.options), "arguments": list(p.arguments),
           "errors": list(p.errors), "summary": p.summary}
    if not p.errors:
        try:
            out["after"] = dict(mod.test_opt_fn(p).options)
        except Exception as e:  # noqa: BLE001
            out["after"] = ("raises", type(e).__name__, str(e))
    return out


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: " ".join(a) or "-")
def test_options_and_errors_match_reference(argv):
    ref_spec = ref_cli.merge_opt_specs(ref_cli.TEST_OPT_SPEC, REF_DEMO_OPTS)
    port_spec = port_cli.merge_opt_specs(
        port_cli.TEST_OPT_SPEC,
        [o for o in port_main.DEMO_OPTS if o.name != "device"])
    want = _parse(ref_cli, argv, ref_spec)
    got = _parse(port_cli, argv, port_spec)
    # the one deliberate divergence of the demo's spec: its store root
    for d in (want["options"], want.get("after") or {}):
        if isinstance(d, dict) and d.get("store_root") == "store":
            d["store_root"] = ledger.BASE_DIR
    want["summary"] = want["summary"].replace(
        "(default: store)", f"(default: {ledger.BASE_DIR})").replace(
        "Approximate ops/sec per worker",
        "Approximate ops/sec, all workers together")
    assert got == want


def test_nodes_file_matches_reference(tmp_path):
    f = tmp_path / "nodes.txt"
    f.write_text("x1\nx2\n")
    argv = ["--nodes", "y1,y2", "--nodes-file", str(f)]
    want = _parse(ref_cli, argv, ref_cli.TEST_OPT_SPEC)
    got = _parse(port_cli, argv, port_cli.TEST_OPT_SPEC)
    assert got == want
    assert got["after"]["nodes"] == ["x1", "x2", "y1", "y2"]


def test_concurrency_sugar_and_exit_helpers_match_reference():
    for c, nodes in (("3n", ["a", "b"]), ("7", ["a"]), ("x", [])):
        res = []
        for mod in (ref_cli, port_cli):
            p = mod.Parsed(options={"concurrency": c, "nodes": nodes})
            try:
                res.append(mod.parse_concurrency(p).options["concurrency"])
            except ValueError as e:
                res.append(str(e))
        assert res[0] == res[1]
    for results in ({True: ["a"]}, {True: ["a"], False: ["b"]},
                    {"unknown": ["a"]}, {"crashed": ["a"], False: ["b"]}):
        assert port_cli.test_all_exit_code(results) == \
            ref_cli.test_all_exit_code(results)


def test_run_cli_exit_codes(capsys):
    cases = [
        ({"go": {}}, ["nope"]), ({"go": {}}, []),
        ({"go": {"opt_spec": [port_cli.Opt("help", short="-h")]}},
         ["go", "--help"]),
        ({"go": {"opt_spec": [port_cli.Opt("n", metavar="N", parse=int)]}},
         ["go", "--n", "x"]),
        ({"go": {"opt_spec": [], "run": lambda p: 2}}, ["go"]),
        ({"go": {"opt_spec": [], "run": lambda p: None}}, ["go"]),
        ({"go": {"opt_spec": [], "run": lambda p: 1 / 0}}, ["go"]),
        ({"go": {"opt_spec": [], "opt_fn": lambda p: 1 / 0}}, ["go"]),
    ]
    got = [port_cli.run_cli(cmds, argv) for cmds, argv in cases]
    assert got == [254, 254, 0, 254, 2, 0, 255, 254]


def _demo(tmp_path, *extra):
    return ["--device", "cpu", "--time-limit", "1", "--rate", "40",
            "--store-root", str(tmp_path / "store"), *extra]


def test_demo_test_exits_zero_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    rc = port_main.main(["test", *_demo(tmp_path, "--nodes", "n1,n2",
                                        "--concurrency", "2n")])
    assert rc == port_cli.EXIT_OK
    run = store.latest(str(tmp_path / "store"))
    loaded = store.load_latest(str(tmp_path / "store"))
    assert loaded["results"]["valid?"] is True
    assert loaded["results"]["algorithm"] == "cuda-wgl"
    assert loaded["concurrency"] == 4 and run.endswith(
        loaded["start_time"])
    kinds = [r["kind"] for r in
             ledger.Ledger(str(tmp_path / "store")).query()]
    assert kinds.count("run") == 1 and kinds.count("checker") == 1


@pytest.mark.parametrize("argv", [["--bogus"], ["--concurrency", "x"],
                                  ["--time-limit", "0"], ["--rate", "x"]])
def test_demo_test_bad_arguments_exit_254(tmp_path, argv):
    rc = port_cli.run_cli(port_main.COMMANDS, ["test", *_demo(tmp_path),
                                                 *argv])
    assert rc == port_cli.EXIT_BAD_ARGS
    assert not (tmp_path / "store").exists()


@pytest.mark.parametrize("command", ["test", "test-all"])
def test_demo_without_a_card_exits_255(tmp_path, monkeypatch, command,
                                       capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = port_cli.run_cli(port_main.COMMANDS, [
        command, "--time-limit", "1", "--store-root",
        str(tmp_path / "store")])
    assert rc == port_cli.EXIT_ERROR
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not (tmp_path / "store").exists()


def test_demo_test_all_two_successes(tmp_path, capsys):
    rc = port_cli.run_cli(port_main.COMMANDS, [
        "test-all", *_demo(tmp_path, "--test-count", "2")])
    out = capsys.readouterr().out
    assert rc == port_cli.EXIT_OK
    assert "2 successes" in out and "0 failures" in out
    runs = store.tests(str(tmp_path / "store"))
    assert {"demo-0", "demo-1"} <= set(runs)


def test_analyze_still_uses_the_demo_checker(tmp_path, monkeypatch):
    """`analyze` re-checks the run `test` stored, with the same demo
    map's checker."""
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    root = str(tmp_path / "store")
    assert port_main.main(["test", *_demo(tmp_path)]) == 0
    assert port_main.main(["analyze", "--store-root", root,
                           "--device", "cpu"]) == 0
    runs = store.tests(root)["demo"]
    assert len(runs) == 2
