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

import os

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


# --- the one command language ----------------------------------------------------

from jepsen_tpu import __main__ as ref_main  # noqa: E402

# the port's own options, which the reference's commands do not have
PORT_ONLY = {"device", "devices", "headline"}
COMMAND_NAMES = ["test", "test-all", "analyze", "serve", "preflight",
                 "doctor", "autopilot", "fleet"]


def _spec_rows(spec, port: bool):
    rows = []
    for o in spec:
        if port and o.name in PORT_ONLY:
            continue
        default = o.default
        if not port and o.name == "store_root" and default == "store":
            # the one deliberate divergence of the defaults: the port's
            # store is its own
            default = ledger.BASE_DIR
        rows.append((o.name, o.short, o.long, o.metavar is None,
                     o.repeated, default))
    return rows


def test_commands_are_the_references_less_fleet():
    # the name is kept from when `fleet` was missing: the sets are equal
    assert sorted(port_main.COMMANDS) == sorted(COMMAND_NAMES)
    assert sorted(port_main.COMMANDS) == sorted(ref_main.COMMANDS)
    import inspect
    assert "argparse" not in inspect.getsource(port_main)


@pytest.mark.parametrize("command", COMMAND_NAMES)
def test_option_names_short_forms_and_defaults_match(command):
    want = _spec_rows(ref_main.COMMANDS[command]["opt_spec"], port=False)
    got = _spec_rows(port_main.COMMANDS[command]["opt_spec"], port=True)
    assert got == want
    names = {o.name for o in port_main.COMMANDS[command]["opt_spec"]}
    assert names - {r[0] for r in got} <= PORT_ONLY


@pytest.mark.parametrize("command", COMMAND_NAMES)
def test_help_exits_0(command, capsys):
    for flag in ("--help", "-h"):
        assert port_cli.run_cli(port_main.COMMANDS, [command, flag]) == 0
        assert ref_cli.run_cli(ref_main.COMMANDS, [command, flag]) == 0
    out = capsys.readouterr().out
    assert "-h, --help" in out and "Traceback" not in out


@pytest.mark.parametrize("argv", [["fleets"], ["nope", "--json"], ["nope"],
                                  [], ["--help"]])
def test_unknown_commands_and_fleet_exit_254(argv, capsys):
    """An unknown command exits 254 with the command list, which names
    `fleet` now; `fleet`'s own codes are in the exit-code scenarios."""
    assert port_main.main(argv) == port_cli.EXIT_BAD_ARGS
    assert ref_cli.run_cli(ref_main.COMMANDS, argv) == ref_cli.EXIT_BAD_ARGS
    out = capsys.readouterr().out
    assert "Commands: analyze, autopilot, doctor, fleet, preflight, " \
           "serve, test, test-all" in out


def _store_run(root, history, name="demo"):
    test = {"name": name, "start_time": "20260101T000000",
            "store_root": str(root), "history": history}
    w = store.Writer(test)
    try:
        w.save_0(test)
        w.save_1(test)
    finally:
        w.close()


def _history(lie_p=0.0):
    from jepsen_tpu import synth as jsynth
    return [o.to_dict() for o in jsynth.cas_register_history(
        200, n_procs=4, seed=8 if lie_p else 3, crash_p=0.0, lie_p=lie_p)]


MALFORMED = [{"type": "invoke", "f": "read", "process": 0, "value": None},
             {"type": "invoke", "f": "read", "process": 0, "value": None},
             {"type": "ok", "f": "read", "process": 0, "value": 1}]


def _storm(root):
    """One record whose compiles storm past its one shape bucket (D001,
    critical)."""
    ledger.Ledger(str(root)).record({
        "kind": "independent", "name": "keys", "compiles": 50,
        "shapes": {"K": 16, "W_pad": 7}})


def _scenario(name, root):
    """(argv without the command's device option, want code, needs the
    port's --device cpu): one exit-code scenario, its store made under
    `root`."""
    s = str(root)
    busy = os.path.join(s, "a-file")
    if name.endswith("store-is-a-file"):
        os.makedirs(s, exist_ok=True)
        open(busy, "w").close()
    table = {
        "test valid": (["test", "--time-limit", "1", "--rate", "40",
                        "--store-root", s], 0, True),
        "test bad-option": (["test", "--bogus"], 254, False),
        "test bad-value": (["test", "--time-limit", "0"], 254, False),
        "test store-is-a-file": (["test", "--time-limit", "1",
                                  "--store-root", busy], 255, True),
        "test-all store-is-a-file": (["test-all", "--time-limit", "1",
                                      "--store-root", busy], 255, True),
        "test-all bad-option": (["test-all", "--bogus"], 254, False),
        "analyze valid": (["analyze", "--store-root", s], 0, True),
        "analyze invalid": (["analyze", "--store-root", s], 1, True),
        "analyze malformed": (["analyze", "--store-root", s], 2, True),
        "analyze empty-store": (["analyze", "--store-root", s], 255, True),
        "analyze name-mismatch": (["analyze", "--store-root", s, "--name",
                                   "x"], 255, True),
        "analyze bad-option": (["analyze", "--bogus"], 254, False),
        "serve bad-port": (["serve", "-p", "x"], 254, False),
        "serve bad-option": (["serve", "--bogus"], 254, False),
        "serve port-in-use": (["serve", "-b", "127.0.0.1", "-p", "PORT",
                               "--store-root", s], 255, False),
        "preflight plans": (["preflight", "--config", "dense_100k"], 0,
                            True),
        "preflight unknown-config": (["preflight", "--config", "nope"], 254,
                                     False),
        "preflight bad-value": (["preflight", "--ops", "x"], 254, False),
        "doctor healthy": (["doctor", "--store", s, "--no-record",
                            "latest"], 0, False),
        "doctor strict": (["doctor", "--store", s, "--no-record", "--strict",
                           "latest"], 1, False),
        "doctor missing": (["doctor", "--store", s, "nope"], 254, False),
        "autopilot storm": (["autopilot", "--store", s, "latest"], 0, False),
        "autopilot missing": (["autopilot", "--store", s, "nope"], 254,
                              False),
        "autopilot bad-option": (["autopilot", "--bogus"], 254, False),
        "fleet roots": (["fleet", os.path.join(s, "r1"), "--json"], 0,
                        False),
        "fleet missing-journey": (["fleet", os.path.join(s, "r1"),
                                   "--journey", "nope"], 1, False),
        "fleet none-found": (["fleet", "--discover",
                              os.path.join(s, "none", "empty")], 2, False),
        "fleet bad-option": (["fleet", "--bogus"], 254, False),
    }
    if name in ("analyze valid", "analyze name-mismatch"):
        _store_run(root, _history())
    elif name == "analyze invalid":
        _store_run(root, _history(lie_p=0.02))
    elif name == "analyze malformed":
        _store_run(root, MALFORMED)
    elif name in ("doctor strict", "autopilot storm"):
        _storm(root)
    elif name in ("fleet roots", "fleet missing-journey"):
        ledger.Ledger(os.path.join(s, "r1")).record({
            "kind": "replica-heartbeat", "name": "replica:r1",
            "replica": "r1", "every_s": 2.0, "served": 0})
    elif name == "fleet none-found":
        os.makedirs(os.path.join(s, "none", "empty"))
    elif name == "doctor healthy":
        ledger.Ledger(s).record({"kind": "checker", "name": "run-x",
                                 "platform": "cpu", "compiles": 0})
    return table[name]


SCENARIOS = ["test valid", "test bad-option", "test bad-value",
             "test store-is-a-file", "test-all store-is-a-file",
             "test-all bad-option", "analyze valid", "analyze invalid",
             "analyze malformed", "analyze empty-store",
             "analyze name-mismatch", "analyze bad-option",
             "serve bad-port", "serve bad-option", "serve port-in-use",
             "preflight plans", "preflight unknown-config",
             "preflight bad-value", "doctor healthy", "doctor strict",
             "doctor missing", "autopilot storm", "autopilot missing",
             "autopilot bad-option", "fleet roots", "fleet missing-journey",
             "fleet none-found", "fleet bad-option"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_exit_codes_match_the_reference(scenario, tmp_path, monkeypatch,
                                        capsys):
    """Each command's exit code in the same situation, in both packages:
    0/1/2 by validity, 254 bad arguments, 255 an internal error. The port
    runs its checks with `--device cpu`; the reference's demo runs the
    host oracle."""
    import socket
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    sock = None
    codes = {}
    try:
        for pkg in ("ref", "port"):
            root = tmp_path / pkg
            argv, want, device = _scenario(scenario, root)
            if "PORT" in argv:
                sock = socket.socket()
                sock.bind(("127.0.0.1", 0))
                sock.listen(1)
                argv = [str(sock.getsockname()[1]) if a == "PORT" else a
                        for a in argv]
            if pkg == "ref":
                codes[pkg] = ref_cli.run_cli(ref_main.COMMANDS, argv)
            else:
                codes[pkg] = port_main.main(
                    argv + (["--device", "cpu"] if device else []))
    finally:
        if sock is not None:
            sock.close()
    assert codes == {"ref": want, "port": want}


def test_serve_on_a_thread_answers_status_with_the_autopilot_block(
        tmp_path, monkeypatch):
    """`serve -p 0`, run by `main` on a thread, binds a free port and
    answers /status.json with the idle autopilot block, and the
    `/autopilot` page with the reference's panel."""
    import json
    import threading
    import time
    import urllib.request

    from jepsen_tpu_torch import web
    monkeypatch.setattr("logging.basicConfig", lambda **kw: None)
    made = []
    real_serve = web.serve

    def capture(**kw):
        made.append(real_serve(**kw))
        return made[-1]

    monkeypatch.setattr(web, "serve", capture)
    rc = []
    t = threading.Thread(target=lambda: rc.append(port_main.main(
        ["serve", "-b", "127.0.0.1", "-p", "0", "--store-root",
         str(tmp_path / "store")])), daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while not made:
        assert time.monotonic() < deadline and t.is_alive()
        time.sleep(0.02)
    try:
        port = made[0].server_port
        assert port > 0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/status.json", timeout=30) as r:
            snap = json.loads(r.read())
        assert snap["autopilot"] == {
            "active": False, "steps": 0, "counts": {}, "quarantined": {},
            "pending": [], "actions": []}
        assert snap["service"]["active"] is False
        # the reference's /autopilot panel, byte for byte but for the
        # package named in its command hint
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/autopilot",
                                    timeout=30) as r:
            assert r.status == 200
            page = r.read()
        from jepsen_tpu import web as ref_web
        want = ref_web.render_autopilot(str(tmp_path / "store"))
        assert page.replace(b"python -m jepsen_tpu_torch ",
                            b"python -m jepsen_tpu ") == want
        assert b"autopilot &middot; idle" in page
    finally:
        made[0].shutdown()
        t.join(timeout=30)
    assert rc == [0]
