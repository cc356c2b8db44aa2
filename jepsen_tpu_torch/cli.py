"""Command-line interface framework: the one option language of every
`python -m jepsen_tpu_torch` command.

The port's copy of `jepsen_tpu/cli.py` (jepsen.cli,
`jepsen/src/jepsen/cli.clj`): a declarative option-spec language that
suites can extend and merge (cli.clj:52-59), the standard test option
set (cli.clj:64-111), node-list merging from `-n`/`--nodes`/
`--nodes-file` (cli.clj:170-205), `"3n"` concurrency sugar
(cli.clj:150-168), and the subcommand dispatcher with the reference's
exit-code contract (cli.clj:129-139):

  0    all tests passed
  1    some test failed
  2    some test had an unknown validity
  254  invalid arguments / unknown command
  255  internal framework error

Commands are plain dicts `{"name": {"opt_spec", "opt_fn", "usage",
"run"}}` so suites compose them with `dict`-merge, as the reference
composes `single-test-cmd`/`test-all-cmd`/`serve-cmd` (cli.clj:355,491,
336). `run` returns an exit code (or None for 0); `run_cli` and `main`
return the code rather than exiting (`python -m jepsen_tpu_torch` exits
with it).

The port's own options: `--device` (where a check or the service runs;
default the card) and `serve --devices N` (N shards of that device, the
mesh of the service's coalesced batches). `serve -p 0` binds a free
port, which the reference's `pos_int` refuses.
"""

from __future__ import annotations

import logging
import os
import re
import sys
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from .ledger import BASE_DIR

log = logging.getLogger("jepsen_tpu_torch.cli")

DEFAULT_NODES = ["n1", "n2", "n3", "n4", "n5"]

EXIT_OK = 0
EXIT_INVALID = 1
EXIT_UNKNOWN = 2
EXIT_BAD_ARGS = 254
EXIT_ERROR = 255


def one_of(coll) -> str:
    """Validation help string listing legal values (cli.clj:20-25)."""
    names = sorted(coll.keys() if isinstance(coll, dict) else coll)
    return "Must be one of " + ", ".join(str(n) for n in names)


@dataclass
class Opt:
    """One command-line option.

    name      key in the parsed options map (underscored)
    long      long flag ("--node"); derived from name if None
    short     optional short flag ("-n")
    metavar   argument placeholder; a flag takes no argument if None
    help      docstring
    default   initial value
    parse     str -> value
    validate  (predicate, message)
    repeated  collect into a list, replacing the default wholesale on
              the first occurrence (cli.clj:27-50)
    """

    name: str
    help: str = ""
    short: Optional[str] = None
    long: Optional[str] = None
    metavar: Optional[str] = None
    default: Any = None
    parse: Optional[Callable[[str], Any]] = None
    validate: Optional[tuple] = None
    repeated: bool = False

    def __post_init__(self):
        if self.long is None:
            self.long = "--" + self.name.replace("_", "-")

    @property
    def takes_arg(self) -> bool:
        return self.metavar is not None

    def summary_line(self) -> str:
        flags = ", ".join(f for f in (self.short, self.long) if f)
        if self.takes_arg:
            flags += " " + self.metavar
        dflt = f" (default: {self.default})" if self.default not in (
            None, False) else ""
        return f"  {flags:<34} {self.help}{dflt}"


def pos_int(s: str) -> int:
    v = int(s)
    if v <= 0:
        raise ValueError(f"{v} must be positive")
    return v


def port_number(s: str) -> int:
    """A TCP port to bind, 0 for a free one."""
    v = int(s)
    if not 0 <= v <= 65535:
        raise ValueError(f"{v} is not a port number (0-65535)")
    return v


def comma_list(s: str) -> list:
    return [p for p in re.split(r",\s*", s) if p]


TEST_OPT_SPEC: list = [
    Opt("help", short="-h", help="Print out this message and exit"),
    Opt("node", short="-n", metavar="HOSTNAME", repeated=True,
        default=DEFAULT_NODES,
        help="Node(s) to run the test on; may be given many times."),
    Opt("nodes", metavar="NODE_LIST", parse=comma_list,
        help="Comma-separated list of node hostnames."),
    Opt("nodes_file", metavar="FILENAME",
        help="File containing node hostnames, one per line."),
    Opt("username", metavar="USER", default="root",
        help="Username for logins"),
    Opt("password", metavar="PASS", default="root",
        help="Password for sudo access"),
    Opt("strict_host_key_checking", default=False,
        help="Whether to check host keys"),
    Opt("no_ssh", default=False,
        help="Don't establish SSH connections to any nodes."),
    Opt("ssh_private_key", metavar="FILE",
        help="Path to an SSH identity file"),
    Opt("concurrency", metavar="NUMBER", default="1n",
        validate=(lambda s: re.fullmatch(r"\d+n?", str(s)),
                  "Must be an integer, optionally followed by n."),
        help="How many workers to run; an integer, optionally followed "
             "by n (e.g. 3n) to multiply by the number of nodes."),
    Opt("leave_db_running", default=False,
        help="Leave the database running at the end of the test."),
    Opt("logging_json", default=False,
        help="Use JSON structured output in the log."),
    Opt("test_count", metavar="NUMBER", default=1, parse=pos_int,
        help="How many times to repeat the test"),
    Opt("time_limit", metavar="SECONDS", default=60, parse=pos_int,
        help="Excluding setup and teardown, how long to run the test"),
]


def merge_opt_specs(a: Sequence[Opt], b: Sequence[Opt]) -> list:
    """Merge two option specs; where both define the same option name
    the latter wins (cli.clj:52-59)."""
    out: list = []
    names: dict = {}
    for o in list(a) + list(b):
        if o.name in names:
            out[names[o.name]] = o
        else:
            names[o.name] = len(out)
            out.append(o)
    return out


@dataclass
class Parsed:
    """Result of option parsing: the opts map, positional arguments,
    accumulated error strings, and a help summary."""

    options: dict = field(default_factory=dict)
    arguments: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    summary: str = ""


def parse_opts(argv: Sequence[str], spec: Sequence[Opt]) -> Parsed:
    """Parse argv against an option spec. Collects (rather than
    raises) errors so the caller can print them and exit 254."""
    by_flag: dict = {}
    for o in spec:
        by_flag[o.long] = o
        if o.short:
            by_flag[o.short] = o

    p = Parsed(options={o.name: o.default for o in spec},
               summary="\n".join(o.summary_line() for o in spec))
    replaced: set = set()  # repeated opts that dropped their default
    args = list(argv)
    i = 0
    while i < len(args):
        tok = args[i]
        i += 1
        if not tok.startswith("-") or tok == "-":
            p.arguments.append(tok)
            continue
        if tok == "--":
            p.arguments.extend(args[i:])
            break
        flag, _, inline = tok.partition("=")
        o = by_flag.get(flag)
        if o is None:
            p.errors.append(f"Unknown option: {flag}")
            continue
        if not o.takes_arg:
            val: Any = True
        elif inline or _:
            val = inline
        elif i < len(args):
            val = args[i]
            i += 1
        else:
            p.errors.append(f"Missing required argument for {flag}")
            continue
        if o.takes_arg:
            if o.validate and not o.validate[0](val):
                p.errors.append(
                    f'Failed to validate "{flag} {val}": {o.validate[1]}')
                continue
            if o.parse:
                try:
                    val = o.parse(val)
                except Exception as e:  # noqa: BLE001
                    p.errors.append(f'Error parsing "{flag} {val}": {e}')
                    continue
        if o.repeated:
            if o.name in replaced:
                p.options[o.name].append(val)
            else:
                replaced.add(o.name)
                p.options[o.name] = [val]
        else:
            p.options[o.name] = val
    return p


# -- Option post-processing (test-opt-fn, cli.clj:245-254) -----------------

def parse_concurrency(parsed: Parsed, key: str = "concurrency") -> Parsed:
    """Resolve "3n"-style concurrency to an integer (cli.clj:150-168)."""
    c = str(parsed.options.get(key))
    m = re.fullmatch(r"(\d+)(n?)", c)
    if not m:
        raise ValueError(
            f"--{key} {c} should be an integer optionally followed by n")
    unit = len(parsed.options.get("nodes") or []) if m.group(2) else 1
    parsed.options[key] = int(m.group(1)) * unit
    return parsed


def parse_nodes(parsed: Parsed) -> Parsed:
    """Merge `-n`, `--nodes`, and `--nodes-file` into a single "nodes"
    list (cli.clj:170-205). Explicit sources drop the default list."""
    o = parsed.options
    node = o.get("node")
    nodes = o.get("nodes")
    nodes_file = o.get("nodes_file")
    if node is DEFAULT_NODES and (nodes or nodes_file):
        node = None
    file_nodes = None
    if nodes_file:
        with open(nodes_file) as f:
            file_nodes = [ln.strip() for ln in f if ln.strip()]
    all_nodes = list(file_nodes or []) + list(nodes or []) + list(node or [])
    o.pop("node", None)
    o.pop("nodes_file", None)
    o["nodes"] = all_nodes
    return parsed


def rename_ssh_options(parsed: Parsed) -> Parsed:
    """Bundle the SSH flags into an "ssh" map (cli.clj:224-243)."""
    o = parsed.options
    o["ssh"] = {
        "dummy?": bool(o.pop("no_ssh", False)),
        "username": o.pop("username", None),
        "password": o.pop("password", None),
        "strict_host_key_checking": o.pop("strict_host_key_checking",
                                          False),
        "private_key_path": o.pop("ssh_private_key", None),
    }
    return parsed


def rename_options(parsed: Parsed, renames: dict) -> Parsed:
    for old, new in renames.items():
        if old in parsed.options:
            parsed.options[new] = parsed.options.pop(old)
    return parsed


def test_opt_fn(parsed: Parsed) -> Parsed:
    """The standard post-processing chain for test commands
    (cli.clj:245-254)."""
    parsed = rename_ssh_options(parsed)
    parsed = rename_options(parsed, {"leave_db_running":
                                     "leave_db_running?",
                                     "logging_json": "logging_json?"})
    parsed = parse_nodes(parsed)
    parsed = parse_concurrency(parsed)
    return parsed


# -- Subcommand dispatcher (cli.clj:258-332) -------------------------------

def run_cli(subcommands: dict, argv: Sequence[str],
            prog: str = "jepsen_tpu_torch") -> int:
    """Dispatch argv[0] to a subcommand map and return an exit code.

    Each subcommand is `{"opt_spec": [...], "opt_fn": fn, "usage": str,
    "run": fn(Parsed) -> int|None}`.
    """
    assert "--help" not in subcommands and "help" not in subcommands
    try:
        command = argv[0] if argv else None
        if command not in subcommands:
            print(f"Usage: python -m {prog} COMMAND [OPTIONS ...]")
            print("Commands:", ", ".join(sorted(subcommands)))
            return EXIT_BAD_ARGS

        sub = subcommands[command]
        opt_fn = sub.get("opt_fn") or (lambda p: p)
        usage = sub.get("usage") or (
            f"Usage: python -m {prog} {command} [OPTIONS ...]")
        run = sub.get("run")

        parsed = parse_opts(argv[1:], sub.get("opt_spec") or [])
        summary = parsed.summary
        if parsed.options.get("help"):
            print(usage)
            print()
            print(summary)
            return EXIT_OK
        if not parsed.errors:
            try:
                parsed = opt_fn(parsed)
            except Exception as e:  # noqa: BLE001
                parsed.errors.append(str(e))
        if parsed.errors:
            for e in parsed.errors:
                print(e, file=sys.stderr)
            return EXIT_BAD_ARGS
        parsed.options["argv"] = list(argv)

        if run is None:
            print("Options:")
            for k in sorted(parsed.options):
                print(f"  {k}: {parsed.options[k]!r}")
            return EXIT_OK
        rc = run(parsed)
        return EXIT_OK if rc is None else int(rc)
    except SystemExit as e:
        return int(e.code or 0)
    except BrokenPipeError:
        return EXIT_OK  # stdout closed (e.g. piped through head)
    except BaseException:  # noqa: BLE001
        print("Oh jeez, I'm sorry, jepsen_tpu_torch broke. Here's why:",
              file=sys.stderr)
        traceback.print_exc()
        return EXIT_ERROR


TEST_USAGE = """Usage: python -m jepsen_tpu_torch COMMAND [OPTIONS ...]

Runs a test and exits with a status code:

  0     All tests passed
  1     Some test failed
  2     Some test had an unknown validity
  254   Invalid arguments
  255   Internal error

Options:"""


def _validity_code(test: dict) -> int:
    v = (test.get("results") or {}).get("valid?")
    if v is False:
        return EXIT_INVALID
    if v == "unknown":
        return EXIT_UNKNOWN
    return EXIT_OK


def single_test_cmd(opts: dict) -> dict:
    """Build `test` and `analyze` commands around a test_fn
    (cli.clj:355-431).

    opts: {"test_fn": options-map -> test-map,
           "opt_spec": extra Opts (merged into TEST_OPT_SPEC),
           "opt_fn": extra post-processing composed after test_opt_fn,
           "usage": usage string}
    """
    opt_spec = merge_opt_specs(TEST_OPT_SPEC, opts.get("opt_spec") or [])
    extra = opts.get("opt_fn")
    opt_fn = (lambda p: extra(test_opt_fn(p))) if extra else test_opt_fn
    test_fn = opts["test_fn"]
    usage = opts.get("usage", TEST_USAGE)

    def run_test(parsed: Parsed):
        from . import core
        options = parsed.options
        log.info("Test options: %r", options)
        for _ in range(options.get("test_count") or 1):
            test = core.run(test_fn(options))
            rc = _validity_code(test)
            if rc != EXIT_OK:
                return rc
        return EXIT_OK

    def run_analyze(parsed: Parsed):
        """Re-analyze the latest stored history with a freshly built
        test map (cli.clj:402-431): the stored results are dropped, the
        test map merged over the CLI's, `core.analyze` run, and the
        analysis written through `store.Writer`. Unlike the reference,
        which rewrites the stored run's own directory, the analysis is
        a new run (a new start time, to the millisecond) under the
        store root, and its records go to the run ledger there."""
        import time

        from . import core, ledger, store
        options = parsed.options
        cli_test = test_fn(options)
        root = options.get("store_root") or BASE_DIR
        if store.latest(root) is None:
            raise RuntimeError("Not sure what the last test was")
        stored = store.load_latest(root)
        if stored.get("name") != cli_test.get("name"):
            raise RuntimeError(
                f"Stored test ({stored.get('name')}) and CLI test "
                f"({cli_test.get('name')}) have different names; aborting")
        stored.pop("results", None)
        now = time.time()
        test = {**cli_test, **stored, "store_root": root,
                "start_time": time.strftime("%Y%m%dT%H%M%S",
                                            time.localtime(now))
                + f".{int(now * 1000) % 1000:03d}"}
        with ledger.use(ledger.Ledger(root)):
            test = core.analyze(test)
        writer = store.Writer(test)
        try:
            test["store_dir"] = writer.dir
            writer.save_0(test)
            writer.save_1(test)
            writer.save_2(test)
        finally:
            writer.close()
        core.log_results(test)
        return _validity_code(test)

    return {
        "test": {"opt_spec": opt_spec, "opt_fn": opt_fn, "usage": usage,
                 "run": run_test},
        "analyze": {"opt_spec": opt_spec, "opt_fn": opt_fn, "usage": usage,
                    "run": run_analyze},
    }


def test_all_run_tests(tests) -> dict:
    """Run a sequence of tests; map outcome (True / "unknown" / False /
    "crashed") -> list of store paths (cli.clj:433-451)."""
    from . import core, store
    outcomes: dict = {}
    for test in tests:
        test = core.prepare_test(test)
        where = None
        try:
            done = core.run(test)
            where = done.get("store_dir") or store.path(done)
            outcome = (done.get("results") or {}).get("valid?")
        except Exception:  # noqa: BLE001
            log.warning("Test crashed", exc_info=True)
            where = test.get("store_dir") or test.get("name")
            outcome = "crashed"
        outcomes.setdefault(outcome, []).append(where)
    return outcomes


def test_all_print_summary(results: dict) -> dict:
    """Human summary of a test-all run (cli.clj:453-481)."""
    for outcome, title in ((True, "Successful tests"),
                           ("unknown", "Indeterminate tests"),
                           ("crashed", "Crashed tests"),
                           (False, "Failed tests")):
        if results.get(outcome):
            print(f"\n# {title}\n")
            for p in results[outcome]:
                print(p)
    print()
    print(len(results.get(True, [])), "successes")
    print(len(results.get("unknown", [])), "unknown")
    print(len(results.get("crashed", [])), "crashed")
    print(len(results.get(False, [])), "failures")
    return results


def test_all_exit_code(results: dict) -> int:
    """255 if any crashed, 2 if any unknown, 1 if any invalid, else 0
    (cli.clj:483-491)."""
    if results.get("crashed"):
        return EXIT_ERROR
    if results.get("unknown"):
        return EXIT_UNKNOWN
    if results.get(False):
        return EXIT_INVALID
    return EXIT_OK


def test_all_cmd(opts: dict) -> dict:
    """Build a `test-all` command around a tests_fn: options-map -> seq
    of test maps (cli.clj:493-519)."""
    opt_spec = merge_opt_specs(TEST_OPT_SPEC, opts.get("opt_spec") or [])
    extra = opts.get("opt_fn")
    opt_fn = (lambda p: extra(test_opt_fn(p))) if extra else test_opt_fn
    tests_fn = opts["tests_fn"]

    def run(parsed: Parsed):
        log.info("CLI options: %r", parsed.options)
        results = test_all_run_tests(tests_fn(parsed.options))
        test_all_print_summary(results)
        return test_all_exit_code(results)

    return {"test-all": {"opt_spec": opt_spec, "opt_fn": opt_fn,
                         "usage": "Runs all tests", "run": run}}


def serve_cmd() -> dict:
    """Build the results web-server command (cli.clj:334-354). With
    --service it also fronts the checker service (`service.py`): POST
    /check, SSE at /events and /runs/<id>/events; with --autopilot the
    verify-or-revert control loop (`autopilot.py`) runs over it."""
    spec = [
        Opt("help", short="-h", help="Print out this message and exit"),
        Opt("host", short="-b", metavar="HOST", default="0.0.0.0",
            help="Hostname to bind to"),
        Opt("port", short="-p", metavar="NUMBER", default=8080,
            parse=port_number, help="Port number to bind to (0: a free "
                                    "one)"),
        Opt("store_root", metavar="DIR", default=BASE_DIR,
            help="Store directory to serve"),
        Opt("service", default=False,
            help="Attach the checker service (POST /check + SSE + "
                 "warm worker pool; re-warms cached bucket plans)"),
        Opt("workers", metavar="N", default=1, parse=pos_int,
            help="Service worker threads (with --service)"),
        Opt("quota_device_s", metavar="SECONDS", parse=float,
            help="Per-tenant device-seconds quota over the rolling "
                 "window (with --service; default: unlimited)"),
        Opt("autopilot", default=False,
            help="Run the verify-or-revert control loop "
                 "(jepsen_tpu_torch/autopilot.py) over the service: "
                 "doctor/SLO findings execute their remedies, every "
                 "action banked and verified (with --service)"),
        Opt("clear_quarantine", default=False,
            help="Discard the autopilot quarantine persisted in "
                 "this store's ledger instead of rehydrating it "
                 "(with --service --autopilot; the clear itself is "
                 "banked)"),
        Opt("replica_id", metavar="ID",
            help="Fleet replica identity banked on heartbeats "
                 "(with --service; default: env "
                 "JEPSEN_TPU_REPLICA_ID, else host-pid)"),
        Opt("device", metavar="DEV",
            help="Where the service runs (with --service; default: the "
                 "card)"),
        Opt("devices", metavar="N", default=1, parse=pos_int,
            help="Shards of that device: the mesh of the service's "
                 "coalesced batches (with --service)"),
    ]

    def run(parsed: Parsed):
        from . import web
        o = parsed.options
        svc = None
        if o.get("service"):
            from .autopilot import CLEAR_QUARANTINE_ENV
            from .service import Service
            from .util import resolve_device
            if o.get("clear_quarantine"):
                # env, not a kwarg: the Supervisor is constructed inside
                # Service.start(), wherever rehydration happens
                os.environ[CLEAR_QUARANTINE_ENV] = "1"
            dev = resolve_device(o.get("device"))
            svc = Service(o["store_root"], workers=o.get("workers") or 1,
                          quota_device_s=o.get("quota_device_s"),
                          autopilot=bool(o.get("autopilot")),
                          replica_id=o.get("replica_id"),
                          devices=[dev] * o["devices"])
        server = web.serve(host=o["host"], port=o["port"],
                           store_root=o["store_root"], service=svc)
        if svc is not None:
            # re-warm the cached bucket plans only after the bind
            # succeeded: kernel builds must not precede an EADDRINUSE
            warmed = svc.rewarm()
            if warmed:
                print(f"Re-warmed {len(warmed)} cached bucket plan(s) "
                      "from fs_cache", flush=True)
        base = f"http://{o['host']}:{server.server_port}"
        print(f"Listening on {base}/", flush=True)
        print(f"Live run status: {base}/status "
              f"(JSON: {base}/status.json)", flush=True)
        print(f"Device observatory: {base}/devices "
              f"· occupancy: {base}/occupancy "
              f"· doctor: {base}/doctor "
              f"· slo: {base}/slo "
              f"· autopilot: {base}/autopilot "
              f"· fleet: {base}/fleet", flush=True)
        if svc is not None:
            print(f"Checker service: POST {base}/check · events: "
                  f"{base}/events ({svc.workers} worker(s) on "
                  f"{[str(d) for d in svc.devices]})"
                  + (" · autopilot ON" if svc.autopilot_enabled else ""),
                  flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
            if svc is not None:
                svc.close()
        return EXIT_OK

    return {"serve": {"opt_spec": spec, "run": run}}


def main(subcommands: dict, argv: Optional[Sequence[str]] = None) -> int:
    """run_cli over argv (default `sys.argv[1:]`) with INFO logging, the
    -main analog (cli.clj:521). Returns the exit code, where the
    reference's calls `sys.exit` with it."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    return run_cli(subcommands, sys.argv[1:] if argv is None else argv)
