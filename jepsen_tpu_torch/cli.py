"""Command-line interface framework for the port's `test` and
`test-all` commands.

The port's copy of `jepsen_tpu/cli.py:1-508` (jepsen.cli,
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
composes `single-test-cmd`/`test-all-cmd` (cli.clj:355,491). `run`
returns an exit code (or None for 0); `run_cli` returns the code rather
than exiting. The port's other commands (`preflight`, `serve`,
`analyze`) stay argparse commands in `__main__.py`.
"""

from __future__ import annotations

import logging
import re
import sys
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

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
    """Build the `test` command around a test_fn (cli.clj:355-400).

    opts: {"test_fn": options-map -> test-map,
           "opt_spec": extra Opts (merged into TEST_OPT_SPEC),
           "opt_fn": extra post-processing composed after test_opt_fn,
           "usage": usage string}

    The reference's command map also holds `analyze`; the port's
    `analyze` is its own argparse command (`__main__.run_analyze`)."""
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

    return {"test": {"opt_spec": opt_spec, "opt_fn": opt_fn,
                     "usage": usage, "run": run_test}}


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
