"""`python -m jepsen_tpu_torch <command>`: every command in the one
option language of `cli.py` (the reference's `COMMANDS`,
`jepsen_tpu/__main__.py:210-218`). `--help` prints a command's options;
the exit codes are the reference's (cli.clj:129-139): 0 valid, 1
invalid, 2 unknown, 254 bad arguments or an unknown command, 255 an
internal error (among them no card without `--device cpu`).

    python -m jepsen_tpu_torch test [--time-limit S] [--concurrency N[n]]
        [--rate HZ] [--nodes N1,N2,...] [--store-root DIR] [--name NAME]
        [--device DEV] [--test-count N] ...
    python -m jepsen_tpu_torch test-all [--test-count N] ...

run the demo test end to end (the reference's `python -m jepsen_tpu
test`): `core.run` of `demo_test`, whose generator is the cas-register
mix of reads, writes and cas ops at a total rate of `--rate` ops/s
(`gen.stagger`) for `--time-limit` seconds, run by the interpreter
against an in-process register (`fakes.AtomClient`) on `--concurrency`
workers over the dummy remote, with a no-op nemesis; the history is
checked by `linearizable(cas_register(), algorithm="cuda-wgl")` on the
card unless `--device cpu`, and the run is stored under DIR (default:
`store/torch`). `test-all` runs `--test-count` such tests and prints the
reference's summary ("N successes", ...).

    python -m jepsen_tpu_torch analyze [--store-root DIR] [--name NAME]
        [--device DEV]

re-checks the latest run stored under DIR (a run the JAX package stored
is read the same way) with the demo test's checker, on the card unless
`--device cpu`. The analysis is written as a new run of the same name
under DIR (`results.json`, and `linear.svg` on a False verdict), and the
checker's record goes to the run ledger under DIR. No stored run or a
name mismatch exits 255.

    python -m jepsen_tpu_torch serve [-b HOST] [-p PORT] [--store-root DIR]
        [--service [--workers N] [--quota-device-s S] [--replica-id ID]
         [--autopilot [--clear-quarantine]] [--device DEV] [--devices N]]

serves the run ledger and the live status over HTTP (`web.py`); with
`--service` it fronts the checker service (`service.py`): POST /check,
SSE at /events and /runs/<id>/events, on the card unless `--device
cpu`, over `--devices N` shards of that device (the mesh its coalesced
batches run on). `--autopilot` runs the verify-or-revert supervisor
(`autopilot.py`) over the service; its block rides `/status.json`.
`-p 0` binds a free port. Cached bucket plans are re-warmed after the
bind succeeds.

    python -m jepsen_tpu_torch preflight [--config NAME | --headline]
        [--ops N] [--txns N] [--execute] [--json] [--device DEV]

prints the admission plan a check would run (`analysis/preflight`):
buckets, kernel, Elle route, bytes on the card and the verdict, without
running anything. `--execute` also runs the planned check (on the card
unless `--device cpu`) and prints the plan beside what ran.

    python -m jepsen_tpu_torch doctor [run_id|latest|bench] [--root DIR]
        [--store DIR] [--json] [--strict] [--no-record] [--watch
         [--interval S]]

diagnoses a recorded run (`doctor.py`): a ledger record under the store
(default `<root>/store/torch`) by id, the newest one ("latest"), or the
bench round written under `--root` (default: the working directory;
"bench", the default). It banks a `kind="doctor"` record unless
`--no-record`; `--strict` exits 1 when a warn or critical finding fired;
a record that is not there exits 254.

    python -m jepsen_tpu_torch autopilot [run_id|latest|bench] [--root DIR]
        [--store DIR] [--json]

replays the autopilot's frozen policy table over a recorded run's
diagnosis: which remedies the supervisor would execute (the decide step
only; no actuator runs and nothing is banked). A record that is not
there exits 254.

    python -m jepsen_tpu_torch fleet [ROOT ...] [--discover DIR]
        [--journey RUN_ID] [--perfetto PATH] [--json]

federates N replicas' store ledgers (`observatory.py`) into one
snapshot: the heartbeat liveness map, the request-weighted fleet SLO
beside each replica's, and the D013-D015 findings. With no roots it
takes `JEPSEN_TPU_FLEET_ROOTS` (path-separated), else discovers the
stores in and around `store/torch`. `--journey` prints one request's
cross-process path (exit 1 when not found), `--perfetto` writes the
merged trace, one process track a replica. No store root found exits 2.
Read-only over every store.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from . import cli
from .cli import Opt
from .ledger import BASE_DIR


def demo_workload():
    """r/w/cas op mix over a small value alphabet
    (tests/linearizable_register.clj:18-29)."""
    from . import generator as gen

    return gen.mix([
        gen.repeat(lambda: {"f": "read"}),
        gen.repeat(lambda: {"f": "write", "value": gen.RNG.randrange(5)}),
        gen.repeat(lambda: {"f": "cas",
                            "value": [gen.RNG.randrange(5),
                                      gen.RNG.randrange(5)]}),
    ])


def demo_test(options: dict) -> dict:
    """The demo test map from parsed CLI options (the reference's
    `demo_test`, `jepsen_tpu/__main__.py:37-62`). Its checker is the
    device search on the card unless `options["device"]` names another
    device (the reference's demo runs the host "wgl" oracle; verdicts
    agree); a missing card raises here, before anything runs. `analyze`
    merges the stored run over the same map."""
    from . import checker, fakes, models
    from . import generator as gen
    from .util import resolve_device

    device = resolve_device(options.get("device"))
    nodes = options.get("nodes") or cli.DEFAULT_NODES
    rate = options.get("rate") or 10.0
    return {
        "name": options.get("name") or "demo",
        "store_root": options.get("store_root") or BASE_DIR,
        "nodes": nodes,
        "concurrency": options.get("concurrency") or len(nodes),
        # the demo's "cluster" is in-process; always use the dummy remote
        "ssh": {"dummy?": True},
        "client": fakes.AtomClient(fakes.SharedRegister()),
        "nemesis": fakes.NoopNemesis(),
        "leave_db_running?": options.get("leave_db_running?", False),
        # the reference register workload composes linearizable (+
        # timeline) only — stats would fail any short run where some op
        # type happens to record zero oks (checker.clj:166-183)
        "checker": checker.linearizable(models.cas_register(),
                                        algorithm="cuda-wgl",
                                        device=device),
        "generator": gen.time_limit(
            options.get("time_limit") or 60,
            gen.clients(gen.stagger(1.0 / rate, demo_workload()))),
    }


def demo_tests(options: dict):
    """test-all: the demo test, `test_count` times."""
    for i in range(options.get("test_count") or 1):
        t = demo_test(options)
        yield {**t, "name": f"{t['name']}-{i}"}


# The demo's options over the reference's `TEST_OPT_SPEC`
# (`jepsen_tpu/__main__.py:72-79`), with the port's `--device`.
DEMO_OPTS = [
    Opt("name", metavar="NAME", default="demo",
        help="Name for this test run"),
    Opt("store_root", metavar="DIR", default=BASE_DIR,
        help="Where to write results"),
    Opt("rate", metavar="HZ", default=10.0, parse=float,
        help="Approximate ops/sec, all workers together"),
    Opt("device", metavar="DEV", default=None,
        help="Where the check runs (default: the card)"),
]


def preflight_cmd() -> dict:
    """`python -m jepsen_tpu_torch preflight`: the static admission
    analyzer (`analysis/preflight`), the reference's `preflight_cmd`.
    It prints the plan report a check would run (ladder buckets,
    kernel, Elle route, bytes on the card) and its verdict without
    running anything; `--execute` also runs it. `--headline` is the
    port's spelling of `--config headline`, and `--device` where the
    plan runs."""
    spec = [
        Opt("help", short="-h", help="Print out this message and exit"),
        Opt("config", metavar="NAME", default="all",
            help="headline | elle_append_8k | dense_100k | all"),
        Opt("headline", default=False,
            help="The headline config alone (--config headline)"),
        Opt("ops", metavar="N", default=10_000, parse=cli.pos_int,
            help="Headline history size (invocations)"),
        Opt("txns", metavar="N", default=4_000, parse=cli.pos_int,
            help="elle_append_8k history size (txns)"),
        Opt("execute", default=False,
            help="Also run the planned check and print the "
                 "planned-vs-executed parity block"),
        Opt("json", default=False,
            help="Emit the full plan reports as JSON"),
        Opt("device", metavar="DEV",
            help="Where the plan runs (default: the card)"),
    ]

    def run(parsed):
        from .analysis import preflight as preflight_mod
        o = parsed.options
        return preflight_mod.cli_main(
            {**o, "config": "headline" if o.get("headline")
             else o.get("config")})

    return {"preflight": {"opt_spec": spec, "run": run,
                          "usage": "Usage: python -m jepsen_tpu_torch "
                                   "preflight [OPTIONS ...]"}}


def doctor_cmd() -> dict:
    """`python -m jepsen_tpu_torch doctor <run_id|latest|bench>`: the
    diagnosis engine (`doctor.py`) over a recorded run, the reference's
    `doctor_cmd`. Pure host-side reads of already-recorded artifacts;
    nothing runs on a device."""
    spec = [
        Opt("help", short="-h", help="Print out this message and exit"),
        Opt("target", metavar="TARGET",
            help="run_id | latest | bench (also accepted as a bare "
                 "positional argument; default bench)"),
        Opt("root", metavar="DIR",
            help="Repo root for bench artifacts (default: cwd)"),
        Opt("store", metavar="DIR",
            help="Store root holding the ledger (default: "
                 "<root>/store/torch)"),
        Opt("json", default=False,
            help="Emit the full report as JSON"),
        Opt("strict", default=False,
            help="Exit 1 when any warn/critical finding fired"),
        Opt("no_record", default=False,
            help="Read-only: skip banking the kind=\"doctor\" "
                 "ledger record"),
        Opt("watch", default=False,
            help="Keep re-diagnosing whenever the store's ledger "
                 "index changes (read-only; Ctrl-C to stop)"),
        Opt("interval", metavar="SECONDS", default=2.0, parse=float,
            help="--watch throttle: at most one diagnosis per this "
                 "many seconds"),
    ]

    def run(parsed):
        from . import doctor as doctor_mod
        return doctor_mod.cli_main(parsed.options, parsed.arguments)

    return {"doctor": {"opt_spec": spec, "run": run,
                       "usage": "Usage: python -m jepsen_tpu_torch doctor "
                                "[run_id|latest|bench] [OPTIONS ...]"}}


def autopilot_cmd() -> dict:
    """`python -m jepsen_tpu_torch autopilot <run_id|latest|bench>`: the
    offline replay of the autopilot's frozen policy table against a
    recorded run (`autopilot.cli_main`), the reference's
    `autopilot_cmd`: the remedies the supervisor would execute (the
    decide step only; no actuator runs, nothing is banked)."""
    spec = [
        Opt("help", short="-h", help="Print out this message and exit"),
        Opt("target", metavar="TARGET",
            help="run_id | latest | bench (also accepted as a bare "
                 "positional argument; default latest)"),
        Opt("root", metavar="DIR",
            help="Repo root for bench artifacts (default: cwd)"),
        Opt("store", metavar="DIR",
            help="Store root holding the ledger (default: "
                 "<root>/store/torch)"),
        Opt("json", default=False,
            help="Emit the decisions + policy table as JSON"),
    ]

    def run(parsed):
        from . import autopilot as autopilot_mod
        return autopilot_mod.cli_main(parsed.options, parsed.arguments)

    return {"autopilot": {"opt_spec": spec, "run": run,
                          "usage": "Usage: python -m jepsen_tpu_torch "
                                   "autopilot [run_id|latest|bench] "
                                   "[OPTIONS ...]"}}


def fleet_cmd() -> dict:
    """`python -m jepsen_tpu_torch fleet <roots...>`: the fleet
    observatory (`observatory.cli_main`), the reference's `fleet_cmd`.
    Federates N replicas' store ledgers into one snapshot, reassembles a
    request's cross-process journey, or writes a merged Perfetto trace
    with one process track per replica. Strictly read-only over every
    store."""
    spec = [
        Opt("help", short="-h", help="Print out this message and exit"),
        Opt("discover", metavar="DIR",
            help="Discover store roots in/around this directory "
                 f"(used when no roots are given; default: {BASE_DIR})"),
        Opt("journey", metavar="RUN_ID",
            help="Reassemble one request's cross-process journey "
                 "and print it as JSON (exit 1 when not found)"),
        Opt("perfetto", metavar="PATH",
            help="Write the merged fleet Perfetto trace here"),
        Opt("json", default=False,
            help="Emit the full fleet snapshot as JSON"),
    ]

    def run(parsed):
        from . import observatory as observatory_mod
        return observatory_mod.cli_main(parsed.options, parsed.arguments)

    return {"fleet": {"opt_spec": spec, "run": run,
                      "usage": "Usage: python -m jepsen_tpu_torch fleet "
                               "[store_roots ...] [OPTIONS ...]"}}


# The reference's COMMANDS (`jepsen_tpu/__main__.py:210-218`).
COMMANDS = {
    **cli.single_test_cmd({"test_fn": demo_test, "opt_spec": DEMO_OPTS}),
    **cli.test_all_cmd({"tests_fn": demo_tests, "opt_spec": DEMO_OPTS}),
    **cli.serve_cmd(),
    **preflight_cmd(),
    **doctor_cmd(),
    **autopilot_cmd(),
    **fleet_cmd(),
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run one command (argv default `sys.argv[1:]`); returns its exit
    code."""
    return cli.main(COMMANDS, argv)


if __name__ == "__main__":
    sys.exit(main())
