"""`python -m jepsen_tpu_torch <command>`.

    python -m jepsen_tpu_torch preflight [--config NAME | --headline]
        [--ops N] [--txns N] [--execute] [--json] [--device DEV]

prints the admission plan a check would run (`analysis/preflight`):
buckets, kernel, Elle route, bytes on the card and the verdict, without
running anything. `--execute` also runs the planned check (on the card
unless `--device cpu`) and prints the plan beside what ran.

    python -m jepsen_tpu_torch serve [-b HOST] [-p PORT] [--store-root DIR]
        [--service [--workers N] [--quota-device-s S] [--replica-id ID]
         [--device DEV] [--devices N]]

serves the run ledger and the live status over HTTP (`web.py`); with
`--service` it fronts the checker service (`service.py`): POST /check,
SSE at /events and /runs/<id>/events. The service runs on the card
unless `--device cpu`; `--devices N` gives it N shards of that device,
the mesh its coalesced batches run on. Cached bucket plans are
re-warmed after the bind succeeds.

    python -m jepsen_tpu_torch analyze [--store-root DIR] [--name NAME]
        [--device DEV]

re-checks the latest run stored under DIR (default: the port's store,
`store/torch`; a run that the JAX package stored is read the same way)
with the demo test's checker, `linearizable(cas_register(),
algorithm="cuda-wgl")`, on the card unless `--device cpu`. The analysis
is written as a new run of the same name under DIR (`results.json`, and
`linear.svg` on a False verdict), and the checker's record goes to the
run ledger under DIR. The exit code is the reference's (cli.clj:
129-139): 0 valid, 1 invalid, 2 unknown, 254 bad arguments, 255 an
internal error (no stored run, a name mismatch, no card).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
import traceback
from typing import Optional, Sequence

EXIT_OK = 0
EXIT_INVALID = 1
EXIT_UNKNOWN = 2
EXIT_BAD_ARGS = 254
EXIT_ERROR = 255


class _BadArgs(Exception):
    pass


class _Parser(argparse.ArgumentParser):
    """argparse with the reference's exit code for bad arguments (254,
    cli.clj:129-139) in place of argparse's 2."""

    def error(self, message):
        self.print_usage(sys.stderr)
        print(f"{self.prog}: error: {message}", file=sys.stderr)
        raise _BadArgs(message)


def _preflight(args) -> int:
    from .analysis import preflight

    return preflight.cli_main({
        "config": "headline" if args.headline else args.config,
        "ops": args.ops, "txns": args.txns, "execute": args.execute,
        "json": args.json, "device": args.device})


def _serve(args) -> int:
    from . import web

    svc = None
    if args.service:
        from .service import Service
        from .util import resolve_device

        dev = resolve_device(args.device)
        svc = Service(args.store_root, workers=args.workers,
                      quota_device_s=args.quota_device_s,
                      replica_id=args.replica_id,
                      devices=[dev] * max(1, args.devices))
    server = web.serve(host=args.host, port=args.port,
                       store_root=args.store_root, service=svc)
    if svc is not None:
        # re-warm the cached bucket plans only after the bind succeeded:
        # kernel builds must not precede an EADDRINUSE
        warmed = svc.rewarm()
        if warmed:
            print(f"Re-warmed {len(warmed)} cached bucket plan(s) from "
                  "fs_cache", flush=True)
    base = f"http://{args.host}:{server.server_port}"
    print(f"Listening on {base}/ (status: {base}/status.json, runs: "
          f"{base}/runs.json)", flush=True)
    if svc is not None:
        print(f"Checker service: POST {base}/check · events: {base}/events "
              f"({svc.workers} worker(s) on "
              f"{[str(d) for d in svc.devices]})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if svc is not None:
            svc.close()
    return 0


def demo_test(name: str, store_root: str, device) -> dict:
    """The demo test map that `analyze` merges with the stored run. Its
    checker is the device search (the reference's demo runs the host
    "wgl" oracle, `jepsen_tpu/__main__.py:54-55`); verdicts agree."""
    from . import checker, models

    return {"name": name, "store_root": store_root,
            "checker": checker.linearizable(models.cas_register(),
                                            algorithm="cuda-wgl",
                                            device=device)}


def _validity_code(test: dict) -> int:
    v = (test.get("results") or {}).get("valid?")
    if v is False:
        return EXIT_INVALID
    if v == "unknown":
        return EXIT_UNKNOWN
    return EXIT_OK


def run_analyze(store_root: str, name: str = "demo", device=None) -> int:
    """Re-analyze the latest stored history with a freshly built test map
    (the reference's `run_analyze`, cli.clj:402-431): the stored results
    are dropped, the test map merged over the demo's, `core.analyze`
    run, and the analysis written through `store.Writer` as a new run
    (a new start time) under `store_root`, its checker record banked in
    the ledger there. Returns the exit code by validity."""
    from . import core, ledger, store
    from .util import resolve_device

    cli_test = demo_test(name, store_root, resolve_device(device))
    if store.latest(store_root) is None:
        raise RuntimeError("Not sure what the last test was")
    stored = store.load_latest(store_root)
    if stored.get("name") != cli_test["name"]:
        raise RuntimeError(
            f"Stored test ({stored.get('name')}) and CLI test "
            f"({cli_test['name']}) have different names; aborting")
    stored.pop("results", None)
    now = time.time()
    test = {**cli_test, **stored, "store_root": store_root,
            "start_time": time.strftime("%Y%m%dT%H%M%S",
                                        time.localtime(now))
            + f".{int(now * 1000) % 1000:03d}"}
    with ledger.use(ledger.Ledger(store_root)):
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


def _analyze(args) -> int:
    return run_analyze(args.store_root, args.name, args.device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .ledger import BASE_DIR

    parser = _Parser(prog="python -m jepsen_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True,
                                parser_class=_Parser)
    pf = sub.add_parser("preflight", help="the static admission analyzer")
    pf.add_argument("--config", default="all",
                    help="headline | elle_append_8k | dense_100k | all")
    pf.add_argument("--headline", action="store_true",
                    help="the headline config alone (--config headline)")
    pf.add_argument("--ops", type=int, default=10_000,
                    help="headline history size (invocations)")
    pf.add_argument("--txns", type=int, default=4_000,
                    help="elle_append_8k history size (txns)")
    pf.add_argument("--execute", action="store_true",
                    help="also run the planned check and print the "
                         "planned-against-executed block")
    pf.add_argument("--json", action="store_true",
                    help="print the full plan reports as JSON")
    pf.add_argument("--device", default=None,
                    help="where the plan runs (default: the card)")
    pf.set_defaults(run=_preflight)
    sv = sub.add_parser("serve", help="the ledger and status server, and "
                                      "with --service the checker service")
    sv.add_argument("-b", "--host", default="0.0.0.0",
                    help="hostname to bind to")
    sv.add_argument("-p", "--port", type=int, default=8080,
                    help="port to bind to (0: a free one)")
    sv.add_argument("--store-root", default=BASE_DIR,
                    help=f"store directory (default: {BASE_DIR})")
    sv.add_argument("--service", action="store_true",
                    help="attach the checker service (POST /check, SSE, "
                         "the warm worker pool; re-warms cached plans)")
    sv.add_argument("--workers", type=int, default=1,
                    help="service worker threads")
    sv.add_argument("--quota-device-s", type=float, default=None,
                    help="per-tenant device-seconds quota over the "
                         "rolling window (default: unlimited)")
    sv.add_argument("--replica-id", default=None,
                    help="replica identity banked on heartbeats")
    sv.add_argument("--device", default=None,
                    help="where the service runs (default: the card)")
    sv.add_argument("--devices", type=int, default=1,
                    help="shards of that device: the mesh of the "
                         "coalesced batches")
    sv.set_defaults(run=_serve)
    an = sub.add_parser("analyze", help="re-check the latest stored run")
    an.add_argument("--store-root", default=BASE_DIR,
                    help=f"store directory (default: {BASE_DIR})")
    an.add_argument("--name", default="demo",
                    help="the test's name; must be the stored run's")
    an.add_argument("--device", default=None,
                    help="where the check runs (default: the card)")
    an.set_defaults(run=_analyze)
    try:
        args = parser.parse_args(argv)
    except _BadArgs:
        return EXIT_BAD_ARGS
    if args.command != "analyze":
        return args.run(args)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    try:
        return args.run(args)
    except BrokenPipeError:
        return EXIT_OK
    except Exception:  # noqa: BLE001
        print("Oh jeez, I'm sorry, jepsen_tpu_torch broke. Here's why:",
              file=sys.stderr)
        traceback.print_exc()
        return EXIT_ERROR


if __name__ == "__main__":
    sys.exit(main())
