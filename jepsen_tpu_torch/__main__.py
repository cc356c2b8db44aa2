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
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


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


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .ledger import BASE_DIR

    parser = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
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
    args = parser.parse_args(argv)
    return args.run(args)


if __name__ == "__main__":
    sys.exit(main())
