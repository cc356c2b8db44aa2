"""`python -m jepsen_tpu_torch <command>`.

One command so far:

    python -m jepsen_tpu_torch preflight [--config NAME | --headline]
        [--ops N] [--txns N] [--execute] [--json] [--device DEV]

prints the admission plan a check would run (`analysis/preflight`):
buckets, kernel, Elle route, bytes on the card and the verdict, without
running anything. `--execute` also runs the planned check (on the card
unless `--device cpu`) and prints the plan beside what ran.
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


def main(argv: Optional[Sequence[str]] = None) -> int:
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
    args = parser.parse_args(argv)
    return args.run(args)


if __name__ == "__main__":
    sys.exit(main())
