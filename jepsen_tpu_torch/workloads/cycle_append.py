"""List-append workload package: generator + checker over transactions
of appends/reads on named lists (parity with
`jepsen/src/jepsen/tests/cycle/append.clj:11-55`; the checking engine
is `jepsen_tpu_torch.elle.append`).

Clients must understand invocations like

    {"f": "txn", "value": [["r", 3, None], ["append", 3, 2], ["r", 3, None]]}

and complete them with reads filled in:

    {"f": "txn", "value": [["r", 3, [1]], ["append", 3, 2], ["r", 3, [1, 2]]]}

The port's copy of `jepsen_tpu/workloads/cycle_append.py`, with the
port's `device` option passed through to `elle.append.check`: the cycle
search's kernels run there (None: the card, raising without one; "cpu":
their plain PyTorch versions).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from .. import store
from ..checker import Checker
from ..elle import append as elle_append


class AppendChecker(Checker):
    """Full checker for append/read histories; writes anomaly
    explanations under <store>/elle/ like the reference does
    (append.clj:17-22)."""

    def __init__(self, anomalies: Iterable[str] = ("G1", "G2"),
                 additional_graphs: Iterable[str] = (), device=None):
        self.anomalies = _expand(anomalies)
        self.additional_graphs = tuple(additional_graphs)
        self.device = device

    def check(self, test, history, opts=None):
        res = elle_append.check(history, anomalies=self.anomalies,
                                additional_graphs=self.additional_graphs,
                                device=self.device)
        _dump_anomalies(test, opts, res)
        return res


def _expand(anomalies) -> tuple:
    """:G1 means G1a+G1b+G1c; :G2 implies G-single (wr.clj:44-46);
    always include the cheap structural checks."""
    out = {"internal", "dirty-update", "duplicate-elements",
           "incompatible-order"}
    for a in anomalies:
        if a == "G1":
            out |= {"G1a", "G1b", "G1c", "G0"}
        elif a == "G2":
            out |= {"G2", "G-single"}
        else:
            out.add(a)
    return tuple(sorted(out))


def _dump_anomalies(test, opts, res):
    """Write the browsable per-anomaly file tree the reference's elle
    integration produces (`jepsen/src/jepsen/tests/cycle.clj:9-16`
    passes `:directory`; elle writes one file per anomaly type): for
    each anomaly, `elle/<name>.json` (machine-readable cases) and
    `elle/<name>.txt` (one human-readable block per case — cycle,
    step-by-step explanation). Browsable next to linear.svg in the
    web UI's store browser."""
    if res.get("valid?") is True or not test or not test.get("store_root"):
        return
    try:
        comps = [c for c in ((opts or {}).get("subdirectory"), "elle")
                 if c is not None]
        d = store.path(test, *comps)
        os.makedirs(d, exist_ok=True)
        for name, cases in (res.get("anomalies") or {}).items():
            with open(os.path.join(d, f"{name}.json"), "w") as fh:
                json.dump(cases, fh, indent=2, default=repr)
            with open(os.path.join(d, f"{name}.txt"), "w") as fh:
                fh.write(f"{name} — {len(cases)} case(s)\n")
                fh.write("=" * 60 + "\n\n")
                for i, case in enumerate(cases):
                    fh.write(f"case {i}\n")
                    if isinstance(case, dict):
                        if case.get("cycle") is not None:
                            fh.write("  cycle: "
                                     + " -> ".join(
                                         f"T{t}" for t in case["cycle"])
                                     + "\n")
                        for s in case.get("steps") or []:
                            fh.write(f"  step: T{s.get('from')} "
                                     f"-{s.get('type')}-> "
                                     f"T{s.get('to')}\n")
                        if case.get("explanation"):
                            fh.write("  why:  "
                                     + str(case["explanation"]) + "\n")
                        for k, v in case.items():
                            if k not in ("cycle", "steps",
                                         "explanation"):
                                fh.write(f"  {k}: {v!r}\n")
                    else:
                        fh.write(f"  {case!r}\n")
                    fh.write("\n")
    except Exception:  # noqa: BLE001 — diagnostics must not mask results
        pass


def checker(anomalies: Iterable[str] = ("G1", "G2"),
            additional_graphs: Iterable[str] = (), device=None) -> Checker:
    return AppendChecker(anomalies, additional_graphs, device)


def gen(key_count: int = 3, min_txn_length: int = 1,
        max_txn_length: int = 4, max_writes_per_key: int = 32,
        seed: Optional[int] = None):
    """The list-append txn generator (append.clj:28-31)."""
    return elle_append.AppendGen(
        key_count=key_count, min_txn_length=min_txn_length,
        max_txn_length=max_txn_length,
        max_writes_per_key=max_writes_per_key, seed=seed)


def workload(key_count: int = 3, min_txn_length: int = 1,
             max_txn_length: int = 4, max_writes_per_key: int = 32,
             anomalies: Iterable[str] = ("G1", "G2"),
             additional_graphs: Iterable[str] = (),
             seed: Optional[int] = None, device=None) -> dict:
    """A partial test: generator + checker (append.clj:33-55)."""
    return {"generator": gen(key_count, min_txn_length, max_txn_length,
                             max_writes_per_key, seed),
            "checker": checker(anomalies, additional_graphs, device)}
