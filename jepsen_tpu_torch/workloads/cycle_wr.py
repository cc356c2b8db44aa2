"""Write/read register workload package (parity with
`jepsen/src/jepsen/tests/cycle/wr.clj:14-53`; engine is
`jepsen_tpu_torch.elle.wr`). Writes are assumed unique.

The port's copy of `jepsen_tpu/workloads/cycle_wr.py`, with the port's
`device` option passed through to `elle.wr.check`, as in
`cycle_append`.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ..checker import Checker
from ..elle import wr as elle_wr
from .cycle_append import _dump_anomalies


class WrChecker(Checker):
    """Checker for write/read register histories. Options mirror
    wr.clj:16-28: sequential_keys / linearizable_keys / wfr_keys pick
    the version-order inference assumptions; additional_graphs adds
    realtime/process edges; `device` is where the cycle search's
    kernels run (None: the card)."""

    def __init__(self, anomalies: Iterable[str] = ("G0", "G1a", "G1b",
                                                   "G1c", "G-single",
                                                   "G2", "internal",
                                                   "cyclic-versions"),
                 additional_graphs: Iterable[str] = (),
                 sequential_keys: bool = False,
                 linearizable_keys: bool = False,
                 wfr_keys: bool = False,
                 device=None):
        self.anomalies = tuple(anomalies)
        self.additional_graphs = tuple(additional_graphs)
        self.sequential_keys = sequential_keys
        self.linearizable_keys = linearizable_keys
        self.wfr_keys = wfr_keys
        self.device = device

    def check(self, test, history, opts=None):
        res = elle_wr.check(
            history, anomalies=self.anomalies,
            additional_graphs=self.additional_graphs,
            sequential_keys=self.sequential_keys,
            linearizable_keys=self.linearizable_keys,
            wfr_keys=self.wfr_keys,
            device=self.device)
        _dump_anomalies(test, opts, res)
        return res


def checker(**opts) -> Checker:
    return WrChecker(**opts)


def gen(key_count: int = 3, min_txn_length: int = 1,
        max_txn_length: int = 4, max_writes_per_key: int = 32,
        seed: Optional[int] = None):
    return elle_wr.WrGen(
        key_count=key_count, min_txn_length=min_txn_length,
        max_txn_length=max_txn_length,
        max_writes_per_key=max_writes_per_key, seed=seed)


def workload(key_count: int = 3, min_txn_length: int = 1,
             max_txn_length: int = 4, max_writes_per_key: int = 32,
             seed: Optional[int] = None, **checker_opts) -> dict:
    return {"generator": gen(key_count, min_txn_length, max_txn_length,
                             max_writes_per_key, seed),
            "checker": checker(**checker_opts)}
