"""Generic cycle-detection checker: wraps any history -> DepGraph
analyzer into a Checker (parity with
`jepsen/src/jepsen/tests/cycle.clj:9-16`, whose engine is elle.core;
ours is `jepsen_tpu_torch.elle.graph`).

The port's copy of `jepsen_tpu/workloads/cycle.py`.
"""

from __future__ import annotations

from typing import Callable

from ..checker import Checker
from ..elle.graph import DepGraph


class CycleChecker(Checker):
    """Takes analyze_fn(history) -> DepGraph; reports the first cycle
    found over all edges as an anomaly."""

    def __init__(self, analyze_fn: Callable):
        self.analyze_fn = analyze_fn

    def check(self, test, history, opts=None):
        g: DepGraph = self.analyze_fn(history)
        cyc = g.find_cycle()
        if cyc is None:
            return {"valid?": True}
        return {"valid?": False,
                "cycles": [{"cycle": cyc,
                            "steps": g.explain_cycle(cyc)}]}


def checker(analyze_fn: Callable) -> Checker:
    return CycleChecker(analyze_fn)
