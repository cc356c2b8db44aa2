"""Linearizability checker over the port's device search.

The port of `jepsen_tpu.checker.Linearizable` (reference:
`jepsen/src/jepsen/checker.clj:185-216`, which gates knossos behind
:algorithm). `check(test, history, opts)` strips nemesis ops, runs the
well-formedness gate, dispatches to the chosen engine and truncates the
counterexample diagnostics to 10 entries.
"""

from __future__ import annotations

from typing import Optional

from . import models
from .analysis import history_lint
from .history import History, strip_nemesis
from .ops import wgl, wgl_ref

ALGORITHMS = ("cuda-wgl", "wgl")


class Linearizable:
    """Linearizability via WGL search.

    algorithm:
      "cuda-wgl" — the lockstep-frontier search with the hand-written
                   CUDA chunk kernel (on `device`, default the card),
                   plus counterexample diagnostics from the oracle on a
                   False verdict
      "wgl"      — the pure-Python DFS with memoization (the oracle)
    """

    def __init__(self, model: models.Model, algorithm: str = "cuda-wgl",
                 time_limit: Optional[float] = None, device=None):
        if algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown linearizability algorithm {algorithm!r}")
        self.model = model
        self.algorithm = algorithm
        self.time_limit = time_limit
        self.device = device

    def check(self, test: dict, history: History,
              opts: Optional[dict] = None) -> dict:
        h = strip_nemesis(history)
        algo = self.algorithm
        # a malformed history (double invoke, unmatched completion, clock
        # regression, ...) would silently corrupt the encoded tensors
        bad = history_lint.gate(h, where="checker.linearizable")
        if bad is not None:
            bad["algorithm"] = algo
            return bad
        if algo == "wgl":
            res = wgl_ref.check(self.model, h, time_limit=self.time_limit)
        else:
            res = wgl.check_with_diagnostics(
                self.model, h, time_limit=self.time_limit,
                device=self.device)
        # Truncate expensive diagnostics (checker.clj:213-216).
        for k in ("final_paths", "configs"):
            if k in res and isinstance(res[k], list):
                res[k] = res[k][:10]
        res["algorithm"] = algo
        return res


def linearizable(model=None, algorithm: str = "cuda-wgl",
                 time_limit: Optional[float] = None,
                 device=None) -> Linearizable:
    """A linearizability checker for `model` (default: cas-register)."""
    return Linearizable(model if model is not None
                        else models.cas_register(),
                        algorithm=algorithm, time_limit=time_limit,
                        device=device)
