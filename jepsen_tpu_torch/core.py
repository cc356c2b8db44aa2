"""The analysis half of the test lifecycle: `analyze` and `log_results`.

The port of `jepsen_tpu/core.py:131-162` (core.clj:221-252): index the
history, run the test's checker through `checker.check_safe`, and log a
human verdict. The run orchestration (`run`, sessions, the DB cycle)
is not ported. The reference's `enable_compilation_cache` has no call
here: the port's kernels persist under `build/torch_kernels/`, keyed by
the hash of their sources (`ops/_native.py`).
"""

from __future__ import annotations

import logging

from . import checker as jchecker
from .history import History

log = logging.getLogger(__name__)


def analyze(test: dict) -> dict:
    """Index the history and run the checker (core.clj:221-237): the
    test map with "history" an indexed `History` and "results"."""
    log.info("Analyzing...")
    history = test["history"]
    if not isinstance(history, History):
        history = History(history)
    history = history.index()
    test = {**test, "history": history}
    test["results"] = jchecker.check_safe(
        test.get("checker") or jchecker.unbridled_optimism(),
        test, history, {})
    log.info("Analysis complete")
    return test


def log_results(test: dict) -> dict:
    """core.clj:239-252."""
    valid = test.get("results", {}).get("valid?")
    if valid is False:
        verdict = "Analysis invalid! (ノಥ益ಥ）ノ ┻━┻"
    elif valid == "unknown":
        verdict = ("Errors occurred during analysis, "
                   "but no anomalies found. ಠ~ಠ")
    else:
        verdict = "Everything looks good! ヽ('ー`)ノ"
    log.info("%r\n\n%s", test.get("results"), verdict)
    return test
