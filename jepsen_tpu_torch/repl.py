"""Helpers for poking at stored test runs from a Python shell
(jepsen/src/jepsen/repl.clj:6-9).

    >>> from jepsen_tpu_torch import repl
    >>> t = repl.latest_test()
    >>> t["results"]["valid?"]

The port's copy of `jepsen_tpu/repl.py`: `latest_test` reads the port's
own store root (`store/torch`) unless given another.
"""

from __future__ import annotations

from typing import Optional

from . import store


def latest_test(store_root: str = store.BASE_DIR) -> Optional[dict]:
    """The most recently run test, loaded lazily from the store
    (repl.clj:6-9)."""
    return store.load_latest(store_root)
