"""Database lifecycle protocols (parity with jepsen.db,
`jepsen/src/jepsen/db.clj`): `DB` setup/teardown (db.clj:11-13), optional
`Process` start/kill (:18-24), `Pause` (:26-29), `Primary` (:31-38),
`LogFiles` (:40-41), and `cycle` (teardown -> setup on all nodes with 3
retries on SetupFailed, :117-158).

The port's copy of `jepsen_tpu/db.py:1-72, 133-158`. The tcpdump capture
DB (`Tcpdump`, :74-130) needs `control.nodeutil` and is not ported yet
(ROADMAP.md Queue A item 6).
"""

from __future__ import annotations

import logging
from typing import Sequence

from . import control as c

log = logging.getLogger("jepsen_tpu_torch.db")


class DB:
    def setup(self, test: dict, node: str) -> None:
        return None

    def teardown(self, test: dict, node: str) -> None:
        return None


class Process:
    """Optional: starting and killing the DB's processes (db.clj:18-24)."""

    def start(self, test: dict, node: str):
        raise NotImplementedError

    def kill(self, test: dict, node: str):
        raise NotImplementedError


class Pause:
    """Optional: pausing/resuming processes (db.clj:26-29)."""

    def pause(self, test: dict, node: str):
        raise NotImplementedError

    def resume(self, test: dict, node: str):
        raise NotImplementedError


class Primary:
    """Optional: databases with a notion of primaries (db.clj:31-38)."""

    def primaries(self, test: dict) -> Sequence[str]:
        raise NotImplementedError

    def setup_primary(self, test: dict, node: str) -> None:
        return None


class LogFiles:
    def log_files(self, test: dict, node: str) -> Sequence[str]:
        return []


class Noop(DB):
    """Does nothing (db.clj:43-47)."""


noop = Noop


class SetupFailed(Exception):
    """Throw from DB.setup to request a teardown+retry (db.clj:117-120)."""


CYCLE_TRIES = 3  # db.clj:117-120


def cycle(test: dict) -> None:
    """Tear down then set up the DB on all nodes concurrently, retrying
    the whole cycle up to CYCLE_TRIES times on SetupFailed
    (db.clj:122-158)."""
    db = test["db"]
    tries = CYCLE_TRIES
    while True:
        log.info("Tearing down DB")
        c.on_nodes(test, db.teardown)
        try:
            log.info("Setting up DB")
            c.on_nodes(test, db.setup)
            if isinstance(db, Primary):
                primary = test["nodes"][0]
                log.info("Setting up primary %s", primary)
                c.on_nodes(test, lambda t, n: db.setup_primary(t, n),
                           [primary])
            return
        except SetupFailed:
            tries -= 1
            if tries < 1:
                raise
            log.warning("Unable to set up database; retrying...")
