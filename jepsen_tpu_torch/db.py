"""Database lifecycle protocols (parity with jepsen.db,
`jepsen/src/jepsen/db.clj`): `DB` setup/teardown (db.clj:11-13), optional
`Process` start/kill (:18-24), `Pause` (:26-29), `Primary` (:31-38),
`LogFiles` (:40-41), a tcpdump capture DB (:49-115), and `cycle`
(teardown -> setup on all nodes with 3 retries on SetupFailed,
:117-158).

The port's copy of `jepsen_tpu/db.py`.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Optional, Sequence

from . import control as c
from .control import nodeutil as cu

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


class Tcpdump(DB, LogFiles):
    """Captures packets from setup to teardown (db.clj:49-115). Options:
    ports (list), clients_only (bool), filter (str)."""

    DIR = "/tmp/jepsen/tcpdump"

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}

    @property
    def log_file(self):
        return f"{self.DIR}/log"

    @property
    def cap_file(self):
        return f"{self.DIR}/tcpdump"

    @property
    def pid_file(self):
        return f"{self.DIR}/pid"

    def setup(self, test, node):
        with c.su():
            c.exec_("mkdir", "-p", self.DIR)
            filters = []
            if self.opts.get("ports"):
                filters.append(" and ".join(
                    f"port {p}" for p in self.opts["ports"]))
            if self.opts.get("clients_only"):
                from .control import netinfo
                filters.append(f"host {netinfo.control_ip()}")
            if self.opts.get("filter"):
                filters.append(self.opts["filter"])
            cu.start_daemon(
                {"logfile": self.log_file, "pidfile": self.pid_file,
                 "chdir": self.DIR},
                "/usr/sbin/tcpdump",
                "-w", self.cap_file, "-s", "65535", "-B", "16384", "-U",
                " and ".join(filters))

    def teardown(self, test, node):
        with c.su():
            pid = cu.meh(c.exec_, "cat", self.pid_file)
            if pid:
                cu.meh(c.exec_, "kill", "-s", "INT", pid.strip())
                for _ in range(100):
                    if cu.meh(c.exec_, "ps", "-p", pid.strip()) is None:
                        break
                    _time.sleep(0.05)
            cu.stop_daemon("tcpdump", self.pid_file)
            c.exec_("rm", "-rf", self.DIR)

    def log_files(self, test, node):
        return [self.log_file, self.cap_file]


def tcpdump(opts: Optional[dict] = None) -> Tcpdump:
    return Tcpdump(opts)


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
