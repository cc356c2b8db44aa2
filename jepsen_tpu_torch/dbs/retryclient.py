"""Shared connect-with-retry client plumbing for the mini-server
suites (one copy, the miniserver.py discipline): a client that lazily
opens one connection to its node — or to the primary, for mini modes
whose single logical store lives on nodes[0] — retrying briefly
across a server's kill/restart window, with a post-connect hook for
session setup (e.g. tidb's auto-retry vars).

The port's copy of `jepsen_tpu/dbs/retryclient.py`.
"""

from __future__ import annotations

import time
from typing import Optional

from .. import client as jclient


def connect_with_retry(connect, retry_excs: tuple,
                       deadline_s: float = 5.0):
    """THE one copy of the connect-retry discipline: call `connect`
    until it returns, swallowing `retry_excs` (a server dying
    mid-handshake surfaces as a protocol error too, and the retry
    window must cover the restart either way) until the deadline."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return connect()
        except retry_excs:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.1)


class RetryClient(jclient.Client):
    """Subclasses implement `_connect(host, port)` returning an
    object with `.close()`, and may override `retry_excs` (what to
    swallow while the server restarts), `_post_connect`, and
    `default_port`."""

    retry_excs: tuple = (OSError,)
    default_port: int = 0
    connect_deadline_s: float = 5.0

    def __init__(self, port_fn=None, timeout: float = 5.0,
                 pin_primary: bool = False):
        self.port_fn = port_fn or (lambda test, node:
                                   (node, self.default_port))
        self.timeout = timeout
        self.pin_primary = pin_primary
        self.node: Optional[str] = None
        self.conn = None

    def open(self, test, node):
        c = type(self)(self.port_fn, self.timeout, self.pin_primary)
        c.node = node
        return c

    def _connect(self, host: str, port: int):
        raise NotImplementedError

    def _post_connect(self, conn, test) -> None:
        """Session setup on a fresh connection (default: none)."""

    def _conn(self, test):
        if self.conn is None:
            target = (test["nodes"][0] if self.pin_primary
                      else self.node)
            host, port = self.port_fn(test, target)
            conn = connect_with_retry(
                lambda: self._connect(host, port),
                self.retry_excs, self.connect_deadline_s)
            self._post_connect(conn, test)
            self.conn = conn
        return self.conn

    def _drop(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def close(self, test):
        self._drop()


def kill_targets(mode: str):
    """Node-targeter for kill/pause nemeses: mini modes pin the
    primary (it holds the one logical store), real clusters fault a
    random member."""
    from .. import generator as gen
    if mode == "mini":
        return lambda nodes: [nodes[0]]
    return lambda nodes: [gen.RNG.choice(nodes)]


def standard_generator(w: dict, nemesis, interval: float,
                       time_limit: float):
    """The suites' shared generator shape: the workload interleaved
    with a start/stop fault cycle under one time limit. A workload
    with ``wrap_time: False`` manages its own phases (e.g. sets'
    add-then-final-read), so the TIME LIMIT moves to the nemesis
    stream, which stops faults 4 s early — the drain window — and
    issues one final stop so the last phase runs against a healthy
    system. A Noop nemesis gets a sleep-only stream (nothing to
    drive)."""
    from .. import generator as gen
    from .. import nemesis as jnemesis
    workload_gen = w["generator"]
    if isinstance(nemesis, jnemesis.Noop):
        nem_gen = gen.repeat(gen.sleep(interval))
    else:
        nem_gen = gen.cycle([gen.sleep(interval),
                             {"type": "info", "f": "start"},
                             gen.sleep(interval),
                             {"type": "info", "f": "stop"}])
    if not w.get("wrap_time", True):
        nem_gen = gen.phases(
            gen.time_limit(max(1.0, time_limit - 4.0), nem_gen),
            gen.once(lambda test, ctx: {"type": "info",
                                        "f": "stop"}))
    workload_gen = gen.nemesis(nem_gen, workload_gen)
    if w.get("wrap_time", True):
        workload_gen = gen.time_limit(time_limit, workload_gen)
    return workload_gen
