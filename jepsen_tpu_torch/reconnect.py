"""Lock-guarded auto-reconnecting client wrappers.

Capability parity with jepsen.reconnect (`jepsen/src/jepsen/reconnect.clj:
1-146`): database client libraries tend to wedge their connections when
the network misbehaves, so we wrap an open function and give callers a
handle that can be re-opened under a lock without racing in-flight users.

The port's copy of `jepsen_tpu/reconnect.py`.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional


class RWLock:
    """A simple writer-preferring read/write lock: many readers may hold
    it concurrently; a writer excludes everyone. The reference gets this
    from Java's ReentrantReadWriteLock (reconnect.clj:10: "multiple
    threads may acquire" the connection; only reopen is exclusive)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class Wrapper:
    """Holds a (re)openable connection. `open_fn()` builds a connection;
    `close_fn(conn)` tears one down; `name` is for logging."""

    def __init__(self, open_fn: Callable[[], Any],
                 close_fn: Optional[Callable[[Any], None]] = None,
                 name: str = "conn"):
        self.open_fn = open_fn
        self.close_fn = close_fn or (lambda c: None)
        self.name = name
        self.lock = RWLock()
        self.conn = None

    def open(self) -> "Wrapper":
        self.lock.acquire_write()
        try:
            if self.conn is None:
                self.conn = self.open_fn()
        finally:
            self.lock.release_write()
        return self

    def close(self) -> None:
        self.lock.acquire_write()
        try:
            self._close_locked()
        finally:
            self.lock.release_write()

    def _close_locked(self) -> None:
        if self.conn is not None:
            try:
                self.close_fn(self.conn)
            finally:
                self.conn = None

    def reopen(self) -> None:
        """Close and reopen the connection (reconnect.clj's reopen!) —
        exclusive: waits for in-flight users to drain."""
        self.lock.acquire_write()
        try:
            self._close_locked()
            self.conn = self.open_fn()
        finally:
            self.lock.release_write()

    def with_conn(self, f: Callable[[Any], Any]) -> Any:
        """Run f(conn) under the read lock: concurrent users proceed in
        parallel; reopens exclude them and wait for users to drain."""
        while True:
            self.lock.acquire_read()
            try:
                if self.conn is not None:
                    return f(self.conn)
            finally:
                self.lock.release_read()
            self.open()

    def with_retry(self, f: Callable[[Any], Any], retries: int = 1) -> Any:
        """Run f(conn); on failure, reopen and retry up to `retries`
        times before re-raising."""
        attempt = 0
        while True:
            try:
                return self.with_conn(f)
            except Exception:  # noqa: BLE001
                if attempt >= retries:
                    raise
                attempt += 1
                self.reopen()


def wrapper(open_fn, close_fn=None, name="conn") -> Wrapper:
    return Wrapper(open_fn, close_fn, name)
