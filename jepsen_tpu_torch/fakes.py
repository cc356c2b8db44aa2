"""In-process fakes for testing the framework without a cluster.

Capability parity with jepsen.tests (`jepsen/src/jepsen/tests.clj`):
`noop_test` is a complete test-map stub; `AtomDB`/`AtomClient` implement
a linearizable CAS register over shared in-process state with a 1 ms
sleep for real concurrency (tests.clj:27-67) — enough to run the entire
run() pipeline in CI with no SSH and no database.

The port's copy of `jepsen_tpu/fakes.py`.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Optional

from . import client as jclient
from . import checker as jchecker
from . import nemesis as jnemesis


class SharedRegister:
    """The in-process 'database': a lock-guarded register."""

    def __init__(self, value=None):
        self.lock = threading.Lock()
        self.value = value

    def read(self):
        with self.lock:
            return self.value

    def write(self, v):
        with self.lock:
            self.value = v

    def cas(self, cur, new) -> bool:
        with self.lock:
            if self.value == cur:
                self.value = new
                return True
            return False


class AtomClient(jclient.Client):
    """CAS-register client over a SharedRegister (tests.clj:34-67).
    Sleeps 1 ms per op so tests see real concurrency."""

    def __init__(self, state: SharedRegister, meta_log: Optional[list] = None):
        self.state = state
        self.meta_log = meta_log if meta_log is not None else []

    def open(self, test, node):
        self.meta_log.append("open")
        return AtomClient(self.state, self.meta_log)

    def setup(self, test):
        self.meta_log.append("setup")

    def invoke(self, test, op):
        _time.sleep(0.001)
        f = op.get("f")
        if f == "write":
            self.state.write(op.get("value"))
            return {**op, "type": "ok"}
        if f == "cas":
            cur, new = op["value"]
            ok = self.state.cas(cur, new)
            return {**op, "type": "ok" if ok else "fail"}
        if f == "read":
            return {**op, "type": "ok", "value": self.state.read()}
        raise ValueError(f"unknown op {f!r}")

    def teardown(self, test):
        self.meta_log.append("teardown")

    def close(self, test):
        self.meta_log.append("close")


class IndependentAtomClient(jclient.Client):
    """Multi-key CAS-register client for independent workloads: op
    values are [k v] tuples; each key addresses its own SharedRegister
    in a shared dict (the in-process analog of the reference's
    register-map tests)."""

    def __init__(self, states: Optional[dict] = None, lie_keys=(),
                 lock: Optional[threading.Lock] = None):
        self.states = states if states is not None else {}
        # the registry lock must be SHARED across open() clones, or two
        # clones could both install a fresh register for the same key
        # and one of them silently lose writes
        self.lock = lock or threading.Lock()
        self.lie_keys = set(lie_keys)  # keys whose reads lie (for tests)

    def open(self, test, node):
        return IndependentAtomClient(self.states, self.lie_keys,
                                     self.lock)

    def setup(self, test):
        pass

    def _reg(self, k) -> SharedRegister:
        with self.lock:
            if k not in self.states:
                self.states[k] = SharedRegister()
            return self.states[k]

    def invoke(self, test, op):
        from .independent import KV, tuple_
        _time.sleep(0.0002)
        kv = op.get("value")
        if not isinstance(kv, KV):
            raise ValueError(f"expected [k v] tuple value, got {kv!r}")
        k, v = kv
        reg = self._reg(k)
        f = op.get("f")
        if f == "write":
            reg.write(v)
            return {**op, "type": "ok"}
        if f == "cas":
            cur, new = v
            okd = reg.cas(cur, new)
            return {**op, "type": "ok" if okd else "fail"}
        if f == "read":
            out = reg.read()
            if k in self.lie_keys:
                out = (out or 0) + 100  # deliberately wrong
            return {**op, "type": "ok", "value": tuple_(k, out)}
        raise ValueError(f"unknown op {f!r}")

    def teardown(self, test):
        pass

    def close(self, test):
        pass


class NoopNemesis(jnemesis.Noop):
    """Accepts every op unchanged."""


def noop_test() -> dict:
    """A boring test stub (tests.clj:12-25); extend with real
    generator/client/checker as needed."""
    return {
        "name": "noop",
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "concurrency": 5,
        "client": jclient.noop(),
        "nemesis": NoopNemesis(),
        "generator": None,
        "checker": jchecker.unbridled_optimism(),
    }
