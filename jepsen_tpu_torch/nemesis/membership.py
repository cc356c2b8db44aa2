"""Cluster membership nemesis (parity with jepsen.nemesis.membership +
membership/state, `jepsen/src/jepsen/nemesis/membership{,.state}.clj`):
standardized support for nemeses that grow and shrink clusters. A
`State` models Jepsen's view of the cluster: per-node views polled on an
interval, a merged authoritative view, and the set of pending operations
whose resolution we must confirm before making further changes.

The port's copy of `jepsen_tpu/nemesis/membership.py`.
"""

from __future__ import annotations

import logging
import threading
import time as _time
from typing import Any, Optional

from .. import control as c
from .. import generator as gen
from . import Nemesis

log = logging.getLogger("jepsen_tpu_torch.nemesis.membership")

NODE_VIEW_INTERVAL = 5  # seconds between node view refreshes (:60-62)


class State:
    """The membership state machine protocol (membership/state.clj:21-59).
    Implementations carry three standard fields, maintained by the
    nemesis: node_views (node -> view), view (merged), pending (set of
    (op, op') pairs)."""

    node_views: dict
    view: Any
    pending: frozenset

    def setup(self, test) -> "State":
        return self

    def node_view(self, test, node):
        """This node's view of the cluster, or None if unknown."""
        raise NotImplementedError

    def merge_views(self, test):
        """Derive the authoritative view from node_views."""
        raise NotImplementedError

    def fs(self) -> set:
        raise NotImplementedError

    def op(self, test):
        """Next operation to perform, or "pending" if none available."""
        raise NotImplementedError

    def invoke(self, test, op):
        """Apply an op; returns op' or (op', state')."""
        raise NotImplementedError

    def resolve(self, test) -> "State":
        """Evolve toward a fixed point (default: resolve each pending
        op via resolve_op)."""
        state = self
        for pair in list(state.pending):
            nxt = state.resolve_op(test, pair)
            if nxt is not None:
                state = nxt
                state.pending = frozenset(state.pending) - {pair}
        return state

    def resolve_op(self, test, pair) -> Optional["State"]:
        """If (op, op') has resolved, return the new state, else None."""
        return None

    def teardown(self, test) -> None:
        return None


def initial_fields(test: dict) -> dict:
    """membership.clj:69-78."""
    return {"node_views": {}, "view": None, "pending": frozenset()}


class MembershipNemesis(Nemesis):
    """Wraps a State into a Nemesis: refreshes node views on an interval
    in a background thread, routes invokes through the state, and tracks
    pending ops (membership.clj:80-270)."""

    def __init__(self, state: State):
        self.state = state
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _refresh(self, test):
        views = c.on_nodes(test, lambda t, n: self.state.node_view(t, n))
        with self.lock:
            self.state.node_views = {k: v for k, v in views.items()
                                     if v is not None}
            self.state.view = self.state.merge_views(test)
            self.state = self.state.resolve(test)

    def setup(self, test):
        self.state.node_views = {}
        self.state.view = None
        self.state.pending = frozenset()
        self.state = self.state.setup(test)
        self._refresh(test)

        def loop():
            while not self._stop.wait(NODE_VIEW_INTERVAL):
                try:
                    self._refresh(test)
                except Exception as e:  # noqa: BLE001
                    log.warning("membership view refresh failed: %s", e)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="membership-views")
        self._thread.start()
        return self

    def invoke(self, test, op):
        with self.lock:
            res = self.state.invoke(test, op)
            if isinstance(res, tuple):
                op2, state2 = res
                self.state = state2
            else:
                op2 = res
            self.state.pending = frozenset(self.state.pending) | {
                (_freeze(op), _freeze(op2))}
            return {**op2, "type": "info"}

    def teardown(self, test):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=NODE_VIEW_INTERVAL + 1)
        self.state.teardown(test)

    def fs(self):
        return self.state.fs()

    def generator(self):
        """A generator asking the state for legal ops
        (membership.clj:231-237). When the state has no op available it
        reports "pending"; we emit PENDING (keeping the generator alive
        so it is asked again) rather than None, which the DSL would
        treat as permanent exhaustion."""
        return _MembershipGen(self)


class _MembershipGen(gen.Generator):
    def __init__(self, nem: "MembershipNemesis"):
        self.nem = nem

    def op(self, test, ctx):
        with self.nem.lock:
            o = self.nem.state.op(test)
        if o == "pending":
            return (gen.PENDING, self)
        if o is None:
            return None
        filled = gen.fill_in_op(dict(o), ctx)
        return (filled, self)


def _freeze(op: dict):
    return tuple(sorted((k, str(v)) for k, v in op.items()))


def nemesis(state: State) -> MembershipNemesis:
    return MembershipNemesis(state)
