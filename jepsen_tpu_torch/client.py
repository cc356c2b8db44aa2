"""Client protocol: applying operations to the system under test.

Capability parity with jepsen.client
(`jepsen/src/jepsen/client.clj:9-27`): a Client has a five-phase
lifecycle — open (connect to one node), setup (initialize DB state),
invoke (apply one op, returning its completion), teardown, close. The
optional `Reusable` marker (client.clj:29-43) lets a crashed client be
reused by a fresh process instead of being reopened; the `Validate`
wrapper (client.clj:64-109) enforces the completion invariants the rest
of the framework relies on (same process/f, completion type ok|info|fail).

The port's copy of `jepsen_tpu/client.py`.
"""

from __future__ import annotations

from typing import Any, Optional


class Client:
    """Base client. Subclasses override what they need; invoke! is
    mandatory."""

    def open(self, test: dict, node: str) -> "Client":
        """Connect to `node`; returns a client ready for invoke. Must not
        alter logical test state."""
        return self

    def close(self, test: dict) -> None:
        return None

    def setup(self, test: dict) -> None:
        return None

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        return None


class Reusable:
    """Mixin marker: crashed clients may be reused by the replacement
    process (client.clj:29-34)."""


def is_reusable(client, test) -> bool:
    return isinstance(client, Reusable)


class Noop(Client):
    """Does nothing; every op completes :ok (client.clj:46-53)."""

    def invoke(self, test, op):
        return {**op, "type": "ok"}


noop = Noop


class InvalidCompletion(Exception):
    def __init__(self, op, op2, problems):
        super().__init__(
            f"Client completed {op!r} with invalid completion {op2!r}: "
            + "; ".join(problems))
        self.op = op
        self.op2 = op2
        self.problems = problems


class Validate(Client):
    """Wraps a client, validating completions (client.clj:64-109)."""

    def __init__(self, client: Client):
        self.client = client

    def open(self, test, node):
        res = self.client.open(test, node)
        if not isinstance(res, Client):
            raise TypeError(
                f"expected open to return a Client, got {res!r}")
        return Validate(res)

    def close(self, test):
        self.client.close(test)

    def setup(self, test):
        self.client.setup(test)

    def invoke(self, test, op):
        op2 = self.client.invoke(test, op)
        problems = []
        if not isinstance(op2, dict):
            problems.append("should be a dict")
        else:
            if op2.get("type") not in ("ok", "info", "fail"):
                problems.append("type should be ok, info, or fail")
            if op2.get("process") != op.get("process"):
                problems.append("process should be the same")
            if op2.get("f") != op.get("f"):
                problems.append("f should be the same")
        if problems:
            raise InvalidCompletion(op, op2, problems)
        return op2

    def teardown(self, test):
        self.client.teardown(test)


def is_validate_reusable(client, test) -> bool:
    """Reusability of a possibly-wrapped client: Validate and any other
    wrapper exposing its inner client as `.client` (e.g.
    trace.TracedClient) are unwrapped transitively."""
    seen = set()
    c = client
    while id(c) not in seen and isinstance(getattr(c, "client", None),
                                           Client):
        seen.add(id(c))
        c = c.client
    return is_reusable(c, test)


def validate(client: Client) -> Validate:
    return Validate(client)
