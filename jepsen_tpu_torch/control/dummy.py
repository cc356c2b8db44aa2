"""A no-op remote for cluster-free tests.

Parity with the reference's `:dummy?` mode (`control.clj:40`, exercised
by `jepsen/test/jepsen/core_test.clj:55-58` via `:ssh {:dummy? true}`):
every command "succeeds" with empty output. Commands are recorded on the
shared `log` list so tests can assert orchestration behavior.

The port's copy of `jepsen_tpu/control/dummy.py`.
"""

from __future__ import annotations

from typing import Optional

from .core import Remote


class DummyRemote(Remote):
    def __init__(self, log: Optional[list] = None):
        self.log = log if log is not None else []
        self.host = None

    def connect(self, conn_spec):
        # type(self): scripted-subclass remotes (test stubs overriding
        # execute) must survive the connect
        r = type(self)(self.log)
        r.host = conn_spec.get("host")
        return r

    def execute(self, context, action):
        self.log.append((self.host, action.get("cmd")))
        return {**action, "exit": 0, "out": "", "err": "",
                "action": action}

    def upload(self, context, local_paths, remote_path, opts=None):
        self.log.append((self.host, ("upload", local_paths, remote_path)))

    def download(self, context, remote_paths, local_path, opts=None):
        self.log.append((self.host, ("download", remote_paths, local_path)))


def remote(log: Optional[list] = None) -> DummyRemote:
    return DummyRemote(log)
