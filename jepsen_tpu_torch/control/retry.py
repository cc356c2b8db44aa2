"""Auto-retrying remote wrapper (parity with jepsen.control.retry,
`control/retry.clj:1-72`): SSH connections flake, so retry failed
actions a few times with backoff, reconnecting on error. Connection
state lives in a `reconnect.Wrapper` — concurrent users share
the session under a read lock, and reconnects are exclusive, exactly as
the reference builds retry on jepsen.reconnect.

The port's copy of `jepsen_tpu/control/retry.py`.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Optional

from ..reconnect import Wrapper
from .core import Remote

log = logging.getLogger("jepsen_tpu_torch.control.retry")

RETRIES = 5          # control/retry.clj:15-17
BACKOFF_S = 0.1      # control/retry.clj:19-21


class RetryRemote(Remote):
    def __init__(self, remote: Remote, conn_spec: Optional[dict] = None,
                 wrapper: Optional[Wrapper] = None):
        self.inner = remote
        self.conn_spec = conn_spec
        self.wrapper = wrapper

    def connect(self, conn_spec):
        w = Wrapper(lambda: self.inner.connect(conn_spec),
                    lambda s: s.disconnect(),
                    name=str(conn_spec.get("host")))
        last = None
        for _ in range(RETRIES):
            try:
                w.open()
                return RetryRemote(self.inner, conn_spec, w)
            except Exception as e:  # noqa: BLE001
                last = e
                _time.sleep(BACKOFF_S)
        raise last  # type: ignore[misc]

    def disconnect(self):
        if self.wrapper:
            self.wrapper.close()

    def _with_retry(self, f):
        last = None
        for _ in range(RETRIES):
            try:
                return self.wrapper.with_conn(f)
            except Exception as e:  # noqa: BLE001
                last = e
                log.warning("remote action failed (%s); reconnecting", e)
                _time.sleep(BACKOFF_S)
                try:
                    self.wrapper.reopen()
                except Exception as ce:  # noqa: BLE001
                    last = ce
        raise last  # type: ignore[misc]

    def execute(self, context, action):
        return self._with_retry(lambda s: s.execute(context, action))

    def upload(self, context, local_paths, remote_path, opts=None):
        return self._with_retry(
            lambda s: s.upload(context, local_paths, remote_path, opts))

    def download(self, context, remote_paths, local_path, opts=None):
        return self._with_retry(
            lambda s: s.download(context, remote_paths, local_path, opts))


def remote(inner: Remote) -> RetryRemote:
    return RetryRemote(inner)
