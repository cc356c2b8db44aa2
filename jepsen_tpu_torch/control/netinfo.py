"""IP lookup helpers on nodes (parity with jepsen.control.net,
`jepsen/src/jepsen/control/net.clj:1-53`).

The port's copy of `jepsen_tpu/control/netinfo.py`."""

from __future__ import annotations

import socket
from functools import lru_cache
from typing import Optional

from . import exec_, state


@lru_cache(maxsize=1024)
def _resolve(node: str) -> str:
    return socket.gethostbyname(node)


def ip(node: str) -> str:
    """The IP address for a node name. Resolved on the control node first
    (cheap); falls back to `getent` on the current session's host
    (control/net.clj's ip). Unresolvable names come back unchanged —
    best effort: scripted/dummy remotes have no resolver, and a real
    cluster with broken DNS should surface the daemon's own bind error
    rather than a harness crash."""
    try:
        return _resolve(node)
    except OSError:
        try:
            out = exec_("getent", "hosts", node)
            return out.split()[0]
        except Exception:  # noqa: BLE001 — no resolver on this remote
            return node


def local_ip() -> str:
    """The bound node's own IP (control/net.clj's local-ip)."""
    return exec_("hostname", "-I").split()[0]


def control_ip() -> Optional[str]:
    """The control node's IP as seen from the cluster
    (control/net.clj's control-ip): the source address of a route
    towards the current host."""
    host = state.host
    if host is None:
        return socket.gethostbyname(socket.gethostname())
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((_resolve(host), 22))
        return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())
    finally:
        s.close()
