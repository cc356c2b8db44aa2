"""Filesystem fault injection — the CharybdeFS-equivalent layer.

Capability parity with the reference's charybdefs wrapper
(`charybdefs/src/jepsen/charybdefs.clj:40-86`), which builds a
C++/Thrift FUSE passthrough on each node and drives EIO "cookbook"
recipes over RPC. Two native backends, both in `native/faultfs/`:

  * **faultfs** (`faultfs.cc`) — the FUSE passthrough. Mounts a
    backing dir with a `.faultfs_ctl` control file; one-line commands
    injected through the control layer flip global / probabilistic /
    path-targeted EIO and latency. Needs libfuse3-dev + /dev/fuse on
    the node; compiled there exactly like the reference compiles
    charybdefs on-node (charybdefs.clj:40-66).

  * **faultlib** (`faultlib.cc`) — an LD_PRELOAD libc interposer (the
    libfaketime mechanism, faketime.clj:8-22): wrap the DB daemon's
    environment and its writes/fsyncs to targeted paths fail with EIO,
    steerable at runtime through a config file the nemesis rewrites.
    No privileges needed — this backend runs in CI against live toykv
    clusters.

`FaultLibNemesis` ops:  {"f": "start", "value": {"eio_p": 1.0,
"path": "state.log", "delay_ms": 0, "eio_after": N}} begins injection
on every node; {"f": "stop"} clears it.

The port's copy of `jepsen_tpu/nemesis/faultfs.py`. The native sources
are the repo's own `native/faultfs/`, shared with the reference
(`NATIVE_DIR`); `faultlib.so` is built on the node, never in the repo.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from .. import control
from ..control import nodeutil
from . import Nemesis

log = logging.getLogger("jepsen_tpu_torch.nemesis.faultfs")

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                          "native", "faultfs")
REMOTE_DIR = "faultfs-src"
CONF_NAME = "faultlib.conf"


def _upload_sources():
    control.exec_("mkdir", "-p", REMOTE_DIR)
    for name in ("faultfs.cc", "faultlib.cc", "Makefile"):
        control.upload(os.path.join(NATIVE_DIR, name),
                       f"{REMOTE_DIR}/{name}")


def install_faultlib() -> str:
    """Compile faultlib.so on the node (g++ only); returns its node
    path. Mirrors nemesis/time.clj:20-39's compile-on-node."""
    _upload_sources()
    control.exec_("make", "-C", REMOTE_DIR, "build/faultlib.so")
    return f"{REMOTE_DIR}/build/faultlib.so"


def install_faultfs() -> str:
    """Compile the FUSE faultfs binary on the node (needs
    libfuse3-dev; the caller installs it, e.g. via the OS layer —
    charybdefs.clj:48-51 does apt-get there too)."""
    _upload_sources()
    control.exec_("make", "-C", REMOTE_DIR, "faultfs")
    return f"{REMOTE_DIR}/build/faultfs"


def preload_env(so_path: str, conf_path: str = CONF_NAME,
                path_substr: Optional[str] = None) -> dict:
    """Environment for a DB daemon to run under faultlib (merge into
    start_daemon's env), steerable later via the conf file."""
    env = {"LD_PRELOAD": so_path, "FAULTLIB_CONF": conf_path}
    if path_substr:
        env["FAULTLIB_PATH"] = path_substr
    return env


class FaultFS:
    """Mount manager + cookbook for the FUSE backend
    (charybdefs.clj:58-86). All methods run under a bound control
    session."""

    def __init__(self, backing: str = "/real", mount: str = "/faulty"):
        self.backing = backing
        self.mount = mount
        self.bin: Optional[str] = None

    def setup(self):
        self.bin = install_faultfs()
        control.exec_("mkdir", "-p", self.backing, self.mount)
        nodeutil.meh(control.exec_, "fusermount", "-u", self.mount)
        control.exec_(self.bin, self.backing, self.mount)

    def _ctl(self, command: str):
        control.exec_("bash", "-c",
                      f"echo {control.escape(command)} > "
                      f"{control.escape(self.mount)}/.faultfs_ctl")

    def break_all(self):
        self._ctl("eio all")           # charybdefs.clj:73-76

    def break_percent(self, p: float = 0.01):
        self._ctl(f"eio p {p}")        # charybdefs.clj:78-81

    def break_path(self, substr: str):
        self._ctl(f"eio path {substr}")

    def delay(self, ms: int, p: float = 1.0):
        self._ctl(f"delay ms {ms} p {p}")

    def clear(self):
        self._ctl("clear")             # charybdefs.clj:83-86

    def teardown(self):
        nodeutil.meh(control.exec_, "fusermount", "-u", self.mount)


class FaultLibNemesis(Nemesis):
    """Drives faultlib's conf file on every node: "start" writes the
    fault spec, "stop" clears it (the preload rereads the file on each
    intercepted call)."""

    def __init__(self, conf_path: str = CONF_NAME):
        self.conf_path = conf_path

    def setup(self, test):
        return self

    def invoke(self, test, op):
        f = op.get("f")
        if f == "start":
            spec = op.get("value") or {}
            lines = []
            for k in ("eio_p", "eio_after", "delay_ms", "path"):
                if spec.get(k) is not None:
                    lines.append(f"{k}={spec[k]}")
            body = "\\n".join(lines)
            cmd = (f"printf '{body}\\n' > "
                   f"{control.escape(self.conf_path)}")
        elif f == "stop":
            cmd = f"rm -f {control.escape(self.conf_path)}"
        else:
            return {**op, "value": ["unknown-f", f]}
        res = control.on_nodes(
            test, lambda t, n: control.exec_("bash", "-c", cmd))
        return {**op, "value": {n: "ok" for n in res}}

    def teardown(self, test):
        try:
            control.on_nodes(
                test, lambda t, n: nodeutil.meh(
                    control.exec_, "rm", "-f", self.conf_path))
        except Exception:  # noqa: BLE001 — sessions may be gone
            pass

    def fs(self):
        return ["start", "stop"]
