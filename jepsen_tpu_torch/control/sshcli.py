"""SSH remote driving the OpenSSH client as a subprocess.

The reference ships two JVM SSH stacks (clj-ssh/JSch at
`jepsen/src/jepsen/control/clj_ssh.clj` and SSHJ at
`jepsen/src/jepsen/control/sshj.clj`). Here the system `ssh` binary is
the transport: a ControlMaster multiplexed connection per node gives
JSch-style session reuse without a Python SSH library, and `scp` handles
file transfer (the reference's scp remote, `control/scp.clj:59-139`).
Concurrency is capped per connection exactly as the reference caps
channels (8, clj_ssh.clj:87-94).

The port's copy of `jepsen_tpu/control/sshcli.py`.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading
from typing import Optional

from .core import Remote, wrap_sudo

CONCURRENCY_LIMIT = 8  # concurrent actions per connection (clj_ssh.clj:87-94)


class SSHRemote(Remote):
    def __init__(self, conn_spec: Optional[dict] = None):
        self.spec = conn_spec or {}
        self.control_dir: Optional[str] = None
        self.sem = threading.Semaphore(CONCURRENCY_LIMIT)

    # -- connection management -------------------------------------------
    def connect(self, conn_spec):
        r = SSHRemote(conn_spec)
        r.control_dir = tempfile.mkdtemp(prefix="jepsen-ssh-")
        # Open the master connection eagerly so failures surface at
        # connect time, as the reference's remotes do.
        res = r._run(r._ssh_args() + ["true"])
        if res.returncode != 0:
            try:
                os.rmdir(r.control_dir)
            except OSError:
                pass
            raise ConnectionError(
                f"ssh connect to {conn_spec.get('host')} failed: "
                f"{res.stderr.decode(errors='replace')}")
        return r

    def disconnect(self):
        if self.control_dir:
            self._run(["ssh", "-o", f"ControlPath={self._control_path()}",
                       "-O", "exit", self._dest()], timeout=10)
            try:
                os.rmdir(self.control_dir)
            except OSError:
                pass

    def _control_path(self) -> str:
        return os.path.join(self.control_dir or "/tmp", "cm-%r@%h:%p")

    def _dest(self) -> str:
        user = self.spec.get("username") or "root"
        return f"{user}@{self.spec.get('host')}"

    def _common_opts(self) -> list:
        opts = ["-o", "BatchMode=yes",
                "-o", f"ControlPath={self._control_path()}",
                "-o", "ControlMaster=auto",
                "-o", "ControlPersist=60",
                "-o", "ConnectTimeout=10"]
        if str(self.spec.get("strict_host_key_checking", "yes")) in (
                "no", "false", "False"):
            opts += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null"]
        if self.spec.get("port"):
            opts += ["-p", str(self.spec["port"])]
        if self.spec.get("private_key_path"):
            opts += ["-i", str(self.spec["private_key_path"])]
        return opts

    def _ssh_args(self) -> list:
        return ["ssh"] + self._common_opts() + [self._dest()]

    def _run(self, args, input_bytes: Optional[bytes] = None,
             timeout: Optional[float] = None):
        return subprocess.run(args, input=input_bytes,
                              capture_output=True, timeout=timeout)

    # -- actions ----------------------------------------------------------
    def execute(self, context, action):
        action = wrap_sudo(context, action)
        with self.sem:
            res = self._run(self._ssh_args() + [action["cmd"]],
                            input_bytes=(action.get("in") or "").encode()
                            if action.get("in") else None,
                            timeout=action.get("timeout"))
        return {**action,
                "exit": res.returncode,
                "out": res.stdout.decode(errors="replace"),
                "err": res.stderr.decode(errors="replace"),
                "action": action}

    def _scp_args(self) -> list:
        args = ["scp", "-r"] + self._common_opts()
        if self.spec.get("port"):
            # scp uses -P for port
            i = args.index("-p")
            args[i] = "-P"
        return args

    def upload(self, context, local_paths, remote_path, opts=None):
        if isinstance(local_paths, (str, os.PathLike)):
            local_paths = [local_paths]
        with self.sem:
            res = self._run(self._scp_args() + [str(p) for p in local_paths]
                            + [f"{self._dest()}:{remote_path}"])
        if res.returncode != 0:
            raise IOError("scp upload failed: "
                          f"{res.stderr.decode(errors='replace')}")

    def download(self, context, remote_paths, local_path, opts=None):
        if isinstance(remote_paths, (str, os.PathLike)):
            remote_paths = [remote_paths]
        with self.sem:
            res = self._run(self._scp_args()
                            + [f"{self._dest()}:{p}" for p in remote_paths]
                            + [str(local_path)])
        if res.returncode != 0:
            raise IOError("scp download failed: "
                          f"{res.stderr.decode(errors='replace')}")


def remote() -> SSHRemote:
    return SSHRemote()
