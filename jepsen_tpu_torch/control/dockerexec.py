"""Remote over `docker exec` / `docker cp` — for containerized clusters
(parity with jepsen.control.docker, `control/docker.clj:1-92`).

The port's copy of `jepsen_tpu/control/dockerexec.py`."""

from __future__ import annotations

import os
import subprocess
from typing import Optional

from .core import Remote, wrap_sudo


class DockerRemote(Remote):
    def __init__(self, container: Optional[str] = None):
        self.container = container

    def connect(self, conn_spec):
        return DockerRemote(conn_spec["host"])

    def execute(self, context, action):
        action = wrap_sudo(context, action)
        res = subprocess.run(
            ["docker", "exec", "-i", self.container, "bash", "-c",
             action["cmd"]],
            input=(action.get("in") or "").encode() if action.get("in")
            else None,
            capture_output=True, timeout=action.get("timeout"))
        return {**action, "exit": res.returncode,
                "out": res.stdout.decode(errors="replace"),
                "err": res.stderr.decode(errors="replace"),
                "action": action}

    def upload(self, context, local_paths, remote_path, opts=None):
        if isinstance(local_paths, (str, os.PathLike)):
            local_paths = [local_paths]
        for p in local_paths:
            subprocess.run(["docker", "cp", str(p),
                            f"{self.container}:{remote_path}"], check=True)

    def download(self, context, remote_paths, local_path, opts=None):
        if isinstance(remote_paths, (str, os.PathLike)):
            remote_paths = [remote_paths]
        for p in remote_paths:
            subprocess.run(["docker", "cp", f"{self.container}:{p}",
                            str(local_path)], check=True)


def remote() -> DockerRemote:
    return DockerRemote()
