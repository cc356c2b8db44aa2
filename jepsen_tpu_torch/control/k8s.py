"""Remote over `kubectl exec` / `kubectl cp` — for k8s pods (parity with
jepsen.control.k8s, `control/k8s.clj:1-111`). Node names are pod names;
an optional namespace comes from the conn spec.

The port's copy of `jepsen_tpu/control/k8s.py`."""

from __future__ import annotations

import os
import subprocess
from typing import Optional

from .core import Remote, wrap_sudo


class K8sRemote(Remote):
    def __init__(self, pod: Optional[str] = None,
                 namespace: Optional[str] = None):
        self.pod = pod
        self.namespace = namespace

    def connect(self, conn_spec):
        return K8sRemote(conn_spec["host"],
                         conn_spec.get("namespace") or self.namespace)

    def _ns(self) -> list:
        return ["-n", self.namespace] if self.namespace else []

    def execute(self, context, action):
        action = wrap_sudo(context, action)
        res = subprocess.run(
            ["kubectl", "exec", "-i", *self._ns(), self.pod, "--",
             "bash", "-c", action["cmd"]],
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
            subprocess.run(["kubectl", "cp", *self._ns(), str(p),
                            f"{self.pod}:{remote_path}"], check=True)

    def download(self, context, remote_paths, local_path, opts=None):
        if isinstance(remote_paths, (str, os.PathLike)):
            remote_paths = [remote_paths]
        for p in remote_paths:
            subprocess.run(["kubectl", "cp", *self._ns(),
                            f"{self.pod}:{p}", str(local_path)], check=True)


def remote() -> K8sRemote:
    return K8sRemote()
