"""A Remote that runs commands in local subprocesses.

The real-execution sibling of the dummy remote (`control/dummy.py`):
where dummy pretends every command succeeded, this one actually runs
them — `bash -c` under a per-node sandbox directory — so the entire
control algebra (escaping, cd, env prefixes, sudo-wrapped actions,
daemon management via `nodeutil.start_daemon`, real pids and signals)
is exercised against a live machine without SSH or containers. This is
the loopback integration tier the reference lacks (its control tests
need a reachable node and are tagged/skipped by default,
`jepsen/test/jepsen/control_test.clj`); suites like
`jepsen_tpu_torch.dbs.toykv` use it to run a real networked DB cluster
in-process-tree.

Each "node" <host> is sandboxed under <root>/<host>/: commands run
with that working directory and JEPSEN_NODE / JEPSEN_NODE_DIR
exported; absolute paths in upload/download are rebased into the
sandbox so nodes stay isolated. Sudo is accepted but ignored — the
current user runs everything (matching the docker remote's stance,
control/docker.clj).

The port's copy of `jepsen_tpu/control/localexec.py`.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

from .core import Remote

DEFAULT_TIMEOUT_S = 60.0


class LocalExecRemote(Remote):
    def __init__(self, root: str, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.root = os.path.abspath(root)
        self.timeout_s = timeout_s
        self.host: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------

    def connect(self, conn_spec):
        r = LocalExecRemote(self.root, self.timeout_s)
        r.host = conn_spec.get("host") or "local"
        os.makedirs(r.node_dir, exist_ok=True)
        return r

    @property
    def node_dir(self) -> str:
        return os.path.join(self.root, str(self.host))

    def _rebase(self, path: str) -> str:
        """Rebase an absolute path into the node sandbox; relative
        paths resolve against the sandbox root."""
        p = str(path)
        if os.path.isabs(p):
            return os.path.join(self.node_dir, p.lstrip("/"))
        return os.path.join(self.node_dir, p)

    # -- execution ---------------------------------------------------------

    def execute(self, context, action):
        env = dict(os.environ)
        env["JEPSEN_NODE"] = str(self.host)
        env["JEPSEN_NODE_DIR"] = self.node_dir
        cmd = action["cmd"]
        # The facade's wrap_cd bakes `cd <dir>; ` (dir defaults to "/",
        # control.clj *dir*) into the command before the remote sees
        # it. Rebase that exact prefix into the sandbox, so cwd-relative
        # suites stay contained.
        from .core import escape
        d = (context or {}).get("dir")
        if d:
            prefix = f"cd {escape(d)}; "
            if cmd.startswith(prefix):
                cmd = (f"cd {escape(self._rebase(d))}; "
                       + cmd[len(prefix):])
        try:
            proc = subprocess.run(
                ["bash", "-c", cmd],
                input=action.get("in"),
                capture_output=True, text=True,
                cwd=self.node_dir, env=env,
                timeout=action.get("timeout", self.timeout_s))
            return {**action, "exit": proc.returncode,
                    "out": proc.stdout, "err": proc.stderr}
        except subprocess.TimeoutExpired as e:
            return {**action, "exit": 124,
                    "out": (e.stdout or b"").decode()
                    if isinstance(e.stdout, bytes) else (e.stdout or ""),
                    "err": f"timed out after {self.timeout_s}s"}

    # -- file transfer -----------------------------------------------------

    def upload(self, context, local_paths, remote_path, opts=None):
        if isinstance(local_paths, (str, os.PathLike)):
            local_paths = [local_paths]
        dest = self._rebase(remote_path)
        many = len(local_paths) > 1 or os.path.isdir(dest)
        os.makedirs(dest if many else os.path.dirname(dest) or ".",
                    exist_ok=True)
        for lp in local_paths:
            target = os.path.join(dest, os.path.basename(lp)) if many \
                else dest
            if os.path.isdir(lp):
                shutil.copytree(lp, target, dirs_exist_ok=True)
            else:
                shutil.copy2(lp, target)

    def download(self, context, remote_paths, local_path, opts=None):
        if isinstance(remote_paths, (str, os.PathLike)):
            remote_paths = [remote_paths]
        many = len(remote_paths) > 1 or os.path.isdir(local_path)
        if many:
            os.makedirs(local_path, exist_ok=True)
        for rp in remote_paths:
            src = self._rebase(rp)
            if not os.path.exists(src):
                continue
            target = os.path.join(local_path, os.path.basename(rp)) \
                if many else local_path
            if os.path.isdir(src):
                shutil.copytree(src, target, dirs_exist_ok=True)
            else:
                os.makedirs(os.path.dirname(target) or ".",
                            exist_ok=True)
                shutil.copy2(src, target)


def remote(root: str, timeout_s: float = DEFAULT_TIMEOUT_S
           ) -> LocalExecRemote:
    return LocalExecRemote(root, timeout_s)
