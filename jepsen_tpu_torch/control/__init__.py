"""Remote-control DSL: run shell commands on cluster nodes.

Capability parity with jepsen.control (`jepsen/src/jepsen/control.clj`):
scoped dynamic state binds the current host/session/dir/sudo
(control.clj:40-53 uses Clojure dynamic vars; here a threading.local so
`on_nodes`'s thread-per-node fan-out gets independent bindings), with
`exec` (escaped commands -> stdout, control.clj:138-157), `upload` /
`download`, `cd`/`sudo_user`/`su` scopes (control.clj:203-218), `on` /
`on_many` / `on_nodes` parallel fan-out (control.clj:272-311), and
`with_ssh`/`with_remote` configuration scopes (control.clj:226-262).

The default remote is the OpenSSH subprocess transport wrapped in
retries; `{"dummy?": True}` in the test's ssh map swaps in the no-op
remote exactly as the reference's `:dummy?` flag does (control.clj:40).

The port's copy of `jepsen_tpu/control/__init__.py`.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Optional, Sequence

from ..util import real_pmap
from . import dummy as dummy_remote_mod
from . import retry as retry_mod
from . import sshcli
from .core import (AND, PIPE, Literal, NonzeroExit, Remote, env, escape, lit,
                   throw_on_nonzero_exit)

__all__ = ["escape", "lit", "env", "Literal", "NonzeroExit", "Remote",
           "exec_", "exec_star", "upload", "download", "cd", "sudo_user",
           "su", "trace", "on", "on_many", "on_nodes", "with_ssh",
           "with_remote", "with_session", "session", "disconnect",
           "AND", "PIPE", "state"]


class _State(threading.local):
    """Per-thread bindings (control.clj:40-53)."""

    def __init__(self):
        self.dummy = False
        self.host = None
        self.session = None
        self.trace = False
        self.dir = "/"
        self.sudo = None
        self.sudo_password = None
        self.username = "root"
        self.password = "root"
        self.port = 22
        self.private_key_path = None
        self.strict_host_key_checking = "yes"
        self.remote = None  # default constructed lazily


state = _State()


def default_remote() -> Remote:
    return retry_mod.remote(sshcli.remote())


def conn_spec() -> dict:
    return {"dummy": state.dummy,
            "host": state.host,
            "port": state.port,
            "username": state.username,
            "password": state.password,
            "private_key_path": state.private_key_path,
            "strict_host_key_checking": state.strict_host_key_checking}


def cmd_context() -> dict:
    return {"dir": state.dir,
            "sudo": state.sudo,
            "sudo_password": state.sudo_password}


_STATE_FIELDS = ("dummy", "host", "session", "trace", "dir", "sudo",
                 "sudo_password", "username", "password", "port",
                 "private_key_path", "strict_host_key_checking", "remote")


@contextmanager
def _bind(**kw):
    old = {k: getattr(state, k) for k in kw}
    for k, v in kw.items():
        setattr(state, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(state, k, v)


def _snapshot() -> dict:
    """Capture this thread's bindings so fan-out threads inherit them
    (the reference's bound-fn in on-nodes, control.clj:303-309)."""
    return {k: getattr(state, k) for k in _STATE_FIELDS}


def bound_fn(f: Callable) -> Callable:
    """Wrap f so it runs under the calling thread's control bindings —
    the reference's bound-fn* (used e.g. to open sessions from worker
    threads, core.clj:285-287)."""
    snap = _snapshot()

    def wrapped(*args, **kw):
        with _bind(**snap):
            return f(*args, **kw)

    return wrapped


def expand_path(path: str) -> str:
    if path.startswith("/"):
        return path
    d = state.dir or "/"
    return d + ("" if d.endswith("/") else "/") + path


@contextmanager
def cd(dir: str):
    """Evaluate body in the given directory (control.clj:203-207)."""
    with _bind(dir=expand_path(dir)):
        yield


@contextmanager
def sudo_user(user: str):
    with _bind(sudo=user):
        yield


@contextmanager
def su():
    """sudo root (control.clj:215-218)."""
    with _bind(sudo="root"):
        yield


@contextmanager
def trace():
    with _bind(trace=True):
        yield


def wrap_cd(action: dict) -> dict:
    if state.dir:
        return {**action, "cmd": f"cd {escape(state.dir)}; " + action["cmd"]}
    return action


class NoSessionError(Exception):
    pass


def ssh_star(action: dict) -> dict:
    """Evaluate an action against the current host (control.clj:125-136)."""
    if state.session is None:
        raise NoSessionError(
            "Unable to perform a control action: no session bound for "
            "this thread. Use on()/on_nodes()/with_session().")
    import logging
    if state.trace:
        logging.getLogger("jepsen_tpu_torch.control").info(
            "Host: %s action: %r", state.host, action)
    return {**state.session.execute(cmd_context(), action),
            "host": state.host, "action": action}


def just_stdout(result: dict) -> str:
    return result.get("out", "").rstrip("\n")


def exec_star(*commands) -> str:
    """Like exec_, without escaping (control.clj:138-148)."""
    cmd = " ".join(str(c) for c in commands)
    action = wrap_cd({"cmd": cmd})
    # sudo wrapping happens in the Remote (core.wrap_sudo) from context
    return just_stdout(throw_on_nonzero_exit(ssh_star(action)))


def exec_(*commands) -> str:
    """Run a shell command (all args escaped); return stdout, raising on
    nonzero exit (control.clj:150-157)."""
    return exec_star(*(escape(c) for c in commands))


def upload(local_paths, remote_path) -> str:
    """Copy local path(s) to the remote node (control.clj:167-178)."""
    if state.session is None:
        raise NoSessionError("no session bound")
    state.session.upload(cmd_context(), local_paths, remote_path, {})
    return remote_path


def upload_text(text: str, remote_path: str) -> str:
    """Upload a string's contents to a remote path (the reference's
    upload-resource!, control.clj:175-185, generalized)."""
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".upload") as f:
        f.write(text)
        f.flush()
        upload(f.name, remote_path)
    return remote_path


def download(remote_paths, local_path) -> None:
    """Copy remote path(s) here (control.clj:186-189)."""
    if state.session is None:
        raise NoSessionError("no session bound")
    state.session.download(cmd_context(), remote_paths, local_path, {})


def session(host: str) -> Remote:
    """A connected Remote for the given host (control.clj:225-229)."""
    base = state.remote
    if base is None:
        base = dummy_remote_mod.remote() if state.dummy else default_remote()
    return base.connect({**conn_spec(), "host": host})


def disconnect(sess: Remote) -> None:
    sess.disconnect()


@contextmanager
def with_remote(remote: Remote):
    with _bind(remote=remote):
        yield


def named_remote(name: str) -> Remote:
    """A Remote by name: "cli" (OpenSSH binary, the default stack) or
    "native" (the from-scratch SSH-2 implementation, sshnative.py) —
    the reference's clj-ssh/sshj duality, selected via the ssh map's
    "remote" key the way its :remote option picks a stack."""
    if name == "native":
        from . import sshnative
        return retry_mod.remote(sshnative.remote())
    if name in ("cli", "ssh"):
        return default_remote()
    raise ValueError(f"unknown remote {name!r} (want cli or native)")


@contextmanager
def with_ssh(ssh: Optional[dict]):
    """Bind SSH configuration from a test's ssh map (control.clj:241-262).
    ssh["remote"] ("cli" | "native") selects the transport stack."""
    ssh = ssh or {}
    if ssh.get("remote") and state.remote is None:
        with _bind(remote=named_remote(ssh["remote"])):
            with with_ssh({k: v for k, v in ssh.items()
                           if k != "remote"}):
                yield
            return
    with _bind(dummy=ssh.get("dummy?", state.dummy),
               username=ssh.get("username", state.username),
               password=ssh.get("password", state.password),
               sudo_password=ssh.get("sudo-password", state.sudo_password),
               port=ssh.get("port", state.port),
               private_key_path=ssh.get("private-key-path",
                                        state.private_key_path),
               strict_host_key_checking=ssh.get("strict-host-key-checking",
                                                state.strict_host_key_checking)):
        yield


@contextmanager
def with_session(host: str, sess: Remote):
    """Bind host + session without opening/closing (control.clj:264-270)."""
    with _bind(host=host, session=sess):
        yield


@contextmanager
def on(host: str):
    """Open a session to host, evaluate body, close (control.clj:272-281)."""
    sess = session(host)
    try:
        with with_session(host, sess):
            yield
    finally:
        disconnect(sess)


def on_many(hosts: Sequence[str], f: Callable[[], Any]) -> dict:
    """Run f() on each host in parallel with its session bound; returns
    {host: result} (control.clj:283-293)."""
    snap = _snapshot()

    def run(host):
        with _bind(**snap), on(host):
            return f()
    return dict(zip(hosts, real_pmap(run, hosts)))


def on_nodes(test: dict, f: Callable[[dict, str], Any],
             nodes: Optional[Sequence[str]] = None) -> dict:
    """Evaluate (f test node) in parallel on each node, with that node's
    session from test["sessions"] bound (control.clj:295-311)."""
    if nodes is None:
        nodes = test["nodes"]
    sessions = test.get("sessions") or {}
    snap = _snapshot()

    def run(node):
        sess = sessions.get(node)
        assert sess is not None, f"no session for node {node!r}"
        with _bind(**snap), with_session(node, sess):
            return f(test, node)

    return dict(zip(nodes, real_pmap(run, nodes)))
