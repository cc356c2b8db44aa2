"""Shared machinery for the in-repo LIVE mini servers (mini-redis,
mini-disque): the embedded RESP2 wire codec their source strings
splice in, and the common DB lifecycle (heredoc upload, daemon
start/stop with pidfile + readiness poll, kill -9 fault surface,
teardown wipe) over the localexec remote.

One copy of the codec and lifecycle means a protocol or durability
fix lands everywhere at once — the suites keep only their
command-set/persistence logic.

The port's copy of `jepsen_tpu/dbs/miniserver.py`.
"""

from __future__ import annotations

from .. import control, db as jdb
from ..control import nodeutil

# RESP2 codec shared by every embedded server: spliced into a server's
# source at its __RESP_COMMON__ marker (build_src). Pure functions —
# no imports, safe to place after the server's import block.
RESP_COMMON_SRC = r'''
def read_resp(rf):
    line = rf.readline()
    if not line:
        return None
    if line[:1] != b"*":
        raise ValueError("expected RESP array, got %r" % line[:16])
    out = []
    for _ in range(int(line[1:].strip())):
        hdr = rf.readline()
        if hdr[:1] != b"$":
            raise ValueError("expected bulk string, got %r" % hdr[:16])
        n = int(hdr[1:].strip())
        body = rf.read(n + 2)
        if len(body) < n + 2:
            raise ValueError("short bulk read")
        out.append(body[:n].decode())
    return out

def enc_cmd(args_):
    out = [b"*%d\r\n" % len(args_)]
    for a in args_:
        b = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)

def bulk(s):
    b = s.encode()
    return b"$%d\r\n%s\r\n" % (len(b), b)
'''


def build_src(template: str) -> str:
    """Splice the shared codec into a server-source template at its
    __RESP_COMMON__ marker."""
    assert "__RESP_COMMON__" in template
    return template.replace("__RESP_COMMON__", RESP_COMMON_SRC)


class MiniServerDB(jdb.DB, jdb.Process, jdb.Pause, jdb.LogFiles):
    """Shared install + daemon lifecycle for an embedded python3
    server (the toykv upload pattern, nemesis/time.clj:20-39 analog):
    subclasses set `script`/`src`/`pidfile`/`logfile`/`data_files`
    and implement `port()` (+ optionally `extra_args()`)."""

    script: str
    src: str
    pidfile: str
    logfile: str
    data_files: tuple = ()

    def port(self, test, node) -> int:
        raise NotImplementedError

    def extra_args(self, test, node) -> list:
        return []

    def _start(self, test, node):
        nodeutil.start_daemon(
            {"logfile": self.logfile, "pidfile": self.pidfile,
             "exec": "/usr/bin/python3",
             "chdir": control.lit("$PWD")},
            "/usr/bin/python3", self.script,
            "--port", str(self.port(test, node)),
            *self.extra_args(test, node))
        # generous: on a loaded CI machine a python server's
        # interpreter start alone can take tens of seconds, and a
        # too-short wait crashes the nemesis heal path mid-test
        nodeutil.await_tcp_port(self.port(test, node), timeout_s=90)

    def _grepkill(self, test, node):
        nodeutil.grepkill(f"{self.script} --port "
                          f"{self.port(test, node)}")

    def setup(self, test, node):
        # defensively kill any orphan from a crashed previous run —
        # it would hold the port with stale state
        self._grepkill(test, node)
        control.exec_("bash", "-c",
                      f"cat > {self.script} <<'MINISERVER_EOF'\n"
                      f"{self.src}\nMINISERVER_EOF")
        if self.data_files:
            control.exec_("rm", "-f", *self.data_files)
        self._start(test, node)

    def teardown(self, test, node):
        nodeutil.stop_daemon(self.pidfile)
        self._grepkill(test, node)
        control.exec_("rm", "-f", *self.data_files, self.script)

    # -- db.Process (kill/restart faults) --
    def start(self, test, node):
        self._start(test, node)
        return "started"

    def kill(self, test, node):
        nodeutil.stop_daemon(self.pidfile)
        self._grepkill(test, node)
        return "killed"

    # -- db.Pause (SIGSTOP/SIGCONT faults) --
    def pause(self, test, node):
        control.exec_("bash", "-c",
                      f"kill -STOP $(cat {self.pidfile})")
        return "paused"

    def resume(self, test, node):
        control.exec_("bash", "-c",
                      f"kill -CONT $(cat {self.pidfile})")
        return "resumed"

    def log_files(self, test, node):
        return [self.logfile]
