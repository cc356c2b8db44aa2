"""Node-side admin toolkit: daemons, downloads, archives, tmp files.

Capability parity with jepsen.control.util
(`jepsen/src/jepsen/control/util.clj`): await-tcp-port (:14), file
predicates (:32-61), tmp-file!/tmp-dir! (:63-87), write-file! (:88),
wget!/cached-wget! (:113-198), install-archive! (:199-276),
grepkill! (:286-308), start-daemon!/stop-daemon! via start-stop-daemon
(:310-386), daemon-running? (:386-397), signal! (:399-403).

All functions run against the currently bound control session.

The port's copy of `jepsen_tpu/control/nodeutil.py`.
"""

from __future__ import annotations

import logging
import os
import time as _time
from typing import Optional, Sequence

from . import cd, exec_, exec_star, su
from .core import NonzeroExit, env as make_env, escape, lit

log = logging.getLogger("jepsen_tpu_torch.control.util")


def meh(f, *args, **kw):
    """Run f, returning None instead of raising (util.clj's meh)."""
    try:
        return f(*args, **kw)
    except Exception:  # noqa: BLE001
        return None


def await_tcp_port(port: int, host: str = "localhost",
                   timeout_s: float = 60, interval_s: float = 0.5) -> None:
    """Wait for a TCP port to open on the node (control/util.clj:14-30)."""
    deadline = _time.monotonic() + timeout_s
    while True:
        try:
            exec_("bash", "-c",
                  f"exec 3<>/dev/tcp/{host}/{port}")
            return
        except NonzeroExit:
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"port {host}:{port} did not open in {timeout_s}s")
            _time.sleep(interval_s)


def file_exists(path: str) -> bool:
    """exists? (control/util.clj:38-43)."""
    try:
        exec_("test", "-e", path)
        return True
    except NonzeroExit:
        return False


def is_file(path: str) -> bool:
    try:
        exec_("test", "-f", path)
        return True
    except NonzeroExit:
        return False


def ls(dir: str = ".") -> list:
    """ls (control/util.clj:45-51)."""
    out = exec_("ls", dir)
    return [l for l in out.split("\n") if l]


def ls_full(dir: str) -> list:
    d = dir if dir.endswith("/") else dir + "/"
    return [d + f for f in ls(d)]


def tmp_file(ext: str = "") -> str:
    """Create a fresh random remote file (control/util.clj:63-76)."""
    suffix = f" --suffix={escape(ext)}" if ext else ""
    return exec_star(f"mktemp /tmp/jepsen-tmp-XXXXXX{suffix}")


def tmp_dir() -> str:
    """Create a fresh random remote directory (control/util.clj:78-86)."""
    return exec_star("mktemp -d /tmp/jepsen-tmp-XXXXXX")


def write_file(content: str, path: str) -> str:
    """Write a string to a remote file (control/util.clj:88-111)."""
    from . import upload_text
    upload_text(content, path)
    return path


def wget(url: str, dest: Optional[str] = None, force: bool = False) -> str:
    """Download a URL on the node (control/util.clj:133-160)."""
    filename = dest or url.split("/")[-1].split("?")[0]
    if force:
        meh(exec_, "rm", "-f", filename)
    if not file_exists(filename):
        exec_("wget", "-O", filename, url)
    return filename


CACHE_DIR = "/tmp/jepsen/cache"


def cached_wget(url: str, force: bool = False) -> str:
    """Download with a node-local cache keyed by URL
    (control/util.clj:167-198)."""
    import hashlib
    key = hashlib.sha256(url.encode()).hexdigest()[:32]
    path = f"{CACHE_DIR}/{key}"
    if force:
        meh(exec_, "rm", "-f", path)
    if not file_exists(path):
        exec_("mkdir", "-p", CACHE_DIR)
        tmp = tmp_file()
        exec_("wget", "-O", tmp, url)
        exec_("mv", tmp, path)
    return path


def install_archive(url: str, dest: str, force: bool = False,
                    user: Optional[str] = None) -> str:
    """Download and extract a tarball/zip to dest
    (control/util.clj:199-276). file:// URLs are used as-is."""
    local = url[len("file://"):] if url.startswith("file://") \
        else cached_wget(url, force=force)
    exec_("rm", "-rf", dest)
    exec_("mkdir", "-p", dest)
    tmp = tmp_dir()
    try:
        if url.rstrip("/").endswith(".zip"):
            exec_("unzip", local, "-d", tmp)
        else:
            exec_("tar", "--no-same-owner", "--no-same-permissions",
                  "--extract", "--file", local, "--directory", tmp)
        entries = ls(tmp)
        if len(entries) == 1 and not is_file(f"{tmp}/{entries[0]}"):
            # single top-level directory: move its contents
            src = f"{tmp}/{entries[0]}"
        else:
            # flat archive (possibly a single file): move everything
            src = tmp
        # Move contents into dest; dotfiles may legitimately be absent.
        exec_star(f"mv {escape(src)}/* {escape(dest)}/")
        exec_star(f"mv {escape(src)}/.[!.]* {escape(dest)}/ "
                  "2>/dev/null || true")
        if user:
            exec_("chown", "-R", user, dest)
    finally:
        meh(exec_, "rm", "-rf", tmp)
    return dest


def grepkill(pattern: str, signal: str = "9") -> None:
    """Kill all processes matching a pattern (control/util.clj:286-308).
    Deliberately NOT pkill -f: the remote bash/sudo wrapper's own command
    line contains the pattern and would signal itself (the reference uses
    ps | grep -v grep for exactly this reason)."""
    # $$ exclusion: the wrapping shell's own command line contains the
    # pattern (fatal under the localexec remote, where bash -c IS the
    # node process; merely cosmetic over SSH)
    meh(exec_star,
        f"ps -ef | grep {escape(pattern)} | grep -v grep "
        f"| awk -v self=$$ '$2 != self {{print $2}}' "
        f"| xargs --no-run-if-empty kill -s {escape(str(signal))}")


def signal(process_name: str, sig: str) -> str:
    """Send a signal to a named process by COMM field
    (control/util.clj:399-403). pkill without -f matches only the
    process name, so the shell wrapper is safe."""
    meh(exec_, "pkill", "--signal", str(sig), process_name)
    return "signaled"


def start_daemon(opts: dict, bin: str, *args) -> str:
    """Start a daemon under start-stop-daemon, logging to opts["logfile"]
    (control/util.clj:310-368). Returns "started" or "already-running"."""
    e = make_env(opts.get("env"))
    logfile = opts["logfile"]
    ssd = ["start-stop-daemon", "--start"]
    if opts.get("background?", True):
        ssd += ["--background", "--no-close"]
    if opts.get("pidfile") and opts.get("make-pidfile?", True):
        ssd += ["--make-pidfile"]
    if opts.get("match-executable?", True):
        ssd += ["--exec", opts.get("exec", bin)]
    if opts.get("match-process-name?", False):
        ssd += ["--name", opts.get("process-name", os.path.basename(bin))]
    if opts.get("pidfile"):
        ssd += ["--pidfile", opts["pidfile"]]
    if opts.get("chdir"):
        ssd += ["--chdir", opts["chdir"]]
    ssd += ["--startas", bin, "--", *args]
    log.info("Starting %s", os.path.basename(bin))
    exec_("echo", lit("`date +'%Y-%m-%d %H:%M:%S'`"),
          f"Jepsen starting {escape(e)} {bin} {escape(list(args))}",
          lit(">>"), logfile)
    try:
        prefix = [e] if e else []
        exec_(*prefix, *ssd, lit(">>"), logfile, lit("2>&1"))
        return "started"
    except NonzeroExit as err:
        if err.result.get("exit") == 1:
            return "already-running"
        raise


def stop_daemon(cmd_or_pidfile: str, pidfile: Optional[str] = None) -> None:
    """Kill a daemon by pidfile, or by command name + pidfile
    (control/util.clj:369-385)."""
    if pidfile is None:
        pf = cmd_or_pidfile
        if file_exists(pf):
            log.info("Stopping %s", pf)
            # the pidfile may vanish between the check and the read (a
            # concurrent nemesis kill + teardown, both stopping)
            pid = (meh(exec_, "cat", pf) or "").strip()
            if pid:
                meh(exec_, "kill", "-9", pid)
                meh(exec_, "rm", "-rf", pf)
            elif not file_exists(pf):
                pass  # vanished mid-race: the other stopper owns it
            else:
                # cat failed while the file still exists (transient
                # remote error?) — leave the pidfile so a later stop
                # can still find the daemon
                log.warning("could not read %s; daemon may still be "
                            "running", pf)
    else:
        log.info("Stopping %s", cmd_or_pidfile)
        meh(exec_, "killall", "-9", "-w", cmd_or_pidfile)
        if pidfile:
            meh(exec_, "rm", "-rf", pidfile)


def daemon_running(pidfile: str):
    """True/False/None per control/util.clj:386-397."""
    pid = meh(exec_, "cat", pidfile)
    if pid is None or pid == "":
        return None
    try:
        exec_("ps", "-o", "pid=", "-p", pid.strip())
        return True
    except NonzeroExit:
        return False
