"""The port's control plane against the JAX package's: the shell
algebra, the dummy remote's log for the same actions, `bound_fn`
carrying the calling thread's bindings into worker threads, `on_nodes` /
`on_many`, `RetryRemote` over a scripted remote, the reconnect wrapper,
`with_ssh({"dummy?": True})`, and `named_remote`: "cli" and "native"
as the reference's, each a retry remote over its stack.
"""

import threading

import pytest

import jepsen_tpu.control as ref_c
import jepsen_tpu.control.dummy as ref_dummy
import jepsen_tpu.control.retry as ref_retry
from jepsen_tpu import reconnect as ref_reconnect
from jepsen_tpu.control import core as ref_core
import jepsen_tpu_torch.control as port_c
import jepsen_tpu_torch.control.dummy as port_dummy
import jepsen_tpu_torch.control.retry as port_retry
from jepsen_tpu_torch import reconnect as port_reconnect
from jepsen_tpu_torch.control import core as port_core

PKGS = {"ref": (ref_c, ref_dummy, ref_retry, ref_core),
        "port": (port_c, port_dummy, port_retry, port_core)}


@pytest.mark.parametrize("arg", [
    "foo", 123, None, "", "hello world", "a$b", 'say "hi"', "semi;colon",
    "back\\slash", ["a", "b c"], ("x", 1)], ids=repr)
def test_escape_matches_reference(arg):
    assert port_core.escape(arg) == ref_core.escape(arg)
    assert port_core.escape(port_core.lit("a | b")) == "a | b"


@pytest.mark.parametrize("ctx", [{}, {"sudo": "root"},
                                 {"sudo": "root", "sudo_password": "pw"}])
def test_wrap_sudo_and_env_match_reference(ctx):
    a = {"cmd": "whoami"}
    assert port_core.wrap_sudo(ctx, a) == ref_core.wrap_sudo(ctx, a)
    e = {"HOME": "/root", "X": "a b"}
    assert port_core.env(e).string == ref_core.env(e).string


def _script(pkg):
    """One session's actions through the DSL; returns the dummy's log."""
    c, dummy, _, _ = PKGS[pkg]
    log = []
    with c.with_remote(dummy.remote(log)):
        with c.on("n1"):
            c.exec_("echo", "hi there")
            with c.cd("/tmp"):
                with c.cd("sub"):
                    c.exec_("ls", "-l")
            with c.su():
                c.exec_star("cat", "/etc/hosts", "|", "wc")
            c.upload(["a", "b"], "/remote")
            c.download("/remote/f", "/local")
        c.on_many(["n2", "n3"], lambda: c.exec_("hostname"))
    return sorted(log, key=repr)


def test_dummy_remote_log_matches_reference():
    got, want = _script("port"), _script("ref")
    assert got == want
    assert ("n1", 'cd /; echo "hi there"') in got
    assert ("n1", "cd /tmp/sub; ls -l") in got


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_bound_fn_carries_bindings_into_threads(pkg):
    c, dummy, _, _ = PKGS[pkg]
    seen = {}
    r = dummy.remote()
    with c.with_remote(r), c.with_ssh({"dummy?": True, "username": "u"}):
        with c.cd("/work"):
            def f(tag):
                seen[tag] = (c.state.remote is r, c.state.dummy,
                             c.state.username, c.state.dir)
            bound = c.bound_fn(f)
    unbound = threading.Thread(target=f, args=("plain",))
    t = threading.Thread(target=bound, args=("bound",))
    for th in (unbound, t):
        th.start()
        th.join()
    assert seen["bound"] == (True, True, "u", "/work")
    assert seen["plain"] == (False, False, "root", "/")


def test_on_nodes_uses_test_sessions():
    for pkg in PKGS:
        c, dummy, _, _ = PKGS[pkg]
        log = []
        r = dummy.remote(log)
        nodes = ["a", "b", "c"]
        test = {"nodes": nodes,
                "sessions": {n: r.connect({"host": n}) for n in nodes}}
        res = c.on_nodes(test, lambda t, n: (n.upper(), c.state.host,
                                             c.exec_("true")))
        assert res == {n: (n.upper(), n, "") for n in nodes}
        assert sorted(log) == [(n, "cd /; true") for n in nodes]
        assert c.on_nodes(test, lambda t, n: n, ["b"]) == {"b": "b"}


def test_no_session_raises():
    with pytest.raises(port_c.NoSessionError):
        port_c.exec_("ls")


def test_with_ssh_dummy_flag():
    with port_c.with_ssh({"dummy?": True}):
        with port_c.on("nowhere"):
            assert port_c.exec_("anything") == ""
        assert isinstance(port_c.session("n1"), port_dummy.DummyRemote)


def _flaky_remote(dummy, fail_connects, fail_execs, events):
    class Flaky(dummy.DummyRemote):
        def connect(self, spec):
            events.append("connect")
            if fail_connects:
                fail_connects.pop()
                raise OSError("refused")
            return super().connect(spec)

        def disconnect(self):
            events.append("disconnect")

        def execute(self, context, action):
            if fail_execs:
                fail_execs.pop()
                raise OSError("reset")
            return super().execute(context, action)
    return Flaky()


@pytest.mark.parametrize("connects,execs", [(0, 0), (2, 0), (0, 2),
                                            (1, 3)])
def test_retry_remote_matches_reference(monkeypatch, connects, execs):
    out = {}
    for pkg in PKGS:
        c, dummy, retry, _ = PKGS[pkg]
        monkeypatch.setattr(retry, "BACKOFF_S", 0.0)
        events = []
        r = retry.remote(_flaky_remote(dummy, [1] * connects, [1] * execs,
                                       events))
        s = r.connect({"host": "n1"})
        res = s.execute({}, {"cmd": "true"})
        s.disconnect()
        out[pkg] = (events, res["exit"], res["out"])
    assert out["port"] == out["ref"]
    assert out["port"][0].count("connect") == connects + 1 + min(execs, 4)


def test_retry_remote_gives_up(monkeypatch):
    monkeypatch.setattr(port_retry, "BACKOFF_S", 0.0)
    r = port_retry.remote(_flaky_remote(port_dummy, [], [1] * 10, []))
    s = r.connect({"host": "n1"})
    with pytest.raises(OSError, match="reset"):
        s.execute({}, {"cmd": "true"})


def test_reconnect_wrapper_matches_reference():
    for mod in (ref_reconnect, port_reconnect):
        opens = []

        class Conn:
            def __init__(self, i):
                self.i = i
                self.dead = i == 0

        def open_fn():
            opens.append(Conn(len(opens)))
            return opens[-1]

        def use(conn):
            if conn.dead:
                raise IOError("wedged")
            return conn.i

        w = mod.wrapper(open_fn)
        assert w.with_retry(use, retries=2) == 1
        assert len(opens) == 2
        results = []
        ts = [threading.Thread(target=lambda: results.append(
            w.with_conn(lambda c: c is not None))) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert results == [True] * 8


def test_named_remote():
    assert isinstance(port_c.named_remote("cli"), port_retry.RetryRemote)
    from jepsen_tpu_torch.control import sshnative as port_sshnative
    native = port_c.named_remote("native")
    assert isinstance(native, port_retry.RetryRemote)
    assert isinstance(native.inner, port_sshnative.NativeSSHRemote)
    assert type(ref_c.named_remote("native").inner).__name__ == \
        type(native.inner).__name__
    with pytest.raises(ValueError, match="unknown remote"):
        port_c.named_remote("telnet")
    with port_c.with_ssh({"remote": "native"}):
        assert isinstance(port_c.state.remote, port_retry.RetryRemote)
        assert isinstance(port_c.state.remote.inner,
                          port_sshnative.NativeSSHRemote)
