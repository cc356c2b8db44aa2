"""The port's robustirc suite (`jepsen_tpu_torch/dbs/robustirc.py`) held
against the JAX package: the twins of `tests/test_robustirc.py` (the
RFC-1459 parser, the RobustSession protocol against the live mini server:
session auth, ClientMessageId dedup, kill -9 durability, the
retransmit-across-restart exactly-once proof; the topic-set suite live; the
go automation through the dummy remote), and parity cases: the server's
source byte for byte, the parser on more lines, the go and mini-server
commands, the generated ops, what the session sends (its `X-Session-Auth`
header on each post and read, its message ids within one process), and
what the client makes of a refused, a reset and a timed-out connection and
of an error body that is not JSON (the fail / info split).

Also: the port's ports and store root are its own, and the suite, whose set
check runs on the host, takes no `--device`.
"""

import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

import pytest

import jepsen_tpu.control as ref_c
from jepsen_tpu import generator as ref_gen
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import robustirc as ref_ri
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu_torch import cli, core
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import httpclient
from jepsen_tpu_torch.dbs import robustirc as ri
from jepsen_tpu_torch.generator import testlib
from conftest import kill_and_wait
from test_torch_galera import dummy_log
from test_torch_httpclient import fault_url
from test_torch_logcabin import src_imports
from test_torch_sqlite import ephemeral_range

#: the twin fixture's server port, inside robustirc's block (32050-32099)
FIXTURE_PORT = 32090


# -- IRC grammar -------------------------------------------------------------

def test_parse_irc():
    assert ri.parse_irc("TOPIC #jepsen :42") == \
        (None, "TOPIC", ["#jepsen"], "42")
    assert ri.parse_irc(":nick!u@h TOPIC #jepsen :7\r\n") == \
        ("nick!u@h", "TOPIC", ["#jepsen"], "7")
    assert ri.parse_irc("JOIN #jepsen") == \
        (None, "JOIN", ["#jepsen"], None)
    assert ri.parse_irc("USER j j j j") == \
        (None, "USER", ["j", "j", "j", "j"], None)


def test_topic_value():
    assert ri.topic_value("TOPIC #jepsen :42") == 42
    assert ri.topic_value(":n!u@h TOPIC #jepsen :9") == 9
    assert ri.topic_value("TOPIC #other :5") is None
    assert ri.topic_value("PRIVMSG #jepsen :42") is None
    assert ri.topic_value("TOPIC #jepsen :not-an-int") is None


# -- live mini server --------------------------------------------------------

def _start(path, port):
    srv_py = path / "miniirc.py"
    if not srv_py.exists():
        srv_py.write_text(ri.MINIIRC_SRC)
    return subprocess.Popen(
        [sys.executable, str(srv_py), "--port", str(port),
         "--dir", str(path)], cwd=path)


def _session(port, deadline_s=10) -> ri.RobustSession:
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return ri.RobustSession(f"http://127.0.0.1:{port}",
                                    timeout=2)
        except httpclient.RequestException:
            assert time.monotonic() < deadline, "never up"
            time.sleep(0.1)


@pytest.fixture()
def mini(tmp_path):
    port = FIXTURE_PORT
    proc = _start(tmp_path, port)
    session = _session(port)
    yield session, port, tmp_path
    session.close()
    proc.kill()
    proc.wait(timeout=10)


def test_session_and_stream(mini):
    s, _, _ = mini
    s.post("NICK a")
    s.post("JOIN #jepsen")
    s.post("TOPIC #jepsen :1")
    msgs = s.read_all()
    assert [m["Data"] for m in msgs] == \
        ["NICK a", "JOIN #jepsen", "TOPIC #jepsen :1"]


def test_bad_auth_rejected(mini):
    s, port, _ = mini
    bad = ri.RobustSession(f"http://127.0.0.1:{port}", timeout=2)
    bad.auth = "wrong"
    with pytest.raises(httpclient.HTTPError):
        bad.post("NICK x", retries=0)
    with pytest.raises(httpclient.HTTPError, match="401"):
        bad.read_all()
    bad.close()


def test_client_message_id_dedup(mini):
    """The exactly-once heart: the same ClientMessageId posted twice
    lands ONCE."""
    s, _, _ = mini
    mid = s.new_message_id()
    s.post("TOPIC #jepsen :5", msg_id=mid)
    s.post("TOPIC #jepsen :5", msg_id=mid)   # retransmit
    topics = [m for m in s.read_all()
              if ri.topic_value(m["Data"]) == 5]
    assert len(topics) == 1


def test_retransmit_across_restart_exactly_once(mini, tmp_path):
    """A retransmit whose ORIGINAL landed before a kill -9 must not
    double-apply after the restart: SEEN_IDS is rebuilt from the
    fsync'd log."""
    s, port, path = mini
    mid = s.new_message_id()
    s.post("TOPIC #jepsen :77", msg_id=mid)
    kill_and_wait("miniirc.py", port)
    proc = _start(path, port)
    try:
        deadline = time.monotonic() + 10
        while True:
            try:
                # same session (persisted), same message id
                s.post("TOPIC #jepsen :77", msg_id=mid, retries=0)
                break
            except httpclient.RequestException:
                assert time.monotonic() < deadline, "never back"
                time.sleep(0.1)
        topics = [m for m in s.read_all()
                  if ri.topic_value(m["Data"]) == 77]
        assert len(topics) == 1  # survived AND deduplicated
    finally:
        proc.kill()
        proc.wait(timeout=10)


# -- full suite against LIVE mini servers ------------------------------------

def test_full_suite_live(tmp_path):
    done = core.run(ri.robustirc_test({
        "nodes": ["i1"], "concurrency": 4, "time_limit": 8,
        "nemesis_interval": 2.5,
        "store_root": str(tmp_path / "store"),
        "sandbox": str(tmp_path / "cluster")}))
    res = done["results"]
    assert res["valid?"] is True, res


# -- go automation -----------------------------------------------------------

def test_go_commands():
    log: list = []
    db = ri.RobustIrcDB()
    test = {"nodes": ["n1", "n2"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
    primary = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "golang-go" in primary
    assert "github.com/robustirc/robustirc" in primary
    assert "-singlenode" in primary       # the primary bootstraps
    log.clear()
    with c.with_remote(DummyRemote(log)):
        with c.on("n2"):
            db.setup(test, "n2")
    joiner = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "-join=n1:13001" in joiner     # others join the primary
    assert "-singlenode" not in joiner


# -- parity with the reference ------------------------------------------------

def test_constants_match_reference():
    for name in ("PORT", "CHANNEL", "NETWORK_PASSWORD"):
        assert getattr(ri, name) == getattr(ref_ri, name), name
    for name in ("script", "pidfile", "logfile", "data_files"):
        assert getattr(ri.MiniIrcDB, name) == \
            getattr(ref_ri.MiniIrcDB, name), name
    assert ri.RobustIrcDB.GOPATH == ref_ri.RobustIrcDB.GOPATH
    assert ri.IrcSetClient.retry_excs == (OSError,
                                          httpclient.RequestException)


def test_source_is_the_references_and_imports_neither_package():
    assert ri.MINIIRC_SRC == ref_ri.MINIIRC_SRC
    mods = src_imports(ri.MINIIRC_SRC)
    assert {"http", "json", "uuid"} <= mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


LINES = ["TOPIC #jepsen :42", ":nick!u@h TOPIC #jepsen :7\r\n",
         "JOIN #jepsen", "USER j j j j", "topic #jepsen :3",
         "TOPIC #jepsen", "TOPIC #jepsen :", "TOPIC #other :5",
         "PRIVMSG #jepsen :42", ":srv 332 me #jepsen :9",
         "TOPIC #jepsen :not-an-int", "TOPIC #jepsen : 12 ",
         ":only-prefix", "", "   ", "NICK a b :c d :e"]


@pytest.mark.parametrize("line", LINES)
def test_parser_matches_reference(line):
    def parsed(mod):
        try:
            return mod.parse_irc(line)
        except ValueError as e:
            return ("ValueError", str(e))
    assert parsed(ri) == parsed(ref_ri)
    assert ri.topic_value(line) == ref_ri.topic_value(line)


def test_go_commands_match_reference(monkeypatch):
    # the setup waits for the daemon's port: nothing listens here
    from jepsen_tpu.control import nodeutil as ref_nodeutil
    from jepsen_tpu_torch.control import nodeutil
    for m in (nodeutil, ref_nodeutil):
        monkeypatch.setattr(m, "await_tcp_port", lambda *a, **kw: None)

    def steps(mod):
        db = mod.RobustIrcDB()
        test = {"nodes": ["n1", "n2", "n3"]}
        return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
                for n in ("n1", "n3") for f in ("setup", "teardown")]
    assert dummy_log(c, DummyRemote, steps(ri)) == \
        dummy_log(ref_c, RefDummyRemote, steps(ref_ri))
    test = {"nodes": ["n1", "n2"]}
    assert ri.RobustIrcDB().log_files(test, "n1") == \
        ref_ri.RobustIrcDB().log_files(test, "n1")


def test_mini_db_commands_match_reference():
    """The mini server's lifecycle: the same commands on the same ports."""
    def steps(mod):
        db = mod.MiniIrcDB()
        test = {"nodes": ["i1", "i2"], "robustirc_ports": {"i1": 40000,
                                                           "i2": 40001}}
        return [("i2", (lambda f=f: getattr(db, f)(test, "i2")))
                for f in ("setup", "kill", "start", "pause", "resume",
                          "teardown")]
    assert dummy_log(c, DummyRemote, steps(ri)) == \
        dummy_log(ref_c, RefDummyRemote, steps(ref_ri))


def generated_ops(mod, g_mod, tl, n: int = 40) -> list:
    """The first `n` client invocations of the suite's test map (its
    generator seeded, every op completing ok at once): (process, f,
    value)."""
    g_mod.RNG.seed(28)
    test = mod.robustirc_test({"nodes": ["i1"], "concurrency": 4,
                               "time_limit": 8})
    return [(o["process"], o["f"], o.get("value"))
            for o in tl.simulate(g_mod.limit(n, g_mod.clients(
                test["generator"])), lambda ctx, inv: {**inv, "type": "ok"})
            if o["type"] == "invoke"]


def test_generated_ops_match_reference():
    got = generated_ops(ri, gen, testlib)
    assert got == generated_ops(ref_ri, ref_gen, ref_testlib)
    assert len(got) == 40 and {f for _, f, _ in got} <= {"add", "read"}


class Recorder(BaseHTTPRequestHandler):
    """The RobustSession endpoints, answering each with success and
    recording (method, path, X-Session-Auth, JSON body) in the server's
    `seen`."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _answer(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n)
        self.server.seen.append((self.command, self.path,
                                 self.headers.get("X-Session-Auth"),
                                 json.loads(body) if body else None))
        if self.path.endswith("/session"):
            out = json.dumps({"Sessionid": "sid1",
                              "Sessionauth": "auth1"}).encode()
        elif self.path.split("?")[0].endswith("/messages"):
            out = b'{"Data": "TOPIC #jepsen :4"}\n{"Data": "NICK a"}'
        else:
            out = b"{}"
        self.send_response(200)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    do_GET = do_POST = _answer


def test_session_sends_auth_as_the_reference_does():
    """Both sessions against one recording server: the same requests, each
    post and read carrying `X-Session-Auth` (the per-call header), the same
    message ids within this process, the same messages read back."""
    pytest.importorskip("requests")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), Recorder)
    srv.daemon_threads, srv.seen = True, []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    got = {}
    try:
        for mod in (ri, ref_ri):
            srv.seen.clear()
            s = mod.RobustSession(f"http://127.0.0.1:{srv.server_port}",
                                  timeout=2)
            s.post("NICK a")
            s.post("TOPIC #jepsen :4", msg_id=17)
            msgs = s.read_all()
            s.close()
            got[mod] = (list(srv.seen), msgs, s.new_message_id())
    finally:
        srv.shutdown()
        srv.server_close()
    assert got[ri] == got[ref_ri]
    seen, msgs, _ = got[ri]
    assert [a for _, _, a, _ in seen] == [None, "auth1", "auth1", "auth1"]
    assert seen[-1][1] == "/robustirc/v1/sid1/messages?lastseen=0.0"
    assert seen[2][3] == {"Data": "TOPIC #jepsen :4", "ClientMessageId": 17}
    assert msgs == [{"Data": "TOPIC #jepsen :4"}, {"Data": "NICK a"}]


OPS = [("add", 3), ("read", None)]
FAULTS = ("refused", "reset", "timeout", "http-500")


def fault_completions(mod, base: str) -> list:
    """The set client's completions on a session against `base` (a
    `fault_url`): (type, value, whether an error was given, whether the
    client still holds the session). The session is made as
    `RobustSession` makes it, less its create-session request, which a
    faulty server would fail."""
    import requests
    addr = urlsplit(base)
    cl = mod.IrcSetClient(port_fn=lambda test, node: (
        addr.hostname, addr.port), timeout=0.3).open({}, "i1")
    out = []
    for f, v in OPS:
        s = object.__new__(mod.RobustSession)
        s.base, s.timeout, s.sid, s.auth, s._next_id = \
            base, 0.3, "sid1", "auth1", 0
        s.http = (httpclient.Session() if mod is ri else requests.Session())
        cl.conn = s
        done = cl.invoke({"nodes": ["i1"]}, {"type": "invoke", "f": f,
                                             "value": v, "process": 0})
        out.append((done["type"], done.get("value"),
                    bool(done.get("error")), cl.conn is s))
    return out


@pytest.mark.parametrize("fault", FAULTS)
def test_client_faults_classified_as_reference(fault):
    """The port's client (on `httpclient`) and the reference's (on
    `requests`) against the same fault: equal completions; the read
    fails, the add goes indefinite, and the session is dropped."""
    pytest.importorskip("requests")
    with fault_url(fault) as base:
        got = fault_completions(ri, base)
        assert got == fault_completions(ref_ri, base)
    assert [(t, err, held) for t, _, err, held in got] == \
        [("info", True, False), ("fail", True, False)]


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert ri.MINI_BASE_PORT == 32050
    assert ri.MINI_BASE_PORT != ref_ri.MINI_BASE_PORT
    # below the ephemeral range, clear of the reference's bases
    # (21850-30680), with room for five nodes and the twin fixture
    lo, _ = ephemeral_range()
    assert 30680 < ri.MINI_BASE_PORT and ri.MINI_BASE_PORT + 50 <= lo
    assert ri.MINI_BASE_PORT + 5 <= FIXTURE_PORT < ri.MINI_BASE_PORT + 50
    test = {"nodes": ["i1", "i2"]}
    assert [ri.mini_node_port(test, n) for n in test["nodes"]] == \
        [ri.MINI_BASE_PORT, ri.MINI_BASE_PORT + 1]
    assert ri.mini_node_port({**test, "robustirc_ports": {"i2": 4000}},
                             "i2") == 4000
    t = ri.robustirc_test({"nodes": ["i1", "i2"], "concurrency": 2,
                           "store_root": str(tmp_path / "store")})
    assert t["store_root"] == str(tmp_path / "store")
    assert t["db"].port(t, "i2") == ri.MINI_BASE_PORT + 1
    # every worker drives the primary's server
    assert t["client"].port_fn(t, "i2") == ("127.0.0.1", ri.MINI_BASE_PORT)
    t = ri.robustirc_test({"nodes": ["i1"], "concurrency": 2})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["name"] == "robustirc-set-mini"


def test_no_device_option():
    """The set check runs on the host: the suite's options have no
    `--device`, and it needs no card."""
    assert "device" not in {o.name for o in ri.ROBUSTIRC_OPTS}
    assert not hasattr(ri, "DEVICE_WORKLOADS")
    assert cli.main({**ri.COMMANDS}, ["test", "--nodes", "i1", "--device",
                                      "cpu"]) == 254
