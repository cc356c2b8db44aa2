"""The port's HTTP client (`jepsen_tpu_torch/dbs/httpclient.py`), which
stands in for `requests` in the suites that speak HTTP: held against
`requests` itself where the sandbox has it (the request a server sees,
the replies' fields, `raise_for_status`' message, the exceptions'
classes), the caller headers (a session's `headers` and a call's
`headers=`, merged as `requests.Session` merges them), and its keep-alive
session: one connection reused, a new one after the server closed it, no
request sent twice.
"""

import contextlib
import json
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from jepsen_tpu_torch.dbs import httpclient


class Echo(BaseHTTPRequestHandler):
    """Answers each request with what it saw, as JSON; the path picks
    the status (`/status/404`), `/close` closes the connection after the
    reply, `/text` answers a body that is not JSON, `/headers` adds the
    request's headers to the answer (names in lower case)."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _answer(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n)
        self.server.seen.append((self.command, self.path, body,
                                 self.client_address[1]))
        if self.path.startswith("/text"):
            out = b"not json"
        else:
            out = json.dumps({
                "method": self.command, "path": self.path,
                "body": body.decode(),
                "type": self.headers.get("Content-Type"),
                **({"headers": {k.lower(): v
                                for k, v in self.headers.items()}}
                   if self.path.startswith("/headers") else {})}).encode()
        code = (int(self.path.split("/")[2])
                if self.path.startswith("/status/") else 200)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        if self.path.startswith("/close"):
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(out)

    do_GET = do_PUT = do_POST = do_DELETE = _answer


@pytest.fixture()
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), Echo)
    srv.daemon_threads = True
    srv.seen = []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()
    srv.server_close()


def url(srv, path="/"):
    return f"http://127.0.0.1:{srv.server_port}{path}"


CALLS = [
    ("get", "/v1/kv/k", dict(params={"consistent": "", "cas": 3})),
    ("put", "/v1/kv/k?x=1", dict(data="42", params={"cas": 7})),
    ("post", "/v3/kv/txn", dict(json={"compare": [], "n": 1})),
    ("delete", "/jepsen", {}),
]


@pytest.mark.parametrize("method,path,kw", CALLS)
def test_requests_seen_as_requests_sends_them(server, method, path, kw):
    requests = pytest.importorskip("requests")
    got = getattr(httpclient, method)(url(server, path), timeout=2, **kw)
    want = getattr(requests, method)(url(server, path), timeout=2, **kw)
    assert [s[:3] for s in server.seen[-2:-1]] == \
        [s[:3] for s in server.seen[-1:]]
    assert got.json() == want.json()
    assert (got.status_code, got.ok, got.text, got.url) == \
        (want.status_code, want.ok, want.text, want.url)


# (a session's headers, a call's, the call): requests' merge of the two,
# names compared without case, the call's value winning and None dropping
# a name, the client's own Accept and a JSON body's Content-Type beneath
HEADER_CASES = {
    "session": ({"Authorization": "Basic c2VjcmV0Og=="}, None, "post"),
    "call": ({}, {"X-Session-Auth": "abc"}, "get"),
    "both": ({"X-A": "1"}, {"X-B": "2"}, "post"),
    "override": ({"X-Session-Auth": "old", "X-A": "1"},
                 {"x-session-auth": "new"}, "get"),
    "call-drops": ({"X-A": "1", "X-B": "2"}, {"X-A": None}, "put"),
    "session-drops": ({"X-A": None, "Accept": None}, {"X-B": "2"}, "get"),
    "accept": ({}, {"Accept": "application/json"}, "get"),
    "content-type": ({}, {"Content-Type": "application/vnd.x+json"}, "post"),
    "session-content-type": ({"content-type": "text/plain"}, None, "post"),
}


def seen_headers(resp, names_set: set) -> dict:
    """The headers the server saw, but for the ones that `requests` adds
    of its own and the port does not (`User-Agent`, and `Accept-Encoding`,
    which `http.client` sends as "identity"), unless the case sets them."""
    own = {"user-agent", "accept-encoding"} - names_set
    return {k: v for k, v in resp.json()["headers"].items() if k not in own}


@pytest.mark.parametrize("case", sorted(HEADER_CASES))
def test_caller_headers_as_requests(server, case):
    requests = pytest.importorskip("requests")
    sess_hdrs, call_hdrs, method = HEADER_CASES[case]
    names_set = {k.lower() for k in {**sess_hdrs, **(call_hdrs or {})}}
    kw = dict(json={"v": 1}) if method == "post" else {}
    seen = []
    for s in (httpclient.Session(), requests.Session()):
        with s:
            s.headers.update(sess_hdrs)
            r = getattr(s, method)(url(server, "/headers"),
                                   headers=call_hdrs, timeout=2, **kw)
            # the session's headers go with its next request too, the
            # call's do not
            again = s.get(url(server, "/headers"), timeout=2)
            seen.append((seen_headers(r, names_set),
                         seen_headers(again, names_set)))
    assert seen[0] == seen[1]
    got, again = seen[0]

    def merged(*layers):
        return {k.lower(): v for k, v in httpclient.merge_headers(
            httpclient.DEFAULT_HEADERS, *layers).items()}

    # each name the case or the client sets, as the merge has it (a name
    # dropped: not sent); the next request without the call's headers
    want, base = merged(sess_hdrs, call_hdrs), merged(sess_hdrs)
    for k in names_set | {"accept", "connection"}:
        assert got.get(k) == want.get(k), k
        assert again.get(k) == base.get(k), k


def test_merge_headers():
    got = httpclient.merge_headers(
        httpclient.DEFAULT_HEADERS, {"authorization": "a", "X-A": "1"},
        {"Authorization": "b", "X-A": None, "Accept": None})
    assert got == {"Connection": "keep-alive", "Authorization": "b"}
    assert httpclient.merge_headers(None, {}) == {}
    # a name keeps the place it first took
    assert list(got) == ["Connection", "Authorization"]


def test_module_level_call_sends_headers(server):
    got = httpclient.get(url(server, "/headers"), headers={"X-A": "1"},
                         timeout=2).json()["headers"]
    assert got["x-a"] == "1" and got["accept"] == "*/*"


@pytest.mark.parametrize("code", (200, 201, 404, 500, 503))
def test_status_and_raise_for_status_as_requests(server, code):
    requests = pytest.importorskip("requests")
    got = httpclient.get(url(server, f"/status/{code}"), timeout=2)
    want = requests.get(url(server, f"/status/{code}"), timeout=2)
    assert (got.status_code, got.ok, got.reason) == \
        (want.status_code, want.ok, want.reason)
    errs = []
    for r, exc in ((got, httpclient.HTTPError),
                   (want, requests.HTTPError)):
        try:
            r.raise_for_status()
            errs.append(None)
        except exc as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == (code < 400)


def test_failures_are_request_exceptions(server):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}/"
    with pytest.raises(httpclient.ConnectionError):
        httpclient.get(dead, timeout=1)
    with pytest.raises(httpclient.JSONDecodeError):
        httpclient.get(url(server, "/text"), timeout=2).json()
    with pytest.raises(httpclient.RequestException):
        httpclient.get("ftp://127.0.0.1/", timeout=1)
    assert issubclass(httpclient.Timeout, httpclient.RequestException)
    assert issubclass(httpclient.RequestException, IOError)

    with fault_url("timeout") as base, pytest.raises(httpclient.Timeout):
        httpclient.get(base, timeout=0.2)


def test_session_keeps_one_connection_and_reconnects(server):
    with httpclient.Session() as s:
        for _ in range(3):
            assert s.get(url(server, "/a"), timeout=2).ok
        ports = {p for *_, p in server.seen}
        assert len(ports) == 1        # one keep-alive connection
        assert s.get(url(server, "/close"), timeout=2).ok
        assert s.post(url(server, "/b"), json={"v": 1}, timeout=2).ok
        # the server closed the first connection: the next request went
        # on a new one, and each request reached the server once
        assert len({p for *_, p in server.seen}) == 2
        assert [m for m, *_ in server.seen] == ["GET"] * 4 + ["POST"]


class Faulty(BaseHTTPRequestHandler):
    """Never answers (a paused server) when the server's `fault` is
    "timeout", else answers 500."""

    def log_message(self, *a):
        pass

    def _fail(self):
        if self.server.fault == "timeout":
            self.server.release.wait(10)
        else:
            self.send_error(500)

    do_GET = do_PUT = do_POST = do_DELETE = _fail


@contextlib.contextmanager
def resetting_server():
    """The port of a server that reads each request and closes its
    connection with a reset (SO_LINGER 0)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            with conn:
                conn.settimeout(2)
                try:
                    conn.recv(65536)
                except OSError:
                    pass
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                struct.pack("ii", 1, 0))

    threading.Thread(target=serve, daemon=True).start()
    try:
        yield srv.getsockname()[1]
    finally:
        srv.close()


@contextlib.contextmanager
def fault_url(fault: str):
    """The base URL of a server that fails as `fault` says: "refused"
    (nothing listens there), "reset" (it reads the request and resets the
    connection), "timeout" (it never answers) or "http-500" (its body an
    HTML page, not JSON). The suites' twin tests use it."""
    if fault == "refused":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        yield f"http://127.0.0.1:{port}"
        return
    if fault == "reset":
        with resetting_server() as port:
            yield f"http://127.0.0.1:{port}"
        return
    srv = ThreadingHTTPServer(("127.0.0.1", 0), Faulty)
    srv.daemon_threads = True
    srv.fault, srv.release = fault, threading.Event()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}"
    finally:
        srv.release.set()
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("fault,exc", (
    ("refused", httpclient.ConnectionError),
    ("reset", httpclient.ConnectionError),
    ("timeout", httpclient.Timeout),
    ("http-500", httpclient.HTTPError)))
def test_fault_servers_fail_as_named(fault, exc):
    with fault_url(fault) as base, pytest.raises(exc):
        httpclient.post(base + "/x", json={}, timeout=0.3) \
            .raise_for_status()
