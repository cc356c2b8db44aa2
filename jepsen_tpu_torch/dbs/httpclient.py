"""A small HTTP/1.1 client on the standard library's `http.client`, for
the suites that speak HTTP (etcd's v3 JSON gateway, consul's v1/kv,
elasticsearch's document API, chronos, dgraph's JSON transactions,
fauna's expression queries, robustirc's RobustSession protocol).

The reference's clients use `requests`, which the card's machine does
not have; this module stands in for the part of it they use, on both
machines:

- `Session`: one keep-alive connection per host, made when first used
  and made again after the server closed it (checked before each reuse,
  as `requests`' pool does; a request is never sent twice); `get`,
  `put`, `post`, `delete` and `request` with `params` (a query string),
  `data` (a raw body), `json` (a JSON body), `headers` and a `timeout`
  in seconds.
- Caller headers, merged as `requests.Session` merges them: the
  session's `headers` dict goes with every request of the session, a
  call's `headers=` over it (names compared without case; the call's
  value wins, and a name whose merged value is None is not sent). The
  client's own `Accept: */*` and `Connection: keep-alive` lie beneath
  both, and a JSON body's `Content-Type: application/json` is set where
  the merged headers have none.
- `Response`: `status_code`, `reason`, `headers`, `content`, `text`,
  `ok`, `json()` and `raise_for_status()`.
- `RequestException`, raised for what `requests` would raise: a
  refused or reset connection, a host that does not resolve, a reply
  that `http.client` cannot read (`ConnectionError`), a timeout
  (`Timeout`), a 4xx or 5xx reply on
  `raise_for_status()` (`HTTPError`, with `requests`' message) and a
  body that is not JSON on `json()` (`JSONDecodeError`).
- `get`, `put`, `post`, `delete` at module level: one request on a
  session of its own.

Redirects are not followed, and no body is compressed: no suite's
server sends either.
"""

from __future__ import annotations

import http.client
import json as _json
import select
import socket
from typing import Optional
from urllib.parse import urlencode, urlsplit

_REASONS = {c.value: c.phrase for c in http.HTTPStatus}


class RequestException(IOError):
    """Any failure of a request (`requests.RequestException`)."""


class ConnectionError(RequestException):  # noqa: A001 — requests' name
    """The connection could not be made, or broke."""


class Timeout(RequestException):
    """The server did not answer within the timeout."""


class HTTPError(RequestException):
    """A 4xx or 5xx reply, raised by `Response.raise_for_status`."""

    def __init__(self, msg: str, response: "Response"):
        super().__init__(msg)
        self.response = response


class JSONDecodeError(RequestException, ValueError):
    """A body that is not JSON, raised by `Response.json`."""


class Response:
    """One reply, read in full."""

    def __init__(self, url: str, status: int, reason: str, headers: dict,
                 content: bytes):
        self.url = url
        self.status_code = status
        self.reason = reason or _REASONS.get(status, "")
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    @property
    def ok(self) -> bool:
        return self.status_code < 400

    def json(self):
        try:
            return _json.loads(self.content)
        except ValueError as e:
            raise JSONDecodeError(f"{e} (body {self.text[:100]!r})") \
                from None

    def raise_for_status(self) -> None:
        if 400 <= self.status_code < 500:
            kind = "Client Error"
        elif 500 <= self.status_code < 600:
            kind = "Server Error"
        else:
            return
        raise HTTPError(f"{self.status_code} {kind}: {self.reason} for "
                        f"url: {self.url}", self)

    def __repr__(self):
        return f"<Response [{self.status_code}]>"


def _dropped(conn: http.client.HTTPConnection) -> bool:
    """True when the server has closed (or written to) an idle
    connection: its socket reads ready."""
    if conn.sock is None:
        return False
    try:
        return bool(select.select([conn.sock], [], [], 0)[0])
    except (OSError, ValueError):
        return True


#: the client's own headers, beneath the session's and the call's
DEFAULT_HEADERS = {"Accept": "*/*", "Connection": "keep-alive"}


def merge_headers(*layers: Optional[dict]) -> dict:
    """The headers of `layers`, each over the ones before it: names
    compared without case (a later layer's spelling and value win, in
    the place the name first took), and a name whose last value is None
    dropped."""
    out: dict = {}
    for layer in layers:
        for k, v in (layer or {}).items():
            out[k.lower()] = (k, v)
    return {k: v for k, v in out.values() if v is not None}


class Session:
    """Keep-alive connections, one per (host, port); for one thread.
    `headers` goes with every request."""

    def __init__(self):
        self._conns: dict = {}
        self.headers: dict = {}

    def request(self, method: str, url: str, params: Optional[dict] = None,
                data=None, json=None, headers: Optional[dict] = None,
                timeout: Optional[float] = None) -> Response:
        parts = urlsplit(url)
        if parts.scheme != "http" or not parts.hostname:
            raise RequestException(f"unsupported URL {url!r}")
        path = parts.path or "/"
        query = parts.query
        if params:
            extra = urlencode([(k, "" if v is None else v)
                               for k, v in params.items()])
            query = f"{query}&{extra}" if query else extra
        target = f"{path}?{query}" if query else path
        hdrs = merge_headers(DEFAULT_HEADERS, self.headers, headers)
        body = None
        if json is not None:
            body = _json.dumps(json, allow_nan=False).encode()
            if not any(k.lower() == "content-type" for k in hdrs):
                hdrs["Content-Type"] = "application/json"
        elif data is not None:
            body = data.encode() if isinstance(data, str) else bytes(data)
        key = (parts.hostname, parts.port or 80)
        conn = self._conns.get(key)
        if conn is not None and _dropped(conn):
            conn.close()
            conn = None
        if conn is None:
            conn = http.client.HTTPConnection(*key, timeout=timeout)
            self._conns[key] = conn
        else:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
        full = parts._replace(query=query, fragment="").geturl()
        try:
            conn.request(method, target, body=body, headers=hdrs)
            resp = conn.getresponse()
            content = resp.read()
        except (socket.timeout, TimeoutError) as e:
            self._drop(key)
            raise Timeout(f"{method} {full}: timed out ({e})") from None
        except (OSError, http.client.HTTPException) as e:
            # `requests` raises a malformed or cut reply as a
            # ConnectionError too
            self._drop(key)
            raise ConnectionError(
                f"{method} {full}: {type(e).__name__}: {e}") from None
        if resp.will_close:
            self._drop(key)
        return Response(full, resp.status, resp.reason,
                        dict(resp.getheaders()), content)

    def _drop(self, key) -> None:
        conn = self._conns.pop(key, None)
        if conn is not None:
            conn.close()

    def get(self, url, **kw) -> Response:
        return self.request("GET", url, **kw)

    def put(self, url, **kw) -> Response:
        return self.request("PUT", url, **kw)

    def post(self, url, **kw) -> Response:
        return self.request("POST", url, **kw)

    def delete(self, url, **kw) -> Response:
        return self.request("DELETE", url, **kw)

    def close(self) -> None:
        for key in list(self._conns):
            self._drop(key)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def request(method: str, url: str, **kw) -> Response:
    """One request on a session of its own."""
    with Session() as s:
        return s.request(method, url, **kw)


def get(url, **kw) -> Response:
    return request("GET", url, **kw)


def put(url, **kw) -> Response:
    return request("PUT", url, **kw)


def post(url, **kw) -> Response:
    return request("POST", url, **kw)


def delete(url, **kw) -> Response:
    return request("DELETE", url, **kw)
