"""NativeSSHRemote — the second, independent SSH transport.

Implements the `Remote` protocol (control/core.py) directly over the
from-scratch SSH-2 engine (control/sshwire.py): no ssh binary, no ssh
library. Selectable via ``ssh={"remote": "native", ...}`` or by
constructing it explicitly; shares the retry/reconnect wrappers like
every other remote (the reference's second stack, sshj, plugs into
jepsen the same way — control/sshj.clj:107-181).

One TCP connection per Remote; each execute/upload/download opens a
fresh session channel on it (SSH multiplexing, RFC 4254). Uploads and
downloads ride exec'd `cat` — capability-equivalent to the scp
subsystem with far less protocol surface, and the reference itself
falls back to plain-exec tactics when scp misbehaves.

The port's copy of `jepsen_tpu/control/sshnative.py`.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional

from . import sshwire as w
from .core import Remote

DEFAULT_PORT = 22


class NativeSSHRemote(Remote):
    def __init__(self, conn_spec: Optional[dict] = None):
        self.spec = conn_spec or {}
        self.ep: Optional[w.SshEndpoint] = None
        self.host_key: Optional[bytes] = None
        self._chan_seq = 0

    # -- Remote protocol ----------------------------------------------------
    def connect(self, conn_spec: dict) -> "NativeSSHRemote":
        r = NativeSSHRemote(conn_spec)
        r._connect()
        return r

    def _connect(self):
        spec = self.spec
        host = spec.get("host") or spec.get("hostname")
        port = int(spec.get("port") or DEFAULT_PORT)
        timeout = float(spec.get("connect_timeout") or 10.0)
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(float(spec.get("timeout") or 30.0))
        ep = w.SshEndpoint(sock)
        try:
            pinned = spec.get("hostkey")  # raw 32B ed25519, optional
            self.host_key = w.client_handshake(ep, pinned)
            self._auth(ep)
        except Exception:
            ep.close()
            raise
        self.ep = ep

    def _auth(self, ep: w.SshEndpoint):
        user = (self.spec.get("username") or "root").encode()
        password = self.spec.get("password")
        ep.send_packet(bytes([w.MSG_SERVICE_REQUEST])
                       + w.put_string(b"ssh-userauth"))
        ep.recv_msg(w.MSG_SERVICE_ACCEPT)
        # probe with "none" (some rigs allow it); else password
        ep.send_packet(bytes([w.MSG_USERAUTH_REQUEST])
                       + w.put_string(user)
                       + w.put_string(b"ssh-connection")
                       + w.put_string(b"none"))
        t, _ = self._recv_auth(ep)
        if t == w.MSG_USERAUTH_SUCCESS:
            return
        if password is None:
            raise w.SshError("auth: none rejected and no password set")
        ep.send_packet(bytes([w.MSG_USERAUTH_REQUEST])
                       + w.put_string(user)
                       + w.put_string(b"ssh-connection")
                       + w.put_string(b"password") + b"\x00"
                       + w.put_string(password.encode()))
        t, _ = self._recv_auth(ep)
        if t != w.MSG_USERAUTH_SUCCESS:
            raise w.SshError("auth: password rejected")

    @staticmethod
    def _recv_auth(ep: w.SshEndpoint):
        while True:
            t, c = ep.recv_msg()
            if t == w.MSG_USERAUTH_BANNER:
                continue
            if t in (w.MSG_USERAUTH_SUCCESS, w.MSG_USERAUTH_FAILURE):
                return t, c
            raise w.SshError(f"unexpected auth message {t}")

    def disconnect(self) -> None:
        if self.ep is not None:
            try:
                self.ep.send_packet(
                    bytes([w.MSG_DISCONNECT])
                    + b"\x00\x00\x00\x0b"  # SSH_DISCONNECT_BY_APPLICATION
                    + w.put_string(b"bye") + w.put_string(b""))
            except OSError:
                pass
            self.ep.close()
            self.ep = None

    # -- session channels ---------------------------------------------------
    def _exec(self, cmd: str, stdin: bytes = b"",
              raw: bool = False) -> dict:
        """One exec channel: returns {"exit", "out", "err"}; with
        raw=True, "out" stays bytes (byte-faithful downloads)."""
        ep = self.ep
        if ep is None:
            raise w.SshError("not connected")
        my_id = self._chan_seq
        self._chan_seq += 1
        ep.send_packet(bytes([w.MSG_CHANNEL_OPEN])
                       + w.put_string(b"session")
                       + struct.pack(">III", my_id, 0x7FFFFFFF, 32768))
        t, c = ep.recv_msg(w.MSG_CHANNEL_OPEN_CONFIRMATION,
                           w.MSG_CHANNEL_OPEN_FAILURE)
        if t == w.MSG_CHANNEL_OPEN_FAILURE:
            c.uint32()
            c.uint32()
            raise w.SshError(f"channel open failed: "
                             f"{c.string().decode()!r}")
        c.uint32()  # our id echoed
        their_id = c.uint32()
        their_window = c.uint32()
        their_maxpkt = max(1024, min(c.uint32() or 32768, 32768))

        ep.send_packet(bytes([w.MSG_CHANNEL_REQUEST])
                       + struct.pack(">I", their_id)
                       + w.put_string(b"exec") + b"\x01"
                       + w.put_string(cmd.encode()))

        out, err = [], []
        exit_status = None
        sent_stdin = False
        eof_sent = False
        closed = False
        pending = stdin

        def try_send_stdin():
            nonlocal pending, their_window, eof_sent, sent_stdin
            while pending and their_window > 0:
                chunk = pending[:min(their_maxpkt, their_window)]
                pending = pending[len(chunk):]
                their_window -= len(chunk)
                ep.send_packet(bytes([w.MSG_CHANNEL_DATA])
                               + struct.pack(">I", their_id)
                               + w.put_string(chunk))
            if not pending and not eof_sent:
                ep.send_packet(bytes([w.MSG_CHANNEL_EOF])
                               + struct.pack(">I", their_id))
                eof_sent = True

        while not closed:
            t, c = ep.recv_msg()
            if t == w.MSG_GLOBAL_REQUEST:
                # e.g. OpenSSH's hostkeys-00@openssh.com right after
                # auth: refuse politely when a reply is wanted, never
                # treat as fatal (stock sshd sends these by default)
                c.string()
                if c.boolean():
                    ep.send_packet(bytes([w.MSG_REQUEST_FAILURE]))
                continue
            if t in (w.MSG_REQUEST_SUCCESS, w.MSG_REQUEST_FAILURE):
                continue
            if t == w.MSG_CHANNEL_SUCCESS:
                # exec accepted: ship stdin now
                if not sent_stdin:
                    sent_stdin = True
                    try_send_stdin()
            elif t == w.MSG_CHANNEL_FAILURE:
                raise w.SshError(f"exec rejected: {cmd!r}")
            elif t == w.MSG_CHANNEL_WINDOW_ADJUST:
                c.uint32()
                their_window += c.uint32()
                if sent_stdin:
                    try_send_stdin()
            elif t == w.MSG_CHANNEL_DATA:
                c.uint32()
                out.append(c.string())
            elif t == w.MSG_CHANNEL_EXTENDED_DATA:
                c.uint32()
                c.uint32()  # data type (1 = stderr)
                err.append(c.string())
            elif t == w.MSG_CHANNEL_REQUEST:
                c.uint32()
                rtype = c.string()
                c.boolean()
                if rtype == b"exit-status":
                    exit_status = c.uint32()
            elif t == w.MSG_CHANNEL_EOF:
                pass
            elif t == w.MSG_CHANNEL_CLOSE:
                ep.send_packet(bytes([w.MSG_CHANNEL_CLOSE])
                               + struct.pack(">I", their_id))
                closed = True
            else:
                raise w.SshError(f"unexpected channel message {t}")
        out_b = b"".join(out)
        return {"exit": exit_status if exit_status is not None else -1,
                "out": out_b if raw else out_b.decode(errors="replace"),
                "err": b"".join(err).decode(errors="replace")}

    # -- Remote operations --------------------------------------------------
    def execute(self, context: dict, action: dict) -> dict:
        res = self._exec(action["cmd"],
                         stdin=(action.get("in") or "").encode())
        return {**action, **res}

    def upload(self, context: dict, local_paths, remote_path,
               opts: Optional[dict] = None) -> None:
        import os
        from .core import escape
        if isinstance(local_paths, (str, bytes)):
            local_paths = [local_paths]
        # scp semantics: several sources mean remote_path is a
        # DIRECTORY (each file lands under its basename); one source
        # writes remote_path itself
        many = len(local_paths) > 1
        for lp in local_paths:
            with open(lp, "rb") as f:
                data = f.read()
            dest = (f"{remote_path}/{os.path.basename(str(lp))}"
                    if many else str(remote_path))
            res = self._exec(f"cat > {escape(dest)}", stdin=data)
            if res["exit"] != 0:
                raise w.SshError(
                    f"upload to {dest!r} failed: {res['err']}")

    def download(self, context: dict, remote_paths, local_path,
                 opts: Optional[dict] = None) -> None:
        import os
        from .core import escape
        if isinstance(remote_paths, (str, bytes)):
            remote_paths = [remote_paths]
        for rp in remote_paths:
            # byte-faithful: logs/AOFs aren't UTF-8; decode-replace
            # here would silently corrupt them
            res = self._exec(f"cat {escape(str(rp))}", raw=True)
            if res["exit"] != 0:
                raise w.SshError(
                    f"download of {rp!r} failed: {res['err']}")
            dest = local_path
            if os.path.isdir(local_path):
                dest = os.path.join(local_path,
                                    os.path.basename(str(rp)))
            with open(dest, "wb") as f:
                f.write(res["out"])


def remote() -> NativeSSHRemote:
    return NativeSSHRemote()
