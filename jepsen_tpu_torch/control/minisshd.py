"""A loopback SSH-2 server for exercising the native transport.

The from-scratch client (control/sshnative.py) needs no sshd and no
ssh binary to be tested: it is tested the way the mini DB servers test
their suites, against an in-repo server speaking
the same RFC subset through the SAME wire engine's server half
(control/sshwire.py server_handshake). Binds 127.0.0.1 only, requires
the per-instance random password, and executes commands via bash in a
caller-chosen working directory — a real remote-execution surface for
the control-plane tests, not a mock.

The port's copy of `jepsen_tpu/control/minisshd.py`.
"""

from __future__ import annotations

import secrets
import socket
import struct
import subprocess
import threading
from typing import Optional

from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey)
from cryptography.hazmat.primitives.serialization import (Encoding,
                                                          PublicFormat)

from . import sshwire as w


class MiniSshd:
    def __init__(self, cwd: str = ".", password: Optional[str] = None,
                 user: str = "jepsen"):
        self.cwd = cwd
        self.user = user
        self.password = password or secrets.token_hex(12)
        self.host_key = Ed25519PrivateKey.generate()
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)

    @property
    def host_key_raw(self) -> bytes:
        return self.host_key.public_key().public_bytes(
            Encoding.Raw, PublicFormat.Raw)

    def start(self) -> "MiniSshd":
        self.thread.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._session, args=(conn,),
                             daemon=True).start()

    def _session(self, conn: socket.socket):
        conn.settimeout(60)
        ep = w.SshEndpoint(conn, server=True)
        try:
            w.server_handshake(ep, self.host_key)
            self._userauth(ep)
            self._connection(ep)
        except (w.SshError, OSError, ValueError):
            pass
        finally:
            ep.close()

    def _userauth(self, ep: w.SshEndpoint):
        _, c = ep.recv_msg(w.MSG_SERVICE_REQUEST)
        if c.string() != b"ssh-userauth":
            raise w.SshError("expected ssh-userauth")
        ep.send_packet(bytes([w.MSG_SERVICE_ACCEPT])
                       + w.put_string(b"ssh-userauth"))
        for _ in range(8):
            _, c = ep.recv_msg(w.MSG_USERAUTH_REQUEST)
            user = c.string().decode()
            c.string()  # service
            method = c.string()
            if method == b"password":
                c.boolean()
                pw = c.string().decode()
                if user == self.user and pw == self.password:
                    ep.send_packet(bytes([w.MSG_USERAUTH_SUCCESS]))
                    return
            ep.send_packet(bytes([w.MSG_USERAUTH_FAILURE])
                           + w.put_namelist(b"password") + b"\x00")
        raise w.SshError("too many auth attempts")

    def _connection(self, ep: w.SshEndpoint):
        """Serve session channels until the peer disconnects.
        Channels are handled one at a time (the client multiplexes
        sequentially), each: exec request -> buffer stdin to EOF ->
        run -> stream stdout/stderr -> exit-status -> close."""
        while True:
            t, c = ep.recv_msg()
            if t != w.MSG_CHANNEL_OPEN:
                continue  # global requests etc.: ignore
            ctype = c.string()
            their_id = c.uint32()
            c.uint32()  # their window (we send small frames anyway)
            c.uint32()
            if ctype != b"session":
                ep.send_packet(bytes([w.MSG_CHANNEL_OPEN_FAILURE])
                               + struct.pack(">II", their_id, 3)
                               + w.put_string(b"unsupported")
                               + w.put_string(b""))
                continue
            my_id = 0
            ep.send_packet(bytes([w.MSG_CHANNEL_OPEN_CONFIRMATION])
                           + struct.pack(">IIII", their_id, my_id,
                                         0x7FFFFFFF, 32768))
            self._channel(ep, their_id)

    def _channel(self, ep: w.SshEndpoint, their_id: int):
        cmd: Optional[str] = None
        stdin: list = []
        got_eof = False
        sent_close = False
        while True:
            t, c = ep.recv_msg()
            if t == w.MSG_CHANNEL_REQUEST:
                c.uint32()
                rtype = c.string()
                want_reply = c.boolean()
                if rtype == b"exec":
                    cmd = c.string().decode()
                    if want_reply:
                        ep.send_packet(bytes([w.MSG_CHANNEL_SUCCESS])
                                       + struct.pack(">I", their_id))
                elif want_reply:
                    ep.send_packet(bytes([w.MSG_CHANNEL_FAILURE])
                                   + struct.pack(">I", their_id))
            elif t == w.MSG_CHANNEL_DATA:
                c.uint32()
                stdin.append(c.string())
            elif t == w.MSG_CHANNEL_EOF:
                got_eof = True
            elif t == w.MSG_CHANNEL_CLOSE:
                # CLOSE is sent at most once per side (RFC 4254 §5.3);
                # _run already closed our half after exit-status — a
                # second CLOSE here would poison the NEXT channel
                if not sent_close:
                    ep.send_packet(bytes([w.MSG_CHANNEL_CLOSE])
                                   + struct.pack(">I", their_id))
                return
            if cmd is not None and got_eof:
                self._run(ep, their_id, cmd, b"".join(stdin))
                cmd = None  # wait for the peer's CLOSE
                sent_close = True

    def _run(self, ep: w.SshEndpoint, their_id: int, cmd: str,
             stdin: bytes):
        try:
            p = subprocess.run(["bash", "-c", cmd], input=stdin,
                               capture_output=True, cwd=self.cwd,
                               timeout=120)
            out, err, code = p.stdout, p.stderr, p.returncode
        except subprocess.TimeoutExpired:
            out, err, code = b"", b"command timed out\n", 124
        for i in range(0, len(out), 32000):
            ep.send_packet(bytes([w.MSG_CHANNEL_DATA])
                           + struct.pack(">I", their_id)
                           + w.put_string(out[i:i + 32000]))
        for i in range(0, len(err), 32000):
            ep.send_packet(bytes([w.MSG_CHANNEL_EXTENDED_DATA])
                           + struct.pack(">II", their_id, 1)
                           + w.put_string(err[i:i + 32000]))
        ep.send_packet(bytes([w.MSG_CHANNEL_REQUEST])
                       + struct.pack(">I", their_id)
                       + w.put_string(b"exit-status") + b"\x00"
                       + struct.pack(">I", code & 0xFFFFFFFF))
        ep.send_packet(bytes([w.MSG_CHANNEL_EOF])
                       + struct.pack(">I", their_id))
        ep.send_packet(bytes([w.MSG_CHANNEL_CLOSE])
                       + struct.pack(">I", their_id))
