"""A from-scratch SSH-2 wire engine (client AND server halves).

The reference ships two complete SSH stacks (clj-ssh and sshj, with an
scp fallback) because SSH transport flakiness is its top operational
pain (jepsen/src/jepsen/control/sshj.clj:70-79 works around an sshj
EOF bug; SURVEY "hard parts" #5). This package's first transport is
the OpenSSH CLI (control/sshcli.py); this module is the INDEPENDENT
second stack — the same discipline as the pgwire/BSON/RESP/AMQP
codecs: the protocol itself, implemented from the RFCs on
`cryptography` primitives, with no ssh binary or library involved.

Scope (deliberately one strong cipher suite, not a menu):
  * transport (RFC 4253): version exchange, binary packet protocol,
    curve25519-sha256 key exchange (RFC 8731), ssh-ed25519 host keys,
    aes128-ctr encryption with hmac-sha2-256 integrity;
  * userauth (RFC 4252): password (and "none" probing);
  * connection (RFC 4254): session channels, exec requests, stdin
    streaming, stdout/stderr demux, exit-status, window accounting.

`SshEndpoint` carries the shared packet/crypto state machine;
`client_handshake` / `server_handshake` drive the asymmetric halves.
The client-side Remote lives in control/sshnative.py; the loopback
test server in control/minisshd.py.

The port's copy of `jepsen_tpu/control/sshwire.py`; its version line
(`VERSION`) names the port.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import socket
import struct
from typing import Optional

from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey, Ed25519PublicKey)
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey, X25519PublicKey)
from cryptography.hazmat.primitives.ciphers import (Cipher, algorithms,
                                                    modes)

VERSION = b"SSH-2.0-jepsen_tpu_torch_0.1"

# message numbers (RFC 4250)
MSG_DISCONNECT = 1
MSG_IGNORE = 2
MSG_UNIMPLEMENTED = 3
MSG_DEBUG = 4
MSG_SERVICE_REQUEST = 5
MSG_SERVICE_ACCEPT = 6
MSG_KEXINIT = 20
MSG_NEWKEYS = 21
MSG_KEX_ECDH_INIT = 30
MSG_KEX_ECDH_REPLY = 31
MSG_USERAUTH_REQUEST = 50
MSG_USERAUTH_FAILURE = 51
MSG_USERAUTH_SUCCESS = 52
MSG_USERAUTH_BANNER = 53
MSG_GLOBAL_REQUEST = 80
MSG_REQUEST_SUCCESS = 81
MSG_REQUEST_FAILURE = 82
MSG_CHANNEL_OPEN = 90
MSG_CHANNEL_OPEN_CONFIRMATION = 91
MSG_CHANNEL_OPEN_FAILURE = 92
MSG_CHANNEL_WINDOW_ADJUST = 93
MSG_CHANNEL_DATA = 94
MSG_CHANNEL_EXTENDED_DATA = 95
MSG_CHANNEL_EOF = 96
MSG_CHANNEL_CLOSE = 97
MSG_CHANNEL_REQUEST = 98
MSG_CHANNEL_SUCCESS = 99
MSG_CHANNEL_FAILURE = 100

KEX_ALG = b"curve25519-sha256"
HOSTKEY_ALG = b"ssh-ed25519"
CIPHER_ALG = b"aes128-ctr"
MAC_ALG = b"hmac-sha2-256"
COMP_ALG = b"none"


class SshError(Exception):
    pass


# -- primitive encoders (RFC 4251 §5) ---------------------------------------

def put_string(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


def put_mpint(n: int) -> bytes:
    if n == 0:
        return put_string(b"")
    b = n.to_bytes((n.bit_length() + 7) // 8, "big")
    if b[0] & 0x80:  # positive numbers need a leading zero bit
        b = b"\x00" + b
    return put_string(b)


def put_namelist(*names: bytes) -> bytes:
    return put_string(b",".join(names))


class Cursor:
    def __init__(self, b: bytes, i: int = 0):
        self.b = b
        self.i = i

    def byte(self) -> int:
        v = self.b[self.i]
        self.i += 1
        return v

    def boolean(self) -> bool:
        return self.byte() != 0

    def uint32(self) -> int:
        v = struct.unpack_from(">I", self.b, self.i)[0]
        self.i += 4
        return v

    def string(self) -> bytes:
        n = self.uint32()
        v = self.b[self.i:self.i + n]
        self.i += n
        return v

    def namelist(self) -> list:
        return self.string().split(b",")


# -- the shared endpoint ----------------------------------------------------

class SshEndpoint:
    """One side of an SSH-2 connection: packet framing, the
    aes128-ctr/hmac-sha2-256 state after NEWKEYS, and kex plumbing.
    `server` flips which derived-key halves encrypt vs decrypt."""

    def __init__(self, sock: socket.socket, server: bool = False):
        self.sock = sock
        self.rf = sock.makefile("rb")
        self.server = server
        self.seq_out = 0
        self.seq_in = 0
        self.enc = None       # outgoing cipher context
        self.dec = None       # incoming cipher context
        self.mac_out: Optional[bytes] = None
        self.mac_in: Optional[bytes] = None
        self.session_id: Optional[bytes] = None
        self.local_version = VERSION
        self.remote_version: Optional[bytes] = None

    # -- version exchange ---------------------------------------------------
    def exchange_versions(self):
        self.sock.sendall(self.local_version + b"\r\n")
        # the peer may send banner lines before its version string
        for _ in range(32):
            line = self.rf.readline(512)
            if not line:
                raise SshError("peer closed before version exchange")
            if line.startswith(b"SSH-"):
                self.remote_version = line.strip()
                if not line.startswith(b"SSH-2."):
                    raise SshError(
                        f"unsupported protocol {line.strip()!r}")
                return
        raise SshError("no SSH version line within 32 lines")

    # -- binary packet protocol (RFC 4253 §6) -------------------------------
    def send_packet(self, payload: bytes):
        block = 16 if self.enc is not None else 8
        # total (len field + padlen field + payload + padding) must be
        # a multiple of the block size, padding >= 4
        pad = block - ((5 + len(payload)) % block)
        if pad < 4:
            pad += block
        packet = (struct.pack(">IB", 1 + len(payload) + pad, pad)
                  + payload + os.urandom(pad))
        if self.enc is None:
            self.sock.sendall(packet)
        else:
            mac = _hmac.new(self.mac_out,
                            struct.pack(">I", self.seq_out) + packet,
                            hashlib.sha256).digest()
            self.sock.sendall(self.enc.update(packet) + mac)
        self.seq_out = (self.seq_out + 1) & 0xFFFFFFFF

    def _read_exact(self, n: int) -> bytes:
        b = self.rf.read(n)
        if b is None or len(b) < n:
            raise SshError("connection closed mid-packet")
        return b

    def recv_packet(self) -> bytes:
        if self.dec is None:
            head = self._read_exact(5)
            length, pad = struct.unpack(">IB", head)
            rest = self._read_exact(length - 1)
            payload = rest[:length - 1 - pad]
        else:
            first = self.dec.update(self._read_exact(16))
            length, pad = struct.unpack(">IB", first[:5])
            if length > 1 << 20:
                raise SshError(f"absurd packet length {length}")
            rest_ct = self._read_exact(4 + length - 16)
            rest = self.dec.update(rest_ct)
            packet = first + rest
            mac = self._read_exact(32)
            want = _hmac.new(self.mac_in,
                             struct.pack(">I", self.seq_in) + packet,
                             hashlib.sha256).digest()
            if not _hmac.compare_digest(mac, want):
                raise SshError("MAC verification failed")
            payload = packet[5:5 + length - 1 - pad]
        self.seq_in = (self.seq_in + 1) & 0xFFFFFFFF
        return payload

    def recv_msg(self, *want: int) -> tuple[int, Cursor]:
        """Next non-transport-noise message; asserts type if `want`."""
        while True:
            p = self.recv_packet()
            t = p[0]
            if t in (MSG_IGNORE, MSG_DEBUG):
                continue
            if t == MSG_UNIMPLEMENTED:
                raise SshError("peer: unimplemented")
            if t == MSG_DISCONNECT:
                c = Cursor(p, 1)
                c.uint32()
                raise SshError(
                    f"peer disconnected: {c.string().decode()!r}")
            if want and t not in want:
                raise SshError(f"expected msg {want}, got {t}")
            return t, Cursor(p, 1)

    # -- kex ----------------------------------------------------------------
    def kexinit_payload(self) -> bytes:
        return (bytes([MSG_KEXINIT]) + os.urandom(16)
                + put_namelist(KEX_ALG)
                + put_namelist(HOSTKEY_ALG)
                + put_namelist(CIPHER_ALG) + put_namelist(CIPHER_ALG)
                + put_namelist(MAC_ALG) + put_namelist(MAC_ALG)
                + put_namelist(COMP_ALG) + put_namelist(COMP_ALG)
                + put_namelist() + put_namelist()
                + b"\x00" + struct.pack(">I", 0))

    @staticmethod
    def check_kexinit(payload: bytes):
        """The peer must support our single suite (first-match rule)."""
        c = Cursor(payload, 1)
        c.i += 16  # cookie
        lists = [c.namelist() for _ in range(8)]
        for alg, offered in zip(
                (KEX_ALG, HOSTKEY_ALG, CIPHER_ALG, CIPHER_ALG,
                 MAC_ALG, MAC_ALG, COMP_ALG, COMP_ALG), lists):
            if alg not in offered:
                raise SshError(
                    f"peer doesn't offer {alg.decode()}: {offered}")

    def activate_keys(self, K: int, H: bytes):
        """Derive + switch on the cipher/MAC state (RFC 4253 §7.2)."""
        if self.session_id is None:
            self.session_id = H

        def kdf(x: bytes, size: int) -> bytes:
            base = put_mpint(K) + H
            out = hashlib.sha256(base + x + self.session_id).digest()
            while len(out) < size:
                out += hashlib.sha256(base + out).digest()
            return out[:size]

        iv_c2s = kdf(b"A", 16)
        iv_s2c = kdf(b"B", 16)
        key_c2s = kdf(b"C", 16)
        key_s2c = kdf(b"D", 16)
        mac_c2s = kdf(b"E", 32)
        mac_s2c = kdf(b"F", 32)
        mk_enc = lambda k, iv: Cipher(  # noqa: E731
            algorithms.AES(k), modes.CTR(iv)).encryptor()
        mk_dec = lambda k, iv: Cipher(  # noqa: E731
            algorithms.AES(k), modes.CTR(iv)).decryptor()
        if self.server:
            self.enc = mk_enc(key_s2c, iv_s2c)
            self.dec = mk_dec(key_c2s, iv_c2s)
            self.mac_out, self.mac_in = mac_s2c, mac_c2s
        else:
            self.enc = mk_enc(key_c2s, iv_c2s)
            self.dec = mk_dec(key_s2c, iv_s2c)
            self.mac_out, self.mac_in = mac_c2s, mac_s2c

    def close(self):
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


def exchange_hash(client_version: bytes, server_version: bytes,
                  client_kexinit: bytes, server_kexinit: bytes,
                  host_key_blob: bytes, q_c: bytes, q_s: bytes,
                  K: int) -> bytes:
    return hashlib.sha256(
        put_string(client_version) + put_string(server_version)
        + put_string(client_kexinit) + put_string(server_kexinit)
        + put_string(host_key_blob) + put_string(q_c)
        + put_string(q_s) + put_mpint(K)).digest()


def ed25519_blob(pub: Ed25519PublicKey) -> bytes:
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PublicFormat)
    raw = pub.public_bytes(Encoding.Raw, PublicFormat.Raw)
    return put_string(HOSTKEY_ALG) + put_string(raw)


def client_handshake(ep: SshEndpoint,
                     expected_hostkey: Optional[bytes] = None) -> bytes:
    """Version + kex + NEWKEYS from the client side. Returns the
    server's raw ed25519 host key (32 B) for trust-on-first-use /
    pinning by the caller."""
    ep.exchange_versions()
    my_kexinit = ep.kexinit_payload()
    ep.send_packet(my_kexinit)
    t, _ = ep.recv_msg(MSG_KEXINIT)
    their_kexinit = bytes([t]) + _.b[1:]
    ep.check_kexinit(their_kexinit)

    eph = X25519PrivateKey.generate()
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PublicFormat)
    q_c = eph.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
    ep.send_packet(bytes([MSG_KEX_ECDH_INIT]) + put_string(q_c))
    _, c = ep.recv_msg(MSG_KEX_ECDH_REPLY)
    host_blob = c.string()
    q_s = c.string()
    sig_blob = c.string()

    hb = Cursor(host_blob)
    if hb.string() != HOSTKEY_ALG:
        raise SshError("host key is not ssh-ed25519")
    host_raw = hb.string()
    if expected_hostkey is not None and host_raw != expected_hostkey:
        raise SshError("HOST KEY MISMATCH (possible MITM)")

    shared = eph.exchange(X25519PublicKey.from_public_bytes(q_s))
    K = int.from_bytes(shared, "big")
    H = exchange_hash(ep.local_version, ep.remote_version,
                      my_kexinit, their_kexinit, host_blob,
                      q_c, q_s, K)
    sb = Cursor(sig_blob)
    if sb.string() != HOSTKEY_ALG:
        raise SshError("signature is not ssh-ed25519")
    Ed25519PublicKey.from_public_bytes(host_raw).verify(
        sb.string(), H)  # raises InvalidSignature on tampering

    ep.send_packet(bytes([MSG_NEWKEYS]))
    ep.recv_msg(MSG_NEWKEYS)
    ep.activate_keys(K, H)
    return host_raw


def server_handshake(ep: SshEndpoint, host_key: Ed25519PrivateKey):
    """The mirror-image half for the loopback server."""
    ep.exchange_versions()
    my_kexinit = ep.kexinit_payload()
    ep.send_packet(my_kexinit)
    t, c = ep.recv_msg(MSG_KEXINIT)
    their_kexinit = bytes([t]) + c.b[1:]
    ep.check_kexinit(their_kexinit)

    _, c = ep.recv_msg(MSG_KEX_ECDH_INIT)
    q_c = c.string()
    eph = X25519PrivateKey.generate()
    from cryptography.hazmat.primitives.serialization import (
        Encoding, PublicFormat)
    q_s = eph.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
    shared = eph.exchange(X25519PublicKey.from_public_bytes(q_c))
    K = int.from_bytes(shared, "big")
    host_blob = ed25519_blob(host_key.public_key())
    # NB: client/server version+kexinit order in H is C then S
    H = exchange_hash(ep.remote_version, ep.local_version,
                      their_kexinit, my_kexinit, host_blob,
                      q_c, q_s, K)
    sig = host_key.sign(H)
    ep.send_packet(bytes([MSG_KEX_ECDH_REPLY]) + put_string(host_blob)
                   + put_string(q_s)
                   + put_string(put_string(HOSTKEY_ALG)
                                + put_string(sig)))
    ep.send_packet(bytes([MSG_NEWKEYS]))
    ep.recv_msg(MSG_NEWKEYS)
    ep.activate_keys(K, H)
