"""The port's SSH-2 stack (`jepsen_tpu_torch/control/sshwire.py`,
`sshnative.py`, `minisshd.py`) held against the JAX package's.

Wire units: the encoders, `Cursor`, `exchange_hash`, the host-key blob
and the kexinit payload are byte-equal to `jepsen_tpu.control.sshwire`'s
on inputs made from a seed. Packets cross a `socketpair` between a port
endpoint and a reference endpoint keyed with the same K and H, both
ways, plaintext and encrypted, and a flipped ciphertext bit fails the
MAC on either side. Interop: each client remote against each loopback
server (the port's against the reference's and back, and the port's
against its own): exec with stdout, stderr, stdin and exit codes, large
output, several channels on one connection, upload and download, a bad
password and the host-key pin. Last, the port's control facade over
`with_ssh({"remote": "native"})`.
"""

import os
import random
import socket
import struct
import threading

import pytest

from jepsen_tpu.control import minisshd as ref_minisshd
from jepsen_tpu.control import sshnative as ref_sshnative
from jepsen_tpu.control import sshwire as ref_w
from jepsen_tpu_torch import control as port_c
from jepsen_tpu_torch.control import minisshd as port_minisshd
from jepsen_tpu_torch.control import retry as port_retry
from jepsen_tpu_torch.control import sshnative as port_sshnative
from jepsen_tpu_torch.control import sshwire as port_w

from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey)

SEEDS = (0, 1, 2, 3)


def _blobs(rng: random.Random, n: int = 24) -> list:
    return [rng.randbytes(rng.choice((0, 1, 5, 31, 32, 33, 255, 4096)))
            for _ in range(n)]


def _ints(rng: random.Random, n: int = 48) -> list:
    out = [0, 1, 0x7F, 0x80, 0xFF, 0x100, (1 << 255) - 1, 1 << 255]
    out += [rng.getrandbits(rng.choice((1, 7, 8, 9, 63, 64, 255, 256,
                                        1024))) for _ in range(n)]
    return out


# -- wire units ---------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_encoders_are_byte_equal(seed):
    rng = random.Random(seed)
    for b in _blobs(rng):
        assert port_w.put_string(b) == ref_w.put_string(b)
    for n in _ints(rng):
        assert port_w.put_mpint(n) == ref_w.put_mpint(n), n
    names = [rng.randbytes(rng.randrange(1, 12)).replace(b",", b".")
             for _ in range(6)]
    for k in range(len(names) + 1):
        assert port_w.put_namelist(*names[:k]) == \
            ref_w.put_namelist(*names[:k])


@pytest.mark.parametrize("seed", SEEDS)
def test_cursor_reads_as_the_reference(seed):
    rng = random.Random(seed)
    fields = []
    buf = b""
    for _ in range(40):
        kind = rng.choice(("byte", "boolean", "uint32", "string",
                           "namelist"))
        if kind in ("byte", "boolean"):
            buf += bytes([rng.randrange(256)])
        elif kind == "uint32":
            buf += struct.pack(">I", rng.getrandbits(32))
        elif kind == "string":
            buf += ref_w.put_string(rng.randbytes(rng.randrange(40)))
        else:
            buf += ref_w.put_namelist(*[b"alg%d" % rng.randrange(99)
                                        for _ in range(rng.randrange(1, 5))])
        fields.append(kind)
    pc, rc = port_w.Cursor(buf), ref_w.Cursor(buf)
    for kind in fields:
        assert getattr(pc, kind)() == getattr(rc, kind)()
        assert pc.i == rc.i
    assert pc.i == len(buf)


@pytest.mark.parametrize("seed", SEEDS)
def test_exchange_hash_is_byte_equal(seed):
    rng = random.Random(seed)
    for _ in range(8):
        args = [rng.randbytes(rng.randrange(4, 200)) for _ in range(7)]
        K = rng.getrandbits(256)
        assert port_w.exchange_hash(*args, K) == ref_w.exchange_hash(*args, K)


@pytest.mark.parametrize("seed", SEEDS)
def test_kexinit_payload_and_host_blob_are_byte_equal(seed, monkeypatch):
    rng = random.Random(seed)
    cookie = rng.randbytes(16)
    # the kexinit cookie is the payload's only random field
    monkeypatch.setattr(os, "urandom", lambda n: cookie[:n])
    a, b = socket.socketpair()
    try:
        pp = port_w.SshEndpoint(a).kexinit_payload()
        rp = ref_w.SshEndpoint(b).kexinit_payload()
    finally:
        a.close()
        b.close()
    assert pp == rp
    port_w.SshEndpoint.check_kexinit(rp)
    ref_w.SshEndpoint.check_kexinit(pp)
    key = Ed25519PrivateKey.from_private_bytes(rng.randbytes(32))
    assert port_w.ed25519_blob(key.public_key()) == \
        ref_w.ed25519_blob(key.public_key())


def test_kexinit_without_the_suite_is_refused():
    bad = (bytes([port_w.MSG_KEXINIT]) + b"\x00" * 16
           + port_w.put_namelist(b"diffie-hellman-group1-sha1")
           + b"".join(port_w.put_namelist(port_w.HOSTKEY_ALG)
                      for _ in range(7)) + b"\x00" + b"\x00" * 4)
    for w in (port_w, ref_w):
        with pytest.raises(w.SshError, match="curve25519"):
            w.SshEndpoint.check_kexinit(bad)


def _pair(port_is_client: bool):
    a, b = socket.socketpair()
    cw, sw = (port_w, ref_w) if port_is_client else (ref_w, port_w)
    return cw.SshEndpoint(a), sw.SshEndpoint(b, server=True), a, b


@pytest.mark.parametrize("port_is_client", [True, False],
                         ids=["port-client", "port-server"])
def test_packets_cross_between_the_packages(port_is_client):
    client, server, a, b = _pair(port_is_client)
    try:
        client.send_packet(b"\x02hello")
        assert server.recv_packet() == b"\x02hello"
        server.send_packet(b"\x02back")
        assert client.recv_packet() == b"\x02back"
        K, H = random.Random(9).getrandbits(256), b"H" * 32
        client.activate_keys(K, H)
        server.activate_keys(K, H)
        for n in (0, 1, 15, 16, 17, 5000, 40000):
            msg = b"\x5a" + random.Random(n).randbytes(n)
            client.send_packet(msg)
            assert server.recv_packet() == msg
            server.send_packet(msg[::-1])
            assert client.recv_packet() == msg[::-1]
        assert (client.seq_out, client.seq_in) == (server.seq_in,
                                                   server.seq_out)
    finally:
        a.close()
        b.close()


class _Capture:
    def __init__(self):
        self.buf = bytearray()

    def sendall(self, data):
        self.buf.extend(data)


@pytest.mark.parametrize("port_is_client", [True, False],
                         ids=["port-sends", "reference-sends"])
def test_mac_tamper_detected_across_the_packages(port_is_client):
    client, server, a, b = _pair(port_is_client)
    try:
        K, H = 999, b"x" * 32
        client.activate_keys(K, H)
        server.activate_keys(K, H)
        cap = _Capture()
        client.sock = cap
        client.send_packet(b"\x5evictim")
        cap.buf[8] ^= 0x01
        a.sendall(bytes(cap.buf))
        err = ref_w.SshError if port_is_client else port_w.SshError
        with pytest.raises(err, match="MAC"):
            server.recv_packet()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("port_is_client", [True, False],
                         ids=["port-client", "port-server"])
def test_handshake_across_the_packages(port_is_client):
    """client_handshake against server_handshake over a socketpair: both
    sides derive one session id, then talk encrypted."""
    client, server, a, b = _pair(port_is_client)
    sw = ref_w if port_is_client else port_w
    cw = port_w if port_is_client else ref_w
    key = Ed25519PrivateKey.generate()
    errors = []

    def serve():
        try:
            sw.server_handshake(server, key)
            server.send_packet(server.recv_packet())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        raw = cw.client_handshake(client, None)
        client.send_packet(b"\x5aecho")
        assert client.recv_packet() == b"\x5aecho"
        t.join(10)
    finally:
        a.close()
        b.close()
    assert not errors, errors
    assert raw == ref_w.ed25519_blob(key.public_key())[-32:]
    assert client.session_id == server.session_id is not None
    assert client.remote_version == server.local_version
    assert server.remote_version == client.local_version


# -- interop: each client remote against each loopback server -----------------

PAIRS = {
    "port-client-ref-server": (port_sshnative, ref_minisshd, port_w),
    "ref-client-port-server": (ref_sshnative, port_minisshd, ref_w),
    "port-client-port-server": (port_sshnative, port_minisshd, port_w),
}


@pytest.fixture(params=list(PAIRS))
def rig(request, tmp_path):
    client_mod, server_mod, w = PAIRS[request.param]
    srv = server_mod.MiniSshd(cwd=str(tmp_path)).start()

    def connect(**kw):
        spec = {"host": "127.0.0.1", "port": srv.port,
                "username": srv.user, "password": srv.password, **kw}
        return client_mod.NativeSSHRemote().connect(spec)

    yield connect, srv, w, tmp_path
    srv.stop()


def test_exec_stdout_and_exit(rig):
    connect, _, _, _ = rig
    r = connect()
    try:
        res = r.execute({}, {"cmd": "echo hello world"})
        assert (res["exit"], res["out"], res["err"]) == (0, "hello world\n",
                                                         "")
    finally:
        r.disconnect()


def test_exec_stderr_and_nonzero_exit(rig):
    connect, _, _, _ = rig
    r = connect()
    try:
        res = r.execute({}, {"cmd": "echo oops >&2; exit 3"})
        assert (res["exit"], res["out"], res["err"]) == (3, "", "oops\n")
    finally:
        r.disconnect()


def test_exec_stdin(rig):
    connect, _, _, _ = rig
    r = connect()
    try:
        res = r.execute({}, {"cmd": "wc -c", "in": "12345"})
        assert res["exit"] == 0 and res["out"].strip() == "5"
        res = r.execute({}, {"cmd": "cat", "in": "é" * 50000})
        assert res["out"] == "é" * 50000
    finally:
        r.disconnect()


def test_exec_large_output(rig):
    connect, _, _, _ = rig
    r = connect()
    try:
        res = r.execute({}, {"cmd": "head -c 300000 /dev/zero | tr '\\0' x; "
                                    "head -c 70000 /dev/zero | tr '\\0' y >&2"})
        assert res["exit"] == 0
        assert res["out"] == "x" * 300000 and res["err"] == "y" * 70000
    finally:
        r.disconnect()


def test_several_channels_on_one_connection(rig):
    connect, _, _, _ = rig
    r = connect()
    try:
        for i in range(6):
            res = r.execute({}, {"cmd": f"echo {i}; exit {i}"})
            assert (res["exit"], res["out"]) == (i, f"{i}\n")
    finally:
        r.disconnect()


def test_upload_download_byte_for_byte(rig):
    connect, _, _, tmp_path = rig
    r = connect()
    payload = bytes(range(256)) * 700 + b"\xff\xfe not utf-8 \x80"
    try:
        src = tmp_path / "local.bin"
        src.write_bytes(payload)
        r.upload({}, str(src), "uploaded.bin")
        assert (tmp_path / "uploaded.bin").read_bytes() == payload
        dl = tmp_path / "dl"
        dl.mkdir()
        r.download({}, "uploaded.bin", str(dl))
        assert (dl / "uploaded.bin").read_bytes() == payload
        r.download({}, "uploaded.bin", str(tmp_path / "named.bin"))
        assert (tmp_path / "named.bin").read_bytes() == payload
    finally:
        r.disconnect()


def test_bad_password_rejected(rig):
    connect, _, w, _ = rig
    with pytest.raises(w.SshError, match="password rejected"):
        connect(password="wrong")


def test_hostkey_pin(rig):
    connect, srv, w, _ = rig
    r = connect(hostkey=srv.host_key_raw)
    try:
        assert r.host_key == srv.host_key_raw
        assert r.execute({}, {"cmd": "true"})["exit"] == 0
    finally:
        r.disconnect()
    with pytest.raises(w.SshError, match="MISMATCH"):
        connect(hostkey=b"\x00" * 32)


def test_control_facade_over_the_native_remote(tmp_path):
    """The port's facade over `with_ssh({"remote": "native"})` (a retry
    remote over the port's NativeSSHRemote), against the reference's
    loopback server."""
    srv = ref_minisshd.MiniSshd(cwd=str(tmp_path)).start()
    try:
        rem = port_c.named_remote("native")
        assert isinstance(rem, port_retry.RetryRemote)
        assert isinstance(rem.inner, port_sshnative.NativeSSHRemote)
        with port_c.with_ssh({"remote": "native", "username": srv.user,
                              "password": srv.password, "port": srv.port}):
            with port_c.on("127.0.0.1"):
                assert port_c.exec_("echo", "over-native") == "over-native"
                p = tmp_path / "via-facade.txt"
                p.write_text("facade")
                dest = str(tmp_path / "uploaded-facade.txt")
                port_c.upload(str(p), dest)
                assert port_c.exec_("cat", dest) == "facade"
                with pytest.raises(port_c.NonzeroExit):
                    port_c.exec_("false")
    finally:
        srv.stop()
