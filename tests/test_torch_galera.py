"""The port's galera suite (`jepsen_tpu_torch/dbs/galera.py`), the
MySQL-wire family's base, held against the JAX package: the twins of
`tests/test_galera.py` (the from-scratch MySQL wire codec against the live
mini server, auth rejection, SQL round trips, transactional isolation,
the dirty-reads checker, the three workloads live under the kill/restart
nemesis, the deb recipe through the dummy remote), and parity cases:
length-encoded integers and scrambles byte for byte, the handshake and
`COM_QUERY` frames a client sends and what it makes of the replies, the
embedded server's source and its dialect bridge (`translate`), the DB's
commands, the generated ops of each workload, and the dirty-reads and
bank checkers' results (valid, and with one seeded anomaly each) equal to
the reference's.

Also: the port's ports and store root are its own. galera's checks run
on the host and take no device.
"""

import ast
import contextlib
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import time

import pytest

import jepsen_tpu.control as ref_c
from jepsen_tpu import generator as ref_gen
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import galera as ref_ga
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import galera as ga
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, fail, invoke, ok
from test_torch_sqlite import ephemeral_range

#: the twin fixture's server port, inside galera's block (31100-31149)
FIXTURE_PORT = 31140


# -- helpers shared by the family's test files --------------------------------

@contextlib.contextmanager
def mini_server(tmp_path, port: int):
    """The embedded server (`MINIMYSQL_SRC`) as a subprocess on `port`;
    yields a `start()` that (re)starts it and returns a connection, and
    the state holding the process."""
    srv_py = tmp_path / "minimysql.py"
    srv_py.write_text(ga.MINIMYSQL_SRC)
    state = {"proc": None}

    def start():
        state["proc"] = subprocess.Popen(
            [sys.executable, str(srv_py), "--port", str(port),
             "--dir", str(tmp_path), "--password", ga.MINI_PASSWORD],
            cwd=tmp_path)
        deadline = time.monotonic() + 30
        while True:
            try:
                return ga.MySqlConn("127.0.0.1", port, timeout=2)
            except OSError:
                assert time.monotonic() < deadline, "never up"
                time.sleep(0.1)

    try:
        yield start, state
    finally:
        if state["proc"] is not None:
            state["proc"].kill()
            state["proc"].wait(timeout=10)


def translate_of(src: str):
    """The dialect bridge `translate` of an embedded server's source, on
    its own (the server module parses arguments and serves when run)."""
    tree = ast.parse(src)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "translate")
    ns: dict = {}
    exec(compile(ast.Module(body=[ast.parse("import re").body[0], fn],
                            type_ignores=[]), "<translate>", "exec"), ns)
    return ns["translate"]


def server_imports(src: str) -> set:
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    return mods


def plain(x):
    """A checker result as plain JSON data: each package's ops as dicts."""
    return json.loads(json.dumps(x, default=lambda o: o.to_dict()))


def ref_history(ops) -> RefHistory:
    """The port's ops as the reference's indexed History."""
    return RefHistory([o.to_dict() for o in ops]).index()


def dummy_log(ctl, remote_cls, steps) -> list:
    """The dummy remote's log of `steps`: (node, fn) pairs run in turn,
    each on its node; each upload's local temp file masked (what it held
    is compared where it is made)."""
    log: list = []
    with ctl.with_remote(remote_cls(log)):
        for node, fn in steps:
            with ctl.on(node):
                fn()
    return [(n, ("upload", "<tmp>", *x[2:])
             if isinstance(x, tuple) and x[0] == "upload" else x)
            for n, x in log]


class SqlConn:
    """A connection that records each statement and answers it from a
    script: SELECTs get `rows`, other statements `affected` rows, and a
    statement holding `fail_on` raises the module's `MySqlError`."""

    def __init__(self, mod, rows, affected=1, fail_on=None, msg=""):
        self.mod, self.rows, self.affected = mod, rows, affected
        self.fail_on, self.msg, self.sent = fail_on, msg, []

    def query(self, sql):
        self.sent.append(sql)
        if self.fail_on and self.fail_on in sql:
            raise self.mod.MySqlError(1213, self.msg)
        if sql.startswith("SELECT"):
            return [list(r) for r in self.rows], 0
        return [], self.affected

    def close(self):
        pass


# -- codec units ----------------------------------------------------------------

def test_lenenc_roundtrip():
    for n in (0, 1, 0xFA, 0xFB, 0xFFFF, 0x10000, 0xFFFFFF, 1 << 30):
        enc = ga.put_lenenc(n)
        val, off = ga.lenenc(enc, 0)
        assert (val, off) == (n, len(enc))


def test_native_scramble_properties():
    nonce = bytes(range(20))
    s = ga.native_scramble("secret", nonce)
    assert len(s) == 20
    assert s != ga.native_scramble("secret", bytes(range(1, 21)))
    assert ga.native_scramble("", nonce) == b""
    # server-side verification algebra: XOR with SHA1(nonce||HH)
    # recovers SHA1(pw)
    p1 = hashlib.sha1(b"secret").digest()
    hh = hashlib.sha1(p1).digest()
    mix = hashlib.sha1(nonce + hh).digest()
    assert bytes(a ^ b for a, b in zip(s, mix)) == p1


# -- live mini server -------------------------------------------------------------

@pytest.fixture()
def mini(tmp_path):
    with mini_server(tmp_path, FIXTURE_PORT) as (start, state):
        yield start, state, FIXTURE_PORT


def test_handshake_and_query(mini):
    start, _, _ = mini
    conn = start()
    conn.query("CREATE TABLE t (a INTEGER PRIMARY KEY, b TEXT)")
    _, affected = conn.query("INSERT INTO t VALUES (1, 'x')")
    assert affected == 1
    rows, _ = conn.query("SELECT a, b FROM t")
    assert rows == [["1", "x"]]
    conn.query("INSERT INTO t VALUES (2, NULL)")
    rows, _ = conn.query("SELECT b FROM t ORDER BY a")
    assert rows == [["x"], [None]]
    conn.close()


def test_bad_password_rejected(mini):
    start, _, port = mini
    conn = start()  # server is up
    conn.close()
    with pytest.raises(ga.MySqlError, match="Access denied"):
        ga.MySqlConn("127.0.0.1", port, password="wrong", timeout=2)


def test_sql_error_surfaces(mini):
    start, _, _ = mini
    conn = start()
    with pytest.raises(ga.MySqlError):
        conn.query("SELECT * FROM nonexistent_table")
    # the connection survives the error
    rows, _ = conn.query("SELECT 1")
    assert rows == [["1"]]
    conn.close()


def test_txn_rollback_isolated(mini):
    start, _, port = mini
    c1 = start()
    c1.query("CREATE TABLE d (id INTEGER PRIMARY KEY, x BIGINT)")
    c1.query("INSERT INTO d VALUES (0, -1)")
    c1.query("BEGIN")
    c1.query("UPDATE d SET x = 99")
    c2 = ga.MySqlConn("127.0.0.1", port, timeout=2)
    rows, _ = c2.query("SELECT x FROM d")
    assert rows == [["-1"]]  # uncommitted marker invisible
    c1.query("ROLLBACK")
    rows, _ = c2.query("SELECT x FROM d")
    assert rows == [["-1"]]  # rolled back for good
    c1.close()
    c2.close()


# -- checker --------------------------------------------------------------------

def test_dirty_reads_checker():
    h = History([
        invoke(0, "write", 7), fail(0, "write", 7),   # rolled back
        invoke(1, "read", None), ok(1, "read", [7, 7, 7, 7]),
    ]).index()
    res = ga.DirtyReadsChecker().check({}, h, {})
    assert res["valid?"] is False and res["dirty-reads"]
    h2 = History([
        invoke(0, "write", 8), ok(0, "write", 8),
        invoke(1, "read", None), ok(1, "read", [8, 8, -1, -1]),
    ]).index()
    res2 = ga.DirtyReadsChecker().check({}, h2, {})
    assert res2["valid?"] is True          # no failed marker seen
    assert res2["inconsistent-reads"]      # but rows disagree


# -- full suites ------------------------------------------------------------------

def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["g1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), **kw}


@pytest.mark.parametrize("which", ["set", "bank", "dirty-reads"])
@pytest.mark.slow  # the reference twin's mark (tests/test_galera.py)
def test_full_suite_live(tmp_path, which):
    done = core.run(ga.galera_test(_options(tmp_path, which)))
    res = done["results"]
    assert res["valid?"] is True, res


def test_deb_commands():
    log: list = []
    db = ga.GaleraDB()
    test = {"nodes": ["n1", "n2"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
        with c.on("n2"):
            db.setup(test, "n2")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "percona-xtradb-cluster" in joined
    assert "bootstrap-pc" in joined        # primary bootstraps
    assert joined.count("bootstrap-pc") == 1  # ONLY the primary
    # the config rides an upload (write_file): check content + dest
    ups = [x[1] for x in log if isinstance(x[1], tuple)
           and x[1][0] == "upload"]
    assert any("galera.cnf" in str(u[2]) for u in ups)
    cnf = ga.GaleraDB.galera_cnf(test, "n2")
    assert "gcomm://n1,n2" in cnf and "wsrep_node_address=n2" in cnf


# -- parity with the reference ------------------------------------------------------

LENENC = (0, 1, 0xFA, 0xFB, 0xFC, 0xFFFF, 0x10000, 0xFFFFFF, 0x1000000,
          1 << 40, (1 << 64) - 1)


@pytest.mark.parametrize("n", LENENC)
def test_lenenc_bytes_match_reference(n):
    enc = ga.put_lenenc(n)
    assert enc == ref_ga.put_lenenc(n)
    tail = enc + b"\x07tail"
    assert ga.lenenc(tail, 0) == ref_ga.lenenc(tail, 0)


def test_bad_lenenc_prefix_rejected_as_reference():
    for mod in (ga, ref_ga):
        with pytest.raises(mod.MySqlError) as e:
            mod.lenenc(b"\xff\x00", 0)
        assert e.value.code == 2027


@pytest.mark.parametrize("password", ("", "jepsen-pw", "secret", "héllo☃",
                                      "x" * 100))
def test_scramble_bytes_match_reference(password):
    for seed in range(4):
        nonce = hashlib.sha1(bytes([seed])).digest()
        assert ga.native_scramble(password, nonce) == \
            ref_ga.native_scramble(password, nonce)
    assert ga.CAPS == ref_ga.CAPS


def packet(seq: int, payload: bytes) -> bytes:
    return len(payload).to_bytes(3, "little") + bytes([seq]) + payload


def greeting(nonce: bytes) -> bytes:
    """The embedded server's HandshakeV10 (`MINIMYSQL_SRC`'s `handle`)."""
    return (b"\x0a" + b"5.7.0-minimysql\x00" + struct.pack("<I", 1)
            + nonce[:8] + b"\x00" + struct.pack("<H", 0xF7FF) + b"\x21"
            + struct.pack("<H", 2) + struct.pack("<H", 0x000F)
            + bytes([21]) + b"\x00" * 10 + nonce[8:] + b"\x00"
            + b"mysql_native_password\x00")


OK_PKT = b"\x00" + b"\x03\x00" + struct.pack("<HH", 2, 0)
ERR_PKT = b"\xff" + struct.pack("<H", 1213) + b"#HY000" + b"database is locked"


def resultset(rows) -> list:
    """The payloads of a two-column text resultset (`run_sql`'s shape)."""
    out = [ga.put_lenenc(2)]
    for name in (b"id", b"val"):
        out.append(ga.put_lenenc(3) + b"def" + b"\x00\x00\x00"
                   + ga.put_lenenc(len(name)) + name
                   + ga.put_lenenc(len(name)) + name
                   + b"\x0c" + struct.pack("<HIBHBH", 33, 255, 253, 0, 0, 0))
    out.append(b"\xfe" + struct.pack("<HH", 0, 2))
    for row in rows:
        b = b""
        for v in row:
            b += b"\xfb" if v is None else ga.put_lenenc(len(v)) + v
        out.append(b)
    out.append(b"\xfe" + struct.pack("<HH", 0, 2))
    return out


class WireSock:
    """A socket that records what the client sends."""

    def __init__(self):
        self.sent = b""

    def sendall(self, b):
        self.sent += b

    def close(self):
        pass


def wire_session(mod, replies: list, steps) -> tuple:
    """A `MySqlConn` of `mod` over canned server `replies` (each a list of
    payloads, framed here from sequence 1 as the server frames them):
    `steps(conn)` run after the handshake. Returns (the bytes the client
    sent, what each step returned or raised)."""
    conn = object.__new__(mod.MySqlConn)
    conn.sock = WireSock()
    conn.seq = 0
    frames = b"".join(packet(i, p) for i, p in enumerate(replies[0]))
    for reply in replies[1:]:
        frames += b"".join(packet(i + 1, p) for i, p in enumerate(reply))
    conn.rf = io.BytesIO(frames)
    conn._handshake("jepsen", mod.MINI_PASSWORD, "jepsen")
    out = []
    for step in steps:
        try:
            out.append(step(conn))
        except mod.MySqlError as e:
            out.append(("error", e.code, str(e)))
    conn.close()
    return conn.sock.sent, out


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_handshake_and_query_frames_match_reference(seed):
    nonce = hashlib.sha256(bytes([seed])).digest()[:20]
    replies = [[greeting(nonce), OK_PKT],
               [OK_PKT],
               resultset([[b"1", b"x"], [b"2", None], [b"3", b"y" * 300]]),
               [ERR_PKT],
               resultset([])]
    steps = [lambda conn: conn.query("INSERT INTO t VALUES (1, 'x')"),
             lambda conn: conn.query("SELECT id, val FROM t"),
             lambda conn: conn.query("BEGIN IMMEDIATE"),
             lambda conn: conn.query("SELECT id, val FROM t WHERE id = 9")]
    got = wire_session(ga, replies, steps)
    assert got == wire_session(ref_ga, replies, steps)
    sent, out = got
    assert out[0] == ([], 3)
    assert out[1] == ([["1", "x"], ["2", None], ["3", "y" * 300]], 0)
    assert out[2] == ("error", 1213, "(1213) database is locked")
    # the handshake response carries the scramble of the server's nonce
    assert ga.native_scramble(ga.MINI_PASSWORD, nonce) in sent
    assert packet(0, b"\x03SELECT id, val FROM t") in sent
    assert sent.endswith(packet(0, b"\x01"))  # COM_QUIT


def test_bad_greetings_rejected_as_reference():
    nonce = bytes(20)
    for bad in ([b"\x09" + greeting(nonce)[1:]], [ERR_PKT],
                [greeting(nonce), b"\x05odd"]):
        codes = []
        for mod in (ga, ref_ga):
            with pytest.raises(mod.MySqlError) as e:
                wire_session(mod, [bad], [])
            codes.append((e.value.code, str(e.value)))
        assert codes[0] == codes[1]


def test_server_src_is_the_references_and_imports_neither_package():
    assert ga.MINIMYSQL_SRC == ref_ga.MINIMYSQL_SRC
    mods = server_imports(ga.MINIMYSQL_SRC)
    assert {"socketserver", "sqlite3"} <= mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


TRANSLATE = (
    "CREATE TABLE IF NOT EXISTS jepsen (id INTEGER PRIMARY KEY "
    "AUTOINCREMENT, value BIGINT NOT NULL)",
    "CREATE TABLE sets (id INTEGER PRIMARY KEY AUTO_INCREMENT, v INT)",
    "create table s (id integer primary key auto_increment)",
    "SELECT balance FROM accounts WHERE id=0 FOR UPDATE",
    "SELECT balance FROM accounts WHERE id=0 for  update  ",
    "SELECT balance FROM accounts LOCK IN SHARE MODE",
    "CREATE TABLE r (id INTEGER PRIMARY KEY, value BIGINT) ENGINE=NDBCLUSTER",
    "CREATE TABLE r (id INT) engine = InnoDB",
    "INSERT INTO test (id, sk, val) VALUES (1, 1, 10) ON DUPLICATE KEY "
    "UPDATE val = 10",
    "INSERT INTO txn (id, sk, val) VALUES (3, 3, '1,2') on duplicate key "
    "update val = '1,2'",
    "INSERT INTO t VALUES (1) ON DUPLICATE KEY UPDATE v = 1",
    "SELECT 'for update' FROM t",
    "SELECT 1",
)


def test_translate_matches_reference():
    port, ref = translate_of(ga.MINIMYSQL_SRC), \
        translate_of(ref_ga.MINIMYSQL_SRC)
    got = [port(s) for s in TRANSLATE]
    assert got == [ref(s) for s in TRANSLATE]
    assert "AUTOINCREMENT" in got[1] and "FOR UPDATE" not in got[3]
    assert "ON CONFLICT(id) DO UPDATE SET val = 10" in got[8]
    assert got[10].endswith("ON CONFLICT(id) DO UPDATE SET v = 1")


def galera_db_steps(mod):
    db = mod.GaleraDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in test["nodes"]
            for f in ("setup", "kill", "start", "teardown")], \
        db.log_files(test, "n1")


def test_db_commands_match_reference():
    steps, files = galera_db_steps(ga)
    ref_steps, ref_files = galera_db_steps(ref_ga)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert files == ref_files
    test = {"nodes": ["a", "b", "c"]}
    for node in test["nodes"]:
        assert ga.GaleraDB.galera_cnf(test, node) == \
            ref_ga.GaleraDB.galera_cnf(test, node)


def workload_ops(mod, g_mod, tl, which: str, n: int = 40) -> list:
    """The first `n` invocations of a suite module's workload `which`
    (its generator seeded, every op completing ok at once): (process, f,
    value), a `[k v]` tuple as ("kv", k, v)."""
    g_mod.RNG.seed(24)
    w = mod.WORKLOADS[which]({"time_limit": 8, "nodes": ["n1"],
                              "concurrency": 4, "device": "cpu"})
    if hasattr(w["generator"], "rng"):
        # Elle's generators draw from an RNG of their own, which the
        # suites leave unseeded
        w["generator"].rng.seed(24)
    test = {k: v for k, v in w.items()
            if k not in ("checker", "generator", "client", "wrap_time")}
    out = []
    for o in tl.simulate(g_mod.limit(n, g_mod.clients(w["generator"])),
                         lambda ctx, inv: {**inv, "type": "ok"}, None,
                         test or None):
        if o["type"] == "invoke":
            v = o.get("value")
            out.append((o["process"], o["f"],
                        ("kv", v.k, v.v) if hasattr(v, "k") else v))
    return out


@pytest.mark.parametrize("which", sorted(ga.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(ga, gen, testlib, which)
    assert got == workload_ops(ref_ga, ref_gen, ref_testlib, which)
    assert len(got) == 40


def dirty_history(dirty: bool) -> list:
    """Two committed markers, one rolled back (odd); with `dirty`, a read
    sees the rolled-back marker."""
    ops = [invoke(0, "write", 2), ok(0, "write", 2),
           invoke(1, "read", None), ok(1, "read", [2, 2, 2, 2]),
           invoke(0, "write", 3), fail(0, "write", 3),
           invoke(2, "read", None), ok(2, "read", [2, 2, 4, 4]),
           invoke(1, "write", 4), ok(1, "write", 4)]
    if dirty:
        ops += [invoke(2, "read", None), ok(2, "read", [3, 3, 3, 3])]
    return ops


@pytest.mark.parametrize("dirty", (False, True), ids=("valid", "dirty"))
def test_dirty_reads_checker_matches_reference(dirty):
    ops = dirty_history(dirty)
    got = ga.DirtyReadsChecker().check({}, History(ops).index(), {})
    want = ref_ga.DirtyReadsChecker().check({}, ref_history(ops), {})
    assert got == want
    assert got["valid?"] is (not dirty) and got["inconsistent-reads"]


def bank_history(wrong: bool) -> list:
    """Transfers over a 5-account bank of 100 and its reads; with `wrong`,
    one read's total is off by one."""
    ops, bal = [], {a: 20 for a in range(5)}
    for i in range(6):
        src, dst = i % 5, (i + 2) % 5
        t = {"from": src, "to": dst, "amount": 3}
        ops += [invoke(0, "transfer", t), ok(0, "transfer", t)]
        bal[src] -= 3
        bal[dst] += 3
        read = dict(bal)
        if wrong and i == 3:
            read[4] += 1
        ops += [invoke(1, "read", None), ok(1, "read", read)]
    return ops


@pytest.mark.parametrize("wrong", (False, True), ids=("valid", "wrong-total"))
def test_bank_checker_matches_reference(tmp_path, wrong):
    opts = _options(tmp_path, "bank")
    t, rt = ga.galera_test(opts), ref_ga.galera_test(opts)
    ops = bank_history(wrong)
    got = t["checker"].checker_map["bank"].check(
        t, History(ops).index(), {})
    want = rt["checker"].checker_map["bank"].check(rt, ref_history(ops), {})
    assert got["valid?"] == want["valid?"] == (not wrong)
    assert plain(got["SI"]) == plain(want["SI"])


# -- the port's own choices ---------------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert ga.MINI_BASE_PORT == 31100
    assert ga.MINI_BASE_PORT != ref_ga.MINI_BASE_PORT
    # below the ephemeral range, clear of the reference's bases
    # (21850-30680), with room for five nodes and the twin fixture
    lo, _ = ephemeral_range()
    assert 30680 < ga.MINI_BASE_PORT and ga.MINI_BASE_PORT + 50 <= lo
    assert ga.MINI_BASE_PORT + 5 <= FIXTURE_PORT < ga.MINI_BASE_PORT + 50
    test = {"nodes": ["g1", "g2"]}
    assert [ga.mini_node_port(test, n) for n in test["nodes"]] == \
        [ga.MINI_BASE_PORT, ga.MINI_BASE_PORT + 1]
    assert ga.mini_node_port({**test, "galera_ports": {"g2": 4000}},
                             "g2") == 4000
    t = ga.galera_test({"nodes": ["g1", "g2"], "concurrency": 2})
    assert t["store_root"] == os.path.join("store", "torch")
    # every client drives the primary's server, on the port's base
    assert t["client"].port_fn(t, "g1") == ("127.0.0.1", ga.MINI_BASE_PORT)
    assert t["client"].pin_primary is True
