"""The port's postgres suite (`jepsen_tpu_torch/dbs/postgres.py`), the
pgwire family's base, held against the JAX package: the twins of
`tests/test_postgres.py` (the from-scratch pgwire v3 codec against a
wire-compatible stub backed by a real SQL engine, register CAS via UPDATE
tags, the three workloads live against the stub), and parity cases: the
codec's bytes (the startup and query frames, every backend message
`read_message` parses, `_parse_error`, `tag_count`), the frames a `PgConn`
sends over a canned server and what it makes of the replies, the SQL each
client sends and what it answers, the generated ops of each workload, the
register check's results (valid, and with one seeded anomaly), and one
live register history judged key by key by both packages' `wgl` oracles.

Also: the `device` option reaches the register and append checks, and a
missing card raises before any node is set up. The suite checks on the
CPU (`device="cpu"`). The stub (`PgStub`, bound to port 0) is this file's
own, and the family's other test files import it from here.
"""

import io
import os
import socket
import socketserver
import sqlite3
import struct
import threading

import pytest
import torch

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.dbs import postgres as ref_pg
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu_torch import checker, core, independent, store
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.dbs import postgres as pg
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.independent import tuple_
from jepsen_tpu_torch.models import cas_register
from test_torch_etcd import kv_of, ref_kv_history
from test_torch_galera import workload_ops
from test_torch_mongodb import register_history


# -- the stub: pgwire in front of sqlite3 ---------------------------------------

class PgStub(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, handler, db_path):
        super().__init__(addr, handler)
        self.db_path = db_path


class PgStubHandler(socketserver.StreamRequestHandler):
    """pgwire frontend speaking to sqlite: trust auth, simple query
    protocol, text format. BEGIN is rewritten to BEGIN IMMEDIATE so
    concurrent writers serialize instead of deadlocking on upgrade."""

    def _send(self, t: bytes, payload: bytes):
        self.wfile.write(t + struct.pack("!i", len(payload) + 4) + payload)

    def handle(self):
        raw = self.rfile.read(4)
        if len(raw) < 4:
            return
        n = struct.unpack("!i", raw)[0]
        self.rfile.read(n - 4)  # params ignored: trust auth
        self._send(b"R", struct.pack("!i", 0))  # AuthenticationOk
        self._send(b"Z", b"I")
        db = sqlite3.connect(self.server.db_path, timeout=10,
                             check_same_thread=False)
        # autocommit + explicit BEGIN/COMMIT as real SQL
        db.isolation_level = None
        try:
            while True:
                t = self.rfile.read(1)
                if not t or t == b"X":
                    return
                n = struct.unpack("!i", self.rfile.read(4))[0]
                payload = self.rfile.read(n - 4)
                if t != b"Q":
                    self._send(b"E", b"SERROR\x00Munsupported message\x00\x00")
                    self._send(b"Z", b"I")
                    continue
                self._run(db, payload[:-1].decode().strip().rstrip(";"))
        finally:
            db.close()

    def _run(self, db, sql):
        up = sql.upper()
        if up.startswith("BEGIN"):
            sql = "BEGIN IMMEDIATE"
        try:
            before = db.total_changes
            cur = db.execute(sql)
            rows = cur.fetchall() if cur.description else []
            changed = db.total_changes - before
        except sqlite3.Error as e:
            try:
                db.rollback()
            except sqlite3.Error:
                pass
            self._send(b"E", b"SERROR\x00M" + str(e)[:120].encode()
                       + b"\x00\x00")
            self._send(b"Z", b"I")
            return
        if cur.description:
            self._send(b"T", row_description([c[0] for c in cur.description]))
            for row in rows:
                self._send(b"D", data_row(row))
            tag = f"SELECT {len(rows)}"
        elif up.startswith("UPDATE"):
            tag = f"UPDATE {changed}"
        elif up.startswith("INSERT"):
            tag = f"INSERT 0 {changed}"
        else:
            tag = up.split()[0]
        self._send(b"C", tag.encode() + b"\x00")
        self._send(b"Z", b"I")


def row_description(names) -> bytes:
    return struct.pack("!h", len(names)) + b"".join(
        n.encode() + b"\x00" + struct.pack("!ihihih", 0, 0, 25, -1, -1, 0)
        for n in names)


def data_row(row) -> bytes:
    out = struct.pack("!h", len(row))
    for v in row:
        if v is None:
            out += struct.pack("!i", -1)
        else:
            b = str(v).encode()
            out += struct.pack("!i", len(b)) + b
    return out


@pytest.fixture()
def stub(tmp_path):
    srv = PgStub(("127.0.0.1", 0), PgStubHandler, str(tmp_path / "pg.db"))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


# -- twins of tests/test_postgres.py ---------------------------------------------

def test_handshake_and_roundtrip(stub):
    host, port = stub
    conn = pg.PgConn(host, port)
    rows, tag = conn.query("SELECT 1 AS one")
    assert rows == [["1"]] and tag.startswith("SELECT")
    conn.query("CREATE TABLE t (a INTEGER)")
    _, tag = conn.query("INSERT INTO t (a) VALUES (5)")
    assert pg.tag_count(tag) == 1
    conn.close()


def test_register_cas_via_update_tag(stub):
    host, port = stub
    pg.PgConn(host, port).query(
        "CREATE TABLE registers (k INTEGER PRIMARY KEY, v INTEGER)")
    cl = pg.PgRegisterClient(
        addr_fn=lambda test, node: (host, port)).open({}, "n1")
    rd = {"type": "invoke", "f": "read", "value": tuple_(1, None),
          "process": 0}
    assert cl.invoke({}, rd)["value"] == tuple_(1, None)
    assert cl.invoke({}, {"f": "write", "value": tuple_(1, 3),
                          "process": 0})["type"] == "ok"
    assert cl.invoke({}, {"f": "cas", "value": tuple_(1, [3, 8]),
                          "process": 0})["type"] == "ok"
    assert cl.invoke({}, {"f": "cas", "value": tuple_(1, [3, 9]),
                          "process": 0})["type"] == "fail"
    assert cl.invoke({}, rd)["value"] == tuple_(1, 8)


def _opts(tmp_path, workload, **kw):
    return {"nodes": ["n1"], "concurrency": 4,
            "time_limit": kw.pop("time_limit", 4), "workload": workload,
            "store_root": str(tmp_path / "store"), "device": "cpu", **kw}


def _run(stub, tmp_path, workload, **kw):
    host, port = stub
    t = pg.postgres_test(_opts(tmp_path, workload, **kw))
    t["client"].addr_fn = lambda test, node: (host, port)
    return core.run(t)


def test_register_suite(stub, tmp_path):
    done = _run(stub, tmp_path, "register")
    assert done["results"]["valid?"] is True
    assert done["results"]["register"]["valid?"] is True


def test_bank_suite(stub, tmp_path):
    done = _run(stub, tmp_path, "bank")
    assert done["results"]["valid?"] is True, done["results"]["bank"]
    reads = [op for op in done["history"]
             if getattr(op, "type", None) == "ok"
             and getattr(op, "f", None) == "read"]
    assert reads and all(
        sum(v for v in op.value.values() if v is not None) == 100
        for op in reads)


def test_append_suite(stub, tmp_path):
    done = _run(stub, tmp_path, "append")
    assert done["results"]["valid?"] is True, done["results"]["append"]
    assert done["results"]["append"]["anomaly-types"] == []


def test_tests_fn_sweeps(tmp_path):
    names = [t["name"] for t in pg.postgres_tests(
        {"nodes": ["n1"], "concurrency": 2, "store_root": str(tmp_path),
         "device": "cpu"})]
    assert names == ["postgres-append", "postgres-bank", "postgres-register"]


# -- parity with the reference: the codec -----------------------------------------

def msg(t: bytes, payload: bytes) -> bytes:
    return t + struct.pack("!i", len(payload) + 4) + payload


ERROR = (b"SERROR\x00VERROR\x00C40001\x00Mcould not serialize access\x00"
         b"Dpivot\x00\x00")
#: one of every backend message `read_message` and `PgConn` meet
BACKEND = (
    msg(b"R", struct.pack("!i", 0)),
    msg(b"S", b"server_version\x0012.0\x00"),
    msg(b"K", struct.pack("!ii", 4242, 77)),
    msg(b"Z", b"I"),
    msg(b"T", row_description(["k", "v"])),
    msg(b"D", data_row(["1", None])),
    msg(b"D", data_row(["x" * 300, "é"])),
    msg(b"C", b"UPDATE 1\x00"),
    msg(b"E", ERROR),
    msg(b"N", b"SNOTICE\x00Mhello\x00\x00"),
    msg(b"I", b""),
    msg(b"Z", b"T"),
)


@pytest.mark.parametrize("user,database", (("jepsen", "jepsen"),
                                           ("", ""), ("é", "db 2")))
def test_startup_bytes_match_reference(user, database):
    got = pg.encode_startup(user, database)
    assert got == ref_pg.encode_startup(user, database)
    assert struct.unpack("!ii", got[:8]) == (len(got), 196608)


@pytest.mark.parametrize("sql", ("SELECT 1", "", "INSERT INTO t VALUES "
                                 "('é')", "BEGIN ISOLATION LEVEL SERIALIZABLE"))
def test_query_bytes_match_reference(sql):
    got = pg.encode_query(sql)
    assert got == ref_pg.encode_query(sql)
    assert got[:1] == b"Q" and got.endswith(b"\x00")


def read_all(mod, stream: bytes) -> list:
    """Every message `read_message` of `mod` reads from `stream`, then
    the error that ends it."""
    rf, out = io.BytesIO(stream), []
    while True:
        try:
            out.append(mod.read_message(rf))
        except ConnectionError as e:
            return out + [("error", str(e))]


@pytest.mark.parametrize("cut", (0, 1, 3, 6, 12))
def test_read_message_matches_reference(cut):
    stream = b"".join(BACKEND)
    stream = stream[:len(stream) - cut] if cut else stream
    got = read_all(pg, stream)
    assert got == read_all(ref_pg, stream)
    # each whole message, then the end of the stream or the cut one's
    assert got[-1][0] == "error"
    assert len(got) == (len(BACKEND) + 1 if cut == 0 else
                        len(BACKEND) if cut <= 6 else len(BACKEND) - 2)


@pytest.mark.parametrize("payload", (
    ERROR, b"SERROR\x00\x00", b"", b"\x00", b"Mfirst\x00Msecond\x00\x00",
    b"SFATAL\x00Mrole \xc3\xa9 missing\x00\x00"))
def test_parse_error_matches_reference(payload):
    assert pg._parse_error(payload) == ref_pg._parse_error(payload)


@pytest.mark.parametrize("tag", (None, "", "UPDATE 1", "UPDATE 0",
                                 "INSERT 0 3", "SELECT 12", "BEGIN",
                                 "COMMIT", "DELETE x"))
def test_tag_count_matches_reference(tag):
    assert pg.tag_count(tag) == ref_pg.tag_count(tag)


class WireSock:
    """A socket over canned server bytes that records what the client
    sends."""

    def __init__(self, replies: bytes):
        self.sent, self.replies = b"", replies

    def settimeout(self, t):
        pass

    def makefile(self, mode):
        return io.BytesIO(self.replies)

    def sendall(self, b):
        self.sent += b

    def close(self):
        pass


def wire_session(monkeypatch, mod, replies: bytes, sqls) -> tuple:
    """A `PgConn` of `mod` over canned `replies`: each of `sqls` queried
    after the handshake. Returns (the bytes the client sent, what each
    step returned or raised)."""
    sock = WireSock(replies)
    monkeypatch.setattr(socket, "create_connection", lambda *a, **k: sock)
    try:
        conn = mod.PgConn("h", 1)
    except mod.PgError as e:
        return sock.sent, [("error", str(e))]
    out = []
    for sql in sqls:
        try:
            out.append(conn.query(sql))
        except mod.PgError as e:
            out.append(("error", str(e)))
        except ConnectionError as e:
            out.append(("closed", str(e)))
    conn.close()
    return sock.sent, out


HANDSHAKE = b"".join(BACKEND[:4])


@pytest.mark.parametrize("case", range(4))
def test_conn_frames_match_reference(monkeypatch, case):
    replies, sqls = [
        (HANDSHAKE + b"".join(BACKEND[4:8]) + msg(b"Z", b"I")
         + BACKEND[8] + msg(b"Z", b"E") + BACKEND[9] + BACKEND[10]
         + BACKEND[11], ["SELECT k, v FROM t", "UPDATE t SET v = 1", ""]),
        (HANDSHAKE + BACKEND[7] + msg(b"Z", b"I"), ["UPDATE t", "SELECT 1"]),
        (msg(b"R", struct.pack("!i", 5)) + BACKEND[3], []),
        (BACKEND[8], []),
    ][case]
    got = wire_session(monkeypatch, pg, replies, sqls)
    assert got == wire_session(monkeypatch, ref_pg, replies, sqls)
    sent, out = got
    assert sent.startswith(pg.encode_startup("jepsen", "jepsen"))
    if case == 0:
        assert out[0] == ([["1", None], ["x" * 300, "é"]], "UPDATE 1")
        assert out[1] == ("error", "could not serialize access")
        assert out[2] == ([], None)
        assert sent.endswith(b"X" + struct.pack("!i", 4))
    elif case == 1:
        assert out == [([], "UPDATE 1"), ("closed", "server closed")]
    else:
        assert out[0][0] == "error"


# -- parity with the reference: the clients -----------------------------------------

class PgScript:
    """A connection that records each statement and answers it from a
    script: SELECTs get `rows`, UPDATEs the tag `UPDATE affected`, other
    statements their verb, and a statement holding `fail_on` raises the
    module's `PgError`."""

    def __init__(self, mod, rows, affected=1, fail_on=None, msg="boom"):
        self.mod, self.rows, self.affected = mod, rows, affected
        self.fail_on, self.msg, self.sent = fail_on, msg, []

    def query(self, sql):
        self.sent.append(sql)
        if self.fail_on and self.fail_on in sql:
            raise self.mod.PgError(self.msg)
        up = sql.upper()
        if up.startswith("SELECT"):
            return [list(r) for r in self.rows], f"SELECT {len(self.rows)}"
        if up.startswith("UPDATE"):
            return [], f"UPDATE {self.affected}"
        return [], up.split()[0] if up else None

    def close(self):
        pass


def client_session(mod, name: str, script: dict, ops, test=None) -> tuple:
    """Client `name` of `mod` over a `PgScript`: its setup, then each op.
    Returns (the statements sent, each op's (type, value, error))."""
    test = test or {"accounts": [0, 1, 2], "total-amount": 10}
    cl = getattr(mod, name)().open(test, "n1")
    conn = PgScript(mod, **script)
    cl.conn = conn
    if hasattr(cl, "setup"):
        cl.setup(test)
    out = []
    for op in ops(mod):
        cl.conn = conn
        done = cl.invoke(test, {"type": "invoke", "process": 0, **op})
        v = done.get("value")
        out.append((done["type"], ("kv", v.k, v.v) if hasattr(v, "k") else v,
                    done.get("error")))
    return conn.sent, out


def kv(mod, k, v):
    return (tuple_ if mod is pg else ref_independent.tuple_)(k, v)


def reg_ops(mod):
    return [{"f": "read", "value": kv(mod, 3, None)},
            {"f": "write", "value": kv(mod, 3, 4)},
            {"f": "cas", "value": kv(mod, 3, [4, 5])}]


TXN = [{"f": "txn", "value": [["r", 1, None], ["append", 1, 5],
                              ["append", 2, 6], ["r", 2, None]]}]
BANK = [{"f": "read", "value": None},
        {"f": "transfer", "value": {"from": 0, "to": 1, "amount": 2}},
        {"f": "transfer", "value": {"from": 1, "to": 0, "amount": 9}}]

SESSIONS = (
    ("PgRegisterClient", dict(rows=[["4"]]), reg_ops),
    ("PgRegisterClient", dict(rows=[], affected=0), reg_ops),
    ("PgRegisterClient", dict(rows=[[None]], fail_on="INSERT"), reg_ops),
    ("PgRegisterClient", dict(rows=[["4"]], fail_on="SELECT"), reg_ops),
    ("PgBankClient", dict(rows=[["0", "5"], ["1", "3"]]), lambda m: BANK),
    ("PgBankClient", dict(rows=[["1", "1"]]), lambda m: BANK),
    ("PgBankClient", dict(rows=[["7"]], fail_on="COMMIT"), lambda m: BANK),
    ("PgAppendClient", dict(rows=[["1,2"]]), lambda m: TXN),
    ("PgAppendClient", dict(rows=[]), lambda m: TXN),
    ("PgAppendClient", dict(rows=[[""]], fail_on="INSERT"), lambda m: TXN),
)


@pytest.mark.parametrize("case", range(len(SESSIONS)))
def test_client_sql_matches_reference(case):
    name, script, ops = SESSIONS[case]
    got = client_session(pg, name, script, ops)
    assert got == client_session(ref_pg, name, script, ops)
    assert got[1]


def test_bank_setup_failure_raises_as_reference():
    for mod in (pg, ref_pg):
        with pytest.raises(mod.PgError):
            client_session(mod, "PgBankClient",
                           dict(rows=[], fail_on="INSERT"), lambda m: [])


@pytest.mark.parametrize("which", sorted(pg.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(pg, gen, testlib, which)
    assert got == workload_ops(ref_pg, ref_gen, ref_testlib, which)
    assert got


def test_schema_and_teardown_match_reference(stub):
    """`ExternalDB`'s setup and teardown against the stub: the same
    tables made and dropped."""
    host, port = stub
    tables = []
    for mod in (pg, ref_pg):
        db = mod.ExternalDB(lambda test, node: mod.PgConn(host, port))
        test = {"nodes": ["n1", "n2"]}
        db.setup(test, "n2")  # not the first node: nothing
        db.setup(test, "n1")
        conn = mod.PgConn(host, port)
        rows, _ = conn.query("SELECT name FROM sqlite_master "
                             "WHERE type = 'table' ORDER BY name")
        db.teardown(test, "n1")
        after, _ = conn.query("SELECT name FROM sqlite_master")
        conn.close()
        tables.append((rows, after))
    assert tables[0] == tables[1]
    assert tables[0] == ([["accounts"], ["lists"], ["registers"]], [])


@pytest.mark.parametrize("stale", (False, True), ids=("valid", "stale"))
def test_register_verdicts_match_reference(tmp_path, stale):
    opts = _opts(tmp_path, "register")
    chk = pg.postgres_test(opts)["checker"].checker_map["register"]
    ref_chk = ref_pg.postgres_test(opts)["checker"].checker_map["register"]
    ops = register_history(stale)
    got = chk.check({}, History([{**o, "value": tuple_(*o["value"])}
                                 for o in ops]).index(), {})
    want = ref_chk.check({}, RefHistory(
        [{**o, "value": ref_independent.tuple_(*o["value"])}
         for o in ops]).index(), {})
    assert got["valid?"] is (not stale) and want["valid?"] is (not stale)
    assert {k: r["valid?"] for k, r in got["results"].items()} == \
        {k: r["valid?"] for k, r in want["results"].items()}


@pytest.fixture(scope="module")
def register_run(tmp_path_factory):
    """A live register run against the stub (the reference test's one
    node and 4 workers, the suite's 100 ops a key, 3 s), its generator
    seeded, judged by the port's host `wgl` oracle: the suite's
    competition race with `device="cpu"` holds a key as long as the plain
    device lane's chunk (ROADMAP Queue C, C3), which
    `test_register_suite` meets."""
    tmp = tmp_path_factory.mktemp("register")
    srv = PgStub(("127.0.0.1", 0), PgStubHandler, str(tmp / "pg.db"))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        gen.RNG.seed(25)
        test = pg.postgres_test(_opts(tmp, "register", time_limit=3))
        host, port = srv.server_address
        test["client"].addr_fn = lambda test, node: (host, port)
        test["checker"] = checker.compose({"register": independent.checker(
            checker.linearizable(cas_register(), algorithm="wgl",
                                 device="cpu"))})
        yield test, core.run(test)
    finally:
        srv.shutdown()
        srv.server_close()


def test_live_register_history_matches_reference(register_run):
    """The live register history, read back from the store, judged key by
    key by the port's `wgl` oracle and by the reference's: equal verdicts
    on every key, all True, equal to the run's own."""
    test, done = register_run
    stored = store.load_latest(test["store_root"])
    hist = History([{**o, "value": kv_of(o.get("value"))}
                    for o in stored["history"]]).index()
    assert [o.to_dict() for o in hist] == \
        [o.to_dict() for o in done["history"]]
    port = independent.checker(checker.linearizable(
        cas_register(), algorithm="wgl", device="cpu")).check(
            {"name": "pg-oracle"}, hist, {})
    ref = ref_independent.checker(ref_checker.linearizable(
        ref_cas_register(), algorithm="wgl")).check(
            {"name": "pg-oracle"}, ref_kv_history(hist), {})
    run = done["results"]["register"]["results"]
    verdicts = {k: r["valid?"] for k, r in port["results"].items()}
    assert verdicts == {k: r["valid?"] for k, r in ref["results"].items()}
    assert verdicts == {k: r["valid?"] for k, r in run.items()}
    assert len(verdicts) >= 3 and all(v is True for v in verdicts.values())


# -- the port's own choices ---------------------------------------------------

def test_store_root_and_port_are_the_ports_own(tmp_path):
    t = pg.postgres_test({"nodes": ["n1"], "concurrency": 2,
                          "workload": "bank"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["client"].addr_fn(t, "db1") == ("db1", pg.PORT) == \
        ("db1", ref_pg.PORT)


@pytest.mark.parametrize("which", pg.DEVICE_WORKLOADS)
def test_device_reaches_the_checkers(tmp_path, which):
    t = pg.postgres_test(_opts(tmp_path, which))
    chk = t["checker"].checker_map[which]
    if which == "register":
        chk = chk.checker.checker_map["linear"]
        assert chk.algorithm == "competition"
    assert chk.device == torch.device("cpu")


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for which in pg.DEVICE_WORKLOADS:
        with pytest.raises(RuntimeError, match="CUDA"):
            pg.postgres_test({**_opts(tmp_path, which), "device": None})
        with pytest.raises(RuntimeError, match="CUDA"):
            list(pg.postgres_tests({**_opts(tmp_path, which),
                                    "device": None}))
    assert not (tmp_path / "store").exists()
    # the bank's check takes no device: no card is needed
    t = pg.postgres_test({**_opts(tmp_path, "bank"), "device": None})
    assert t["name"] == "postgres-bank"
