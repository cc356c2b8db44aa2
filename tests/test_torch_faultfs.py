"""The port's filesystem fault injection (`nemesis/faultfs.py`), held
against the JAX package: the twins of `tests/test_faultfs.py` (the
native faultlib LD_PRELOAD interposer's EIO, path targeting and
conf-file steering against real subprocesses; the nemesis against a live
toykv cluster of the port; the FUSE mount where libfuse3 is present),
and the commands each package sends a node (the uploads by their bytes,
the builds, the conf-file edits and the FUSE cookbook) under a recording
dummy remote.

faultlib is built here with `make` into a temporary directory, and on a
node inside the localexec sandbox, never into the repository.
"""

import os
import subprocess
import sys

import pytest

import jepsen_tpu.control as ref_c
import jepsen_tpu.control.dummy as ref_dummy
from jepsen_tpu.nemesis import faultfs as ref_ff
from jepsen_tpu_torch import checker as jchecker
from jepsen_tpu_torch import control, core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control import dummy
from jepsen_tpu_torch.dbs import toykv
from jepsen_tpu_torch.nemesis import faultfs as ff

NATIVE = os.path.join(os.path.dirname(__file__), "..", "native",
                      "faultfs")

WRITER = r"""
import os, sys
try:
    with open(sys.argv[1], "w") as fh:
        fh.write("data")
        fh.flush()
        os.fsync(fh.fileno())
    print("OK")
except OSError as e:
    print("EIO" if e.errno == 5 else f"ERR:{e.errno}")
"""


@pytest.fixture(scope="module")
def faultlib(tmp_path_factory):
    build = tmp_path_factory.mktemp("faultlib") / "build"
    so = build / "faultlib.so"
    out = subprocess.run(["make", "-C", NATIVE, f"BUILD={build}", str(so)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    return str(so)


def run_writer(so, path, env=None):
    e = {**os.environ, "LD_PRELOAD": so, **(env or {})}
    out = subprocess.run([sys.executable, "-c", WRITER, str(path)],
                         capture_output=True, text=True, env=e)
    return out.stdout.strip()


class TestFaultlib:
    def test_eio_on_matching_path(self, faultlib, tmp_path):
        assert run_writer(faultlib, tmp_path / "victim.log",
                          {"FAULTLIB_PATH": "victim.log",
                           "FAULTLIB_EIO_P": "1.0"}) == "EIO"

    def test_other_paths_untouched(self, faultlib, tmp_path):
        assert run_writer(faultlib, tmp_path / "bystander.log",
                          {"FAULTLIB_PATH": "victim.log",
                           "FAULTLIB_EIO_P": "1.0"}) == "OK"

    def test_no_config_no_faults(self, faultlib, tmp_path):
        assert run_writer(faultlib, tmp_path / "x.log") == "OK"

    def test_eio_after_threshold(self, faultlib, tmp_path):
        # a single writer process: first write ok, then EIO
        prog = r"""
import os, sys
fh = open(sys.argv[1], "wb", buffering=0)
outs = []
for i in range(4):
    try:
        fh.write(b"x")
        outs.append("OK")
    except OSError as e:
        outs.append("EIO" if e.errno == 5 else "ERR")
print(",".join(outs))
"""
        e = {**os.environ, "LD_PRELOAD": faultlib,
             "FAULTLIB_PATH": "t.log", "FAULTLIB_EIO_AFTER": "2"}
        out = subprocess.run(
            [sys.executable, "-c", prog, str(tmp_path / "t.log")],
            capture_output=True, text=True, env=e)
        assert out.stdout.strip() == "OK,OK,EIO,EIO"

    def test_conf_file_steering(self, faultlib, tmp_path):
        """A live process's faults flip on and off as the nemesis
        rewrites the conf file. Progress-driven: each phase waits for
        the observed outcome rather than sleeping."""
        conf = tmp_path / "faultlib.conf"
        prog = r"""
import os, sys, time
fh = open(sys.argv[1], "wb", buffering=0)
while True:
    try:
        fh.write(b"x")
        print("OK", flush=True)
    except OSError:
        print("EIO", flush=True)
    time.sleep(0.15)
"""
        e = {**os.environ, "LD_PRELOAD": faultlib,
             "FAULTLIB_PATH": "s.log",
             "FAULTLIB_CONF": str(conf)}
        p = subprocess.Popen(
            [sys.executable, "-c", prog, str(tmp_path / "s.log")],
            stdout=subprocess.PIPE, text=True, env=e)

        def await_outcome(want, max_lines=60):
            seen = []
            for _ in range(max_lines):
                line = p.stdout.readline().strip()
                if not line:
                    break
                seen.append(line)
                if line == want:
                    return seen
            raise AssertionError(
                f"never saw {want!r}; tail: {seen[-6:]}")

        try:
            await_outcome("OK")
            conf.write_text("eio_p=1.0\n")
            await_outcome("EIO")
            conf.unlink()  # missing file = cleared
            await_outcome("OK")
        finally:
            p.kill()
            p.wait(timeout=10)


def test_faultlib_nemesis_against_toykv(tmp_path):
    """End to end: install faultlib on the node through the control
    layer, run the port's toykv under the preload, flip EIO on the
    recovery log mid-run via the nemesis, and observe real injected
    faults (server tracebacks + crashed client ops), then recovery
    after clear."""
    sandbox = tmp_path / "cluster"
    opts = {"name": "toykv-faults", "nodes": ["a"], "concurrency": 2,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(sandbox), "time_limit": 6,
            "per_key_limit": 10, "nemesis_interval": 99, "device": "cpu"}
    test = toykv.toykv_test(opts)
    # a fixed port below Linux's ephemeral range (32768-60999), apart from
    # the suite's own (31850 on): a retrying client cannot meet itself there
    test["toykv_ports"] = {"a": 31880}
    rem = test["remote"]

    # pre-install faultlib on the node via the control layer
    with control.with_remote(rem):
        with control.with_ssh({}):
            with control.on("a"):
                so = ff.install_faultlib()
    db = toykv.ToyKVDB(env=ff.preload_env(
        so, conf_path=ff.CONF_NAME, path_substr="state.log"))
    test["db"] = db
    test["client"] = toykv.ToyKVSetClient()
    test["nemesis"] = ff.FaultLibNemesis()
    test["checker"] = jchecker.compose({
        "set": jchecker.set_checker(),
        "crashes": jchecker.unhandled_exceptions(),
    })
    counter = iter(range(10_000))
    test["generator"] = gen.phases(
        gen.clients([gen.limit(5, lambda t, c: {
            "f": "add", "value": next(counter)})]),
        gen.nemesis([gen.once({
            "type": "info", "f": "start",
            "value": {"eio_p": 1.0, "path": "state.log"}})]),
        gen.clients([gen.limit(6, lambda t, c: {
            "f": "add", "value": next(counter)})]),
        gen.nemesis([gen.once({"type": "info", "f": "stop"})]),
        gen.clients([gen.limit(5, lambda t, c: {
            "f": "add", "value": next(counter)})]),
        gen.clients([gen.limit(2, lambda t, c: {
            "f": "read", "value": None})]),
    )
    t = core.run(test)
    hist = t["history"]
    crashed_adds = [op for op in hist
                    if op.is_info and op.f == "add"
                    and isinstance(op.process, int)]
    assert crashed_adds, "EIO injection never bit an add"
    # the server hit real I/O errors on its recovery log
    log_text = open(os.path.join(
        t["store_dir"], "a", "server.log")).read()
    assert "Input/output error" in log_text or "OSError" in log_text
    # after clear, the cluster recovered: final reads succeeded
    ok_reads = [op for op in hist if op.is_ok and op.f == "read"]
    assert ok_reads
    # no false alarms: no restart happened, so nothing acked was lost
    s = t["results"]["set"]
    assert s["valid?"] is True
    assert s["lost-count"] == 0
    assert s["ok-count"] >= 10


def test_faultfs_fuse_mount(tmp_path):
    if (subprocess.run(["pkg-config", "--exists", "fuse3"],
                       capture_output=True).returncode != 0
            or not os.path.exists("/dev/fuse")):
        pytest.skip("libfuse3-dev (or /dev/fuse) unavailable: faultfs is "
                    "compiled on db nodes, like the reference's charybdefs")
    build = tmp_path / "build"
    out = subprocess.run(["make", "-C", NATIVE, f"BUILD={build}",
                          "faultfs"], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    binp = str(build / "faultfs")
    backing = tmp_path / "real"
    mnt = tmp_path / "faulty"
    backing.mkdir()
    mnt.mkdir()
    subprocess.run([binp, str(backing), str(mnt)], check=True)
    try:
        (mnt / "f.txt").write_text("hello")
        assert (backing / "f.txt").read_text() == "hello"
        (mnt / ".faultfs_ctl").write_text("eio all")
        with pytest.raises(OSError):
            (mnt / "g.txt").write_text("nope")
        (mnt / ".faultfs_ctl").write_text("clear")
        (mnt / "h.txt").write_text("fine")
    finally:
        subprocess.run(["fusermount", "-u", str(mnt)],
                       capture_output=True)


# -- parity: the commands each package sends a node --------------------------

def recording_remote(dummy_mod, log: list):
    class Recording(dummy_mod.DummyRemote):
        def upload(self, context, local_paths, remote_path, opts=None):
            paths = [local_paths] if isinstance(local_paths, str) \
                else list(local_paths)
            self.log.append((self.host, ("upload", [
                open(p, "rb").read() for p in paths], remote_path)))

    return Recording(log)


def commands(c, dummy_mod, ffm, fn) -> tuple:
    """fn(ffm, test) over a recording remote with sessions to two nodes:
    (each node's commands in order, the result)."""
    log: list = []
    rem = recording_remote(dummy_mod, log)
    nodes = ["n1", "n2"]
    test = {"nodes": nodes,
            "sessions": {n: rem.connect({"host": n}) for n in nodes}}
    with c.with_remote(rem):
        with c.on("n1"):
            out = fn(ffm, test)
    per_node: dict = {}
    for host, cmd in log:
        per_node.setdefault(host, []).append(cmd)
    return per_node, out


def nemesis_ops(ffm, test):
    nem = ffm.FaultLibNemesis("/var/lib/db/faultlib.conf").setup(test)
    out = [nem.invoke(test, {"type": "info", "f": "start",
                             "value": {"eio_p": 0.5, "path": "wal",
                                       "delay_ms": 3, "eio_after": 9}}),
           nem.invoke(test, {"type": "info", "f": "start", "value": None}),
           nem.invoke(test, {"type": "info", "f": "stop"}),
           nem.invoke(test, {"type": "info", "f": "bogus"})]
    nem.teardown(test)
    return out, list(nem.fs())


def cookbook(ffm, test):
    fs = ffm.FaultFS("/srv/real dir", "/srv/faulty")
    fs.setup()
    fs.break_all()
    fs.break_percent(0.25)
    fs.break_path("wal/seg")
    fs.delay(40, 0.5)
    fs.clear()
    fs.teardown()
    return fs.bin


FAULTFS_CALLS = {
    "install_faultlib": lambda ffm, test: ffm.install_faultlib(),
    "install_faultfs": lambda ffm, test: ffm.install_faultfs(),
    "preload_env": lambda ffm, test: (
        ffm.preload_env("faultfs-src/build/faultlib.so"),
        ffm.preload_env("x.so", "/etc/f.conf", path_substr="state.log")),
    "nemesis": nemesis_ops,
    "cookbook": cookbook,
}


@pytest.mark.parametrize("call", list(FAULTFS_CALLS))
def test_commands_match_reference(call):
    port = commands(control, dummy, ff, FAULTFS_CALLS[call])
    assert port == commands(ref_c, ref_dummy, ref_ff, FAULTFS_CALLS[call])
    assert port[0] or call == "preload_env"


def test_native_sources_are_the_repos_own():
    """`NATIVE_DIR` resolves to the repository's `native/faultfs/` from
    the port's package, as the reference's does."""
    assert os.path.realpath(ff.NATIVE_DIR) == os.path.realpath(
        ref_ff.NATIVE_DIR) == os.path.realpath(NATIVE)
    per_node, so = commands(control, dummy, ff,
                            FAULTFS_CALLS["install_faultlib"])
    uploads = [c for c in per_node["n1"] if isinstance(c, tuple)]
    assert [u[2] for u in uploads] == [f"{ff.REMOTE_DIR}/{n}" for n in
                                       ("faultfs.cc", "faultlib.cc",
                                        "Makefile")]
    assert so == "faultfs-src/build/faultlib.so"
