"""The port's `ops/linprep.prepare` memo and `fs_cache`'s remote copies,
against the JAX package's.

The memo is bounded (`_PREP_CAP` = 2) and keyed by the history's
identity and length: a second call on the same history is a hit (the
same frozen `LinOp`s in a fresh list), a grown history misses, a third
history evicts the oldest, and `clear_prepare_memo` empties it. Both
packages show the same hits and misses over one sequence of calls, and
the preflight gate's shape probe and the check it admits prepare the
history once. `fs_cache.save_remote` / `deploy_remote` drive the dummy
remote with the reference's commands.
"""

import os
from collections import OrderedDict

import pytest

from jepsen_tpu import control as jcontrol
from jepsen_tpu import fs_cache as jfs_cache
from jepsen_tpu import models as jmodels
from jepsen_tpu import synth as jsynth
from jepsen_tpu.analysis import preflight as jpreflight
from jepsen_tpu.control import dummy as jdummy
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.ops import linprep as jlinprep
from jepsen_tpu_torch import control as tcontrol
from jepsen_tpu_torch import fs_cache as tfs_cache
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.analysis import preflight as tpreflight
from jepsen_tpu_torch.control import dummy as tdummy
from jepsen_tpu_torch.ops import linprep as tlinprep
from jepsen_tpu_torch.ops import wgl as twgl

PKGS = {"ref": jlinprep, "port": tlinprep}


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


class CountingMemo(OrderedDict):
    """The memo with its lookups and stores counted: a store is a miss
    (a pass over the history)."""

    def __init__(self):
        super().__init__()
        self.gets = 0
        self.sets = 0

    def get(self, key, default=None):
        self.gets += 1
        return super().get(key, default)

    def __setitem__(self, key, value):
        self.sets += 1
        super().__setitem__(key, value)


@pytest.fixture(autouse=True)
def _fresh_memos():
    for mod in PKGS.values():
        mod.clear_prepare_memo()
    yield
    for mod in PKGS.values():
        mod.clear_prepare_memo()


def _trace(mod, hists) -> list:
    """Hit (True) or miss (False) of each call in a fixed sequence."""
    h1, h2, h3 = hists
    out = []
    last = {}

    def call(name, h):
        ops = mod.prepare(h)
        prev = last.get(name)
        out.append(prev is not None and len(prev) == len(ops)
                   and all(a is b for a, b in zip(prev, ops)))
        last[name] = ops
        return ops

    a = call("h1", h1)
    b = call("h1", h1)                 # hit
    assert a == b and a is not b      # a fresh list each time
    call("h2", h2)
    call("h1", h1)                     # hit (h1 and h2 fit the cap)
    call("h3", h3)                     # evicts h2
    call("h2", h2)                     # miss, evicts h1
    call("h1", h1)                     # miss
    h1.append(h1[-1].with_(index=len(h1)))
    call("h1", h1)                     # grown: miss
    call("h1", h1)                     # hit
    mod.clear_prepare_memo()
    assert len(mod._PREP_MEMO) == 0
    call("h1", h1)                     # cleared: miss
    return out


def test_memo_hits_and_misses_match_reference():
    base = [jsynth.cas_register_history(40 + 10 * s, n_procs=3, seed=s)
            for s in range(3)]
    ref = _trace(jlinprep, [jsynth.cas_register_history(
        40 + 10 * s, n_procs=3, seed=s) for s in range(3)])
    port = _trace(tlinprep, [to_port(h) for h in base])
    assert port == ref == [False, True, False, True, False, False, False,
                           False, True, False]
    assert tlinprep._PREP_CAP == jlinprep._PREP_CAP == 2


def test_memo_results_equal_the_reference():
    h = jsynth.cas_register_history(80, n_procs=4, seed=3, crash_p=0.1)
    p = to_port(h)
    for fs in (("read",), ()):
        want = [vars(o) for o in jlinprep.prepare(h, crashed_read_fs=fs)]
        assert [vars(o) for o in tlinprep.prepare(p, crashed_read_fs=fs)] \
            == want
        # the hit returns the same ops
        assert [vars(o) for o in tlinprep.prepare(p, crashed_read_fs=fs)] \
            == want


def test_preflight_probe_and_check_prepare_once(monkeypatch):
    """`preflight.gate_wgl` then `wgl.check` on one history: two lookups,
    one pass; the reference's gate and encode alike."""
    h = jsynth.cas_register_history(60, n_procs=3, seed=4)
    counts = {}
    for pkg, mod in PKGS.items():
        memo = CountingMemo()
        monkeypatch.setattr(mod, "_PREP_MEMO", memo)
        if pkg == "ref":
            assert jpreflight.gate_wgl(jmodels.cas_register(), h,
                                       where="t") is None
            jencode.encode(jmodels.cas_register(), h)
        else:
            p = to_port(h)
            assert tpreflight.gate_wgl(tmodels.cas_register(), p, where="t",
                                       devices=["cpu"]) is None
            res = twgl.check(tmodels.cas_register(), p, device="cpu")
            assert res["valid?"] is True
        counts[pkg] = (memo.gets, memo.sets)
    assert counts["port"] == counts["ref"] == (2, 1)


# --- fs_cache's remote copies -------------------------------------------------

FS = {"ref": (jfs_cache, jcontrol, jdummy), "port": (tfs_cache, tcontrol,
                                                    tdummy)}


def _remote_log(pkg, root) -> list:
    fs_cache, c, dummy = FS[pkg]
    log: list = []
    with c.with_remote(dummy.remote(log)):
        with c.on("n1"):
            assert fs_cache.save_remote(("db", "tarball", 1),
                                        "/var/db.tar.gz") == "/var/db.tar.gz"
            assert os.path.isdir(os.path.dirname(
                fs_cache.fs_path(("db", "tarball", 1))))
            fs_cache.save_string(("conf", True), "x = 1\n")
            assert fs_cache.deploy_remote(("conf", True),
                                          "/etc/db.conf") == "/etc/db.conf"
            with pytest.raises(AssertionError, match="nothing cached"):
                fs_cache.deploy_remote(("missing",), "/etc/other")
    return [(host, tuple(str(x).replace(root, "<cache>") for x in act))
            for host, act in log]


def test_save_and_deploy_remote_match_reference(tmp_path, monkeypatch):
    logs = {}
    for pkg in FS:
        root = str(tmp_path / pkg)
        monkeypatch.setattr(FS[pkg][0], "DIR", root)
        logs[pkg] = _remote_log(pkg, root)
    assert logs["port"] == logs["ref"] == [
        ("n1", ("download", "/var/db.tar.gz",
                "<cache>/s-db/s-tarball/i-1")),
        ("n1", ("upload", "<cache>/s-conf/b-True", "/etc/db.conf"))]


def test_memo_under_threads_keeps_results_and_cap():
    """More threads than cores prepare four histories at once, with a
    short switch interval: every result equals the plain pass, and the
    memo never holds more than its cap."""
    import sys
    import threading

    hists = [to_port(jsynth.cas_register_history(30 + 5 * s, n_procs=3,
                                                  seed=s))
             for s in range(4)]
    want = []
    for h in hists:
        tlinprep.clear_prepare_memo()
        want.append([vars(o) for o in tlinprep.prepare(h)])
    bad: list = []

    def work(t):
        for i in range(60):
            k = (t + i) % len(hists)
            if [vars(o) for o in tlinprep.prepare(hists[k])] != want[k]:
                bad.append((t, i))
            with tlinprep._PREP_LOCK:
                held = len(tlinprep._PREP_MEMO)
            if held > tlinprep._PREP_CAP:
                bad.append(("cap", held))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(4 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
