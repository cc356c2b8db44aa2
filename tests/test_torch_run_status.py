"""The port's live run status against the JAX package's.

Both packages' `fleet.RunStatus` are fed the same sequence of phases,
key, device, op, nemesis, fault, stall and poll events, each with a
status-file mirror under its own store root. Their snapshots must have
the same keys and the same counters (the wall-clock fields masked), and
`read_status_file` of each mirror must agree. `web.status_snapshot`
falls back to the mirror that a run in another process writes, and its
idle schema is the reference's.
"""

import pytest

from jepsen_tpu import fleet as ref_fleet
from jepsen_tpu import web as ref_web
from jepsen_tpu_torch import fleet as port_fleet
from jepsen_tpu_torch import web as port_web

CLOCK = ("started", "updated", "elapsed_s", "eta_s", "since_s",
         "keys_started", "last_age_s")


def masked(x):
    if isinstance(x, dict):
        return {k: ("<clock>" if k in CLOCK else masked(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [masked(v) for v in x]
    return x


def feed(st):
    st.phase("run")
    st.begin_keys(3)
    st.device_state("cpu", "busy", key_index=0)
    for i in range(5):
        st.op_event(invoked=True)
        if i < 4:
            st.op_event(invoked=False)
    st.nemesis_event("start-partition", active=True)
    st.key_done({"device": "cpu", "key_index": 0, "wall_s": 0.25,
                 "valid?": True})
    st.key_done({"device": "cpu", "key_index": 1, "wall_s": 0.5,
                 "valid?": False, "fault": {"type": "RuntimeError"}})
    st.fault({"type": "RuntimeError", "error": "boom",
              "stage": "device-worker", "device": "cpu", "key_index": 1})
    st.stall({"source": "wgl-poll#1", "age_s": 12.5})
    st.search_poll({"frontier": 4, "backlog": 2, "explored": 100,
                    "poll_s": 0.5}, search_id="s")
    st.search_poll({"frontier": 3, "backlog": 0, "explored": 300,
                    "poll_s": 0.5}, search_id="s")
    st.batched_poll(live=1, decided=2, total=3, frontier_total=7,
                    backlog_total=1, explored_total=900)
    st.occupancy_poll({"mode": "single", "kernel": "wgl32", "K": 2,
                       "fill_last": 0.5, "recent_rounds": [
                           {"round": 1, "fill": 0.5}]}, search_id="s")
    st.nemesis_event("stop-partition",
                     active=ref_fleet.nemesis_opens_window("stop-partition"))
    st.phase("analyze")
    st.finish(valid=False)


@pytest.fixture
def statuses(tmp_path):
    out = {}
    for name, mod in (("ref", ref_fleet), ("port", port_fleet)):
        root = tmp_path / name
        st = mod.RunStatus(test="status-parity", progress=False,
                           status_file=str(root / mod.STATUS_FILENAME))
        feed(st)
        out[name] = (mod, st, str(root))
    return out


def test_snapshot_keys_and_counters_match(statuses):
    ref = statuses["ref"][1].snapshot()
    port = statuses["port"][1].snapshot()
    assert set(port) == set(ref)
    assert masked(port) == masked(ref)
    assert port["ops"] == {"invoked": 5, "completed": 4}
    assert port["nemesis"]["f"] == "stop-partition"
    assert port["nemesis"]["active"] is False
    assert port["active"] is False and port["valid?"] is False


def test_status_file_mirrors_match(statuses):
    mirrors = {k: mod.read_status_file(root)
               for k, (mod, _, root) in statuses.items()}
    assert mirrors["port"] is not None
    assert masked(mirrors["port"]) == masked(mirrors["ref"])
    assert port_fleet.STATUS_FILENAME == ref_fleet.STATUS_FILENAME
    assert port_fleet.read_status_file(
        str(statuses["port"][2]) + "-missing") is None


@pytest.mark.parametrize("f", ["start-partition", "kill", "pause", "start",
                               "stop", "stop-partition", "heal", "resume",
                               "recover", None, 3])
def test_nemesis_opens_window_matches(f):
    assert port_fleet.nemesis_opens_window(f) == \
        ref_fleet.nemesis_opens_window(f)


def test_disabled_status_records_nothing(tmp_path):
    st = port_fleet.RunStatus(enabled=False,
                              status_file=str(tmp_path / "s.json"))
    st.op_event(invoked=True)
    st.nemesis_event("kill", active=True)
    st.finish(valid=True)
    assert not (tmp_path / "s.json").exists()
    assert st.snapshot()["ops"] == {"invoked": 0, "completed": 0}


def test_mirror_is_throttled_and_atomic(tmp_path):
    path = tmp_path / port_fleet.STATUS_FILENAME
    st = port_fleet.RunStatus(test="t", progress=False,
                              status_file=str(path))
    st.phase("run")                 # first write
    first = port_fleet.read_status_file(str(tmp_path))
    st.phase("analyze")             # within the second: not written
    assert port_fleet.read_status_file(str(tmp_path)) == first
    assert first["phase"] == "run"
    st.finish(valid=True)           # finish always writes
    assert port_fleet.read_status_file(str(tmp_path))["phase"] == "done"
    assert not (tmp_path / (port_fleet.STATUS_FILENAME + ".tmp")).exists()


def test_web_status_falls_back_to_the_mirror(statuses):
    """With no status installed in this process, /status.json serves the
    mirror a run in another process wrote, as the reference's does."""
    assert not port_fleet.get_default().enabled
    assert not ref_fleet.get_default().enabled
    root = statuses["port"][2]
    got = port_web.status_snapshot(root)
    want = ref_web.status_snapshot(statuses["ref"][2])
    live = set(statuses["port"][1].snapshot())
    assert masked({k: got[k] for k in live}) == \
        masked({k: want[k] for k in live})
    assert got["test"] == "status-parity" and got["ops"]["invoked"] == 5


def test_web_idle_schema_matches(tmp_path):
    got = port_web.status_snapshot(str(tmp_path))
    want = ref_web.status_snapshot(str(tmp_path))
    idle = set(port_web._idle_status())
    assert idle <= set(want)
    assert {k: got[k] for k in idle} == {k: want[k] for k in idle}
