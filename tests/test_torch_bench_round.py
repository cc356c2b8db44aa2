"""Every config of the bench round, at small sizes, on the CPU; then a
second, headline-only round that reads the first as its prior; then
`python -m jepsen_tpu_torch doctor bench` over the two.

The reference's env knobs size the fan-out and sharded configs; the
configs the reference gives fixed sizes (register 500 to Elle 4k) are
cut by wrapping the port's `synth` generators, so that every config's
path runs here in seconds: each decides as the host oracle does on its
history. `chip_smoke.py` runs the round at the reference's sizes on the
card.
"""

import contextlib
import io
import json
import os

import pytest

from jepsen_tpu_torch import __main__ as tmain
from jepsen_tpu_torch import bench as tbench
from jepsen_tpu_torch import fs_cache
from jepsen_tpu_torch import ledger as tledger
from jepsen_tpu_torch import synth

SMALL = {"JEPSEN_TPU_BENCH_TOTAL_S": "600",
         "JEPSEN_TPU_BENCH_TRACE_DIR": "",
         "JEPSEN_TPU_BENCH_KEYS": "4",
         "JEPSEN_TPU_BENCH_PER_KEY": "60",
         "JEPSEN_TPU_BENCH_MESH_KEYS": "4",
         "JEPSEN_TPU_BENCH_MESH_PER_KEY": "60",
         "JEPSEN_TPU_BENCH_ELLE_TXNS": "80"}

# the verdict each config's small history has (the host oracle's)
WANT = {"cas_register_0k": True, "register_500": True, "mutex_1k": True,
        "fifo_queue_100k": True, "adversarial_wave_2M": False,
        "long_tail_900": True, "elle_append_3k": True, "elle_wr_3k": True,
        "elle_append_8k": True, "elle_append_sharded_80": True,
        "independent_4x60": True, "independent_mesh_4x60": True}


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """Two rounds under one root: every config, then the headline."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("bench")
    # the mesh config's warm registers its plan in the port's fs_cache
    mp.setattr(fs_cache, "DIR", str(root / "fs_cache"))
    for k, v in SMALL.items():
        mp.setenv(k, v)
    orig = {n: getattr(synth, n) for n in (
        "list_append_history", "wr_register_history",
        "fifo_queue_history", "adversarial_wave_history",
        "long_tail_history")}

    def capped(name, cap):
        return lambda n, **kw: orig[name](min(n, cap), **kw)
    mp.setattr(synth, "list_append_history",
               capped("list_append_history", 80))
    mp.setattr(synth, "wr_register_history",
               capped("wr_register_history", 80))
    mp.setattr(synth, "fifo_queue_history",
               capped("fifo_queue_history", 500))
    mp.setattr(synth, "long_tail_history", capped("long_tail_history", 60))
    mp.setattr(synth, "adversarial_wave_history",
               lambda n, **kw: orig["adversarial_wave_history"](
                   2, width=6, span=2, seed=kw.get("seed", 0)))
    capsys_lines = []
    for extras in ("1", "0"):
        mp.setenv("JEPSEN_TPU_BENCH_EXTRAS", extras)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tbench.main(["--device", "cpu", "--ops", "300",
                              "--root", str(root)])
        with open(root / tbench.DETAILS_FILE) as fh:
            details = json.load(fh)
        capsys_lines.append((rc, buf.getvalue().strip().splitlines(),
                             details))
    mp.undo()
    return str(root), capsys_lines


def test_every_config_decides_as_the_oracle(rounds):
    _, lines = rounds
    rc, (line,), details = lines[0]
    out = json.loads(line)
    assert rc == 0 and out["verdict"] is True
    assert {n: c["verdict"] for n, c in out["configs"].items()} == WANT
    cfgs = details["configs"]
    assert cfgs["register_500"]["engine"] == "jitlin"
    assert cfgs["fifo_queue_100k"]["engine"] == "queue-poly"
    adv = cfgs["adversarial_wave_2M"]
    assert adv["engine"] == "device"
    assert adv["device_row"]["verdict"] is adv["oracle_row"]["verdict"] \
        is False
    # the Elle rows stay out of a config entry, as in the reference's
    # `_config_entry`; an engine disagreement would be the cause
    for name in ("elle_append_8k", "elle_append_sharded_80"):
        assert "DISAGREEMENT" not in (cfgs[name].get("cause") or ""), name
        assert cfgs[name]["engine"] in ("host", "sharded", "trim")
    mesh = cfgs["independent_mesh_4x60"]
    assert mesh["engine"] == "device-mesh" and mesh["parity"] is True
    assert mesh["mesh"]["n_devices"] == tbench.MESH_SHARDS
    assert "speedup_vs_streamed" in mesh
    for c in cfgs.values():
        assert c["verdict"] not in ("error", "skipped"), c
        # on the CPU no wrapper launches a kernel
        assert c["launches"] == {}


def test_second_round_reads_the_first(rounds):
    root, lines = rounds
    rc, (line,), _ = lines[1]
    out = json.loads(line)
    assert rc == 0 and set(out["configs"]) == {"cas_register_0k"}
    reg = out["regressions"]
    assert reg["compared_rounds"] == [1]
    led = tledger.Ledger(os.path.join(root, tbench.STORE_DIR))
    assert [(r["round"], r["platform"]) for r in
            led.query(kind="bench-round")] == [(1, "cpu"), (2, "cpu")]
    assert len(led.query(kind="bench-occupancy")) == 2
    assert len(led.query(kind="doctor")) == 2
    names = {r["name"] for r in led.query(kind="bench")}
    assert set(WANT) - {"cas_register_0k"} <= names
    rep = json.load(open(os.path.join(root, tbench.TELEMETRY_DIR,
                                      "regressions.json")))
    assert rep["compared_rounds"] == [1]
    assert rep["sources"] == {"ledger": 1, "glob": 0}


def test_doctor_bench_over_the_round(rounds, capsys):
    root, _ = rounds
    rc = tmain.main(["doctor", "bench", "--root", root, "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["target"] == "bench"
    assert rep["platform"] == "cpu" and not rep.get("errors")
    assert rep["rules_evaluated"] == sorted(
        ["D001", "D002", "D003", "D004", "D005", "D006", "D007",
         "D008", "D009", "D010", "D011", "D012", "D016"])
    led = tledger.Ledger(os.path.join(root, tbench.STORE_DIR))
    assert led.query(kind="doctor", name="doctor-bench")


def test_the_rounds_write_the_reference_pngs(rounds):
    """With matplotlib, a round writes `occupancy-heatmap.png` from the
    batched fan-out's `wgl_batched_rounds` series beside occupancy.json,
    and the second round `bench-trajectory.png` (two rounds to draw)
    beside regressions.json; each is listed in `files` only when
    written."""
    root, lines = rounds
    first, second = (json.loads(ln[1][0]) for ln in lines)
    tel = os.path.join(root, tbench.TELEMETRY_DIR)
    traj = "artifacts/torch/telemetry/bench-trajectory.png"
    heat = "artifacts/torch/telemetry/occupancy-heatmap.png"
    assert traj not in first["regressions"]["files"]
    assert traj in second["regressions"]["files"]
    assert heat in first["occupancy_report"]["files"]
    # the headline-only round ran no fan-out: no heatmap listed
    assert heat not in second["occupancy_report"]["files"]
    for f in ("bench-trajectory.png", "occupancy-heatmap.png"):
        assert os.path.getsize(os.path.join(tel, f)) > 0
