"""End-to-end parity of the port's wide-window search (32 < W <= 1024).

The port's `ops.wgl.check` on `device="cpu"` (the plain PyTorch
`wgln.chunk_ref` under the CPU plan: 128-round chunks, the wide ladder)
must agree with the JAX package's `wgl.check` on the verdict, configs
explored, rounds, final beam width K and the ladder's path. Both run
the same plan on the same search, so the counts are equal, not merely
within the oracle's slack. The corpora are those of
`tests/test_wgl_adversarial.py`, regenerated here. `derive_plan` of the
two packages agrees on wide windows, and a wide window with the ladder
off keeps its K where the narrow window's legacy escalation widens it.
"""

import pytest
import jax
import torch

from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch.models import core as tmodels
from jepsen_tpu_torch.ops import encode as tencode
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wgl_ref as tref

# intra-op threads only contend with the other test workers
torch.set_num_threads(1)

CORPUS = {
    # ~26k configs; False is proven by exhausting the space
    "wave-exhaustive": lambda s: s.adversarial_wave_history(4, width=10,
                                                            span=4, seed=3),
    "wave-valid": lambda s: s.adversarial_wave_history(4, width=8, span=3,
                                                       seed=5, invalid=False),
    "long-tail": lambda s: s.long_tail_history(120, seed=3),
}


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


def _key(res):
    u = res.get("util", {})
    return {"valid?": res["valid?"],
            "configs_explored": res.get("configs_explored"),
            "rounds": u.get("rounds"), "K": res.get("K"),
            "adapt_path": u.get("adapt", {}).get("path")}


@pytest.mark.parametrize("name", list(CORPUS))
def test_check_matches_jax_and_oracle(name):
    hist = CORPUS[name](jsynth)
    want = jwgl.check(jmodels.cas_register(), hist)
    got = twgl.check(tmodels.cas_register(), to_port(hist), device="cpu")
    assert _key(got) == _key(want), name
    assert got["W"] == want["W"] and got["W_pad"] == want["W_pad"]
    assert got["valid?"] == tref.check(tmodels.cas_register(),
                                       to_port(hist))["valid?"]


def test_wide_corpora_take_the_wide_kernel():
    for name in ("wave-exhaustive", "long-tail"):
        enc = tencode.encode(tmodels.cas_register(),
                             to_port(CORPUS[name](jsynth)))
        assert enc.window_raw > 32, name


def test_synth_matches_jax():
    for name, make in CORPUS.items():
        assert ([o.to_dict() for o in make(tsynth)]
                == [o.to_dict() for o in make(jsynth)]), name
    assert ([o.to_dict() for o in tsynth.fifo_queue_history(300, seed=4)]
            == [o.to_dict() for o in jsynth.fifo_queue_history(300, seed=4)])


@pytest.mark.parametrize("cap", ["conftest", "unset"])
@pytest.mark.parametrize("accel", [True, False])
@pytest.mark.parametrize("window", [33, 71, 657, 1024])
def test_derive_plan_matches_jax(window, accel, cap, monkeypatch):
    if cap == "unset":
        monkeypatch.delenv("JEPSEN_TPU_MAX_FRONTIER", raising=False)
    for n, n_info, ic_pad in ((229, 0, 32), (6000, 44, 64)):
        for kw in ({}, {"adaptive": False}, {"frontier": 128}):
            got = twgl.derive_plan(window_raw=window, ic_pad=ic_pad, n=n,
                                   n_info=n_info, accel=accel, **kw)
            want = jwgl.derive_plan(window_raw=window,
                                    W=twgl._pad_to_mult(window, 32),
                                    ic_pad=ic_pad, n=n, n_info=n_info,
                                    accel=accel, **kw)
            assert got["kern"] == "wgln"
            assert got == {k: want[k] for k in got}, (n, kw)


def test_derive_plan_card_plans(monkeypatch):
    """The card's plans for the two histories `chip_smoke.py` drives."""
    monkeypatch.delenv("JEPSEN_TPU_MAX_FRONTIER", raising=False)
    wave = twgl.derive_plan(window_raw=71, ic_pad=32, n=229, n_info=0,
                            accel=True)
    tail = twgl.derive_plan(window_raw=657, ic_pad=32, n=657, n_info=0,
                            accel=True)
    assert (wave["L"], wave["ladder"], wave["B"], wave["H"]) == (
        3, (256, 2048, 4096), 1 << 20, 1 << 23)
    assert (tail["L"], tail["ladder"][0], tail["B"]) == (21, 256, 1 << 18)
    assert wave["chunk"] == tail["chunk"] == 512


@pytest.mark.parametrize("name", ["wave-exhaustive", "narrow"])
def test_legacy_escalation_is_narrow_only(name, monkeypatch):
    """With the ladder off, the legacy one-shot escalation widens the
    beam to 512 past `_ESCALATE_AT` explored configs, for narrow
    windows only (the JAX package's `enc.window_raw <= 32` guard): a
    wide window keeps its K. The threshold is lowered in both packages
    so that a small search crosses it."""
    monkeypatch.setenv("JEPSEN_TPU_MAX_FRONTIER", "64")
    monkeypatch.setattr(jwgl, "_ESCALATE_AT", 2000)
    monkeypatch.setattr(twgl, "_ESCALATE_AT", 2000)
    if name == "narrow":
        hist = jsynth.cas_register_history(1500, n_procs=5, seed=4)
    else:
        hist = CORPUS[name](jsynth)
    wide = jencode.encode(jmodels.cas_register(), hist).window_raw > 32
    want = jwgl.check(jmodels.cas_register(), hist, adaptive=False)
    got = twgl.check(tmodels.cas_register(), to_port(hist), adaptive=False,
                     device="cpu")
    assert _key(got) == _key(want)
    assert got["configs_explored"] >= 2000
    assert got["K"] == (64 if wide else 512)
