"""The port's `parallel.check_streamed` options against the JAX
package's: `race` and `register_keys` (the twins of
`tests/test_parallel.py`'s streamed race tests).

`race=True` races each key's device search against the host oracle (on
the CPU the device lane is the host kernel); `race=True` without
`oracle_fallback` raises the reference's `ValueError`; `race=False`
gives the raw device verdicts, equal to the JAX package's. With
`register_keys` a direct call over several keys resets the live
`fleet.RunStatus`'s key count as the reference's does, and
`check_batched` registers its key set once. The `gpu` case runs
`race=False` over the card.
"""

import pytest
import torch

from jepsen_tpu import fleet as jfleet
from jepsen_tpu import models as jmodels
from jepsen_tpu import synth as jsynth
from jepsen_tpu.parallel import batched as jbatched
from jepsen_tpu_torch import fleet as tfleet
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.ops import wgl32 as tw
from jepsen_tpu_torch.ops import wgl_ref as twgl_ref
from jepsen_tpu_torch.parallel import batched as tbatched

# the streamed keys are small: intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


def _race_hists():
    """tests/test_parallel.py::test_streamed_race_mode's keys."""
    return [jsynth.cas_register_history(300, n_procs=3, seed=s,
                                        lie_p=(0.05 if s == 1 else 0))
            for s in range(3)]


def _small_hists(n=3):
    return [jsynth.cas_register_history(60, n_procs=3, seed=s,
                                        lie_p=(0.1 if s == 1 else 0))
            for s in range(n)]


def test_streamed_race_mode_on_cpu():
    res = tbatched.check_streamed(tmodels.cas_register(),
                                  [to_port(h) for h in _race_hists()],
                                  race=True, device="cpu")
    assert [r["valid?"] for r in res] == [True, False, True]
    assert all(r.get("engine") in ("device", "oracle") for r in res)
    assert [r["shard"]["engine"] for r in res] == \
        [r["engine"] for r in res]


def test_streamed_race_rejects_no_fallback():
    for check, models, h in (
            (jbatched.check_streamed, jmodels,
             jsynth.cas_register_history(40, seed=0)),
            (tbatched.check_streamed, tmodels,
             to_port(jsynth.cas_register_history(40, seed=0)))):
        with pytest.raises(ValueError, match="race=True requires"):
            check(models.cas_register(), [h], race=True,
                  oracle_fallback=False)


def test_streamed_race_false_matches_reference_raw_verdicts():
    hists = _small_hists()
    want = jbatched.check_streamed(jmodels.cas_register(), hists,
                                   race=False, oracle_fallback=False)
    got = tbatched.check_streamed(tmodels.cas_register(),
                                  [to_port(h) for h in hists], race=False,
                                  oracle_fallback=False, device="cpu")
    assert [r["valid?"] for r in got] == [r["valid?"] for r in want] == \
        [True, False, True]
    assert [r["shard"]["engine"] for r in got] == \
        [r["shard"]["engine"] for r in want] == ["device"] * 3
    assert [r["shard"]["retries"] for r in got] == [0, 0, 0]


def _keys(fleet, fn):
    st = fleet.RunStatus(test="streamed", progress=False)
    st.begin_keys(10)
    with fleet.use(st):
        fn()
    k = st.snapshot()["keys"]
    return {n: k[n] for n in ("total", "decided", "live", "failures")}


@pytest.mark.parametrize("register_keys", [True, False])
def test_direct_call_registers_keys_like_reference(register_keys):
    hists = _small_hists()
    kw = dict(race=False, oracle_fallback=True, register_keys=register_keys)
    ref = _keys(jfleet, lambda: jbatched.check_streamed(
        jmodels.cas_register(), hists, **kw))
    port = _keys(tfleet, lambda: tbatched.check_streamed(
        tmodels.cas_register(), [to_port(h) for h in hists], device="cpu",
        **kw))
    assert port == ref
    assert port["total"] == (3 if register_keys else 10)
    assert port["decided"] == 3 and port["failures"] == 1


def test_check_batched_registers_keys_once_like_reference():
    hists = _small_hists()
    ref = _keys(jfleet, lambda: jbatched.check_batched(
        jmodels.cas_register(), hists, strategy="stream"))
    port = _keys(tfleet, lambda: tbatched.check_batched(
        tmodels.cas_register(), [to_port(h) for h in hists],
        strategy="stream", device="cpu"))
    assert port == ref == {"total": 3, "decided": 3, "live": 0,
                           "failures": 1}


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_streamed_race_false_on_card(cuda_device):
    """`race=False` over the card: the narrow chunk kernel decides every
    key, each verdict the host oracle's, and `begin_keys` is seen."""
    hists = [to_port(h) for h in _race_hists()]
    want = [twgl_ref.check(tmodels.cas_register(), h)["valid?"]
            for h in hists]
    before = tw.chunk.launches
    st = tfleet.RunStatus(test="streamed", progress=False)
    with tfleet.use(st):
        res = tbatched.check_streamed(tmodels.cas_register(), hists,
                                      race=False, device=cuda_device)
    assert tw.chunk.launches > before
    assert [r["valid?"] for r in res] == want == [True, False, True]
    assert all(r["shard"]["engine"] == "device" for r in res)
    assert st.snapshot()["keys"]["total"] == len(hists)
