"""The bool-window WGL chunk (`jepsen_tpu_torch/ops/wgl_bool.py`,
reached through `ops/wgl._build_search` / `_compiled_search`) against
the JAX package's `ops/wgl._compiled_search`, the jitted `chunk_fn`.

The same encoding (the JAX package's `encode`, consts in
`aot._wgl_consts_spec` order) goes through both chunks from the same
start; after every chunk, until the search stops, all 13 carry leaves
must be bit-identical (windows and info masks as bools, the memo table
as uint32 words). Four inputs: a 200-op cas-register history with
crashes (info successors), a wide wave history (W 64), a memo table of
64 slots (probes that find no empty slot) and an 8-row backlog
(overflow). The `gpu` cases hold the `wgl_chunk` kernel against the
plain chunk on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import cas_register
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wgl_bool

torch.set_num_threads(1)

PROBES = 4
_ENC: dict = {}

# name -> (history, K, H, B, chunk, max_cfg)
CASES = {
    "cas-crashes": (lambda: jsynth.cas_register_history(
        200, n_procs=5, seed=4, crash_p=0.05), 16, 1 << 12, 4096, 4, 10**8),
    "wave-w64": (lambda: jsynth.adversarial_wave_history(
        4, width=10, span=4, seed=3, invalid=False), 32, 1 << 14, 4096, 8,
        10**8),
    "tiny-table": (lambda: jsynth.cas_register_history(
        200, n_procs=5, seed=4, crash_p=0.05), 16, 64, 4096, 16, 3000),
    "tiny-backlog": (lambda: jsynth.cas_register_history(
        200, n_procs=5, seed=4, crash_p=0.05), 4, 1 << 12, 8, 16, 10**8),
}


def _encoded(name):
    if name not in _ENC:
        _ENC[name] = jencode.encode(cas_register(), CASES[name][0]())
    return _ENC[name]


def _arrays(enc):
    return (enc.inv, enc.ret, enc.opcode, enc.sufminret, enc.inv_info,
            enc.opcode_info, enc.table)


def _shape(enc, K, H, B, chunk):
    S, O = enc.table.shape
    return (len(enc.inv), len(enc.inv_info), enc.window, S, O, K, H, B,
            chunk, PROBES)


def _verdict(leaves):
    flags, fr_cnt = leaves[wgl_bool.FLAGS], int(leaves[wgl_bool.FR_CNT])
    if flags[0]:
        return True
    if fr_cnt == 0:
        return "unknown" if flags[1] else False
    return "unknown"


def _run_both(name):
    """Every chunk through the JAX package and the port from the same
    carry, compared leaf by leaf; returns the final leaves."""
    _, K, H, B, chunk, max_cfg = CASES[name]
    enc = _encoded(name)
    arrays = _arrays(enc)
    consts_j = tuple(jnp.asarray(a) for a in arrays) + (
        jnp.int32(enc.n_ok), jnp.int32(enc.n_info), jnp.int32(max_cfg))
    consts_t = wgl_bool.consts_from_numpy(*arrays, enc.n_ok, enc.n_info,
                                          max_cfg, device="cpu")
    shape = _shape(enc, K, H, B, chunk)
    init_j, chunk_j = jwgl._compiled_search(*shape)
    init_t, chunk_t = twgl._build_search(*shape)
    carry_j, carry_t = init_j(0), init_t(0, device="cpu")
    leaves = None
    for step in range(400):
        carry_j = chunk_j(consts_j, carry_j)
        # copies: the next call donates the JAX carry's buffers
        leaves = [np.array(x) for x in carry_j]
        got = chunk_t(consts_t, carry_t)
        assert got is carry_t
        for i, (a, b) in enumerate(zip(wgl_bool.carry_to_numpy(carry_t),
                                       leaves)):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, i)
            np.testing.assert_array_equal(
                a, b, err_msg=f"{name}: chunk {step}, leaf {i}")
        stats = leaves[wgl_bool.STATS]
        if (leaves[wgl_bool.FLAGS][0] or int(leaves[wgl_bool.FR_CNT]) == 0
                or stats[0] >= max_cfg):
            return leaves, step + 1
    raise AssertionError(f"{name}: the search did not stop")


def test_init_carry_matches_jax_init_fn():
    enc = _encoded("cas-crashes")
    shape = _shape(enc, 16, 1 << 12, 4096, 4)
    init_j, _ = jwgl._build_search(*shape)
    init_t, _ = twgl._build_search(*shape)
    for i, (a, b) in enumerate(zip(
            wgl_bool.carry_to_numpy(init_t(3, device="cpu")), init_j(3))):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def test_crashes_bit_identical_every_chunk():
    leaves, chunks = _run_both("cas-crashes")
    assert chunks > 2
    assert _verdict(leaves) is True
    # info successors ran: some frontier or backlog row took an info op
    assert leaves[wgl_bool.BK_INFO].any() or leaves[wgl_bool.FR_INFO].any()
    hist = CASES["cas-crashes"][0]()
    assert jwgl.check(cas_register(), hist)["valid?"] is True


def test_wide_window_bit_identical_every_chunk():
    enc = _encoded("wave-w64")
    assert enc.window == 64 and enc.window_raw > 32
    leaves, chunks = _run_both("wave-w64")
    assert chunks > 2
    assert _verdict(leaves) is True
    hist = CASES["wave-w64"][0]()
    assert jwgl.check(cas_register(), hist)["valid?"] is True


def test_full_table_bit_identical_every_chunk():
    """64 memo slots: probes run out of empty slots and the rows that
    could not insert survive as new; the config budget stops it."""
    leaves, _ = _run_both("tiny-table")
    table = leaves[wgl_bool.TABLE]
    assert int((table[:, 0] != 0).sum()) == 64
    ref, _ = _run_both("cas-crashes")
    # re-exploration: fewer memo hits for more configs than the roomy run
    assert leaves[wgl_bool.STATS][3] < ref[wgl_bool.STATS][3]


def test_overflow_bit_identical_every_chunk():
    """An 8-row backlog overflows; the exhausted frontier then answers
    "unknown" in both packages."""
    leaves, _ = _run_both("tiny-backlog")
    assert leaves[wgl_bool.FLAGS][1]
    assert _verdict(leaves) == "unknown"


@pytest.mark.parametrize("W,ic,probes", [(40, 32, 4), (32, 8, 4),
                                         (2048, 32, 4), (32, 288, 4),
                                         (32, 32, 9)])
def test_check_launch_refuses_what_the_kernel_does_not_take(W, ic, probes):
    consts = (torch.zeros(64, dtype=torch.int32),) * 3 + (
        torch.zeros(65, dtype=torch.int32),
        torch.zeros(ic, dtype=torch.int32),
        torch.zeros(ic, dtype=torch.int32),
        torch.zeros((4, 4), dtype=torch.int32), 1, 0, 100)
    carry = wgl_bool.init_carry(4, W, ic, 64, 8, 0, "cpu")
    with pytest.raises(ValueError):
        wgl_bool.check_launch(consts, carry, K=4, W=W, ic=ic, H=64, B=8,
                              chunk=4, probes=probes)


def test_check_launch_takes_a_plain_shape():
    enc = _encoded("cas-crashes")
    consts = wgl_bool.consts_from_numpy(*_arrays(enc), enc.n_ok,
                                        enc.n_info, 100, device="cpu")
    carry = wgl_bool.init_carry(16, enc.window, len(enc.inv_info), 64, 8, 0,
                                "cpu")
    wgl_bool.check_launch(consts, carry, K=16, W=enc.window,
                          ic=len(enc.inv_info), H=64, B=8, chunk=4, probes=4)
    assert wgl_bool.sort_rows(16, 32, 32) == 1024
    assert wgl_bool.sort_rows(2, 32, 32) == 128


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_chunk_on_card(cuda_device, name):
    _, K, H, B, chunk, max_cfg = CASES[name]
    enc = _encoded(name)
    consts = wgl_bool.consts_from_numpy(*_arrays(enc), enc.n_ok, enc.n_info,
                                        max_cfg, device=cuda_device)
    shape = _shape(enc, K, H, B, chunk)
    init_fn, chunk_k = twgl._compiled_search(*shape)
    _, chunk_p = twgl._build_search(*shape)
    carry = init_fn(0, device=cuda_device)
    before = wgl_bool.chunk.launches
    for step in range(400):
        ref = chunk_p(consts, tuple(t.clone() for t in carry))
        chunk_k(consts, carry)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(carry, ref)):
            assert torch.equal(a, b), (name, step, i)
        if bool(carry[wgl_bool.FLAGS][0]) or int(carry[wgl_bool.FR_CNT]) == 0 \
                or int(carry[wgl_bool.STATS][0]) >= max_cfg:
            break
    assert wgl_bool.chunk.launches == before + step + 1
