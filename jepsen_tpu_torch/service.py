"""The checker service's canonical shape buckets.

The port of the bucketing half of `jepsen_tpu/service.py`: requests
quantize into canonical buckets so that "the same workload again" lands
in the SAME bucket, and so on kernels the warm plane already built,
loaded and launched (`ops/aot.precompile_service_bucket`). Padding into
a bucket (`ops/wgl._apply_bucket`) keeps verdicts exact. The admission
queue, the worker pool and the request plane are not ported yet.
"""

from __future__ import annotations

# Shape-bucket quanta, the reference's: coarse on purpose, a serving
# pool trades padded lanes for warm-hit rate (narrow windows always run
# at W_eff 32, the branch maximum, so that per-request concurrency
# jitter cannot fragment the warm set).
BUCKET_N_QUANTUM = 256
BUCKET_IC_QUANTUM = 32
NARROW_W_EFF = 32
# model-table quanta: the observed op alphabet (and so the (S, O)
# transition table) varies per history; both axes pad with -1
BUCKET_S_QUANTUM = 16
BUCKET_O_QUANTUM = 32


def _quantize(n: int, q: int) -> int:
    return max(q, ((int(n) + q - 1) // q) * q)


def bucket_for(enc) -> tuple:
    """(key, bucket) for one encoding: the canonical quantized shape
    bucket the request serves under, deterministic from the encoding
    alone, so that identical workloads key the same warm kernels.
    `ic_eff` pins to `ic_pad` so that `wgl.derive_plan` resolves the same
    effective widths for every member of the bucket."""
    from .ops.encode import _pad_to
    from .ops.wgl import _packable
    wide = enc.window_raw > 32
    w_eff = _pad_to(enc.window_raw, 32) if wide else NARROW_W_EFF
    n_pad = _quantize(len(enc.inv), BUCKET_N_QUANTUM)
    ic_pad = _quantize(max(len(enc.inv_info), 1), BUCKET_IC_QUANTUM)
    S = _quantize(int(enc.table.shape[0]), BUCKET_S_QUANTUM)
    O = _quantize(int(enc.table.shape[1]), BUCKET_O_QUANTUM)
    pack = bool(_packable(enc))
    bucket = {"n_pad": n_pad, "ic_pad": ic_pad, "S": S, "O": O,
              "w_eff": int(w_eff), "ic_eff": ic_pad, "n_cap": n_pad,
              "pack": pack}
    key = ("wgl", "wide" if wide else "narrow", n_pad, ic_pad, S, O,
           int(w_eff), pack)
    return key, bucket
