"""`python -m jepsen_tpu_torch.bench [--device DEV] [--ops N]`: the
port's headline number.

The reference bench's headline (`bench.py`'s `headline()`): a
cas-register history of N invocations (default 10000; 5 processes,
seed 42, crash probability 0.002) checked once cold by `ops/wgl.check`
in a fresh process, then re-checked warm inside
`CompileGuard(name="bench-warm")`, on the card unless `--device cpu`.
It prints one JSON line:

    {"metric": "cas_register_10k_wgl_wall_s", "value": <warm wall s>,
     "unit": "s", "verdict": true, "cold_s": ..., "platform": "gpu",
     "device_kind": "<card name>", "compiles": 0, "d2h": ..., "h2d": 1,
     "guard": {<the guard's report>},
     "configs": {"cas_register_10k": {<verdict, wall, K, util, ...>}}}

and exits non-zero when the warm verdict is not True (the history is
valid). The rest of the reference bench (the platform probe, the extra
configurations, the ledger and the regression gate) is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

# the keys of a check's result a config entry keeps (the reference's
# `_config_entry`)
CONFIG_KEYS = ("W", "W_pad", "K", "configs_explored", "cause", "engine",
               "route_reason", "shape", "util", "device_row", "oracle_row",
               "mesh", "streamed_row", "speedup_vs_streamed", "parity")


def _config_entry(res: dict, wall: float) -> dict:
    """One configuration's entry: verdict, wall, op count and the result
    keys of CONFIG_KEYS it has, its occupancy block compacted and its
    measured device memory, as in the reference."""
    out = {"verdict": res.get("valid?"), "wall_s": wall,
           "op_count": res.get("op_count")}
    for k in CONFIG_KEYS:
        if res.get(k) is not None:
            out[k] = res[k]
    occ = res.get("occupancy")
    if isinstance(occ, dict):
        out["occupancy"] = {k: occ.get(k) for k in
                            ("kernel", "K", "rounds_total",
                             "rounds_dropped", "fill", "memo", "roofline")}
    if isinstance(res.get("hbm"), dict):
        out["hbm"] = res["hbm"]
    return out


def _timed(fn, *args, **kw):
    t0 = time.monotonic()
    res = fn(*args, **kw)
    return res, time.monotonic() - t0


def run(n_ops: int = 10000, device=None) -> dict:
    """The headline's cold check and guarded warm re-check on `device`
    (None: the card), each under the reference's time budget
    (JEPSEN_TPU_BENCH_BUDGET_S, default 120 s); returns the JSON line's
    dict."""
    from .analysis import guards
    from .models import cas_register
    from .ops import wgl
    from .synth import cas_register_history
    from .util import device_name, resolve_device

    dev = resolve_device(device)
    budget = float(os.environ.get("JEPSEN_TPU_BENCH_BUDGET_S", "120"))
    model = cas_register()
    hist = cas_register_history(n_ops, n_procs=5, seed=42, crash_p=0.002)
    name = f"cas_register_{n_ops // 1000}k"

    def check():
        res = wgl.check(model, hist, time_limit=budget, device=dev)
        if dev.type == "cuda":
            import torch
            torch.cuda.synchronize(dev)
        return res

    _, cold_s = _timed(check)
    g = guards.CompileGuard(name="bench-warm")
    with g:
        res, warm_s = _timed(check)
    return {"metric": f"{name}_wgl_wall_s", "value": warm_s, "unit": "s",
            "verdict": res.get("valid?"), "cold_s": cold_s,
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "device_kind": device_name(dev),
            "compiles": g.compiles, "d2h": g.d2h, "h2d": g.h2d,
            "guard": g.report(),
            "configs": {name: _config_entry(res, warm_s)}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.bench",
        description="the port's headline: a cold check of the 10k-op "
                    "cas-register history, then a guarded warm re-check")
    ap.add_argument("--device", default=None,
                    help="where the checks run (default: the card)")
    ap.add_argument("--ops", type=int, default=10000,
                    help="invocations in the history (default 10000)")
    args = ap.parse_args(argv)
    line = run(args.ops, device=args.device)
    print(json.dumps(line), flush=True)
    return 0 if line["verdict"] is True else 1


if __name__ == "__main__":
    sys.exit(main())
