#!/usr/bin/env python3
"""One CTA a lane against the cluster form of the wide lane-batched WGL
chunk (`wgln_chunk_batched`, `csrc/wgl_common.cuh`), in turns, on one
CUDA card.

Run from the repository root on a machine with a card:

    python3 scripts/wgln_cluster_turns.py [--out PATH]

For each shape (lanes, K) of a batch of adversarial-wave keys (the
fan-out waves' keys of `chip_smoke.py`, L 2, and the 16-wave history's,
L 3) it launches one 64-round chunk from the same start in each form:
one CTA a lane (`wgl32.block_form`) and the cluster form at every g
from 2 to 16 the card holds, the forms then the same reversed (a, b, b,
a), after one untimed launch of each, CUDA events around each launch.
Every output must equal the first form's on every carry leaf and the
summary, or the script fails. It
prints the card (`nvidia-smi` name and power limit), its SM count and
cluster capacities, and per shape each form's microseconds a round
(kernel time over the rounds the chunk ran: the lanes run side by side,
so this is a lane's round) and the form `wgln.batched_form` picks; the
rows also go to PATH as JSON (default
artifacts/torch/wgln_cluster_turns.json).
Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

ROUNDS = 64
# (what, wave history args, lanes, K values)
SHAPES = (
    ("fan-out waves", dict(n_waves=6, width=12, span=3), 8,
     (16, 32, 48, 64, 128, 256, 1024)),
    ("mesh waves", dict(n_waves=6, width=12, span=3), 2,
     (16, 32, 48, 64, 128, 256, 1024)),
    ("16-wave", dict(n_waves=16, width=14, span=5), 2, (16, 32, 64, 256)),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "artifacts" / "torch"
                                         / "wgln_cluster_turns.json"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("wgln_cluster_turns: no CUDA card", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import synth
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import encode, wgl32, wgln
    from jepsen_tpu_torch.parallel import batched

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    sms, cap = wgln.card_shape(dev)
    print(f"card: {card}; {sms} SMs; clusters of g CTAs held at once "
          f"{cap}", flush=True)

    def label(f):
        return (f"cluster g {f.blocks}" if f.name == "cluster"
                else f"one CTA ({f.name}, {f.threads} threads)")

    rows = []
    for what, hist_kw, lanes, Ks in SHAPES:
        hists = [synth.adversarial_wave_history(seed=s, **hist_kw)
                 for s in range(lanes)]
        encs = [encode.encode(cas_register(), h) for h in hists]
        b = batched.encode_batch(encs)
        plan = batched.vmap_plan(b, max(e.window_raw for e in encs), ROUNDS)
        L, ic = plan["L"], plan["ic"]
        consts = batched.batch_consts(b, plan, 50_000_000, dev)
        for K in Ks:
            start = wgln.init_carry_batch(lanes, K, L, ic, plan["H"],
                                          plan["B"], 0, dev)
            one = wgl32.block_form(K, 32 * L, ic, wgln.row_words(L, ic))
            forms = [one] + [wgl32.Form("cluster", wgl32.MAX_THREADS, g)
                             for g in (2, 4, 8, 16) if cap[g] >= 1]
            for f in forms:     # one untimed launch of each form first
                wgl32.launch_batched(
                    "wgln_chunk_batched", consts,
                    tuple(t.clone() for t in start), K=K, W=32 * L, L=L,
                    ic=ic, H=plan["H"], B=plan["B"], rounds=ROUNDS,
                    probes=plan["probes"], form=f)
            times: dict = {}
            first = None
            for f in forms + forms[::-1]:
                c = tuple(t.clone() for t in start)
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                s = wgl32.launch_batched(
                    "wgln_chunk_batched", consts, c, K=K, W=32 * L, L=L,
                    ic=ic, H=plan["H"], B=plan["B"], rounds=ROUNDS,
                    probes=plan["probes"], form=f)
                e1.record()
                torch.cuda.synchronize()
                times.setdefault(label(f), []).append(e0.elapsed_time(e1))
                if first is None:
                    first = (c, s)
                elif not (torch.equal(s, first[1]) and all(
                        torch.equal(x, y) for x, y in zip(c, first[0]))):
                    raise AssertionError(f"{what} K {K}: {label(f)} differs "
                                         f"from {label(forms[0])}")
            rounds = int(first[1][:, 5].max())
            us = {k: float(np.mean(v)) * 1e3 / max(rounds, 1)
                  for k, v in times.items()}
            pick = wgln.batched_form(lanes, K, L, ic, sms=sms, capacity=cap)
            R = K * (32 * L + ic)
            best = min(us, key=us.get)
            rows.append({"what": what, "lanes": lanes, "K": K, "L": L,
                         "ic": ic, "R": R, "rounds": rounds, "ms": times,
                         "us_per_round": us, "picked": label(pick),
                         "fastest": best, "card": card})
            print(f"{what} ({lanes} lanes, K {K}, L {L}, R {R}, {rounds} "
                  f"rounds): " + "; ".join(
                      f"{k} {[round(x, 4) for x in times[k]]} ms = "
                      f"{us[k]:.2f} us/round" for k in times)
                  + f"; fastest {best}; batched_form picks {label(pick)}",
                  flush=True)
            del start, first
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"card": card, "sms": sms, "capacity": cap, "rows": rows,
         "at": time.strftime("%Y-%m-%d %H:%M:%S")}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
