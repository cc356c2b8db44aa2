#!/usr/bin/env python
"""The walls of the two packages' Elle checks on the host CPU, in turns.

    python scripts/elle_cpu_twins.py [--n 3000] [--seed 3] [--checks 6]
                                     [--turns 2] [--port-root DIR]

`elle.append.check` on `synth.list_append_history(n, seed=seed)` and
`elle.wr.check` on `synth.wr_register_history(n, seed=seed)`, with
`cycle_backend="auto"`: the port (`jepsen_tpu_torch`, `device="cpu"`)
and the JAX package (`jepsen_tpu`, pinned to its CPU platform). Each
package runs in `turns` fresh processes, the two packages in turns (the
port first in even turns); a process runs each check once cold, then
`checks` times warm. Only the warm walls count. A process imports one
package and nothing of the other.

Prints each process's walls, the trim's seconds (`cycle-util.kernel_s`),
route and kernel, and torch's thread count, then one JSON line: per
check the medians and maxima of both packages, and whether the port's
median is at most the JAX package's and its slowest run at most twice
the JAX package's slowest. `--port-root` runs the port from another
checkout (an older tree unpacked with `git archive`). Exits 1 when a
verdict, route or kernel differs between the packages.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(pkg: str, root: str, n: int, seed: int, checks: int) -> dict:
    """One fresh process's checks: {kind: {walls, trim_s, ...}}."""
    sys.path.insert(0, root)
    if pkg == "port":
        import torch

        from jepsen_tpu_torch import synth
        from jepsen_tpu_torch.elle import append, wr
        extra = {"device": "cpu"}
        threads = torch.get_num_threads()
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        from jepsen_tpu import synth
        from jepsen_tpu.elle import append, wr
        extra = {}
        threads = None
    out = {"threads": threads}
    for kind, check, gen in (
            ("append", append.check, synth.list_append_history),
            ("wr", wr.check, synth.wr_register_history)):
        h = gen(n, seed=seed)
        walls, trims = [], []
        for k in range(checks + 1):
            t0 = time.monotonic()
            res = check(h, cycle_backend="auto", **extra)
            wall = time.monotonic() - t0
            u = res.get("cycle-util") or {}
            if k:
                walls.append(wall)
                trims.append(u.get("kernel_s"))
        out[kind] = {"walls": walls, "trim_s": trims,
                     "valid": res["valid?"],
                     "engine": res.get("cycle-engine"),
                     "kernel": u.get("kernel"),
                     "iters_run": u.get("iters_run")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--checks", type=int, default=6)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--port-root", default=REPO)
    ap.add_argument("--child", choices=("port", "reference"))
    a = ap.parse_args()
    if a.child:
        root = a.port_root if a.child == "port" else REPO
        print(json.dumps(child(a.child, root, a.n, a.seed, a.checks)))
        return 0

    runs: dict = {"port": [], "reference": []}
    for turn in range(a.turns):
        order = ("port", "reference") if turn % 2 == 0 else (
            "reference", "port")
        for pkg in order:
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", pkg,
                 "--n", str(a.n), "--seed", str(a.seed), "--checks",
                 str(a.checks), "--port-root", a.port_root],
                cwd=REPO, env=env, capture_output=True, text=True)
            if p.returncode != 0:
                print(p.stderr[-4000:], file=sys.stderr)
                return 1
            r = json.loads(p.stdout.strip().splitlines()[-1])
            runs[pkg].append(r)
            print(f"turn {turn} {pkg} (torch threads {r['threads']}):",
                  flush=True)
            for kind in ("append", "wr"):
                k = r[kind]
                print(f"  {kind}: {k['valid']} {k['engine']} "
                      f"{k['kernel']} iters_run {k['iters_run']}; walls "
                      f"{[round(w, 4) for w in k['walls']]} s; trim "
                      f"{k['trim_s']} s", flush=True)
    summary, same = {}, True
    for kind in ("append", "wr"):
        got = {pkg: [w for r in runs[pkg] for w in r[kind]["walls"]]
               for pkg in runs}
        keys = {pkg: {(r[kind]["valid"], r[kind]["engine"],
                       r[kind]["kernel"], r[kind]["iters_run"])
                      for r in runs[pkg]} for pkg in runs}
        same = same and keys["port"] == keys["reference"] and len(
            keys["port"]) == 1
        pm, rm = (statistics.median(got[p]) for p in ("port", "reference"))
        summary[kind] = {
            "port_median": pm, "reference_median": rm,
            "port_max": max(got["port"]),
            "reference_max": max(got["reference"]),
            "median_met": pm <= rm,
            "max_met": max(got["port"]) <= 2 * max(got["reference"]),
            "route": sorted(map(list, keys["port"]))}
    print(json.dumps({"n": a.n, "seed": a.seed, "checks": a.checks,
                      "turns": a.turns, "same_route_and_verdict": same,
                      "summary": summary}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
