"""Clock-skew plot over time.

The port of `jepsen_tpu/checker/clock.py` (jepsen.checker.clock,
`jepsen/src/jepsen/checker/clock.clj`): collects the ``clock_offsets``
maps the clock nemesis attaches to its ops, producing per-node step
series of offset-vs-time, rendered to ``clock-skew.png`` with common
trailing node-name components stripped (clock.clj:36-45). Without
matplotlib `plot` writes nothing and returns None (`plots._plt`)."""

from __future__ import annotations

import logging
from typing import Optional

from ..history import History
from .plots import _plt, _save

log = logging.getLogger("jepsen_tpu_torch.checker.clock")


def history_datasets(history) -> dict:
    """{node: ([t_secs...], [offset...])} from ops carrying
    clock_offsets (clock.clj:13-34). Each series is extended to the
    final history time so step plots span the run."""
    series: dict = {}
    final_t = None
    for op in History(history):
        if op.time is not None and op.time >= 0:
            final_t = op.time / 1e9
        offsets = op.extra.get("clock_offsets") if op.extra else None
        if not offsets:
            continue
        t = op.time / 1e9 if op.time is not None and op.time >= 0 else 0.0
        for node, off in offsets.items():
            xs, ys = series.setdefault(node, ([], []))
            xs.append(t)
            ys.append(off)
    if final_t is not None:
        for xs, ys in series.values():
            if xs and xs[-1] < final_t:
                xs.append(final_t)
                ys.append(ys[-1])
    return series


def short_node_names(nodes) -> dict:
    """Strip common trailing domain components (clock.clj:36-45):
    ["n1.foo.com", "n2.foo.com"] -> {"n1.foo.com": "n1", ...}."""
    nodes = list(nodes)
    if len(nodes) < 2:
        return {n: n for n in nodes}
    parts = [str(n).split(".") for n in nodes]
    # how many trailing components are shared by all (proper suffix only)
    k = 0
    while (k < min(len(p) for p in parts) - 1
           and len({tuple(p[len(p) - k - 1:]) for p in parts}) == 1):
        k += 1
    return {n: ".".join(p[:len(p) - k]) for n, p in zip(nodes, parts)}


def plot(test, history, opts=None) -> Optional[str]:
    """Render clock-skew.png; None when no ops carry offsets
    (clock.clj:48-75)."""
    datasets = history_datasets(history)
    if not datasets:
        return None
    plt = _plt()
    if plt is None:
        return None
    names = short_node_names(datasets.keys())
    fig, ax = plt.subplots(figsize=(10, 4))
    for node in sorted(datasets, key=str):
        xs, ys = datasets[node]
        ax.step(xs, ys, where="post", label=names[node], lw=1.2)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Skew (s)")
    ax.set_title(f"{test.get('name', '')} clock skew")
    ax.legend(loc="upper right", fontsize=8)
    out = _save(fig, test, opts, "clock-skew.png")
    plt.close(fig)
    return out
