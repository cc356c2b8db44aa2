"""Clock-skew faults (parity with jepsen.nemesis.time,
`jepsen/src/jepsen/nemesis/time.clj`): uploads the C++ clock tools from
`native/clock/` to each node, compiles them there (time.clj:20-61), and
exposes a nemesis handling reset/strobe/bump/check-offsets ops, each
annotated with per-node clock offsets (time.clj:98-146). Generators
mirror the reference's randomized magnitudes (time.clj:148-205: bumps
±2^2..2^18 ms, strobes delta 4 ms–262 s / period 1 ms–1 s / ≤32 s).

The port's copy of `jepsen_tpu/nemesis/timefaults.py`. The clock tools'
sources are the repo's own `native/clock/`, shared with the reference
(`_SRC_DIR` resolves to the repository root from either package).
"""

from __future__ import annotations

import logging
import os
import time as _time
from typing import Callable, Optional

from .. import control as c
from ..control import nodeutil as cu
from . import RNG, Nemesis

log = logging.getLogger("jepsen_tpu_torch.nemesis.time")

DIR = "/opt/jepsen"
_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "clock")

_TOOLS = {"bump-time": "bump_time.cc", "strobe-time": "strobe_time.cc"}


def compile_tool(bin_name: str) -> str:
    """Upload + compile one tool on the bound node unless present
    (time.clj:20-49)."""
    with c.su():
        if not cu.file_exists(f"{DIR}/{bin_name}"):
            log.info("Compiling %s", bin_name)
            c.exec_("mkdir", "-p", DIR)
            c.exec_("chmod", "a+rwx", DIR)
            src = os.path.join(_SRC_DIR, _TOOLS[bin_name])
            c.upload(src, f"{DIR}/{bin_name}.cc")
            with c.cd(DIR):
                c.exec_("g++", "-O2", "-o", bin_name, f"{bin_name}.cc")
    return bin_name


def install() -> None:
    """Install the clock tools, adding a compiler if needed
    (time.clj:52-61)."""
    try:
        for b in _TOOLS:
            compile_tool(b)
    except Exception:  # noqa: BLE001
        from ..os_setup import CentOS, Debian
        try:
            Debian().install(["build-essential", "g++"])
        except Exception:  # noqa: BLE001
            CentOS().install(["gcc-c++"])
        for b in _TOOLS:
            compile_tool(b)


def parse_time(s: str) -> float:
    return float(s.strip())


def clock_offset(remote_time: float) -> float:
    """Remote clock minus control-node clock, seconds (time.clj:69-74)."""
    return remote_time - _time.time()


def current_offset() -> float:
    """Offset of the bound node's clock, in seconds (time.clj:76-79)."""
    return clock_offset(parse_time(c.exec_("date", "+%s.%N")))


def reset_time() -> None:
    """NTP-reset the bound node's clock (time.clj:81-85)."""
    with c.su():
        c.exec_("ntpdate", "-p", "1", "-b", "time.google.com")


def reset_time_all(test: dict) -> None:
    c.on_nodes(test, lambda t, n: reset_time())


def bump_time(delta_ms: float) -> float:
    """Adjust the bound node's clock by delta ms; returns offset seconds
    (time.clj:86-90)."""
    with c.su():
        return clock_offset(parse_time(
            c.exec_(f"{DIR}/bump-time", delta_ms)))


def strobe_time(delta_ms: float, period_ms: float, duration_s: float) -> None:
    """time.clj:92-96."""
    with c.su():
        c.exec_(f"{DIR}/strobe-time", delta_ms, period_ms, duration_s)


class ClockNemesis(Nemesis):
    """Handles {"f": "reset", "value": [nodes]},
    {"f": "strobe", "value": {node: {delta,period,duration}}},
    {"f": "bump", "value": {node: delta_ms}}, {"f": "check-offsets"}
    (time.clj:98-146). Completions carry clock_offsets per node."""

    def setup(self, test):
        def prep(t, node):
            install()
            cu.meh(lambda: c.exec_("service", "ntpd", "stop"))
            reset_time()
        c.on_nodes(test, prep)
        return self

    def invoke(self, test, op):
        f = op.get("f")
        if f == "reset":
            res = c.on_nodes(test, lambda t, n: (reset_time(),
                                                 current_offset())[1],
                             op.get("value"))
        elif f == "check-offsets":
            res = c.on_nodes(test, lambda t, n: current_offset())
        elif f == "strobe":
            m = op["value"]

            def do_strobe(t, node):
                spec = m[node]
                strobe_time(spec["delta"], spec["period"], spec["duration"])
                return current_offset()
            res = c.on_nodes(test, do_strobe, list(m.keys()))
        elif f == "bump":
            m = op["value"]
            res = c.on_nodes(test, lambda t, n: bump_time(m[n]),
                             list(m.keys()))
        else:
            raise ValueError(f"clock nemesis can't handle {f!r}")
        return {**op, "type": "info", "clock_offsets": res}

    def teardown(self, test):
        reset_time_all(test)

    def fs(self):
        return {"reset", "strobe", "bump", "check-offsets"}


def clock_nemesis() -> ClockNemesis:
    return ClockNemesis()


def random_nonempty_subset(nodes) -> list:
    ns = [n for n in nodes if RNG.random() < 0.5]
    return ns or [RNG.choice(list(nodes))]


def reset_gen(test, ctx):
    """Randomized reset op (time.clj:148-160)."""
    return {"type": "info", "f": "reset",
            "value": random_nonempty_subset(test["nodes"])}


def bump_gen(test, ctx):
    """Bumps ±2^2..2^18 ms, exponentially distributed (time.clj:162-177)."""
    return {"type": "info", "f": "bump",
            "value": {n: int(RNG.choice([-1, 1])
                             * 2 ** (2 + RNG.random() * 16))
                      for n in random_nonempty_subset(test["nodes"])}}


def strobe_gen(test, ctx):
    """Strobes: delta 4 ms–262 s, period 1 ms–1 s, ≤32 s
    (time.clj:179-197)."""
    return {"type": "info", "f": "strobe",
            "value": {n: {"delta": int(2 ** (2 + RNG.random() * 16)),
                          "period": int(2 ** (RNG.random() * 10)),
                          "duration": RNG.random() * 32}
                      for n in random_nonempty_subset(test["nodes"])}}


def clock_gen():
    """Random schedule of clock faults, starting with a check
    (time.clj:199-205)."""
    from .. import generator as gen
    return gen.phases({"type": "info", "f": "check-offsets"},
                      gen.mix([reset_gen, bump_gen, strobe_gen]))
