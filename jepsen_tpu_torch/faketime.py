"""libfaketime wrappers: run DB binaries under scaled/offset clocks
(parity with jepsen.faketime, `jepsen/src/jepsen/faketime.clj`): wraps an
executable in a faketime shell script so its process sees a clock that
starts offset and runs at a different rate.

The port's copy of `jepsen_tpu/faketime.py`.
"""

from __future__ import annotations

import random as _random
from typing import Optional

from . import control as c
from .control import nodeutil as cu
from .control.core import lit

RNG = _random.Random()


def install() -> None:
    """Install libfaketime from source on the bound node
    (faketime.clj:8-22). Uses the distro package when available, falling
    back to a source build."""
    with c.su():
        try:
            c.exec_("which", "faketime")
            return
        except Exception:  # noqa: BLE001
            pass
        c.exec_("mkdir", "-p", "/tmp/jepsen")
        with c.cd("/tmp/jepsen"):
            if not cu.file_exists("libfaketime"):
                c.exec_("git", "clone",
                        "https://github.com/wolfcw/libfaketime.git",
                        "libfaketime")
            with c.cd("libfaketime"):
                c.exec_("make")
                c.exec_("make", "install")


def script(cmd: str, init_offset: float, rate: float) -> str:
    """A shell script invoking cmd under faketime (faketime.clj:24-35):
    clock starts `init_offset` seconds skewed and runs at `rate`x."""
    off = int(init_offset)
    sign = "-" if off < 0 else "+"
    return ("#!/bin/bash\n"
            f'faketime -m -f "{sign}{abs(off)}s x{float(rate)}" '
            f'{c.expand_path(cmd)} "$@"\n')


def wrap(cmd: str, init_offset: float, rate: float) -> None:
    """Replace an executable with a faketime wrapper, moving the original
    to <cmd>.no-faketime. Idempotent (faketime.clj:37-48)."""
    orig = cmd + ".no-faketime"
    wrapper = script(orig, init_offset, rate)
    if not cu.file_exists(orig):
        c.exec_("mv", cmd, orig)
    cu.write_file(wrapper, cmd)
    c.exec_("chmod", "a+x", cmd)


def unwrap(cmd: str) -> None:
    """Remove the wrapper, restoring the original (faketime.clj:50-56)."""
    orig = cmd + ".no-faketime"
    if cu.file_exists(orig):
        c.exec_("mv", orig, cmd)


def rand_factor(factor: float) -> float:
    """A rate drawn around 1 with max/min ratio = factor
    (faketime.clj:57-65)."""
    hi = 2 / (1 + 1 / factor)
    lo = hi / factor
    return lo + RNG.random() * (hi - lo)
