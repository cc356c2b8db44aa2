"""Redirect printed output into report files
(jepsen/src/jepsen/report.clj:7-16).

The reference's `report/to` macro rebinds *out* to a file around a
body; the Python shape is a context manager:

    with report.to(os.path.join(run_dir, "set.txt")):
        print(results["set"])

The port's copy of `jepsen_tpu/report.py`, unchanged but for this
docstring.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
from pprint import pprint

__all__ = ["to", "pprint"]


@contextlib.contextmanager
def to(filename: str):
    """Bind stdout to `filename` for the duration of the block,
    creating parent directories; announces the report path on exit
    (report.clj:7-16)."""
    parent = os.path.dirname(filename)
    if parent:
        os.makedirs(parent, exist_ok=True)
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        yield buf
    finally:
        sys.stdout = old
        with open(filename, "w") as fh:
            fh.write(buf.getvalue())
        print("Report written to", filename)
