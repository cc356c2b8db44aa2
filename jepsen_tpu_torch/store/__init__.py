"""Results persistence: a copy of `jepsen_tpu/store/__init__.py`
(parity with jepsen.store, `jepsen/src/jepsen/store.clj`).

Each run gets `<root>/<name>/<start-time>/` with a binary `test.jepsen`
block file (crash-recoverable; see `.format`, byte-compatible with the
JAX package's), plain-text `history.txt` / `history.jsonl` /
`results.json` artifacts, a `jepsen.log` capturing the run's logging
(`start_logging` / `stop_logging`), and `latest` symlinks
(store.clj:40-62, 375-419, 436-464). Saves happen in three phases: 0
(test map, before the run), 1 (history, before analysis), 2 (results).

The root is the test map's `store_root`, else `BASE_DIR`: the port's own
store (`ledger.BASE_DIR`, `store/torch`), where `serve` browses the
port's runs and `ledger.Ledger` keeps its records. A run that the JAX
package stored is read by pointing `store_root` at its root.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

from ..ledger import BASE_DIR
from .format import JepsenFile

# Test-map keys that are live objects, not data (store.clj:92-100).
NONSERIALIZABLE_KEYS = ("db", "os", "net", "client", "nemesis", "checker",
                        "generator", "remote", "sessions", "store_writer",
                        "model", "tracer")


def serializable_test(test: dict) -> dict:
    drop = set(NONSERIALIZABLE_KEYS) | set(
        test.get("nonserializable_keys", ()))
    return {k: v for k, v in test.items() if k not in drop}


def path(test: dict, *components) -> str:
    """<root>/<name>/<start-time>/<...> (store.clj:40-62)."""
    name = test.get("name") or "unnamed"
    t = test.get("start_time") or "unknown"
    root = test.get("store_root", BASE_DIR)
    return os.path.join(root, str(name), str(t), *map(str, components))


def path_bang(test: dict, *components) -> str:
    """`path`, with its directory made."""
    p = path(test, *components)
    os.makedirs(os.path.dirname(p) if components else p, exist_ok=True)
    return p


def _ops_dicts(history) -> list:
    return [op.to_dict() if hasattr(op, "to_dict") else op
            for op in history]


def update_symlinks(test: dict) -> None:
    """<root>/latest and <root>/<name>/latest (store.clj:300-330)."""
    d = path(test)
    for link in (os.path.join(os.path.dirname(os.path.dirname(d)),
                              "latest"),
                 os.path.join(os.path.dirname(d), "latest")):
        try:
            if os.path.islink(link):
                os.unlink(link)
            os.symlink(os.path.relpath(d, os.path.dirname(link)), link)
        except OSError:
            pass


class Writer:
    """Three-phase persistence for one run (store.clj:366-419)."""

    def __init__(self, test: dict):
        self.dir = path_bang(test)
        self.jepsen = JepsenFile(os.path.join(self.dir, "test.jepsen"), "w")
        self.history_chunks: list = []

    def save_0(self, test: dict) -> None:
        """Initial test map, before the run (store.clj:375-382)."""
        self.jepsen.write_initial_test(serializable_test(test))
        update_symlinks(test)

    def append_history_chunk(self, ops: list) -> None:
        """Incremental history persistence mid-run."""
        self.history_chunks.append(
            self.jepsen.append_history_chunk(_ops_dicts(ops)))
        self.jepsen.save()

    def save_1(self, test: dict) -> None:
        """Test + complete history (store.clj:384-399): the history is
        committed before analysis, so a crashed analysis can be re-run."""
        ops = _ops_dicts(test.get("history") or [])
        t = serializable_test(test)
        if self.history_chunks:
            self.jepsen.write_history(t, chunk_ids=self.history_chunks)
        else:
            self.jepsen.write_history(t, ops=ops)
        with open(os.path.join(self.dir, "history.jsonl"), "w") as fh:
            for op in ops:
                fh.write(json.dumps(op, default=str) + "\n")
        with open(os.path.join(self.dir, "history.txt"), "w") as fh:
            for op in ops:
                fh.write("{:<12} {:<8} {:<12} {}\n".format(
                    str(op.get("process")), str(op.get("type")),
                    str(op.get("f")), str(op.get("value"))))

    def save_2(self, test: dict) -> None:
        """Results (store.clj:401-419)."""
        results = test.get("results") or {}
        self.jepsen.write_results(serializable_test(test), results)
        with open(os.path.join(self.dir, "results.json"), "w") as fh:
            json.dump(results, fh, indent=2, default=str)
        update_symlinks(test)

    def close(self):
        self.jepsen.close()


def load(name: str, start_time: str, store_root: str = BASE_DIR) -> dict:
    """Load a test lazily from disk (store.clj:121-131)."""
    jf = JepsenFile(os.path.join(store_root, name, str(start_time),
                                 "test.jepsen"), "r")
    return jf.read_test(lazy=True)


def load_latest(store_root: str = BASE_DIR) -> Optional[dict]:
    """The most recent run's whole test map, history and results
    included (store.clj:282 + load); what `analyze` re-checks."""
    d = latest(store_root)
    if d is None:
        return None
    jf = JepsenFile(os.path.join(d, "test.jepsen"), "r")
    try:
        return jf.read_test(lazy=False)
    finally:
        jf.close()


def tests(store_root: str = BASE_DIR) -> dict:
    """{name: {start-time: path}} for every stored run (store.clj:226)."""
    out: dict = {}
    if not os.path.isdir(store_root):
        return out
    for name in sorted(os.listdir(store_root)):
        d = os.path.join(store_root, name)
        if not os.path.isdir(d) or name == "latest":
            continue
        runs = {}
        for t in sorted(os.listdir(d)):
            rd = os.path.join(d, t)
            if os.path.isdir(rd) and t != "latest" \
                    and not os.path.islink(rd):
                runs[t] = rd
        if runs:
            out[name] = runs
    return out


def latest(store_root: str = BASE_DIR) -> Optional[str]:
    """Path of the most recent run (store.clj:282)."""
    link = os.path.join(store_root, "latest")
    if os.path.islink(link):
        return os.path.realpath(link)
    newest = None
    for name, runs in tests(store_root).items():
        for t, p in runs.items():
            if newest is None or t > newest[0]:
                newest = (t, p)
    return newest[1] if newest else None


_log_handler: Optional[logging.Handler] = None


def start_logging(test: dict) -> None:
    """Tee logging into <dir>/jepsen.log (store.clj:436-458): one root
    `logging.FileHandler`, replacing any that an earlier call left."""
    global _log_handler
    stop_logging()
    h = logging.FileHandler(os.path.join(path_bang(test), "jepsen.log"))
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s [%(name)s] %(message)s"))
    logging.getLogger().addHandler(h)
    _log_handler = h


def stop_logging() -> None:
    """Remove and close the handler `start_logging` added, if any."""
    global _log_handler
    if _log_handler is not None:
        logging.getLogger().removeHandler(_log_handler)
        _log_handler.close()
        _log_handler = None
