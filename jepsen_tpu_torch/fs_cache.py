"""Control-node persistent cache for expensive artifacts: a copy of the
JAX package's `jepsen_tpu/fs_cache.py` (parity with jepsen.fs-cache,
`jepsen/src/jepsen/fs_cache.clj:1-278`). Cache values live under
logical paths (tuples of strings/ints/bools), stored as strings, JSON
data, or files, with atomic writes and per-path locks.

The port keeps its own root (`DIR`, `~/.jepsen_tpu_torch/cache`): the
warm plane's plan registry (`parallel/mesh.warm_plan`,
`ops/aot.precompile_service_plan`) must never read a plan the JAX
package recorded, which names XLA executables the port does not have.
The reference's remote save/deploy helpers (they drive a cluster's
nodes) are not copied."""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from contextlib import contextmanager
from typing import Any, Optional, Sequence

DIR = os.path.expanduser("~/.jepsen_tpu_torch/cache")

_locks: dict = {}
_locks_guard = threading.Lock()


def _encode_component(x) -> str:
    """Path components encode to filesystem-safe strings
    (fs_cache.clj Encode protocol, :80-138)."""
    if isinstance(x, bool):
        return f"b-{x}"
    if isinstance(x, int):
        return f"i-{x}"
    if isinstance(x, str):
        safe = "".join(ch if ch.isalnum() or ch in "-_." else "_"
                       for ch in x)
        return f"s-{safe}"
    raise TypeError(f"can't encode cache path component {x!r}")


def fs_path(path: Sequence) -> str:
    assert path, "empty cache path"
    return os.path.join(DIR, *[_encode_component(x) for x in path])


def cached(path: Sequence) -> bool:
    return os.path.exists(fs_path(path))


def clear(path: Optional[Sequence] = None) -> None:
    if path is None:
        shutil.rmtree(DIR, ignore_errors=True)
    else:
        p = fs_path(path)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        elif os.path.exists(p):
            os.unlink(p)


def atomic_write(dest: str, writer) -> None:
    """Write via temp file + rename (fs_cache.clj:140-160)."""
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dest))
    try:
        with os.fdopen(fd, "wb") as fh:
            writer(fh)
        os.replace(tmp, dest)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_string(path: Sequence, s: str) -> str:
    atomic_write(fs_path(path), lambda fh: fh.write(s.encode()))
    return s


def load_string(path: Sequence) -> Optional[str]:
    try:
        with open(fs_path(path), "rb") as fh:
            return fh.read().decode()
    except FileNotFoundError:
        return None


def save_data(path: Sequence, value: Any) -> Any:
    """JSON analog of save-edn! (fs_cache.clj:213-222)."""
    atomic_write(fs_path(path),
                 lambda fh: fh.write(json.dumps(value).encode()))
    return value


def load_data(path: Sequence) -> Any:
    s = load_string(path)
    return None if s is None else json.loads(s)


def list_data(prefix: Sequence) -> list:
    """Every JSON value cached under a logical path prefix (depth-
    first) — the registry walk `aot.precompile_cached_mesh_plans`
    uses to re-warm all recorded mesh plans after a process restart.
    Unreadable or non-JSON entries are skipped, not raised: a torn
    cache entry must not break warm-up."""
    root = fs_path(prefix)
    out = []
    if os.path.isfile(root):
        try:
            with open(root, "rb") as fh:
                out.append(json.loads(fh.read().decode()))
        except (OSError, ValueError):
            pass
        return out
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for f in sorted(files):
            try:
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out.append(json.loads(fh.read().decode()))
            except (OSError, ValueError):
                continue
    return out


def save_file(path: Sequence, local_file: str) -> str:
    atomic_write(fs_path(path),
                 lambda fh: shutil.copyfileobj(open(local_file, "rb"), fh))
    return local_file


def load_file(path: Sequence) -> Optional[str]:
    p = fs_path(path)
    return p if os.path.exists(p) else None


@contextmanager
def locking(path: Sequence):
    """Lock a cache path (fs_cache.clj:272-278)."""
    key = fs_path(path)
    with _locks_guard:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        yield
