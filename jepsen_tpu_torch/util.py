"""Device resolution for the port's entry points, shard streams,
`bounded_pmap`, the jax-free helpers of `jepsen_tpu/util.py` that the
checker compositions and reports use (`polysort_key`,
`integer_interval_set_str`, `nemesis_intervals`, `Multiset`), and those
the run orchestration uses (`majority`, `real_pmap`, the relative-time
clock `with_relative_time` / `relative_time_nanos`, `timeout`,
`await_fn`, `with_retry`, `rand_exp`).

Every entry point takes `device=None`, which means the CUDA card. There
is no silent fallback: asking for CUDA where there is none raises, and
the CPU runs only when the caller names it (the tests do), where every
kernel wrapper takes its plain PyTorch version. The fan-out and Elle
entry points also take `devices=`, a list of devices that plays the
reference's device mesh (`default_devices`, every card, when none is
named); an entry may repeat, and then several shards share one device.
"""

from __future__ import annotations

import contextlib
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Callable, Iterable, Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` -> the current CUDA device; otherwise `torch.device(device)`.
    Raises RuntimeError when a CUDA device is asked for and CUDA is not
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def default_devices(n_devices: Optional[int] = None) -> list:
    """Every visible card, each once (the reference's `default_mesh`),
    or the first `n_devices` of them. Raises without a card, as
    `resolve_device` does."""
    resolve_device("cuda")   # raises the no-card error
    devs = [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]
    return devs[:int(n_devices)] if n_devices else devs


def resolve_devices(devices: Optional[Sequence] = None,
                    device=None) -> list:
    """The device list of an entry point that takes `devices=`: each
    entry of `devices` through `resolve_device` (repeats kept: they are
    shards sharing a device), else `[resolve_device(device)]` when one
    device is named, else every visible card (`default_devices`).
    Raises ValueError on an empty list."""
    if devices is None:
        return [resolve_device(device)] if device is not None \
            else default_devices()
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("an empty device list")
    return out


def shard_streams(devices: Sequence[torch.device]) -> list:
    """One new `torch.cuda.Stream` per CUDA entry of a device list (None
    for a CPU entry), so that shards sharing a card overlap on it as
    shards on separate cards would."""
    return [torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in devices]


def on_stream(stream):
    """`torch.cuda.stream(stream)` for a shard's stream; nothing for a
    CPU shard (None)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


_SAME_DEVICE = contextlib.nullcontext()


def _index(dev) -> int:
    idx = dev if isinstance(dev, int) else dev.index
    return torch._C._cuda_getDevice() if idx is None else idx


def on_device(dev):
    """`torch.cuda.device(dev)` for a launch on `dev` (a CUDA device or
    its index), or nothing when `dev` is already the current device (the
    context switch costs two device exchanges on the host). For a caller
    that holds a tensor on `dev`, so CUDA is initialised."""
    idx = _index(dev)
    if idx == torch._C._cuda_getDevice():
        return _SAME_DEVICE
    return torch.cuda.device(idx)


def raw_stream(dev) -> int:
    """The cudaStream_t of the current stream of `dev` (a CUDA device or
    its index), as an int: what a kernel's C entry point takes, read
    without making a `torch.cuda.Stream`."""
    return torch._C._cuda_getCurrentRawStream(_index(dev))


def device_name(device: torch.device) -> str:
    """The card's name (`torch.cuda.get_device_name`), or "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def bounded_pmap(f: Callable, coll: Sequence, max_workers: int = 16) -> list:
    """pmap with a bounded worker pool (jepsen.util/bounded-pmap
    parity): `f` over `coll` on at most `max_workers` threads, results
    in order."""
    coll = list(coll)
    if not coll:
        return []
    with ThreadPoolExecutor(max_workers=min(max_workers, len(coll))) as ex:
        return list(ex.map(f, coll))


def polysort_key(x):
    """Sort key tolerant of mixed types: ints first in numeric order,
    everything else by string (jepsen.util/polysort parity)."""
    if isinstance(x, int) and not isinstance(x, bool):
        return (0, x, "")
    return (1, 0, str(x))


def integer_interval_set_str(xs: Iterable) -> str:
    """A set of integers in compact interval notation, e.g. #{1-3 5 7-9}
    (jepsen.util/integer-interval-set-str parity). Non-integer elements
    are rendered plainly."""
    xs = sorted(xs, key=polysort_key)
    parts = []
    i = 0
    while i < len(xs):
        x = xs[i]
        if isinstance(x, int) and not isinstance(x, bool):
            j = i
            while (j + 1 < len(xs) and isinstance(xs[j + 1], int)
                   and xs[j + 1] == xs[j] + 1):
                j += 1
            parts.append(f"{x}-{xs[j]}" if j > i else str(x))
            i = j + 1
        else:
            parts.append(str(x))
            i += 1
    return "#{" + " ".join(parts) + "}"


def nemesis_intervals(history, fs_start=("start",), fs_stop=("stop",)):
    """Nemesis start/stop events paired into (start-op, stop-op-or-None)
    intervals (jepsen.util/nemesis-intervals parity, util.clj:736): the
    invocations and the completions are paired separately, so both the
    [start-invoke stop-invoke] and the [start-complete stop-complete]
    windows come out; a stop closes every start still open."""
    intervals = []
    open_invokes: list = []
    open_completes: list = []
    for op in history:
        if op.process != "nemesis":
            continue
        if op.f in fs_start:
            (open_invokes if op.is_invoke else open_completes).append(op)
        elif op.f in fs_stop:
            if op.is_invoke:
                intervals.extend((s, op) for s in open_invokes)
                open_invokes = []
            else:
                intervals.extend((s, op) for s in open_completes)
                open_completes = []
    intervals.extend((s, None) for s in open_invokes + open_completes)
    return intervals


class Multiset:
    """A small multiset (the reference's total-queue accounting leans on
    org.clojure/multiset, checker.clj:628-687)."""

    def __init__(self, items: Iterable = ()):
        self.counts: dict = {}
        for x in items:
            self.add(x)

    def add(self, x, n: int = 1):
        self.counts[x] = self.counts.get(x, 0) + n

    def __len__(self):
        return sum(self.counts.values())

    def __contains__(self, x):
        return self.counts.get(x, 0) > 0

    def __iter__(self):
        for x, c in self.counts.items():
            for _ in range(c):
                yield x

    def __eq__(self, other):
        return isinstance(other, Multiset) and self.counts == other.counts

    def __repr__(self):
        return f"Multiset({dict(self.counts)})"

    def intersect(self, other: "Multiset") -> "Multiset":
        m = Multiset()
        for x, c in self.counts.items():
            k = min(c, other.counts.get(x, 0))
            if k > 0:
                m.add(x, k)
        return m

    def minus(self, other: "Multiset") -> "Multiset":
        m = Multiset()
        for x, c in self.counts.items():
            k = c - other.counts.get(x, 0)
            if k > 0:
                m.add(x, k)
        return m

    def to_sorted_list(self):
        try:
            return sorted(self)
        except TypeError:
            return list(self)


# -- the run orchestration's helpers (jepsen_tpu/util.py:14-30, 261-390,
# 421-424): majority math, real_pmap, the relative-time clock, timeouts
# and retries --

def majority(n: int) -> int:
    """Smallest integer strictly greater than half of n
    (jepsen.util/majority parity: for 5 -> 3, for 0 -> 1)."""
    return n // 2 + 1


def minority(n: int) -> int:
    """Largest number of nodes that is still a minority."""
    return (n - 1) // 2


def minority_third(n: int) -> int:
    """Byzantine-fault threshold: largest f with 3f < n
    (jepsen.util/minority-third parity)."""
    return max(0, (n - 1) // 3)


def real_pmap(f: Callable, coll: Sequence) -> list:
    """Apply f to every element in its own thread; wait for all; raise the
    most interesting exception if any failed (jepsen.util/real-pmap parity,
    util.clj:65-77 — 'interesting' = prefer non-interrupt exceptions)."""
    coll = list(coll)
    if not coll:
        return []
    results: list = [None] * len(coll)
    errors: list = [None] * len(coll)

    def run(i, x):
        try:
            results[i] = f(x)
        except BaseException as e:  # noqa: BLE001 — rethrown below
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i, x), daemon=True)
               for i, x in enumerate(coll)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errs = [e for e in errors if e is not None]
    if errs:
        # Prefer "interesting" exceptions over interrupts/cancellations.
        boring = (KeyboardInterrupt, SystemExit)
        interesting = [e for e in errs if not isinstance(e, boring)]
        raise (interesting[0] if interesting else errs[0])
    return results


# -- relative-time clock (jepsen.util/with-relative-time, util.clj:326-347).
# Process-global, like the reference's dynamic var: all worker threads share
# the test's time origin. --
_global_origin: Optional[int] = None


def linear_time_nanos() -> int:
    return _time.monotonic_ns()


@contextmanager
def with_relative_time():
    """Zero the test clock for the duration of the block."""
    global _global_origin
    prev = _global_origin
    _global_origin = linear_time_nanos()
    try:
        yield
    finally:
        _global_origin = prev


def relative_time_nanos() -> int:
    origin = _global_origin
    if origin is None:
        raise RuntimeError("relative_time_nanos outside with_relative_time")
    return linear_time_nanos() - origin


def sleep_nanos(dt: int) -> None:
    if dt > 0:
        _time.sleep(dt / 1e9)


class TimeoutError_(Exception):
    pass


def timeout(seconds: float, f: Callable, *args, default=TimeoutError_):
    """Run f in a thread with a timeout (jepsen.util/timeout macro parity).
    Returns default on timeout (or raises it if it's an exception class).
    The worker thread is abandoned, not killed — f should be interruptible
    or side-effect-safe."""
    result: list = []
    err: list = []

    def run():
        try:
            result.append(f(*args))
        except BaseException as e:  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        if isinstance(default, type) and issubclass(default, BaseException):
            raise default(f"timed out after {seconds}s")
        return default
    if err:
        raise err[0]
    return result[0]


def await_fn(f: Callable, retry_interval: float = 1.0,
             timeout_s: float = 60.0, log_message: Optional[str] = None):
    """Poll f until it returns non-exceptionally (jepsen.util/await-fn
    parity, util.clj:383)."""
    deadline = _time.monotonic() + timeout_s
    last: Optional[BaseException] = None
    while _time.monotonic() < deadline:
        try:
            return f()
        except Exception as e:  # noqa: BLE001
            last = e
            _time.sleep(retry_interval)
    raise TimeoutError_(log_message or f"await_fn timed out after {timeout_s}s") \
        from last


def with_retry(f: Callable, retries: int = 5, backoff: float = 0.1):
    """Call f, retrying up to `retries` times with fixed backoff."""
    for attempt in range(retries + 1):
        try:
            return f()
        except Exception:
            if attempt == retries:
                raise
            _time.sleep(backoff)


def rand_exp(rng, mean: float) -> float:
    """Exponentially distributed random value with the given mean."""
    return rng.expovariate(1.0 / mean) if mean > 0 else 0.0
