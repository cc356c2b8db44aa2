"""Device resolution for the port's entry points, shard streams, and
`bounded_pmap`.

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
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Union

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
