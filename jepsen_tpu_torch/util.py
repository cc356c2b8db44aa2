"""Device resolution for the port's entry points, and `bounded_pmap`.

Every entry point takes `device=None`, which means the CUDA card. There
is no silent fallback: asking for CUDA where there is none raises, and
the CPU runs only when the caller names it (the tests do), where every
kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

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
