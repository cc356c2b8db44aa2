"""Build and bind the port's CUDA kernels.

Every `.cu` source under `jepsen_tpu_torch/csrc/` is compiled by `nvcc`
for `sm_90a` into a shared library with a plain C interface, built on
first use into `build/torch_kernels/` at the repository root and loaded
with `ctypes`. The library's file name carries a hash of the sources
and flags, so an edited source rebuilds and a stale library is never
loaded. Nothing here includes PyTorch's headers (a build that does
takes minutes); pointers and the stream cross as plain integers.

`nvcc` and `ctypes` are reached only from the first launch, so the
package imports on machines without a toolkit. A build or launch
failure raises; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Build every kernel source whose library is not on disk yet, one
    `nvcc` per source, all started together. Returns {name: None when
    the library was already built, else {source, seconds, ptxas}: the
    build time and the `-Xptxas -v` register and shared-memory
    report}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict = {}
    running = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = _lib_path(src)
        if lib.exists():
            out[src.stem] = None
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((src, lib, tmp, time.monotonic(), proc))
    failed = []
    for src, lib, tmp, t0, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, lib)
        out[src.stem] = {"source": str(src.relative_to(_PKG.parent)),
                         "seconds": time.monotonic() - t0,
                         "ptxas": err.strip()}
    if failed:
        raise RuntimeError("nvcc failed for " + "; ".join(failed))
    return out


def _lib(name: str):
    """The ctypes library of `csrc/<name>.cu`, built on first use and
    bound once. Every chunk kernel has the same C interface (14 device
    pointers, 13 int32 scalars, the stream; `csrc/wgl_common.cuh`)."""
    import ctypes

    with _LOCK:
        if name not in _LIBS:
            path = _lib_path(CSRC / f"{name}.cu")
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 13
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = (fn, err)
        return _LIBS[name]


def launch(name: str, ptrs, ints, stream) -> None:
    """Launch the chunk kernel `name` (`wgl32_chunk` or `wgln_chunk`:
    14 device pointers, 13 int32 scalars, the stream) and raise on a
    launch error."""
    fn, err = _lib(name)
    if len(ptrs) != 14 or len(ints) != 13:
        raise ValueError(f"{name} takes 14 pointers and 13 ints")
    rc = fn(*ptrs, *[int(x) for x in ints], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err(rc).decode()} (cuda {rc})")
