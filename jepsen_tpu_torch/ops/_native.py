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

Each of those first-use costs reports to the compile guard
(`analysis/guards.note_compile`): one "build" per source `build_all`
compiles (with its nvcc seconds), one "load" per library `_load` opens
(`constant` loads through it), one "bind" per entry point `_lib` binds.
The bound-launch path (`launch` after the first) reports nothing.
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
    from ..analysis import guards

    failed = []
    for src, lib, tmp, t0, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, lib)
        seconds = time.monotonic() - t0
        guards.note_compile("build", seconds, src.stem)
        out[src.stem] = {"source": str(src.relative_to(_PKG.parent)),
                         "seconds": seconds, "ptxas": err.strip()}
    if failed:
        raise RuntimeError("nvcc failed for " + "; ".join(failed))
    return out


# The C entry points, by function name: (source stem under csrc/,
# device pointers, int32 scalars). Every entry point takes its pointers,
# then its ints, then the stream, and returns cudaGetLastError(); each
# library exports `<stem>_error_string` beside them.
KERNELS = {
    # the WGL chunk loop (csrc/wgl_common.cuh); the last ints are the
    # launch form (ops/wgl32.py::FORM_FIELDS): threads and shared bytes,
    # the solo wide kernel's blocks between them
    "wgl32_chunk": ("wgl32_chunk", 14, 15),
    "wgln_chunk": ("wgln_chunk", 14, 16),
    # the same loop with a lane axis, one CTA per lane (threads, shared
    # bytes)
    "wgl32_chunk_batched": ("wgl32_chunk", 17, 14),
    "wgln_chunk_batched": ("wgln_chunk", 17, 14),
    # Elle's closures and trim
    "elle_closure_square": ("elle_closure", 3, 2),
    "elle_closure_labels": ("elle_closure", 5, 3),
    # the packed and sharded squarings take the tensor-core product's
    # scratch (bit transpose, A and T tile flags) after the count
    "elle_packed_square": ("elle_packed", 6, 2),
    "elle_packed_labels": ("elle_packed", 5, 3),
    # the tensor cores' rate probe (variant, iterations, blocks)
    "elle_bitmm_rate": ("elle_packed", 1, 3),
    # the trim's ints end with the masked slots its scratch has room for
    "elle_trim": ("elle_trim", 13, 9),
    # one block barrier-and-reduce step, timed (iterations)
    "elle_trim_step_probe": ("elle_trim", 1, 1),
    # the mesh scheduler's lane reset (its one pointer is a host block of
    # int64 arguments, parallel/mesh.py::RESET_WORDS) and batched
    # frontier migration
    "wgl_lane_reset": ("wgl_lanes", 1, 0),
    "wgl_frontier_migrate": ("wgl_lanes", 2, 4),
    # one squaring of a word-column shard of the packed closure
    "elle_sharded_square": ("elle_sharded", 7, 3),
    # the bool-window WGL chunk (the reference's general search)
    "wgl_chunk": ("wgl_chunk", 21, 13),
}


# Sizes the kernels' sources own, by exported function name: (source
# stem). Each function takes nothing and returns an int.
CONSTANTS = {
    # int32 words of the grid form's control block after the scratch
    "wgln_chunk_grid_ctl_words": "wgln_chunk",
}
_CONSTANTS: dict = {}


def cold_sources(names) -> list:
    """The source stems of the entry points `names` (KERNELS keys) whose
    library this process has neither bound nor found built on disk: what
    a first launch of each would build with nvcc."""
    stems = sorted({KERNELS[n][0] for n in names})
    with _LOCK:
        bound = {KERNELS[n][0] for n in _LIBS}
    return [s for s in stems
            if s not in bound and not _lib_path(CSRC / f"{s}.cu").exists()]


def _load(stem: str):
    """The library of source `stem`, built first when it is not on
    disk. Call with _LOCK held."""
    import ctypes

    from ..analysis import guards

    path = _lib_path(CSRC / f"{stem}.cu")
    if not path.exists():
        build_all()
    t0 = time.monotonic()
    lib = ctypes.CDLL(str(path))
    guards.note_compile("load", time.monotonic() - t0, stem)
    return lib


def _lib(name: str):
    """The binding of entry point `name` (a KERNELS key): (ctypes
    function, error-string function, pointer count, int count), its
    library built on first use and bound once."""
    import ctypes

    from ..analysis import guards

    stem, n_ptrs, n_ints = KERNELS[name]
    with _LOCK:
        if name not in _LIBS:
            lib = _load(stem)
            t0 = time.monotonic()
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = (fn, err, n_ptrs, n_ints)
            guards.note_compile("bind", time.monotonic() - t0, name)
        return _LIBS[name]


def constant(name: str) -> int:
    """The value of the exported size `name` (a CONSTANTS key), its
    library built on first use; read once."""
    value = _CONSTANTS.get(name)
    if value is None:
        import ctypes

        with _LOCK:
            fn = getattr(_load(CONSTANTS[name]), name)
            fn.argtypes, fn.restype = [], ctypes.c_int
            value = _CONSTANTS[name] = int(fn())
    return value


def launch(name: str, ptrs, ints, stream) -> None:
    """Launch entry point `name` (a KERNELS key) with its device
    pointers and int32 scalars on `stream`, and raise on a launch
    error. Once the entry point is bound this is a dict lookup, the
    argument counts and the ctypes call (ctypes converts the ints): no
    lock is taken and no list is rebuilt."""
    bound = _LIBS.get(name) or _lib(name)
    fn, err, n_ptrs, n_ints = bound
    if len(ptrs) != n_ptrs or len(ints) != n_ints:
        raise ValueError(f"{name} takes {n_ptrs} pointers and {n_ints} "
                         "ints")
    rc = fn(*ptrs, *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err(rc).decode()} (cuda {rc})")
