"""Build and bind the port's CUDA kernels and its host kernel.

Every `.cu` source under `jepsen_tpu_torch/csrc/` is compiled by `nvcc`
for `sm_90a` into a shared library with a plain C interface, built on
first use into `build/torch_kernels/` at the repository root and loaded
with `ctypes`. The library's file name carries a hash of the sources
and flags, so an edited source rebuilds and a stale library is never
loaded. Nothing here includes PyTorch's headers (a build that does
takes minutes); pointers and the stream cross as plain integers.

Every `.cpp` source there (`wgl_host.cpp`: the WGL chunk on one host
core; `elle_trim_host.cpp`: Elle's trim on one host core; both for CPU
tensors) is compiled the same way by the host compiler (`c++` or `g++`,
`HOST_FLAGS`) into the same directory, each under a hash of its own
source: a host build needs no `nvcc`, and a CUDA build no host
library. Their entry points (`HOST_KERNELS`) are bound with
`ctypes.CDLL`, which releases the GIL for the length of a call.

The compilers and `ctypes` are reached only from the first call, so
the package imports on machines without a toolkit. A build or launch
failure raises; nothing falls back to the plain PyTorch versions.

Each of those first-use costs reports to the compile guard
(`analysis/guards.note_compile`): one "build" per source `build_all`
compiles (with its nvcc seconds), one "load" per library `_load` opens
(`constant` loads through it), one "bind" per entry point `_lib` binds;
the host library's build and load are a "host_build" and a
"host_load", their entry points' binds "bind"s. The bound paths
(`launch`, `host_call` after the first) report nothing.
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

HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

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


def _build(sources, lib_path, cmd, kind: str, tool: str,
           log_key=None) -> dict:
    """Build each of `sources` whose library (`lib_path(src)`) is not on
    disk yet, one compiler run each (`cmd(src, out)`), all started
    together, each into a file of its own process moved into place
    (`os.replace`), so that processes building at once never load a
    half-written library. Each build reports a compile of `kind` to the
    guard. Returns {stem: None when already built, else {source,
    seconds} and, under `log_key`, the compiler's stderr}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict = {}
    running = []
    for src in sources:
        lib = lib_path(src)
        if lib.exists():
            out[src.stem] = None
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.Popen(cmd(src, tmp), stdout=subprocess.PIPE,
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
        guards.note_compile(kind, seconds, src.stem)
        out[src.stem] = {"source": str(src.relative_to(_PKG.parent)),
                         "seconds": seconds}
        if log_key:
            out[src.stem][log_key] = err.strip()
    if failed:
        raise RuntimeError(f"{tool} failed for " + "; ".join(failed))
    return out


def build_all() -> dict:
    """Build every kernel source whose library is not on disk yet, one
    `nvcc` per source, all started together. Returns {name: None when
    the library was already built, else {source, seconds, ptxas}: the
    build time and the `-Xptxas -v` register and shared-memory
    report}."""
    return _build(sorted(CSRC.glob("*.cu")), _lib_path,
                  lambda src, out: [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o",
                                    str(out), str(src)],
                  "build", "nvcc", log_key="ptxas")


# The C entry points, by function name: (source stem under csrc/,
# device pointers, int32 scalars). Every entry point takes its pointers,
# then its ints, then the stream, and returns cudaGetLastError(); each
# library exports `<stem>_error_string` beside them.
KERNELS = {
    # the WGL chunk loop (csrc/wgl_common.cuh); the last ints are the
    # launch form (ops/wgl32.py::FORM_FIELDS): threads and shared bytes,
    # the wide kernels' blocks between them
    "wgl32_chunk": ("wgl32_chunk", 14, 15),
    "wgln_chunk": ("wgln_chunk", 14, 16),
    # the same loop with a lane axis, one CTA per lane (threads, shared
    # bytes) or, for the wide kernel, one cluster per lane (blocks)
    "wgl32_chunk_batched": ("wgl32_chunk", 17, 14),
    "wgln_chunk_batched": ("wgln_chunk", 17, 15),
    # the clusters of a size (int) the card holds at once, written to a
    # host int32 (ops/wgln.py::card_shape); launches nothing
    "wgln_chunk_cluster_fit": ("wgln_chunk", 1, 1),
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
        bound = {KERNELS[n][0] for n in _LIBS if n in KERNELS}
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


# ---------------------------------------------------------------------------
# the host kernel (csrc/*.cpp), built with the host compiler
# ---------------------------------------------------------------------------

# The host entry points, by function name: (source stem under csrc/,
# host pointers, int32 scalars). Each returns 0 or an error code, which
# its library's `<stem>_error_string` names. The solo chunk's pointers end with a
# cancel word (or null: ops/wgl32.py::CancelFlag), its ints are K, W, L,
# ic, H, B, rounds, probes, n_pad, S, O, n_ok, n_info, max_cfg; the
# batched chunk's pointers end with the lanes' n_ok, n_info and max_cfg,
# its ints are K, W, L, ic, H, B, rounds, probes, n_pad, S, O, lanes
# (ops/wgl32.py::host_chunk, host_chunk_batched). The trim's pointers
# are trim_ref's nine inputs, then live, counts and bodies; its ints
# n_pad, d_in, d_out, S, p_pad, use_rt, use_proc, counts_rows
# (elle/tpu.py::trim).
HOST_KERNELS = {
    "wgl32_host_chunk": ("wgl_host", 14, 14),
    "wgln_host_chunk": ("wgl_host", 14, 14),
    "wgl32_host_chunk_batched": ("wgl_host", 16, 12),
    "wgln_host_chunk_batched": ("wgl_host", 16, 12),
    "elle_trim_host": ("elle_trim_host", 12, 8),
}


def _host_cxx() -> str:
    for name in ("c++", "g++"):
        cand = shutil.which(name)
        if cand:
            return cand
    raise RuntimeError("no host C++ compiler (c++ or g++) found: the host "
                       "kernels are built from source")


def _host_lib_path(src: Path) -> Path:
    # a host source includes nothing of the others: its own hash
    h = hashlib.sha256()
    h.update(src.name.encode())
    h.update(src.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_host(stems=None) -> dict:
    """Build every host source (or those of `stems`) whose library is
    not on disk yet, one host-compiler run per source, all started
    together. Returns {name: None when already built, else {source,
    seconds}}."""
    sources = sorted(CSRC.glob("*.cpp")) if stems is None else [
        CSRC / f"{s}.cpp" for s in stems]
    return _build(sources, _host_lib_path,
                  lambda src, out: [_host_cxx(), *HOST_FLAGS, "-o",
                                    str(out), str(src)],
                  "host_build", "the host compiler")


def _host_bind(name: str):
    """The binding of host entry point `name` (a HOST_KERNELS key):
    (ctypes function, error-string function, pointer count, int
    count), its library built on first use and bound once."""
    import ctypes

    from ..analysis import guards

    stem, n_ptrs, n_ints = HOST_KERNELS[name]
    with _LOCK:
        if name not in _LIBS:
            path = _host_lib_path(CSRC / f"{stem}.cpp")
            if not path.exists():
                build_host([stem])
            t0 = time.monotonic()
            lib = ctypes.CDLL(str(path))
            guards.note_compile("host_load", time.monotonic() - t0, stem)
            t0 = time.monotonic()
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = (fn, err, n_ptrs, n_ints)
            guards.note_compile("bind", time.monotonic() - t0, name)
        return _LIBS[name]


def host_call(name: str, ptrs, ints) -> None:
    """Call host entry point `name` (a HOST_KERNELS key) with its host
    pointers and int32 scalars, and raise on its error code. The call
    runs without the GIL."""
    fn, err, n_ptrs, n_ints = _LIBS.get(name) or _host_bind(name)
    if len(ptrs) != n_ptrs or len(ints) != n_ints:
        raise ValueError(f"{name} takes {n_ptrs} pointers and {n_ints} "
                         "ints")
    rc = fn(*ptrs, *ints)
    if rc != 0:
        raise RuntimeError(f"{name} failed: {err(rc).decode()} (code {rc})")
