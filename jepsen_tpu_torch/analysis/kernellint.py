"""Kernel-host lint for the launch paths (AST-based, stdlib-only).

The port's counterpart of `jepsen_tpu/analysis/jaxlint.py`. There is no
jit here: each device program is a hand-written CUDA kernel behind a
Python launch wrapper (`_native.launch`), and the perf-critical host
code is the wrappers, the poll loops around them and the kernel builds
beneath them. The footguns change shape but not kind — a hidden host
sync in a wrapper, a Python branch on a card tensor, a build per call —
and none fails loudly; they serialize the card or rebuild per
invocation. This linter encodes them as static rules, each the twin of
a jaxlint rule:

  K001 host-sync-in-launch   (J001) `.item()`, `.tolist()`, `.cpu()`,
                             `.numpy()`, `torch.cuda.synchronize()`,
                             a stream's or an event's `.synchronize()`,
                             or `bool()`/`int()`/`float()` of a tensor
                             inside a launch wrapper (below) — each
                             stalls the host on the card's queue at
                             every launch (`.tolist()` / `.item()` of
                             a local made by `np.*` is a host read)
  K002 tensor-branch         (J002) Python `if`/`while` in a launch
                             wrapper whose condition reads a tensor
                             (`.any()`, `.all()`, `.item()`, or a
                             comparison of a tensor local) — an
                             implicit device->host sync per launch
  K003 uncached-build        (J003) a kernel build or load
                             (`_native.build_all`, `_native._load`,
                             `torch.utils.cpp_extension.load` /
                             `load_inline`, `triton.jit(...)` as a
                             call) in a function with no caching
                             decorator on its enclosing chain — a
                             build every call
  K004 param-build           (J004) a build or library lookup
                             (`_native._load` / `_lib`, `cpp_extension
                             .load*`, `triton.jit(...)`) whose name or
                             defines come from a parameter of an
                             uncached function — one build per
                             distinct value
  K005 dtype-promotion       (J005) arithmetic mixing two *different*
                             explicit integer `torch` dtypes in one
                             expression — implicit promotion drifts
                             dtypes away from the kernels' int32 ABI
  K006 python-loop-launch    (J006) a kernel launch (`_native.launch`
                             of an entry point with a batched twin, a
                             `chunk` / `launch`, or an in-module
                             launch wrapper) inside a Python `for ...
                             in range(...)` over lanes or rows — one
                             launch per lane where the batched kernel
                             takes them all
  K007 transfer-in-loop      (J007) a host sync inside a HOST-side
                             poll loop — each iteration pays a
                             device->host round trip; the static twin
                             of the transfer budget
                             `guards.CompileGuard` enforces at
                             runtime. `.synchronize()` counts
                             anywhere; the reads count on a value a
                             call made (or was handed) in the loop.
                             While-loops check every form; for-loops
                             only the unambiguous syncs (`.cpu()`,
                             `.synchronize()`), since `.tolist()` over
                             a host array is idiomatic numpy
  K008 carry-copy            (J008) a chunk wrapper that copies its
                             `carry` / `state` argument (`.clone()`,
                             `.contiguous()`, `.to(...)`) on every call
                             — the port's chunks update the carry in
                             place, so a copy is a multi-MB device
                             copy per chunk

Launch wrappers are resolved per module: the functions whose own body
calls `_native.launch`, and the functions whose own body calls one of
those by bare name when it is a helper named `*launch*` (the port's
`launch` / `launch_batched` / `_launch`). Tensor
locals are the names a wrapper assigns from a `torch.*` call or from an
expression over tensor locals (one forward pass; `.shape`, `.dtype`,
`.device`, `.numel()`, `.data_ptr()`, `len()` are static).

Allowlist: a `# kernellint: ok(K001)` (or `ok(K001,K006)`, or a bare
`# kernellint: ok`) comment on the flagged line — or on the line
directly above it — suppresses the finding. A file-level
`# kernellint: ok-file(K003,K006)` within the first 20 lines suppresses
the named rules for the whole module (never a bare form — file-wide
suppression must name its rules). Every allowlist in the tree is an
explicit, reviewable decision with its reason beside it.

CLI (the twin of the reference's `scripts/jax_lint.py`):

    python -m jepsen_tpu_torch.analysis.kernellint [--check]
        [--list-rules] [--rules K001,K007] [--changed-only] [paths...]

No paths: `DEFAULT_PATHS` (`jepsen_tpu_torch/ops`, `elle`, `parallel`
and `bench.py`). Exit 0 clean, 1 findings remain after the allowlist,
254 a usage error; `--check` only changes verbosity.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Optional

RULES = {
    "K001": "host-sync-in-launch",
    "K002": "tensor-branch",
    "K003": "uncached-build",
    "K004": "param-build",
    "K005": "dtype-promotion",
    "K006": "python-loop-launch",
    "K007": "transfer-in-loop",
    "K008": "carry-copy",
}

# chunk-wrapper carry parameter names K008 keys on: the re-fed search
# carry the port's chunks update in place.
_CARRY_PARAMS = {"carry", "state"}
_CARRY_COPIES = {"clone", "contiguous", "to"}

_CACHE_DECORATORS = {"lru_cache", "cache", "cached_property"}
# methods that read a card tensor back to the host (or wait for it)
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# of those, the ones that are a device sync whatever their receiver:
# `.tolist()` / `.item()` / `.numpy()` are also host numpy idioms
_UNAMBIGUOUS_SYNCS = {"cpu", "synchronize"}
_TENSOR_TESTS = {"any", "all", "item"}
# comparisons that read no tensor's values (`out is None`, `k in d`)
_IDENTITY_OPS = (ast.Is, ast.IsNot, ast.In, ast.NotIn)
# attribute / call forms that read only a tensor's metadata
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                 "data_ptr", "numel", "size", "element_size", "stride",
                 "dim", "type", "index"}
_STATIC_FUNCS = {"len", "isinstance", "getattr", "hasattr", "type", "id"}
# `torch.<x>` calls that make no tensor
_TORCH_NON_TENSOR = {"device", "Size", "dtype", "is_tensor", "cuda",
                     "get_default_dtype", "finfo", "iinfo", "Generator"}
_INT_DTYPES = {"int8", "int16", "int32", "int64", "uint8", "uint16",
               "uint32", "uint64", "short", "int", "long"}
# builds and loads of a kernel library (K003), and the lookups whose
# argument names a library (K004)
_NATIVE_BUILDS = {"build_all", "_load"}
_NATIVE_LOOKUPS = {"_load", "_lib"}
_EXT_BUILDS = {"load", "load_inline"}
# entry points with a lane-batched twin (`_native.KERNELS`), and the
# wrapper names whose `_batched` twin exists (`ops/wgl32.py`,
# `ops/wgln.py`)
_BATCHED_ENTRY_POINTS = {"wgl32_chunk", "wgln_chunk"}
_BATCHED_WRAPPERS = {"chunk", "launch"}

_ALLOW_RE = re.compile(r"#\s*kernellint:\s*ok(?:\(([^)]*)\))?")
_ALLOW_FILE_RE = re.compile(r"#\s*kernellint:\s*ok-file\(([^)]*)\)")
# ok-file must sit in the module header, a visible reviewable banner
_ALLOW_FILE_SCAN_LINES = 20


@dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{RULES[self.rule]}] {self.message}")


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------

def _dotted(node) -> Optional[str]:
    """`torch.cuda.synchronize` -> dotted string; None for anything that
    is not a plain dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last_seg(dotted: Optional[str]) -> str:
    return (dotted or "").rsplit(".", 1)[-1]


def _is_native(node) -> bool:
    """A receiver naming the kernel-library module (`_native`,
    `ops._native`, `native`)."""
    return _last_seg(_dotted(node)).lstrip("_") == "native"


def _param_names(node) -> set:
    a = node.args
    names = [x.arg for x in
             list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _decorator_names(node) -> set:
    out = set()
    for dec in getattr(node, "decorator_list", []):
        d = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(d, ast.Attribute):
            out.add(d.attr)
        elif isinstance(d, ast.Name):
            out.add(d.id)
    return out


def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _walk_own(fn_node):
    """Walk a function body WITHOUT descending into nested function
    defs/lambdas — those are their own scopes and are analyzed
    separately."""
    body = fn_node.body if isinstance(fn_node.body, list) \
        else [fn_node.body]
    stack = [n for n in body if not isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.append(child)


def _walk_skip_defs(node):
    """Walk a subtree without descending into nested function defs or
    lambdas (separate scopes, analyzed on their own)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            continue
        yield sub
        stack.extend(ast.iter_child_nodes(sub))


def _is_launch_call(node) -> bool:
    """`_native.launch(...)`."""
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) \
        and node.func.attr == "launch" and _is_native(node.func.value)


def _is_build_call(node) -> Optional[str]:
    """The build or load a call makes (K003), by name, else None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in _NATIVE_BUILDS and _is_native(f.value):
        return f"_native.{f.attr}"
    if f.attr in _EXT_BUILDS \
            and _last_seg(_dotted(f.value)) == "cpp_extension":
        return f"cpp_extension.{f.attr}"
    if f.attr == "jit" and _dotted(f.value) == "triton":
        return "triton.jit"
    return None


def _is_lookup_call(node) -> Optional[str]:
    """A build or library lookup whose arguments pick the library
    (K004), by name, else None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _NATIVE_LOOKUPS \
            and _is_native(f.value):
        return f"_native.{f.attr}"
    name = _is_build_call(node)
    return name if name and name != "_native.build_all" else None


# ---------------------------------------------------------------------------
# module indexing
# ---------------------------------------------------------------------------

class _FuncInfo:
    __slots__ = ("node", "name", "parents", "params", "cached_chain")

    def __init__(self, node, name, parents, params, cached_chain):
        self.node = node
        self.name = name
        self.parents = parents          # enclosing _FuncInfo chain
        self.params = params            # parameter name set
        self.cached_chain = cached_chain  # this def or an enclosing one
        #                                   is cached


class _Index(ast.NodeVisitor):
    """Every function def with its enclosing chain."""

    def __init__(self):
        self.funcs: list = []
        self.by_name: dict = {}
        self._stack: list = []

    def _enter(self, node, name):
        cached = any(_decorator_names(f.node) & _CACHE_DECORATORS
                     for f in self._stack)
        cached = cached or bool(_decorator_names(node)
                                & _CACHE_DECORATORS)
        fi = _FuncInfo(node, name, list(self._stack),
                       _param_names(node), cached)
        self.funcs.append(fi)
        self.by_name.setdefault(name, []).append(fi)
        self._stack.append(fi)
        self.generic_visit(node)
        self._stack.pop()

    def visit_FunctionDef(self, node):
        self._enter(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._enter(node, "<lambda>")


def _launch_wrappers(idx: _Index) -> set:
    """The launch wrappers' def nodes: each function whose own body
    calls `_native.launch`, and each whose own body calls an in-module
    launch helper (one of those named `*launch*`) by bare name."""
    direct = {fi.node for fi in idx.funcs
              if any(_is_launch_call(s) for s in _walk_own(fi.node))}
    helpers = {fi.name for fi in idx.funcs
               if fi.node in direct and "launch" in fi.name}
    out = set(direct)
    for fi in idx.funcs:
        if any(isinstance(s, ast.Call) and isinstance(s.func, ast.Name)
               and s.func.id in helpers for s in _walk_own(fi.node)):
            out.add(fi.node)
    return out


# ---------------------------------------------------------------------------
# per-function analysis helpers
# ---------------------------------------------------------------------------

def _is_static_access(parent_map, node) -> bool:
    """x.shape / x.device / x.numel() / len(x) never read a tensor's
    values — expressions built only from these are static."""
    p = parent_map.get(node)
    if isinstance(p, ast.Attribute) and p.attr in _STATIC_ATTRS:
        return True
    if isinstance(p, ast.Call) and isinstance(p.func, ast.Name) \
            and p.func.id in _STATIC_FUNCS:
        return True
    return False


def _torch_tensor_call(node) -> bool:
    """A `torch.<fn>(...)` call that makes a tensor."""
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func) or ""
    parts = d.split(".")
    return len(parts) >= 2 and parts[0] == "torch" \
        and parts[1] not in _TORCH_NON_TENSOR


def _tensor_names(fn_node, parent_map) -> set:
    """Locals assigned from a `torch.*` call or from an expression over
    tensor locals (single forward pass, good enough for lint).
    Parameters are not assumed to be tensors: a wrapper's ints (K, W,
    rounds) are parameters too."""
    tensors: set = set()

    def expr_tensor(e) -> bool:
        for sub in ast.walk(e):
            if _torch_tensor_call(sub):
                return True
            if isinstance(sub, ast.Name) and sub.id in tensors \
                    and not _is_static_access(parent_map, sub):
                return True
        return False

    for sub in _walk_own(fn_node):
        if isinstance(sub, ast.Assign) and expr_tensor(sub.value):
            for tgt in sub.targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        tensors.add(n.id)
    return tensors


def _tensor_operand(node, tensors, parent_map) -> bool:
    """Does the expression read a tensor's values: a tensor local, a
    `torch.*` call, or a reduction over `dim=` (numpy's is `axis=`)?"""
    return any(isinstance(n, ast.Name) and n.id in tensors
               and not _is_static_access(parent_map, n)
               for n in ast.walk(node)) \
        or any(_torch_tensor_call(n) for n in ast.walk(node)) \
        or any(isinstance(n, ast.Call)
               and any(k.arg == "dim" for k in n.keywords)
               for n in ast.walk(node))


def _loop_call_targets(loop) -> set:
    """Names assigned from a call expression inside the loop body, and
    the names handed to such a call (its out-parameters: the port's
    kernels write into tensors they are given) — the values that can
    hold card results in a host poll loop."""
    out: set = set()
    for sub in _walk_skip_defs(loop):
        if isinstance(sub, ast.Assign) and any(
                isinstance(x, ast.Call) for x in ast.walk(sub.value)):
            for tgt in sub.targets:
                for nm in ast.walk(tgt):
                    if isinstance(nm, ast.Name):
                        out.add(nm.id)
            if isinstance(sub.value, ast.Call):
                for a in list(sub.value.args) + [
                        k.value for k in sub.value.keywords]:
                    out |= _names_in(a)
    return out


def _numpy_names(fn_node) -> set:
    """Locals assigned from a `np.*` / `numpy.*` call: host arrays,
    whose `.tolist()` / `.item()` read no card."""
    out: set = set()
    for sub in _walk_own(fn_node):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call) \
                and (_dotted(sub.value.func) or "").split(".")[0] \
                in ("np", "numpy"):
            for tgt in sub.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _dtype_markers(node) -> set:
    """Explicit integer `torch` dtypes in an expression subtree:
    `torch.int32`, `dtype=torch.int64`, `.to(torch.int32)`."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _INT_DTYPES \
                and isinstance(sub.value, ast.Name) \
                and sub.value.id == "torch":
            out.add(sub.attr)
    return out


def _is_launch_of_batched(call, wrapper_names: set) -> Optional[str]:
    """The launch a call makes that has a lane-batched twin, else None:
    `_native.launch("wgl32_chunk", ...)`, `X.chunk(...)` /
    `X.launch(...)`, or an in-module launch wrapper by name whose
    `<name>_batched` twin the module defines (`wrapper_names`)."""
    f = call.func
    if _is_launch_call(call):
        a0 = call.args[0] if call.args else None
        if isinstance(a0, ast.Constant) and a0.value \
                in _BATCHED_ENTRY_POINTS:
            return a0.value
        return None
    if isinstance(f, ast.Attribute) and f.attr in _BATCHED_WRAPPERS \
            and not _is_native(f.value):
        return f"{_dotted(f) or f.attr}"
    if isinstance(f, ast.Name) and f.id in wrapper_names:
        return f.id
    return None


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------

def lint_source(src: str, path: str = "<string>") -> list:
    """Lint one module's source. Returns a list of Findings (already
    filtered through the inline allowlist)."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, 0, "K001",
                        f"syntax error prevents linting: {e.msg}")]
    idx = _Index()
    idx.visit(tree)
    wrappers = _launch_wrappers(idx)
    # in-module wrappers with a lane-batched twin beside them
    wrapper_names = {fi.name for fi in idx.funcs if fi.node in wrappers
                     and f"{fi.name}_batched" in idx.by_name}
    findings: list = []

    parent_map: dict = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parent_map[child] = node

    def add(node, rule, msg):
        findings.append(Finding(path, getattr(node, "lineno", 0),
                                getattr(node, "col_offset", 0),
                                rule, msg))

    def in_wrapper(node) -> bool:
        p = parent_map.get(node)
        while p is not None:
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return p in wrappers
            p = parent_map.get(p)
        return False

    # -- K007: host syncs inside host-side poll loops -----------------
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.While, ast.For)) \
                or in_wrapper(loop):
            continue
        targets = _loop_call_targets(loop)
        is_while = isinstance(loop, ast.While)
        for sub in _walk_skip_defs(loop):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if not isinstance(f, ast.Attribute) \
                    or f.attr not in _HOST_SYNC_ATTRS:
                continue
            if f.attr == "synchronize":
                add(sub, "K007",
                    f".{f.attr}() inside a host poll loop — each "
                    "iteration waits on the card (a device->host "
                    "round trip); batch the wait into the packed poll "
                    "summary's read (allowlist the ONE designed poll)")
                continue
            if not is_while and f.attr not in _UNAMBIGUOUS_SYNCS:
                continue
            arg_names = _names_in(f.value)
            for a in sub.args:
                arg_names |= _names_in(a)
            if arg_names & targets:
                add(sub, "K007",
                    f".{f.attr}() on a value made inside a host poll "
                    "loop transfers per iteration — batch the fetch "
                    "into the packed poll summary (allowlist the ONE "
                    "designed poll)")

    # -- K008: chunk wrappers copying the in-place carry --------------
    for fi in idx.funcs:
        if isinstance(fi.node, ast.Lambda):
            continue
        carry = fi.params & _CARRY_PARAMS
        if not carry:
            continue
        for sub in _walk_own(fi.node):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _CARRY_COPIES):
                continue
            recv = _names_in(sub.func.value)
            # `[c.clone() for c in carry]` copies the carry too
            comp = parent_map.get(sub)
            while comp is not None and not isinstance(
                    comp, (ast.ListComp, ast.GeneratorExp, ast.SetComp,
                           ast.DictComp, ast.stmt)):
                comp = parent_map.get(comp)
            if isinstance(comp, (ast.ListComp, ast.GeneratorExp,
                                 ast.SetComp, ast.DictComp)):
                for gen in comp.generators:
                    if _names_in(gen.iter) & carry \
                            and _names_in(gen.target) & recv:
                        recv = recv | carry
            hit = recv & carry
            if hit:
                add(sub, "K008",
                    f"{fi.name} copies its {sorted(hit)} parameter "
                    f"(.{sub.func.attr}) on every call — the port's "
                    "chunks update the carry in place; a copy is a "
                    "multi-MB device copy per chunk")
                break

    # -- K003 / K004: builds and loads outside a cached builder -------
    for fi in idx.funcs:
        chain_cached = fi.cached_chain or any(
            p.cached_chain for p in fi.parents)
        if chain_cached:
            continue
        outer_params = set(fi.params)
        for p in fi.parents:
            outer_params |= p.params
        for sub in _walk_own(fi.node):
            name = _is_build_call(sub)
            if name:
                add(sub, "K003",
                    f"{name} inside an uncached function — a kernel "
                    "build (or load) every call (wrap the builder in "
                    "functools.lru_cache)")
            lookup = _is_lookup_call(sub)
            if lookup:
                used = set()
                for a in list(sub.args) + [k.value for k in
                                           sub.keywords]:
                    used |= _names_in(a)
                captured = used & outer_params
                if captured:
                    add(sub, "K004",
                        f"{lookup} picks its library from parameter(s) "
                        f"{sorted(captured)} of an uncached function — "
                        "each distinct value builds (or loads) again")

    # -- K006: a launch per lane inside a Python range loop -----------
    for loop in ast.walk(tree):
        if not isinstance(loop, ast.For):
            continue
        it = loop.iter
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range"):
            continue
        for sub in _walk_skip_defs(loop):
            if not isinstance(sub, ast.Call):
                continue
            which = _is_launch_of_batched(sub, wrapper_names)
            if which:
                add(sub, "K006",
                    f"{which} launched inside a Python `for ... in "
                    "range(...)` — one launch per lane or row where "
                    "the lane-batched kernel takes them all in one "
                    "(allowlist a loop over devices or shards)")
                break

    # -- K005: mixed explicit integer dtypes, anywhere ----------------
    for sub in ast.walk(tree):
        if isinstance(sub, ast.BinOp) and isinstance(
                sub.op, (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv,
                         ast.Mod, ast.BitAnd, ast.BitOr,
                         ast.BitXor, ast.LShift, ast.RShift)):
            lm, rm = _dtype_markers(sub.left), _dtype_markers(sub.right)
            if lm and rm and not (lm & rm):
                add(sub, "K005",
                    f"arithmetic mixes explicit dtypes "
                    f"{sorted(lm)} and {sorted(rm)} — implicit "
                    "promotion drifts dtypes; cast one side "
                    "explicitly")

    # -- K001 / K002: inside launch wrappers --------------------------
    for fi in idx.funcs:
        if fi.node not in wrappers:
            continue
        tensors = _tensor_names(fi.node, parent_map)
        host = _numpy_names(fi.node)
        for sub in _walk_own(fi.node):
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Attribute) \
                        and f.attr in _HOST_SYNC_ATTRS and not (
                            f.attr not in _UNAMBIGUOUS_SYNCS
                            and _names_in(f.value)
                            and _names_in(f.value) <= host):
                    add(sub, "K001",
                        f".{f.attr}() inside a launch wrapper "
                        f"({fi.name}) stalls the host on the card's "
                        "queue at every launch")
                elif isinstance(f, ast.Name) \
                        and f.id in ("float", "int", "bool") \
                        and sub.args and _tensor_operand(
                            sub.args[0], tensors, parent_map):
                    add(sub, "K001",
                        f"{f.id}() of a tensor inside a launch wrapper "
                        f"({fi.name}) reads it back to the host")
            elif isinstance(sub, (ast.If, ast.While)):
                reads = any(
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _TENSOR_TESTS
                    for n in ast.walk(sub.test))
                cmp_names = sorted({
                    n.id for c in ast.walk(sub.test)
                    if isinstance(c, ast.Compare) and not all(
                        isinstance(op, _IDENTITY_OPS) for op in c.ops)
                    for n in ast.walk(c)
                    if isinstance(n, ast.Name) and n.id in tensors
                    and not _is_static_access(parent_map, n)})
                if reads or cmp_names:
                    kind = "if" if isinstance(sub, ast.If) else "while"
                    what = (f"tensor(s) {cmp_names}" if cmp_names
                            else "a tensor's values")
                    add(sub, "K002",
                        f"Python `{kind}` on {what} inside a launch "
                        f"wrapper ({fi.name}) — an implicit "
                        "device->host sync per launch; decide on the "
                        "host's own values or inside the kernel")

    seen: set = set()
    uniq: list = []
    for f in findings:
        k = (f.path, f.line, f.col, f.rule)
        if k not in seen:
            seen.add(k)
            uniq.append(f)
    return _apply_allowlist(uniq, src)


def _apply_allowlist(findings: list, src: str) -> list:
    lines = src.splitlines()

    file_rules: set = set()
    for ln in lines[:_ALLOW_FILE_SCAN_LINES]:
        m = _ALLOW_FILE_RE.search(ln)
        if m:
            file_rules |= {w.strip() for w in m.group(1).split(",")
                           if w.strip()}

    def allowed(f: Finding) -> bool:
        if f.rule in file_rules:
            return True
        for ln in (f.line, f.line - 1):
            if 1 <= ln <= len(lines):
                m = _ALLOW_RE.search(lines[ln - 1])
                if m:
                    which = m.group(1)
                    if which is None:
                        return True
                    ids = {w.strip() for w in which.split(",")}
                    if f.rule in ids:
                        return True
        return False

    out = [f for f in findings if not allowed(f)]
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def lint_file(path: str) -> list:
    with open(path) as fh:
        return lint_source(fh.read(), path)


def lint_paths(paths) -> list:
    """Lint every .py file under the given files/directories."""
    findings: list = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                if "__pycache__" in root:
                    continue
                for name in sorted(files):
                    if name.endswith(".py"):
                        findings += lint_file(os.path.join(root, name))
        elif p.endswith(".py"):
            findings += lint_file(p)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)

DEFAULT_PATHS = tuple(os.path.join(PACKAGE_DIR, p) for p in (
    "ops", "elle", "parallel", "bench.py"))


def main(argv=None) -> int:
    """The lint CLI: 0 clean, 1 findings, 254 a usage error."""
    import sys

    from . import gitscope

    argv = list(sys.argv[1:] if argv is None else argv)
    quiet = "--check" in argv
    changed_only = "--changed-only" in argv
    argv = [a for a in argv if a not in ("--check", "--changed-only")]
    rules = None
    if "--rules" in argv:
        i = argv.index("--rules")
        if i + 1 >= len(argv):
            print("--rules needs a comma-separated rule list "
                  "(e.g. --rules K001,K007)", file=sys.stderr)
            return 254
        rules = {r.strip() for r in argv[i + 1].split(",") if r.strip()}
        unknown = rules - set(RULES)
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)} "
                  f"(known: {sorted(RULES)})", file=sys.stderr)
            return 254
        del argv[i:i + 2]
    if "--list-rules" in argv:
        for rule, name in sorted(RULES.items()):
            print(f"{rule}  {name}")
        return 0
    paths = argv or list(DEFAULT_PATHS)
    if changed_only:
        paths, done = gitscope.scope_changed(
            paths, REPO_ROOT, quiet=quiet, label="kernel lint")
        if done:
            return 0
    findings = lint_paths(paths)
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    for f in findings:
        print(f, file=sys.stderr)
    n_files = sum(
        (len([x for x in os.listdir(p) if x.endswith(".py")])
         if os.path.isdir(p) else 1)
        for p in paths if os.path.exists(p))
    if not quiet or findings:
        print(f"kernel lint: {n_files} file(s), "
              f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
