"""Thread-safety lint for the service host plane (AST-based, stdlib).

The port of `jepsen_tpu/analysis/threadlint.py`: the same rules, the
same lock-ish and thread-context resolution and the same allowlist, over
the port's threaded modules (`DEFAULT_PATHS`). The checker kernels are
guarded by their own static planes (history_lint, kernellint,
preflight) — but the part of the tree that carries production semantics
is *threaded host code*: the service worker pool, the autopilot
supervisor, the watchdog monitor, replica heartbeats, SSE streams, the
streamed fan-out workers. This linter encodes the hazards found there
by hand the way Eraser's lockset analysis and FreeBSD's witness checker
do, as static rules:

  T001 unlocked-shared-write   a `self.X` written both from a
                               thread context (a method reachable
                               from `Thread(target=...)` / `Timer` /
                               a callback, transitively) and from
                               other methods, with at least one of
                               those writes not under `with
                               self._lock` — the Eraser condition
  T002 lock-order-inversion    the per-module lock-acquisition graph
                               (built from nested `with` blocks,
                               Condition aliases resolved to their
                               underlying lock) contains a cycle —
                               two code paths that can deadlock
  T003 blocking-call-under-lock  `time.sleep`, a thread `.join`, a
                               socket/subprocess call, a ledger
                               `.record`, an Event `.wait`, a
                               kernel build (`*compile*`, an nvcc
                               build or library load through
                               `_native.build_all` / `_load` /
                               `_lib`), or a card sync
                               (`torch.cuda.synchronize()`, a
                               stream's or an event's
                               `.synchronize()`) inside a `with
                               lock:` body — every other thread on
                               that lock stalls for the full blocking
                               call (`Condition.wait` is exempt: it
                               releases the lock)
  T004 unjoined-thread         `threading.Thread(...)` started with
                               no `daemon=` flag and no reachable
                               `.join()` / `.daemon =` / return path
                               — a leaked non-daemon thread blocks
                               interpreter exit
  T005 check-then-act          an unlocked `if` on shared state
                               (membership, `.is_set()`, `is None`)
                               whose body then writes that same
                               state unlocked — the window between
                               check and act races (double-checked
                               locking, where the WRITE is locked,
                               passes)
  T006 global-write-in-thread  a module-level global rebound or
                               mutated from a thread-context
                               function without a module lock
  T007 signature-toctou        `index_signature()` computed AFTER
                               the data read it is meant to version
                               — a concurrent append between read
                               and signature aliases the stale read
                               under the fresh signature forever
                               (signature-before-read heals next
                               poll; this order never does)
  T008 loop-capture-in-thread  a closure created inside a loop,
                               referencing the loop variable, handed
                               to a thread/timer/executor — every
                               thread sees the LAST iteration's
                               value (bind it as a default arg)

Scope notes. "Thread context" is resolved per module to a fixpoint:
methods/functions referenced by `Thread(target=...)`,
`threading.Timer`, or `target=`/`callback=` keyword arguments, plus
everything they call through `self.` or bare names. A write counts
as locked when an enclosing `with` acquires a lock-ish expression
(name ending in lock/mutex/cv/cond, a class attribute assigned from
`threading.Lock/RLock/Condition/Semaphore` or
`analysis.lockwatch.lock/rlock`), or when the enclosing method's
name ends in `_locked` (the tree's "caller holds the lock"
convention). `Condition(self._lock)` aliases to the underlying lock,
so `with self._cv:` guards the same state as `with self._lock:` and
never produces a false T002 cycle against it.

Allowlist: `# threadlint: ok(T001)` (or `ok(T001,T005)`, or a bare
`# threadlint: ok`) on the flagged line or the line directly above
suppresses the finding; a file-level `# threadlint: ok-file(T004)`
within the first 20 lines suppresses named rules module-wide (never
a bare form). Every allowlist is a reviewable decision with a
written justification, and the tree is kept clean.

CLI (the twin of the reference's `scripts/thread_lint.py`):

    python -m jepsen_tpu_torch.analysis.threadlint [--check]
        [--list-rules] [--rules T001,T003] [--changed-only] [paths...]

No paths: the port's threaded host plane (`DEFAULT_PATHS`). Exit 0
clean, 1 findings remain after the allowlist, 254 a usage error;
`--check` only changes verbosity. Runtime twin: `analysis.lockwatch`,
the witness that observes the ACTUAL acquisition order under
JEPSEN_TPU_LOCKWATCH=1.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Optional

RULES = {
    "T001": "unlocked-shared-write",
    "T002": "lock-order-inversion",
    "T003": "blocking-call-under-lock",
    "T004": "unjoined-thread",
    "T005": "check-then-act",
    "T006": "global-write-in-thread",
    "T007": "signature-toctou",
    "T008": "loop-capture-in-thread",
}

_ALLOW_RE = re.compile(r"#\s*threadlint:\s*ok(?:\(([^)]*)\))?")
_ALLOW_FILE_RE = re.compile(r"#\s*threadlint:\s*ok-file\(([^)]*)\)")
# ok-file must sit in the module header, a visible reviewable banner
_ALLOW_FILE_SCAN_LINES = 20

# lock-ish name suffixes: the last dotted segment (underscores
# stripped) must END in one of these for a `with X:` to count as a
# lock acquisition — `self._lock`, `qlock`, `_LOCK`, `self._ev_cv`
_LOCK_SUFFIXES = ("lock", "mutex", "cv", "cond", "condition")

# threading constructors whose result is a lock-ish attribute; the
# lockwatch factories keep instrumented trees recognizable
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore", "lock", "rlock"}
_EVENT_CTORS = {"Event"}

# container-mutation method names that count as writes for T001/T005
_MUTATORS = {"append", "appendleft", "add", "update", "pop", "popleft",
             "clear", "remove", "discard", "extend", "insert",
             "setdefault", "set"}

# receivers whose .join is a thread join, not str.join
_JOINISH_RE = re.compile(
    r"(thread|worker|monitor|proc|^t\d*$|^th\d*$)", re.IGNORECASE)
# receivers whose .wait blocks while holding the lock (Events); cv /
# cond receivers are exempt — Condition.wait releases the lock
_EVENTISH_RE = re.compile(r"(ev|event|stop|done|ready)$", re.IGNORECASE)
_LEDGERISH_RE = re.compile(r"(led|ledger)", re.IGNORECASE)

_THREAD_HANDOFF_FUNCS = {"Thread", "Timer", "submit", "call_later",
                         "spawn", "start_new_thread"}

# `ops/_native` calls that run nvcc or load / bind a kernel library:
# under a lock they stall every other thread on it for the build
_NATIVE_BUILDS = {"build_all", "_load", "_lib"}
_THREAD_HANDOFF_KWARGS = {"target", "callback", "on_done", "on_event"}


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

def _walk_own(fn_node):
    """Walk a function body WITHOUT descending into nested defs or
    lambdas — each is its own analysis unit with its own thread/lock
    context."""
    body = fn_node.body if isinstance(fn_node.body, list) \
        else [fn_node.body]
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.append(child)


def _dotted(node) -> Optional[str]:
    """`self._lock` -> "self._lock"; `mod.obj.qlock` -> dotted string;
    None for anything that is not a plain dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last_seg(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1].lstrip("_").lower()


def _is_lockish_name(dotted: Optional[str]) -> bool:
    if not dotted:
        return False
    seg = _last_seg(dotted)
    return any(seg == s or seg.endswith(s) for s in _LOCK_SUFFIXES)


def _ctor_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _self_attr(node) -> Optional[str]:
    """`self.X` -> "X" (one level only)."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _param_names(node) -> set:
    a = node.args
    names = [x.arg for x in
             list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


# ---------------------------------------------------------------------------
# module index: analysis units, classes, thread-context fixpoint
# ---------------------------------------------------------------------------

class _Unit:
    """One analysis unit: a def (method, function, or nested def)."""

    __slots__ = ("node", "name", "cls", "parents", "thread_ctx")

    def __init__(self, node, name, cls, parents):
        self.node = node
        self.name = name
        self.cls = cls              # owning _ClassInfo or None
        self.parents = parents      # enclosing unit chain
        self.thread_ctx = False


class _ClassInfo:
    __slots__ = ("node", "name", "lock_attrs", "aliases", "event_attrs",
                 "methods", "spawns_threads")

    def __init__(self, node):
        self.node = node
        self.name = node.name
        self.lock_attrs: set = set()
        self.aliases: dict = {}     # cv attr -> underlying lock attr
        self.event_attrs: set = set()
        self.methods: dict = {}     # name -> _Unit
        self.spawns_threads = False


class _Index(ast.NodeVisitor):
    def __init__(self):
        self.units: list = []
        self.by_name: dict = {}       # bare name -> [_Unit]
        self.classes: list = []
        self.module_globals: set = set()
        self._cls_stack: list = []
        self._unit_stack: list = []

    def visit_Module(self, node):
        for stmt in node.body:
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        self.module_globals.add(tgt.id)
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                self.module_globals.add(stmt.target.id)
        self.generic_visit(node)

    def visit_ClassDef(self, node):
        ci = _ClassInfo(node)
        self.classes.append(ci)
        self._cls_stack.append(ci)
        self.generic_visit(node)
        self._cls_stack.pop()

    def _enter(self, node, name):
        cls = self._cls_stack[-1] if self._cls_stack else None
        u = _Unit(node, name, cls, list(self._unit_stack))
        self.units.append(u)
        self.by_name.setdefault(name, []).append(u)
        # a def directly in the class body is a method
        if cls is not None and not self._unit_stack:
            cls.methods[name] = u
        self._unit_stack.append(u)
        self.generic_visit(node)
        self._unit_stack.pop()

    def visit_FunctionDef(self, node):
        self._enter(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._enter(node, "<lambda>")

    def visit_Call(self, node):
        cls = self._cls_stack[-1] if self._cls_stack else None
        name = _ctor_name(node)
        if name in ("Thread", "Timer") and cls is not None:
            cls.spawns_threads = True
        # lock/cv/event attribute discovery: self.X = Lock()/...
        self.generic_visit(node)

    def visit_Assign(self, node):
        cls = self._cls_stack[-1] if self._cls_stack else None
        if cls is not None and isinstance(node.value, ast.Call):
            ctor = _ctor_name(node.value)
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if ctor in _LOCK_CTORS:
                    cls.lock_attrs.add(attr)
                    if ctor == "Condition" and node.value.args:
                        under = _self_attr(node.value.args[0])
                        if under is not None:
                            cls.aliases[attr] = under
                elif ctor in _EVENT_CTORS:
                    cls.event_attrs.add(attr)
        self.generic_visit(node)


def _thread_handoff_targets(tree) -> list:
    """AST nodes handed to a thread/timer/executor anywhere in the
    module: `Thread(target=X)`, `Timer(t, X)`, `submit(X, ...)`,
    `callback=X` — the thread-context seeds."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _ctor_name(node)
        if fname in _THREAD_HANDOFF_FUNCS:
            if fname == "Timer" and len(node.args) >= 2:
                out.append(node.args[1])
            if fname in ("submit", "spawn", "start_new_thread") \
                    and node.args:
                out.append(node.args[0])
        for kw in node.keywords:
            if kw.arg in _THREAD_HANDOFF_KWARGS:
                out.append(kw.value)
    return out


def _resolve_thread_ctx(idx: _Index, tree) -> None:
    """Mark thread-context units to a fixpoint: handoff seeds, then
    everything they call via `self.m()` or bare `f()`."""
    seeds: list = []
    for ref in _thread_handoff_targets(tree):
        attr = _self_attr(ref)
        if attr is not None:
            for cls in idx.classes:
                if attr in cls.methods:
                    seeds.append(cls.methods[attr])
        elif isinstance(ref, ast.Name):
            seeds.extend(idx.by_name.get(ref.id, []))
        elif isinstance(ref, ast.Lambda):
            for u in idx.units:
                if u.node is ref:
                    seeds.append(u)

    work = list(seeds)
    while work:
        u = work.pop()
        if u.thread_ctx:
            continue
        u.thread_ctx = True
        for sub in _walk_own(u.node):
            if not isinstance(sub, ast.Call):
                continue
            attr = _self_attr(sub.func)
            if attr is not None and u.cls is not None \
                    and attr in u.cls.methods:
                work.append(u.cls.methods[attr])
            elif isinstance(sub.func, ast.Name):
                work.extend(idx.by_name.get(sub.func.id, []))
        # nested defs inherit the thread context of their parent
        # (they run on the same thread unless handed off again)
        for other in idx.units:
            if other.parents and other.parents[-1] is u:
                work.append(other)


# ---------------------------------------------------------------------------
# per-unit traversal with a held-locks stack
# ---------------------------------------------------------------------------

def _canonical_lock(expr, cls: Optional[_ClassInfo]) -> Optional[str]:
    """The canonical dotted name a `with` item acquires, or None when
    it is not a lock acquisition. Condition attrs alias to their
    underlying lock."""
    if isinstance(expr, ast.Call):
        return None  # `with Lock():` — a fresh lock guards nothing
    dotted = _dotted(expr)
    if dotted is None:
        return None
    attr = _self_attr(expr)
    if cls is not None and attr is not None:
        if attr in cls.aliases:
            return f"self.{cls.aliases[attr]}"
        if attr in cls.lock_attrs:
            return dotted
    if _is_lockish_name(dotted):
        if cls is not None and attr is not None \
                and attr in cls.aliases:
            return f"self.{cls.aliases[attr]}"
        return dotted
    return None


class _Site:
    """One interesting site observed during a unit traversal."""

    __slots__ = ("node", "held", "kind", "extra")

    def __init__(self, node, held, kind, extra=None):
        self.node = node
        self.held = tuple(held)     # lock names held at this site
        self.kind = kind
        self.extra = extra


def _traverse(unit: _Unit, on_site, lock_edges: dict) -> None:
    """Statement-ordered walk of one unit, maintaining the held-lock
    stack. `on_site(site)` receives writes/reads/ifs/calls;
    `lock_edges[(outer, inner)] = node` accumulates the acquisition
    graph."""
    held: list = []
    cls = unit.cls

    def visit(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                lk = _canonical_lock(item.context_expr, cls)
                if lk is not None:
                    for h in held:
                        if h != lk:
                            lock_edges.setdefault((h, lk), node)
                    held.append(lk)
                    acquired.append(lk)
            for stmt in node.body:
                visit(stmt)
            for lk in reversed(acquired):
                held.pop()
            return
        on_site(_Site(node, held, "node"))
        for child in ast.iter_child_nodes(node):
            visit(child)

    body = unit.node.body if isinstance(unit.node.body, list) \
        else [unit.node.body]
    for stmt in body:
        visit(stmt)


# ---------------------------------------------------------------------------
# write/read collection for T001 / T005 / T006
# ---------------------------------------------------------------------------

def _self_write_target(node) -> Optional[str]:
    """The self attribute a statement/expression writes, if any."""
    if isinstance(node, ast.Assign):
        for tgt in node.targets:
            attr = _self_attr(tgt)
            if attr is not None:
                return attr
            if isinstance(tgt, ast.Subscript):
                attr = _self_attr(tgt.value)
                if attr is not None:
                    return attr
    elif isinstance(node, ast.AugAssign):
        attr = _self_attr(node.target)
        if attr is not None:
            return attr
        if isinstance(node.target, ast.Subscript):
            return _self_attr(node.target.value)
    elif isinstance(node, ast.Delete):
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                attr = _self_attr(tgt.value)
                if attr is not None:
                    return attr
    elif isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS:
        return _self_attr(node.func.value)
    return None


def _global_write_target(node, module_globals: set,
                         local_names: set) -> Optional[str]:
    """The module global a statement rebinds or mutates, if any."""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        tgts = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for tgt in tgts:
            if isinstance(tgt, ast.Subscript) \
                    and isinstance(tgt.value, ast.Name) \
                    and tgt.value.id in module_globals \
                    and tgt.value.id not in local_names:
                return tgt.value.id
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS \
            and isinstance(node.func.value, ast.Name) \
            and node.func.value.id in module_globals \
            and node.func.value.id not in local_names:
        return node.func.value.id
    return None


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------

def lint_source(src: str, path: str = "<string>") -> list:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, 0, "T001",
                        f"syntax error prevents linting: {e.msg}")]
    idx = _Index()
    idx.visit(tree)
    _resolve_thread_ctx(idx, tree)
    findings: list = []

    def add(node, rule, msg):
        findings.append(Finding(path, getattr(node, "lineno", 0),
                                getattr(node, "col_offset", 0),
                                rule, msg))

    # per-class write ledgers for T001:
    #   writes[cls][field] = [(unit, node, locked, thread_ctx)]
    writes: dict = {}
    lock_edges: dict = {}     # (outer, inner) -> first with-node

    for unit in idx.units:
        cls = unit.cls
        in_init = unit.name == "__init__" or any(
            p.name == "__init__" for p in unit.parents)
        held_locked_method = unit.name.endswith("_locked") or any(
            p.name.endswith("_locked") for p in unit.parents)
        local_names = _param_names(unit.node) if not isinstance(
            unit.node, ast.Lambda) else set()
        for sub in _walk_own(unit.node):
            if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                tgts = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                for tgt in tgts:
                    for nm in ast.walk(tgt):
                        if isinstance(nm, ast.Name):
                            local_names.add(nm.id)
        has_global_decl = {
            name for sub in _walk_own(unit.node)
            if isinstance(sub, ast.Global) for name in sub.names}

        sites: list = []
        _traverse(unit, sites.append, lock_edges)

        for site in sites:
            node = site.node
            locked = bool(site.held) or held_locked_method
            # ---- write collection (T001 / T006) --------------------
            wt = _self_write_target(node)
            if wt is not None and cls is not None and not in_init \
                    and wt not in cls.lock_attrs \
                    and wt not in cls.aliases:
                # Event .set()/.clear() are internally synchronized
                is_event_mut = (isinstance(node, ast.Call)
                                and wt in cls.event_attrs)
                if not is_event_mut:
                    writes.setdefault(cls.name, {}).setdefault(
                        wt, []).append(
                        (unit, node, locked, unit.thread_ctx))
            if unit.thread_ctx and not locked:
                gname = None
                if isinstance(node, (ast.Assign, ast.AugAssign)) \
                        and not isinstance(node, ast.AugAssign):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name) \
                                and tgt.id in has_global_decl:
                            gname = tgt.id
                if gname is None:
                    gname = _global_write_target(
                        node, idx.module_globals, local_names)
                if gname is not None:
                    add(node, "T006",
                        f"module global `{gname}` mutated from "
                        f"thread context ({unit.name}) without a "
                        "module lock — concurrent threads tear the "
                        "update")

            # ---- T003: blocking call under a held lock -------------
            if site.held and isinstance(node, ast.Call):
                _t003(node, add)

            # ---- T005: check-then-act ------------------------------
            if isinstance(node, ast.If) and not locked \
                    and cls is not None and not in_init \
                    and (cls.spawns_threads or cls.lock_attrs) \
                    and unit.name != "__init__":
                _t005(node, cls, add)

        # ---- T004: threads without daemon/join ---------------------
        _t004(unit, add)

        # ---- T007: signature computed after the read ---------------
        _t007(unit, add)

        # ---- T008: loop-variable capture into a thread -------------
        _t008(unit, add)

    # ---- T001: co-written fields with an unlocked write ------------
    for cls in idx.classes:
        for field, ws in writes.get(cls.name, {}).items():
            thread_ws = [w for w in ws if w[3]]
            other_ws = [w for w in ws if not w[3]]
            if not thread_ws or not other_ws:
                continue
            unlocked = [w for w in ws if not w[2]]
            if not unlocked:
                continue
            t_names = sorted({w[0].name for w in thread_ws})
            o_names = sorted({w[0].name for w in other_ws})
            for unit, node, _lk, t_ctx in unlocked:
                where = "thread context" if t_ctx else "caller context"
                add(node, "T001",
                    f"self.{field} written here ({unit.name}, "
                    f"{where}) without holding the class lock — "
                    f"also written from thread context {t_names} "
                    f"and caller context {o_names}; one side "
                    "unlocked is the Eraser race condition")

    # ---- T002: cycles in the acquisition graph ---------------------
    _t002(lock_edges, add)

    seen: set = set()
    uniq: list = []
    for f in findings:
        k = (f.path, f.line, f.col, f.rule)
        if k not in seen:
            seen.add(k)
            uniq.append(f)
    return _apply_allowlist(uniq, src)


# ---------------------------------------------------------------------------
# individual rule bodies
# ---------------------------------------------------------------------------

def _t002(lock_edges: dict, add) -> None:
    graph: dict = {}
    for (a, b) in lock_edges:
        graph.setdefault(a, set()).add(b)

    def reachable(frm: str, to: str) -> bool:
        seen, stack = set(), [frm]
        while stack:
            n = stack.pop()
            if n == to:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(graph.get(n, ()))
        return False

    for (a, b), node in sorted(lock_edges.items(),
                               key=lambda kv: kv[1].lineno):
        if a != b and reachable(b, a):
            add(node, "T002",
                f"lock-order inversion: `{a}` is acquired before "
                f"`{b}` here, but another path acquires `{b}` "
                f"before `{a}` — two threads on opposite paths "
                "deadlock; pick ONE global order")


def _t003(node: ast.Call, add) -> None:
    f = node.func
    dotted = _dotted(f)
    if isinstance(f, ast.Attribute):
        recv = _dotted(f.value) or ""
        seg = _last_seg(recv) if recv else ""
        if f.attr == "sleep" and seg == "time":
            add(node, "T003",
                "time.sleep under a held lock stalls every thread "
                "waiting on that lock for the full sleep — sleep "
                "outside, or use Condition.wait (which releases)")
        elif f.attr == "join" and not isinstance(f.value,
                                                 ast.Constant) \
                and (_JOINISH_RE.search(seg)
                     or _JOINISH_RE.search(recv)):
            add(node, "T003",
                f"{recv}.join under a held lock: if the joined "
                "thread needs this lock to finish, this is a "
                "deadlock; join after releasing")
        elif f.attr == "wait" and _EVENTISH_RE.search(seg) \
                and not _is_lockish_name(recv):
            add(node, "T003",
                f"{recv}.wait under a held lock blocks while "
                "HOLDING it (Event.wait does not release, unlike "
                "Condition.wait) — waiters that need the lock to "
                "set the event deadlock")
        elif f.attr in ("record", "record_result") \
                and _LEDGERISH_RE.search(seg):
            add(node, "T003",
                f"ledger {f.attr} under a held lock: the append "
                "takes an exclusive flock + fsync-ordered rename — "
                "every thread on this lock stalls behind disk; "
                "bank outside the critical section")
        elif f.attr in ("recv", "accept", "connect", "urlopen"):
            add(node, "T003",
                f"socket/HTTP {f.attr} under a held lock blocks "
                "the lock on network latency — move I/O outside")
        elif "compile" in f.attr.lower() \
                or "precompile" in f.attr.lower() \
                or (f.attr in _NATIVE_BUILDS and seg.endswith("native")):
            add(node, "T003",
                f"{f.attr} under a held lock: an nvcc build is "
                "seconds-long — warm outside the lock and publish "
                "the result under it")
        elif f.attr == "synchronize":
            add(node, "T003",
                f"{recv}.synchronize under a held lock: the host waits "
                "for the card's queued work while HOLDING the lock — "
                "every thread on it stalls for the device time; sync "
                "outside the critical section")
    elif isinstance(f, ast.Name):
        if f.id == "sleep":
            add(node, "T003",
                "sleep under a held lock stalls every thread "
                "waiting on that lock for the full sleep")
        elif dotted and "subprocess" in dotted:
            add(node, "T003",
                "subprocess call under a held lock blocks the lock "
                "on the child process")


def _t005(node: ast.If, cls: _ClassInfo, add) -> None:
    """Unlocked `if <check on self.X>` whose body writes self.X
    unlocked. The body scan tracks nested `with` locks so
    double-checked locking passes."""
    checked: set = set()
    for sub in ast.walk(node.test):
        if isinstance(sub, ast.Compare) and any(
                isinstance(op, (ast.In, ast.NotIn, ast.Is, ast.IsNot))
                for op in sub.ops):
            for part in [sub.left] + list(sub.comparators):
                attr = _self_attr(part)
                if attr is not None:
                    checked.add(attr)
        elif isinstance(sub, ast.Call) \
                and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in ("is_set", "get", "__contains__"):
            attr = _self_attr(sub.func.value)
            if attr is not None:
                checked.add(attr)
    checked -= cls.lock_attrs
    checked -= set(cls.aliases)
    if not checked:
        return

    def body_writes(stmts, held: bool):
        stack = list(stmts)
        while stack:
            sub = stack.pop()
            if isinstance(sub, ast.With):
                inner_held = held or any(
                    _canonical_lock(i.context_expr, cls)
                    for i in sub.items)
                yield from body_writes(sub.body, inner_held)
                continue  # don't re-walk the with body unlocked
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            wt = _self_write_target(sub)
            if wt in checked and not held:
                # Event.set()/clear() on a checked Event attr is
                # still a lost-update window: check+act together
                yield sub, wt
            stack.extend(ast.iter_child_nodes(sub))

    hits = list(body_writes(node.body, False))
    for sub, wt in hits[:1]:
        add(node, "T005",
            f"check-then-act on self.{wt}: the test and the write "
            "in its body both run unlocked — another thread can "
            "interleave between them (take the lock around both, "
            "or re-check under the lock)")


def _t004(unit: _Unit, add) -> None:
    own = list(_walk_own(unit.node))
    src_has_join = any(
        isinstance(s, ast.Attribute) and s.attr == "join"
        for s in own)
    src_sets_daemon = any(
        isinstance(s, ast.Assign) and any(
            isinstance(t, ast.Attribute) and t.attr == "daemon"
            for t in s.targets)
        for s in own)
    has_return = any(isinstance(s, ast.Return) and s.value is not None
                     for s in own)
    for sub in own:
        if not isinstance(sub, ast.Call):
            continue
        if _ctor_name(sub) != "Thread":
            continue
        if any(kw.arg == "daemon" for kw in sub.keywords):
            continue
        if src_has_join or src_sets_daemon or has_return:
            continue
        add(sub, "T004",
            "Thread created without daemon= and with no join / "
            ".daemon assignment / return in this function — a "
            "leaked non-daemon thread blocks interpreter exit and "
            "is unstoppable; pass daemon=True or keep a join path")


def _t007(unit: _Unit, add) -> None:
    first_read_line = None
    for sub in _walk_own(unit.node):
        if not isinstance(sub, ast.Call) \
                or not isinstance(sub.func, ast.Attribute):
            continue
        recv = _dotted(sub.func.value) or ""
        if sub.func.attr in ("query", "records") \
                and _LEDGERISH_RE.search(_last_seg(recv) or recv):
            ln = sub.lineno
            if first_read_line is None or ln < first_read_line:
                first_read_line = ln
    if first_read_line is None:
        return
    for sub in _walk_own(unit.node):
        if isinstance(sub, ast.Call) \
                and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr == "index_signature" \
                and sub.lineno > first_read_line:
            add(sub, "T007",
                "index_signature() computed AFTER the data read it "
                "versions — an append landing between read and "
                "signature aliases the stale read under the fresh "
                "signature forever; compute the signature BEFORE "
                "reading (a stale signature merely refreshes next "
                "poll)")


def _t008(unit: _Unit, add) -> None:
    for loop in _walk_own(unit.node):
        if not isinstance(loop, (ast.For,)):
            continue
        loop_vars = {n.id for n in ast.walk(loop.target)
                     if isinstance(n, ast.Name)}
        for sub in ast.walk(loop):
            if not isinstance(sub, ast.Call):
                continue
            handoff_args = []
            if _ctor_name(sub) in _THREAD_HANDOFF_FUNCS:
                handoff_args.extend(sub.args)
            handoff_args.extend(
                kw.value for kw in sub.keywords
                if kw.arg in _THREAD_HANDOFF_KWARGS)
            for arg in handoff_args:
                if not isinstance(arg, (ast.Lambda, ast.Name)):
                    continue
                closure = None
                if isinstance(arg, ast.Lambda):
                    closure = arg
                else:
                    for d in ast.walk(loop):
                        if isinstance(d, ast.FunctionDef) \
                                and d.name == arg.id:
                            closure = d
                if closure is None:
                    continue
                bound = _param_names(closure)
                free_loop = {
                    n.id for n in ast.walk(
                        closure.body if isinstance(closure,
                                                   ast.Lambda)
                        else closure)
                    if isinstance(n, ast.Name)
                    and n.id in loop_vars and n.id not in bound}
                if free_loop:
                    add(arg, "T008",
                        f"closure captures loop variable(s) "
                        f"{sorted(free_loop)} and is handed to a "
                        "thread — every thread sees the LAST "
                        "iteration's value; bind it as a default "
                        "argument (lambda x=x: ...) or pass via "
                        "args=")


# ---------------------------------------------------------------------------
# allowlist + file plumbing (same contract as kernellint)
# ---------------------------------------------------------------------------

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

# the port's threaded host plane: the reference's eight modules' twins
DEFAULT_PATHS = tuple(os.path.join(PACKAGE_DIR, *p) for p in (
    ("service.py",), ("fleet.py",), ("autopilot.py",),
    ("observatory.py",), ("watchdog.py",), ("web.py",),
    ("parallel", "batched.py"), ("analysis", "lockwatch.py")))


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
                  "(e.g. --rules T001,T003)", file=sys.stderr)
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
            paths, REPO_ROOT, quiet=quiet, label="thread lint")
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
        print(f"thread lint: {n_files} file(s), "
              f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
