"""The port's thread-safety lint and git scoping, against the JAX package's.

`jepsen_tpu_torch/analysis/threadlint.py` and `gitscope.py` are copies
of the reference's modules (`jepsen_tpu/analysis/`): over every file of
`tests/threadlint_fixtures/` and over the reference's eight threaded
modules (as shipped, and with their allowlist comments taken out) both
linters give the same findings, message for message but for T003's
build wording ("an nvcc build" where the reference says "an XLA
compile"). The reference's clean counterparts and allowlist cases
(`tests/test_threadlint.py`) hold for the port; the port's CLI (`python
-m jepsen_tpu_torch.analysis.threadlint`) exits as `scripts/
thread_lint.py` does; the card's own blocking calls are T003 in the
port alone; and the port's threaded plane (`DEFAULT_PATHS`) lints clean.
"""

import importlib
import os
import re
import subprocess
import sys

import pytest

from jepsen_tpu.analysis import gitscope as jgitscope
from jepsen_tpu.analysis import threadlint as jlint
from jepsen_tpu_torch.analysis import gitscope as tgitscope
from jepsen_tpu_torch.analysis import threadlint as tlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "threadlint_fixtures")
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))

sys.path.insert(0, os.path.join(REPO, "scripts"))
jcli = importlib.import_module("thread_lint")

REF_MODULES = [os.path.relpath(p, REPO) for p in jcli.DEFAULT_PATHS]

# the one message the port words its own way (T003 on a build)
WORDING = {"an XLA compile": "an nvcc build"}


def keyed(findings, reword=False):
    out = []
    for f in findings:
        msg = f.message
        if reword:
            for a, b in WORDING.items():
                msg = msg.replace(a, b)
        out.append((f.rule, f.line, f.col, msg))
    return out


def both_source(src, path="x.py"):
    return (keyed(jlint.lint_source(src, path), reword=True),
            keyed(tlint.lint_source(src, path)))


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_match_reference(name):
    path = os.path.join(FIXTURES, name)
    want = keyed(jlint.lint_file(path), reword=True)
    assert keyed(tlint.lint_file(path)) == want
    if name != "fixture_allowlisted.py":
        assert want, name


@pytest.mark.parametrize("rule", sorted(jlint.RULES))
def test_each_rule_trips_on_its_fixture(rule):
    path = os.path.join(FIXTURES, f"fixture_{rule.lower()}.py")
    assert rule in {f.rule for f in tlint.lint_file(path)}


def test_rule_catalog_matches_reference():
    assert tlint.RULES == jlint.RULES


@pytest.mark.parametrize("rel", REF_MODULES)
def test_reference_modules_match(rel):
    path = os.path.join(REPO, rel)
    assert keyed(tlint.lint_file(path)) == keyed(jlint.lint_file(path),
                                                 reword=True)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_reference_modules_match_without_allowlists(rel):
    """With every `# threadlint: ok(...)` taken out, the reference's
    allowlisted findings (service.py's T005) come back in both."""
    with open(os.path.join(REPO, rel)) as fh:
        src = re.sub(r"#\s*threadlint:\s*ok[^\n]*", "", fh.read())
    want, got = both_source(src, rel)
    assert got == want
    if rel.endswith("service.py"):
        assert "T005" in {r for r, *_ in got}


def test_build_under_lock_differs_only_in_wording():
    src = ("import threading\n"
           "class W:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "    def warm(self, b):\n"
           "        with self._lock:\n"
           "            precompile_bucket(b)\n"
           "            self.aot.compile(b)\n")
    want = keyed(jlint.lint_source(src, "w.py"))
    got = keyed(tlint.lint_source(src, "w.py"))
    assert [k[:3] for k in got] == [k[:3] for k in want] == [
        ("T003", 8, 12)]
    assert "an XLA compile" in want[0][3]
    assert got[0][3] == want[0][3].replace("an XLA compile",
                                           "an nvcc build")


CLEAN = {
    "locked-writes": (
        "import threading\n"
        "class Pool:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.count = 0\n"
        "    def start(self):\n"
        "        t = threading.Thread(target=self._run,\n"
        "                             daemon=True)\n"
        "        t.start()\n"
        "    def _run(self):\n"
        "        with self._lock:\n"
        "            self.count += 1\n"
        "    def reset(self):\n"
        "        with self._lock:\n"
        "            self.count = 0\n", None),
    "one-order": (
        "import threading\n"
        "class TwoLocks:\n"
        "    def __init__(self):\n"
        "        self._a_lock = threading.Lock()\n"
        "        self._b_lock = threading.Lock()\n"
        "    def one(self):\n"
        "        with self._a_lock:\n"
        "            with self._b_lock:\n"
        "                return 1\n"
        "    def two(self):\n"
        "        with self._a_lock:\n"
        "            with self._b_lock:\n"
        "                return 2\n", None),
    "condition-alias": (
        "import threading\n"
        "class Svc:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.RLock()\n"
        "        self._cv = threading.Condition(self._lock)\n"
        "    def a(self):\n"
        "        with self._lock:\n"
        "            with self._cv:\n"
        "                return 1\n"
        "    def b(self):\n"
        "        with self._cv:\n"
        "            with self._lock:\n"
        "                return 2\n", "T002"),
    "lockwatch-alias": (
        "import threading\n"
        "from .analysis import lockwatch\n"
        "class Svc:\n"
        "    def __init__(self):\n"
        "        self._lock = lockwatch.rlock('service')\n"
        "        self._cv = threading.Condition(self._lock)\n"
        "    def a(self):\n"
        "        with self._lock:\n"
        "            with self._cv:\n"
        "                return 1\n"
        "    def b(self):\n"
        "        with self._cv:\n"
        "            with self._lock:\n"
        "                return 2\n", "T002"),
    "sleep-outside": (
        "import threading, time\n"
        "class Host:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def poll(self):\n"
        "        with self._lock:\n"
        "            n = 1\n"
        "        time.sleep(0.5)\n"
        "        return n\n", None),
    "condition-wait": (
        "import threading\n"
        "class Svc:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._cv = threading.Condition(self._lock)\n"
        "    def take(self):\n"
        "        with self._cv:\n"
        "            self._cv.wait(1.0)\n", "T003"),
    "str-join": (
        "import threading\n"
        "class Fmt:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def render(self, parts):\n"
        "        with self._lock:\n"
        "            return ', '.join(parts)\n", None),
    "daemon-thread": (
        "import threading\n"
        "def kick(fn):\n"
        "    threading.Thread(target=fn, daemon=True).start()\n", None),
    "joined-thread": (
        "import threading\n"
        "def run(fn):\n"
        "    t = threading.Thread(target=fn)\n"
        "    t.start()\n"
        "    t.join()\n", None),
    "double-checked": (
        "import threading\n"
        "class Cache:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._plan = None\n"
        "    def ensure(self):\n"
        "        if self._plan is None:\n"
        "            with self._lock:\n"
        "                if self._plan is None:\n"
        "                    self._plan = object()\n"
        "        return self._plan\n", "T005"),
    "signature-first": (
        "def poll(led, cache):\n"
        "    sig = led.index_signature()\n"
        "    recs = led.query(kind='service-request')\n"
        "    cache[sig] = recs\n"
        "    return recs\n", None),
    "default-arg": (
        "import threading\n"
        "def fan_out(items, handle):\n"
        "    ts = []\n"
        "    for item in items:\n"
        "        ts.append(threading.Thread(\n"
        "            target=lambda item=item: handle(item),\n"
        "            daemon=True))\n"
        "    for t in ts:\n"
        "        t.start()\n"
        "    return ts\n", "T008"),
    "sync-outside-lock": (
        "import threading, torch\n"
        "class Host:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def poll(self):\n"
        "        torch.cuda.synchronize()\n"
        "        with self._lock:\n"
        "            return 1\n", None),
}


@pytest.mark.parametrize("case", sorted(CLEAN))
def test_clean_counterparts(case):
    src, rule = CLEAN[case]
    want, got = both_source(src, f"{case}.py")
    assert got == want
    if rule is None:
        assert got == []
    else:
        assert rule not in {r for r, *_ in got}


# the card's blocking calls: T003 in the port, nothing in the reference
CARD_T003 = {
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
    "stream.synchronize": "self._stream.synchronize()",
    "event.synchronize": "ev.synchronize()",
    "_native.build_all": "_native.build_all()",
    "_native._load": "_native._load('wgl32_chunk')",
    "_native._lib": "ops._native._lib('wgl32_chunk')",
}


@pytest.mark.parametrize("case", sorted(CARD_T003))
def test_card_blocking_calls_under_a_lock(case):
    src = ("import threading, torch\n"
           "from .ops import _native\n"
           "class Host:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "    def poll(self, ev):\n"
           "        with self._lock:\n"
           f"            {CARD_T003[case]}\n")
    got = tlint.lint_source(src, "card.py")
    assert [(f.rule, f.line) for f in got] == [("T003", 8)]
    if "synchronize" in case:
        assert "synchronize under a held lock" in got[0].message
    else:
        assert "an nvcc build" in got[0].message
    assert jlint.lint_source(src, "card.py") == []


# tests/test_threadlint.py's allowlist cases
ALLOW = {
    "wrong-rule-id": (
        "import threading, time\n"
        "class H:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def s(self):\n"
        "        with self._lock:\n"
        "            time.sleep(1)  # threadlint: ok(T001)\n", ["T003"]),
    "bare-ok": (
        "import threading, time\n"
        "class H:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def s(self):\n"
        "        with self._lock:\n"
        "            time.sleep(1)  # threadlint: ok\n", []),
    "line-above": (
        "import threading, time\n"
        "class H:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def s(self):\n"
        "        with self._lock:\n"
        "            # threadlint: ok(T003) — a test's deliberate stall\n"
        "            time.sleep(1)\n", []),
    "ok-file-in-header": (
        "# threadlint: ok-file(T004)\n"
        "import threading\n"
        "def kick(fn):\n"
        "    t = threading.Thread(target=fn)\n"
        "    t.start()\n", []),
    "ok-file-buried": (
        "x = 1\n" * 25 + "# threadlint: ok-file(T004)\n"
        "import threading\n"
        "def kick(fn):\n"
        "    t = threading.Thread(target=fn)\n"
        "    t.start()\n", ["T004"]),
    "bare-ok-file-ignored": (
        "# threadlint: ok-file()\n"
        "import threading\n"
        "def kick(fn):\n"
        "    t = threading.Thread(target=fn)\n"
        "    t.start()\n", ["T004"]),
}


@pytest.mark.parametrize("case", sorted(ALLOW))
def test_allowlist_cases(case):
    src, rules = ALLOW[case]
    want, got = both_source(src, f"{case}.py")
    assert got == want
    assert [r for r, *_ in got] == rules


def test_allowlisted_fixture_is_clean():
    assert tlint.lint_file(os.path.join(FIXTURES,
                                        "fixture_allowlisted.py")) == []


def test_finding_str_has_path_line_rule():
    path = os.path.join(FIXTURES, "fixture_t003.py")
    f = tlint.lint_file(path)[0]
    assert str(f).startswith(f"{path}:{f.line}:{f.col}: T003 ")
    assert "[blocking-call-under-lock]" in str(f)


def test_default_paths_are_the_references_twins():
    port = [os.path.relpath(p, tlint.PACKAGE_DIR)
            for p in tlint.DEFAULT_PATHS]
    ref = [os.path.relpath(p, os.path.join(REPO, "jepsen_tpu"))
           for p in jcli.DEFAULT_PATHS]
    assert port == ref
    assert all(os.path.isfile(p) for p in tlint.DEFAULT_PATHS)


def test_the_ports_threaded_plane_lints_clean():
    assert tlint.lint_paths(tlint.DEFAULT_PATHS) == []


def test_every_port_allowlist_has_a_reason():
    """An allowlist comment in the port names its rules and says why."""
    bare = []
    for root, _dirs, files in os.walk(tlint.PACKAGE_DIR):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    m = re.search(r"#\s*(thread|kernel)lint:\s*ok(.*)$",
                                  line)
                    if m is None or "`" in line:
                        continue   # docstrings quote the syntax
                    if not re.match(r"(-file)?\(K?T?\d+(,\s*[KT]\d+)*\)"
                                    r"\s+—\s+\S", m.group(2)):
                        bare.append(f"{path}:{i}: {line.strip()}")
    assert bare == []


CLI_CASES = {
    "clean-path": [os.path.join(FIXTURES, "fixture_allowlisted.py")],
    "fixture": [os.path.join(FIXTURES, "fixture_t002.py")],
    "rules-scope": ["--rules", "T005",
                    os.path.join(FIXTURES, "fixture_t002.py")],
    "unknown-rule": ["--rules", "T999"],
    "rules-no-list": ["--rules"],
    "list-rules": ["--list-rules"],
    "check-fixture": ["--check", os.path.join(FIXTURES, "fixture_t001.py")],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_exit_codes_match_reference(case, capsys):
    argv = CLI_CASES[case]
    want = jcli.main(list(argv))
    want_out = capsys.readouterr()
    got = tlint.main(list(argv))
    got_out = capsys.readouterr()
    assert got == want
    assert want in {"clean-path": (0,), "fixture": (1,),
                    "rules-scope": (0,), "unknown-rule": (254,),
                    "rules-no-list": (254,), "list-rules": (0,),
                    "check-fixture": (1,)}[case]
    assert got_out.out == want_out.out
    assert [ln.split(": ", 1)[-1] for ln in got_out.err.splitlines()] == \
        [ln.split(": ", 1)[-1] for ln in want_out.err.splitlines()]


def test_module_cli_runs_clean_on_the_tree():
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.analysis.threadlint",
         "--check"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "" and "Warning" not in proc.stderr


# ---------------------------------------------------------------------------
# gitscope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,roots", [
    ("/a/b/c.py", ["/a/b"]), ("/a/x/c.py", ["/a/b"]), ("/a/b", ["/a/b"]),
    ("/a/bc/d.py", ["/a/b"]), ("/a/b/c.py", ["/z", "/a/b/c.py"])])
def test_gitscope_under_matches(path, roots):
    assert tgitscope.under(path, roots) == jgitscope.under(path, roots)


def _git(root, *args):
    subprocess.run(["git", "-c", "user.email=t@example.com",
                    "-c", "user.name=t", *args], cwd=root, check=True,
                   capture_output=True, timeout=60)


def test_gitscope_scopes_a_git_tree_as_the_reference(tmp_path, capsys):
    root = str(tmp_path)
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    for name in ("a.py", "b.py", "gone.py"):
        (pkg / name).write_text("x = 1\n")
    (tmp_path / "out.py").write_text("x = 1\n")
    _git(root, "init", "-q")
    _git(root, "add", "-A")
    _git(root, "commit", "-q", "-m", "seed")
    (pkg / "a.py").write_text("x = 2\n")          # modified
    (pkg / "new.py").write_text("y = 1\n")        # untracked
    (pkg / "notes.txt").write_text("n\n")         # not python
    (pkg / "gone.py").unlink()                    # deleted
    (tmp_path / "out.py").write_text("x = 3\n")   # outside the scope
    want = jgitscope.changed_files(root)
    assert sorted(tgitscope.changed_files(root)) == sorted(want)
    assert sorted(os.path.basename(p) for p in want) == [
        "a.py", "new.py", "out.py"]
    scope = [str(pkg)]
    got = tgitscope.scope_changed(scope, root, quiet=True, label="x")
    ref = jgitscope.scope_changed(scope, root, quiet=True, label="x")
    assert (sorted(got[0]), got[1]) == (sorted(ref[0]), ref[1])
    assert got[1] is False and len(got[0]) == 2
    # nothing changed under a scope: done, and the same note
    empty = [str(tmp_path / "nothing")]
    assert tgitscope.scope_changed(empty, root, quiet=False,
                                   label="x") == ([], True)
    t_out = capsys.readouterr().out
    assert jgitscope.scope_changed(empty, root, quiet=False,
                                   label="x") == ([], True)
    assert capsys.readouterr().out == t_out


def test_gitscope_without_git_falls_back_to_the_full_paths(
        tmp_path, capsys, monkeypatch):
    # git must not find a repository above the temporary directory
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path))
    root = str(tmp_path / "not-a-repo")
    os.makedirs(root)
    assert tgitscope.changed_files(root) is None
    got = tgitscope.scope_changed(["p"], root, quiet=True, label="x")
    err = capsys.readouterr().err
    assert got == jgitscope.scope_changed(["p"], root, quiet=True,
                                          label="x") == (["p"], False)
    assert "falls back" in err
