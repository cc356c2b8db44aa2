"""The port's kernel-host lint (`analysis/kernellint.py`), against jaxlint.

Each rule K001–K008 is the twin of the reference's J001–J008
(`jepsen_tpu/analysis/jaxlint.py`) on the port's launch paths: one
inline fixture trips each rule and one beside it does not. The
allowlist (`# kernellint: ok(...)`, the line or the line above,
`ok-file(...)` only in the first 20 lines and never bare) behaves as
`jaxlint._apply_allowlist` does on the same text with the tag renamed.
The port's `DEFAULT_PATHS` lint clean, and each allowlist comment in
them suppresses a finding the lint makes without it. The CLI (`python
-m jepsen_tpu_torch.analysis.kernellint`) exits as `scripts/jax_lint.py`
does: 0 clean, 1 findings, 254 a usage error.
"""

import importlib
import os
import re
import subprocess
import sys

import pytest

from jepsen_tpu.analysis import jaxlint
from jepsen_tpu_torch.analysis import kernellint as klint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFIXTURES = os.path.join(REPO, "tests", "jaxlint_fixtures")

sys.path.insert(0, os.path.join(REPO, "scripts"))
jcli = importlib.import_module("jax_lint")

HEAD = "import functools\nimport numpy as np\nimport torch\n" \
       "from . import _native, wgl32\n"

# rule -> (source that trips it, source beside it that does not)
FIXTURES = {
    "K001": (
        "def chunk(x, n):\n"
        "    out = torch.empty(n, dtype=torch.int32, device=x.device)\n"
        "    _native.launch('k', [x.data_ptr(), out.data_ptr()], [n], 0)\n"
        "    return int(out.sum())\n",
        "def chunk(x, n, mask):\n"
        "    out = torch.empty(n, dtype=torch.int32, device=x.device)\n"
        "    idx = np.flatnonzero(mask)\n"
        "    words = sum(1 << i for i in idx.tolist())\n"
        "    _native.launch('k', [x.data_ptr(), out.data_ptr()],\n"
        "                   [int(n), words, x.shape[0]], 0)\n"
        "    return out\n"),
    "K002": (
        "def launch(x, n):\n"
        "    out = torch.zeros(n, dtype=torch.int32, device=x.device)\n"
        "    _native.launch('k', [x.data_ptr(), out.data_ptr()], [n], 0)\n"
        "    if out.any():\n"
        "        raise RuntimeError('overflow')\n"
        "    return out\n",
        "def launch(x, n, out=None):\n"
        "    if out is None:\n"
        "        out = torch.zeros(n, dtype=torch.int32, device=x.device)\n"
        "    if x.device.type != 'cuda' or n > 1 << 20:\n"
        "        raise ValueError('k')\n"
        "    _native.launch('k', [x.data_ptr(), out.data_ptr()], [n], 0)\n"
        "    return out\n"),
    "K003": (
        "def ensure_built(names):\n"
        "    _native.build_all()\n"
        "    return names\n",
        "@functools.lru_cache(maxsize=None)\n"
        "def ensure_built():\n"
        "    return _native.build_all()\n"
        "\n"
        "BUILT = _native.build_all()\n"),
    "K004": (
        "def entry(name):\n"
        "    return _native._lib(name)\n",
        "def entry():\n"
        "    return _native._lib('wgl32_chunk')\n"
        "\n"
        "@functools.lru_cache(maxsize=None)\n"
        "def variant(define):\n"
        "    from torch.utils import cpp_extension\n"
        "    return cpp_extension.load(name=f'k_{define}', sources=['k.cu'],\n"
        "                              extra_cuda_cflags=[f'-D{define}'])\n"),
    "K005": (
        "def pack(a, b):\n"
        "    return a.to(torch.int32) + b.to(torch.int64)\n",
        "def pack(a, b):\n"
        "    return a.to(torch.int32) + b.to(torch.int32)\n"),
    "K006": (
        "def per_lane(consts, carries, lanes):\n"
        "    for i in range(lanes):\n"
        "        wgl32.chunk(consts[i], carries[i], K=2)\n",
        "def per_shard(steps, consts, carries, nd):\n"
        "    for d in range(nd):\n"
        "        steps[d](consts[d], carries[d])\n"
        "    wgl32.chunk_batched(consts, carries, K=2)\n"),
    "K007": (
        "def poll(step, carry):\n"
        "    while True:\n"
        "        carry, summary = step(carry)\n"
        "        s = summary.cpu().numpy()\n"
        "        if s[0]:\n"
        "            return s\n",
        "def poll(step, carry, rows):\n"
        "    while True:\n"
        "        carry, summary = step(carry)\n"
        "        # kernellint: ok(K007) — the one designed poll\n"
        "        s = summary.cpu().numpy()\n"
        "        if s[0]:\n"
        "            break\n"
        "    for r in rows:\n"
        "        print(r.tolist())\n"
        "    return s\n"),
    "K008": (
        "def chunk(consts, carry, K):\n"
        "    carry = [c.clone() for c in carry]\n"
        "    _native.launch('k', [c.data_ptr() for c in carry], [K], 0)\n"
        "    return carry\n",
        "def chunk(consts, carry, K):\n"
        "    carry[0].zero_()\n"
        "    scratch = consts[0].clone()\n"
        "    _native.launch('k', [c.data_ptr() for c in carry] +\n"
        "                   [scratch.data_ptr()], [K], 0)\n"
        "    return carry\n"),
}


def rules_of(src):
    return [f.rule for f in klint.lint_source(HEAD + src, "fixture.py")]


@pytest.mark.parametrize("rule", sorted(klint.RULES))
def test_fixture_trips_its_rule(rule):
    assert rule in rules_of(FIXTURES[rule][0]), rules_of(FIXTURES[rule][0])


@pytest.mark.parametrize("rule", sorted(klint.RULES))
def test_counterpart_is_clean(rule):
    assert rules_of(FIXTURES[rule][1]) == []


def test_rules_are_the_references_twins():
    assert sorted(klint.RULES) == [f"K{r[1:]}" for r in sorted(jaxlint.RULES)]
    assert klint.RULES["K007"] == jaxlint.RULES["J007"]
    assert klint.RULES["K005"] == jaxlint.RULES["J005"]


def test_host_syncs_each_trip_k001():
    """Every host-sync form of K001 inside a launch wrapper."""
    forms = ["out.item()", "out.tolist()", "out.cpu()", "out.numpy()",
             "torch.cuda.synchronize()", "stream.synchronize()",
             "ev.synchronize()", "bool(out)", "float(out)"]
    body = "\n".join(f"    {f}" for f in forms)
    src = ("def chunk(x, n, stream, ev):\n"
           "    out = torch.empty(n, device=x.device)\n"
           "    _native.launch('k', [out.data_ptr()], [n], 0)\n"
           f"{body}\n")
    found = klint.lint_source(HEAD + src, "forms.py")
    assert [(f.rule, f.line - 4) for f in found] == [
        ("K001", 4 + i) for i in range(len(forms))]


def test_a_launch_helper_makes_its_callers_wrappers():
    src = ("def _launch(name, ptrs, ints):\n"
           "    _native.launch(name, ptrs, ints, 0)\n"
           "def square(r, cnt):\n"
           "    _launch('sq', [r, cnt], [])\n"
           "    return cnt.tolist()\n"
           "def closure(r, cnt):\n"
           "    square(r, cnt)\n"
           "    return cnt.tolist()\n")
    found = klint.lint_source(HEAD + src, "helper.py")
    assert [(f.rule, f.line - 4) for f in found] == [("K001", 5)]


def test_k007_for_loops_check_only_the_unambiguous_syncs():
    src = ("def drain(step, n, streams):\n"
           "    for i in range(n):\n"
           "        out = step(i)\n"
           "        a = out.tolist()\n"
           "        b = out.cpu()\n"
           "    for st in streams:\n"
           "        st.synchronize()\n")
    found = klint.lint_source(HEAD + src, "for.py")
    assert [(f.rule, f.line - 4) for f in found] == [("K007", 5),
                                                     ("K007", 7)]


def test_k007_sees_a_kernels_out_parameter():
    """The port's kernels write counts into a tensor they are given:
    reading it back each iteration is a transfer per iteration."""
    src = ("def squarings(square, reach, counts, iters):\n"
           "    i = 0\n"
           "    while i < iters:\n"
           "        reach = square(reach, counts[i])\n"
           "        c = counts[i].tolist()\n"
           "        i += 1\n")
    found = klint.lint_source(HEAD + src, "out.py")
    assert [(f.rule, f.line - 4) for f in found] == [("K007", 5)]


def test_the_k007_fixture_matches_jaxlints_on_its_twin():
    """The J007 fixture's poll loop, in torch, trips K007 on the same
    line."""
    path = os.path.join(JFIXTURES, "fixture_j007.py")
    want = [f.line for f in jaxlint.lint_file(path) if f.rule == "J007"]
    with open(path) as fh:
        src = fh.read()
    src = src.replace("np.asarray(summary)", "summary.cpu().numpy()")
    src = src.replace("jax.device_get(out)", "out.cpu()")
    got = [f.line for f in klint.lint_source(src, "j007.py")]
    assert got == want


def test_finding_str_has_path_line_rule():
    f = klint.lint_source(HEAD + FIXTURES["K007"][0], "p.py")[0]
    assert str(f) == (f"p.py:{f.line}:{f.col}: K007 [transfer-in-loop] "
                      f"{f.message}")


def test_syntax_error_is_a_finding():
    (f,) = klint.lint_source("def (:\n", "bad.py")
    assert f.rule == "K001" and "syntax error" in f.message


# ---------------------------------------------------------------------------
# the allowlist contract
# ---------------------------------------------------------------------------

BODY = ("import torch\n"
        "def poll(step, carry):\n"
        "    while True:\n"
        "        carry, summary = step(carry)\n"
        "{above}"
        "        s = summary.cpu(){inline}\n"
        "        if s[0]:\n"
        "            return s\n")

ALLOW = {
    "inline": (BODY.format(above="", inline="  # kernellint: ok(K007) — why"),
               []),
    "inline-two-rules": (BODY.format(
        above="", inline="  # kernellint: ok(K001, K007) — why"), []),
    "line-above": (BODY.format(
        above="        # kernellint: ok(K007) — why\n", inline=""), []),
    "bare-inline": (BODY.format(above="", inline="  # kernellint: ok"),
                    []),
    "wrong-rule": (BODY.format(above="", inline="  # kernellint: ok(K001)"),
                   ["K007"]),
    "two-lines-above": (BODY.format(
        above="        # kernellint: ok(K007) — why\n        pass\n",
        inline=""), ["K007"]),
    "ok-file-header": ("# kernellint: ok-file(K007)\n"
                       + BODY.format(above="", inline=""), []),
    "ok-file-buried": ("x = 1\n" * 25 + "# kernellint: ok-file(K007)\n"
                       + BODY.format(above="", inline=""), ["K007"]),
    "ok-file-bare": ("# kernellint: ok-file()\n"
                     + BODY.format(above="", inline=""), ["K007"]),
    "ok-file-no-parens": ("# kernellint: ok-file\n"
                          + BODY.format(above="", inline=""), ["K007"]),
    "other-tag": (BODY.format(above="", inline="  # jaxlint: ok(K007)"),
                  ["K007"]),
}


@pytest.mark.parametrize("case", sorted(ALLOW))
def test_allowlist_contract(case):
    src, rules = ALLOW[case]
    assert [f.rule for f in klint.lint_source(src, "a.py")] == rules


@pytest.mark.parametrize("case", sorted(ALLOW))
def test_allowlist_behaves_as_jaxlints(case):
    """The same raw findings through both `_apply_allowlist`s, the text
    given to jaxlint with the tags renamed (its own tag made inert),
    keep the same findings."""
    src, _ = ALLOW[case]
    renamed = src.replace("jaxlint", "otherlint").replace("kernellint",
                                                          "jaxlint")
    n = len(src.splitlines())
    raw = [(ln, rule) for ln in range(1, n + 1)
           for rule in ("K001", "K007")]
    got = klint._apply_allowlist(
        [klint.Finding("a.py", ln, 0, r, "m") for ln, r in raw], src)
    want = jaxlint._apply_allowlist(
        [jaxlint.Finding("a.py", ln, 0, r, "m") for ln, r in raw], renamed)
    assert [(f.line, f.rule) for f in got] == \
        [(f.line, f.rule) for f in want]


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

def _tree_files():
    out = []
    for p in klint.DEFAULT_PATHS:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                out += [os.path.join(root, f) for f in sorted(files)
                        if f.endswith(".py")]
        else:
            out.append(p)
    return out


def test_default_paths():
    rel = [os.path.relpath(p, klint.PACKAGE_DIR) for p in klint.DEFAULT_PATHS]
    assert rel == ["ops", "elle", "parallel", "bench.py"]
    assert all(os.path.exists(p) for p in klint.DEFAULT_PATHS)


def test_the_ports_kernel_host_code_lints_clean():
    assert klint.lint_paths(klint.DEFAULT_PATHS) == []


ALLOW_LINE = re.compile(r"#\s*kernellint:\s*ok\(([^)]*)\)\s+—\s+\S")


def test_each_allowlist_in_the_tree_suppresses_a_finding():
    """Without its comments, each file's findings are exactly the lines
    its allowlist comments name: none is stale, none bare, and the rule
    each names is the rule found there."""
    n_comments = 0
    for path in _tree_files():
        with open(path) as fh:
            lines = fh.read().splitlines()
        marks = {}
        for i, line in enumerate(lines, 1):
            if "kernellint:" in line and "`" not in line:
                m = ALLOW_LINE.search(line)
                assert m, f"{path}:{i}: an allowlist without its reason"
                marks[i] = {r.strip() for r in m.group(1).split(",")}
        if not marks:
            continue
        n_comments += len(marks)
        stripped = "\n".join(re.sub(r"#\s*kernellint:.*$", "", ln)
                             for ln in lines) + "\n"
        found = klint.lint_source(stripped, path)
        covered = set()
        for f in found:
            hits = [ln for ln in (f.line, f.line - 1)
                    if f.rule in marks.get(ln, ())]
            assert hits, f"{path}:{f.line}: {f.rule} not allowlisted"
            covered.add(hits[0])
        assert covered == set(marks), (path, sorted(set(marks) - covered))
    assert n_comments >= 5


CLI_CASES = {
    # (the port's argv, the reference CLI's argv on the J twin, exit)
    "clean-path": (["{clean}"], [os.path.join(JFIXTURES,
                                              "fixture_allowlisted.py")], 0),
    "fixture": (["{k007}"], [os.path.join(JFIXTURES, "fixture_j007.py")], 1),
    "check-fixture": (["--check", "{k007}"],
                      ["--check", os.path.join(JFIXTURES,
                                               "fixture_j007.py")], 1),
    "rules-scope": (["--rules", "K001", "{k007}"],
                    ["--rules", "J001", os.path.join(JFIXTURES,
                                                     "fixture_j007.py")], 0),
    "unknown-rule": (["--rules", "K999"], ["--rules", "J999"], 254),
    "rules-no-list": (["--rules"], ["--rules"], 254),
    "list-rules": (["--list-rules"], ["--list-rules"], 0),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_exit_codes_match_reference(case, tmp_path, capsys):
    k007 = tmp_path / "k007.py"
    k007.write_text(HEAD + FIXTURES["K007"][0])
    clean = tmp_path / "clean.py"
    clean.write_text(HEAD + FIXTURES["K007"][1])
    argv, ref_argv, code = CLI_CASES[case]
    argv = [a.format(k007=k007, clean=clean) for a in argv]
    assert jcli.main(list(ref_argv)) == code
    capsys.readouterr()
    assert klint.main(argv) == code
    out = capsys.readouterr()
    if code == 1:
        assert "K007" in out.err and "1 finding(s)" in out.out
    if case == "list-rules":
        assert out.out.splitlines() == [
            f"{r}  {n}" for r, n in sorted(klint.RULES.items())]


def test_module_cli_runs_clean_on_the_tree():
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.analysis.kernellint",
         "--check"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "" and "Warning" not in proc.stderr
