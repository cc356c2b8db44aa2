"""Changed-file scoping for the lint CLIs (one copy, two linters).

The port of `jepsen_tpu/analysis/gitscope.py`. `python -m
jepsen_tpu_torch.analysis.threadlint` and `python -m
jepsen_tpu_torch.analysis.kernellint` both offer `--changed-only`: lint
just the files changed vs git HEAD (plus untracked), intersected with
the linter's default paths — the fast pre-commit loop. The git plumbing
lives here so the two CLIs cannot drift apart in how they interpret the
working tree.
"""

from __future__ import annotations

import os
import subprocess


def changed_files(repo_root: str):
    """Python files changed vs HEAD (staged, unstaged, untracked),
    absolute paths. Returns None when git is unavailable/failing —
    the caller must then lint the full paths rather than silently
    passing an unknowable working tree."""
    out: list = []
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            cwd=repo_root, capture_output=True, text=True, timeout=30)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=repo_root, capture_output=True, text=True, timeout=30)
        if diff.returncode != 0 or untracked.returncode != 0:
            return None
        names = diff.stdout.splitlines() + untracked.stdout.splitlines()
    except Exception:  # noqa: BLE001 — no git: signal the caller
        return None
    for name in names:
        path = os.path.join(repo_root, name)
        # a deleted tracked file still shows in the diff — nothing to
        # lint there
        if name.endswith(".py") and os.path.isfile(path):
            out.append(path)
    return out


def under(path: str, roots) -> bool:
    """Is `path` one of `roots` or inside one of them?"""
    path = os.path.abspath(path)
    for r in roots:
        r = os.path.abspath(r)
        if path == r or path.startswith(r + os.sep):
            return True
    return False


def scope_changed(paths, repo_root: str, *, quiet: bool,
                  label: str):
    """The shared --changed-only behavior: intersect changed files
    with `paths`. Returns (paths, done) — `done` True means "nothing
    to lint, exit 0 now". Falls back to the full paths (with a stderr
    note) when git is unusable."""
    import sys
    changed = changed_files(repo_root)
    if changed is None:
        # no usable git: a silent pass here would green-light an
        # unknowable tree — lint the full scope instead
        print(f"{label}: git unavailable; --changed-only falls "
              "back to the full lint paths", file=sys.stderr)
        return list(paths), False
    kept = [p for p in changed if under(p, paths)]
    if not kept:
        if not quiet:
            print(f"{label}: no changed files under the lint paths")
        return [], True
    return kept, False
