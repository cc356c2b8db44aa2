"""Remote-execution protocol + shell command algebra.

Capability parity with jepsen.control.core
(`jepsen/src/jepsen/control/core.clj`): the `Remote` protocol
(connect/disconnect/execute/upload/download, core.clj:7-58), shell
escaping with `Literal` passthrough (core.clj:62-110), env-var
construction (core.clj:112-140), sudo wrapping (core.clj:142-153), and
nonzero-exit enforcement (core.clj:155-177).

The port's copy of `jepsen_tpu/control/core.py`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


@dataclass(frozen=True)
class Literal:
    """A string passed unescaped to the shell (core.clj:60-65)."""

    string: str


def lit(s: str) -> Literal:
    return Literal(s)


PIPE = lit("|")
AND = lit("&&")

_NEEDS_QUOTING = re.compile(r'[\\$`"\s(){}\[\]*?<>&;]')
_QUOTE_CHARS = re.compile(r'([\\$`"])')


def escape(s) -> str:
    """Escape a thing for the shell (core.clj:67-110): None -> empty,
    Literals pass through, lists/sets/tuples escape elementwise and join
    with spaces, strings quote when they contain metacharacters."""
    if s is None:
        return ""
    if isinstance(s, Literal):
        return s.string
    if isinstance(s, (list, tuple, set, frozenset)):
        items = sorted(s, key=str) if isinstance(s, (set, frozenset)) else s
        return " ".join(escape(x) for x in items)
    s = str(s)
    if s == "":
        return '""'
    if _NEEDS_QUOTING.search(s):
        return '"' + _QUOTE_CHARS.sub(r"\\\1", s) + '"'
    return s


def env(e) -> Optional[Literal]:
    """Build an env-var prefix string from a dict (core.clj:112-140)."""
    if e is None:
        return None
    if isinstance(e, Literal):
        return e
    if isinstance(e, str):
        return lit(e)
    if isinstance(e, dict):
        return lit(" ".join(f"{k}={escape(v)}" for k, v in e.items()))
    raise TypeError(f"can't build env from {e!r}")


def wrap_sudo(context: dict, action: dict) -> dict:
    """Wrap an action's :cmd in sudo, per the context's sudo/sudo_password
    (core.clj:142-153)."""
    sudo = context.get("sudo")
    if not sudo:
        return action
    out = dict(action)
    out["cmd"] = f"sudo -k -S -u {sudo} bash -c " + escape(action["cmd"])
    pw = context.get("sudo_password")
    if pw:
        out["in"] = pw + "\n" + (action.get("in") or "")
    return out


class NonzeroExit(Exception):
    """A remote command exited with nonzero status (core.clj:155-177)."""

    def __init__(self, result: dict):
        self.result = result
        action = result.get("action") or {}
        super().__init__(
            f"Command exited with non-zero status {result.get('exit')} on "
            f"node {result.get('host')}:\n{action.get('cmd')}\n\n"
            f"STDIN:\n{action.get('in')}\n\nSTDOUT:\n{result.get('out')}\n\n"
            f"STDERR:\n{result.get('err')}")


def throw_on_nonzero_exit(result: dict) -> dict:
    if result.get("exit") != 0:
        raise NonzeroExit(result)
    return result


class Remote:
    """Base remote (core.clj:7-58). Context maps carry dir/sudo/
    sudo_password; conn specs carry host/port/username/password/
    private_key_path/strict_host_key_checking."""

    def connect(self, conn_spec: dict) -> "Remote":
        raise NotImplementedError

    def disconnect(self) -> None:
        return None

    def execute(self, context: dict, action: dict) -> dict:
        """Run action {"cmd": ..., "in": ...}; return it with exit/out/err."""
        raise NotImplementedError

    def upload(self, context: dict, local_paths, remote_path,
               opts: Optional[dict] = None) -> None:
        raise NotImplementedError

    def download(self, context: dict, remote_paths, local_path,
                 opts: Optional[dict] = None) -> None:
        raise NotImplementedError
