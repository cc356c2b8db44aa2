"""A small EDN reader — enough to replay real Jepsen artifacts.

The reference persists every run's history as EDN, one op map per
`prn` line (jepsen/src/jepsen/store.clj:338-346 write-history! via
jepsen.util/write-history!), e.g.

    {:process 0, :type :invoke, :f :read, :value nil, :index 0,
     :time 3291485317}

and its checker tests hand-write histories in the same shape
(jepsen/test/jepsen/checker_test.clj). Ingesting that format means a
reference run can be replayed through this framework's checker planes
for cross-validation — SURVEY §7 step 1's differential requirement:

    from jepsen_tpu_torch import checker
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import cas_register
    h = History.from_edn("history.edn").index()
    checker.linearizable(cas_register(), algorithm="cuda-wgl").check({}, h, {})

Supported: nil/true/false, integers (incl. 123N bigints, radix 0x/0o),
floats (incl. 1.5M decimals), strings, characters, keywords, symbols,
lists, vectors, maps, sets, tagged literals (#inst/#uuid read as
strings; record tags like #jepsen.history.Op{...} read as their map),
#_ discard, and ; comments. Deliberately Python-native output:
keywords and symbols become plain strings (":type :invoke" ->
"type"/"invoke" — exactly the op-dict shape History.append expects),
vectors/lists become lists, sets become Python sets, map keys are
frozen to hashable forms.

The port's copy of `jepsen_tpu/edn.py`, unchanged but for this
docstring.
"""

from __future__ import annotations

from typing import Any, Optional

_WS = set(" \t\n\r,")
_DELIM = _WS | set("()[]{}\"@;")
_CHAR_NAMES = {"newline": "\n", "space": " ", "tab": "\t",
               "return": "\r", "backspace": "\b", "formfeed": "\f"}
_STR_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "b": "\b",
                "f": "\f", "\\": "\\", '"': '"'}


class EdnError(ValueError):
    pass


_DISCARD = object()  # sentinel: a #_ form was consumed here


class _Reader:
    def __init__(self, text: str):
        self.s = text
        self.i = 0
        self.n = len(text)

    # -- low level ----------------------------------------------------
    def _skip_ws(self):
        while self.i < self.n:
            c = self.s[self.i]
            if c in _WS:
                self.i += 1
            elif c == ";":
                while self.i < self.n and self.s[self.i] != "\n":
                    self.i += 1
            else:
                return

    def _peek(self) -> Optional[str]:
        return self.s[self.i] if self.i < self.n else None

    def at_eof(self) -> bool:
        self._skip_ws()
        return self.i >= self.n

    # -- forms --------------------------------------------------------
    def read(self) -> Any:
        """Read one VALUE (discards skipped; EOF mid-read raises)."""
        while True:
            v = self._read_form()
            if v is not _DISCARD:
                return v

    def _read_form(self) -> Any:
        self._skip_ws()
        if self.i >= self.n:
            raise EdnError("unexpected EOF")
        c = self.s[self.i]
        if c == "(":
            return self._read_seq(")")
        if c == "[":
            return self._read_seq("]")
        if c == "{":
            return self._read_map()
        if c == '"':
            return self._read_string()
        if c == "\\":
            return self._read_char()
        if c == "#":
            return self._read_dispatch()
        if c in ")]}":
            raise EdnError(f"unmatched {c!r} at {self.i}")
        return self._read_atom()

    def _read_seq(self, closer: str) -> list:
        self.i += 1  # opener
        out = []
        while True:
            self._skip_ws()
            if self._peek() is None:
                raise EdnError(f"unterminated sequence, wanted {closer!r}")
            if self._peek() == closer:
                self.i += 1
                return out
            v = self._read_form()
            if v is not _DISCARD:  # '[1 #_ 2]' == [1]
                out.append(v)

    def _read_map(self) -> dict:
        items = self._read_seq("}")
        if len(items) % 2:
            raise EdnError("map literal with odd number of forms")
        out = {}
        for k, v in zip(items[::2], items[1::2]):
            out[_freeze(k)] = v
        return out

    def _read_string(self) -> str:
        self.i += 1
        out = []
        while True:
            if self.i >= self.n:
                raise EdnError("unterminated string")
            c = self.s[self.i]
            self.i += 1
            if c == '"':
                return "".join(out)
            if c == "\\":
                e = self.s[self.i] if self.i < self.n else None
                if e is None:
                    raise EdnError("unterminated escape")
                self.i += 1
                if e == "u":
                    hexs = self.s[self.i:self.i + 4]
                    try:
                        out.append(chr(int(hexs, 16)))
                    except ValueError:
                        raise EdnError(
                            f"bad unicode escape \\u{hexs}") from None
                    self.i += 4
                elif e in _STR_ESCAPES:
                    out.append(_STR_ESCAPES[e])
                else:
                    raise EdnError(f"bad string escape \\{e}")
            else:
                out.append(c)

    def _read_char(self) -> str:
        self.i += 1
        j = self.i
        while j < self.n and self.s[j] not in _DELIM:
            j += 1
        tok = self.s[self.i:j]
        if not tok:
            raise EdnError("bare backslash")
        self.i = j
        if len(tok) == 1:
            return tok
        if tok in _CHAR_NAMES:
            return _CHAR_NAMES[tok]
        if tok.startswith("u") and len(tok) == 5:
            try:
                return chr(int(tok[1:], 16))
            except ValueError:
                raise EdnError(
                    f"bad unicode character \\{tok}") from None
        raise EdnError(f"unknown character literal \\{tok}")

    def _read_dispatch(self) -> Any:
        self.i += 1
        c = self._peek()
        if c == "{":  # set
            items = self._read_seq("}")
            return set(_freeze(x) for x in items)
        if c == "_":  # discard the NEXT form only; yield a sentinel so
            self.i += 1  # '[1 #_ 2]' and trailing '#_ x' stay valid
            self.read()
            return _DISCARD
        # tagged literal: #tag form. #inst/#uuid stay strings; record
        # tags (#some.ns.Op{...}) yield their map — exactly what
        # history replay wants from op records.
        j = self.i
        while j < self.n and self.s[j] not in _DELIM:
            j += 1
        tag = self.s[self.i:j]
        if not tag:
            raise EdnError("bare # dispatch")
        self.i = j
        return self.read()

    def _read_atom(self) -> Any:
        j = self.i
        while j < self.n and self.s[j] not in _DELIM:
            j += 1
        tok = self.s[self.i:j]
        if not tok:
            # a delimiter char no rule consumes (e.g. a stray "@"):
            # raising beats an empty-symbol that never advances the
            # cursor (observed: loads_all spun forever on "@")
            raise EdnError(
                f"unexpected character {self.s[self.i]!r} at {self.i}")
        self.i = j
        if tok == "nil":
            return None
        if tok == "true":
            return True
        if tok == "false":
            return False
        if tok.startswith(":"):
            return tok[1:]  # keyword -> plain string
        num = _try_number(tok)
        if num is not None:
            return num
        return tok  # symbol -> plain string


def _try_number(tok: str) -> Optional[Any]:
    t = tok
    neg = t.startswith("-")
    if t[:1] in "+-":
        t = t[1:]
    if not t or not (t[0].isdigit() or (t[0] == "." and
                                        t[1:2].isdigit())):
        return None
    body = tok
    try:
        if t.endswith("N"):
            return int(body[:-1])
        if t.endswith("M"):
            return float(body[:-1])
        if t[:2] in ("0x", "0X"):
            return int(body, 16)
        if t[:2] in ("0o", "0O"):
            return int(body, 8)
        if "/" in t:  # ratio
            a, b = body.split("/")
            if int(b) == 0:
                raise EdnError(f"ratio with zero denominator: {tok}")
            return int(a) / int(b)
        if any(ch in t for ch in ".eE"):
            return float(body)
        return int(body)
    except EdnError:
        raise  # EdnError IS a ValueError — don't demote it to a symbol
    except ValueError:
        return None


def _freeze(x: Any) -> Any:
    """Hashable view of a form, for map keys / set members."""
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, set):
        return frozenset(x)
    return x


def loads(text: str) -> Any:
    """Parse ONE EDN form."""
    r = _Reader(text)
    v = r.read()
    if not r.at_eof():
        raise EdnError(f"trailing data at {r.i}")
    return v


def loads_all(text: str) -> list:
    """Parse every top-level form (the one-op-per-line history file)."""
    r = _Reader(text)
    out = []
    while not r.at_eof():
        v = r._read_form()
        if v is not _DISCARD:  # a trailing top-level '#_ x' is valid
            out.append(v)
    return out


def load_history(source: str):
    """Build a History from EDN text: either one vector of op maps, or
    one op map per line (store.clj's history.edn shape)."""
    from .history import History

    forms = loads_all(source)
    if len(forms) == 1 and isinstance(forms[0], list):
        forms = forms[0]
    h = History()
    for op in forms:
        if not isinstance(op, dict):
            raise EdnError(f"history form is not an op map: {op!r}")
        h.append(op)
    return h
