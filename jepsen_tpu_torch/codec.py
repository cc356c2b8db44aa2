"""Object <-> bytes serialization (jepsen/src/jepsen/codec.clj:9-29).

The reference round-trips EDN text; this framework's store format is
JSON-payload-based (store/format.py), so the codec speaks compact JSON
with the same nil conventions: None encodes to zero bytes, and zero
bytes (or None) decode to None.

The port's copy of `jepsen_tpu/codec.py`, unchanged but for this
docstring.
"""

from __future__ import annotations

import json
from typing import Any, Optional


def _check_keys(o: Any) -> None:
    """json.dumps silently coerces non-str dict keys (1 -> "1"), which
    would break decode(encode(o)) == o without an error — reject them
    up front instead."""
    if isinstance(o, dict):
        for k, v in o.items():
            if not isinstance(k, str):
                raise TypeError(
                    f"codec.encode: non-string dict key {k!r} would not "
                    "round-trip (json object keys are strings)")
            _check_keys(v)
    elif isinstance(o, (list, tuple)):
        for v in o:
            _check_keys(v)


def encode(o: Any) -> bytes:
    """Serialize an object to bytes (codec.clj:9-16). Non-JSON-native
    values — including dicts with non-string keys, which json would
    silently coerce — raise TypeError: silent coercion would break the
    decode(encode(o)) == o round-trip."""
    if o is None:
        return b""
    _check_keys(o)
    return json.dumps(o, separators=(",", ":"), sort_keys=True).encode()


def decode(data: Optional[bytes]) -> Any:
    """Deserialize bytes to an object (codec.clj:18-29)."""
    if data is None or len(data) == 0:
        return None
    return json.loads(bytes(data).decode())
