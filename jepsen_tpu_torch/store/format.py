"""The `.jepsen` binary block file format.

A copy of `jepsen_tpu/store/format.py` that reads and writes the same
bytes, so that either package can re-analyze a run the other stored
(the reference's spec: `jepsen/src/jepsen/store/format.clj:1-177`): an
append-only, CRC32-checksummed block file holding the test map, its
history, and its results, such that

  * the history is committed to disk *before* analysis begins, so a
    crashed analysis can be re-run from the file alone;
  * readers can load the test map and `valid?` without deserializing a
    multi-GB history (lazy block refs + partial maps);
  * writers append — save points never rewrite earlier bytes, they just
    append new blocks and a fresh index.

Layout (all integers little-endian; this is not the JVM):

    | b"JEPTPU\\x01\\n" (8) | index-offset (8) | block 1 | block 2 | ...

Each block:

    | length (8) | crc32 (4) | type (2) | payload ... |

`length` covers the whole block including the header. The CRC covers the
payload, then the header with the CRC field zeroed — so payloads can be
streamed before their checksum is known. Block types:

    1  index:   JSON {"root": block-id, "blocks": {id: offset}}
    2  data:    JSON value; {"__block_ref__": id} pointers may appear
                anywhere and are resolved lazily on read
    3  partial: JSON map + block-ref to a rest-map (for results: the
                small part carries "valid?", the rest can be huge)
    4  chunked: JSON {"chunks": [ids]} — a list concatenated from
                per-chunk data blocks (histories append chunk by chunk)

The header's index-offset points at the most recent index block; writing
a save point = append blocks + append index + patch the 8-byte pointer
(a single atomic-enough write). Recovery after a crash scans forward
from the last valid index and ignores any torn trailing block.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Optional

MAGIC = b"JEPTPU\x01\n"
HEADER_LEN = len(MAGIC) + 8

INDEX_BLOCK = 1
DATA_BLOCK = 2
PARTIAL_BLOCK = 3
CHUNKED_BLOCK = 4

_BLOCK_HEADER = struct.Struct("<QIH")  # length, crc32, type


class CorruptFile(Exception):
    pass


class BlockRef(dict):
    """{"__block_ref__": id} — a lazy pointer to another block."""

    def __init__(self, block_id: int):
        super().__init__(__block_ref__=block_id)

    @property
    def id(self) -> int:
        return self["__block_ref__"]


def is_block_ref(x) -> bool:
    return isinstance(x, dict) and "__block_ref__" in x and len(x) == 1


def _crc(header_sans_crc: bytes, payload: bytes) -> int:
    c = zlib.crc32(payload)
    return zlib.crc32(header_sans_crc, c) & 0xFFFFFFFF


class JepsenFile:
    """An open .jepsen block file. Writers append; readers resolve
    blocks lazily through the index."""

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.writable = mode in ("w", "a")
        if mode == "w" or (mode == "a" and not os.path.exists(path)):
            self.fh: BinaryIO = open(path, "w+b")
            self.fh.write(MAGIC)
            self.fh.write(struct.pack("<Q", 0))
            self.fh.flush()
            self.index: dict = {"root": 0, "blocks": {}}
            self.next_id = 1
        else:
            self.fh = open(path, "r+b" if mode == "a" else "rb")
            self._load()
            if mode == "a":
                # Never append past a torn/uncommitted tail: blocks
                # written there would be unreachable to the
                # scan-forward recovery path. Everything up to and
                # including the committed index block is known valid
                # (blocks are fsynced before the pointer moves), so
                # trim right after it — O(1), no full-file scan.
                end = self._committed_end if self._committed_end \
                    else HEADER_LEN
                self.fh.seek(0, os.SEEK_END)
                if self.fh.tell() > end:
                    self.fh.truncate(end)

    # -- low level -------------------------------------------------------
    def _load(self):
        self.fh.seek(0)
        if self.fh.read(len(MAGIC)) != MAGIC:
            raise CorruptFile(f"{self.path}: bad magic")
        ptr = self.fh.read(8)
        if len(ptr) < 8:
            raise CorruptFile(f"{self.path}: truncated file header")
        (index_off,) = struct.unpack("<Q", ptr)
        payload = None
        self._committed_end = 0  # offset just past the committed index
        if index_off:
            try:
                btype, payload = self._read_block_at(index_off)
                if btype != INDEX_BLOCK:
                    payload = None
            except CorruptFile:
                payload = None
            if payload is not None:
                self._committed_end = (index_off + _BLOCK_HEADER.size
                                       + len(payload))
        if payload is None:
            # Pointer missing, torn, or stale: recover by scanning
            # forward over the append-only block stream for the last
            # valid index block (the documented crash-recovery path).
            found = self._scan_last_index()
            if found is None and index_off:
                # The pointer claims a committed save point but neither
                # it nor the scan can reach one (e.g. early bit-rot
                # blocking the scan): refuse rather than proceed with —
                # or worse, truncate to — an empty index.
                raise CorruptFile(
                    f"{self.path}: committed index unreachable "
                    f"(pointer @{index_off} invalid, scan found no "
                    f"index block)")
            if found is not None:
                off, payload = found
                self._committed_end = (off + _BLOCK_HEADER.size
                                       + len(payload))
                if self.writable:
                    # repair the header pointer for future readers
                    self.fh.seek(len(MAGIC))
                    self.fh.write(struct.pack("<Q", off))
                    self.fh.flush()
                    os.fsync(self.fh.fileno())
        if payload is None:
            self.index = {"root": 0, "blocks": {}}
        else:
            self.index = json.loads(payload)
            self.index["blocks"] = {int(k): v for k, v
                                    in self.index["blocks"].items()}
        ids = self.index["blocks"].keys()
        self.next_id = max(ids, default=0) + 1

    def _iter_valid_blocks(self):
        """Yield (offset, btype, payload) for the contiguous run of
        valid blocks from the start of the file, stopping at the first
        torn/corrupt one."""
        offset = HEADER_LEN
        self.fh.seek(0, os.SEEK_END)
        end = self.fh.tell()
        while offset < end:
            try:
                btype, payload = self._read_block_at(offset)
            except CorruptFile:
                return
            yield offset, btype, payload
            offset += _BLOCK_HEADER.size + len(payload)

    def _scan_last_index(self) -> Optional[tuple]:
        """(offset, payload) of the last checksummed index block,
        ignoring any torn tail (the crash-recovery path)."""
        last = None
        for off, btype, payload in self._iter_valid_blocks():
            if btype == INDEX_BLOCK:
                last = (off, payload)
        return last

    def _read_block_at(self, offset: int) -> tuple:
        self.fh.seek(offset)
        header = self.fh.read(_BLOCK_HEADER.size)
        if len(header) < _BLOCK_HEADER.size:
            raise CorruptFile(f"{self.path}@{offset}: truncated header")
        length, crc, btype = _BLOCK_HEADER.unpack(header)
        if length < _BLOCK_HEADER.size:
            raise CorruptFile(f"{self.path}@{offset}: bad block length "
                              f"{length}")
        payload = self.fh.read(length - _BLOCK_HEADER.size)
        if len(payload) != length - _BLOCK_HEADER.size:
            raise CorruptFile(f"{self.path}@{offset}: truncated block")
        expect = _crc(_BLOCK_HEADER.pack(length, 0, btype), payload)
        if crc != expect:
            raise CorruptFile(f"{self.path}@{offset}: checksum mismatch")
        return btype, payload

    def _append_block(self, btype: int, payload: bytes) -> int:
        """Append a block; returns its offset."""
        assert self.writable
        self.fh.seek(0, os.SEEK_END)
        offset = self.fh.tell()
        length = _BLOCK_HEADER.size + len(payload)
        crc = _crc(_BLOCK_HEADER.pack(length, 0, btype), payload)
        self.fh.write(_BLOCK_HEADER.pack(length, crc, btype))
        self.fh.write(payload)
        return offset

    def _write_index(self):
        """Append a fresh index block and repoint the header at it."""
        payload = json.dumps({"root": self.index["root"],
                              "blocks": self.index["blocks"]}).encode()
        offset = self._append_block(INDEX_BLOCK, payload)
        # Make the appended blocks durable BEFORE the header points at
        # them, so a crash between the two writes leaves a pointer that
        # references only fully-written bytes.
        self.fh.flush()
        os.fsync(self.fh.fileno())
        self.fh.seek(len(MAGIC))
        self.fh.write(struct.pack("<Q", offset))
        self.fh.flush()
        os.fsync(self.fh.fileno())

    # -- block-level API -------------------------------------------------
    def write_data(self, value: Any, btype: int = DATA_BLOCK) -> int:
        """Append a data block; returns its logical id. The index is NOT
        saved until save() — call it to commit a save point."""
        bid = self.next_id
        self.next_id += 1
        offset = self._append_block(
            btype, json.dumps(value, default=str).encode())
        self.index["blocks"][bid] = offset
        return bid

    def read_block(self, bid: int) -> Any:
        offset = self.index["blocks"].get(int(bid))
        if offset is None:
            raise KeyError(f"no block {bid}")
        btype, payload = self._read_block_at(offset)
        value = json.loads(payload)
        if btype == CHUNKED_BLOCK:
            out: list = []
            for cid in value["chunks"]:
                out.extend(self.read_block(cid))
            return out
        if btype == PARTIAL_BLOCK:
            small = value["map"]
            rest = self.read_block(value["rest"]) if value.get("rest") \
                else {}
            return {**rest, **small}
        return value

    def resolve(self, value: Any) -> Any:
        """Recursively resolve block refs in a loaded value."""
        if is_block_ref(value):
            return self.resolve(self.read_block(value["__block_ref__"]))
        if isinstance(value, dict):
            return {k: self.resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [self.resolve(v) for v in value]
        return value

    def save(self, root_id: Optional[int] = None):
        """Commit a save point (new index + header pointer)."""
        if root_id is not None:
            self.index["root"] = root_id
        self._write_index()

    # -- test-level API (the reference's write-initial-test! etc.,
    #    format.clj:1112-1150) ------------------------------------------
    def write_initial_test(self, test: dict) -> int:
        """Save point 0: the test map, without history/results."""
        t = {k: v for k, v in test.items()
             if k not in ("history", "results")}
        root = self.write_data(t)
        self.save(root)
        return root

    def append_history_chunk(self, ops: list) -> int:
        """Append one chunk of history ops; returns the chunk block id.
        Incremental: a crash loses at most the last chunk."""
        return self.write_data(ops)

    def write_history(self, test: dict, chunk_ids: Optional[list] = None,
                      ops: Optional[list] = None) -> int:
        """Save point 1: test + history (as a chunked block)."""
        if chunk_ids is None:
            chunk_ids = [self.append_history_chunk(ops or [])]
        hist_id = self.write_data({"chunks": chunk_ids},
                                  btype=CHUNKED_BLOCK)
        t = {k: v for k, v in test.items()
             if k not in ("history", "results")}
        t["history"] = BlockRef(hist_id)
        root = self.write_data(t)
        self.save(root)
        return root

    def write_results(self, test: dict, results: dict) -> int:
        """Save point 2: test + history + results (partial map: valid?
        loads without the rest)."""
        root_val = self.read_block(self.index["root"]) \
            if self.index["root"] else {}
        rest = {k: v for k, v in results.items() if k != "valid?"}
        rest_id = self.write_data(rest)
        res_id = self.write_data({"map": {"valid?": results.get("valid?")},
                                  "rest": rest_id}, btype=PARTIAL_BLOCK)
        t = {k: v for k, v in root_val.items() if k != "results"}
        t["results"] = BlockRef(res_id)
        root = self.write_data(t)
        self.save(root)
        return root

    def read_test(self, lazy: bool = True) -> dict:
        """The current test map. With lazy=True, history/results stay as
        LazyRef objects until accessed (format.clj's LazyTest, :1187)."""
        if not self.index["root"]:
            return {}
        raw = self.read_block(self.index["root"])
        if not lazy:
            return self.resolve(raw)
        return LazyTest(self, raw)

    def read_valid(self) -> Any:
        """Just results.valid? — without loading history or the full
        results (the web UI's fast path)."""
        if not self.index["root"]:
            return None
        raw = self.read_block(self.index["root"])
        ref = raw.get("results")
        if not is_block_ref(ref):
            return (raw.get("results") or {}).get("valid?")
        offset = self.index["blocks"].get(int(ref["__block_ref__"]))
        btype, payload = self._read_block_at(offset)
        value = json.loads(payload)
        if btype == PARTIAL_BLOCK:
            return value["map"].get("valid?")
        return value.get("valid?")

    def gc(self) -> None:
        """Rewrite the file keeping only blocks reachable from the
        current root (format.clj:911-1008)."""
        assert self.writable
        test = self.read_test(lazy=False)
        tmp = self.path + ".gc"
        out = JepsenFile(tmp, "w")
        if test.get("history") is not None or test.get("results"):
            hist = test.pop("history", []) or []
            results = test.pop("results", None)
            chunk = out.append_history_chunk(hist)
            out.write_history(test, chunk_ids=[chunk])
            if results:
                out.write_results(test, results)
        else:
            out.write_initial_test(test)
        out.close()
        self.fh.close()
        os.replace(tmp, self.path)
        self.fh = open(self.path, "r+b")
        self._load()

    def close(self):
        self.fh.close()


class LazyTest(dict):
    """A test map whose history/results load from the file on first
    access (format.clj LazyTest :1187-1216)."""

    def __init__(self, jf: JepsenFile, raw: dict):
        self._jf = jf
        super().__init__(raw)

    def __getitem__(self, k):
        v = super().__getitem__(k)
        if is_block_ref(v):
            v = self._jf.resolve(v)
            super().__setitem__(k, v)
        return v

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default
