"""Roaring bitmap interchange format (pilosa dialect + official read).

The port's copy of pilosa_tpu/core/roaring_io.py (numpy only). Roaring is
the interchange codec of the HTTP bulk paths: it decodes any roaring
file into sorted uint64 bit positions and encodes positions back into the
pilosa dialect, for

  - `POST /index/{i}/field/{f}/import-roaring/{shard}` bulk ingest,
  - `GET /index/{i}/field/{f}/export-roaring/{shard}`.

Format (pilosa dialect, all little-endian):
  bytes 0-1  magic 12348; byte 2 version (0); byte 3 flags
  bytes 4-7  u32 container count
  descriptive header, 12 B/container: u64 key, u16 type, u16 cardinality-1
  offset header, 4 B/container: u32 absolute file offset of container data
  container data: array = u16[n]; bitmap = u64[1024];
                  run = u16 run count, then (u16 start, u16 last) pairs
  anything after the last container is an op log (ignored here).

Official RoaringFormatSpec (read-only): cookie 12346 (no runs; offset table
present) or low16==12347 (count = hi16+1; is-run bitset; containers packed
sequentially, runs stored as (start, length)); u16 keys.

The reference decodes through a native C++ codec when it is built; this
numpy codec produces the same bytes and positions.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 12348
OFFICIAL_COOKIE = 12347
OFFICIAL_COOKIE_NORUN = 12346

TYPE_ARRAY = 1
TYPE_BITMAP = 2
TYPE_RUN = 3

ARRAY_MAX_SIZE = 4096  # reference: roaring/roaring.go:1940
HEADER_BASE_SIZE = 8
# Official spec: run-cookie files carry an offset header iff they have at
# least this many containers. (The Go reference ignores it and misparses
# such files — newOfficialRoaringIterator reads sequentially; we honor it.)
NO_OFFSET_THRESHOLD = 4

_U16 = np.dtype("<u2")
_U32 = np.dtype("<u4")
_U64 = np.dtype("<u8")


class RoaringError(ValueError):
    pass


def _expand_runs(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """[s0,s1..], [n0,n1..] -> concatenated aranges, vectorized."""
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.uint32)
    excl = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    base = np.repeat(starts.astype(np.int64) - excl, lengths)
    return (base + np.arange(total, dtype=np.int64)).astype(np.uint32)


def _bitmap_words_to_lows(words: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint32)


def _lows_to_bitmap_words(lows: np.ndarray) -> np.ndarray:
    bits = np.zeros(1 << 16, dtype=np.uint8)
    bits[lows] = 1
    return np.packbits(bits, bitorder="little").view(_U64)


def _runs_of(lows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted u16 lows -> (run starts, run lasts)."""
    if len(lows) == 0:
        return lows, lows
    brk = np.nonzero(np.diff(lows.astype(np.int64)) != 1)[0]
    starts = np.concatenate(([lows[0]], lows[brk + 1]))
    lasts = np.concatenate((lows[brk], [lows[-1]]))
    return starts, lasts


def decode(data: bytes) -> np.ndarray:
    """Any roaring file -> sorted uint64 bit positions (ignores op log)."""
    if len(data) < 8:
        raise RoaringError(f"buffer too small: {len(data)} bytes")
    cookie = struct.unpack_from("<I", data, 0)[0]
    if cookie & 0xFFFF == MAGIC:
        return _decode_pilosa(data)
    if cookie == OFFICIAL_COOKIE_NORUN or cookie & 0xFFFF == OFFICIAL_COOKIE:
        return _decode_official(data)
    raise RoaringError(f"unknown roaring cookie: {cookie & 0xFFFF}")


def _decode_pilosa(data: bytes) -> np.ndarray:
    version = data[2]
    if version != 0:
        raise RoaringError(f"unsupported roaring file version {version}")
    n_keys = struct.unpack_from("<I", data, 4)[0]
    if n_keys == 0:
        return np.empty(0, dtype=np.uint64)
    hdr_end = HEADER_BASE_SIZE + 12 * n_keys
    off_end = hdr_end + 4 * n_keys
    if off_end > len(data):
        raise RoaringError("descriptive/offset header overruns buffer")
    hdr = np.frombuffer(data, dtype=np.uint8, count=12 * n_keys, offset=HEADER_BASE_SIZE)
    keys = hdr.reshape(n_keys, 12)[:, 0:8].copy().view(_U64).reshape(n_keys)
    types = hdr.reshape(n_keys, 12)[:, 8:10].copy().view(_U16).reshape(n_keys)
    cards = hdr.reshape(n_keys, 12)[:, 10:12].copy().view(_U16).reshape(n_keys).astype(np.int64) + 1
    offsets = np.frombuffer(data, dtype=_U32, count=n_keys, offset=hdr_end).astype(np.int64)
    if len(np.unique(keys)) != n_keys or not np.all(np.diff(keys.astype(np.int64)) > 0):
        raise RoaringError("container keys not strictly increasing")
    out: List[np.ndarray] = []
    for i in range(n_keys):
        lows = _decode_container(
            data, int(types[i]), int(offsets[i]), int(cards[i]), runs_as_last=True
        )
        out.append((keys[i] << np.uint64(16)) | lows.astype(np.uint64))
    return np.concatenate(out) if out else np.empty(0, dtype=np.uint64)


def _decode_container(
    data: bytes, ctype: int, offset: int, card: int, runs_as_last: bool
) -> np.ndarray:
    if ctype == TYPE_ARRAY:
        end = offset + 2 * card
        if offset < 0 or end > len(data):
            raise RoaringError("array container overruns buffer")
        return np.frombuffer(data, dtype=_U16, count=card, offset=offset).astype(np.uint32)
    if ctype == TYPE_BITMAP:
        if offset < 0 or offset + 8192 > len(data):
            raise RoaringError("bitmap container overruns buffer")
        words = np.frombuffer(data, dtype=_U64, count=1024, offset=offset)
        return _bitmap_words_to_lows(words)
    if ctype == TYPE_RUN:
        if offset < 0 or offset + 2 > len(data):
            raise RoaringError("run container overruns buffer")
        n_runs = struct.unpack_from("<H", data, offset)[0]
        end = offset + 2 + 4 * n_runs
        if end > len(data):
            raise RoaringError("run container overruns buffer")
        pairs = np.frombuffer(data, dtype=_U16, count=2 * n_runs, offset=offset + 2)
        starts = pairs[0::2].astype(np.int64)
        seconds = pairs[1::2].astype(np.int64)
        lengths = (seconds - starts + 1) if runs_as_last else (seconds + 1)
        if np.any(lengths <= 0) or np.any(starts + lengths - 1 > 0xFFFF):
            raise RoaringError("invalid run bounds")
        return _expand_runs(starts, lengths)
    raise RoaringError(f"unknown container type {ctype}")


def _decode_official(data: bytes) -> np.ndarray:
    cookie = struct.unpack_from("<I", data, 0)[0]
    pos = 4
    if cookie == OFFICIAL_COOKIE_NORUN:
        n_keys = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        run_bitset = None
    else:
        n_keys = (cookie >> 16) + 1
        nbytes = (n_keys + 7) // 8
        run_bitset = np.unpackbits(
            np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=pos), bitorder="little"
        )
        pos += nbytes
    if n_keys == 0:
        return np.empty(0, dtype=np.uint64)
    if n_keys > (1 << 16):
        raise RoaringError("more than 2^16 containers")
    hdr = np.frombuffer(data, dtype=_U16, count=2 * n_keys, offset=pos)
    pos += 4 * n_keys
    keys = hdr[0::2].astype(np.uint64)
    if n_keys > 1 and not np.all(keys[1:] > keys[:-1]):
        # the decode() contract is sorted unique positions; the official
        # format requires strictly increasing container keys
        raise RoaringError("container keys not strictly increasing")
    cards = hdr[1::2].astype(np.int64) + 1
    offsets: Optional[np.ndarray] = None
    if run_bitset is None or n_keys >= NO_OFFSET_THRESHOLD:
        # offset table present: always for the no-run dialect, and for the
        # run dialect at >= NO_OFFSET_THRESHOLD containers (official spec)
        if pos + 4 * n_keys > len(data):
            raise RoaringError("offset table overruns buffer")
        offsets = np.frombuffer(data, dtype=_U32, count=n_keys, offset=pos).astype(np.int64)
        pos += 4 * n_keys
    out: List[np.ndarray] = []
    for i in range(n_keys):
        card = int(cards[i])
        if run_bitset is not None and run_bitset[i]:
            ctype = TYPE_RUN
        elif card <= ARRAY_MAX_SIZE:
            ctype = TYPE_ARRAY
        else:
            ctype = TYPE_BITMAP
        off = int(offsets[i]) if offsets is not None else pos
        lows = _decode_container(data, ctype, off, card, runs_as_last=False)
        if offsets is None:
            if ctype == TYPE_ARRAY:
                pos = off + 2 * card
            elif ctype == TYPE_BITMAP:
                pos = off + 8192
            else:
                n_runs = struct.unpack_from("<H", data, off)[0]
                pos = off + 2 + 4 * n_runs
        out.append((keys[i] << np.uint64(16)) | lows.astype(np.uint64))
    return np.concatenate(out) if out else np.empty(0, dtype=np.uint64)


def encode(positions: np.ndarray) -> bytes:
    """Sorted-or-not uint64 positions -> pilosa-dialect roaring bytes.

    Container encodings are picked by serialized size (the reference's
    optimize(), roaring/roaring.go:2334): run if strictly smallest, else
    array for cardinality <= 4096, else bitmap.
    """
    positions = np.asarray(positions, dtype=np.uint64)
    if len(positions) > 1 and not np.all(positions[1:] > positions[:-1]):
        positions = np.unique(positions)  # sorted unique input skips the sort
    keys_all = positions >> np.uint64(16)
    lows_all = (positions & np.uint64(0xFFFF)).astype(np.uint32)
    keys, key_starts, counts = np.unique(keys_all, return_index=True, return_counts=True)
    n_keys = len(keys)

    header = bytearray()
    header += struct.pack("<HBB", MAGIC, 0, 0)
    header += struct.pack("<I", n_keys)
    desc = bytearray()
    offs = bytearray()
    payloads: List[bytes] = []
    offset = HEADER_BASE_SIZE + 16 * n_keys
    for i in range(n_keys):
        lows = lows_all[key_starts[i] : key_starts[i] + counts[i]]
        n = len(lows)
        starts, lasts = _runs_of(lows)
        size_run = 2 + 4 * len(starts)
        size_array = 2 * n
        if size_run < min(size_array, 8192):
            ctype = TYPE_RUN
            pairs = np.empty(2 * len(starts), dtype=_U16)
            pairs[0::2] = starts.astype(_U16)
            pairs[1::2] = lasts.astype(_U16)
            payload = struct.pack("<H", len(starts)) + pairs.tobytes()
        elif n <= ARRAY_MAX_SIZE:
            ctype = TYPE_ARRAY
            payload = lows.astype(_U16).tobytes()
        else:
            ctype = TYPE_BITMAP
            payload = _lows_to_bitmap_words(lows).tobytes()
        desc += struct.pack("<QHH", int(keys[i]), ctype, n - 1)
        offs += struct.pack("<I", offset)
        payloads.append(payload)
        offset += len(payload)
    return bytes(header) + bytes(desc) + bytes(offs) + b"".join(payloads)


def inspect(data: bytes) -> dict:
    """Summary of a roaring file (for CLI inspect/check)."""
    cookie = struct.unpack_from("<I", data, 0)[0]
    dialect = (
        "pilosa"
        if cookie & 0xFFFF == MAGIC
        else "official"
        if cookie == OFFICIAL_COOKIE_NORUN or cookie & 0xFFFF == OFFICIAL_COOKIE
        else "unknown"
    )
    positions = decode(data)
    return {
        "dialect": dialect,
        "bit_count": int(len(positions)),
        "container_count": int(struct.unpack_from("<I", data, 4)[0])
        if dialect == "pilosa"
        else None,
        "max_position": int(positions[-1]) if len(positions) else None,
    }
