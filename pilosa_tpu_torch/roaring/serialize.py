"""Roaring persistence: snapshot file format + append-only ops log.

Reference: roaring/roaring.go (WriteTo/UnmarshalBinary with the
pilosa-specific cookie, and the appended ops log: op / OpWriter).

Three snapshot layouts are readable; the upstream-pilosa layout is the
one written (wire interop with stock pilosa
clients' ``import-roaring`` payloads and fragment files). The pilosa
and legacy layouts start with the uint16 magic 12348 (next uint16: 0 =
upstream storageVersion, 1 = this framework's legacy layout); the
OFFICIAL 32-bit interchange layout (RoaringFormatSpec cookies
12346/12347, what stock CRoaring/RoaringBitmap clients emit) is also
accepted on read.

Upstream layout (little-endian; roaring.go WriteTo — reconstructed from
upstream v1.x knowledge, unverified against the fork because the
reference mount is empty, see SURVEY.md §0):
    cookie:   uint32 = 12348 | storageVersion(0) << 16
    count:    uint32 n_containers
    headers:  n × (uint64 key | uint16 type | uint16 cardinality-1)
              type: 1=array, 2=bitmap, 3=run
    offsets:  n × uint32 (byte offset of payload from buffer start)
    payloads: array: card×uint16; bitmap: 1024×uint64;
              run: uint16 n_runs, then n_runs×(uint16 start|uint16 last)

Legacy layout (version 1, still readable):
    header:   uint16 magic=12348 | uint16 version=1 | uint32 n_containers
    metadata: n × (uint64 key | uint16 type | uint16 pad | uint32 cardinality)
    offsets:  n × uint64
    payloads: as above except runs prefixed by uint32 n_runs

Ops log (framework-specific; appended after either snapshot, replayed on
load — upstream's op byte layout is version-dependent and unverifiable).
Two record framings are readable; v2 is what gets written:

    v1: uint8 magic=0xF1 | uint8 opcode | uint32 count | count × uint64
    v2: uint8 magic=0xF2 | uint8 opcode | uint32 count | uint32 crc32 |
        count × uint64 values

v2's crc32 covers the header-sans-crc AND the value payload, so reopen
distinguishes a torn tail (record runs past EOF — truncate, the write
never finished) from in-place corruption (full-length record, checksum
mismatch — report with offset, then truncate conservatively). opcode
1=add, 2=remove either way.

Opcode 3 (union, v2-only) is the bulk-ingest record: its body is a
whole serialized roaring frame (snapshot layout, optionally followed by
its own add/remove op records) that replay UNIONS into the bitmap.
``count`` holds the body's BYTE length for this opcode — the payload is
a container stream, not a u64 vector. One import-roaring post appends
one of these instead of rewriting the whole snapshot (docs/ingest.md).
"""

from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from pilosa_tpu_torch.roaring import containers as ct
from pilosa_tpu_torch.roaring.bitmap import Bitmap

MAGIC = 12348
STORAGE_VERSION = 0  # upstream pilosa storageVersion (written format)
VERSION = 1  # this framework's legacy layout (read-compat only)
# the OFFICIAL 32-bit roaring interchange format (RoaringFormatSpec);
# upstream pilosa's UnmarshalBinary accepts it on import, so import-
# roaring payloads produced by stock CRoaring/RoaringBitmap clients work
OFFICIAL_COOKIE = 12347  # run containers present (packed count, run bitset)
OFFICIAL_COOKIE_NO_RUNS = 12346  # no runs; separate uint32 count, offsets
_OFFICIAL_NO_OFFSET_THRESHOLD = 4
OP_MAGIC = 0xF1  # v1 record: no checksum (read-compat only)
OP_MAGIC2 = 0xF2  # v2 record: crc32-framed (what append_op writes)
OP_ADD = 1
OP_REMOVE = 2
OP_UNION = 3  # body = serialized roaring frame, count = byte length

_HEADER = struct.Struct("<HHI")
_META = struct.Struct("<QHHI")
_OP_HEADER = struct.Struct("<BBI")
_OP2_HEADER = struct.Struct("<BBII")  # magic, opcode, count, crc32
_PILOSA_HEADER = struct.Struct("<II")  # cookie, container count
_PILOSA_META = struct.Struct("<QHH")  # key, type, cardinality-1


def _payload_bytes(c: ct.Container) -> bytes:
    if c.type == ct.TYPE_RUN:
        return struct.pack("<H", c.data.shape[0]) + c.data.tobytes()
    return c.data.tobytes()


def serialize(bitmap: Bitmap, compact_in_place: bool = False) -> bytes:
    """Snapshot a Bitmap to bytes (no ops log) in the upstream-pilosa
    layout (roaring.go WriteTo). Containers are run-compacted on the way
    out — the write hot paths keep array/bitmap representations (run
    detection per mutation is pure overhead), and snapshot time is where
    the reference applies its Optimize pass too.

    ``compact_in_place=True`` also writes the compacted containers back
    into the bitmap (amortizes re-analysis across snapshots, shrinks
    resident memory) — ONLY safe when the caller holds the owning
    fragment's lock: an unlocked write-back could clobber a concurrent
    import's container and silently drop its bits. Unlocked callers
    (e.g. the anti-entropy /fragment/data handler) keep the default
    read-only behavior."""
    keys = sorted(bitmap._containers)
    # run containers are already compacted; everything else gets the
    # Optimize pass — batched, one vectorized analysis for the whole
    # bitmap instead of a numpy micro-call chain per container
    compacted = ct.batch_optimize([bitmap._containers[k] for k in keys])
    payloads = []
    counts = np.empty(len(keys), dtype=np.int64)
    for i, c in enumerate(compacted):
        if compact_in_place and c is not bitmap._containers[keys[i]]:
            bitmap._containers[keys[i]] = c
        payloads.append(_payload_bytes(c))
        counts[i] = ct.container_count(c)
    # meta + offset blocks as two vectorized tobytes, not a struct.pack
    # and BytesIO.write per container (<QHH> packs to 12 bytes unpadded,
    # matching the numpy packed struct dtype)
    meta = np.empty(
        len(keys), dtype=[("key", "<u8"), ("type", "<u2"), ("n", "<u2")]
    )
    meta["key"] = keys
    meta["type"] = [c.type for c in compacted]
    meta["n"] = counts - 1
    if counts.size and counts.min() <= 0:
        # an empty container would wrap n-1 through <u2 and corrupt the
        # stream on read-back; the container layer never stores empties
        raise ValueError("cannot serialize an empty container")
    lengths = np.fromiter((len(p) for p in payloads), np.int64, len(payloads))
    first = _PILOSA_HEADER.size + len(keys) * (_PILOSA_META.size + 4)
    offsets = first + np.concatenate(([0], np.cumsum(lengths)))[: len(payloads)]
    if offsets.size and int(offsets[-1]) + int(lengths[-1]) > 0xFFFFFFFF:
        # the <u4 cast below would silently wrap where struct.pack("<I")
        # raised — keep the loud failure for >4 GiB snapshots
        raise ValueError("serialized bitmap exceeds the 4 GiB offset space")
    return b"".join(
        [
            _PILOSA_HEADER.pack(MAGIC | (STORAGE_VERSION << 16), len(keys)),
            meta.tobytes(),
            offsets.astype("<u4").tobytes(),
            *payloads,
        ]
    )


def serialize_official(bitmap: Bitmap) -> bytes:
    """Serialize to the OFFICIAL 32-bit roaring interchange layout
    (RoaringFormatSpec, cookies 12346/12347) — the format stock
    CRoaring/RoaringBitmap clients parse. Only the low 2^32 positions
    are representable (container keys ≤ 0xFFFF, the 32-bit space's high
    half); higher keys raise ValueError.

    Containers are run-compacted on the way out like serialize(); run
    payloads are written as (start, length-1) pairs per the spec (the
    internal form is (start, last))."""
    keys = sorted(bitmap._containers)
    if keys and keys[-1] > 0xFFFF:
        raise ValueError(
            f"official roaring format is 32-bit: container key {keys[-1]} "
            "exceeds 0xFFFF (value ≥ 2^32)"
        )
    conts = list(
        zip(keys, ct.batch_optimize([bitmap._containers[k] for k in keys]))
    )
    n = len(conts)
    has_runs = any(c.type == ct.TYPE_RUN for _k, c in conts)
    buf = io.BytesIO()
    if has_runs:
        buf.write(struct.pack("<I", OFFICIAL_COOKIE | ((n - 1) << 16)))
        run_bitset = bytearray((n + 7) // 8)
        for i, (_k, c) in enumerate(conts):
            if c.type == ct.TYPE_RUN:
                run_bitset[i >> 3] |= 1 << (i & 7)
        buf.write(bytes(run_bitset))
        has_offsets = n >= _OFFICIAL_NO_OFFSET_THRESHOLD
    else:
        buf.write(struct.pack("<II", OFFICIAL_COOKIE_NO_RUNS, n))
        has_offsets = True
    payloads = []
    for _key, c in conts:
        if c.type == ct.TYPE_RUN:
            lengths = (c.data[:, 1] - c.data[:, 0]).astype(np.uint16)
            pairs = np.stack([c.data[:, 0], lengths], axis=1).astype("<u2")
            payloads.append(
                struct.pack("<H", c.data.shape[0]) + pairs.tobytes()
            )
        else:
            payloads.append(c.data.astype(c.data.dtype.newbyteorder("<")).tobytes())
    for (key, c), payload in zip(conts, payloads):
        buf.write(struct.pack("<HH", key, ct.container_count(c) - 1))
    if has_offsets:
        offset = buf.tell() + 4 * n
        for payload in payloads:
            buf.write(struct.pack("<I", offset))
            offset += len(payload)
    for payload in payloads:
        buf.write(payload)
    return buf.getvalue()


def deserialize(data: bytes) -> tuple[Bitmap, int]:
    """Parse a snapshot; returns (bitmap, bytes consumed by the snapshot).

    Dispatches on the leading cookie: official RoaringFormatSpec
    layouts (12346/12347), then the shared magic 12348's version word —
    upstream pilosa layout (storageVersion 0) or this framework's
    legacy layout (version 1). Any bytes after the snapshot are ops-log
    records; use ``replay_ops`` on the remainder.
    """
    try:
        magic, version, _n = _HEADER.unpack_from(data, 0)
        if magic in (OFFICIAL_COOKIE, OFFICIAL_COOKIE_NO_RUNS):
            return _deserialize_official(data)
        if magic != MAGIC:
            raise ValueError(f"bad roaring magic {magic}")
        if version == STORAGE_VERSION:
            return _deserialize_pilosa(data)
        if version == VERSION:
            return _deserialize_legacy(data)
        raise ValueError(f"unsupported roaring version {version}")
    except (struct.error, IndexError) as e:
        raise ValueError(f"truncated roaring snapshot: {e}") from e


_PILOSA_META_DT = np.dtype(
    [("key", "<u8"), ("type", "<u2"), ("card", "<u2")]
)


def _deserialize_pilosa(data: bytes) -> tuple[Bitmap, int]:
    """Vectorized snapshot parse: the whole meta and offset tables come
    out of two frombuffer calls, and container payloads are ZERO-COPY
    views into the (immutable bytes) buffer — payload immutability is
    the codebase-wide container discipline, so sharing is safe and the
    old per-container .copy() was pure overhead. At import-heavy scale
    (~64k containers per 5M-bit batch) per-container struct.unpack and
    copies dominated the roaring fast path."""
    _cookie, n = _PILOSA_HEADER.unpack_from(data, 0)
    b = Bitmap()
    meta_off = _PILOSA_HEADER.size
    metas = np.frombuffer(data, _PILOSA_META_DT, n, meta_off)
    off_base = meta_off + n * _PILOSA_META.size
    offsets = np.frombuffer(data, "<u4", n, off_base)
    end = off_base + 4 * n
    if n and (metas["type"] == ct.TYPE_ARRAY).all():
        # homogeneous all-array snapshot (the bulk-import norm): one u16
        # view over the whole buffer + a dict comprehension of slices —
        # no per-container frombuffer or branch
        u16 = np.frombuffer(data, np.uint16, len(data) // 2)
        starts = (offsets >> 1).astype(np.int64)
        ends = starts + metas["card"].astype(np.int64) + 1
        if int(ends.max()) * 2 > len(data):
            # numpy slices truncate silently — surface short payloads as
            # the same error the per-container frombuffer path raises
            raise ValueError("truncated roaring snapshot: payload out of range")
        mk, t_arr = ct.Container, ct.TYPE_ARRAY
        b._containers = {
            k: mk(t_arr, u16[s:e])
            for k, s, e in zip(
                metas["key"].tolist(), starts.tolist(), ends.tolist()
            )
        }
        end = max(end, int(ends.max()) * 2)
        return b, end
    keys = metas["key"].tolist()
    types = metas["type"].tolist()
    cards = metas["card"].tolist()
    offs = offsets.tolist()
    containers = b._containers
    mk, t_arr, t_bmp = ct.Container, ct.TYPE_ARRAY, ct.TYPE_BITMAP
    bitmap_n = ct.BITMAP_N
    for key, ctype, card_m1, off in zip(keys, types, cards, offs):
        if ctype == t_arr:
            card = card_m1 + 1
            c = mk(t_arr, np.frombuffer(data, np.uint16, card, off))
            size = card * 2
        elif ctype == t_bmp:
            c = mk(t_bmp, np.frombuffer(data, np.uint64, bitmap_n, off))
            size = bitmap_n * 8
        elif ctype == ct.TYPE_RUN:
            (n_runs,) = struct.unpack_from("<H", data, off)
            size = 2 + n_runs * 4
            c = ct.run_container(
                np.frombuffer(data, np.uint16, n_runs * 2, off + 2).reshape(-1, 2)
            )
        else:
            raise ValueError(f"bad container type {ctype}")
        containers[key] = c
        last_end = off + size
        if last_end > end:
            end = last_end
    return b, end


def _deserialize_official(data: bytes) -> tuple[Bitmap, int]:
    """Official 32-bit roaring layout (RoaringFormatSpec). Keys are
    uint16 (the 32-bit value space's high half), mapping directly onto
    this Bitmap's low 2^32 positions. Run intervals are (start,
    length-1) pairs — converted to the internal (start, last) form."""
    (cookie16,) = struct.unpack_from("<H", data, 0)
    pos = 0
    if cookie16 == OFFICIAL_COOKIE:
        (packed,) = struct.unpack_from("<I", data, 0)
        n = (packed >> 16) + 1
        pos = 4
        bitset_len = (n + 7) // 8
        run_bitset = data[pos : pos + bitset_len]
        pos += bitset_len
        has_offsets = n >= _OFFICIAL_NO_OFFSET_THRESHOLD
    else:  # OFFICIAL_COOKIE_NO_RUNS
        (n,) = struct.unpack_from("<I", data, 4)
        pos = 8
        run_bitset = b""
        has_offsets = True

    def _is_run(i: int) -> bool:
        return bool(run_bitset and (run_bitset[i >> 3] >> (i & 7)) & 1)

    metas = []
    for i in range(n):
        key, card_m1 = struct.unpack_from("<HH", data, pos + 4 * i)
        metas.append((key, card_m1 + 1))
    pos += 4 * n
    if has_offsets:
        pos += 4 * n  # offsets are redundant for sequential parsing
    b = Bitmap()
    for i, (key, card) in enumerate(metas):
        if _is_run(i):
            (n_runs,) = struct.unpack_from("<H", data, pos)
            pos += 2
            pairs = np.frombuffer(data, np.uint16, n_runs * 2, pos).reshape(-1, 2)
            pos += n_runs * 4
            # widen before adding: a corrupt pair must raise, not wrap
            last = pairs[:, 0].astype(np.int64) + pairs[:, 1].astype(np.int64)
            if (last > 0xFFFF).any():
                raise ValueError("official roaring run exceeds container bounds")
            runs = np.stack([pairs[:, 0].astype(np.int64), last], axis=1).astype(
                np.uint16
            )
            c = ct.run_container(runs)
        elif card > ct.ARRAY_MAX:
            c = ct.bitmap_container(
                np.frombuffer(data, np.uint64, ct.BITMAP_N, pos)
            )
            pos += ct.BITMAP_N * 8
        else:
            c = ct.array_container(np.frombuffer(data, np.uint16, card, pos))
            pos += card * 2
        b._containers[key] = ct.Container(c.type, c.data.copy())
    return b, pos


def _deserialize_legacy(data: bytes) -> tuple[Bitmap, int]:
    _magic, _version, n = _HEADER.unpack_from(data, 0)
    b = Bitmap()
    meta_off = _HEADER.size
    metas = []
    for i in range(n):
        key, ctype, _pad, card = _META.unpack_from(data, meta_off + i * _META.size)
        metas.append((key, ctype, card))
    off_base = meta_off + n * _META.size
    offsets = [
        struct.unpack_from("<Q", data, off_base + 8 * i)[0] for i in range(n)
    ]
    end = _HEADER.size + n * (_META.size + 8)
    for (key, ctype, card), off in zip(metas, offsets):
        if ctype == ct.TYPE_ARRAY:
            size = card * 2
            c = ct.array_container(np.frombuffer(data, np.uint16, card, off))
        elif ctype == ct.TYPE_BITMAP:
            size = ct.BITMAP_N * 8
            c = ct.bitmap_container(np.frombuffer(data, np.uint64, ct.BITMAP_N, off))
        elif ctype == ct.TYPE_RUN:
            (n_runs,) = struct.unpack_from("<I", data, off)
            size = 4 + n_runs * 4
            c = ct.run_container(
                np.frombuffer(data, np.uint16, n_runs * 2, off + 4).reshape(-1, 2)
            )
        else:
            raise ValueError(f"bad container type {ctype}")
        # copy payloads out of the input buffer so containers stay mutable
        c = ct.Container(c.type, c.data.copy())
        b._containers[key] = c
        end = max(end, off + size)
    return b, end


def append_op(opcode: int, values: np.ndarray) -> bytes:
    """Encode one ops-log record (v2, crc32-framed) for appending to a
    fragment file."""
    values = np.asarray(values, dtype=np.uint64)
    body = values.tobytes()
    crc = zlib.crc32(body, zlib.crc32(
        _OP_HEADER.pack(OP_MAGIC2, opcode, values.size)
    ))
    return _OP2_HEADER.pack(OP_MAGIC2, opcode, values.size, crc) + body


def append_union_op(frame: bytes) -> bytes:
    """Encode one UNION ops-log record (v2, crc32-framed): the body is a
    whole serialized roaring frame adopted wholesale on replay. This is
    the bulk-ingest record — one compressed frame per import post
    instead of a full snapshot rewrite (8 bytes/bit for OP_ADD vs the
    container stream's packed words/runs)."""
    crc = zlib.crc32(frame, zlib.crc32(
        _OP_HEADER.pack(OP_MAGIC2, OP_UNION, len(frame))
    ))
    return _OP2_HEADER.pack(OP_MAGIC2, OP_UNION, len(frame), crc) + frame


@dataclass
class ReplayResult:
    """Outcome of a checked ops-log replay.

    ``good_bytes`` is the prefix length that replayed cleanly — reopen
    truncates the on-disk log to it so a torn/corrupt tail can never
    weld onto the next append. ``corrupt`` is set ONLY for a checksum
    mismatch on a full-length record (in-place corruption, e.g. a
    bit-flip); a record that simply runs past EOF is a torn write and
    reports clean truncation with no error."""

    n_ops: int
    good_bytes: int
    corrupt: bool = False
    corrupt_offset: int = -1


def replay_ops_checked(bitmap: Bitmap, data: bytes) -> ReplayResult:
    """Apply ops-log records to ``bitmap`` with v2 checksum
    verification; v1 records replay without one (legacy files). Stops at
    the first torn, corrupt, or unrecognizable record — everything
    after a bad record is untrusted (its framing may itself be
    damaged), so recovery is conservative: replay the clean prefix,
    truncate the rest."""
    pos, n_ops = 0, 0
    n = len(data)
    while pos + _OP_HEADER.size <= n:
        magic = data[pos]
        if magic == OP_MAGIC2:
            if pos + _OP2_HEADER.size > n:
                break  # torn mid-header
            _m, opcode, count, crc = _OP2_HEADER.unpack_from(data, pos)
            body_start = pos + _OP2_HEADER.size
            # UNION bodies are a serialized roaring frame: count is the
            # byte length, not a u64 vector size
            body_len = count if opcode == OP_UNION else count * 8
            body_end = body_start + body_len
            if body_end > n:
                break  # torn write
            body = data[body_start:body_end]
            want = zlib.crc32(body, zlib.crc32(
                _OP_HEADER.pack(OP_MAGIC2, opcode, count)
            ))
            if want != crc:
                return ReplayResult(n_ops, pos, corrupt=True, corrupt_offset=pos)
        elif magic == OP_MAGIC:
            _m, opcode, count = _OP_HEADER.unpack_from(data, pos)
            body_start = pos + _OP_HEADER.size
            body_end = body_start + count * 8
            if body_end > n:
                break  # torn write
        else:
            break  # unrecognized tail byte: treat as torn
        if opcode == OP_ADD:
            bitmap.add_many(np.frombuffer(data, np.uint64, count, body_start))
        elif opcode == OP_REMOVE:
            bitmap.remove_many(np.frombuffer(data, np.uint64, count, body_start))
        elif opcode == OP_UNION and magic == OP_MAGIC2:
            # checksum already verified above: a malformed frame here is
            # in-place corruption the crc missed only if the writer
            # framed garbage — surface it as corruption, not a crash
            try:
                inc, c2 = deserialize(data[body_start:body_end])
                replay_ops(inc, data[body_start + c2 : body_end])
            except ValueError:
                return ReplayResult(n_ops, pos, corrupt=True, corrupt_offset=pos)
            bitmap.union_in_place(inc)
        else:
            break
        pos = body_end
        n_ops += 1
    return ReplayResult(n_ops, pos)


def replay_ops(bitmap: Bitmap, data: bytes) -> int:
    """Apply ops-log records to ``bitmap``; returns number of ops replayed.

    Truncated trailing records (torn writes) are ignored, matching the
    reference's crash-tolerant ops-log replay. Callers that must REPAIR
    the file (the fragment reopen path) use ``replay_ops_checked``
    instead, which also reports how many bytes replayed cleanly and
    whether a checksum caught in-place corruption."""
    return replay_ops_checked(bitmap, data).n_ops
