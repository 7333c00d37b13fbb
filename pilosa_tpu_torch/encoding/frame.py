"""Framed binary envelope for the internal node↔node data plane.

Reference: internal/internal.proto + http/client.go (InternalClient) move
node↔node payloads as protobuf. This framework keeps JSON for CONTROL
(readable, schema-free) but moves the FAT arrays — query-result bitmap
segments, import column/row id vectors, anti-entropy block pairs — as raw
little-endian binary blobs referenced from the control header, so
multi-GB internal transfers pay zero base64 inflation and no
per-element JSON parse.

Layout (all little-endian):

    magic  b"PTF1"
    u32    header_len          (JSON control bytes)
    u32    n_blobs
    u64[n] blob lengths
    bytes  header JSON
    bytes  blob 0 | blob 1 | …

Control JSON references blobs by index (position in the blob table).
Receivers sniff the magic, so every framed route also accepts plain
JSON from external tools. Like the reference's protobuf internal plane,
SENDERS frame unconditionally: the node↔node wire assumes a
uniform-version cluster (mixed-version rolling upgrades are out of
scope, as they were for the JSON wire this replaces).
"""

from __future__ import annotations

import json
import struct

import numpy as np

MAGIC = b"PTF1"
CONTENT_TYPE = "application/x-pilosa-frame"


def is_frame(data: bytes) -> bool:
    return len(data) >= 4 and bytes(data[:4]) == MAGIC


def encode_frame(control: dict, blobs: list[bytes]) -> bytes:
    header = json.dumps(control).encode()
    parts = [
        MAGIC,
        struct.pack("<II", len(header), len(blobs)),
        struct.pack(f"<{len(blobs)}Q", *[len(b) for b in blobs]),
        header,
    ]
    parts.extend(bytes(b) for b in blobs)
    return b"".join(parts)


def decode_frame(data: bytes) -> tuple[dict, list[memoryview]]:
    mv = memoryview(data)
    if bytes(mv[:4]) != MAGIC:
        raise ValueError("not a pilosa frame")
    if len(mv) < 12:
        raise ValueError("truncated frame header")
    header_len, n_blobs = struct.unpack_from("<II", mv, 4)
    if len(mv) < 12 + 8 * n_blobs:
        raise ValueError("truncated frame blob table")
    lens = struct.unpack_from(f"<{n_blobs}Q", mv, 12)
    off = 12 + 8 * n_blobs
    # exact-length check: a truncated body must fail loudly, not yield
    # silently short blobs (an 8-byte-aligned shortfall would otherwise
    # decode to HALF the column ids with no error)
    if off + header_len + sum(lens) != len(mv):
        raise ValueError(
            f"frame length mismatch: declared "
            f"{off + header_len + sum(lens)}, got {len(mv)}"
        )
    control = json.loads(bytes(mv[off : off + header_len]))
    off += header_len
    blobs: list[memoryview] = []
    for length in lens:
        blobs.append(mv[off : off + length])
        off += length
    return control, blobs


def pack_u64(values) -> bytes:
    return np.asarray(values, dtype=np.uint64).tobytes()


def unpack_u64(blob) -> np.ndarray:
    # copy: frombuffer over a memoryview yields a read-only view into the
    # request buffer; downstream (fragment import, reduce) assumes owned,
    # writable arrays
    return np.frombuffer(blob, dtype=np.uint64).copy()


def pack_u32(values) -> bytes:
    return np.asarray(values, dtype=np.uint32).tobytes()


def unpack_u32(blob) -> np.ndarray:
    return np.frombuffer(blob, dtype=np.uint32).copy()
