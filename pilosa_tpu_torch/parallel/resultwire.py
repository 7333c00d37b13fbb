"""Typed query-result wire codec shared by the internal client and the
cluster coordinator (reference: internal QueryResponse protobuf — here
JSON control with raw packed-word blobs via encoding/frame.py, base64
fallback for external/older callers)."""

from __future__ import annotations

from typing import Any

from pilosa_tpu_torch.encoding import frame
from pilosa_tpu_torch.executor import RowResult
from pilosa_tpu_torch.parallel.client import decode_words_b64, encode_words_b64


def encode_result(r: Any, blobs: list[bytes] | None = None) -> dict:
    """Typed wire form of one query result. With ``blobs`` (framed
    internal transport — see encoding/frame.py), RowResult segments ride
    as raw packed-word binary referenced by blob index; without, they
    fall back to base64-in-JSON (kept for external/older callers)."""
    if isinstance(r, RowResult):
        if blobs is not None:
            segbin: dict[str, int] = {}
            for s, w in r.segments.items():
                segbin[str(s)] = len(blobs)
                blobs.append(frame.pack_u32(w))
            return {"type": "row", "segbin": segbin}
        return {
            "type": "row",
            "segments": {
                str(s): encode_words_b64(w) for s, w in r.segments.items()
            },
        }
    if isinstance(r, bool):
        return {"type": "bool", "value": r}
    if isinstance(r, int):
        return {"type": "count", "value": r}
    if isinstance(r, dict) and "value" in r and "count" in r:
        return {"type": "valCount", "value": r["value"], "count": r["count"]}
    if isinstance(r, dict) and "rows" in r:
        return {"type": "rowIDs", **r}
    if isinstance(r, list):
        if r and "group" in r[0]:
            return {"type": "groups", "groups": r}
        return {"type": "pairs", "pairs": r}
    if r is None:
        return {"type": "null"}
    raise TypeError(f"cannot encode result {r!r}")


def decode_result(d: dict, blobs: list | None = None) -> Any:
    t = d["type"]
    if t == "row":
        if "segbin" in d:
            return RowResult(
                {
                    int(s): frame.unpack_u32(blobs[i])
                    for s, i in d["segbin"].items()
                }
            )
        return RowResult({int(s): decode_words_b64(w) for s, w in d["segments"].items()})
    if t == "bool":
        return d["value"]
    if t == "count":
        return d["value"]
    if t == "valCount":
        return {"value": d["value"], "count": d["count"]}
    if t == "rowIDs":
        return {k: v for k, v in d.items() if k != "type"}
    if t == "groups":
        return d["groups"]
    if t == "pairs":
        return d["pairs"]
    if t == "null":
        return None
    raise TypeError(f"cannot decode result {d!r}")


