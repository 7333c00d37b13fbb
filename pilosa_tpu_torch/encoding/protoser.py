"""Protobuf serializer: framework result/request dicts ↔ wire messages.

Reference: encoding/proto/proto.go (Serializer — Marshal/Unmarshal of
QueryRequest/QueryResponse/Import* payloads). The framework's canonical
in-process result shapes are the JSON-able dicts produced by
``api.query`` (see server/api.py _result_json); this module maps those
to/from the ``pilosa.proto`` messages so HTTP clients can content-
negotiate ``application/x-protobuf`` exactly like the reference's
handler does.
"""

from __future__ import annotations

from typing import Any

from pilosa_tpu_torch.encoding import pilosa_pb2 as pb

CONTENT_TYPE = "application/x-protobuf"

# QueryResult.type tags (reference: QueryResult.Type codes)
T_NIL = 0
T_ROW = 1
T_COUNT = 2
T_PAIRS = 3
T_VAL_COUNT = 4
T_CHANGED = 5
T_ROW_IDS = 6
T_GROUP_COUNTS = 7

_ATTR_STRING = 1
_ATTR_INT = 2
_ATTR_BOOL = 3
_ATTR_FLOAT = 4


def attrs_to_proto(attrs: dict[str, Any]) -> list[pb.Attr]:
    out = []
    for k in sorted(attrs):
        v = attrs[k]
        a = pb.Attr(key=k)
        if isinstance(v, bool):
            a.type = _ATTR_BOOL
            a.bool_value = v
        elif isinstance(v, int):
            a.type = _ATTR_INT
            a.int_value = v
        elif isinstance(v, float):
            a.type = _ATTR_FLOAT
            a.float_value = v
        else:
            a.type = _ATTR_STRING
            a.string_value = str(v)
        out.append(a)
    return out


def attrs_from_proto(attrs) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for a in attrs:
        if a.type == _ATTR_BOOL:
            out[a.key] = a.bool_value
        elif a.type == _ATTR_INT:
            out[a.key] = a.int_value
        elif a.type == _ATTR_FLOAT:
            out[a.key] = a.float_value
        else:
            out[a.key] = a.string_value
    return out


# ---------------------------------------------------------------- results
def result_to_proto(r: Any) -> pb.QueryResult:
    """One result entry (a ``_result_json`` value) → QueryResult."""
    q = pb.QueryResult()
    if r is None:
        q.type = T_NIL
        return q
    if isinstance(r, bool):
        q.type = T_CHANGED
        q.changed = r
        return q
    if isinstance(r, int):
        q.type = T_COUNT
        q.n = r
        return q
    if isinstance(r, dict):
        if "columns" in r or ("keys" in r and "rows" not in r):
            q.type = T_ROW
            q.row.columns.extend(r.get("columns", []))
            q.row.keys.extend(r.get("keys", []))
            q.row.keyed = "keys" in r
            q.row.attrs.extend(attrs_to_proto(r.get("attrs", {})))
            return q
        if "value" in r and "count" in r:
            q.type = T_VAL_COUNT
            q.val_count.val = r["value"]
            q.val_count.count = r["count"]
            return q
        if "rows" in r:
            q.type = T_ROW_IDS
            q.row_identifiers.rows.extend(r["rows"])
            q.row_identifiers.keys.extend(r.get("keys", []))
            q.row_identifiers.keyed = "keys" in r
            return q
    if isinstance(r, list):
        if r and isinstance(r[0], dict) and "group" in r[0]:
            q.type = T_GROUP_COUNTS
            for g in r:
                gc = q.group_counts.add()
                gc.count = g["count"]
                if "sum" in g:
                    gc.sum = g["sum"]
                    gc.has_sum = True
                for e in g["group"]:
                    fr = gc.group.add()
                    fr.field = e["field"]
                    fr.row_id = e.get("rowID", 0)
                    if e.get("rowKey"):
                        fr.row_key = e["rowKey"]
            return q
        q.type = T_PAIRS
        for p in r:
            q.pairs.add(
                id=p.get("id", 0), key=p.get("key", ""), count=p["count"]
            )
        return q
    raise TypeError(f"cannot serialize result {r!r}")


def result_from_proto(q: pb.QueryResult) -> Any:
    if q.type == T_NIL:
        return None
    if q.type == T_CHANGED:
        return q.changed
    if q.type == T_COUNT:
        return q.n
    if q.type == T_ROW:
        out: dict[str, Any] = {}
        if q.row.keyed:
            out["keys"] = list(q.row.keys)
        else:
            out["columns"] = list(q.row.columns)
        if q.row.attrs:
            out["attrs"] = attrs_from_proto(q.row.attrs)
        return out
    if q.type == T_VAL_COUNT:
        return {"value": q.val_count.val, "count": q.val_count.count}
    if q.type == T_ROW_IDS:
        out = {"rows": list(q.row_identifiers.rows)}
        if q.row_identifiers.keyed:
            out["keys"] = list(q.row_identifiers.keys)
        return out
    if q.type == T_GROUP_COUNTS:
        groups = []
        for gc in q.group_counts:
            g: dict[str, Any] = {
                "group": [
                    {
                        "field": fr.field,
                        "rowID": fr.row_id,
                        **({"rowKey": fr.row_key} if fr.row_key else {}),
                    }
                    for fr in gc.group
                ],
                "count": gc.count,
            }
            if gc.has_sum:
                g["sum"] = gc.sum
            groups.append(g)
        return groups
    if q.type == T_PAIRS:
        return [
            {
                "id": p.id,
                **({"key": p.key} if p.key else {}),
                "count": p.count,
            }
            for p in q.pairs
        ]
    raise TypeError(f"unknown QueryResult type {q.type}")


def response_to_bytes(resp: dict) -> bytes:
    """api.query response dict → serialized QueryResponse."""
    m = pb.QueryResponse()
    if resp.get("error"):
        m.err = resp["error"]
    for r in resp.get("results", []):
        m.results.append(result_to_proto(r))
    for cas in resp.get("columnAttrs", []):
        c = m.column_attr_sets.add()
        c.id = cas.get("id", 0)
        if cas.get("key"):
            c.key = cas["key"]
        c.attrs.extend(attrs_to_proto(cas.get("attrs", {})))
    return m.SerializeToString()


def response_from_bytes(data: bytes) -> dict:
    m = pb.QueryResponse()
    m.ParseFromString(data)
    out: dict[str, Any] = {"results": [result_from_proto(r) for r in m.results]}
    if m.err:
        out["error"] = m.err
    if m.column_attr_sets:
        out["columnAttrs"] = [
            {
                "id": c.id,
                **({"key": c.key} if c.key else {}),
                "attrs": attrs_from_proto(c.attrs),
            }
            for c in m.column_attr_sets
        ]
    return out


def import_response_to_bytes(err: str = "") -> bytes:
    return pb.ImportResponse(err=err).SerializeToString()


def import_response_from_bytes(data: bytes) -> str:
    m = pb.ImportResponse()
    m.ParseFromString(data)
    return m.err


# ---------------------------------------------------------------- requests
def query_request_to_bytes(
    query: str, shards: list[int] | None = None, **opts
) -> bytes:
    m = pb.QueryRequest(query=query)
    if shards:
        m.shards.extend(shards)
    m.column_attrs = bool(opts.get("column_attrs"))
    m.remote = bool(opts.get("remote"))
    m.exclude_row_attrs = bool(opts.get("exclude_row_attrs"))
    m.exclude_columns = bool(opts.get("exclude_columns"))
    return m.SerializeToString()


def query_request_from_bytes(data: bytes) -> tuple[str, list[int] | None]:
    m = pb.QueryRequest()
    m.ParseFromString(data)
    return m.query, list(m.shards) or None


def import_request_to_bytes(payload: dict) -> bytes:
    m = pb.ImportRequest()
    m.index = payload.get("index", "")
    m.field = payload.get("field", "")
    m.shard = payload.get("shard", 0)
    m.row_ids.extend(payload.get("rowIDs", []))
    m.row_keys.extend(payload.get("rowKeys", []))
    m.column_ids.extend(payload.get("columnIDs", []))
    m.column_keys.extend(payload.get("columnKeys", []))
    m.timestamps.extend(int(t) for t in payload.get("timestamps", []))
    m.clear = bool(payload.get("clear"))
    return m.SerializeToString()


def import_request_from_bytes(data: bytes) -> dict:
    m = pb.ImportRequest()
    m.ParseFromString(data)
    out: dict[str, Any] = {}
    if m.row_ids:
        out["rowIDs"] = list(m.row_ids)
    if m.row_keys:
        out["rowKeys"] = list(m.row_keys)
    if m.column_ids:
        out["columnIDs"] = list(m.column_ids)
    if m.column_keys:
        out["columnKeys"] = list(m.column_keys)
    if m.timestamps:
        out["timestamps"] = list(m.timestamps)
    if m.clear:
        out["clear"] = True
    return out


def translate_keys_request_to_bytes(
    index: str, keys: list[str], field: str = "", create: bool = True
) -> bytes:
    return pb.TranslateKeysRequest(
        index=index, field=field, keys=keys, lookup_only=not create
    ).SerializeToString()


def translate_keys_request_from_bytes(data: bytes) -> dict:
    m = pb.TranslateKeysRequest()
    m.ParseFromString(data)
    return {
        "index": m.index,
        "field": m.field,
        "keys": list(m.keys),
        "create": not m.lookup_only,
    }


def translate_keys_response_to_bytes(ids: list[int | None]) -> bytes:
    """None (key not found on a lookup-only request) maps to 0 — IDs
    start at 1, so 0 is unambiguous."""
    return pb.TranslateKeysResponse(
        ids=[i or 0 for i in ids]
    ).SerializeToString()


def translate_keys_response_from_bytes(data: bytes) -> list[int]:
    m = pb.TranslateKeysResponse()
    m.ParseFromString(data)
    return list(m.ids)


def import_value_request_to_bytes(payload: dict) -> bytes:
    m = pb.ImportValueRequest()
    m.index = payload.get("index", "")
    m.field = payload.get("field", "")
    m.shard = payload.get("shard", 0)
    m.column_ids.extend(payload.get("columnIDs", []))
    m.column_keys.extend(payload.get("columnKeys", []))
    m.values.extend(payload.get("values", []))
    m.clear = bool(payload.get("clear"))
    return m.SerializeToString()


def import_roaring_request_to_bytes(data: bytes, view: str = "standard") -> bytes:
    return pb.ImportRoaringRequest(view=view, data=data).SerializeToString()


def import_roaring_request_from_bytes(body: bytes) -> tuple[bytes, str]:
    """Returns (data, view); view is "" when the envelope left it unset
    so the caller can fall back to the ?view= query parameter."""
    m = pb.ImportRoaringRequest()
    m.ParseFromString(body)
    return m.data, m.view


def import_value_request_from_bytes(data: bytes) -> dict:
    m = pb.ImportValueRequest()
    m.ParseFromString(data)
    out: dict[str, Any] = {}
    if m.column_ids:
        out["columnIDs"] = list(m.column_ids)
    if m.column_keys:
        out["columnKeys"] = list(m.column_keys)
    if m.values:
        out["values"] = list(m.values)
    if m.clear:
        out["clear"] = True
    return out
