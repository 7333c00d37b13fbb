"""Wire serialization (reference: internal/internal.proto +
encoding/proto/proto.go).

``AVAILABLE`` is False when the google.protobuf runtime is missing; the
HTTP layer then serves JSON only (the reference requires protobuf
unconditionally; here it is an optional content type).
"""

from __future__ import annotations

try:
    from google.protobuf.message import DecodeError  # noqa: F401

    from pilosa_tpu_torch.encoding import protoser  # noqa: F401
    from pilosa_tpu_torch.encoding.protoser import CONTENT_TYPE  # noqa: F401

    AVAILABLE = True
except ImportError:  # pragma: no cover - protobuf is baked into the image
    protoser = None  # type: ignore[assignment]
    CONTENT_TYPE = "application/x-protobuf"
    AVAILABLE = False

    class DecodeError(Exception):  # type: ignore[no-redef]
        pass
