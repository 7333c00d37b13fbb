"""Serving surfaces (reference: pilosa_tpu/server). The API façade is
ported; the HTTP listener, event loop and Server follow."""

from pilosa_tpu_torch.server.api import API

__all__ = ["API"]
