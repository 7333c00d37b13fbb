"""Serving surfaces (reference: pilosa_tpu/server): the API façade, the
HTTP front end (the event-loop listener) and the Server runtime."""

from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.http import HTTPServer
from pilosa_tpu_torch.server.server import Server

__all__ = ["API", "HTTPServer", "Server"]
