"""Serving surfaces (reference: pilosa_tpu/server): the API façade, the
HTTP front ends (the event-loop listener and the threaded one), the
Server runtime and the multi-process supervisor.

The names load on first use, so that the supervisor's parent
(``server.supervisor``) imports neither torch nor the server runtime.
"""

__all__ = ["API", "HTTPServer", "Server"]


def __getattr__(name):
    if name == "API":
        from pilosa_tpu_torch.server.api import API

        return API
    if name == "HTTPServer":
        from pilosa_tpu_torch.server.http import HTTPServer

        return HTTPServer
    if name == "Server":
        from pilosa_tpu_torch.server.server import Server

        return Server
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
