"""Minimal logger (reference: logger.go's Logger interface + the
server's log-path config): one sink, line-oriented, safe from
concurrent handler threads. stderr by default; a configured log-path
appends to a file the operator can rotate externally (reopen-on-HUP is
out of scope — upstream relied on external rotation too).
"""

from __future__ import annotations

import sys
import threading
import time

from pilosa_tpu_torch.utils import sanitize


class Logger:
    def __init__(self, path: str | None = None):
        self._lock = sanitize.make_lock("Logger._lock", loop_safe=True)
        self._file = open(path, "a") if path else None

    def log(self, msg: str) -> None:
        stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
        line = f"{stamp} [pilosa-tpu] {msg}\n"
        with self._lock:
            sink = self._file if self._file is not None else sys.stderr
            sink.write(line)
            sink.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
