"""The closed-loop clients: one process of their own that imports only
the standard library, so the server's interpreter lock is not shared
with the load, and one thread a client.

    python3 -I -S portbench/loadgen.py

It reads one JSON line from stdin: ``{"port", "path", "timeout",
"clients": [{"warm": [pql], "queries": [pql], "keep": [position]}...]}``.
Each client opens one keep-alive connection and sends its warm-up
queries; then the process prints ``{"ready": true}`` and waits for a
second line ``{"end": t}`` (a ``time.monotonic()`` instant, which every
process of the machine shares). Each client then sends its queries in
order, each after the last answer, until ``t``. The process prints one
JSON line: ``{"clients": [{"records": [[position, t_sent, t_parsed,
status]...], "bodies": {position: results}, "warm_failed": n}...]}``,
``status`` 0 where no answer came. Latency runs from the request being
written to its JSON being parsed.
"""

import http.client
import json
import sys
import threading
import time


def send(conn, path: str, pql: str):
    """(status, parsed JSON or None, the connection to use next)."""
    try:
        conn.request("POST", path, body=pql.encode())
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, json.loads(body), conn
    except (OSError, http.client.HTTPException, ValueError):
        conn.close()
        return 0, None, http.client.HTTPConnection(conn.host, conn.port, timeout=conn.timeout)


class Client:
    def __init__(self, job: dict, spec: dict):
        self.path = job["path"]
        self.conn = http.client.HTTPConnection("127.0.0.1", int(job["port"]), timeout=float(job["timeout"]))
        self.spec = spec
        self.out = {"records": [], "bodies": {}, "warm_failed": 0}

    def warm(self) -> None:
        for pql in self.spec["warm"]:
            status, _, self.conn = send(self.conn, self.path, pql)
            self.out["warm_failed"] += status != 200

    def run(self, end: float) -> None:
        queries, keep = self.spec["queries"], set(self.spec["keep"])
        records, bodies = self.out["records"], self.out["bodies"]
        i = 0
        while True:
            t0 = time.monotonic()
            if t0 >= end:
                break
            status, out, self.conn = send(self.conn, self.path, queries[i % len(queries)])
            t1 = time.monotonic()
            records.append([i, t0, t1, status])
            if i in keep and status == 200:
                bodies[i] = out.get("results")
            i += 1
        self.conn.close()


def together(clients: list, method: str, *args) -> None:
    threads = [threading.Thread(target=getattr(c, method), args=args) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def main() -> None:
    job = json.loads(sys.stdin.readline())
    clients = [Client(job, spec) for spec in job["clients"]]
    together(clients, "warm")
    sys.stdout.write(json.dumps({"ready": True}) + "\n")
    sys.stdout.flush()
    end = float(json.loads(sys.stdin.readline())["end"])
    together(clients, "run", end)
    sys.stdout.write(json.dumps({"clients": [c.out for c in clients]}) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
