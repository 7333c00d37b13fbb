"""Multi-process serving supervisor (docs/multiprocess.md).

Reference: pilosa_tpu/server/supervisor.py. One process serving on one
interpreter is bound by its GIL and worker pool past a few dozen
concurrent clients — more threads cannot help, because the binding
resources are per-interpreter.  This module treats one box like a
cluster instead: ``pilosa_tpu_torch server --processes N`` runs the
parent as a SUPERVISOR that spawns N child server processes, each a full event-
loop front end owning a disjoint shard subset through the ordinary
cluster membership (seeds over localhost, child 0 coordinator, the
configured replica-n).  Fragments are on-disk snapshots + WAL, so
ownership is purely a config statement — no storage rewrite.

Public-port sharing, two modes:

- **reuseport** — every child additionally binds the public host:port
  with ``SO_REUSEPORT`` once its cluster join completes (readiness
  gating: the kernel only balances new connections across sockets that
  exist, so a child that cannot serve its shard subset yet is simply
  not in the group).  The kernel load-balances accepts; no parent hop
  on the data path.
- **fd-pass** — where ``SO_REUSEPORT`` is missing/broken (the boot
  probe decides, loudly), the parent binds the public port, accepts,
  and ships each connected fd to a ready child over a per-child unix
  socket via ``SCM_RIGHTS``; the child adopts the fd into its event
  loop (server/eventloop.py ``add_fd_listener``).

The supervisor monitors children — restart-on-crash with capped
exponential backoff, graceful SIGTERM drain — and maintains a fleet-
state JSON (listener mode, pids, restart counts) that children read to
serve the stitched ``GET /debug/processes`` view.  The parent process
deliberately imports neither torch nor the server runtime: it is a
lifecycle manager, not a query engine, and a CUDA context in it would
hold memory on the card for nothing.

Every child runs ``python -m pilosa_tpu_torch server`` on the parent's
``--device``: on a card, all N children share it, each with its own
CUDA context and probe, and each takes 1/N of the card's default stack
budget (it counts the fleet in the state file; server/server.py).

Topology note: per-process shard ownership over localhost is the same
shape as per-host ownership across machines — this supervisor doubles
as the single-box rehearsal of that deployment (docs/multiprocess.md
§multi-host).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

from pilosa_tpu_torch.utils import durable
from pilosa_tpu_torch.utils.config import Config
from pilosa_tpu_torch.utils.log import Logger

# listen backlog for the fd-pass parent's public socket — same sizing
# rationale as the event loop's (eventloop.py LISTEN_BACKLOG)
_BACKLOG = 1024
# a child alive this long resets its consecutive-crash streak: distinct
# crashes minutes apart should each pay the BASE backoff, not climb
HEALTHY_RESET_S = 30.0
# last-resort 503 the fd-pass parent answers when no child is ready
_NO_CHILD_503 = (
    b"HTTP/1.1 503 Service Unavailable\r\n"
    b"Content-Type: application/json\r\n"
    b"Retry-After: 1\r\n"
    b"Content-Length: 35\r\n"
    b"Connection: close\r\n\r\n"
    b'{"error": "no serving child ready"}'
)


def probe_so_reuseport(host: str = "127.0.0.1") -> bool:
    """Can two live sockets share one (host, port) via SO_REUSEPORT?

    Binding a second socket to the first's port is the real capability
    — the constant existing is not enough (some kernels/filesystems
    expose it and still refuse the second bind), so probe by doing."""
    if not hasattr(socket, "SO_REUSEPORT"):
        return False
    s1 = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s2 = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s1.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s1.bind((host, 0))
        port = s1.getsockname()[1]
        s2.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s2.bind((host, port))
        return True
    except OSError:
        return False
    finally:
        s1.close()
        s2.close()


def restart_backoff(consecutive: int, base_s: float, max_s: float) -> float:
    """Seconds to wait before the Nth consecutive respawn (N >= 1):
    capped exponential — base, 2·base, 4·base, ... up to max."""
    if consecutive <= 0:
        return 0.0
    return min(max_s, base_s * (2.0 ** (consecutive - 1)))


class _Child:
    """One supervised serving process: its immutable spec (index,
    internal bind, data dir, env) plus live lifecycle state."""

    def __init__(self, index: int, bind: str, data_dir: str, env: dict):
        self.index = index
        self.bind = bind  # internal 127.0.0.1:port (cluster plane)
        self.data_dir = data_dir
        self.env = env
        self.proc: subprocess.Popen | None = None
        self.ready = False
        self.restarts = 0
        self.consecutive = 0  # crash streak (reset after HEALTHY_RESET_S)
        self.spawned_at = 0.0
        self.restart_at = 0.0  # monotonic respawn-not-before
        self.last_exit: int | None = None
        self.fd_sock: socket.socket | None = None  # fd-pass control conn

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None


class Supervisor:
    """Parent of a ``serving-processes = N`` fleet: spawn, watch,
    restart, drain.  Construct with the PARENT's effective config (its
    ``bind`` is the shared public address); ``config_path`` is passed
    through to children so file-level knobs apply fleet-wide, with the
    supervisor's per-child env overrides (env beats file) layered on."""

    def __init__(self, config: Config, config_path: str | None = None,
                 argv_overrides: dict | None = None, device: str = "cuda"):
        if config.serving_processes < 1:
            raise ValueError("serving-processes must be >= 1")
        self.config = config
        # every child's --device (the port's servers take no config key
        # for it): the whole fleet shares this one device
        self.device = device
        self.config_path = config_path
        # CLI overrides that must reach children as env (CLI argv wins
        # over env in the child, so only pass-through keys belong here)
        self.argv_overrides = dict(argv_overrides or {})
        self.n = config.serving_processes
        self.logger = Logger(
            os.path.expanduser(config.log_path) if config.log_path else None
        )
        self.root = os.path.expanduser(config.data_dir)
        self.state_path = os.path.join(self.root, "supervisor.json")
        self.mode = ""  # "reuseport" | "fd-pass", decided in start()
        self.children: list[_Child] = []
        self.public_sock: socket.socket | None = None  # fd-pass only
        self._accept_thread: threading.Thread | None = None
        self._monitor_thread: threading.Thread | None = None
        self._stopping = threading.Event()
        self._rr = 0  # fd-pass round-robin cursor
        self._state_lock = threading.Lock()

    # ------------------------------------------------------------- planning
    def plan(self) -> list[_Child]:
        """Build the child specs once: stable internal ports (reused
        across restarts so peers' seed lists stay true), per-child data
        dirs under the fleet root, and the env override layer."""
        host = self.config.host
        ports = self._free_ports(host, self.n)
        binds = [f"{host}:{p}" for p in ports]
        scheme = self.config.scheme
        seeds = ",".join(f"{scheme}://{b}" for b in binds)
        children = []
        for i in range(self.n):
            env = dict(os.environ)
            env.update(
                {
                    # never recurse: a child is always a solo server
                    "PILOSA_TPU_SERVING_PROCESSES": "1",
                    # no PILOSA_TPU_NAME override: a node's id must be
                    # derived from its bind, the same way PEERS derive
                    # it from the seed list — shard ownership hashes
                    # node ids, so a vanity name here would give every
                    # member a DIFFERENT ownership map (each sees
                    # itself as "procN" but its peers as host:port)
                    "PILOSA_TPU_SEEDS": seeds,
                    "PILOSA_TPU_COORDINATOR": "1" if i == 0 else "0",
                    "PILOSA_TPU_REPLICA_N": str(self.config.replica_n),
                    "PILOSA_TPU_SUPERVISOR_STATE": self.state_path,
                }
            )
            for key, value in self.argv_overrides.items():
                env["PILOSA_TPU_" + key.upper()] = str(value)
            if self.mode == "reuseport":
                env["PILOSA_TPU_SHARED_BIND"] = self.config.bind
            else:
                env["PILOSA_TPU_FD_PASS_SOCKET"] = os.path.join(
                    self.root, f"proc{i}.sock"
                )
            children.append(
                _Child(i, binds[i], os.path.join(self.root, f"proc{i}"), env)
            )
        return children

    @staticmethod
    def _free_ports(host: str, n: int) -> list[int]:
        socks = []
        try:
            for _ in range(n):
                s = socket.socket()
                s.bind((host, 0))
                socks.append(s)
            return [s.getsockname()[1] for s in socks]
        finally:
            for s in socks:
                s.close()

    # ------------------------------------------------------------ lifecycle
    def start(self, ready_timeout_s: float = 600.0) -> None:
        """Decide the sharing mode, spawn the fleet, block until every
        child's cluster join has completed (readiness gating — the
        public port is only announced once the fleet can serve)."""
        os.makedirs(self.root, exist_ok=True)
        if probe_so_reuseport(self.config.host):
            self.mode = "reuseport"
        else:
            self.mode = "fd-pass"
            # LOUD: the operator asked for kernel-balanced sockets and
            # is getting the accept-and-pass parent instead — a real
            # throughput difference, not an implementation detail
            self.logger.log(
                "SO_REUSEPORT unavailable on this host — falling back to "
                "the accept-and-pass parent (every public connection pays "
                "one fd hand-off; docs/multiprocess.md)"
            )
        self.logger.log(
            f"supervisor: {self.n} serving processes, public port shared "
            f"via {self.mode}"
        )
        self.children = self.plan()
        if self.mode == "fd-pass":
            self.public_sock = socket.create_server(
                (self.config.host, self.config.port), backlog=_BACKLOG
            )
        self._write_state()
        for child in self.children:
            self._spawn(child)
        deadline = time.monotonic() + ready_timeout_s
        for child in self.children:
            if not self._wait_ready(child, deadline):
                raise RuntimeError(
                    f"child {child.index} ({child.bind}) not ready within "
                    f"{ready_timeout_s:.0f}s"
                )
        self._write_state()
        if self.mode == "fd-pass":
            self._accept_thread = threading.Thread(
                target=self._accept_loop, daemon=True,
                name="supervisor-accept",
            )
            self._accept_thread.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="supervisor-monitor"
        )
        self._monitor_thread.start()
        self.logger.log(
            f"supervisor: all {self.n} children ready — "
            f"{self.config.uri} announced"
        )

    def _spawn(self, child: _Child) -> None:
        argv = [
            sys.executable, "-m", "pilosa_tpu_torch", "server",
            "--bind", child.bind,
            "--data-dir", child.data_dir,
            "--device", self.device,
        ]
        if self.config_path:
            argv += ["--config", self.config_path]
        child.proc = subprocess.Popen(argv, env=child.env)
        child.ready = False
        child.spawned_at = time.monotonic()
        # child.last_exit is deliberately NOT cleared: the state file's
        # lastExitCode answers "why did this child restart" long after
        # the respawn succeeded

    def _status_url(self, child: _Child) -> str:
        return f"{self.config.scheme}://{child.bind}/status"

    def _probe_ready(self, child: _Child, timeout: float = 2.0) -> bool:
        ctx = None
        if self.config.scheme == "https":
            import ssl

            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        try:
            with urllib.request.urlopen(
                self._status_url(child), timeout=timeout, context=ctx
            ) as resp:
                return json.loads(resp.read()).get("state") == "NORMAL"
        except Exception:  # pilosa: allow(broad-except) — any failure
            # (refused, reset, timeout, bad JSON) means "not ready yet"
            return False

    def _wait_ready(self, child: _Child, deadline: float) -> bool:
        while time.monotonic() < deadline and not self._stopping.is_set():
            if child.proc is not None and child.proc.poll() is not None:
                # died during boot: respawn immediately inside the
                # readiness window (a crash loop exhausts the deadline)
                child.last_exit = child.proc.returncode
                child.restarts += 1
                self.logger.log(
                    f"supervisor: child {child.index} exited "
                    f"{child.last_exit} during boot — respawning"
                )
                time.sleep(
                    restart_backoff(
                        child.restarts,
                        self.config.supervisor_restart_backoff_s,
                        self.config.supervisor_restart_backoff_max_s,
                    )
                )
                self._spawn(child)
            if self._probe_ready(child):
                child.ready = True
                child.consecutive = 0
                return True
            time.sleep(0.25)
        return child.ready

    # ------------------------------------------------------------- monitor
    def _monitor(self) -> None:
        """Watch the fleet: respawn crashed children with capped
        exponential backoff, re-confirm readiness after each respawn,
        keep the fleet-state file current."""
        while not self._stopping.is_set():
            dirty = False
            now = time.monotonic()
            for child in self.children:
                proc = child.proc
                if proc is None:
                    continue
                code = proc.poll()
                if code is not None and child.restart_at == 0.0:
                    # fresh crash: schedule the respawn
                    child.last_exit = code
                    child.ready = False
                    if child.fd_sock is not None:
                        try:
                            child.fd_sock.close()
                        except OSError:
                            pass
                        child.fd_sock = None
                    if now - child.spawned_at >= HEALTHY_RESET_S:
                        child.consecutive = 0
                    child.consecutive += 1
                    child.restarts += 1
                    delay = restart_backoff(
                        child.consecutive,
                        self.config.supervisor_restart_backoff_s,
                        self.config.supervisor_restart_backoff_max_s,
                    )
                    child.restart_at = now + delay
                    self.logger.log(
                        f"supervisor: child {child.index} "
                        f"({child.bind}) exited {code} — respawn in "
                        f"{delay:.1f}s (restart #{child.restarts})"
                    )
                    dirty = True
                elif child.restart_at and now >= child.restart_at:
                    child.restart_at = 0.0
                    self._spawn(child)
                    dirty = True
                elif (
                    not child.ready
                    and child.restart_at == 0.0
                    and code is None
                    and self._probe_ready(child, timeout=0.5)
                ):
                    # respawned child finished its rejoin: back in the
                    # fd-pass rotation / counted ready in the state file
                    child.ready = True
                    self.logger.log(
                        f"supervisor: child {child.index} rejoined "
                        "(ownership re-hydrated)"
                    )
                    dirty = True
            if dirty:
                self._write_state()
            self._stopping.wait(0.5)

    # ------------------------------------------------------- fd-pass parent
    def _accept_loop(self) -> None:
        """Accept public connections and ship each fd to a ready child
        (round-robin).  Only runs in fd-pass mode."""
        assert self.public_sock is not None
        self.public_sock.settimeout(0.5)
        while not self._stopping.is_set():
            try:
                conn, _addr = self.public_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # socket closed by stop()
            try:
                if not self._pass_fd(conn):
                    try:
                        conn.sendall(_NO_CHILD_503)
                    except OSError:
                        pass
            finally:
                # the child holds its own duplicated fd now (or the 503
                # went out); the parent's reference always closes
                conn.close()

    def _pass_fd(self, conn: socket.socket) -> bool:
        """SCM_RIGHTS hand-off to the next ready child; tries each
        child once before giving up."""
        import array

        for _ in range(len(self.children)):
            child = self.children[self._rr % len(self.children)]
            self._rr += 1
            if not child.ready:
                continue
            try:
                if child.fd_sock is None:
                    path = child.env["PILOSA_TPU_FD_PASS_SOCKET"]
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.connect(path)
                    child.fd_sock = s
                child.fd_sock.sendmsg(
                    [b"c"],
                    [(
                        socket.SOL_SOCKET,
                        socket.SCM_RIGHTS,
                        array.array("i", [conn.fileno()]).tobytes(),
                    )],
                )
                return True
            except OSError:
                # broken control channel: drop it, try the next child
                if child.fd_sock is not None:
                    try:
                        child.fd_sock.close()
                    except OSError:
                        pass
                    child.fd_sock = None
                continue
        return False

    # ------------------------------------------------------------ state file
    def _write_state(self) -> None:
        """Atomic fleet-state snapshot: what children serve
        /debug/processes from, and what doctor --fleet walks."""
        state = {
            "mode": self.mode,
            "publicBind": self.config.bind,
            "publicUri": self.config.uri,
            "parentPid": os.getpid(),
            "device": self.device,
            "processes": [
                {
                    "index": c.index,
                    "bind": c.bind,
                    "uri": f"{self.config.scheme}://{c.bind}",
                    "dataDir": c.data_dir,
                    "pid": c.pid,
                    "ready": c.ready,
                    "restarts": c.restarts,
                    "lastExitCode": c.last_exit,
                }
                for c in self.children
            ],
        }
        tmp = self.state_path + ".tmp"
        with self._state_lock:
            with open(tmp, "w") as f:
                json.dump(state, f, indent=2)
            # best-effort observability state: atomic for readers, but a
            # crash losing the newest snapshot is fine — it is rebuilt on
            # the next monitor tick
            durable.replace_durable(tmp, self.state_path, durable=False)

    # ------------------------------------------------------------- shutdown
    def stop(self, drain_s: float = 30.0) -> None:
        """Graceful drain: stop accepting (fd-pass), SIGTERM every
        child, bounded wait, SIGKILL stragglers."""
        self._stopping.set()
        if self.public_sock is not None:
            try:
                self.public_sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=2.0)
        for child in self.children:
            if child.proc is not None and child.proc.poll() is None:
                try:
                    child.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + drain_s
        for child in self.children:
            if child.proc is None:
                continue
            try:
                child.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.logger.log(
                    f"supervisor: child {child.index} ignored SIGTERM for "
                    f"{drain_s:.0f}s — killing"
                )
                child.proc.kill()
                child.proc.wait(timeout=10.0)
            child.last_exit = child.proc.returncode
            child.ready = False
        self._write_state()
        self.logger.log("supervisor: fleet drained")
        self.logger.close()

    def run_forever(self) -> int:
        """CLI entry (cmd_server's --processes N path): start the
        fleet, park until SIGTERM/SIGINT, drain."""
        stop = []
        signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
        try:
            self.start()
        except Exception:
            self.stop(drain_s=5.0)
            raise
        print(
            f"pilosa-tpu supervisor: {self.n} processes serving "
            f"{self.config.uri} ({self.mode})",
            flush=True,
        )
        try:
            while not stop:
                signal.pause()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
        return 0
