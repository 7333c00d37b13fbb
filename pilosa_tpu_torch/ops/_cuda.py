"""Builds the hand-written CUDA kernels and binds them through ctypes.

Each ``csrc/<name>.cu`` is compiled at first use, on the machine that
has the card, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

into ``pilosa_tpu_torch/_build/`` (git-ignored), and loaded with
``ctypes``. The sources have a plain C interface and include no PyTorch
header, so one file builds in seconds. Pointers are ``data_ptr()`` ints
and the stream is PyTorch's current stream; every C entry returns
``cudaGetLastError()`` and :meth:`Kernel.launch` raises when it is not 0.

A failed build or launch raises: nothing here falls back to the plain
torch versions. Those run only for tensors that lie on the CPU, a
decision the callers in ``ops`` make from the tensor's device.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a card
    raises; the CPU is used only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "torch versions of the kernels on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """Whether ``lib<name>.so`` is older than its source or any header
    in ``csrc/`` (``common.cuh``, ``bulk.cuh``, ``bmma.cuh``,
    ``tree_interp.cuh``)."""
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    sources = [os.path.join(CSRC, f"{name}.cu"), *headers]
    return any(os.path.getmtime(s) > built for s in sources)


def build(names: list[str], force: bool = False) -> dict[str, float]:
    """Compile every stale source in ``names`` (every one with
    ``force``) with one nvcc process each, all started together. Returns
    the seconds each build took (0.0 for a library already current)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
            time.perf_counter(),
        )
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate(timeout=600)
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, _lib_path(name))
    if errors:
        raise KernelBuildError("\n".join(errors))
    return seconds


class Kernel:
    """One hand-written kernel: its source, its C entry and its count of
    launches (raised only where the kernel is launched), also kept per
    mode of the launch (``modes``). ``stem`` names the source when one
    file holds several entries (K6, K9 and K10, K12, and the fused-filter
    entries of K2, K4 and K5)."""

    def __init__(self, name: str, argtypes: list, replaces: str, stem: str | None = None):
        self.name = name
        self.stem = stem or name
        self.source = f"pilosa_tpu_torch/csrc/{self.stem}.cu"
        self.replaces = replaces
        self.launches = 0
        self.modes: dict[str, int] = {}
        self._argtypes = argtypes
        self._fn = None
        self._errstr = None
        self._lock = threading.Lock()

    def _bind(self):
        with self._lock:
            if self._fn is None:
                build([self.stem])
                lib = ctypes.CDLL(_lib_path(self.stem))
                fn = getattr(lib, self.name)
                fn.argtypes = self._argtypes
                fn.restype = ctypes.c_int
                err = lib.pt_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._errstr = err
                self._fn = fn
        return self._fn

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.modes = {}

    def launch(self, device: torch.device, *args, mode: str = "") -> None:
        """Call the C entry on ``device``'s current stream; raise on a
        non-zero cudaGetLastError(). ``mode`` names what the launch
        computes (K1's words or count, a filtered TopN) for the counts."""
        fn = self._bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            err = fn(*args, ctypes.c_void_p(stream))
        if err != 0:
            msg = self._errstr(err).decode(errors="replace")
            raise KernelLaunchError(f"{self.name}: CUDA error {err}: {msg}")
        with self._lock:
            self.launches += 1
            if mode:
                self.modes[mode] = self.modes.get(mode, 0) + 1


_VP, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float

TREE_EVAL = Kernel(
    "tree_eval",
    [_VP, _LL, _VP, _VP, _VP],
    # _Planner.plan, run by count_async (:1656) and bitmap_device (:1640)
    "pilosa_tpu/executor/compile.py:1334",
)
ROW_COUNTS = Kernel(
    "row_counts",
    [_VP, _LL, _LL, _VP, _VP, _LL, _VP, _VP],
    # matrix_filter_counts; also ops/topn.py:29 candidate_counts
    "pilosa_tpu/ops/bitwise.py:102",
)
ROW_COUNTS_TREE = Kernel(
    "row_counts_tree",
    [_VP, _VP, _LL, _LL, _VP, _LL, _VP, _VP],
    # the filtered TopN's program with its filter's tree inside
    # (_filter_plan, :1276-1312 ids=, :1356-1383)
    "pilosa_tpu/executor/executor.py:1019",
    stem="row_counts",
)
STACK_DELTA = Kernel(
    "stack_delta",
    [_VP, _VP, _LL, _LL, _LL, _VP, _I, _VP, _LL, _VP, _VP],
    "pilosa_tpu/executor/compile.py:194",  # _apply_stack_delta
)
BSI_SUM = Kernel(
    "bsi_sum",
    [_VP, _LL, _I, _I, _VP, _I, _VP, _VP, _VP, _VP],
    # sum_counts, vmapped by _sum_fn (executor.py:1073) and grouped by
    # _grouped_sum_program (:1088)
    "pilosa_tpu/ops/bsi.py:113",
)
BSI_SUM_TREE = Kernel(
    "bsi_sum_tree",
    [_VP, _VP, _LL, _I, _I, _VP, _VP, _VP, _VP],
    # the filtered Sum's program with its filter's tree inside
    # (_filter_plan, :1107-1132)
    "pilosa_tpu/executor/executor.py:1019",
    stem="bsi_sum",
)
BSI_MINMAX = Kernel(
    "bsi_minmax",
    [_VP, _LL, _I, _I, _I, _VP, _I, _VP, _VP, _VP],
    "pilosa_tpu/ops/bsi.py:152",  # min_max, vmapped at executor.py:1194
)
BSI_MINMAX_TREE = Kernel(
    "bsi_minmax_tree",
    [_VP, _VP, _LL, _I, _I, _I, _I, _VP, _VP, _VP],
    # the filtered Min/Max program with its filter's tree inside
    # (_filter_plan, :1167-1203)
    "pilosa_tpu/executor/executor.py:1019",
    stem="bsi_minmax",
)
GB_COUNTS = Kernel(
    "gb_counts",
    [_VP, _LL, _VP, _LL, _LL, _VP, _LL, _VP, _VP],
    "pilosa_tpu/executor/executor.py:177",  # _gb_counts
    stem="groupby",
)
GB_MASKS = Kernel(
    "gb_masks",
    [_VP, _VP, _LL, _VP, _LL, _LL, _VP, _VP, _LL, _VP],
    "pilosa_tpu/executor/executor.py:192",  # _gb_masks
    stem="groupby",
)
SHIFT_WORDS = Kernel(
    "shift_words",
    [_VP, _VP, _LL, _LL, _LL, _VP],
    "pilosa_tpu/ops/bitwise.py:112",  # shift_words, for PQL Shift (compile.py:1375)
)
CONTAINER_COUNT = Kernel(
    "container_count",
    [_VP, _I, _LL, _VP, _VP],
    # sparse_count (:113) and run_count (:119), the direct counts of
    # count_async (compile.py:1656)
    "pilosa_tpu/ops/containers.py:113",
)
SIM_SCAN = Kernel(
    "sim_scan",
    [_VP, _LL, _LL, _VP, _F, _I, _VP, _VP, _VP],
    # tanimoto_search's scan: matrix_filter_counts, popcount_rows, the score
    "pilosa_tpu/ops/similarity.py:25",
    stem="similarity_scan",
)
SIM_SELECT = Kernel(
    "sim_select",
    [_VP, _LL, _VP, _VP, _VP, _LL, _I, _I, _VP, _VP, _I, _VP, _VP],
    # tanimoto_search's jax.lax.top_k; its int mode the lax.top_k of int64
    # counts (mesh.py:647-652, ops/topn.py:24)
    "pilosa_tpu/ops/similarity.py:25",
    stem="similarity_scan",
)
PAIRWISE = Kernel(
    "pairwise",
    [_VP, _LL, _VP, _LL, _LL, _I, _I, _VP, _VP],
    # pairwise_intersections, with the epilogues of tanimoto_matrix (:63)
    # and cosine_matrix (:72)
    "pilosa_tpu/ops/similarity.py:51",
)
MESH_SIM_KEYS = Kernel(
    "mesh_sim_keys",
    [_VP, _VP, _VP, _LL, _I, _VP, _VP, _VP],
    # the score lines of the mesh Tanimoto (:684-688) and cosine (:726-733)
    "pilosa_tpu/parallel/mesh.py:684",
    stem="mesh_finish",
)
MESH_PAIRWISE_FINISH = Kernel(
    "mesh_pairwise_finish",
    [_VP, _VP, _VP, _LL, _LL, _I, _VP, _VP],
    "pilosa_tpu/parallel/mesh.py:796",  # the all-pairs epilogue over the reduced counts
    stem="mesh_finish",
)
COUNT_KEYS = Kernel(
    "count_keys",
    [_VP, _LL, _VP, _VP, _VP],
    # the integer top-k's keys: lax.top_k of the mesh TopN's int64 counts
    "pilosa_tpu/parallel/mesh.py:650",
    stem="mesh_finish",
)
INGEST_COUNTS = Kernel(
    "ingest_counts",
    [_VP, _VP, _LL, _LL, _VP, _VP, _VP, _VP],
    # _ingest_prog, the donated m | delta with its filtered row counts;
    # also __graft_entry__.py:65 query_step
    "pilosa_tpu/parallel/mesh.py:852",
)
KERNELS = {
    k.name: k
    for k in (
        TREE_EVAL, ROW_COUNTS, ROW_COUNTS_TREE, STACK_DELTA, BSI_SUM, BSI_SUM_TREE,
        BSI_MINMAX, BSI_MINMAX_TREE, GB_COUNTS, GB_MASKS, SHIFT_WORDS, CONTAINER_COUNT,
        SIM_SCAN, SIM_SELECT, PAIRWISE, MESH_SIM_KEYS, MESH_PAIRWISE_FINISH, COUNT_KEYS,
        INGEST_COUNTS,
    )
}
# the sources, one nvcc process each
SOURCES = sorted({k.stem for k in KERNELS.values()})
