"""pilosa_tpu_torch — the PyTorch and CUDA port of pilosa_tpu.

The same Holder → Index → Field → View → Fragment model, roaring storage
and PQL as ``pilosa_tpu``, with the device hot loops run by kernels
written by hand for NVIDIA Hopper (``csrc/*.cu``, built with nvcc at
first use and called through ctypes). The package imports neither JAX
nor ``pilosa_tpu``: the modules it shares with the reference are copies.

Layer map:
    roaring/   bitmap engine (host codec)
    core/      storage & data model (Holder/Index/Field/View/Fragment)
    pql/       query language (parser → AST)
    executor/  PQL AST → postfix programs and kernel launches
    ops/       plain torch versions, kernel wrappers, the nvcc loader
    server/    API façade
    utils/     stats, tracing, logging, durability
    csrc/      the CUDA kernels

Entry points take ``device=``; the default is ``"cuda"`` and it never
drops to the CPU by itself — pass ``device="cpu"`` to run the plain torch
versions of every kernel (the tests do).
"""

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXP, WORDS_PER_SHARD

__version__ = "0.1.0"

__all__ = [
    "SHARD_WIDTH",
    "SHARD_WIDTH_EXP",
    "WORDS_PER_SHARD",
    "__version__",
]
