"""Shard-width constant.

Reference: shardwidth/shardwidth.go (Exponent = 20) — in Pilosa the shard
width is a compile-time build-tag constant; here it is process-wide and
configurable through the ``PILOSA_TPU_SHARD_WIDTH_EXP`` environment variable
(read once at import). All (index, field, view, shard) fragments cover
``SHARD_WIDTH`` consecutive columns; column ``c`` lives in shard
``c // SHARD_WIDTH`` at in-shard position ``c % SHARD_WIDTH``.

The shard is the dense-packing unit: one fragment row is
``WORDS_PER_SHARD`` uint32 words. The default exponent of 20 gives
1,048,576 columns per shard = 32,768 words = 128 KiB per row. The
smallest exponent (12) still gives 128 words, so a row is always a whole
number of the 16-byte vectors the CUDA kernels load per thread.
The variable is the one ``pilosa_tpu`` reads, so both packages agree on
``W`` in one process. Tests run with a smaller exponent to keep host
arrays tiny.
"""

import os

BITS_PER_WORD = 32

SHARD_WIDTH_EXP = int(os.environ.get("PILOSA_TPU_SHARD_WIDTH_EXP", "20"))
if SHARD_WIDTH_EXP < 12 or SHARD_WIDTH_EXP > 28:
    raise ValueError(
        f"PILOSA_TPU_SHARD_WIDTH_EXP={SHARD_WIDTH_EXP} out of range [12, 28]"
    )

SHARD_WIDTH = 1 << SHARD_WIDTH_EXP
WORDS_PER_SHARD = SHARD_WIDTH // BITS_PER_WORD
