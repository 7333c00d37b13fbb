"""Roaring ↔ dense packed-word conversion (the TPU interchange boundary).

The device-side representation of a fragment is a dense packed bit matrix
``uint32[rows, WORDS_PER_SHARD]`` (see SURVEY.md §7): XLA wants static
shapes and vectorised bitwise ops, so roaring is only the at-rest / import
format and everything hot runs on packed words. These helpers convert a
host Bitmap range to/from packed uint32 words.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.roaring.bitmap import Bitmap
from pilosa_tpu_torch.shardwidth import BITS_PER_WORD


def pack_range(bitmap: Bitmap, start: int, stop: int) -> np.ndarray:
    """Pack bits for positions [start, stop) into uint32 words.

    ``stop - start`` must be a multiple of 32. Bit ``p`` (absolute) maps to
    word ``(p - start) // 32``, bit ``(p - start) % 32`` (little-endian bit
    order within a word).
    """
    width = stop - start
    if width % BITS_PER_WORD:
        raise ValueError("range width must be a multiple of 32")
    positions = (bitmap.range_values(start, stop) - np.uint64(start)).astype(np.int64)
    return pack_positions(positions, width)


def pack_positions(positions: np.ndarray, width: int) -> np.ndarray:
    """Pack sorted in-range bit positions into uint32[width // 32]."""
    from pilosa_tpu_torch import native

    return native.pack_positions(np.asarray(positions, dtype=np.int64), width)


def unpack_words(words: np.ndarray) -> np.ndarray:
    """Set-bit positions (int64, ascending) of packed uint32 words."""
    from pilosa_tpu_torch import native

    return native.unpack_words(words)


def words_count(words: np.ndarray) -> int:
    from pilosa_tpu_torch import native

    return native.words_count(words)
