"""Vectorized bulk container builders — the client half of the
wire-speed ingest lane (docs/ingest.md).

Turns flat (row, column) id vectors into per-shard serialized roaring
frames ready to POST to ``/index/{i}/field/{f}/import-roaring/{shard}``,
never touching a per-bit ``Set`` path (the Roaring papers' columnar
construction: arXiv 1709.07821 §4, 1402.6407 §5). The passes are all
whole-batch numpy:

1. position encode — ``pos = row * SHARD_WIDTH + col % SHARD_WIDTH``;
2. shard split — one argsort of the shard vector, then searchsorted
   boundaries (no per-shard boolean scans);
3. container build — ``Bitmap.add_many``'s batch merge (sort-unique →
   per-key chunking → ``packbits``-style word fill for dense chunks);
4. run detection + serialization — ``serialize``'s ``batch_optimize``
   pass analyzes every container in one vectorized sweep.

The server adopts each frame wholesale (one crc32-framed WAL append,
see ``core/fragment.py:import_roaring``), so the bytes built here are
the bytes that land in the fragment file.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch import native
from pilosa_tpu_torch.roaring import containers as ct
from pilosa_tpu_torch.roaring.bitmap import Bitmap
from pilosa_tpu_torch.roaring.serialize import serialize
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


def bitmap_from_positions(
    positions: np.ndarray, presorted: bool = False
) -> Bitmap:
    """One fragment-relative position vector → a Bitmap, built columnar
    (sort-unique + per-key chunk passes; no per-bit container probing).
    ``presorted=True`` when the caller already holds sorted-unique
    positions (the combined-key split below) skips the re-sort."""
    bm = Bitmap()
    bm.add_many(np.asarray(positions, dtype=np.uint64), presorted=presorted)
    return bm


def payload_from_positions(positions: np.ndarray) -> bytes:
    """Fragment-relative positions → one serialized roaring frame
    (run-compacted), the exact body of an import-roaring POST."""
    return serialize(bitmap_from_positions(positions))


def split_by_shard(
    rows: np.ndarray, cols: np.ndarray, shard_width: int = SHARD_WIDTH
) -> list[tuple[int, np.ndarray]]:
    """Partition (row, col) bit vectors by shard: returns
    ``[(shard, fragment_relative_positions), ...]`` sorted by shard,
    every slice SORTED UNIQUE.

    One radix sort-unique over a combined ``shard << k | position`` key
    does the whole job — the split AND the per-shard container ordering
    — in a single pass (the separate argsort-by-shard + per-shard
    re-sort it replaces measured ~2x the time at 4M bits). Falls back
    to the two-pass form when the combined key would overflow 64 bits
    (astronomical row ids)."""
    rows = np.asarray(rows, dtype=np.uint64)
    cols = np.asarray(cols, dtype=np.uint64)
    if rows.size != cols.size:
        raise ValueError("rows and cols length mismatch")
    if rows.size == 0:
        return []
    sw = np.uint64(shard_width)
    shards = cols // sw
    # position upper bound from the row max alone — one cheap reduction
    # instead of materializing the position vector just to take its max
    pos_bits = max(
        1, (int(rows.max() if rows.size else 0) * shard_width + shard_width - 1).bit_length()
    )
    max_shard = int(shards.max())
    if pos_bits + max(max_shard.bit_length(), 1) <= 64:
        shift = np.uint64(pos_bits)
        # key = shard << shift | pos, with pos = row*sw + col % sw and
        # col % sw = col - shard*sw — fused into three in-place passes
        # (the naive div/mod/mul/or chain was ~7 full-array passes)
        key = rows * sw
        key += cols
        key += shards * np.uint64((1 << pos_bits) - shard_width)
        key = native.sort_unique_u64(key, owned=True)
        kpos = key & np.uint64((1 << pos_bits) - 1)
        if max_shard < (1 << 16):
            # dense shard range: boundaries by O(S log n) searchsorted
            # over the sorted key — not another O(n) decode+uniq pass.
            # Only shard START keys are searched; the final boundary is
            # key.size directly — a (max_shard+1) << shift sentinel can
            # wrap to 0 in uint64 when the combined key uses all 64
            # bits, silently dropping the highest shard's slice
            cand = np.arange(max_shard + 1, dtype=np.uint64) << shift
            bounds = np.append(np.searchsorted(key, cand), key.size)
            return [
                (s, kpos[bounds[s] : bounds[s + 1]])
                for s in range(max_shard + 1)
                if bounds[s + 1] > bounds[s]
            ]
        kshards = (key >> shift).astype(np.int64)
        uniq, starts = native.uniq_sorted(kshards)
        bounds = np.append(starts, kshards.size)
        return [
            (int(s), kpos[bounds[i] : bounds[i + 1]])
            for i, s in enumerate(uniq.tolist())
        ]
    positions = rows * sw + (cols % sw)
    order = np.argsort(shards, kind="stable")
    shards_s = shards[order].astype(np.int64)
    positions_s = positions[order]
    uniq, starts = native.uniq_sorted(shards_s)
    bounds = np.append(starts, shards_s.size)
    return [
        (
            int(s),
            native.sort_unique_u64(positions_s[bounds[i] : bounds[i + 1]]),
        )
        for i, s in enumerate(uniq.tolist())
    ]


def shard_payloads(
    rows: np.ndarray, cols: np.ndarray, shard_width: int = SHARD_WIDTH
) -> list[tuple[int, bytes, int]]:
    """The full client-side pipeline: (rows, cols) → ``[(shard,
    serialized_frame, n_bits), ...]``. ``n_bits`` is the DEDUPLICATED
    bit count the frame carries (what the server will actually adopt),
    for throughput accounting.

    Fast path: no value sort at all. Bits are grouped by CONTAINER key
    with one O(n + K) counting pass (keys are dense small integers —
    shard × row × container), then each container's low 16 bits scatter
    into a bool plane where deduplication and ordering fall out for
    free: ``flatnonzero`` yields the sorted-unique array container,
    ``packbits`` the bitmap words. Replaces the 4-pass radix
    sort-unique over the full u64 position vector — the former build
    bottleneck. Sparse/huge shard ids fall back to the sorted-split
    path."""
    rows = np.asarray(rows, dtype=np.uint64)
    cols = np.asarray(cols, dtype=np.uint64)
    if rows.size != cols.size:
        raise ValueError("rows and cols length mismatch")
    if rows.size == 0:
        return []
    sw = np.uint64(shard_width)
    shards = cols // sw
    pos_bits = max(
        16,
        (int(rows.max()) * shard_width + shard_width - 1).bit_length(),
    )
    max_shard = int(shards.max())
    gk_max = ((max_shard + 1) << (pos_bits - 16)) - 1
    if pos_bits + max(max_shard.bit_length(), 1) > 64 or gk_max > max(
        4 * rows.size, 1 << 22
    ):
        # combined key overflows, or the container-key space is way out
        # of proportion to n (counting pass would be histogram-bound)
        return [
            (shard, serialize(bm), bm.count())
            for shard, positions in split_by_shard(rows, cols, shard_width)
            for bm in (bitmap_from_positions(positions, presorted=True),)
        ]
    # key = shard << pos_bits | position, fused (col % sw = col - shard*sw)
    key = rows * sw
    key += cols
    key += shards * np.uint64((1 << pos_bits) - shard_width)
    bucketed = native.bucket_lows(key, gk_max)
    if bucketed is not None:
        # one native counting pass groups the truncated lows directly —
        # no permutation array, no gather, no separate bincount
        lows_sorted, hist = bucketed
    else:
        gk = (key >> np.uint64(16)).astype(np.int64)
        order = np.argsort(gk, kind="stable")
        lows_sorted = key.astype(np.uint16)[order]
        hist = np.bincount(gk, minlength=gk_max + 1)
    present = np.flatnonzero(hist)
    bounds = np.concatenate(([0], np.cumsum(hist[present])))
    key_mask = (1 << (pos_bits - 16)) - 1
    out: list[tuple[int, bytes, int]] = []
    cur_shard = -1
    bm = Bitmap()
    arr_max, mk, t_arr = ct.ARRAY_MAX, ct.Container, ct.TYPE_ARRAY
    # ONE reusable scatter plane, reset by re-clearing only the touched
    # positions — a fresh 64 KiB zeros() per container doubles the
    # builder's memory traffic
    bits = np.zeros(ct.CONTAINER_BITS, dtype=bool)
    for i, g in enumerate(present.tolist()):
        shard = g >> (pos_bits - 16)
        if shard != cur_shard:
            if cur_shard >= 0:
                out.append((cur_shard, serialize(bm), bm.count()))
            cur_shard = shard
            bm = Bitmap()
        chunk = lows_sorted[bounds[i] : bounds[i + 1]]
        # bool scatter: dedup + sort fall out of position addressing
        bits[chunk] = True
        values = np.flatnonzero(bits).astype(np.uint16)
        if values.size > arr_max:
            data = np.packbits(bits, bitorder="little").view(np.uint64)
            bm._containers[g & key_mask] = ct.Container(ct.TYPE_BITMAP, data)
        else:
            bm._containers[g & key_mask] = mk(t_arr, values)
        bits[chunk] = False
    if cur_shard >= 0:
        out.append((cur_shard, serialize(bm), bm.count()))
    return out


def fold_to_columns(bm: Bitmap, shard_width: int = SHARD_WIDTH) -> Bitmap:
    """Fragment positions → the shard-relative COLUMN bitmap (positions
    mod shard_width), container-wise: when the shard width is a multiple
    of the container span (the ≥2^16 production widths), every row's
    containers fold onto the column space by key arithmetic + a
    container OR chain — O(containers), never a sort over the value
    vector. This is the existence-marking fast path (docs/ingest.md):
    the adopt delta's column set comes straight off its containers.
    Narrow test widths fall back to the value-vector mod."""
    out = Bitmap()
    if not bm._containers:
        return out
    keys_per_row = shard_width // ct.CONTAINER_BITS
    if keys_per_row * ct.CONTAINER_BITS != shard_width or keys_per_row < 1:
        out.add_many(bm.values() % np.uint64(shard_width))
        return out
    oc = out._containers
    for key, c in bm._containers.items():
        k = key % keys_per_row
        existing = oc.get(k)
        oc[k] = c if existing is None else ct.container_or(existing, c)
    return out
