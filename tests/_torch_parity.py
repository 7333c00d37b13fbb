"""One seeded data set, written into a holder of either package.

The port's tests hold pilosa_tpu_torch against pilosa_tpu on the same
bits: ``fill(core, holder)`` takes a package's ``core`` module and writes
the identical data through that package's own Field API.
"""

from datetime import datetime, timedelta

import numpy as np

N_SHARDS = 3


def fill_data(seed: int = 7) -> dict:
    """The bits of ``fill``'s index "i": {"f": (rows, cols), "g": (rows,
    cols), "t": (rows, cols, datetimes), "v": (cols, values)}, each an
    array (or list) in import order, for a holder or for HTTP imports."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(seed)
    n_cols = N_SHARDS * SHARD_WIDTH
    cols = rng.integers(0, n_cols, 4000).astype(np.uint64)
    rows = rng.integers(0, 5, 4000).astype(np.uint64)
    full = np.arange(SHARD_WIDTH, dtype=np.uint64)
    high = np.arange(SHARD_WIDTH + 31, 2 * SHARD_WIDTH, 32, dtype=np.uint64)
    f = (
        np.concatenate([rows, np.full(full.size, 5, np.uint64), np.full(high.size, 4, np.uint64)]),
        np.concatenate([cols, full, high]),
    )
    gcols = rng.integers(0, n_cols, 1500).astype(np.uint64)
    g = (rng.integers(0, 3, 1500).astype(np.uint64), gcols)
    tcols = rng.integers(0, n_cols, 600).astype(np.uint64)
    days = rng.integers(0, 700, 600)
    stamps = [datetime(2020, 1, 1) + timedelta(days=int(d), hours=5) for d in days]
    t = (rng.integers(0, 3, 600).astype(np.uint64), tcols, stamps)
    vcols = rng.choice(n_cols, 500, replace=False).astype(np.uint64)
    v = (vcols, rng.integers(-1000, 1001, 500).astype(np.int64))
    return {"f": f, "g": g, "t": t, "v": v}


def fill(core, holder, seed: int = 7):
    """Index "i" with existence tracking and fields:

    f   set, rows 0-5 random; row 5 is all ones across shard 0 (all-ones
        words) and row 4 holds only column 31 of each word in shard 1
        (words with only the high bit set)
    g   set, rows 0-2 random
    t   time, quantum YMD, rows 0-2 over 2020-2021
    v   int in [-1000, 1000]
    """
    d = fill_data(seed)
    idx = holder.create_index("i")
    idx.create_field("f").import_bulk(*d["f"])
    idx.create_field("g").import_bulk(*d["g"])
    t = idx.create_field("t", core.FieldOptions(field_type="time", time_quantum="YMD"))
    trows, tcols, stamps = d["t"]
    t.import_bulk(trows, tcols, timestamps=stamps)
    v = idx.create_field(
        "v", core.FieldOptions(field_type="int", min=-1000, max=1000, has_range=True)
    )
    v.import_values(*d["v"])
    idx.mark_columns_exist(np.concatenate([d["f"][1], d["g"][1], tcols, d["v"][0]]))
    return idx


MIXED_SHARDS = 2


def fill_mixed(core, holder, seed: int = 0, n_rows: int = 200):
    """Index "res" whose set field ``f`` has rows of every container
    kind once its stack is over budget (tests/test_residency.py's
    recipe, fewer rows): rows 0..n_rows-1 one random bit each (sparse),
    row 10 a run of 3,000 columns across the shard boundary (run), row
    11 a random half of all columns (dense); and an int field ``v`` of
    600 values in [-500, 50000)."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(seed)
    n_cols = MIXED_SHARDS * SHARD_WIDTH
    idx = holder.create_index("res")
    f = idx.create_field("f")
    cols = rng.integers(0, n_cols, size=n_rows).astype(np.uint64)
    f.import_bulk(np.arange(n_rows, dtype=np.uint64), cols)
    f.import_bulk(
        np.full(3000, 10, np.uint64), (np.arange(3000) + SHARD_WIDTH - 1500).astype(np.uint64)
    )
    dense = rng.choice(n_cols, size=SHARD_WIDTH, replace=False).astype(np.uint64)
    f.import_bulk(np.full(dense.size, 11, np.uint64), dense)
    v = idx.create_field("v", core.FieldOptions(field_type="int"))
    vcols = rng.choice(n_cols, size=600, replace=False).astype(np.uint64)
    v.import_values(vcols, rng.integers(-500, 50000, size=600).astype(np.int64))
    idx.mark_columns_exist(np.concatenate([cols, dense, vcols]))
    return idx


MESH_SHARDS = 8


def fill_mesh(core, holder, seed: int = 42):
    """Index "eq" of the mesh-vs-host suite (tests/test_mesh_spmd.py's
    recipe, 8 shards): set fields f (rows 0-7) and g (rows 0-4) over
    5,000 random columns, int field v in [-500, 500) on the same columns,
    and time field t (quantum YMD) over the first 400 of them."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(seed)
    idx = holder.create_index("eq")
    f = idx.create_field("f")
    g = idx.create_field("g")
    v = idx.create_field("v", core.FieldOptions(field_type="int", min=-1000, max=1000))
    t = idx.create_field("t", core.FieldOptions(field_type="time", time_quantum="YMD"))
    n = 5000
    cols = rng.choice(MESH_SHARDS * SHARD_WIDTH, n, replace=False).astype(np.uint64)
    frows = rng.integers(0, 8, n).astype(np.uint64)
    grows = rng.integers(0, 5, n).astype(np.uint64)
    f.import_bulk(frows, cols)
    g.import_bulk(grows, cols)
    v.import_values(cols, rng.integers(-500, 500, n).astype(np.int64))
    t.import_bulk(
        frows[:400], cols[:400], timestamps=[datetime(2024, 1 + int(i % 3), 5) for i in range(400)]
    )
    return idx
