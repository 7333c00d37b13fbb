"""A configuration's data, made from the seed, in two forms: the raw
columns that the reference reads, and the packed planes that the
program is loaded with.

A configuration file (``configs/<name>.json``) names an index, its
shard count, its shard width and the number of distinct blocks cycled
over the shards (block ``s % blocks`` fills shard ``s``, so generation
stays O(blocks) while every query does the full O(shards) work), and
its fields, each of one kind:

- ``categorical``: one row per column, drawn from the list ``p`` or
  from a truncated geometric law (``p0`` for row 0, each later row
  ``ratio`` times the one before); with ``cover``, column ``r`` of
  every block holds row ``r``, so every block holds every row;
- ``int``: a BSI field from ``min`` to ``max``; values from ``mix``
  (``[share, lo, hi]`` parts), a ``missing`` share of columns without a
  value, and ``pin`` (``[block, value]``: the value at the head of that
  block, so the field's extremes exist).

Only numpy is imported: the reference reads the raw columns, and the
packing into the program's layout lives here too, where both sides
can be checked against each other.
"""

from __future__ import annotations

import numpy as np

BITS_PER_WORD = 32
MIN_PADDED_ROWS = 8  # a fragment pads its rows to a power of two, at least 8


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """The seed's stream ``stream``: data is stream 0, traffic stream 1.
    Any whole number is a seed, negative ones included."""
    return np.random.SeedSequence([int(seed) % (1 << 64), stream])


def padded_rows(n: int) -> int:
    p = MIN_PADDED_ROWS
    while p < n:
        p *= 2
    return p


def pack(bits: np.ndarray) -> np.ndarray:
    """bool[..., n] → uint32[..., n / 32], column c at bit c % 32 of word
    c // 32 (the fragments' packed layout)."""
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)


def unpack(words: np.ndarray) -> np.ndarray:
    """uint32[..., w] → bool[..., 32 w], the inverse of :func:`pack`."""
    return np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little").astype(bool)


def bit_depth(lo: int, hi: int) -> int:
    """The BSI magnitude depth of a field from ``lo`` to ``hi``."""
    return max(abs(lo).bit_length(), abs(hi).bit_length(), 1)


class Field:
    """One field's raw columns over the blocks: ``cats`` (categorical:
    int16[G, C], the row of each column) or ``vals`` and ``has`` (int:
    int64[G, C] and bool[G, C])."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.name = spec["name"]
        self.kind = spec["kind"]
        if self.kind == "int":
            self.min, self.max = int(spec["min"]), int(spec["max"])
            self.depth = bit_depth(self.min, self.max)
            self.rows = 0
        else:
            self.rows = int(spec["rows"])
        self.cats = self.vals = self.has = None

    def row_ids(self) -> list[int]:
        return list(range(self.rows))

    def packed(self, g: int) -> np.ndarray:
        """Block ``g`` as the program stores it: a set field's rows, or an
        int field's BSI planes (exists, sign, then the magnitude's bits
        from the lowest), padded to a fragment's height."""
        if self.kind == "categorical":
            rows = one_hot_words(self.cats[g], self.rows)
        else:
            v, has = self.vals[g], self.has[g]
            mag = np.abs(v)
            bits = np.empty((2 + self.depth, v.size), dtype=bool)
            bits[0] = has
            bits[1] = has & (v < 0)
            for k in range(self.depth):
                bits[2 + k] = has & (((mag >> k) & 1) == 1)
            rows = pack(bits)
        out = np.zeros((padded_rows(rows.shape[0]), rows.shape[1]), dtype=np.uint32)
        out[: rows.shape[0]] = rows
        return out

    def positions(self, g: int) -> np.ndarray:
        """Block ``g`` of a set field as fragment positions (row × shard
        width + column), for the one shard loaded through roaring
        storage."""
        cols = np.arange(self.cats.shape[1], dtype=np.uint64)
        return self.cats[g].astype(np.uint64) * np.uint64(self.cats.shape[1]) + cols


def one_hot_words(cats: np.ndarray, rows: int) -> np.ndarray:
    """uint32[rows, C / 32]: column c's bit set in row ``cats[c]``. The
    bits of one word are distinct powers of two, so their sum is their
    OR, and a float64 sum below 2^32 is exact."""
    cols = np.arange(cats.size, dtype=np.int64)
    key = cats.astype(np.int64) * (cats.size // BITS_PER_WORD) + (cols >> 5)
    words = np.bincount(key, weights=np.left_shift(1, cols & 31).astype(np.float64),
                        minlength=rows * (cats.size // BITS_PER_WORD))
    return words.astype(np.uint32).reshape(rows, -1)


class Dataset:
    """A configuration's data for one seed: ``fields`` by name, each over
    ``blocks`` blocks of ``width`` columns, and ``mult[g]``, the number
    of shards that block ``g`` fills. ``only`` names the fields to make
    (all where None); each field has a stream of the seed of its own, so
    a field is the same whichever others are made."""

    def __init__(self, config: dict, seed: int, shards: int | None = None, width_exp: int | None = None,
                 only: "list | None" = None):
        self.config = config
        self.index = config["index"]
        self.shards = int(shards if shards is not None else config["shards"])
        self.width_exp = int(width_exp if width_exp is not None else config["shard_width_exp"])
        self.width = 1 << self.width_exp
        self.words = self.width // BITS_PER_WORD
        self.blocks = min(int(config["blocks"]), self.shards)
        self.mult = np.bincount(np.arange(self.shards) % self.blocks, minlength=self.blocks)
        self.fields = {}
        streams = seed_sequence(seed, 0).spawn(len(config["fields"]))
        for spec, ss in zip(config["fields"], streams):
            if only is not None and spec["name"] not in only:
                continue
            f = Field(spec)
            _generate(f, np.random.default_rng(ss), self.blocks, self.width)
            self.fields[f.name] = f

    def plane_bytes(self) -> int:
        """Bytes of one row over every shard: one plane of the stack."""
        return self.shards * self.words * 4


def _generate(f: Field, rng: np.random.Generator, blocks: int, width: int) -> None:
    spec = f.spec
    if f.kind == "categorical":
        p = categorical_p(spec)
        cats = rng.choice(f.rows, (blocks, width), p=p).astype(np.int16)
        if spec.get("cover"):
            cats[:, : f.rows] = np.arange(f.rows, dtype=np.int16)
        f.cats = cats
    elif f.kind == "int":
        mix = spec["mix"]
        shares = np.array([m[0] for m in mix], dtype=np.float64)
        part = rng.choice(len(mix), (blocks, width), p=shares / shares.sum())
        vals = np.zeros((blocks, width), dtype=np.int64)
        for i, (_share, lo, hi) in enumerate(mix):
            sel = part == i
            vals[sel] = rng.integers(int(lo), int(hi) + 1, int(sel.sum()))
        has = rng.random((blocks, width)) >= float(spec.get("missing", 0.0))
        for k, (g, value) in enumerate(spec.get("pin", [])):
            vals[int(g) % blocks, k] = int(value)
            has[int(g) % blocks, k] = True
        if vals[has].min() < f.min or vals[has].max() > f.max:
            raise ValueError(f"{f.name}: values outside [{f.min}, {f.max}]")
        f.vals, f.has = vals, has
    else:
        raise ValueError(f"{f.name}: unknown field kind {f.kind!r}")


def categorical_p(spec: dict) -> np.ndarray:
    rows = int(spec["rows"])
    if "p" in spec:
        p = np.asarray(spec["p"], dtype=np.float64)
        if p.size != rows:
            raise ValueError(f"{spec['name']}: {p.size} probabilities for {rows} rows")
    else:
        p = np.empty(rows, dtype=np.float64)
        p[0] = float(spec["p0"])
        tail = float(spec["ratio"]) ** np.arange(rows - 1)
        p[1:] = (1.0 - p[0]) * tail / tail.sum()
    return p / p.sum()
