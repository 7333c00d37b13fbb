"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and the configuration's fields, and makes
each client's queries from the seed.

A mix file holds:

- ``clients``: closed-loop clients, each on one keep-alive connection;
- ``fields``: the configuration's fields the mix reads; only these are
  made, loaded and stacked;
- ``warmup``: queries each client sends before the window;
- ``rate_cap``: the most queries a second one client could answer;
  each client gets ``rate_cap`` × seconds queries (it cycles past the
  end, which a sound cap never reaches);
- ``check``: the share of the window's answers whose bodies the client
  keeps, and ``check_max``, the most of them the reference checks;
- ``templates``: ``{"name", "weight", "pql", "slots"}``. ``pql`` is the
  text with ``{slot}`` holes; each slot is one of

  - ``row``: a row id of ``field``. A template's ``row`` slots together
    span a grid, every combination of their rows. The grid is dealt to
    the clients once a run, in an order drawn from the seed, client
    ``c`` taking every ``clients``-th combination; each client sends
    its share in a shuffled order, and again in another once it is
    through. So no two clients send one text, and a client repeats one
    only after its whole share;
  - ``tree``: a set-operation tree over rows of ``field``: ``leaves``
    [lo, hi], ``ops``, and ``depth`` (1: one call over rows; 2: its
    children may be calls over rows);
  - ``int_band``: ``Row(lo <= field <= hi)`` with ``lo`` drawn from
    [a, b] and the width from [c, d];
  - ``ids``: ``[r1, ...]``, ``count`` [lo, hi] distinct rows of
    ``field``.

Every seed gives each client the same work in another order: each
discrete choice (the template, by its whole ``weight``; a tree's leaf
count; an ``ids`` count) is dealt from a shuffled deck that holds each
option as often as its weight, and each range of ``int_band`` from a
deck of eight equal strata, a value drawn inside the stratum.
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np

from portbench.data import seed_sequence

STRATA = 8


class Decks:
    """One client's shuffled decks, each refilled when dealt out, and its
    shares of the templates' grids."""

    def __init__(self, rng, shares: dict):
        self.rng = rng
        self.shares = shares  # template index → [combination]
        self.decks: dict = {}

    def _pop(self, key, fill: list):
        deck = self.decks.get(key)
        if not deck:
            deck = list(fill)
            self.rng.shuffle(deck)
            self.decks[key] = deck
        return deck.pop()

    def deal(self, key, weights: list) -> int:
        """An index into ``weights``, dealt from the deck ``key``."""
        return self._pop(key, [i for i, w in enumerate(weights) for _ in range(int(w))])

    def combination(self, k: int) -> tuple:
        """The next row combination of template ``k``'s share."""
        return self._pop(("grid", k), self.shares[k])

    def uniform(self, key, lo: int, hi: int) -> int:
        """A whole number in [lo, hi], from a stratum dealt from a deck."""
        k = self.deal(key, [1] * STRATA)
        a = lo + (hi - lo + 1) * k // STRATA
        b = lo + (hi - lo + 1) * (k + 1) // STRATA - 1
        return int(self.rng.integers(a, max(a, b) + 1))


class Mix:
    def __init__(self, spec: dict, fields: dict):
        self.name = spec["name"]
        self.clients = int(spec["clients"])
        self.fields_read = list(spec["fields"])
        self.warmup = int(spec["warmup"])
        self.rate_cap = float(spec["rate_cap"])
        self.check = float(spec["check"])
        self.check_max = int(spec["check_max"])
        self.templates = spec["templates"]
        self.fields = fields  # name → data.Field (for rows)
        self.weights = [int(t["weight"]) for t in self.templates]

    def grid_slots(self, k: int) -> list:
        return [name for name, s in self.templates[k].get("slots", {}).items() if s["kind"] == "row"]

    def _decks(self, rng, clients: int) -> list:
        """Each client's decks, with its share of every template's grid."""
        shares = [{} for _ in range(clients)]
        for k, t in enumerate(self.templates):
            slots = self.grid_slots(k)
            if not slots:
                continue
            grid = list(itertools.product(*(range(self.fields[t["slots"][n]["field"]].rows) for n in slots)))
            if len(grid) < clients:
                raise ValueError(f"{self.name}: template {t['name']} has fewer texts than clients")
            order = rng.permutation(len(grid))
            for c in range(clients):
                shares[c][k] = [grid[i] for i in order[c::clients]]
        return [Decks(rng, s) for s in shares]

    def plan(self, seed: int, seconds: float) -> dict:
        """``{"warm": [[pql]...], "queries": [[pql]...], "kinds":
        [[template index]...], "keep": [[position]...]}``, one list per
        client, all drawn from ``seed``."""
        rng = np.random.default_rng(seed_sequence(seed, 1))
        per_client = max(1, math.ceil(self.rate_cap * seconds))
        decks = self._decks(rng, self.clients)
        warm = [[self._query(decks[c])[1] for _ in range(self.warmup)] for c in range(self.clients)]
        queries, kinds, keep = [], [], []
        for c in range(self.clients):
            drawn = [self._query(decks[c]) for _ in range(per_client)]
            kinds.append([k for k, _ in drawn])
            queries.append([q for _, q in drawn])
            keep.append(np.flatnonzero(rng.random(per_client) < self.check).tolist())
        return {"warm": warm, "queries": queries, "kinds": kinds, "keep": keep}

    def first_of_each(self, seed: int) -> list[str]:
        """One query of each template, for the sequential warm-up that
        builds each template's shapes once, before clients run together."""
        (decks,) = self._decks(np.random.default_rng(seed_sequence(seed, 2)), 1)
        return [self._fill(decks, k) for k in range(len(self.templates))]

    def _query(self, decks: Decks) -> tuple[int, str]:
        k = decks.deal("template", self.weights)
        return k, self._fill(decks, k)

    def _fill(self, decks: Decks, k: int) -> str:
        t = self.templates[k]
        slots = t.get("slots", {})
        grid = self.grid_slots(k)
        values = dict(zip(grid, (str(int(r)) for r in decks.combination(k)))) if grid else {}
        for name, s in slots.items():
            if name not in values:
                values[name] = self._slot(decks, (k, name), s)
        return t["pql"].format(**values)

    def _slot(self, decks: Decks, key: tuple, s: dict) -> str:
        kind = s["kind"]
        rng = decks.rng
        if kind == "tree":
            return self._tree(decks, key, s)
        if kind == "int_band":
            lo = decks.uniform(key + ("lo",), *s["lo"])
            hi = lo + decks.uniform(key + ("width",), *s["width"])
            return f"Row({lo} <= {s['field']} <= {hi})"
        if kind == "ids":
            rows = self.fields[s["field"]].rows
            n = s["count"][0] + decks.deal(key, [1] * (s["count"][1] - s["count"][0] + 1))
            return "[" + ", ".join(str(int(r)) for r in rng.choice(rows, n, replace=False)) + "]"
        raise ValueError(f"{self.name}: unknown slot kind {kind!r}")

    def _tree(self, decks: Decks, key: tuple, s: dict) -> str:
        rng = decks.rng
        lo, hi = s["leaves"]
        n = lo + decks.deal(key, [1] * (hi - lo + 1))
        rows = self.fields[s["field"]].rows
        leaves = [f"Row({s['field']}={int(r)})" for r in rng.integers(0, rows, n)]
        if n == 1:
            return leaves[0]
        ops = s["ops"]
        if int(s.get("depth", 1)) >= 2 and n >= 3 and rng.random() < 0.5:
            # one nested call over a run of 2..n-1 leaves, the rest flat
            k = int(rng.integers(2, n))
            at = int(rng.integers(0, n - k + 1))
            inner = f"{ops[int(rng.integers(len(ops)))]}({', '.join(leaves[at:at + k])})"
            leaves = leaves[:at] + [inner] + leaves[at + k:]
        return f"{ops[int(rng.integers(len(ops)))]}({', '.join(leaves)})"


def read_spec(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load(path: str, fields: dict) -> Mix:
    return Mix(read_spec(path), fields)
