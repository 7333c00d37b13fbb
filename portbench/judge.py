"""The comparison that decides ``correct``.

What is compared: the answers the window itself returned, the JSON
that came back through the front end, each against the reference's
answer to the same query. The clients keep the body of a seeded share
of the window's requests (the mix's ``check``); of those that were
answered, a seeded sample of at most ``check_max`` is compared. The
numbers compared, each with its limit:

- ``wrong``: compared answers that differ from the reference's (limit
  0: the configurations state exact answers);
- ``errors``: requests of the warm-up and the window that got no
  answer or an error status (limit 0: no query of these mixes fails);
- ``checked``: answers compared (at least ``MIN_CHECKED``).
"""

from __future__ import annotations

import numpy as np

from portbench.data import seed_sequence
from portbench.reference import Reference

LIMITS = {"wrong": 0, "errors": 0}
MIN_CHECKED = 1


def sample(results: list, check_max: int, seed: int) -> list:
    """[(client, position)] of the kept answers to compare, drawn from
    the seed where there are more than ``check_max``."""
    kept = sorted((c, int(pos)) for c, res in enumerate(results) for pos in res["bodies"])
    if len(kept) <= check_max:
        return kept
    rng = np.random.default_rng(seed_sequence(seed, 3))
    pick = np.sort(rng.choice(len(kept), check_max, replace=False))
    return [kept[i] for i in pick]


def compare(ref: Reference, plan: dict, results: list, picks: list) -> tuple:
    """(number wrong, the first few differences) over ``picks``."""
    wrong, examples = 0, []
    for c, pos in picks:
        queries = plan["queries"][c]
        pql = queries[pos % len(queries)]
        got = results[c]["bodies"][str(pos)]  # JSON keys are strings
        want = ref.answer(pql)
        if not got or got[-1] != want:
            wrong += 1
            if len(examples) < 3:
                examples.append({"pql": pql[:200], "got": str(got[-1] if got else got)[:300], "want": str(want)[:300]})
    return wrong, examples


def verdict(numbers: dict) -> bool:
    return (all(numbers[k] <= lim for k, lim in LIMITS.items())
            and numbers["checked"] >= MIN_CHECKED)


def lines(numbers: dict) -> dict:
    """The compared numbers beside their limits, as the result line
    carries them."""
    out = {k: {"value": numbers[k], "limit": lim} for k, lim in LIMITS.items()}
    out["checked"] = {"value": numbers["checked"], "limit": MIN_CHECKED}
    return out
