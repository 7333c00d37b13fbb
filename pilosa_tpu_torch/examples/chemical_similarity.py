"""Chemical-similarity demo: Tanimoto search over molecule fingerprints.

The port of examples/chemical_similarity.py: the reference's
chemical-similarity use case (molecule fingerprints stored one per row,
searched by Tanimoto coefficient). The one-vs-all search is one scan of
the packed matrix (K9) and an exact top-k (K10); the all-pairs block is
one launch of K11 (pilosa_tpu_torch/ops/similarity.py).

Run:

    python -m pilosa_tpu_torch.examples.chemical_similarity --molecules 8192

``--device cpu`` runs the plain torch versions. Fingerprints are
synthetic 2048-bit Morgan-style vectors; structural families share a
base pattern so the search has real signal.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pilosa_tpu_torch.ops import similarity

FP_BITS = 2048
FP_WORDS = FP_BITS // 32


def make_fingerprints(n: int, n_families: int = 64, seed: int = 3):
    """uint32[n, FP_WORDS]: family base pattern + per-molecule noise."""
    rng = np.random.default_rng(seed)
    fams = rng.integers(0, 2**32, (n_families, FP_WORDS), dtype=np.uint32)
    fams &= rng.integers(0, 2**32, (n_families, FP_WORDS), dtype=np.uint32)
    family = rng.integers(0, n_families, n)
    noise = rng.integers(0, 2**32, (n, FP_WORDS), dtype=np.uint32)
    noise &= rng.integers(0, 2**32, (n, FP_WORDS), dtype=np.uint32)
    noise &= rng.integers(0, 2**32, (n, FP_WORDS), dtype=np.uint32)
    return fams[family] | noise, family


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: "list[str] | None" = None) -> dict:
    """Run the demo; returns the search's (scores, ids) and the number of
    pairs at or above the threshold, as numpy values."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--molecules", type=int, default=8192)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--threshold", type=float, default=0.3)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    fps, family = make_fingerprints(args.molecules)
    print(f"{args.molecules:,} molecules × {FP_BITS}-bit fingerprints "
          f"({fps.nbytes / 1e6:.1f} MB packed)")

    device = torch.device(args.device)
    matrix = similarity.as_words(fps, device)
    query = matrix[17]  # pick a molecule; its family-mates should surface

    # ---- one-vs-all Tanimoto top-k (one scan, then an exact top-k)
    similarity.tanimoto_search(matrix, query, k=args.k, device=device)  # warm
    _sync(device)
    t0 = time.perf_counter()
    scores, ids = similarity.tanimoto_search(matrix, query, k=args.k, device=device)
    scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
    dt = (time.perf_counter() - t0) * 1e3
    print(f"\ntop-{args.k} Tanimoto neighbours of molecule 17 "
          f"(family {family[17]})  [{dt:.2f} ms]:")
    for s, i in zip(scores, ids):
        print(f"    molecule {i:6d}  family {family[i]:3d}  tanimoto={s:.3f}")

    # ---- all-pairs block: one launch
    n_block = min(args.molecules, 2048)
    block = matrix[:n_block]
    similarity.tanimoto_matrix(block, block, device=device)  # warm
    _sync(device)
    t0 = time.perf_counter()
    sims = similarity.tanimoto_matrix(block, block, device=device)
    _sync(device)
    dt = (time.perf_counter() - t0) * 1e3
    n_pairs = n_block * n_block
    above = int((sims >= args.threshold).sum()) - n_block
    print(f"\nall-pairs {n_block}×{n_block} Tanimoto matrix in {dt:.1f} ms "
          f"({n_pairs / (dt / 1e3) / 1e6:,.0f}M pairs/s)")
    print(f"pairs ≥ {args.threshold}: {above // 2:,} (excluding self-pairs)")
    return {"scores": scores, "ids": ids, "pairs_above": above // 2}


if __name__ == "__main__":
    main()
