"""pilosa_tpu_torch.ops.similarity against pilosa_tpu.ops.similarity.

Inputs are made with numpy from a seed and handed to both packages; the
port runs its plain torch versions on the CPU (``device="cpu"``), the
reference its jnp programs on the CPU. The search is held exactly: ids
and scores bit for bit, ties to the lower row, the zero-score tail in
row order, k clamped to R, the threshold compared in f32. The all-pairs
matrices are held exactly too, cosine included: the plain versions round
the division and the square root correctly, as the reference's f32
program does on the CPU.
"""

import os

import jax
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import similarity as ref
from pilosa_tpu_torch.examples import chemical_similarity as demo
from pilosa_tpu_torch.ops import _cuda
from pilosa_tpu_torch.ops import similarity as sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fingerprints(seed: int, n: int, w: int) -> np.ndarray:
    """uint32[n, w], about a quarter of the bits set, with edge rows where
    they fit: a duplicate of row 0 (the query's tie), all ones, bit 31
    only, zero, and a second duplicate of row 0."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    m &= rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    edges = {1: m[0].copy(), 2: 0xFFFFFFFF, 3: 0x80000000, 4: 0, 6: m[0].copy()}
    for row, value in edges.items():
        if row < n:
            m[row] = value
    return m


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def _assert_search_equal(matrix, query, k, threshold):
    want_s, want_i = ref.tanimoto_search(matrix, query, k=k, threshold=threshold)
    got_s, got_i = sim.tanimoto_search(matrix, query, k=k, threshold=threshold, device="cpu")
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    assert np.array_equal(got_i.numpy(), np.asarray(want_i)), (got_i, want_i)
    assert np.array_equal(_bits(got_s.numpy()), _bits(want_s))
    plain_s, plain_i = sim.tanimoto_search_plain(
        sim.as_words(matrix, "cpu"), sim.as_words(query, "cpu"), k, float(np.float32(threshold)))
    assert torch.equal(plain_i, got_i) and torch.equal(plain_s.view(torch.int32), got_s.view(torch.int32))


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.9, 1.0])
@pytest.mark.parametrize("k_of", ["1", "5", "R", "R+30"])
@pytest.mark.parametrize("n_rows", [1, 7, 50, 300])
def test_search_matches_reference(n_rows, k_of, threshold):
    k = {"1": 1, "5": 5, "R": n_rows, "R+30": n_rows + 30}[k_of]
    m = _fingerprints(n_rows, n_rows, 64)
    zero = np.zeros(64, dtype=np.uint32)
    other = _fingerprints(1000 + n_rows, 1, 64)[0]
    for query in (m[0], zero, m[min(2, n_rows - 1)], other):
        _assert_search_equal(m, query, k, threshold)


def test_ties_go_to_the_lower_row_and_the_zero_tail_stays_in_row_order():
    m = _fingerprints(5, 20, 64)
    m[3] = m[4] = m[10]
    m[1] = m[6] = m[2]  # undo the edge duplicates of row 0
    q = m[10].copy()
    m[10] = _fingerprints(6, 1, 64)[0]
    scores, ids = sim.tanimoto_search(m, q, k=12, threshold=0.9, device="cpu")
    assert scores.tolist()[:3] == [1.0, 1.0, 0.0]
    assert ids.tolist() == [3, 4, 0, 1, 2, 5, 6, 7, 8, 9, 10, 11]
    _assert_search_equal(m, q, 12, 0.9)


def test_threshold_is_compared_in_f32():
    # a score of exactly f32(1/3); the threshold 0.33333335 rounds to it in
    # f32 but is larger as a double, so a double compare would drop the row
    m = np.zeros((5, 2), dtype=np.uint32)
    m[1, 0] = 1
    q = np.array([7, 0], dtype=np.uint32)
    scores, ids = sim.tanimoto_search(m, q, k=3, threshold=0.33333335, device="cpu")
    assert ids.tolist() == [1, 0, 2] and float(scores[0]) == float(np.float32(1) / np.float32(3))
    _assert_search_equal(m, q, 3, 0.33333335)


def test_k_is_clamped_to_r_and_zero_rows_score_zero():
    m = _fingerprints(8, 20, 64)
    m[:] = 0
    scores, ids = sim.tanimoto_search(m, np.zeros(64, np.uint32), k=50, device="cpu")
    assert ids.tolist() == list(range(20)) and not scores.any()
    _assert_search_equal(m, np.zeros(64, np.uint32), 50, 0.0)
    empty = sim.tanimoto_search(m, m[0], k=0, device="cpu")
    assert empty[0].shape == (0,) and empty[1].shape == (0,)
    with pytest.raises(ValueError):
        sim.tanimoto_search(m, m[0], k=-1, device="cpu")


@pytest.mark.parametrize("w", [1, 3, 64, 512])
def test_search_at_every_width_matches_reference(w):
    m = _fingerprints(w, 90, w)
    for threshold in (0.0, 0.3):
        _assert_search_equal(m, m[0], 15, threshold)


def test_search_keys_and_select_top_plain_pieces():
    m = torch.from_numpy(_fingerprints(9, 300, 64).view(np.int32))
    q = m[0].clone()
    keys, hist = sim.search_keys(m, q, 0.3)
    assert keys.dtype == torch.int64 and hist.dtype == torch.int32 and hist.shape == (sim.SELECT_BINS,)
    assert torch.equal(hist.long(), torch.bincount(keys >> sim.SELECT_SHIFTS[0], minlength=sim.SELECT_BINS))
    assert torch.unique(keys).numel() == keys.numel()  # distinct: the order is unique
    assert int(keys.max()) < 1 << 62
    for k in (1, 10, 300):
        s, i = sim.select_top(keys, hist, k)
        want_s, want_i = ref.tanimoto_search(m.numpy().view(np.uint32), q.numpy().view(np.uint32), k=k, threshold=0.3)
        assert np.array_equal(i.numpy(), np.asarray(want_i))
        assert np.array_equal(_bits(s.numpy()), _bits(want_s))
    with pytest.raises(ValueError):
        sim.select_top(keys, hist, 301)
    with pytest.raises(ValueError):
        sim.search_keys(m, m[:2, 0].clone(), 0.0)


@pytest.mark.parametrize("mode", ["inter", "tanimoto", "cosine"])
@pytest.mark.parametrize("w", [1, 3, 7, 8, 9, 33, 64, 512])
def test_pairwise_matches_reference(w, mode):
    """Exact: every f32 of the three matrices bit-equal to the
    reference's. W around K11's 8-word k-step (7, 8, 9, 33) and its
    16-word tiles, N and M at 1 and around its 128-row tiles' quarters
    (63, 65, 129), with all-ones, bit-31-only and zero rows."""
    fn = {"inter": "pairwise_intersections", "tanimoto": "tanimoto_matrix", "cosine": "cosine_matrix"}[mode]
    # the reference's function as one program: one compile per shape
    ref_fn = jax.jit(getattr(ref, fn))
    for n, m in ((64, 37), (1, 129), (129, 1), (63, 65)):
        a = _fingerprints(100 + w + n, n, w)
        b = _fingerprints(200 + w + m, m, w)
        if n > 3 and m > 5:
            b[5] = a[3]  # a duplicate pair: tanimoto and cosine 1.0
        want = np.asarray(ref_fn(a, b))
        got = getattr(sim, fn)(a, b, device="cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == (n, m)
        assert np.array_equal(_bits(got.numpy()), _bits(want)), (n, m)
        assert np.array_equal(_bits(sim.pairwise_plain(torch.from_numpy(a.view(np.int32)),
                                                       torch.from_numpy(b.view(np.int32)), mode).numpy()), _bits(want))


def test_unpack_bits_matches_reference():
    a = _fingerprints(4, 7, 3)
    want = np.asarray(ref._unpack_bits_bf16(a)).astype(np.float32)
    assert np.array_equal(sim.unpack_bits(torch.from_numpy(a.view(np.int32))).numpy(), want)


def test_wrappers_check_their_inputs():
    a = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        sim.pairwise(a, a, "jaccard")
    with pytest.raises(ValueError):
        sim.pairwise(a, torch.zeros((4, 2), dtype=torch.int32), "inter")
    with pytest.raises(ValueError):
        sim.pairwise(a.to(torch.int64), a, "inter")
    with pytest.raises(ValueError):
        sim.as_words(np.zeros((2, 2), dtype=np.uint64), "cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    m = _fingerprints(3, 4, 2)
    for call in (lambda: sim.tanimoto_search(m, m[0]), lambda: sim.tanimoto_matrix(m, m),
                 lambda: sim.cosine_matrix(m, m), lambda: sim.pairwise_intersections(m, m)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_kernels_name_their_reference_lines():
    with open(f"{REPO}/pilosa_tpu/ops/similarity.py") as fh:
        lines = fh.read().splitlines()
    want = {"sim_scan": "def tanimoto_search(", "sim_select": "def tanimoto_search(",
            "pairwise": "def pairwise_intersections("}
    for name, start in want.items():
        kern = _cuda.KERNELS[name]
        path, line = kern.replaces.split(":")
        assert path == "pilosa_tpu/ops/similarity.py" and lines[int(line) - 1].startswith(start), kern.replaces
        assert kern.stem in _cuda.SOURCES


def test_demo_runs_on_the_cpu_and_matches_reference(capsys):
    out = demo.main(["--molecules", "256", "--device", "cpu"])
    fps, family = demo.make_fingerprints(256)
    want_s, want_i = ref.tanimoto_search(fps, fps[17], k=10)
    assert np.array_equal(out["ids"], np.asarray(want_i))
    assert np.array_equal(_bits(out["scores"]), _bits(want_s))
    assert family[out["ids"][1]] == family[17]  # a family-mate is the nearest other
    sims = np.asarray(ref.tanimoto_matrix(fps, fps))
    assert out["pairs_above"] == (int((sims >= 0.3).sum()) - 256) // 2
    text = capsys.readouterr().out
    assert "top-10 Tanimoto neighbours of molecule 17" in text and "all-pairs 256×256" in text
