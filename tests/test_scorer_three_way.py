"""Three-way fuzz of the stage-2 scorer: Python oracle automaton vs
C++ port vs the run-grouped brute-force witness (tests/witness_brute.py).

All three were written from sketch/BottomOverlapSketch.java separately
and with different structure (flat-cursor automaton / flat-cursor C++ /
run-grouped merge): a common-mode misreading of the Java would have to
occur three times independently to pass this suite.
"""

import numpy as np
import pytest

from witness_brute import brute_overlap_info


@pytest.fixture(scope="module")
def cpp_score():
    from mhap_tpu.utils.native import score_pair

    return score_pair


def _mk_sketch(rng, n, nk, alphabet, pos_max=None):
    pos_max = pos_max or nk
    h = rng.choice(alphabet, n)
    p = rng.choice(pos_max, size=n, replace=(n > pos_max))
    order = np.lexsort((p, h))
    return np.stack([h[order], p[order]], axis=1).astype(np.int32)


def _assert_three(want_o, got_c, got_b, ctx):
    assert want_o == got_c, ("oracle vs C++", ctx, want_o, got_c)
    assert want_o == got_b, ("oracle vs brute", ctx, want_o, got_b)


def test_three_way_duplicate_runs(cpp_score):
    """Small hash alphabets => long duplicate runs on both sides,
    stressing the :457-506 extension pairing in all three."""
    from mhap_tpu.oracle.scorer import get_overlap_info

    rng = np.random.default_rng(31)
    for t in range(300):
        alpha_sz = int(rng.integers(2, 16))
        alphabet = rng.integers(-2**31, 2**31 - 1, alpha_sz).astype(np.int64)
        n1 = int(rng.integers(3, 60))
        n2 = int(rng.integers(3, 60))
        nk1 = int(rng.integers(n1, 4 * n1 + 5))
        nk2 = int(rng.integers(n2, 4 * n2 + 5))
        s1 = _mk_sketch(rng, n1, nk1, alphabet)
        s2 = _mk_sketch(rng, n2, nk2, alphabet)
        _assert_three(get_overlap_info(s1, nk1, s2, nk2, 12, 0.2),
                      cpp_score(s1, nk1, s2, nk2),
                      brute_overlap_info(s1, nk1, s2, nk2, 12, 0.2),
                      f"trial {t}")


def test_three_way_diagonal(cpp_score):
    """Realistic shifted-diagonal structure + noise: two-pass window
    re-filter, median shift, optimizeShifts, UMVU edges."""
    from mhap_tpu.oracle.scorer import get_overlap_info

    rng = np.random.default_rng(32)
    for t in range(200):
        nk = int(rng.integers(50, 400))
        shift = int(rng.integers(-nk // 2, nk // 2))
        n_shared = int(rng.integers(3, 30))
        shared_h = rng.integers(-2**31, 2**31 - 1, n_shared)
        p1 = rng.choice(nk, n_shared, replace=False)
        p2 = np.clip(p1 + shift + rng.integers(-5, 6, n_shared), 0, nk - 1)
        rows1 = [(shared_h[i], p1[i]) for i in range(n_shared)]
        rows2 = [(shared_h[i], p2[i]) for i in range(n_shared)]
        for _ in range(int(rng.integers(0, 20))):
            rows1.append((rng.integers(-2**31, 2**31 - 1),
                          rng.integers(0, nk)))
            rows2.append((rng.integers(-2**31, 2**31 - 1),
                          rng.integers(0, nk)))
        s1 = np.asarray(sorted(rows1), np.int32).reshape(-1, 2)
        s2 = np.asarray(sorted(rows2), np.int32).reshape(-1, 2)
        _assert_three(get_overlap_info(s1, nk, s2, nk, 12, 0.2),
                      cpp_score(s1, nk, s2, nk),
                      brute_overlap_info(s1, nk, s2, nk, 12, 0.2),
                      f"trial {t}")


def test_three_way_window_truncated_runs(cpp_score):
    """Runs whose position spread straddles the pass-2 validity window:
    the extension must stop at the FIRST invalid entry (not skip it),
    and the post-jump cursor may land mid-run.  This is the structural
    corner where a run-grouped and a flat-cursor reading could diverge."""
    from mhap_tpu.oracle.scorer import get_overlap_info

    rng = np.random.default_rng(33)
    for t in range(300):
        A = int(rng.integers(2, 7))
        alphabet = np.unique(rng.integers(-2**31, 2**31 - 1, A))
        nk = int(rng.integers(40, 3000))
        base = int(rng.integers(0, nk // 2))
        pool = np.unique(np.concatenate([
            base + rng.integers(0, 25, 10),
            rng.integers(0, nk, 10)]))
        rows1, rows2 = [], []
        for h in alphabet:
            for p in np.sort(rng.choice(pool,
                                        size=int(rng.integers(1, 6)),
                                        replace=False)):
                rows1.append((int(h), int(p)))
            for p in np.sort(rng.choice(pool,
                                        size=int(rng.integers(1, 6)),
                                        replace=False)):
                rows2.append((int(h), int(p)))
        s1 = np.asarray(sorted(rows1), np.int32)
        s2 = np.asarray(sorted(rows2), np.int32)
        _assert_three(get_overlap_info(s1, nk, s2, nk, 12, 0.2),
                      cpp_score(s1, nk, s2, nk),
                      brute_overlap_info(s1, nk, s2, nk, 12, 0.2),
                      f"trial {t}")


def test_three_way_umvu_wrap(cpp_score):
    """Huge coordinates drive the Java int32 wrap in border and UMVU
    math -- the corner the r2 differential fuzz caught in the oracle."""
    from mhap_tpu.oracle.scorer import get_overlap_info

    rng = np.random.default_rng(34)
    big = 2**30
    for t in range(100):
        nk = big + int(rng.integers(0, 2**29))
        h = rng.integers(-2**31, 2**31 - 1, 8)
        p1 = np.sort(rng.integers(big - 1000, nk, 8))
        p2 = np.sort(rng.integers(big - 1000, nk, 8))
        s1 = np.stack([np.sort(h), p1], 1).astype(np.int32)
        s2 = np.stack([np.sort(h), p2], 1).astype(np.int32)
        _assert_three(get_overlap_info(s1, nk, s2, nk, 12, 0.2),
                      cpp_score(s1, nk, s2, nk),
                      brute_overlap_info(s1, nk, s2, nk, 12, 0.2),
                      f"trial {t}")


def test_three_way_real_sketches(cpp_score):
    """End-to-end shaped input: real BottomOverlapSketch pairs built by
    the oracle sketcher from noisy overlapping reads."""
    from mhap_tpu.oracle.scorer import get_overlap_info
    from mhap_tpu.oracle.sketch import bottom_sketch

    rng = np.random.default_rng(35)
    bases = "ACGT"
    for t in range(20):
        glen = 3000
        genome = rng.integers(0, 4, glen)

        def noisy(seg):
            out = []
            for b in seg:
                r = rng.random()
                if r < 0.03:
                    continue
                if r < 0.07:
                    out.append(int(rng.integers(0, 4)))
                out.append(int(b) if r >= 0.10 else int(rng.integers(0, 4)))
            return "".join(bases[x] for x in out)

        cut = int(rng.integers(500, 1500))
        r1 = noisy(genome[:cut + 1000])
        r2 = noisy(genome[cut:])
        k2, ssize = 12, 256
        h1, nk1 = bottom_sketch(r1, k2, ssize)
        h2, nk2 = bottom_sketch(r2, k2, ssize)
        s1 = np.asarray(h1, np.int32).reshape(-1, 2)
        s2 = np.asarray(h2, np.int32).reshape(-1, 2)
        _assert_three(get_overlap_info(s1, nk1, s2, nk2, k2, 0.2),
                      cpp_score(s1, nk1, s2, nk2, k2=k2),
                      brute_overlap_info(s1, nk1, s2, nk2, k2, 0.2),
                      f"trial {t}")
