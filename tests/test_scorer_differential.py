"""Differential fuzz of the stage-2 scorer: the Python oracle automaton
(mhap_tpu/oracle/scorer.py) vs the independently written C++ port
(native/scorer.h via libmhapnative.so).

Both were derived from sketch/BottomOverlapSketch.java separately; exact
agreement on adversarial inputs targets the semantics that were once
single-sourced: duplicate-run cursor extension
(recordMatchingKmers :457-506), one-sided shift-window advances,
optimizeShifts dedup (:156-189), UMVU rounding/int32 wrap (:128-135), and
the windowed bottom-k Jaccard merge (:304-364).
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def cpp_score():
    from mhap_tpu.utils.native import score_pair

    return score_pair


def _mk_sketch(rng, n, nk, alphabet, pos_max=None):
    """Hash-sorted (hash, pos) sketch with duplicate runs (small hash
    alphabet => long runs) and increasing positions within a run, matching
    the stable-sort invariant of BottomOverlapSketch construction."""
    pos_max = pos_max or nk
    h = rng.choice(alphabet, n)
    p = rng.choice(pos_max, size=n, replace=(n > pos_max))
    order = np.lexsort((p, h))
    return np.stack([h[order], p[order]], axis=1).astype(np.int32)


def _assert_same(oracle_out, cpp_out, ctx):
    assert oracle_out[2:] == cpp_out[2:], (ctx, oracle_out, cpp_out)
    assert oracle_out[1] == cpp_out[1], (ctx, oracle_out, cpp_out)
    assert oracle_out[0] == pytest.approx(cpp_out[0], abs=0.0), \
        (ctx, oracle_out, cpp_out)


def test_duplicate_run_fuzz(cpp_score):
    """Small hash alphabets force duplicate runs on both sides."""
    from mhap_tpu.oracle.scorer import get_overlap_info

    rng = np.random.default_rng(1)
    for t in range(400):
        alpha_sz = int(rng.integers(2, 20))
        alphabet = rng.integers(-2**31, 2**31 - 1, alpha_sz).astype(np.int64)
        n1 = int(rng.integers(3, 60))
        n2 = int(rng.integers(3, 60))
        nk1 = int(rng.integers(n1, 4 * n1 + 5))
        nk2 = int(rng.integers(n2, 4 * n2 + 5))
        s1 = _mk_sketch(rng, n1, nk1, alphabet)
        s2 = _mk_sketch(rng, n2, nk2, alphabet)
        got_o = get_overlap_info(s1, nk1, s2, nk2, 12, 0.2)
        got_c = cpp_score(s1, nk1, s2, nk2)
        _assert_same(got_o, got_c, f"trial {t}")


def test_diagonal_overlap_fuzz(cpp_score):
    """Shifted-diagonal matches (realistic overlap structure) with noise,
    stressing the two-pass window re-filter and median shift."""
    from mhap_tpu.oracle.scorer import get_overlap_info

    rng = np.random.default_rng(2)
    for t in range(300):
        nk = int(rng.integers(50, 400))
        shift = int(rng.integers(-nk // 2, nk // 2))
        n_shared = int(rng.integers(3, 30))
        shared_h = rng.integers(-2**31, 2**31 - 1, n_shared)
        p1 = rng.choice(nk, n_shared, replace=False)
        p2 = np.clip(p1 + shift + rng.integers(-5, 6, n_shared), 0, nk - 1)
        n_noise = int(rng.integers(0, 20))
        rows1 = [(shared_h[i], p1[i]) for i in range(n_shared)]
        rows2 = [(shared_h[i], p2[i]) for i in range(n_shared)]
        for _ in range(n_noise):
            rows1.append((rng.integers(-2**31, 2**31 - 1),
                          rng.integers(0, nk)))
            rows2.append((rng.integers(-2**31, 2**31 - 1),
                          rng.integers(0, nk)))
        s1 = np.asarray(sorted(rows1), np.int32).reshape(-1, 2)
        s2 = np.asarray(sorted(rows2), np.int32).reshape(-1, 2)
        got_o = get_overlap_info(s1, nk, s2, nk, 12, 0.2)
        got_c = cpp_score(s1, nk, s2, nk)
        _assert_same(got_o, got_c, f"trial {t}")


def test_same_pos1_optimize_shifts(cpp_score):
    """Adjacent same-pos1 matches: optimizeShifts keep-closest-to-median."""
    from mhap_tpu.oracle.scorer import get_overlap_info

    rng = np.random.default_rng(3)
    for t in range(200):
        nk = int(rng.integers(30, 120))
        alphabet = rng.integers(-2**31, 2**31 - 1, 4)
        n1 = int(rng.integers(4, 25))
        # few distinct positions -> repeated pos1 after dedup windows
        s1 = _mk_sketch(rng, n1, nk, alphabet, pos_max=max(3, nk // 8))
        s2 = _mk_sketch(rng, n1, nk, alphabet, pos_max=max(3, nk // 8))
        got_o = get_overlap_info(s1, nk, s2, nk, 12, 0.2)
        got_c = cpp_score(s1, nk, s2, nk)
        _assert_same(got_o, got_c, f"trial {t}")


def test_extreme_positions_umvu_wrap(cpp_score):
    """Huge positions/num_kmers drive the UMVU int32 wrap semantics
    ((int)(n*lo - hi), BottomOverlapSketch.java:131-134)."""
    from mhap_tpu.oracle.scorer import get_overlap_info

    rng = np.random.default_rng(4)
    big = 2**30
    for t in range(100):
        nk = big + int(rng.integers(0, 2**29))
        h = rng.integers(-2**31, 2**31 - 1, 8)
        p1 = np.sort(rng.integers(big - 1000, nk, 8))
        p2 = np.sort(rng.integers(big - 1000, nk, 8))
        s1 = np.stack([np.sort(h), p1], 1).astype(np.int32)
        s2 = np.stack([np.sort(h), p2], 1).astype(np.int32)
        got_o = get_overlap_info(s1, nk, s2, nk, 12, 0.2)
        got_c = cpp_score(s1, nk, s2, nk)
        _assert_same(got_o, got_c, f"trial {t}")


def test_fast_device_scorer_against_both(cpp_score):
    """Close the triangle on the device scan-path scorer for a sample of
    the duplicate-run cases (oracle == C++ == device fast path or its
    flagged-lane contract)."""
    import jax.numpy as jnp

    from mhap_tpu.ops import scorer as ksc
    from mhap_tpu.oracle.scorer import get_overlap_info

    rng = np.random.default_rng(5)
    S = 64
    fast = ksc.make_score_pairs_fast(0.2, S)
    for t in range(40):
        alphabet = rng.integers(-2**31, 2**31 - 1, 8)
        n1 = int(rng.integers(3, S))
        n2 = int(rng.integers(3, S))
        nk1, nk2 = n1 + 10, n2 + 10
        s1 = _mk_sketch(rng, n1, nk1, alphabet)
        s2 = _mk_sketch(rng, n2, nk2, alphabet)

        def pad(s, m):
            oh = np.full(S, 0x7FFFFFFF, np.int32)
            op = np.full(S, 0x7FFFFFFF, np.int32)
            oh[:len(s)] = s[:, 0]
            op[:len(s)] = s[:, 1]
            return oh, op

        oh1, op1 = pad(s1, n1)
        oh2, op2 = pad(s2, n2)
        out = {k: np.asarray(v) for k, v in fast(
            jnp.asarray(oh1[None]), jnp.asarray(op1[None]),
            jnp.asarray([n1], np.int32), jnp.asarray([nk1], np.int32),
            jnp.asarray(oh2[None]), jnp.asarray(op2[None]),
            jnp.asarray([n2], np.int32),
            jnp.asarray([nk2], np.int32)).items()}
        want = get_overlap_info(s1, nk1, s2, nk2, 12, 0.2)
        assert want == cpp_score(s1, nk1, s2, nk2)
        if out["needs_slow"][0]:
            continue  # flagged lanes re-run on the oracle by contract
        if not out["ok"][0]:
            assert want == (0.0, 0.0, 0, 0, 0, 0)
        else:
            assert (want[2], want[3], want[4], want[5]) == (
                out["a1"][0], out["a2"][0], out["b1"][0], out["b2"][0])
            assert want[1] == out["valid_cnt"][0]


def test_replay_shift_retry_runs_exact(cpp_score):
    """The bounded in-run replay (ops/scorer._replay_runs) must make
    shift-retry runs -- first-pair shift outside median +- absMax with
    multiple valid entries on the advancing side, where the automaton
    retries WITHIN the run (recordMatchingKmers :487-499) -- bit-exact in
    the scan fast path without flagging needs_slow.

    Construction: small hash alphabets with per-side duplicate runs of
    2-6 entries whose positions straddle wide spreads, so pass-2 windows
    and the shift bound produce in-run retries.  Every unflagged lane
    must match the oracle AND the C++ port exactly; flagged lanes are
    allowed only for run lengths beyond scan_bound."""
    import jax.numpy as jnp

    from mhap_tpu.ops import scorer as ksc
    from mhap_tpu.oracle.scorer import get_overlap_info

    rng = np.random.default_rng(17)
    S = 64
    fast = ksc.make_score_pairs_fast(0.2, S, scan_bound=8)

    def mk(alphabet, runs, spread, nk):
        rows = []
        for h in alphabet:
            r = int(rng.integers(1, runs + 1))
            ps = np.sort(rng.choice(spread, size=r, replace=False))
            for p in ps:
                rows.append((int(h), int(p)))
        rows.sort()
        a = np.asarray(rows, np.int32)
        return a[np.lexsort((a[:, 1], a[:, 0]))]

    flagged = checked = 0
    for t in range(400):
        A = int(rng.integers(2, 6))
        alphabet = np.unique(rng.integers(-2**31, 2**31 - 1, A))
        nk = int(rng.integers(40, 4000))
        # position pool mixing a tight cluster (drives the median) with
        # far outliers (drive retries/window exclusion)
        base = int(rng.integers(0, nk // 2))
        pool = np.unique(np.concatenate([
            base + rng.integers(0, 30, 12),
            rng.integers(0, nk, 8)]))
        s1 = mk(alphabet, 4, pool, nk)
        s2 = mk(alphabet, 4, pool, nk)
        n1, n2 = len(s1), len(s2)
        if n1 < 1 or n2 < 1 or n1 > S or n2 > S:
            continue
        oh1 = np.full(S, 0x7FFFFFFF, np.int32)
        op1 = np.full(S, 0x7FFFFFFF, np.int32)
        oh1[:n1], op1[:n1] = s1[:, 0], s1[:, 1]
        oh2 = np.full(S, 0x7FFFFFFF, np.int32)
        op2 = np.full(S, 0x7FFFFFFF, np.int32)
        oh2[:n2], op2[:n2] = s2[:, 0], s2[:, 1]
        out = {k: np.asarray(v) for k, v in fast(
            jnp.asarray(oh1[None]), jnp.asarray(op1[None]),
            jnp.asarray([n1], np.int32), jnp.asarray([nk], np.int32),
            jnp.asarray(oh2[None]), jnp.asarray(op2[None]),
            jnp.asarray([n2], np.int32),
            jnp.asarray([nk], np.int32)).items()}
        want = get_overlap_info(s1, nk, s2, nk, 12, 0.2)
        assert want == cpp_score(s1, nk, s2, nk)
        if out["needs_slow"][0]:
            flagged += 1
            continue
        checked += 1
        if not out["ok"][0]:
            assert want == (0.0, 0.0, 0, 0, 0, 0), f"trial {t}"
        else:
            assert (want[2], want[3], want[4], want[5]) == (
                out["a1"][0], out["a2"][0], out["b1"][0],
                out["b2"][0]), f"trial {t}"
            assert want[1] == out["valid_cnt"][0], f"trial {t}"
    # the replay must absorb nearly everything at these run lengths
    assert checked >= 250
    assert flagged <= checked // 10


def test_replay_deterministic_retry(cpp_score):
    """A hand-built run where the first (a, b) pair's shift fails the
    median +- absMax bound but a later in-run pair passes: the old scan
    path flagged this lane needs_slow; the replay must now score it
    exactly with no flag."""
    import jax.numpy as jnp

    from mhap_tpu.ops import scorer as ksc
    from mhap_tpu.oracle.scorer import get_overlap_info

    S = 16
    nk = 1000
    # three singleton runs at shift ~100 fix the pass-1 median; run h=50
    # has side-1 entries at pos 0 and 500 vs side-2 at 600: first-pair
    # shift 600 >> median + absMax, the retry within the run matches
    # (500, 600) with shift 100
    s1 = np.asarray([(10, 100), (20, 300), (30, 700), (50, 0), (50, 500)],
                    np.int32)
    s2 = np.asarray([(10, 200), (20, 400), (30, 800), (50, 600)], np.int32)
    want = get_overlap_info(s1, nk, s2, nk, 12, 0.2)
    assert want == cpp_score(s1, nk, s2, nk)
    # the retried record must actually appear: 4 valid matches
    assert want[1] == 4.0

    fast = ksc.make_score_pairs_fast(0.2, S, scan_bound=8)

    def pad(s, n):
        oh = np.full(S, 0x7FFFFFFF, np.int32)
        op = np.full(S, 0x7FFFFFFF, np.int32)
        oh[:n], op[:n] = s[:, 0], s[:, 1]
        return oh, op

    oh1, op1 = pad(s1, len(s1))
    oh2, op2 = pad(s2, len(s2))
    out = {k: np.asarray(v) for k, v in fast(
        jnp.asarray(oh1[None]), jnp.asarray(op1[None]),
        jnp.asarray([len(s1)], np.int32), jnp.asarray([nk], np.int32),
        jnp.asarray(oh2[None]), jnp.asarray(op2[None]),
        jnp.asarray([len(s2)], np.int32), jnp.asarray([nk], np.int32)
    ).items()}
    assert not out["needs_slow"][0]
    assert out["ok"][0]
    assert (want[2], want[3], want[4], want[5]) == (
        out["a1"][0], out["a2"][0], out["b1"][0], out["b2"][0])
    assert want[1] == out["valid_cnt"][0]
