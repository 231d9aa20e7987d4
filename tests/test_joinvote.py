"""Parity tests for the join-once wide-store vote (index/joinvote.py).

The wide path is exercised end-to-end by forcing WIDE_STORE_MIN down on
small synthetic datasets and asserting LINE-SET EQUALITY against the
exact host-postings path -- the same oracle-anchored discipline as the
fused device path's tests (tests/test_pipeline_device.py).
"""

import numpy as np
import pytest

import bench as B
from mhap_tpu.pipeline.overlapper import TpuOverlapper


def _mk(n_reads=260, read_len=1000, genome_len=22000, seed=5):
    return B.make_reads(n_reads=n_reads, read_len=read_len,
                        genome_len=genome_len, seed=seed)


def _wide(**kw):
    ov = TpuOverlapper(**kw)
    ov.device_vote = True
    ov.WIDE_STORE_MIN = 10
    return ov


def test_wide_self_overlap_matches_host():
    reads = _mk()
    ref = TpuOverlapper()
    ref.device_vote = False
    expect = ref.overlap_self(reads)
    got = _wide().overlap_self(reads)
    assert set(got) == set(expect)
    assert len(got) == len(expect)


def test_wide_query_mode_matches_host():
    reads = _mk(n_reads=200, seed=6)
    box, queries = reads[:140], reads[140:]
    ref = TpuOverlapper()
    ref.device_vote = False
    expect = ref.overlap_query(box, queries)
    got = _wide().overlap_query(box, queries)
    assert set(got) == set(expect)


def test_wide_repeat_heavy_residuals():
    """Repeat-seeded genome: deep posting runs exercise the residual
    gather and (for monsters) the direct-vote fallback.  The spy PINS
    the fallback coverage: if dataset tuning ever stops producing
    monster queries, the exact direct path would silently lose its only
    end-to-end exercise."""
    genome = B.repeat_seeded_genome(16000, seed=9, repeat_len=900,
                                    n_copies=12)
    reads, _, _ = B.make_reads_placed(220, seed=9, lognormal=False,
                                      genome=genome, genome_len=16000)
    ref = TpuOverlapper()
    ref.device_vote = False
    expect = ref.overlap_self(reads)
    ov = _wide()
    called = {"direct": 0}
    orig = ov._find_matches_direct

    def spy(*a, **k):
        called["direct"] += 1
        return orig(*a, **k)

    ov._find_matches_direct = spy
    got = ov.overlap_self(reads)
    assert set(got) == set(expect)
    assert called["direct"] > 0
    # CLI final stats of the fallback-heavy run must match the exact
    # host path's accounting (fallback queries counted exactly once)
    ref_stats = ref.stats
    for key in ("matches_processed", "sequences_searched",
                "sequences_fully_compared", "elements_processed",
                "sequences_hit"):
        assert ov.stats[key] == ref_stats[key], (key, ov.stats, ref_stats)


def test_direct_subset_matches_full_vote_unit():
    """direct_vote_subset over candidate_member_mask's rows must return
    the same pairs AND the same stats (hit mass, distinct) as the
    full-store direct_vote -- the exactness claim of the family-subset
    restriction."""
    import jax.numpy as jnp

    from mhap_tpu.index import joinvote as JV

    rng = np.random.default_rng(11)
    N, H, B = 400, 32, 64
    # low-cardinality values => dense shared-value structure (repeat-ish)
    mh = rng.integers(0, 90, (N, H)).astype(np.int32)
    rows = rng.choice(N, B, replace=False).astype(np.int32)
    rows[-5:] = -1  # padding slots
    mh_d = jnp.asarray(mh)
    for mm in (1, 3):
        pq, pc, st = JV.direct_vote(mh_d, mh_d, jnp.asarray(rows),
                                    None, mm=mm, to_self=True)
        q_real = rows[rows >= 0]
        q_vals = jnp.sort(mh_d[jnp.asarray(q_real)], axis=0)
        mask = np.asarray(JV.candidate_member_mask(mh_d, q_vals))
        sub = np.nonzero(mask)[0].astype(np.int32)
        ns = max(64, -(-len(sub) // 64) * 64)
        rows_sub = np.full(ns, -1, np.int32)
        rows_sub[:len(sub)] = sub
        cand = jnp.asarray(rows_sub)
        sub_mh = jnp.take(mh_d, jnp.clip(cand, 0, N - 1), axis=0)
        spq, spc, sst = JV.direct_vote_subset(
            sub_mh, cand, mh_d, jnp.asarray(rows), None,
            mm=mm, to_self=True)
        full = {(int(a), int(b))
                for a, b in zip(np.asarray(pq), np.asarray(pc))
                if a >= 0}
        got = {(int(a), int(b))
               for a, b in zip(np.asarray(spq), np.asarray(spc))
               if a >= 0}
        assert got == full
        np.testing.assert_array_equal(np.asarray(sst), np.asarray(st))


def test_wide_repeat_heavy_direct_subset_exact():
    """End-to-end: the family-subset direct vote (forced) must give the
    same line set AND final stats as the exact host path on the
    repeat-heavy dataset -- and the subset kernel must actually fire."""
    from mhap_tpu.index import joinvote as JV

    genome = B.repeat_seeded_genome(16000, seed=9, repeat_len=900,
                                    n_copies=12)
    reads, _, _ = B.make_reads_placed(220, seed=9, lognormal=False,
                                      genome=genome, genome_len=16000)
    ref = TpuOverlapper()
    ref.device_vote = False
    expect = ref.overlap_self(reads)
    ov = _wide()
    ov.direct_subset = True  # force the subset path at any Q_fb
    fired = {"subset": 0}
    orig = JV.direct_vote_subset

    def spy(*a, **k):
        fired["subset"] += 1
        return orig(*a, **k)

    JV.direct_vote_subset = spy
    try:
        got = ov.overlap_self(reads)
    finally:
        JV.direct_vote_subset = orig
    assert fired["subset"] > 0
    assert set(got) == set(expect)
    assert len(got) == len(expect)
    for key in ("matches_processed", "sequences_searched",
                "sequences_fully_compared", "elements_processed",
                "sequences_hit"):
        assert ov.stats[key] == ref.stats[key], (key, ov.stats, ref.stats)


def test_wide_respects_min_store_length_guard():
    """msl != 0 must NOT take the wide path (its suppression shortcut
    assumes the default): the dispatcher falls back."""
    reads = _mk(n_reads=120, seed=7)
    ov = _wide(cfg=dict(min_store_length=600))
    # the guard is config-driven: msl != 0 refuses regardless of store
    assert not ov._wide_path_ok(object.__new__(type("S", (), {})), None,
                                True)
    ref = TpuOverlapper(cfg=dict(min_store_length=600))
    ref.device_vote = False
    expect = ref.overlap_self(reads)
    got = ov.overlap_self(reads)
    assert set(got) == set(expect)


def test_wide_path_taken_at_scale_threshold():
    """Sanity: the dispatcher actually routes through joinvote (spy)."""
    reads = _mk(n_reads=150, seed=8)
    ov = _wide()
    called = {}
    orig = ov._find_matches_wide

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    ov._find_matches_wide = spy
    ov.overlap_self(reads)
    assert called.get("yes")


def test_band_group_streaming_equivalence():
    """G > 1 recomputes the join per group (memory streaming); the
    candidate buffer must be identical to the G == 1 build."""
    import jax.numpy as jnp

    from mhap_tpu.index import joinvote as JV
    from mhap_tpu.index.postings import build_postings_device

    rng = np.random.default_rng(3)
    N, H, Q = 300, 16, 128
    mh = rng.integers(-500, 500, (N, H)).astype(np.int32)
    pv, ps = build_postings_device(mh)
    q_rows = np.arange(0, N, N // Q)[:Q].astype(np.int32)
    ji1 = JV.JoinedIndex(pv, ps, jnp.asarray(mh), q_rows, band_groups=1)
    ji4 = JV.JoinedIndex(pv, ps, jnp.asarray(mh), q_rows, band_groups=4)
    span, _ = ji1.plan_span()
    c1 = np.asarray(ji1.build_candidates(span))
    c4 = np.asarray(ji4.build_candidates(span))
    np.testing.assert_array_equal(np.sort(c1, axis=1), np.sort(c4, axis=1))
    np.testing.assert_array_equal(np.asarray(ji1.lr_hq),
                                  np.asarray(ji4.lr_hq))


def test_wide_query_slabs_exact():
    """Slab-partitioned wide path (memory bounding at 100k+) must give
    the same line set as a single slab."""
    reads = _mk(n_reads=180, seed=12)
    ref = TpuOverlapper()
    ref.device_vote = False
    expect = ref.overlap_self(reads)
    ov = _wide()
    ov.WIDE_QUERY_SLAB = 64  # force several slabs
    ov.WIDE_CAND_BUDGET = 0  # disable the single-slab upgrade
    got = ov.overlap_self(reads)
    assert set(got) == set(expect)
    assert len(got) == len(expect)
