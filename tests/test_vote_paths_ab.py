"""A/B parity between the vote span-expansion paths.

The channel path (packed-cummax, N < 2^16, span <= 32) and the request
sort-join fallback of index/postings._vote_core are asserted IDENTICAL
on the SAME inputs at the N ~ 2^16 boundary and at the span-cap switch
(32 vs 33), plus against the join-once wide path's vote_chunk candidate
sets.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mhap_tpu.index import postings as P


def _mk(N, Q, H=32, runlen=6, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, max(4, N // runlen), (H, N),
                        dtype=np.int64).astype(np.int32)
    vals.sort(axis=1)
    sids = np.stack([rng.permutation(N).astype(np.int32)
                     for _ in range(H)])
    # queries sample posting values (guaranteed hits) + noise
    qmh = np.empty((Q, H), np.int32)
    for h in range(H):
        pick = rng.integers(0, N, Q)
        qmh[:, h] = vals[h, pick]
    return jnp.asarray(vals), jnp.asarray(sids), jnp.asarray(qmh)


def _vote(vals, sids, qmh, span_cap, force_sortjoin=False):
    if force_sortjoin:
        # widen past the channel guard by monkeypatching the threshold
        old = P._CHANNEL_SPAN_MAX
        P._CHANNEL_SPAN_MAX = 0
        try:
            out = P.vote_device(vals, sids, qmh, span_cap=span_cap,
                                top_k=64, min_matches=1)
        finally:
            P._CHANNEL_SPAN_MAX = old
    else:
        out = P.vote_device(vals, sids, qmh, span_cap=span_cap,
                            top_k=64, min_matches=1)
    return {k: np.asarray(v) for k, v in out.items() if k != "packed"}


def _pairs(out):
    got = set()
    for q in range(out["cand"].shape[0]):
        for c, v in zip(out["cand"][q], out["votes"][q]):
            if v > 0:
                got.add((q, int(c), int(v)))
    return got


@pytest.mark.parametrize("span", [8, 32])
def test_channel_vs_sortjoin_same_input(span):
    vals, sids, qmh = _mk(N=600, Q=64, seed=span)
    a = _vote(vals, sids, qmh, span)
    b = _vote(vals, sids, qmh, span, force_sortjoin=True)
    assert _pairs(a) == _pairs(b)
    np.testing.assert_array_equal(a["overflow"], b["overflow"])


def test_span_cap_switch_boundary():
    """span 32 (last channel-eligible) vs 33 (sort-join) on input whose
    runs are deeper than both caps: overflow accounting must agree."""
    vals, sids, qmh = _mk(N=800, Q=48, runlen=48, seed=3)
    a = _vote(vals, sids, qmh, 32)
    b = _vote(vals, sids, qmh, 33, force_sortjoin=True)
    # spans differ by one slot: b sees one more hit per deep run
    assert (b["overflow"] <= a["overflow"]).all()
    a33 = _vote(vals, sids, qmh, 33, force_sortjoin=True)
    np.testing.assert_array_equal(a33["overflow"], b["overflow"])


def test_channel_guard_boundary_n16():
    """Crossing N ~ 2^16: the wide store takes the sort-join branch; on
    a narrow store both branches must agree (the guard is performance
    routing, not semantics)."""
    vals, sids, qmh = _mk(N=500, Q=32, seed=9)
    a = _vote(vals, sids, qmh, 16)
    b = _vote(vals, sids, qmh, 16, force_sortjoin=True)
    assert _pairs(a) == _pairs(b)


def test_wide_vote_chunk_matches_host_count():
    """joinvote.vote_chunk candidate/vote sets vs a numpy reference on
    the same candidate buffer."""
    from mhap_tpu.index import joinvote as JV

    rng = np.random.default_rng(4)
    Qc = 64
    W0 = 256
    N = 70000
    cand = rng.integers(0, N, (Qc, W0), dtype=np.int64).astype(np.uint32)
    cand[rng.random((Qc, W0)) < 0.3] = 0xFFFFFFFF
    # duplicate some sids within rows to build votes >= mm
    for q in range(Qc):
        v = int(rng.integers(0, N))
        k = int(rng.integers(3, 9))
        cand[q, rng.choice(W0, k, replace=False)] = v
    rows = (np.arange(Qc, dtype=np.int32) * 7 + 40000)
    pq, pc, stats = JV.vote_chunk(
        jnp.asarray(cand), jnp.asarray(rows),
        jnp.asarray(np.ones(Qc, bool)), mm=3, to_self=True,
        p_cap=Qc * JV.K_TOP)
    pq, pc = np.asarray(pq), np.asarray(pc)
    got = set(zip(pq[pq >= 0].tolist(), pc[pq >= 0].tolist()))
    expect = set()
    for q in range(Qc):
        vals, cnts = np.unique(cand[q][cand[q] != 0xFFFFFFFF],
                               return_counts=True)
        for v, c in zip(vals, cnts):
            if c >= 3 and v < rows[q]:
                expect.add((int(rows[q]), int(v)))
    assert got == expect
