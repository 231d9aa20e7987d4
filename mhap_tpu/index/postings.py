"""Device-side LSH index: sorted postings + searchsorted vote kernel.

The device re-expression of MinHashSearch's 512 per-position hash
tables (impl/MinHashSearch.java:85-147): for each sketch position the
(value -> [sequence ids]) map becomes a value-sorted row of a dense
[H, N] postings matrix; a query looks its value up with vectorized
binary search and every posting in the matched span votes
(MinHashSearch.java:161-181).

Fixed-capacity discipline (SURVEY.md hard part #2): each (query,
position) lookup materializes at most ``span_cap`` hits; spans larger
than that (heavy repeat buckets) are counted in ``overflow`` so the
caller can fall back to the exact host vote for affected queries.  Vote
counting is a sort + run-length pass over the (query, candidate) hit
keys -- no hash maps, no scatters.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
U32 = jnp.uint32


def build_postings_device(minhash: np.ndarray):
    """minhash: [N, H] int32 -> (values [H, N] int32 sorted per row,
    sids [H, N] int32).  One lax.sort over the transposed sketch matrix.
    """
    mh = jnp.asarray(minhash).T  # [H, N]
    H, N = mh.shape
    sid = jnp.broadcast_to(jnp.arange(N, dtype=I32), (H, N))
    vals, sids = jax.lax.sort((mh, sid), dimension=1, num_keys=1)
    return vals, sids


_CHANNEL_SPAN_MAX = 32  # spans above this use the request sort-join


def _expand_spans_sortjoin(post_sids, left, cnt, span_cap: int, N: int,
                           Q: int, H: int):
    """Span expansion for LARGE span_cap: candidate ids [Q, H, span_cap]
    via a request sort-join, not a gather (chosen on the earlier target,
    where computed-index gathers ran slower than sorts; not yet
    re-measured on the H100).  Each (q, band, d) request wants
    posting slot left+d; jointly sorting postings (tag 0, their own
    slot) with requests (tag 1, wanted slot) per band lets a doubling
    fill propagate each posting's sid to the requests behind it, and a
    second sort returns requests to their original order."""
    offs = jnp.arange(span_cap, dtype=I32)
    hit_ok = offs[None, None, :] < jnp.minimum(cnt, span_cap)[:, :, None]
    QS = Q * span_cap
    req = jnp.clip(left.T[:, :, None] + offs[None, None, :],
                   0, N - 1).reshape(H, QS)
    slots = jnp.broadcast_to(jnp.arange(N, dtype=I32), (H, N))
    j_slot = jnp.concatenate([slots, req], axis=1)
    j_tag = jnp.concatenate(
        [jnp.zeros((H, N), I32), jnp.ones((H, QS), I32)], axis=1)
    j_pay = jnp.concatenate(
        [post_sids,
         jnp.broadcast_to(jnp.arange(QS, dtype=I32), (H, QS))], axis=1)
    s_slot, s_tag, s_pay = jax.lax.sort(
        (j_slot, j_tag, j_pay), dimension=1, num_keys=2)
    # fill each slot-run with its head posting's sid (the head is the
    # unique tag-0 element: slots are distinct per band).  Forward
    # doubling fill bounded by run equality on the slot key -- a plain
    # cummax would propagate the largest sid seen, not the nearest.
    sid_run = jnp.where(s_tag == 0, s_pay, -1)
    MJ = N + QS
    d = 1
    while d < MJ:
        prev_slot = jnp.concatenate(
            [jnp.full((H, d), -1, I32), s_slot[:, :-d]], axis=1)
        prev_val = jnp.concatenate(
            [jnp.full((H, d), -1, I32), sid_run[:, :-d]], axis=1)
        sid_run = jnp.where(prev_slot == s_slot,
                            jnp.maximum(sid_run, prev_val), sid_run)
        d *= 2
    _, _, b_sid = jax.lax.sort((s_tag, s_pay, sid_run), dimension=1,
                               num_keys=2)
    cand = b_sid[:, N:].reshape(H, Q, span_cap).transpose(1, 0, 2)
    return jnp.where(hit_ok, cand, N)  # N = sentinel (sorts last)


def expand_hits(post_vals, post_sids, query_mh, *, span_cap: int):
    """Span expansion half of the vote kernel: candidate ids for every
    (query, band) value run, plus overflow/hit statistics.

    Returns (cand [Q, H, span_cap] i32 with N as the empty sentinel,
    overflow [Q], hits_total [Q]).  Factored out so the sharded SPMD
    path (parallel/sharded.py) can run the same sort-join/channel
    expansion per band shard instead of vmapped binary searches +
    computed gathers, and route the expanded hits with one
    all_to_all."""
    return _expand_core(post_vals, post_sids, query_mh,
                        span_cap=span_cap)


def _expand_core(post_vals, post_sids, query_mh, *, span_cap: int):
    H, N = post_vals.shape
    Q = query_mh.shape[0]

    # per (q, pos): locate the value span in the position's posting row.
    # Vectorized binary search (searchsorted) is a computed-index gather
    # loop (slow on the earlier target).  Instead, a per-band SORT-JOIN:
    # jointly sort postings (tag 0) and queries (tag 1) per band, then
    # ranks fall out of cumulative sums and a run-start cummax, and
    # (left, cnt) ride back to query-slot order on a second sort.  Two
    # [H, N+Q] sorts replace Q*H binary searches.
    M = N + Q
    j_vals = jnp.concatenate([post_vals, query_mh.T], axis=1)   # [H, M]
    j_tag = jnp.concatenate(
        [jnp.zeros((H, N), I32), jnp.ones((H, Q), I32)], axis=1)
    j_pay = jnp.concatenate(
        [jnp.broadcast_to(jnp.arange(N, dtype=I32), (H, N)),
         jnp.broadcast_to(jnp.arange(Q, dtype=I32), (H, Q))], axis=1)
    j_sid = jnp.concatenate(
        [post_sids, jnp.zeros((H, Q), I32)], axis=1)
    s_val, s_tag, s_pay, s_sid = jax.lax.sort(
        (j_vals, j_tag, j_pay, j_sid), dimension=1, num_keys=2)
    pos_j = jnp.broadcast_to(jnp.arange(M, dtype=I32), (H, M))
    cum_q = jnp.cumsum(s_tag, axis=1)              # queries at or before j
    right_j = pos_j + 1 - cum_q                    # postings at or before j
    # left = postings before this element's value-run: propagate the
    # run-start rank (non-decreasing, so a cummax carries it along runs)
    new_run = jnp.concatenate(
        [jnp.ones((H, 1), bool), s_val[:, 1:] != s_val[:, :-1]], axis=1)
    left_j = jax.lax.cummax(
        jnp.where(new_run, pos_j - (cum_q - s_tag), 0), axis=1)

    # the channel path packs candidate ids and ranks into u32 halves
    # (sort compile time grew steeply with operand count on the earlier
    # target; not yet re-measured on the H100), so it requires N and M
    # to fit 16 bits; wider stores use the sort-join.
    use_channels = (span_cap <= _CHANNEL_SPAN_MAX and N < 0xFFFF
                    and M <= 0xFFFF)
    packed_ch = []
    if use_channels:
        # span expansion IN the value join: a query's candidates are the
        # first span_cap postings of its OWN value run (exact-value LSH
        # match), and within a run all postings precede all queries (tag
        # is the second sort key).  The posting at in-run offset d
        # broadcasts its sid forward with ONE packed cummax (run-start
        # position in the high bits: the prefix max at any element is
        # the latest offset-d posting, valid iff its run is the
        # element's own).  span_cap cummaxes over [H, M] replace the old
        # [H, N + Q*span_cap] request sort-join + log-doubling fill +
        # unsort sort -- the vote kernel's dominant cost.
        rs1 = (jax.lax.cummax(jnp.where(new_run, pos_j, 0), axis=1)
               + 1)                      # run start position + 1 (0=none)
        rel = pos_j + 1 - rs1            # in-run offset
        lo_bits = 16
        sid_u = jnp.where(s_tag == 0, s_sid, 0).astype(jnp.uint32)
        rs1_u = rs1.astype(jnp.uint32)
        cnt_j = right_j - left_j         # run posting count (at queries)
        pay = (rs1_u << U32(lo_bits)) | sid_u
        chans = []
        for d in range(span_cap):
            ch = jax.lax.cummax(
                jnp.where((rel == d) & (s_tag == 0), pay, U32(0)),
                axis=1)
            ok = ((ch >> U32(lo_bits)) == rs1_u) & (d < cnt_j)
            sid_d = ch & U32(0xFFFF)
            chans.append(jnp.where(ok, sid_d, U32(N)))
        if len(chans) % 2:
            chans.append(jnp.full((H, M), U32(N)))
        packed_ch = [(chans[2 * i] << U32(16)) | chans[2 * i + 1]
                     for i in range(len(chans) // 2)]

    # back to query-slot order: postings (tag 0) first, queries by slot;
    # ranks and channel candidates ride the same single-packed-key sort
    key = (s_tag << 30) | s_pay
    if use_channels:
        lr = ((left_j.astype(jnp.uint32) << U32(16))
              | right_j.astype(jnp.uint32))
        srt = jax.lax.sort((key, lr, *packed_ch), dimension=1, num_keys=1)
        lr_q = srt[1]
        left = (lr_q >> U32(16)).astype(I32)[:, N:].T    # [Q, H]
        right = (lr_q & U32(0xFFFF)).astype(I32)[:, N:].T
    else:
        _, b_left, b_right = jax.lax.sort((key, left_j, right_j),
                                          dimension=1, num_keys=1)
        left = b_left[:, N:].T                           # [Q, H]
        right = b_right[:, N:].T
    cnt = right - left
    overflow = jnp.sum(jnp.maximum(cnt - span_cap, 0), axis=1).astype(I32)
    hits_total = jnp.sum(cnt, axis=1).astype(I32)

    if use_channels:
        parts = []
        for pk in srt[2:]:
            q = pk[:, N:]
            parts.append((q >> U32(16)).astype(I32))
            parts.append((q & U32(0xFFFF)).astype(I32))
        cand = jnp.stack(parts[:span_cap],
                         axis=2).transpose(1, 0, 2)  # [Q, H, span_cap]
    else:
        # large spans / wide stores: the request sort-join expansion
        cand = _expand_spans_sortjoin(post_sids, left, cnt, span_cap,
                                      N, Q, H)
    return cand, overflow, hits_total


def count_votes(cand_flat, N: int, *, top_k: int, min_matches: int):
    """Vote-count half: sorted run-length counting over a [Q, W] flat
    candidate matrix (sentinel >= N), then min-matches + top-k.

    Returns (top_cand [Q, top_k], top_votes, distinct [Q],
    saturated [Q] bool)."""
    Q = cand_flat.shape[0]
    s = jnp.sort(cand_flat, axis=1)
    M = cand_flat.shape[1]
    new_run = jnp.concatenate(
        [jnp.ones((Q, 1), bool), s[:, 1:] != s[:, :-1]], axis=1) & (s < N)
    # votes per run via position-difference of run starts
    pos = jnp.arange(M, dtype=I32)
    valid_total = jnp.sum(s < N, axis=1, keepdims=True)
    # run length = next run start - this run start (scan-free: use the
    # index of each run start and the following run start)
    run_start_idx = jnp.where(new_run, pos[None, :], M)
    # next run start for each element: a suffix-min, i.e. a reversed
    # cummin: one native cummin + two reversals replaces a log2(M)-step
    # doubling loop
    nxt = jnp.concatenate(
        [run_start_idx[:, 1:], jnp.full((Q, 1), M, I32)], axis=1)
    nxt = jax.lax.cummin(nxt[:, ::-1], axis=1)[:, ::-1]
    run_len = jnp.where(new_run,
                        jnp.minimum(nxt, valid_total) - pos[None, :], 0)
    run_len = jnp.maximum(run_len, 0)

    votes_all = jnp.where(new_run & (run_len >= min_matches), run_len, 0)
    top_votes, top_idx = jax.lax.top_k(votes_all, top_k)
    top_cand = jnp.take_along_axis(s, top_idx, axis=1)
    top_cand = jnp.where(top_votes > 0, top_cand, -1)
    distinct = jnp.sum(new_run, axis=1).astype(I32)
    saturated = (top_votes[:, -1] > 0) if top_k < N else jnp.zeros((Q,), bool)
    return (top_cand.astype(I32), top_votes.astype(I32), distinct,
            saturated)


def _vote_core(post_vals, post_sids, query_mh, *, span_cap: int,
               top_k: int, min_matches: int):
    """Shared vote kernel body; see vote_device_packed for semantics.

    Returns (cand [Q, top_k], votes [Q, top_k], overflow [Q],
    hits_total [Q], distinct [Q], saturated [Q] bool)."""
    H, N = post_vals.shape
    Q = query_mh.shape[0]
    cand, overflow, hits_total = _expand_core(post_vals, post_sids,
                                              query_mh, span_cap=span_cap)
    top_cand, top_votes, distinct, saturated = count_votes(
        cand.reshape(Q, H * span_cap), N, top_k=top_k,
        min_matches=min_matches)
    return (top_cand, top_votes, overflow, hits_total, distinct,
            saturated)


@partial(jax.jit, static_argnames=("span_cap", "top_k", "min_matches"))
def vote_device_packed(post_vals, post_sids, query_mh, *, span_cap: int = 16,
                       top_k: int = 64, min_matches: int = 3):
    """Vote counting for a query batch, packed for one-transfer readback.

    post_vals/post_sids: [H, N]; query_mh: [Q, H] int32.
    Returns ONE int32 array [Q, 2*top_k + 3] laid out as
      [cand (top_k) | votes (top_k) | overflow | hits_total | distinct]
    where ``cand``/``votes`` are the top candidates by descending vote
    count (votes 0 => empty slot; only counts >= min_matches surface),
    ``overflow`` counts hits dropped by span_cap (0 => exact result),
    ``hits_total`` is the uncapped postings-bucket mass touched by the
    query (MinHashSearch's additionalProcessed, :174-180) and ``distinct``
    the number of distinct candidates hit (bestSequenceHit.size(), exact
    when overflow == 0).
    """
    top_cand, top_votes, overflow, hits_total, distinct, _ = _vote_core(
        post_vals, post_sids, query_mh, span_cap=span_cap, top_k=top_k,
        min_matches=min_matches)
    return jnp.concatenate(
        [top_cand, top_votes, overflow[:, None],
         hits_total[:, None], distinct[:, None]], axis=1)


def vote_device(post_vals, post_sids, query_mh, *, span_cap: int = 16,
                top_k: int = 64, min_matches: int = 3):
    """Dict view of vote_device_packed (cand/votes/overflow)."""
    packed = vote_device_packed(post_vals, post_sids, query_mh,
                                span_cap=span_cap, top_k=top_k,
                                min_matches=min_matches)
    K = top_k
    return {"cand": packed[:, :K], "votes": packed[:, K:2 * K],
            "overflow": packed[:, 2 * K], "packed": packed}


@partial(jax.jit, static_argnames=("span_cap", "top_k", "min_matches",
                                   "msl", "to_self", "p_cap"))
def vote_suppress_compact(post_vals, post_sids, query_mh_all, q_rows,
                          q_hid, q_len, c_hid, c_len, *, span_cap: int,
                          top_k: int, min_matches: int, msl: int,
                          to_self: bool, p_cap: int):
    """Vote + suppression rules + pair compaction, fully on device.

    The host-side continuation of MinHashSearch.findMatches (:161-225)
    without the [Q, 2*top_k] readback: candidate pairs that survive the
    vote threshold AND the id/length suppression rules are compacted to a
    fixed [p_cap] buffer that STAYS on device (the scorer consumes it
    directly); only a small per-query stats block crosses the link.

    query_mh_all: [Nq, H] the query store's minhash matrix (device).
    q_rows:      [Q] int32 global query rows (-1 = padding slot).
    q_hid/q_len: [Nq] int32 header ids / lengths of the query store.
    c_hid/c_len: [N]  int32 header ids / lengths of the index store.

    Suppression (MinHashSearch.java:199-225): drop hid==0 padding rows,
    same-header pairs (self mode), short-short pairs, greater-id
    long-long pairs (self mode: each pair scored once), short-candidate
    long-query pairs (self mode).

    Returns (pairs_ql [p_cap] i32 local query slots, pairs_c [p_cap] i32
    candidate rows, stats [5, Q] i32).  stats rows: 0 overflow (span hits
    dropped), 1 hits_total, 2 distinct, 3 top-k saturated flag;
    row 4: slot 0 = surviving pair count (may exceed p_cap = compaction
    overflow), rest 0.
    """
    Q = q_rows.shape[0]
    N = post_vals.shape[1]
    q_valid = q_rows >= 0
    qr = jnp.where(q_valid, q_rows, 0)
    qmh = query_mh_all[qr]
    cand, votes, overflow, hits_total, distinct, saturated = _vote_core(
        post_vals, post_sids, qmh, span_cap=span_cap, top_k=top_k,
        min_matches=min_matches)

    qg_hid = q_hid[qr][:, None]
    qg_len = q_len[qr][:, None]
    cc = jnp.clip(cand, 0, N - 1)
    cd_hid = c_hid[cc]
    cd_len = c_len[cc]
    keep = (votes > 0) & (cand >= 0) & q_valid[:, None]
    keep &= cd_hid > 0
    keep &= ~((cd_len < msl) & (qg_len < msl))
    if to_self:
        keep &= cd_hid != qg_hid
        keep &= ~((cd_hid > qg_hid) & (cd_len >= msl) & (qg_len >= msl))
        keep &= ~((cd_len < msl) & (qg_len >= msl))

    # compact surviving pairs (q-major order) to [p_cap] by sort
    QK = Q * top_k
    flat_keep = keep.reshape(QK)
    order = jnp.arange(QK, dtype=I32)
    key = jnp.where(flat_keep, order, QK)
    ql_flat = order // top_k
    c_flat = cc.reshape(QK)
    _, s_ql, s_c = jax.lax.sort((key, ql_flat, c_flat), num_keys=1)
    cnt = jnp.sum(flat_keep).astype(I32)
    take = min(p_cap, QK)
    in_cnt = jnp.arange(take, dtype=I32) < cnt
    pairs_ql = jnp.where(in_cnt, s_ql[:take], -1)
    pairs_c = jnp.where(in_cnt, s_c[:take], -1)
    if take < p_cap:
        padv = jnp.full((p_cap - take,), -1, I32)
        pairs_ql = jnp.concatenate([pairs_ql, padv])
        pairs_c = jnp.concatenate([pairs_c, padv])

    counters = jnp.zeros((Q,), I32).at[0].set(cnt)
    stats = jnp.stack([overflow, hits_total, distinct,
                       saturated.astype(I32), counters])
    return pairs_ql, pairs_c, stats
