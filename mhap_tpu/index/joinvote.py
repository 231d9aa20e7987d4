"""Join-once LSH vote for WIDE stores (reference scale, N >= 2^16).

The per-chunk fused vote (index/postings.py) re-scans all N postings for
every query chunk: at 40k reads (N ~ 80k postings per band) that is the
dominant cost of the whole run.  This module restructures the vote
around ONE global value join per dataset (the scaling-book "sort once,
slice often" discipline):

  stage A  (per band group): one 2-operand join sort of postings+queries
           per band -> run ranks (left / cnt) for EVERY query, plus the
           in-run offset channels' inputs.  One more 2-operand sort
           returns (left, cnt) to query-slot order.  Exact run counts
           for all (query, band) cells BEFORE any expansion: no
           escalation ladder, no speculative re-dispatch, ever.
  stats    one small pull: per-query hit mass, max run count, residual
           mass beyond candidate spans -> span + residual plan chosen
           from the DATA (span in {8,16,32}).
  stage B  (per band group): candidate extraction as split-sid
           double-cummax channels over the joined order (channel d
           broadcasts the run's d-th posting; two u32 cummaxes carry
           (run-start << B | sid-half) so any N fits), then ONE compiled
           5-operand unsort program transports 4 channels per dispatch
           back to query-slot order.
  residual run cells with cnt > span contribute their remaining
           postings EXACTLY through a host-built flat gather scattered
           into E extra candidate columns; queries whose residual
           exceeds E fall back to the exact host vote.
  stage C  (per fixed-size query chunk): one u32 sort of the candidate
           row counts votes by run length; suppression is a pure
           row-index compare (store rows are header-ordered, so
           hid_c < hid_q  <=>  row_c < row_q -- no gathers); packed
           (votes << 17 | sid) top_k bounds the per-query survivors; a
           flat sort compacts pairs.  Pair buffers accumulate on device;
           the host syncs ONCE for all stats + pair counts.

Reference semantics: impl/MinHashSearch.java:149-225 (vote counting,
minMatches threshold, suppression rules at default minStoreLength=0).
Exactness: run counts are exact, spans+residuals cover every posting,
saturated/overflowed/monster queries are re-run on the exact host path.
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_WPROF = os.environ.get("MHAP_WIDE_PROFILE") == "1"


def _wp(label, t0):
    if not _WPROF:
        return t0
    t1 = time.perf_counter()
    # stderr: stdout carries M4 overlap lines in the CLI
    print(f"[wprof]   resid.{label}: {t1 - t0:.3f}s",
          file=sys.stderr, flush=True)
    return t1

I32 = jnp.int32
U32 = jnp.uint32

TAG_BIT = 24  # tagpay = tag << TAG_BIT | (sid or qslot); needs N,Q < 2^24
SPANS = (8, 16, 32)       # compiled stage-B span variants (at most one
#                           per dataset is actually compiled)
E_RESID = 64              # extra candidate columns for residual hits
CNT_CAP = 255             # run counts clip here; bigger cells -> host
K_TOP = 384               # per-query survivor buffer
QC = 8192                 # stage-C query chunk
CHANS_PER_UNSORT = 4      # payload channels per unsort dispatch


@partial(jax.jit, static_argnames=("Hg",))
def _stage_a_join(post_vals, post_sids, q_t, *, Hg: int):
    """Join + ranks for one band group.

    post_vals/post_sids: [Hg, N] i32; q_t: [Hg, Q] i32 (query minhash
    transposed).  Returns (s_tp, rs1, rel [Hg, M] i32, lrpack [Hg, M]
    u32) in joined order."""
    N = post_vals.shape[1]
    Q = q_t.shape[1]
    M = N + Q
    tp_p = post_sids
    tp_q = jnp.broadcast_to(
        jnp.arange(Q, dtype=I32) + (1 << TAG_BIT), (Hg, Q))
    j_vals = jnp.concatenate([post_vals, q_t], axis=1)
    j_tp = jnp.concatenate([tp_p, tp_q], axis=1)
    s_val, s_tp = jax.lax.sort((j_vals, j_tp), dimension=1, num_keys=2)
    tag = s_tp >> TAG_BIT
    pos = jnp.broadcast_to(jnp.arange(M, dtype=I32), (Hg, M))
    cum_q = jnp.cumsum(tag, axis=1)
    right = pos + 1 - cum_q
    new_run = jnp.concatenate(
        [jnp.ones((Hg, 1), bool), s_val[:, 1:] != s_val[:, :-1]], axis=1)
    left = jax.lax.cummax(
        jnp.where(new_run, pos - (cum_q - tag), 0), axis=1)
    rs1 = jax.lax.cummax(jnp.where(new_run, pos, 0), axis=1) + 1
    rel = pos + 1 - rs1
    cnt = right - left
    lrpack = ((left.astype(U32) << U32(8))
              | jnp.minimum(cnt, CNT_CAP).astype(U32))
    return s_tp, rs1, rel, lrpack


@jax.jit
def _stage_a_unsort(s_tp, lrpack):
    """(left, cnt) back to query-slot order: [Hg, Q] u32 (queries occupy
    the last Q joined slots after sorting by tagpay)."""
    N_plus_Q = s_tp.shape[1]
    _, lr = jax.lax.sort((s_tp, lrpack), dimension=1, num_keys=1)
    return lr  # caller slices [:, N:]


@jax.jit
def _stats_from_cnt(cnt_hq):
    """cnt_hq: [H, Q] i32 -> per-query stats for the span/residual plan."""
    hits = jnp.sum(cnt_hq, axis=0)
    mx = jnp.max(cnt_hq, axis=0)
    resid = [jnp.sum(jnp.maximum(cnt_hq - s, 0), axis=0) for s in SPANS]
    return (hits.astype(I32), mx.astype(I32)) + tuple(
        r.astype(I32) for r in resid)


@partial(jax.jit, static_argnames=("span", "b_half", "first_chan"))
def _stage_b_channels(s_tp, rs1, rel, *, span: int, b_half: int,
                      first_chan: int):
    """CHANS_PER_UNSORT candidate channels [first_chan, first_chan+4) in
    joined order: channel d broadcasts the run's d-th posting sid to
    every later element of the run with two split-sid cummaxes."""
    tag0 = (s_tp >> TAG_BIT) == 0
    sid = (s_tp & ((1 << TAG_BIT) - 1)).astype(U32)
    mask = U32((1 << b_half) - 1)
    rs1u = rs1.astype(U32)
    chans = []
    for d in range(first_chan, min(first_chan + CHANS_PER_UNSORT, span)):
        sel = tag0 & (rel == d)
        hi = jax.lax.cummax(
            jnp.where(sel, (rs1u << U32(b_half)) | (sid >> U32(b_half)),
                      U32(0)), axis=1)
        lo = jax.lax.cummax(
            jnp.where(sel, (rs1u << U32(b_half)) | (sid & mask),
                      U32(0)), axis=1)
        chans.append(((hi & mask) << U32(b_half)) | (lo & mask))
    while len(chans) < CHANS_PER_UNSORT:
        chans.append(jnp.zeros_like(s_tp, dtype=U32))
    return tuple(chans)


@jax.jit
def _stage_b_unsort(s_tp, c0, c1, c2, c3):
    """ONE compiled 5-operand transport: 4 channels to query-slot order."""
    out = jax.lax.sort((s_tp, c0, c1, c2, c3), dimension=1, num_keys=1)
    return out[1:]


@partial(jax.jit, static_argnames=("span", "Hg"))
def _assemble_qmajor(chans_q, lr_q, *, span: int, Hg: int):
    """[span, Hg, Q] channels + [Hg, Q] lrpack -> [Q, Hg*span] u32
    candidates (invalid -> 0xFFFFFFFF sentinel, sorts last)."""
    cnt = (lr_q & U32(0xFF)).astype(I32)  # [Hg, Q]
    st = jnp.stack(chans_q, axis=0)       # [span, Hg, Q]
    dd = jnp.arange(span, dtype=I32)[:, None, None]
    ok = dd < cnt[None, :, :]
    st = jnp.where(ok, st, U32(0xFFFFFFFF))
    return st.transpose(2, 1, 0).reshape(st.shape[2], Hg * span)


R_DESC_CAP = 1 << 17  # residual descriptor pull size (one transfer)


@partial(jax.jit, static_argnames=("span", "cap"))
def _resid_descriptors(lr_hq, base, *, span: int, cap: int):
    """Compact global-cell descriptors of cells with cnt > span for ONE
    band group: flat 2-op sort over [Hg*Q] (chunked so the transient
    fits HBM at 100k reads), fixed-size [2, cap] output + count.
    ``base`` = first global cell index of the group (device scalar, so
    one compile serves every group)."""
    Hg, Q = lr_hq.shape
    flat_lr = lr_hq.reshape(-1)
    flat_cnt = (flat_lr & U32(0xFF)).astype(I32)
    over = flat_cnt > span
    idx = jnp.arange(Hg * Q, dtype=I32) + base
    key = jnp.where(over, idx, jnp.iinfo(jnp.int32).max)
    s_key, s_lr = jax.lax.sort((key, flat_lr), num_keys=1)
    n_over = jnp.sum(over.astype(I32))
    packed = jnp.stack([s_key[:cap], s_lr[:cap].astype(I32)])
    return packed, n_over


@jax.jit
def _resid_gather(post_sids_all, bands, slots):
    """Flat gather of residual posting sids: [R] from [H, N]."""
    return post_sids_all[bands, slots]


def _cdiv(a, b):
    return -(-a // b)


class JoinedIndex:
    """Wide-store vote driver state (built once per (store, queries))."""

    def __init__(self, post_vals, post_sids, query_mh, q_rows,
                 band_groups: int | None = None):
        """post_vals/post_sids: [H, N] device (build_postings_device);
        query_mh: [Nq, H] device store minhash; q_rows: [Q] int32 host
        (global query store rows, e.g. fwd rows for self-overlap)."""
        H, N = post_vals.shape
        Q = len(q_rows)
        if N >= (1 << TAG_BIT) or Q >= (1 << TAG_BIT):
            raise ValueError("store exceeds the 2^24-row join pack")
        # vote_chunk packs (votes << 21 | sid): the whole wide path is
        # only exact for stores under 2^21 rows, enforced HERE where the
        # packing invariant is relied on (not just at the dispatcher's
        # _wide_path_ok guard)
        if N >= (1 << 21):
            raise ValueError("store exceeds the 2^21-row vote pack")
        self.H, self.N, self.Q = H, N, Q
        self.M = N + Q
        # split-sid bit budget: rs1 needs ceil(log2(M+1)) bits
        bits_rs = (self.M + 1).bit_length()
        self.b_half = 32 - bits_rs
        if 2 * self.b_half < max(N.bit_length(), 1):
            raise ValueError("store too large for split-sid channels")
        G = band_groups or max(1, (self.M * H) // (32 << 20))
        while H % G:
            G += 1
        self.G = G
        self.Hg = H // G
        self.post_vals = post_vals
        self.post_sids = post_sids
        self.q_rows = np.asarray(q_rows, np.int32)
        # q_rows < 0 are padding slots (shape-unified query slabs): their
        # join columns get the INT32_MAX sentinel so they match nothing
        # and every per-query stat/residual stays exactly zero
        valid = self.q_rows >= 0
        q_rows_dev = jnp.asarray(np.where(valid, self.q_rows, 0))
        q_t = query_mh[q_rows_dev].T  # [H, Q] device
        if not valid.all():
            q_t = jnp.where(jnp.asarray(valid)[None, :], q_t,
                            jnp.int32(0x7FFFFFFF))
        self.q_t_full = q_t
        # stage A per group.  With more than one band group the joined
        # arrays are NOT retained (holding G groups' [Hg, M] triples is
        # what blows HBM at 100k reads); stage B recomputes the join per
        # group instead -- one extra 2-operand sort per group.
        self.joined = []   # (s_tp, rs1, rel) per group (G == 1 only)
        lr_groups = []
        for g in range(self.G):
            sl = slice(g * self.Hg, (g + 1) * self.Hg)
            s_tp, rs1, rel, lrpack = _stage_a_join(
                post_vals[sl], post_sids[sl], self.q_t_full[sl],
                Hg=self.Hg)
            if self.G == 1:
                self.joined.append((s_tp, rs1, rel))
            lr_groups.append(_stage_a_unsort(s_tp, lrpack)[:, N:])
            del s_tp, rs1, rel, lrpack
        self.lr_hq = jnp.concatenate(lr_groups, axis=0)  # [H, Q] u32
        if not valid.all():
            # zero padding columns outright: a real posting with value
            # INT32_MAX would otherwise match the pad sentinel and
            # inflate hit/residual stats (votes themselves are masked by
            # q_valid, but the stats and span plan read lr_hq directly)
            self.lr_hq = jnp.where(jnp.asarray(valid)[None, :],
                                   self.lr_hq, U32(0))
        self.cnt_hq = (self.lr_hq & U32(0xFF)).astype(I32)
        st = _stats_from_cnt(self.cnt_hq)
        stats = np.asarray(jnp.stack(st))
        self.cnt_hq = None  # derived from lr_hq when needed (HBM)
        self.hits_q = stats[0]
        self.max_cnt_q = stats[1]
        self.resid_q = {s: stats[2 + i] for i, s in enumerate(SPANS)}

    def plan_span(self, resid_elem_cap: int = 1 << 18,
                  fallback_cap: int = 512):
        """Smallest span whose residual fits the budgets.  Returns
        (span, fallback_rows): fallback rows (monster queries) are
        excluded from the device vote and re-run on the exact host
        path."""
        for span in SPANS:
            resid = self.resid_q[span]
            fb = (resid > E_RESID) | (self.max_cnt_q >= CNT_CAP)
            eff = resid[~fb].sum()
            if eff <= resid_elem_cap and fb.sum() <= fallback_cap:
                return span, np.nonzero(fb)[0]
        span = SPANS[-1]
        resid = self.resid_q[span]
        fb = (resid > E_RESID) | (self.max_cnt_q >= CNT_CAP)
        return span, np.nonzero(fb)[0]

    def build_candidates(self, span: int):
        """Stage B: the [Q, H*span] u32 candidate buffer (the E_RESID
        residual columns are attached by apply_residuals)."""
        parts = []
        for g in range(self.G):
            if self.G == 1:
                s_tp, rs1, rel = self.joined[0]
            else:
                sl_g = slice(g * self.Hg, (g + 1) * self.Hg)
                s_tp, rs1, rel, _ = _stage_a_join(
                    self.post_vals[sl_g], self.post_sids[sl_g],
                    self.q_t_full[sl_g], Hg=self.Hg)
            chans_q = []
            for fc in range(0, span, CHANS_PER_UNSORT):
                ch = _stage_b_channels(s_tp, rs1, rel, span=span,
                                       b_half=self.b_half, first_chan=fc)
                out = _stage_b_unsort(s_tp, *ch)
                take = min(CHANS_PER_UNSORT, span - fc)
                chans_q.extend(o[:, self.N:] for o in out[:take])
            sl = slice(g * self.Hg, (g + 1) * self.Hg)
            parts.append(_assemble_qmajor(
                tuple(chans_q), self.lr_hq[sl], span=span, Hg=self.Hg))
        return jnp.concatenate(parts, axis=1)  # [Q, H*span]

    def _with_resid_cols(self, cand, fill: np.ndarray | None):
        """Attach the E_RESID columns (host fill or all-sentinel) by
        CONCATENATION, not a .at[rows].set scatter into the ~0.7GB buffer
        (chosen on the earlier target, where that scatter serialized;
        not yet re-measured on the H100)."""
        if fill is None:
            fill = np.full((self.Q, E_RESID), 0xFFFFFFFF, np.uint32)
        return jnp.concatenate([cand, jnp.asarray(fill)], axis=1)

    def apply_residuals(self, cand, span: int):
        """Exact residual hits for cells with cnt > span, via ONE small
        host round trip.  Returns (cand', overflow_rows) where
        overflow_rows exceeded E_RESID and must host-fallback; cand'
        always has width H*span + E_RESID."""
        total = int(self.resid_q[span].sum())
        if total == 0:
            return self._with_resid_cols(cand, None), np.zeros(0, np.int64)
        tp = time.perf_counter()
        cap = min(R_DESC_CAP, self.Hg * self.Q)
        keys_parts, lr_parts = [], []
        for g in range(self.G):
            sl = slice(g * self.Hg, (g + 1) * self.Hg)
            packed, n_over = _resid_descriptors(
                self.lr_hq[sl], jax.device_put(
                    np.int32(g * self.Hg * self.Q)), span=span, cap=cap)
            n_over = int(n_over)
            if n_over > cap:
                # more overflowing cells than the descriptor cap: every
                # affected query host-fallbacks (pathological data)
                rq = np.nonzero(self.resid_q[span] > 0)[0]
                return self._with_resid_cols(cand, None), rq
            desc = np.asarray(packed)
            keys_parts.append(desc[0, :n_over])
            lr_parts.append(desc[1, :n_over].view(np.uint32))
        tp = _wp("descriptors", tp)
        desc_key = np.concatenate(keys_parts)
        desc_lr = np.concatenate(lr_parts)
        bands = desc_key // self.Q
        qs = desc_key % self.Q
        left = (desc_lr >> 8).astype(np.int64)
        cnts = (desc_lr & 0xFF).astype(np.int64)
        reps = np.minimum(cnts, CNT_CAP) - span
        keep = reps > 0
        bands, qs, left, reps = bands[keep], qs[keep], left[keep], reps[keep]
        flat_b = np.repeat(bands, reps).astype(np.int32)
        flat_q = np.repeat(qs, reps)
        starts = np.repeat(left + span, reps)
        offs = np.arange(len(flat_b)) - np.repeat(
            np.cumsum(reps) - reps, reps)
        flat_slot = (starts + offs).astype(np.int32)
        tp = _wp("expand", tp)
        sids = np.asarray(_resid_gather(self.post_sids,
                                        jnp.asarray(flat_b),
                                        jnp.asarray(flat_slot)))
        tp = _wp(f"gather n={len(flat_b)}", tp)
        # pack per query into E_RESID columns (host-side; tiny), then
        # REPLACE the sentinel residual block by concatenation, not a
        # .at[rows].set scatter into the ~0.7GB candidate buffer (see
        # _with_resid_cols)
        order = np.argsort(flat_q, kind="stable")
        fq, fs = flat_q[order], sids[order]
        uq, qstart, qcnt = np.unique(fq, return_index=True,
                                     return_counts=True)
        overflow_rows = uq[qcnt > E_RESID]
        fill = np.full((self.Q, E_RESID), 0xFFFFFFFF, np.uint32)
        for q, st0, c in zip(uq, qstart, qcnt):
            c2 = min(int(c), E_RESID)
            fill[q, :c2] = fs[st0:st0 + c2]
        tp = _wp(f"fill nq={len(uq)}", tp)
        out = self._with_resid_cols(cand, fill), overflow_rows
        _wp("concat", tp)
        return out


@partial(jax.jit, static_argnames=("mm", "to_self", "p_cap"))
def vote_chunk(cand_slice, q_store_rows, q_valid, hid=None, *, mm: int,
               to_self: bool, p_cap: int):
    """Stage C for one query chunk.

    cand_slice: [QC, W0] u32 (0xFFFFFFFF = invalid); q_store_rows [QC]
    i32 global store rows of the queries (-1 pad); q_valid [QC] bool.
    Suppression at minStoreLength=0 reduces to a row compare: store rows
    are header-ordered with the query's own fwd row first, so keeping
    hid_c < hid_q is exactly cand_row < query_row
    (MinHashSearch.java:199-225).  ``hid`` ([N] i32 header ids, 0 =
    padding row) switches to explicit header-id suppression for stores
    that are NOT header-ordered / have padding rows (the sharded
    keep-in-place store): keep hid_c > 0, and hid_c < hid_q in self
    mode -- one extra gather, same semantics.

    Returns (pairs_q [p_cap] i32 store rows, pairs_c [p_cap] i32,
    stats [4, QC]: hits-mass is tracked by the caller; rows are
    0: distinct candidates hit, 1: saturated flag, 2: surviving pairs
    per query, 3: slot 0 = chunk pair count)."""
    Qc, W0 = cand_slice.shape
    s = jnp.sort(cand_slice, axis=1)
    sent = s == U32(0xFFFFFFFF)
    new_run = jnp.concatenate(
        [jnp.ones((Qc, 1), bool), s[:, 1:] != s[:, :-1]], axis=1) & ~sent
    pos = jnp.broadcast_to(jnp.arange(W0, dtype=I32), (Qc, W0))
    run_start = jnp.where(new_run, pos, W0)
    nxt = jnp.concatenate(
        [run_start[:, 1:], jnp.full((Qc, 1), W0, I32)], axis=1)
    nxt = jax.lax.cummin(nxt[:, ::-1], axis=1)[:, ::-1]
    n_valid = jnp.sum((~sent).astype(I32), axis=1, keepdims=True)
    run_len = jnp.where(new_run, jnp.minimum(nxt, n_valid) - pos, 0)
    run_len = jnp.maximum(run_len, 0)
    distinct = jnp.sum(new_run.astype(I32), axis=1)

    votes = jnp.where(new_run & (run_len >= mm), run_len, 0)
    sid = s.astype(I32)
    if hid is not None:
        hid_c = hid[jnp.clip(sid, 0, hid.shape[0] - 1)]
        votes = jnp.where(hid_c > 0, votes, 0)
        if to_self:
            hid_q = hid[jnp.clip(q_store_rows, 0, hid.shape[0] - 1)]
            votes = jnp.where(hid_c < hid_q[:, None], votes, 0)
    elif to_self:
        votes = jnp.where(sid < q_store_rows[:, None], votes, 0)
    votes = jnp.where(q_valid[:, None], votes, 0)
    # votes <= H (a candidate posts once per band), so 10 bits suffice
    # and sid gets 21 (stores up to 2M rows)
    packed = (jnp.minimum(votes, 1023) << 21) | jnp.where(
        votes > 0, sid, 0)
    topp, _ = jax.lax.top_k(packed, min(K_TOP, W0))
    top_votes = topp >> 21
    top_cand = jnp.where(top_votes > 0, topp & ((1 << 21) - 1), -1)
    saturated = top_votes[:, -1] > 0
    pair_cnt_q = jnp.sum((top_votes > 0).astype(I32), axis=1)

    # compact pairs to [p_cap] by flat sort (q-major order)
    QK = Qc * min(K_TOP, W0)
    keep = (top_cand >= 0).reshape(QK)
    order = jnp.arange(QK, dtype=I32)
    key = jnp.where(keep, order, QK)
    ql = order // min(K_TOP, W0)
    qrow = q_store_rows[jnp.clip(ql, 0, Qc - 1)]
    _, s_q, s_c = jax.lax.sort(
        (key, qrow, top_cand.reshape(QK)), num_keys=1)
    cnt = jnp.sum(keep).astype(I32)
    take = min(p_cap, QK)
    in_cnt = jnp.arange(take, dtype=I32) < cnt
    pairs_q = jnp.where(in_cnt, s_q[:take], -1)
    pairs_c = jnp.where(in_cnt, s_c[:take], -1)
    if take < p_cap:
        pad = jnp.full((p_cap - take,), -1, I32)
        pairs_q = jnp.concatenate([pairs_q, pad])
        pairs_c = jnp.concatenate([pairs_c, pad])
    counters = jnp.zeros((Qc,), I32).at[0].set(cnt)
    stats = jnp.stack([distinct, saturated.astype(I32), pair_cnt_q,
                       counters])
    return pairs_q, pairs_c, stats


DIRECT_NQ = 512       # direct-vote batch (padded; one compile).  Wide
#                       batches amortize the per-batch stats sync and
#                       the [N, H] sketch stream: repeat-heavy datasets
#                       send thousands of queries down this path
DIRECT_PAIR_CAP = 1 << 20


@partial(jax.jit, static_argnames=("mm", "to_self"))
def direct_vote(store_mh, query_mh, rows, hid=None, *, mm: int,
                to_self: bool):
    """EXACT uncapped vote for a batch of queries, no postings needed:
    votes[c] = #bands where store_mh[c, h] == q[h] -- definitionally
    what the LSH run-length vote computes (MinHashSearch.java:149-178),
    with no span/count/top-k capacity anywhere.  Used for the wide
    path's capacity-overflow queries (monster repeats): one streaming
    pass over the [N, H] sketch matrix instead of the host postings
    rebuild (~60s at 200k rows) the host fallback cost.

    store_mh [N, H] i32; query_mh [Nq, H]; rows [B] i32 store rows of
    the queries (-1 = padding).  Returns (pairs_q, pairs_c [cap] i32,
    stats [3]: total pairs, hit mass, distinct candidates)."""
    N = store_mh.shape[0]
    B = rows.shape[0]
    valid = rows >= 0
    q = query_mh[jnp.clip(rows, 0, query_mh.shape[0] - 1)]      # [B, H]
    votes = jnp.sum((store_mh[None, :, :] == q[:, None, :]),
                    axis=-1, dtype=I32)                          # [B, N]
    votes = jnp.where(valid[:, None], votes, 0)
    if hid is not None:
        votes = jnp.where(hid[None, :] > 0, votes, 0)
    hits = jnp.sum(votes)
    distinct = jnp.sum(votes > 0)
    keep = votes >= mm
    crow = jnp.broadcast_to(jnp.arange(N, dtype=I32)[None], (B, N))
    if hid is not None:
        if to_self:
            # keep-in-place stores: explicit header-id suppression
            hid_q = hid[jnp.clip(rows, 0, hid.shape[0] - 1)]
            keep &= hid[None, :] < hid_q[:, None]
    elif to_self:
        # suppression at default minStoreLength reduces to a row
        # compare (store rows are header-ordered; see vote_chunk)
        keep &= crow < rows[:, None]
    total = jnp.sum(keep).astype(I32)
    flat = keep.reshape(-1)
    idx = jnp.arange(B * N, dtype=I32)
    key = jnp.where(flat, idx, jnp.iinfo(jnp.int32).max)
    qrow = jnp.broadcast_to(rows[:, None], (B, N)).reshape(-1)
    _, s_q, s_c = jax.lax.sort((key, qrow, crow.reshape(-1)), num_keys=1)
    cap = min(DIRECT_PAIR_CAP, B * N)
    in_cnt = jnp.arange(cap, dtype=I32) < total
    pairs_q = jnp.where(in_cnt, s_q[:cap], -1)
    pairs_c = jnp.where(in_cnt, s_c[:cap], -1)
    return pairs_q, pairs_c, jnp.stack([total, hits, distinct])


SUBSET_MAX_FRAC = 0.75  # subset must cut the candidate axis by >= 25%
#                       to pay for the extra gather/compile
SUBSET_PAD = 4096     # candidate-subset rows pad to this quantum (one
#                       compile per quantum; power-of-two padding would
#                       double Ns at repeat40k scale and eat the win)


@jax.jit
def candidate_member_mask(store_mh, q_vals_sorted):
    """mask[c] = does store row c share >= 1 BAND-ALIGNED sketch value
    with any fallback query?  A direct vote (direct_vote docstring) is
    votes[q, c] = #bands h with store_mh[c, h] == q_mh[q, h]; a row with
    mask False therefore has ZERO votes against every fallback query, so
    restricting the dense vote's candidate axis to mask rows is EXACT --
    the repeat regime's fallback queries are family reads whose
    candidates live almost entirely inside the repeat family, a ~2-3x
    smaller axis.

    q_vals_sorted [B, H]: fallback queries' sketch values, sorted per
    band column (pad by REPEATING a real query row -- duplicates cannot
    change set membership).  Cost: log2(B) binary-search passes over the
    [N, H] sketch matrix."""
    B = q_vals_sorted.shape[0]

    def per_band(qcol, scol):
        pos = jnp.clip(jnp.searchsorted(qcol, scol), 0, B - 1)
        return qcol[pos] == scol

    member = jax.vmap(per_band, in_axes=(1, 1), out_axes=1)(
        q_vals_sorted, store_mh)                        # [N, H]
    return jnp.any(member, axis=1)


@partial(jax.jit, static_argnames=("mm", "to_self"))
def direct_vote_subset(sub_mh, cand_rows, query_mh, rows, hid=None, *,
                       mm: int, to_self: bool):
    """direct_vote restricted to a candidate subset: sub_mh [Ns, H] =
    store_mh gathered at cand_rows [Ns] (true store rows, -1 = padding).
    Exact when cand_rows covers candidate_member_mask's rows: excluded
    rows have zero votes, so pairs, hit mass and distinct counts all
    match the full-store vote (stats parity included)."""
    Ns = sub_mh.shape[0]
    B = rows.shape[0]
    valid = rows >= 0
    q = query_mh[jnp.clip(rows, 0, query_mh.shape[0] - 1)]   # [B, H]
    votes = jnp.sum((sub_mh[None, :, :] == q[:, None, :]),
                    axis=-1, dtype=I32)                       # [B, Ns]
    votes = jnp.where(valid[:, None], votes, 0)
    cvalid = cand_rows >= 0
    votes = jnp.where(cvalid[None, :], votes, 0)
    if hid is not None:
        hid_c = jnp.where(
            cvalid, hid[jnp.clip(cand_rows, 0, hid.shape[0] - 1)], 0)
        votes = jnp.where(hid_c[None, :] > 0, votes, 0)
    hits = jnp.sum(votes)
    distinct = jnp.sum(votes > 0)
    keep = votes >= mm
    crow = jnp.broadcast_to(cand_rows[None, :], (B, Ns))
    if hid is not None:
        if to_self:
            hid_q = hid[jnp.clip(rows, 0, hid.shape[0] - 1)]
            keep &= hid_c[None, :] < hid_q[:, None]
    elif to_self:
        keep &= cand_rows[None, :] < rows[:, None]
    total = jnp.sum(keep).astype(I32)
    flat = keep.reshape(-1)
    idx = jnp.arange(B * Ns, dtype=I32)
    key = jnp.where(flat, idx, jnp.iinfo(jnp.int32).max)
    qrow = jnp.broadcast_to(rows[:, None], (B, Ns)).reshape(-1)
    _, s_q, s_c = jax.lax.sort((key, qrow, crow.reshape(-1)), num_keys=1)
    cap = min(DIRECT_PAIR_CAP, B * Ns)
    in_cnt = jnp.arange(cap, dtype=I32) < total
    pairs_q = jnp.where(in_cnt, s_q[:cap], -1)
    pairs_c = jnp.where(in_cnt, s_c[:cap], -1)
    return pairs_q, pairs_c, jnp.stack([total, hits, distinct])


@partial(jax.jit, static_argnames=("total_cap",))
def compact_pairs(pairs_q_all, pairs_c_all, *, total_cap: int):
    """Concat + compact per-chunk pair buffers to one run buffer."""
    q = pairs_q_all.reshape(-1)
    c = pairs_c_all.reshape(-1)
    keep = q >= 0
    idx = jnp.arange(q.shape[0], dtype=I32)
    key = jnp.where(keep, idx, jnp.iinfo(jnp.int32).max)
    _, s_q, s_c = jax.lax.sort((key, q, c), num_keys=1)
    total = jnp.sum(keep.astype(I32))
    take = min(total_cap, q.shape[0])
    return s_q[:take], s_c[:take], total
