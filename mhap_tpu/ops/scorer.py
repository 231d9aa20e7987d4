"""Stage-2 pair scorer: the two-pass merge automaton on device.

Parity target: sketch/BottomOverlapSketch.java:397-630 + MatchData (:64-298).
All device outputs are **integers** (intersection count, bottom-k size,
valid-match count, UMVU edges); the float mash-identity conversion happens
on the host in float64 so there is zero float-parity risk in the kernel
(see pipeline/overlapper.py).

Device structure:

* a *shared-hash prefilter* removes entries whose hash does not occur in the
  other sketch.  This is exactly behavior-preserving: matches happen only on
  shared hashes, duplicate-hash runs are single-hash so prefiltering never
  splits a run, and the automaton's action on a non-shared entry is always a
  bare cursor skip.  It shrinks the sequential merge from ~2*S steps to
  ~#shared-hash entries (huge for candidate pairs that are not overlaps).
* the merge itself is a ``lax.while_loop`` over per-lane cursors, vmapped
  over a pair batch; duplicate-run extension, one-sided shift-window
  advances and the (first,last)-of-run record rule follow the reference
  exactly.
* median shift / UMVU edges / shift windows are integer-exact:
  Java's ``(int)(overlapSize * maxShiftPercent)`` is a fixed-point multiply
  by the exact binary expansion of the double (validated host-side), and
  ``Math.round(a/b)`` is ``floor((2a+b)/(2b))`` via integer long division.
* the windowed bottom-k Jaccard merge has a closed form (per shared hash
  value with multiplicities c1, c2: min(c1,c2) intersections then
  |c1-c2| singles), computed fully vectorized with one sort + segment sums.
"""

from __future__ import annotations

from fractions import Fraction
from functools import partial

import jax
import jax.numpy as jnp

from . import bitonic, u64

I32 = jnp.int32
U32 = jnp.uint32
_IMAX = jnp.int32(0x7FFFFFFF)
_UMAXU = U32(0xFFFFFFFF)
PAD_HASH = _IMAX


def fixed_point_constant(p: float, max_ov: int = 1 << 22) -> tuple[int, int]:
    """Exact binary expansion (m, s) of the double p: p == m / 2**s.

    Verifies that floor(ov * m / 2**s) == (int)(double)(ov * p) for every
    integer ov in [0, max_ov] (the Java semantics: double multiply, then
    truncate).  Differences can only occur when the exact product lies
    within one double-rounding step of an integer; those candidates are
    checked exactly.
    """
    import numpy as np

    if p < 0:
        raise ValueError("max-shift percent must be >= 0 on device")
    fr = Fraction(p)
    m, den = fr.numerator, fr.denominator
    s = den.bit_length() - 1
    assert den == 1 << s
    # candidate ovs where double rounding could cross an integer
    ov = np.arange(1, max_ov + 1, dtype=np.float64)
    prod = ov * np.float64(p)
    frac = prod - np.floor(prod)
    eps = np.maximum(np.spacing(prod) * 2, 1e-12)
    cand = np.nonzero((frac < eps) | (frac > 1 - eps))[0] + 1
    for o in cand[:100000]:
        exact_floor = (int(o) * m) >> s
        double_floor = int(float(int(o)) * p)
        if exact_floor != double_floor:
            raise ValueError(
                f"max-shift {p!r} has floor(double) != floor(exact) at ov={o};"
                " device scoring would diverge -- use the host scorer")
    return m, s


def _floor_mul(ov: jnp.ndarray, m: int, s: int) -> jnp.ndarray:
    """floor(ov * m / 2**s) for uint32 ov, exact (96-bit intermediate)."""
    ov = ov.astype(U32)
    m0 = U32(m & 0xFFFFFFFF)
    m1_int = (m >> 32) & 0xFFFFFFFF
    h0, l0 = u64._mul32_full(ov, m0)
    if m1_int:
        h1, l1 = u64._mul32_full(ov, U32(m1_int))
    else:
        h1 = l1 = jnp.zeros_like(ov)
    L0 = l0
    t = h0 + l1
    carry = (t < h0).astype(U32)
    L1 = t
    L2 = h1 + carry
    if s == 0:
        r = L0
    elif s < 32:
        r = (L0 >> U32(s)) | (L1 << U32(32 - s))
    elif s == 32:
        r = L1
    elif s < 64:
        r = (L1 >> U32(s - 32)) | (L2 << U32(64 - s))
    elif s == 64:
        r = L2
    elif s < 96:
        r = L2 >> U32(s - 64)
    else:
        r = jnp.zeros_like(ov)
    return r.astype(I32)


def _median_from(shifts: jnp.ndarray, cnt: jnp.ndarray) -> jnp.ndarray:
    """Upper median (Utils.quickSelect with k = cnt/2); shifts padded +MAX."""
    s = jnp.sort(shifts)
    idx = jnp.clip(cnt // 2, 0, shifts.shape[0] - 1)
    return s[idx]


def _window_params(median, abs_max, nk1, nk2):
    v1l = jnp.maximum(0, -median - abs_max)
    v1u = jnp.minimum(nk1, nk2 - median + abs_max)
    v2l = jnp.maximum(0, median - abs_max)
    v2u = jnp.minimum(nk2, nk1 + median + abs_max)
    return v1l, v1u, v2l, v2u


def _shift_stats(shifts, cnt, nk1, nk2, m, s):
    """median + absMaxShiftInOverlap (MatchData.performUpdate :191-215)."""
    median = _median_from(shifts, cnt)
    left = jnp.maximum(0, -median)
    right = jnp.minimum(nk1, nk2 - median)
    overlap = jnp.maximum(10, right - left)
    abs_max = jnp.minimum(jnp.maximum(nk1, nk2), _floor_mul(overlap, m, s))
    return median, abs_max


def _merge_pass(a_h, a_p, n1, b_h, b_p, n2, median, abs_max,
                v1l, v1u, v2l, v2u, cap: int):
    """One recordMatchingKmers pass (per lane; vmapped by caller).

    a_h, a_p: int32 [S] (hash, pos) sorted by (hash, pos); entries >= n1 are
    PAD.  Returns (pos1 [cap], pos2 [cap], cnt).
    """
    S = a_h.shape[0]

    def gather(arr, i):
        return arr[jnp.clip(i, 0, S - 1)]

    def ext_scan(h, i, arr_h, arr_p, n, vl, vu, active):
        """Last consecutive index with same hash and valid pos."""
        def cond(st):
            t, last, act = st
            ok = act & (t < n)
            ht = gather(arr_h, t)
            pt = gather(arr_p, t)
            return ok & (ht == h) & (pt >= vl) & (pt < vu)

        def body(st):
            t, last, act = st
            return t + 1, t, act

        _, last, _ = jax.lax.while_loop(cond, body, (i + 1, i, active))
        return last

    def cond(st):
        i1, i2, cnt, p1b, p2b = st
        return (i1 < n1) & (i2 < n2)

    def body(st):
        i1, i2, cnt, p1b, p2b = st
        h1 = gather(a_h, i1)
        p1 = gather(a_p, i1)
        h2 = gather(b_h, i2)
        p2 = gather(b_p, i2)

        adv1 = (h1 < h2) | (p1 < v1l) | (p1 >= v1u)
        adv2 = (~adv1) & ((h2 < h1) | (p2 < v2l) | (p2 >= v2u))
        matched = (~adv1) & (~adv2)
        shift = p2 - p1
        diff = shift - median
        sf1 = matched & (diff > abs_max)
        sf2 = matched & (diff < -abs_max)
        rec = matched & (~sf1) & (~sf2)

        # record the first pair
        c0 = jnp.clip(cnt, 0, cap - 1)
        p1b = p1b.at[c0].set(jnp.where(rec, p1, p1b[c0]))
        p2b = p2b.at[c0].set(jnp.where(rec, p2, p2b[c0]))

        i1_last = ext_scan(h1, i1, a_h, a_p, n1, v1l, v1u, rec)
        i2_last = ext_scan(h2, i2, b_h, b_p, n2, v2l, v2u, rec)
        moved = rec & ((i1_last != i1) | (i2_last != i2))

        cnt1 = cnt + rec.astype(I32)
        c1 = jnp.clip(cnt1, 0, cap - 1)
        p1n = gather(a_p, i1_last)
        p2n = gather(b_p, i2_last)
        p1b = p1b.at[c1].set(jnp.where(moved, p1n, p1b[c1]))
        p2b = p2b.at[c1].set(jnp.where(moved, p2n, p2b[c1]))
        cnt2 = cnt1 + moved.astype(I32)

        i1n = jnp.where(rec,
                        jnp.where(moved, i1_last, i1) + 1,
                        i1 + (adv1 | sf1).astype(I32))
        i2n = jnp.where(rec,
                        jnp.where(moved, i2_last, i2) + 1,
                        i2 + (adv2 | sf2).astype(I32))
        return i1n, i2n, cnt2, p1b, p2b

    p1b = jnp.full((cap,), _IMAX, I32)
    p2b = jnp.full((cap,), _IMAX, I32)
    i1, i2, cnt, p1b, p2b = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.int32(0), jnp.int32(0), p1b, p2b))
    return p1b, p2b, cnt


def _optimize_shifts(p1b, p2b, cnt, median, cap: int):
    """Adjacent same-pos1 dedup (MatchData.optimizeShifts :156-189).

    Returns keep mask [cap] (selected entries) and new count.
    """
    idx = jnp.arange(cap, dtype=I32)
    in_range = idx < cnt
    shifts = p2b - p1b
    key = jnp.abs(shifts - median)
    # adjacent runs of equal pos1 among in-range entries
    prev_same = jnp.concatenate(
        [jnp.zeros((1,), bool), p1b[1:] == p1b[:-1]]) & in_range
    new_run = in_range & ~prev_same
    run_id = jnp.cumsum(new_run.astype(I32)) - 1
    run_id = jnp.where(in_range, run_id, cap + 1)
    key = jnp.where(in_range, key, _IMAX)
    s_run, s_key, s_idx = jax.lax.sort((run_id, key, idx), num_keys=3)
    first_of_run = jnp.concatenate(
        [jnp.ones((1,), bool), s_run[1:] != s_run[:-1]]) & (s_run < cap)
    # un-permute by sorting on the carried index (scatter-free)
    _, keep_i = jax.lax.sort((s_idx, first_of_run.astype(I32)), num_keys=1)
    keep = keep_i == 1
    new_cnt = jnp.sum(keep).astype(I32)
    return keep, new_cnt


def _edges(p1b, p2b, keep, median, abs_max, nk1, nk2):
    """UMVU edge estimation (MatchData.computeEdges :90-137).

    Java computes round((n*lo - hi)/(n-1)) in double; since
    n*lo - hi == (n-1)*lo + (lo - hi), this equals
    lo + round((lo - hi)/(n-1)) exactly, and round(a/b) (half-up) is
    floor((2a + b)/(2b)) -- all within int32 range (|lo-hi| < 2^25,
    n <= cap), so a single floor-divide suffices.  (The double-precision
    quotient is exact for these magnitudes, so double-rounding cannot
    diverge: the fraction n*lo-hi is < 2^37 and n-1 < 2^13, both exactly
    representable, and Math.round's floor(x+0.5) on a value within 2^-15
    of a half-integer boundary only shifts when the true quotient is
    exactly k+1/2, which the integer formula handles identically.)
    """
    shifts = p2b - p1b
    valid = keep & (jnp.abs(shifts - median) <= abs_max)
    n = jnp.sum(valid).astype(I32)
    big = _IMAX
    l1 = jnp.min(jnp.where(valid, p1b, big))
    l2 = jnp.min(jnp.where(valid, p2b, big))
    r1 = jnp.max(jnp.where(valid, p1b, -big))
    r2 = jnp.max(jnp.where(valid, p2b, -big))
    den = jnp.maximum(n - 1, 1)

    def umvu(lo, hi_):
        # Java: (int)(n*lo - hi) wraps in int32 BEFORE the double divide;
        # jnp int32 multiply wraps identically.  round-half-up via
        # q0 + (2*rem >= den) keeps everything in int32 range.
        num = n * lo - hi_
        q0 = jnp.floor_divide(num, den)
        rem = num - q0 * den
        return q0 + (2 * rem >= den).astype(I32)

    a1 = jnp.maximum(0, umvu(l1, r1))
    a2 = jnp.minimum(nk1, umvu(r1, l1))
    b1 = jnp.maximum(0, umvu(l2, r2))
    b2 = jnp.minimum(nk2, umvu(r2, l2))
    ok = n >= 3
    return ok, n, a1, a2, b1, b2


def _windowed_jaccard(a_h, a_p, m1, b_h, b_p, m2, a1, a2, b1, b2):
    """Closed form of computeKBottomSketchJaccard (:304-364).

    Per shared hash value with window-filtered multiplicities c1, c2 the
    sequential union merge consumes max(c1,c2) union slots, intersections
    first; count intersections within the first k = min(s1,s2) slots.
    Returns (intersections, k).
    """
    S = a_h.shape[0]
    slot = jnp.arange(S, dtype=I32)
    in1 = (slot < m1) & (a_p >= a1) & (a_p <= a2)
    in2 = (slot < m2) & (b_p >= b1) & (b_p <= b2)
    s1 = jnp.sum(in1).astype(I32)
    s2 = jnp.sum(in2).astype(I32)
    k = jnp.minimum(s1, s2)

    vals = jnp.concatenate([jnp.where(in1, a_h, PAD_HASH),
                            jnp.where(in2, b_h, PAD_HASH)])
    tags = jnp.concatenate([jnp.zeros((S,), I32), jnp.ones((S,), I32)])
    mask = jnp.concatenate([in1, in2])
    # second key: valid entries sort before pads within an equal hash value,
    # so a run's first element is always valid (a real hash can legitimately
    # equal the PAD sentinel)
    inv = (~mask).astype(I32)
    s_vals, _, s_tags, s_mask = jax.lax.sort(
        (vals, inv, tags, mask.astype(I32)), num_keys=2)
    s_mask = s_mask == 1

    n2_ = 2 * S
    new_run = jnp.concatenate(
        [jnp.ones((1,), bool), s_vals[1:] != s_vals[:-1]]) & s_mask
    run_id = jnp.cumsum(new_run.astype(I32)) - 1
    run_id_c = jnp.where(s_mask, run_id, n2_ - 1)
    c1 = jax.ops.segment_sum((s_mask & (s_tags == 0)).astype(I32), run_id_c,
                             num_segments=n2_)
    c2 = jax.ops.segment_sum((s_mask & (s_tags == 1)).astype(I32), run_id_c,
                             num_segments=n2_)
    # per-run union consumption and intersections, in ascending hash order
    u = jnp.maximum(c1, c2)
    i_ = jnp.minimum(c1, c2)
    cum_u = jnp.cumsum(u) - u  # exclusive prefix
    remaining = jnp.maximum(k - cum_u, 0)
    contrib = jnp.minimum(remaining, i_)
    nruns = jnp.sum(new_run).astype(I32)
    run_slot = jnp.arange(n2_, dtype=I32)
    inter = jnp.sum(jnp.where(run_slot < nruns, contrib, 0)).astype(I32)
    return inter, k


def _prefilter_shared(a_h, a_p, m1, b_h, b_p, m2):
    """Keep only entries whose hash occurs in the other list (exact, see
    module docstring).  Returns compacted (a_h, a_p, m1', b_h, b_p, m2')."""
    S = a_h.shape[0]
    slot = jnp.arange(S, dtype=I32)

    def compact(h, p, m, other_h, other_m):
        idx = jnp.searchsorted(other_h, h)
        idx_c = jnp.clip(idx, 0, S - 1)
        found = (other_h[idx_c] == h) & (idx < other_m)
        keepm = found & (slot < m)
        inv = (~keepm).astype(U32)
        _, _, nh, np_ = jax.lax.sort((inv, slot.astype(U32), h, p),
                                     num_keys=2)
        nm = jnp.sum(keepm).astype(I32)
        nh = jnp.where(slot < nm, nh, PAD_HASH)
        np_ = jnp.where(slot < nm, np_, _IMAX)
        return nh, np_, nm

    na_h, na_p, nm1 = compact(a_h, a_p, m1, b_h, m2)
    nb_h, nb_p, nm2 = compact(b_h, b_p, m2, a_h, m1)
    return na_h, na_p, nm1, nb_h, nb_p, nm2


def make_score_pairs(max_shift_percent: float, sketch_size: int,
                     cap: int | None = None, jit: bool = True):
    """Build the batched pair scorer for a given max-shift percent.

    Returns fn(a_h, a_p, a_m, a_nk, b_h, b_p, b_m, b_nk) -> dict of int32
    [P] arrays: ok, inter, k, valid_cnt (rawScore), a1, a2, b1, b2.
    With jit=False the raw vmapped function is returned (for embedding in a
    larger jit/shard_map program).
    """
    m_c, s_c = fixed_point_constant(max_shift_percent)
    if cap is None:
        cap = 2 * sketch_size

    def score_one(a_h, a_p, a_m, a_nk, b_h, b_p, b_m, b_nk):
        fa_h, fa_p, fm1, fb_h, fb_p, fm2 = _prefilter_shared(
            a_h, a_p, a_m, b_h, b_p, b_m)

        # pass 1: unconstrained windows
        abs_max0 = jnp.maximum(a_nk, b_nk) + 1
        p1b, p2b, cnt1 = _merge_pass(
            fa_h, fa_p, fm1, fb_h, fb_p, fm2,
            jnp.int32(0), abs_max0, jnp.int32(0), a_nk, jnp.int32(0), b_nk,
            cap)
        ok = cnt1 > 0

        shifts1 = jnp.where(jnp.arange(cap) < cnt1, p2b - p1b, _IMAX)
        median1, abs_max1 = _shift_stats(shifts1, cnt1, a_nk, b_nk, m_c, s_c)
        v1l, v1u, v2l, v2u = _window_params(median1, abs_max1, a_nk, b_nk)

        # pass 2
        p1b, p2b, cnt2 = _merge_pass(
            fa_h, fa_p, fm1, fb_h, fb_p, fm2,
            median1, abs_max1, v1l, v1u, v2l, v2u, cap)
        ok = ok & (cnt2 > 0)

        shifts2 = jnp.where(jnp.arange(cap) < cnt2, p2b - p1b, _IMAX)
        median2 = _median_from(shifts2, cnt2)
        keep, cnt3 = _optimize_shifts(p1b, p2b, cnt2, median2, cap)
        ok = ok & (cnt3 > 0)

        shifts3 = jnp.where(keep, p2b - p1b, _IMAX)
        median3, abs_max3 = _shift_stats(shifts3, cnt3, a_nk, b_nk, m_c, s_c)
        eok, vcnt, a1, a2, b1, b2 = _edges(
            p1b, p2b, keep, median3, abs_max3, a_nk, b_nk)
        ok = ok & eok

        inter, k = _windowed_jaccard(a_h, a_p, a_m, b_h, b_p, b_m,
                                     a1, a2, b1, b2)
        return {
            "ok": ok, "inter": inter, "k": k, "valid_cnt": vcnt,
            "a1": a1, "a2": a2, "b1": b1, "b2": b2,
        }

    fn = jax.vmap(score_one)
    return jax.jit(fn) if jit else fn


_OP_FILL = {"sum": 0, "min": None, "max": None}  # min/max fills per-leaf


def seg_suffix_scan(leaves: dict, run_last: jnp.ndarray,
                    max_span: int | None = None) -> dict:
    """Backward segmented inclusive scan carrying several reductions at
    once (no scatters, no data-dependent control flow).

    leaves: name -> (values, op) with op in {sum, min, max}.  Segments are
    delimited by ``run_last`` flags (an element is the last of its run).
    Result[e] = reduction over elements e..end_of_run(e); read at a run's
    FIRST element it is the whole-run aggregate.

    Implemented as a log2(n)-step segmented Hillis-Steele doubling scan
    (v'[e] = f[e] ? v[e] : op(v[e], v[e+d]); f'[e] = f[e] | f[e+d]) --
    a small static graph, unlike lax.associative_scan's recursive
    construction which explodes trace/compile time at this width.

    max_span: when every run is known to span <= max_span elements, the
    doubling loop stops early (log2(max_span) steps instead of log2(n)) --
    the scorer's dominant cost.  Results for longer runs are WRONG; the
    caller must detect them and escalate (see make_score_pairs_fast's
    scan_bound / long-run flag).
    """
    names = list(leaves)
    ops = [leaves[n][1] for n in names]
    vals = [leaves[n][0] for n in names]
    n = run_last.shape[0]
    fills = []
    for op, v in zip(ops, vals):
        if op == "sum":
            fills.append(jnp.zeros((), v.dtype))
        elif op == "min":
            fills.append(jnp.asarray(jnp.iinfo(v.dtype).max, v.dtype))
        else:
            fills.append(jnp.asarray(jnp.iinfo(v.dtype).min, v.dtype))

    f = run_last
    d = 1
    limit = n if max_span is None else min(n, max_span)
    while d < limit:
        fs = jnp.concatenate([f[d:], jnp.ones((d,), bool)])
        nv = []
        for op, v, fill in zip(ops, vals, fills):
            vs = jnp.concatenate([v[d:], jnp.full((d,), fill, v.dtype)])
            if op == "sum":
                m = v + vs
            elif op == "min":
                m = jnp.minimum(v, vs)
            else:
                m = jnp.maximum(v, vs)
            nv.append(jnp.where(f, v, m))
        vals = nv
        f = f | (~f & fs)
        d *= 2
    return dict(zip(names, vals))


def _sorted_pair_structure_sort(a_h, a_p, a_m, b_h, b_p, b_m):
    """Master structure via one full 2-limb lax.sort (the GPU choice;
    see _sorted_pair_structure for the dispatch)."""
    S = a_h.shape[0]
    slot = jnp.arange(S, dtype=I32)
    is_pad = jnp.concatenate([slot >= a_m, slot >= b_m])
    h = jnp.concatenate([a_h, b_h])
    p = jnp.concatenate([a_p, b_p])
    tag = jnp.concatenate([jnp.zeros((S,), I32), jnp.ones((S,), I32)])
    # packed 2-limb key, same scheme as the merge variant below: limb0 =
    # signed hash as unsigned (pads -> UMAX), limb1 = tag<<31 | pos
    # (pads -> UMAX).  2 sort keys instead of 4 -- XLA sort compile time
    # and runtime both scale with operand count.
    k0 = jnp.where(is_pad, _UMAXU, h.astype(U32) ^ U32(0x80000000))
    k1 = jnp.where(is_pad, _UMAXU,
                   p.astype(U32) | (tag.astype(U32) << U32(31)))
    s0, s1 = jax.lax.sort((k0, k1), num_keys=2)
    real = ~((s0 == _UMAXU) & (s1 == _UMAXU))
    s_h = (s0 ^ U32(0x80000000)).astype(I32)
    s_tag = (s1 >> U32(31)).astype(I32)
    s_p = (s1 & U32(0x7FFFFFFF)).astype(I32)
    n2 = 2 * S
    first = real & jnp.concatenate(
        [jnp.ones((1,), bool), s_h[1:] != s_h[:-1]])
    last = real & jnp.concatenate(
        [(s_h[1:] != s_h[:-1]) | ~real[1:], jnp.ones((1,), bool)])
    idx = jnp.arange(n2, dtype=I32)
    return dict(h=s_h, p=s_p, tag=s_tag, real=real, first=first, last=last,
                idx=idx)


def _sorted_pair_structure_merge(a_h, a_p, a_m, b_h, b_p, b_m):
    """Master structure for the scan-based fast path: both (hash,pos)-sorted
    lists merged into one [2S] array ordered by (pad, hash, tag, pos) --
    each shared-hash run is contiguous with side-0 entries (pos ascending)
    before side-1 entries.

    Built by a bitonic MERGE, not a sort: each side is already sorted by
    (hash, pos) with pads in the suffix slots (the BottomOverlapSketch
    construction invariant, sketch/BottomOverlapSketch.java:543-558), so
    concat(A, reverse(B)) is bitonic under the packed key and log2(2S)
    compare-exchange stages replace the full 4-key sort network.
    5-7x faster than lax.sort on the CPU backend (tests, virtual-mesh
    scale runs) -- see _sorted_pair_structure for the dispatch.

    Packed 2-limb key per entry:
      limb0 = hash ^ 0x80000000   (signed order as unsigned)
      limb1 = tag << 31 | pos     (pos is an int32 k-mer index >= 0)
    pad entries (slot >= m) get (0xFFFFFFFF, 0xFFFFFFFF), which no real
    entry can equal (it would need pos == 0x7FFFFFFF, i.e. a read longer
    than int32).  A real hash CAN equal the 0x7FFFFFFF sentinel; its limb1
    keeps it ahead of the pads, preserving the (pad, hash, tag, pos) order.
    """
    S = a_h.shape[0]
    P2 = 1
    while P2 < S:
        P2 *= 2
    slot = jnp.arange(S, dtype=I32)

    def pack(h, p, m, tag_bit):
        k0 = h.astype(U32) ^ U32(0x80000000)
        k1 = p.astype(U32) | (U32(tag_bit) << U32(31))
        pad = slot >= m
        k0 = jnp.where(pad, _UMAXU, k0)
        k1 = jnp.where(pad, _UMAXU, k1)
        if P2 > S:
            ext = jnp.full((P2 - S,), _UMAXU, U32)
            k0 = jnp.concatenate([k0, ext])
            k1 = jnp.concatenate([k1, ext])
        return k0, k1

    ka0, ka1 = pack(a_h, a_p, a_m, 0)
    kb0, kb1 = pack(b_h, b_p, b_m, 1)
    c0 = jnp.concatenate([ka0, kb0[::-1]])
    c1 = jnp.concatenate([ka1, kb1[::-1]])
    s0, s1 = bitonic.merge(c0, c1)
    n2 = 2 * S
    s0 = s0[:n2]  # dropped tail is all pad-keyed (reals sort first)
    s1 = s1[:n2]

    real = ~((s0 == _UMAXU) & (s1 == _UMAXU))
    s_h = (s0 ^ U32(0x80000000)).astype(I32)
    s_tag = (s1 >> U32(31)).astype(I32)
    s_p = (s1 & U32(0x7FFFFFFF)).astype(I32)
    first = real & jnp.concatenate(
        [jnp.ones((1,), bool), s_h[1:] != s_h[:-1]])
    last = real & jnp.concatenate(
        [(s_h[1:] != s_h[:-1]) | ~real[1:], jnp.ones((1,), bool)])
    idx = jnp.arange(n2, dtype=I32)
    return dict(h=s_h, p=s_p, tag=s_tag, real=real, first=first, last=last,
                idx=idx)


def _sorted_pair_structure(a_h, a_p, a_m, b_h, b_p, b_m):
    """Backend dispatch for the master structure (trace-time choice; both
    formulations are differentially tested bit-identical).  The GPU takes
    the formulation measured faster on the H100 at S=1536 over a
    32768-lane slice; every other backend takes the merge."""
    if jax.default_backend() == "gpu":
        return _sorted_pair_structure_sort(a_h, a_p, a_m, b_h, b_p, b_m)
    return _sorted_pair_structure_merge(a_h, a_p, a_m, b_h, b_p, b_m)


def _replay_runs(st, okv, amb, median, abs_max, A: int, RB: int):
    """EXACT bounded replay of the merge automaton inside ambiguous runs.

    amb: [n2] bool flags at run-representative (first) elements whose
    in-run cursor dynamics the segmented scans cannot reproduce
    (interior window-invalid entries / first-pair shift retries).  The
    first A flagged runs are replayed with a statically unrolled
    2*RB-step simulation of recordMatchingKmers (:397-516) restricted to
    the run's <= RB entries; each run is independent because a record
    requires hash equality, so once either cursor leaves a run the other
    side drains without recording.

    Returns (amb_idx [A] master indices (n2 = unused slot),
    rc [A] record counts, rec1/rec2 [A, RB] recorded (pos1, pos2) in
    automaton order, overflow [] bool -- more than A ambiguous runs)."""
    p, tag, real, first = st["p"], st["tag"], st["real"], st["first"]
    n2 = p.shape[0]
    idx = jnp.arange(n2, dtype=I32)
    ranks = jnp.cumsum(amb.astype(I32)) - 1
    sel = amb & (ranks < A)
    amb_idx = jax.lax.sort(jnp.where(sel, idx, n2))[:A]
    overflow = jnp.sum(amb.astype(I32)) > A

    # extract the A run windows by SORT, not gather (computed gathers
    # cost ~5x a same-width sort here): each real element learns its
    # window id by a run-bounded doubling fill from its run head, gets a
    # dense key win*RB + offset, and two small filler sorts place the
    # elements into an offset-aligned [A, RB] block.
    rep_idx = jax.lax.cummax(jnp.where(first, idx, -1))
    BIGW = jnp.int32(A)
    win = jnp.where(first & sel, ranks, BIGW)
    d = 1
    while d < RB:
        prev_rep = jnp.concatenate([jnp.full((d,), -2, I32), rep_idx[:-d]])
        prev_win = jnp.concatenate([jnp.full((d,), BIGW, I32), win[:-d]])
        win = jnp.where(prev_rep == rep_idx,
                        jnp.minimum(win, prev_win), win)
        d *= 2
    offset = idx - rep_idx
    M = A * RB
    key = jnp.where(real & (win < A) & (offset < RB),
                    win * RB + offset, M + idx)
    meta = tag + 2 * okv.astype(I32)  # bit0 = tag, bit1 = window-valid
    k_s, p_s, m_s = jax.lax.sort((key, p, meta), num_keys=1)
    # dense placement: real prefix + M fillers; first-of-key wins
    Mp = min(M, n2)
    kk = jnp.concatenate([k_s[:Mp], jnp.arange(M, dtype=I32)])
    ff = jnp.concatenate([jnp.zeros((Mp,), I32), jnp.ones((M,), I32)])
    pp = jnp.concatenate([p_s[:Mp], jnp.zeros((M,), I32)])
    mm = jnp.concatenate([m_s[:Mp], jnp.full((M,), -1, I32)])
    k2_, _, p2_, m2_ = jax.lax.sort((kk, ff, pp, mm), num_keys=2)
    first_k = jnp.concatenate([jnp.ones((1,), bool), k2_[1:] != k2_[:-1]])
    sel_k = first_k & (k2_ < M)
    order = jnp.where(sel_k, k2_, M + jnp.arange(Mp + M, dtype=I32))
    _, pd, md = jax.lax.sort((order, p2_, m2_), num_keys=1)
    g_p = pd[:M].reshape(A, RB)
    g_m = md[:M].reshape(A, RB)
    in_run = g_m >= 0
    g_tag = jnp.where(in_run, g_m & 1, -1)
    g_ok = in_run & (((g_m >> 1) & 1) == 1)
    ma = jnp.sum((in_run & (g_tag == 0)).astype(I32), axis=1)
    mb = jnp.sum((in_run & (g_tag == 1)).astype(I32), axis=1)

    # ext[d]: last index reachable from d extending over consecutive
    # valid same-side in-run entries (reverse static scan)
    exts = [None] * RB
    exts[RB - 1] = jnp.full((A,), RB - 1, I32)
    for d in range(RB - 2, -1, -1):
        chain = (in_run[:, d + 1] & (g_tag[:, d + 1] == g_tag[:, d])
                 & g_ok[:, d + 1])
        exts[d] = jnp.where(chain, exts[d + 1], d)
    g_ext = jnp.stack(exts, axis=1)  # [A, RB]

    def sel8(arr, i):
        """arr[:, i] via a static select chain (no computed gather)."""
        out = arr[:, 0]
        for d in range(1, RB):
            out = jnp.where(i == d, arr[:, d], out)
        return out

    i = jnp.zeros((A,), I32)          # side-0 cursor: in [0, ma)
    j = ma                            # side-1 cursor: in [ma, ma+mb)
    rc = jnp.zeros((A,), I32)
    rec1 = jnp.full((A, RB), _IMAX, I32)
    rec2 = jnp.full((A, RB), _IMAX, I32)
    slot_r = jnp.arange(RB, dtype=I32)[None, :]

    def write(buf, at, val, cond):
        return jnp.where((slot_r == at[:, None]) & cond[:, None],
                         val[:, None], buf)

    # each step advances >= 1 cursor and the run holds <= RB entries, so
    # RB steps exhaust every run
    for _step in range(RB):
        active = (i < ma) & (j < ma + mb)
        a_p = sel8(g_p, i)
        a_ok = sel8(g_ok.astype(I32), i) == 1
        b_p = sel8(g_p, j)
        b_ok = sel8(g_ok.astype(I32), j) == 1
        skip_a = active & ~a_ok
        skip_b = active & a_ok & ~b_ok
        diff = b_p - a_p - median
        both = active & a_ok & b_ok
        sf1 = both & (diff > abs_max)
        sf2 = both & (diff < -abs_max)
        rec = both & ~sf1 & ~sf2
        il = sel8(g_ext, i)
        jl = sel8(g_ext, j)
        al_p = sel8(g_p, il)
        bl_p = sel8(g_p, jl)
        moved = rec & ((il != i) | (jl != j))
        rec1 = write(rec1, rc, a_p, rec)
        rec2 = write(rec2, rc, b_p, rec)
        rc1 = rc + rec.astype(I32)
        rec1 = write(rec1, rc1, al_p, moved)
        rec2 = write(rec2, rc1, bl_p, moved)
        rc = rc1 + moved.astype(I32)
        i = jnp.where(rec, il + 1, i + (skip_a | sf1).astype(I32))
        j = jnp.where(rec, jl + 1, j + (skip_b | sf2).astype(I32))

    # unused window slots never fill (no head wrote their rank): ma=mb=0
    # keeps their rc at 0
    return amb_idx, rc, rec1, rec2, overflow


def _compact_shared_runs(st, W: int, max_span: int | None):
    """Compact the master structure to its SHARED runs (hash present on
    both sides), [W] wide.

    Records can only come from shared runs (a record requires hash
    equality) and non-shared entries only cost the automaton bare cursor
    skips, so the merge passes are exact on the compacted structure --
    the reference's own prefilter argument (_prefilter_shared).  At
    PacBio-like error rates shared entries are <10%% of 2S, so the wide
    per-pass sorts and scans shrink ~6x.  Returns (st2, n_shared); lanes
    with n_shared > W must be flagged by the caller (the windowed
    jaccard still runs on the FULL structure -- union consumption needs
    every entry).

    Shared-ness is classified with max_span-bounded scans/fills: runs
    longer than max_span may misclassify, but such lanes are already
    needs_slow via the caller's long-run check."""
    h, p, tag, real = st["h"], st["p"], st["tag"], st["real"]
    first, last = st["first"], st["last"]
    n2 = h.shape[0]
    one = jnp.ones((n2,), I32)
    agg = seg_suffix_scan({
        "c1": (jnp.where(real & (tag == 0), one, 0), "sum"),
        "c2": (jnp.where(real & (tag == 1), one, 0), "sum"),
    }, last, max_span)
    idx = jnp.arange(n2, dtype=I32)
    rep_idx = jax.lax.cummax(jnp.where(first, idx, -1))
    shared = first & (agg["c1"] > 0) & (agg["c2"] > 0)
    lim = max_span if max_span is not None else n2
    d = 1
    while d < lim:
        prev_rep = jnp.concatenate([jnp.full((d,), -2, I32), rep_idx[:-d]])
        prev_sh = jnp.concatenate(
            [jnp.zeros((d,), bool), shared[:-d]])
        shared = shared | ((prev_rep == rep_idx) & prev_sh)
        d *= 2
    shared = shared & real
    n_shared = jnp.sum(shared.astype(I32))
    key = jnp.where(shared, idx, n2 + idx)
    # pos+tag packed into one payload (pos is a non-negative int32):
    # fewer sort operands = faster compile AND runtime
    pt = p.astype(U32) | (tag.astype(U32) << U32(31))
    _, hs, pts = jax.lax.sort((key, h, pt), num_keys=1)
    real2 = jnp.arange(W, dtype=I32) < n_shared
    h2 = hs[:W]
    first2 = real2 & jnp.concatenate(
        [jnp.ones((1,), bool), h2[1:] != h2[:-1]])
    last2 = real2 & jnp.concatenate(
        [(h2[1:] != h2[:-1]) | ~real2[1:], jnp.ones((1,), bool)])
    st2 = dict(h=h2, p=(pts[:W] & U32(0x7FFFFFFF)).astype(I32),
               tag=(pts[:W] >> U32(31)).astype(I32), real=real2,
               first=first2, last=last2, idx=jnp.arange(W, dtype=I32))
    return st2, n_shared


def _fast_pass_scan(st, median, abs_max, v1l, v1u, v2l, v2u,
                    cap: int | None, *, pass1: bool = False,
                    max_span: int | None = None,
                    replay_budget: int = 8):
    """Scan-based recordMatchingKmers pass on the master structure.

    The merge automaton's behavior is per-hash-run local: for each hash
    value shared by both (hash,pos)-sorted lists it records the (first
    window-valid p1, first window-valid p2) pair if its shift passes the
    median +- abs_max bound, then -- if either side's run extends -- the
    (last consecutive valid p1, last valid p2) pair with no shift check,
    and jumps both cursors past the run (BottomOverlapSketch.java:397-516).
    That reduces to segmented scans over the master structure, EXCEPT when
      (a) a run has a window-invalid entry strictly between its first and
          last valid entries (the extension stops there and the tail can
          re-match), or
      (b) the first-pair shift check fails while the advancing side has
          more than one valid entry in the run (the automaton retries
          within the run).
    Runs in those cases are AMBIGUOUS and re-scored exactly, in program,
    by a statically-unrolled bounded replay (_replay_runs) over the first
    ``replay_budget`` such runs; only lanes with MORE ambiguous runs than
    the budget flag ``needs_slow`` (plus run-length/capacity overflows
    handled by the caller).

    Returns (pos1 [cap], pos2 [cap], cnt, needs_slow); with cap=None
    (shifts-only mode) returns (shifts [2*n2], None, cnt, needs_slow)
    instead, skipping the record compaction.

    pass1=True specializes for the unconstrained first pass: positions are
    always inside the windows (okv == real) and the shift bound cannot
    fail, so the corner cases (a)/(b) are impossible -- the scan carries 6
    leaves instead of 10 and skips the flag logic entirely."""
    p, tag, real = st["p"], st["tag"], st["real"]
    idx, first, last = st["idx"], st["first"], st["last"]
    n2 = p.shape[0]
    t0 = tag == 0
    t1 = tag == 1
    if pass1:
        okv = real
    else:
        okv = real & jnp.where(t0, (p >= v1l) & (p < v1u),
                               (p >= v2l) & (p < v2u))
    one = jnp.ones((n2,), I32)
    leaves = {
        "c1": (jnp.where(okv & t0, one, 0), "sum"),
        "c2": (jnp.where(okv & t1, one, 0), "sum"),
        "fp1": (jnp.where(okv & t0, p, _IMAX), "min"),
        "fp2": (jnp.where(okv & t1, p, _IMAX), "min"),
        "lp1": (jnp.where(okv & t0, p, -_IMAX - 1), "max"),
        "lp2": (jnp.where(okv & t1, p, -_IMAX - 1), "max"),
    }
    agg = seg_suffix_scan(leaves, last, max_span)

    # evaluate at run representatives (first element of each run)
    valid_run = first & (agg["c1"] > 0) & (agg["c2"] > 0)
    if pass1:
        needs_slow = jnp.zeros((), bool)
        sf_hi = sf_lo = jnp.zeros((n2,), bool)
        amb = None
    else:
        # note: interior window-invalid entries are IMPOSSIBLE -- side
        # entries ascend by position within a run (master sort) and the
        # window is one interval, so invalid entries form a prefix and/or
        # suffix and the automaton's extension always reaches the last
        # valid entry.  The only in-run dynamics beyond the scan's
        # first/last model are shift retries (recordMatchingKmers
        # :487-499): first-pair shift outside the bound with >1 valid
        # entry on the advancing side.  Those runs are replayed exactly
        # below.
        shift = agg["fp2"] - agg["fp1"]
        diff = shift - median
        sf_hi = diff > abs_max
        sf_lo = diff < -abs_max
        amb = valid_run & ((sf_hi & (agg["c1"] > 1))
                           | (sf_lo & (agg["c2"] > 1)))
        needs_slow = jnp.zeros((), bool)

    rec_first = valid_run & ~sf_hi & ~sf_lo
    moved = (agg["lp1"] != agg["fp1"]) | (agg["lp2"] != agg["fp2"])
    if amb is not None:
        rec_first = rec_first & ~amb
    rec_last = rec_first & moved
    rc = rec_first.astype(I32) + rec_last.astype(I32)
    if cap is None:
        # shifts-only mode (pass 1): the caller needs just the record
        # count and the shift median, so skip the compaction sort and
        # return an [n2] masked shift array: the first-pair shift lives
        # at the run representative and the last-pair shift at rep+1 --
        # a rec_last run has >= 2 elements, so rep+1 is inside the same
        # run and never itself a representative.  Halves the caller's
        # median sort width vs a [2*n2] concat.
        cnt = jnp.sum(rc).astype(I32)
        shifts = jnp.where(rec_first, agg["fp2"] - agg["fp1"], _IMAX)
        rl_s = jnp.concatenate([jnp.zeros((1,), bool), rec_last[:-1]])
        last_sh = jnp.concatenate(
            [jnp.full((1,), _IMAX, I32), (agg["lp2"] - agg["lp1"])[:-1]])
        shifts = jnp.where(rl_s, last_sh, shifts)
        return shifts, None, cnt, needs_slow

    if amb is not None:
        RB = max_span if max_span is not None else 8
        amb_idx, rc_r, rec1_r, rec2_r, r_over = _replay_runs(
            st, okv, amb, median, abs_max, replay_budget, RB)
        needs_slow = needs_slow | r_over
        rc = rc.at[amb_idx].set(rc_r, mode="drop")
    cnt = jnp.sum(rc).astype(I32)
    base = jnp.cumsum(rc) - rc
    # record-capacity overflow (cap may be < 2S to shrink the shift/sort
    # widths): flagged lanes re-run exactly on the host
    needs_slow = needs_slow | (cnt > cap)

    # compact records to [cap] BY SORT, not scatter (chosen on the
    # earlier target, where computed-index scatters serialized; not yet
    # re-measured on the H100).  Each run representative carries its
    # first-pair record (key `base`) and parks the last-pair record on the NEXT
    # element (key `base + 1`; rep+1 is inside the run whenever rec_last
    # -- see the shifts-only branch), keeping the sort [n2] wide instead
    # of [2*n2].  Replayed runs carry up to RB records keyed base + slot.
    rl_s = jnp.concatenate([jnp.zeros((1,), bool), rec_last[:-1]])

    def shift1(a):
        return jnp.concatenate([jnp.full((1,), _IMAX, I32), a[:-1]])

    key = jnp.where(rec_first, base, n2 + cap)
    key = jnp.where(rl_s, shift1(base + 1), key)
    v1 = jnp.where(rec_first, agg["fp1"], _IMAX)
    v1 = jnp.where(rl_s, shift1(agg["lp1"]), v1)
    v2 = jnp.where(rec_first, agg["fp2"], _IMAX)
    v2 = jnp.where(rl_s, shift1(agg["lp2"]), v2)
    if amb is not None:
        base_r = jnp.take(base, jnp.clip(amb_idx, 0, n2 - 1))
        slot_r = jnp.arange(rec1_r.shape[1], dtype=I32)[None, :]
        k_r = jnp.where(slot_r < rc_r[:, None],
                        base_r[:, None] + slot_r, n2 + cap).reshape(-1)
        key = jnp.concatenate([key, k_r])
        v1 = jnp.concatenate([v1, rec1_r.reshape(-1)])
        v2 = jnp.concatenate([v2, rec2_r.reshape(-1)])
    _, s1, s2 = jax.lax.sort((key, v1, v2), num_keys=1)
    in_cnt = jnp.arange(cap, dtype=I32) < cnt
    p1b = jnp.where(in_cnt, s1[:cap], _IMAX)
    p2b = jnp.where(in_cnt, s2[:cap], _IMAX)
    return p1b, p2b, cnt, needs_slow


def _windowed_jaccard_scan(st, m1, m2, a1, a2, b1, b2,
                           max_span: int | None = None):
    """computeKBottomSketchJaccard closed form on the master structure."""
    p, tag, real = st["p"], st["tag"], st["real"]
    first, last = st["first"], st["last"]
    n2 = p.shape[0]
    t0 = tag == 0
    t1 = tag == 1
    in1 = real & t0 & (p >= a1) & (p <= a2)
    in2 = real & t1 & (p >= b1) & (p <= b2)
    s1 = jnp.sum(in1).astype(I32)
    s2 = jnp.sum(in2).astype(I32)
    k = jnp.minimum(s1, s2)
    one = jnp.ones((n2,), I32)
    agg = seg_suffix_scan({
        "c1": (jnp.where(in1, one, 0), "sum"),
        "c2": (jnp.where(in2, one, 0), "sum"),
    }, last, max_span)
    c1 = jnp.where(first, agg["c1"], 0)
    c2 = jnp.where(first, agg["c2"], 0)
    u = jnp.maximum(c1, c2)
    i_ = jnp.minimum(c1, c2)
    cum_u = jnp.cumsum(u) - u  # exclusive, ascending hash order
    remaining = jnp.maximum(k - cum_u, 0)
    inter = jnp.sum(jnp.minimum(remaining, i_)).astype(I32)
    return inter, k


def make_score_pairs_fast(max_shift_percent: float, sketch_size: int,
                          cap: int | None = None, jit: bool = True,
                          scan_bound: int | None = 8,
                          shared_cap: int | None = 1024):
    """Vectorized-fast-path batched scorer (one master sort + segmented
    scans; no data-dependent loops).

    Same outputs as make_score_pairs plus ``needs_slow`` (bool [P]): lanes
    where the fast pass cannot reproduce the automaton bit-exactly (see
    _fast_pass_scan) and must be re-scored with make_score_pairs.  All
    other lanes are exact.

    scan_bound: the segmented scans run log2(scan_bound) doubling steps
    instead of log2(2S) -- the scans were the scorer's dominant cost on
    the earlier target (not yet re-measured on the H100).  Lanes
    containing any hash run longer than scan_bound elements are detected
    exactly (equal hashes at
    distance scan_bound in the sorted structure) and flagged needs_slow.
    Real-data runs are c1+c2 duplicate 12-mers of one hash value within
    two 1536-entry sketches -- measured <= 4 on 100% of bench pairs -- so
    the default 8 escalates essentially nothing.  None = unbounded.

    shared_cap: the merge passes run on a [shared_cap]-wide compaction of
    the shared runs (_compact_shared_runs -- sort-based, NOT the gather
    formulation, a dead end on the earlier target).  Shared entries
    are <10%% of 2S at PacBio-like error rates; lanes whose shared count
    exceeds the cap flag needs_slow.  None (or >= 2S) disables.
    """
    m_c, s_c = fixed_point_constant(max_shift_percent)
    if cap is None:
        cap = 2 * sketch_size

    def score_one(a_h, a_p, a_m, a_nk, b_h, b_p, b_m, b_nk):
        st = _sorted_pair_structure(a_h, a_p, a_m, b_h, b_p, b_m)

        if scan_bound is not None:
            # any run longer than scan_bound has equal (real) hashes at
            # distance scan_bound -- exact, conservative in neither
            # direction (sorted order makes equal values contiguous)
            h, real = st["h"], st["real"]
            long_run = jnp.any((h[:-scan_bound] == h[scan_bound:])
                               & real[:-scan_bound] & real[scan_bound:])
        else:
            long_run = jnp.zeros((), bool)

        # the merge passes run on the shared-run compaction; overflowing
        # lanes are re-scored exactly (needs_slow)
        if shared_cap is not None and shared_cap < 2 * sketch_size:
            stp, n_shared = _compact_shared_runs(st, shared_cap, scan_bound)
            shared_over = n_shared > shared_cap
        else:
            stp = st
            shared_over = jnp.zeros((), bool)

        # pass 1: unconstrained windows -- positions always in range, the
        # shift bound can never fail (|shift| <= max(nk) < abs_max).  Only
        # the record count + shift median are needed, so the pass runs in
        # shifts-only mode (no record compaction; median over the full
        # uncapped record list, exactly the reference semantics)
        abs_max0 = jnp.maximum(a_nk, b_nk) + 1
        shifts1, _, cnt1, _ = _fast_pass_scan(
            stp, jnp.int32(0), abs_max0, jnp.int32(0), a_nk,
            jnp.int32(0), b_nk, None, pass1=True, max_span=scan_bound)
        ok = cnt1 > 0

        median1, abs_max1 = _shift_stats(shifts1, cnt1, a_nk, b_nk, m_c, s_c)
        v1l, v1u, v2l, v2u = _window_params(median1, abs_max1, a_nk, b_nk)

        p1b, p2b, cnt2, needs_slow = _fast_pass_scan(
            stp, median1, abs_max1, v1l, v1u, v2l, v2u, cap,
            max_span=scan_bound)
        needs_slow = needs_slow | long_run | shared_over
        ok = ok & (cnt2 > 0)

        shifts2 = jnp.where(jnp.arange(cap) < cnt2, p2b - p1b, _IMAX)
        median2 = _median_from(shifts2, cnt2)
        keep, cnt3 = _optimize_shifts(p1b, p2b, cnt2, median2, cap)
        ok = ok & (cnt3 > 0)

        shifts3 = jnp.where(keep, p2b - p1b, _IMAX)
        median3, abs_max3 = _shift_stats(shifts3, cnt3, a_nk, b_nk, m_c, s_c)
        eok, vcnt, a1, a2, b1, b2 = _edges(
            p1b, p2b, keep, median3, abs_max3, a_nk, b_nk)
        ok = ok & eok

        inter, k = _windowed_jaccard_scan(st, a_m, b_m, a1, a2, b1, b2,
                                          max_span=scan_bound)
        return {
            "ok": ok, "inter": inter, "k": k, "valid_cnt": vcnt,
            "a1": a1, "a2": a2, "b1": b1, "b2": b2,
            "needs_slow": needs_slow,
        }

    fn = jax.vmap(score_one)
    return jax.jit(fn) if jit else fn
