"""Batched affine-gap local Smith-Waterman on device (anti-diagonal
wavefront).

The device counterpart of the reference's single native component,
the SSW striped Smith-Waterman JNI library used by EstimateROC's PPV
adjudication (main/EstimateROC.java:294-313, :789; our host-side exact
rebuild is native/sw.cc).  This kernel scores a BATCH of pairs at once:

  * Gotoh recurrences swept along anti-diagonals: every cell of diagonal
    d depends only on diagonal d-1 (gap open/extend) and d-2
    (match/mismatch), so each scan step is one fully-vectorized
    [P, n+1] update -- no data-dependent control flow.
  * Path statistics (matches, alignment columns) are carried through the
    max selections alongside the scores, so identity = 1 - errors/len
    comes out without a traceback pass.  Tie-breaking follows
    native/sw.cc (diag, then vertical, then horizontal); score and end
    coordinates are exact, path stats can differ only on equal-score
    co-optimal paths.

Scoring matches the SSW invocation: match/mismatch/gap-open/gap-extend
with a length-L gap costing open + (L-1)*extend.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

I32 = jnp.int32
NEG = jnp.int32(-(1 << 29))


@partial(jax.jit, static_argnames=("match", "mismatch", "gap_open",
                                   "gap_extend"))
def sw_align_batch(q: jnp.ndarray, qlen: jnp.ndarray, r: jnp.ndarray,
                   rlen: jnp.ndarray, *, match: int = 2, mismatch: int = -2,
                   gap_open: int = 2, gap_extend: int = 1):
    """q: [P, n] uint8, r: [P, m] uint8 (padded); qlen/rlen: [P] int32.

    Returns dict of [P] int32 arrays: score, q_end, r_end (0-based,
    inclusive), matches, errors, length (M+I+D columns of a best path).
    """
    P, n = q.shape
    m = r.shape[1]
    go = jnp.int32(gap_open)
    ge = jnp.int32(gap_extend)

    # rext[p, t] holds r[p, t - (n+1)]: lets each diagonal read r[j-1]
    # via one aligned gather (j = d - i)
    rext = jnp.concatenate(
        [jnp.zeros((P, n + 1), jnp.uint8), r,
         jnp.zeros((P, 2), jnp.uint8)], axis=1)
    qcol = jnp.concatenate([jnp.zeros((P, 1), jnp.uint8), q], axis=1)
    ivec = jnp.arange(n + 1, dtype=I32)

    def shift(x, fill):
        return jnp.roll(x, 1, axis=1).at[:, 0].set(fill)

    def step(carry, d):
        (H1, E1, F1, H2, hM1, hL1, hM2, hL2, eM1, eL1, fM1, fL1,
         hQ1, hQ2, eQ1, fQ1, hR1, hR2, eR1, fR1,
         cbest, cbd, cbm, cbl, cbq, cbr) = carry
        j = d - ivec[None, :]
        valid = (ivec[None, :] >= 1) & (ivec[None, :] <= qlen[:, None]) \
            & (j >= 1) & (j <= rlen[:, None])

        # E: gap along r, source (i, j-1) = diag d-1, same i
        e_ext = (E1 - ge) >= (H1 - go)
        e = jnp.where(e_ext, E1 - ge, H1 - go)
        eM = jnp.where(e_ext, eM1, hM1)
        eL = jnp.where(e_ext, eL1, hL1) + 1
        eQ = jnp.where(e_ext, eQ1, hQ1)
        eR = jnp.where(e_ext, eR1, hR1)

        # F: gap along q, source (i-1, j) = diag d-1 shifted in i
        H1s = shift(H1, 0)
        F1s = shift(F1, NEG)
        hM1s = shift(hM1, 0)
        hL1s = shift(hL1, 0)
        hQ1s = shift(hQ1, 0)
        f_ext = (F1s - ge) >= (H1s - go)
        f = jnp.where(f_ext, F1s - ge, H1s - go)
        fM = jnp.where(f_ext, shift(fM1, 0), hM1s)
        fL = jnp.where(f_ext, shift(fL1, 0), hL1s) + 1
        fQ = jnp.where(f_ext, shift(fQ1, 0), hQ1s)
        fR = jnp.where(f_ext, shift(fR1, 0), shift(hR1, 0))

        # diag: source (i-1, j-1) = diag d-2 shifted in i
        H2s = shift(H2, 0)
        hM2s = shift(hM2, 0)
        hL2s = shift(hL2, 0)
        hQ2s = shift(hQ2, 0)
        rchar = jnp.take_along_axis(rext, (n + d) - ivec[None, :], axis=1)
        is_match = qcol == rchar
        sub = jnp.where(is_match, jnp.int32(match), jnp.int32(mismatch))
        diag = H2s + sub
        dM = hM2s + is_match.astype(I32)
        dL = hL2s + 1
        # path start: a fresh local path begins here when the diag source
        # cell scored 0 (matches sw.cc's traceback stop at T_STOP)
        dQ = jnp.where(H2s == 0, ivec[None, :] - 1, hQ2s)
        dR = jnp.where(H2s == 0, j - 1, shift(hR2, 0))

        h = jnp.maximum(jnp.maximum(0, diag), jnp.maximum(e, f))
        h = jnp.where(valid, h, 0)
        from_diag = (h > 0) & (h == diag)
        from_f = (h > 0) & ~from_diag & (h == f)
        from_e = (h > 0) & ~from_diag & ~from_f & (h == e)
        hM = jnp.where(from_diag, dM,
                       jnp.where(from_f, fM, jnp.where(from_e, eM, 0)))
        hL = jnp.where(from_diag, dL,
                       jnp.where(from_f, fL, jnp.where(from_e, eL, 0)))
        hQ = jnp.where(from_diag, dQ,
                       jnp.where(from_f, fQ, jnp.where(from_e, eQ, 0)))
        hR = jnp.where(from_diag, dR,
                       jnp.where(from_f, fR, jnp.where(from_e, eR, 0)))

        e = jnp.where(valid, e, NEG)
        f = jnp.where(valid, f, NEG)

        upd = h > cbest  # strict >: earliest diagonal wins ties (sw.cc)
        cbest = jnp.where(upd, h, cbest)
        cbd = jnp.where(upd, d, cbd)
        cbm = jnp.where(upd, hM, cbm)
        cbl = jnp.where(upd, hL, cbl)
        cbq = jnp.where(upd, hQ, cbq)
        cbr = jnp.where(upd, hR, cbr)
        return (h, e, f, H1, hM, hL, hM1, hL1, eM, eL, fM, fL,
                hQ, hQ1, eQ, fQ, hR, hR1, eR, fR,
                cbest, cbd, cbm, cbl, cbq, cbr), None

    z = jnp.zeros((P, n + 1), I32)
    neg = jnp.full((P, n + 1), NEG, I32)
    carry0 = (z, neg, neg, z, z, z, z, z, z, z, z, z,
              z, z, z, z, z, z, z, z, z, z, z, z, z, z)
    carry, _ = jax.lax.scan(step, carry0,
                            jnp.arange(2, n + m + 1, dtype=I32))
    (cbest, cbd, cbm, cbl, cbq, cbr) = carry[20:26]

    score = jnp.max(cbest, axis=1)
    win_i = jnp.argmax(cbest, axis=1).astype(I32)
    take = lambda arr: jnp.take_along_axis(arr, win_i[:, None], 1)[:, 0]
    bd = take(cbd)
    matches = take(cbm)
    length = take(cbl)
    q_begin = take(cbq)
    r_begin = take(cbr)
    return {"score": score, "q_end": win_i - 1, "r_end": bd - win_i - 1,
            "q_begin": q_begin, "r_begin": r_begin,
            "matches": matches, "errors": length - matches,
            "length": length}
