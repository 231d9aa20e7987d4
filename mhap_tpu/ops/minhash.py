"""Stage-1 weighted MinHash sketch kernel (JAX, dense batched formulation).

Parity target: sketch/MinHashSketch.java:51-179.

The reference walks a per-k-mer xorshift64 stream, consuming ``weight``
values per sketch slot and keeping the running signed-64-bit minimum per
slot; the stored value is the low/high half of the winning k-mer's identity
hash by slot parity.  Re-expressed dense and batched:

1. sort each read's (hash, position) pairs so duplicate k-mers form runs
   (``lax.sort`` with 3 keys);
2. per run: occurrence count via segment-sum, first-occurrence position as
   the tie-break index (the reference's insertion-ordered map + strict ``<``
   resolves ties to the earliest-inserted k-mer);
3. a ``lax.scan`` over the ``num_hashes`` slots; each step advances every
   active stream ``weight`` times (masked to its own weight) and reduces the
   per-slot window minimum over all k-mers of the read, lexicographically on
   (signed value, first-occurrence index).

Everything is fixed-shape; weights above the compiled cap dispatch to a
larger-cap variant on the host side (see pipeline/overlapper.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import u64

U32 = jnp.uint32
I32 = jnp.int32
_SIGN = U32(0x80000000)
_UMAX = U32(0xFFFFFFFF)
_IMAX = I32(0x7FFFFFFF)


def sort_and_count(hi: jnp.ndarray, lo: jnp.ndarray, valid: jnp.ndarray):
    """Group duplicate k-mer hashes per read.

    hi, lo: [B, n] uint32 halves of the 64-bit identity hash.
    valid:  [B, n] bool (position produces a real k-mer and passed keepKmer).

    Returns dict of [B, n] arrays in hash-sorted order:
      hi, lo        -- sorted hashes (invalid rows pushed to the end)
      first         -- bool, first element of each valid run
      count         -- int32, run length (only meaningful at ``first``)
      tiebreak      -- int32, original position of the run's first occurrence
    """
    B, n = hi.shape
    idx = jnp.broadcast_to(jnp.arange(n, dtype=I32), (B, n))
    inval = (~valid).astype(U32)  # invalid sorts last
    s_inval, s_hi, s_lo, s_idx = jax.lax.sort(
        (inval, hi, lo, idx), dimension=1, num_keys=3, is_stable=True)
    s_valid = s_inval == 0

    prev_same = jnp.concatenate(
        [jnp.zeros((B, 1), bool),
         (s_hi[:, 1:] == s_hi[:, :-1]) & (s_lo[:, 1:] == s_lo[:, :-1])],
        axis=1)
    first = s_valid & ~prev_same

    run_id = jnp.cumsum(first.astype(I32), axis=1) - 1  # -1 before first run
    run_id = jnp.maximum(run_id, 0)
    ones = s_valid.astype(I32)
    counts_per_run = jax.vmap(
        partial(jax.ops.segment_sum, num_segments=n))(ones, run_id)
    count = jnp.take_along_axis(counts_per_run, run_id, axis=1)

    return {
        "hi": s_hi, "lo": s_lo, "first": first,
        "count": count, "tiebreak": s_idx,
    }


def dup_rows(hi: jnp.ndarray, lo: jnp.ndarray, valid: jnp.ndarray):
    """Per-row flag: does any k-mer hash occur at >= 2 valid positions?
    Used by the w=1 sketch rung (pipeline/overlapper.py) to decide
    escalation WITHOUT the full dedup sort: a SINGLE-key sort of the low
    32 hash bits, no carried payloads, no stability machinery and no
    segment sums.

    One-sided test: equal 64-bit k-mer hashes (the reference's notion of
    a repeated k-mer -- the weight map keys on the 64-bit hash,
    MinHashSketch.java:66-81) always have equal ``lo``, so a duplicate is
    never missed.  Distinct k-mers colliding in the low 32 bits
    (~n^2/2^33 ~ 1e-3 per row at n ~ 3k) or a real lo landing on an
    invalid-slot sentinel only cause a harmless extra escalation -- the
    escalated rung computes exact counts and corrects the flag."""
    del hi
    B, n = lo.shape
    pos = jnp.broadcast_to(jnp.arange(n, dtype=U32), (B, n))
    k_lo = jnp.where(valid, lo, pos)
    (s_lo,) = jax.lax.sort((k_lo,), dimension=1, num_keys=1)
    return jnp.any(s_lo[:, 1:] == s_lo[:, :-1], axis=1)


@partial(jax.jit, static_argnames=("num_hashes", "w_max", "unroll"))
def weighted_min_reduce(hi, lo, weight, active, tiebreak, *,
                        num_hashes: int, w_max: int, unroll: int = 4):
    """The xorshift min-reduction (MinHashSketch.java:134-153).

    hi, lo:    [B, n] uint32 -- k-mer identity hashes (any order; inactive
               duplicates must have active=False)
    weight:    [B, n] int32  -- stream values consumed per slot (<= w_max)
    active:    [B, n] bool
    tiebreak:  [B, n] int32  -- first-occurrence position (tie resolution)

    ``unroll`` sketch slots are processed per scan step (statically
    unrolled) to amortize per-step dispatch latency -- the scan would
    otherwise run num_hashes sequential [B, n]-wide steps.

    Returns int32 [B, num_hashes] sketch.
    """
    B, n = hi.shape
    x0 = (hi, lo)
    act_u = active
    w = jnp.where(active, weight, 0)
    # keep the unrolled graph bounded: ~32 advances per scan step (compile
    # time scales with the step body)
    unroll = min(unroll, max(1, 32 // max(w_max, 1)))
    while num_hashes % unroll:
        unroll //= 2
    unroll = max(unroll, 1)

    def one_slot(x):
        """Window minimum over one slot's `weight` stream values."""
        def advance(t, carry):
            xs, wm_hi, wm_lo = carry
            nxt = u64.xorshift(xs)
            adv = t < w
            xs = u64.select(adv, nxt, xs)
            v_hi = nxt[0] ^ _SIGN  # signed order == unsigned on flipped hi
            v_lo = nxt[1]
            less = (v_hi < wm_hi) | ((v_hi == wm_hi) & (v_lo < wm_lo))
            upd = adv & less
            wm_hi = jnp.where(upd, v_hi, wm_hi)
            wm_lo = jnp.where(upd, v_lo, wm_lo)
            return xs, wm_hi, wm_lo

        carry = (x, jnp.full((B, n), _UMAX, U32), jnp.full((B, n), _UMAX, U32))
        if w_max <= 16:
            for t in range(w_max):
                carry = advance(t, carry)
        else:
            carry = jax.lax.fori_loop(0, w_max, advance, carry)
        xs, wm_hi, wm_lo = carry

        wm_hi = jnp.where(act_u, wm_hi, _UMAX)
        wm_lo = jnp.where(act_u, wm_lo, _UMAX)
        # lexicographic argmin over k-mers: (value, tiebreak)
        m_hi = jnp.min(wm_hi, axis=1, keepdims=True)
        m1 = wm_hi == m_hi
        m_lo = jnp.min(jnp.where(m1, wm_lo, _UMAX), axis=1, keepdims=True)
        m2 = m1 & (wm_lo == m_lo)
        widx = jnp.min(jnp.where(m2, tiebreak, _IMAX), axis=1, keepdims=True)
        sel = m2 & (tiebreak == widx)
        key_lo = jnp.max(jnp.where(sel, lo, U32(0)), axis=1)
        key_hi = jnp.max(jnp.where(sel, hi, U32(0)), axis=1)
        return xs, key_hi, key_lo

    def step(x, _):
        khs, kls = [], []
        for _u in range(unroll):
            x, kh, kl = one_slot(x)
            khs.append(kh)
            kls.append(kl)
        return x, (jnp.stack(khs), jnp.stack(kls))

    _, (keys_hi, keys_lo) = jax.lax.scan(
        step, x0, None, length=num_hashes // unroll)
    # keys_*: [steps, unroll, B] -> [B, num_hashes]
    keys_hi = keys_hi.reshape(num_hashes, B).T
    keys_lo = keys_lo.reshape(num_hashes, B).T
    parity = jnp.arange(num_hashes) % 2 == 0
    out = jnp.where(parity[None, :], keys_lo, keys_hi)
    return out.astype(I32)


def minhash_from_hashes(hi, lo, valid, weights_fn=None, *,
                        num_hashes: int, w_max: int = 1):
    """Full stage-1 sketch from raw per-position hashes.

    weights_fn: optional callable(groups) -> int32 [B, n] weights evaluated
    at run-first positions (tf/tf-idf/legacy modes); defaults to the
    reference's no-filter tf mode (weight = occurrence count).

    Returns (sketch int32 [B, num_hashes], n_valid int32 [B]).
    """
    g = sort_and_count(hi, lo, valid)
    if weights_fn is None:
        w = g["count"]
    else:
        w = weights_fn(g)
    w = jnp.where(g["first"], w, 0)
    active = g["first"] & (w > 0)
    n_valid = jnp.sum(active, axis=1).astype(I32)
    sketch = weighted_min_reduce(
        g["hi"], g["lo"], w, active, g["tiebreak"],
        num_hashes=num_hashes, w_max=w_max)
    return sketch, n_valid
