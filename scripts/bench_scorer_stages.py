"""Microbenchmark the fast-scorer sub-stages on the GPU.

Times each piece of make_score_pairs_fast's per-lane program at pipeline
batch shape (pair lanes x 2S master width) to attribute the score stage's
wall time: master sort, pass-1 scan, pass-2 scan (+record compaction),
optimizeShifts, windowed jaccard.
"""
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from mhap_tpu.ops import scorer as SC

P, S = 4096, 1536  # pair lanes, sketch size
CAP = 2 * S
rng = np.random.default_rng(0)


def mk_side():
    h = np.sort(rng.integers(-2**31, 2**31, (P, S)).astype(np.int32), axis=1)
    p = rng.integers(0, 2900, (P, S)).astype(np.int32)
    m = np.full(P, S, np.int32)
    nk = np.full(P, 2885, np.int32)
    return jnp.asarray(h), jnp.asarray(p), jnp.asarray(m), jnp.asarray(nk)


a_h, a_p, a_m, a_nk = mk_side()
b_h, b_p, b_m, b_nk = mk_side()


def timeit(name, fn, reps=3):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:>28}: {dt*1000:9.1f} ms/call ({P} lanes)", flush=True)
    return out


struct = jax.jit(jax.vmap(SC._sorted_pair_structure))
st = timeit("master structure (sort)", lambda: struct(a_h, a_p, a_m, b_h, b_p, b_m))

zeros = jnp.zeros(P, jnp.int32)


@jax.jit
def pass1(st, a_nk, b_nk):
    def one(st1, ank, bnk):
        return SC._fast_pass_scan(st1, jnp.int32(0), jnp.maximum(ank, bnk) + 1,
                                  jnp.int32(0), ank, jnp.int32(0), bnk, None,
                                  pass1=True)[0]
    return jax.vmap(one)(st, a_nk, b_nk)


timeit("pass1 scan (6-leaf)", lambda: pass1(st, a_nk, b_nk))


@jax.jit
def pass2(st, a_nk, b_nk):
    def one(st1, ank, bnk):
        return SC._fast_pass_scan(st1, jnp.int32(100), jnp.int32(500),
                                  jnp.int32(0), ank, jnp.int32(0), bnk, CAP)
    p1b, p2b, cnt, ns = jax.vmap(one)(st, a_nk, b_nk)
    return p1b, p2b, cnt


p1b, p2b, cnt = timeit("pass2 scan+compact (10-leaf)",
                       lambda: pass2(st, a_nk, b_nk))


@jax.jit
def opt(p1b, p2b, cnt):
    def one(p1, p2, c):
        return SC._optimize_shifts(p1, p2, c, jnp.int32(100), CAP)
    return jax.vmap(one)(p1b, p2b, cnt)


timeit("optimize_shifts", lambda: opt(p1b, p2b, cnt))


@jax.jit
def medians(p1b, p2b, cnt):
    def one(p1, p2, c):
        sh = jnp.where(jnp.arange(CAP) < c, p2 - p1, SC._IMAX)
        return SC._median_from(sh, c)
    return jax.vmap(one)(p1b, p2b, cnt)


timeit("median (sort of cap)", lambda: medians(p1b, p2b, cnt))


@jax.jit
def jac(st, a_m, b_m):
    def one(st1, m1, m2):
        return SC._windowed_jaccard_scan(st1, m1, m2, jnp.int32(0),
                                         jnp.int32(2900), jnp.int32(0),
                                         jnp.int32(2900))
    return jax.vmap(one)(st, a_m, b_m)


timeit("windowed jaccard (2-leaf)", lambda: jac(st, a_m, b_m))

# whole scorer for reference
fast = SC.make_score_pairs_fast(0.2, S)
timeit("whole fast scorer", lambda: fast(a_h, a_p, a_m, a_nk,
                                         b_h, b_p, b_m, b_nk))
